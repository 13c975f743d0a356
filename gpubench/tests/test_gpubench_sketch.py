"""The reference's genome sketch: the vectorised minimizers equal the
frozen scalar mm_sketch's, tandem repeats and equal k-mers included, and
the index and seed hits built on them equal the scalar path's."""
import numpy as np
import pytest

from gpubench.gen.genome import Genome
from gpubench.ref import seeds as rseeds
from gpubench.ref import sketch as sk


def contig(rng, n_tandem):
    parts = []
    for _ in range(n_tandem):
        parts.append(rng.choice(list(b"ACGT"), int(rng.integers(200, 900))))
        unit = rng.choice(list(b"ACGT"), int(rng.integers(1, 9)))
        parts.append(np.tile(unit, int(rng.integers(2, 30))))
        parts.append(np.full(int(rng.integers(1, 40)), ord("A")))
    parts.append(rng.choice(list(b"ACGT"), 3000))
    return np.concatenate(parts).astype(np.uint8)


@pytest.mark.parametrize("w,k,n_tandem", [(10, 15, 0), (10, 15, 40),
                                          (5, 15, 40), (3, 11, 60)])
def test_vectorised_equals_scalar(w, k, n_tandem):
    rng = np.random.default_rng(w * 100 + n_tandem)
    c = contig(rng, n_tandem)
    x, y = sk._sketch_contig(c, w, k, 2, "cpu")
    got = sorted(zip(x.numpy().view(np.uint64).tolist(),
                     y.numpy().view(np.uint64).tolist()))
    want = sorted(sk.sketch(sk.encode_nt4(c), w, k, 2))
    assert got == want


def test_index_and_hits_equal_the_scalar_path():
    rng = np.random.default_rng(3)
    ctgs = [contig(rng, 20), contig(rng, 5)]
    g = Genome(np.concatenate(ctgs), [len(c) for c in ctgs])
    idx = rseeds.RefIndex(g, 10, 15, "cpu")
    mm = [m for i, c in enumerate(ctgs)
          for m in sk.sketch(sk.encode_nt4(c), 10, 15, i)]
    keys = sorted({x >> 8 for x, _ in mm})
    assert idx.keys.tolist() == keys
    by = {}
    for x, y in mm:
        by.setdefault(x >> 8, []).append(y)
    assert idx.pos.tolist() == [y for h in keys for y in sorted(by[h])]
    read = ctgs[0][500:2500].copy()
    a, rep, mini_pos = rseeds.read_anchors(idx, read, 1000)
    assert len(a) and rep == 0
    assert len(mini_pos) == len(sk.sketch_np(read, 10, 15, 0))
    # the read's own stretch holds a hit for each of its minimizers
    xs = a[:, 0] & np.uint64(0xFFFFFFFF)
    rid = (a[:, 0] >> np.uint64(32)) & np.uint64(0x7FFFFFFF)
    home = (rid == 0) & (xs >= 500) & (xs < 2500 + 15)
    assert home.sum() >= len(sk.sketch_np(read, 10, 15, 0)) - 2

"""Host seeding a batch at a time (mm2tpu_torch/mapping/seed_batch.py, on
mm2tpu_torch/native/seed_batch.cpp) against the per-read path.

Every read's minimizers, anchors, rep_len, mini_pos and minimizer count
from the two batch calls equal `collect_minimizers` and
`collect_seed_hits` a read, array for array, under each preset's index
and options (spliced reads, map-ont, read pairs, an HPC index, each
strand filter), on 1, 2, 3 and 8 threads, with empty segments, reads
shorter than k, reads of N, and U, R and lower case among them. Where the batch calls do not
cover the options (SDUST masking, the ava presets' read-name rules),
`map_frags_batched` seeds a read at a time and its PAF is the JAX
package's, as it is on the batch calls."""
import functools

import numpy as np
import pytest

import mm2tpu.index.build as jax_build
import mm2tpu.io.format as jax_format
import mm2tpu.options as jax_options
import mm2tpu_torch.index.build as port_build
import mm2tpu_torch.options as port_options
from mm2tpu.mapping.pipeline import map_frags_batched as jax_map_batched
from mm2tpu_torch.mapping import pipeline, seed_batch
from mm2tpu_torch.mapping.seed import collect_minimizers, collect_seed_hits
from mm2tpu_torch.options import MM_F_FOR_ONLY, MM_F_REV_ONLY
from mm2tpu_torch.utils import profiling
from test_torch_pipeline import paf

BASES = np.array(list("ACGT"))
REPEAT_COPIES = 8
MID_OCC = 5          # the repeat's minimizers go over it: rep_len > 0


def revcomp(s):
    return s[::-1].translate(str.maketrans("ACGTN", "TGCAN"))


@functools.cache
def genome():
    """Two seeded contigs, 100 and 50 kb, with a 500 bp element copied
    REPEAT_COPIES times into the first."""
    rng = np.random.default_rng(19)
    c0 = list("".join(BASES[rng.integers(0, 4, 100000)]))
    rep = list("".join(BASES[rng.integers(0, 4, 500)]))
    for j in range(REPEAT_COPIES):
        st = 2000 + 12000 * j
        c0[st:st + len(rep)] = rep
    return ["".join(c0), "".join(BASES[rng.integers(0, 4, 50000)])]


@functools.cache
def index(preset):
    io, _ = port_options.set_opt(preset)
    return port_build.build_index(["c0", "c1"], genome(), io)


def options(preset, flag=0):
    mi = index(preset)
    _, mo = port_options.set_opt(preset)
    port_options.mapopt_update(mo, mi)
    mo.mid_occ = MID_OCC
    mo.flag |= flag
    return mi, mo


def draw(rng, L):
    """L bases of the genome, from either strand, 5% substituted."""
    g = genome()[int(rng.integers(0, 2))]
    st = int(rng.integers(0, len(g) - L))
    s = list(g[st:st + L])
    for _ in range(L // 20):
        s[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
    s = "".join(s)
    return revcomp(s) if rng.integers(0, 2) else s


@functools.cache
def reads(pairs):
    """Seeded fragments with the edge cases among them: one segment a
    read (one of 0 bases stays out: it is never seeded), or 2 x 150 bp
    pairs with an empty and a short mate."""
    rng = np.random.default_rng(23)
    rep = genome()[0][2000:2500]
    if pairs:
        frags = [[draw(rng, 150), draw(rng, 150)] for _ in range(24)]
        frags += [["", draw(rng, 150)], [draw(rng, 150), "ACGTAC"],
                  ["N" * 150, draw(rng, 150)], [rep[:150], rep[200:350]]]
    else:
        frags = [[draw(rng, int(rng.integers(200, 4000)))]
                 for _ in range(24)]
        frags += [["ACGTACGTA"], ["N" * 800],
                  [draw(rng, 600) + "N" * 40 + draw(rng, 600)],
                  [draw(rng, 900).lower()], ["A" * 300 + draw(rng, 300)],
                  ["".join("UuRn"[j % 4] if j % 97 == 5 else b for j, b in
                           enumerate(draw(rng, 1200)))],
                  [draw(rng, 300) + rep + draw(rng, 300)]]
    return frags


def contexts(mo, frags):
    out = [pipeline._frag_ctx(seqs, mo, "q%d" % i)
           for i, seqs in enumerate(frags)]
    return [c for c in out if isinstance(c, pipeline._FragCtx)]


CASES = {"splice": ("splice", 0, False), "map-ont": ("map-ont", 0, False),
         "sr-pairs": ("sr", 0, True), "hpc": ("map-pb", 0, False),
         "for-only": ("map-ont", MM_F_FOR_ONLY, False),
         "rev-only": ("map-ont", MM_F_REV_ONLY, False)}


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_batch_seeding_equals_the_per_read_path(case, threads, monkeypatch):
    preset, flag, pairs = CASES[case]
    mi, mo = options(preset, flag)
    assert len(mi.keys) >= 512 and bool(mi.flag & 1) == (case == "hpc")
    assert seed_batch.covers(mi, mo, True)
    monkeypatch.setattr(seed_batch, "threads", lambda n: threads)
    ctxs = contexts(mo, reads(pairs))
    seed_batch.seed_frags(mi, mo, ctxs, seed_hits=True)
    sketched = contexts(mo, reads(pairs))
    seed_batch.seed_frags(mi, mo, sketched, seed_hits=False)
    n_anchors = rep = 0
    for c, s in zip(ctxs, sketched):
        mv = collect_minimizers(mi, mo, c.seqs, c.qlens)
        sr = collect_seed_hits(mi, mo, mo.mid_occ, mv, c.qname, c.qlen_sum)
        for got in (c.mv, s.mv):
            assert got.dtype == mv.dtype and np.array_equal(got, mv)
        assert s.sr is None
        assert c.sr.anchors.dtype == sr.anchors.dtype
        assert np.array_equal(c.sr.anchors, sr.anchors)
        assert np.array_equal(c.sr.mini_pos, sr.mini_pos)
        assert (c.sr.rep_len, c.sr.n_mv) == (sr.rep_len, sr.n_mv)
        n_anchors += len(sr.anchors)
        rep += sr.rep_len
    # the reads exercise the index, and a read has no minimizers (each
    # pair has a mate with some)
    assert pairs or min(len(c.mv) for c in ctxs) == 0
    assert n_anchors > 10 * len(ctxs) and rep > 0


def test_threads_follow_the_reads_and_the_cores():
    cores = seed_batch.threads(10 ** 9)
    assert cores >= 1
    assert seed_batch.threads(1) == seed_batch.threads(16) == 1
    assert seed_batch.threads(17) == min(2, cores)


@pytest.mark.parametrize("preset,sdust,batched", [
    ("map-ont", 0, True), ("map-ont", 20, False), ("ava-ont", 0, False)])
def test_either_seeding_path_keeps_the_jax_paf(preset, sdust, batched):
    """`map_frags_batched` counts the reads it seeds (`seed.reads`) and
    those of the batch calls (`seed.batched`: all or none), and writes
    the JAX package's PAF either way."""
    frags = reads(False)[:12]
    # names before the contigs': ava's MM_F_NO_DUAL keeps their hits
    names = ["a%d" % i for i in range(len(frags))]
    mi = port_build.build_index(["c0", "c1"], genome(), w=10, k=15)
    jmi = jax_build.build_index(["c0", "c1"], genome(), w=10, k=15)
    mos = []
    for opts, m in ((port_options, mi), (jax_options, jmi)):
        _, mo = opts.set_opt(preset)
        opts.mapopt_update(mo, m)
        mo.sdust_thres = sdust
        mos.append(mo)
    mo, jmo = mos
    assert seed_batch.covers(mi, mo, True) == batched
    profiling.enable()
    try:
        res = pipeline.map_frags_batched(mi, frags, mo, names, "cpu")
        counters = dict(profiling.counters)
    finally:
        profiling.disable()
    n = len(contexts(mo, frags))
    assert counters["seed.reads"] == n
    assert counters.get("seed.batched", 0) == (n if batched else 0)
    assert counters.get("seed.batch_calls", 0) == (2 if batched else 0)
    assert not [k for k in counters if k.startswith("fallback.")]
    res_jax = jax_map_batched(jmi, frags, jmo, names, mesh=None)
    got = paf(mi, mo, names, frags, res)
    assert got == paf(jmi, jmo, names, frags, res_jax, jax_format.write_paf)
    assert got.count("\tc0\t") + got.count("\tc1\t") >= 8

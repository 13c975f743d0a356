"""The genome model: contigs of random bases with diverged repeat
families, built from a fixed seed.

`gen_genome` is a copy of `scripts/make_workload.py::gen_genome`:
contigs whose lengths follow a flat Dirichlet draw, 35% of each covered
by copies of 8 repeat families of 1-8 kb, every copy mutated at 4%.
Like hg38 (about half repeats), this multiplies seed hits and chaining
work without tripping the mid_occ filter the way exact copies do.

`load_genome` builds the genome once a checkout and keeps it in the
checkout's cache as one uint8 array of ASCII bases and the contigs'
lengths.
"""
from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)


def gen_genome(rng, total_bp: int, n_ctg: int, repeat_frac: float = 0.35,
               repeat_div: float = 0.04) -> List[np.ndarray]:
    """Contigs (uint8 ASCII arrays) with embedded diverged repeat
    families (copied from scripts/make_workload.py)."""
    lens = rng.dirichlet(np.ones(n_ctg)) * total_bp
    lens = np.maximum(lens.astype(np.int64), 10000)
    fams = [BASES[rng.integers(0, 4, int(rng.integers(1000, 8000)))]
            for _ in range(8)]
    ctgs = []
    for L in lens:
        g = BASES[rng.integers(0, 4, int(L))]
        target = int(L * repeat_frac)
        placed = 0
        while placed < target:
            fam = fams[int(rng.integers(0, len(fams)))]
            rl = int(rng.integers(len(fam) // 2, len(fam)))
            copy = fam[:rl].copy()
            m = rng.random(rl) < repeat_div
            copy[m] = BASES[(np.searchsorted(BASES, copy[m]) +
                             rng.integers(1, 4, int(m.sum()))) % 4]
            p = int(rng.integers(0, max(1, len(g) - rl)))
            g[p:p + rl] = copy
            placed += rl
        ctgs.append(g)
    return ctgs


class Genome:
    """The contigs as one array: `seq` (uint8 ASCII), `offsets` and
    `lens` (int64), and `names`."""

    def __init__(self, seq: np.ndarray, lens: np.ndarray):
        self.seq = seq
        self.lens = np.asarray(lens, np.int64)
        self.offsets = np.concatenate(([0], np.cumsum(self.lens)[:-1]))
        self.names = ["ctg%d" % i for i in range(len(self.lens))]

    def contig(self, i: int) -> np.ndarray:
        o = int(self.offsets[i])
        return self.seq[o:o + int(self.lens[i])]


def genome_key(g: dict) -> str:
    return "g%d_c%d_s%d_rf%g_rd%g" % (g["length"], g["contigs"], g["seed"],
                                       g["repeat_frac"], g["repeat_div"])


def load_genome(g: dict, cache_dir: str) -> Tuple[Genome, bool]:
    """The configuration's genome (`g`: length, contigs, seed,
    repeat_frac, repeat_div), from the cache or built and cached there.
    Returns it and whether it was built."""
    d = os.path.join(cache_dir, genome_key(g))
    seq_p, meta_p = os.path.join(d, "genome.npy"), os.path.join(d, "meta.json")
    if os.path.exists(meta_p):
        with open(meta_p) as f:
            lens = json.load(f)["lens"]
        return Genome(np.load(seq_p, mmap_mode="r"), lens), False
    rng = np.random.default_rng(g["seed"])
    ctgs = gen_genome(rng, int(g["length"]), int(g["contigs"]),
                      g["repeat_frac"], g["repeat_div"])
    os.makedirs(d, exist_ok=True)
    seq = np.concatenate(ctgs)
    tmp = seq_p + ".part.npy"
    with open(tmp, "wb") as f:
        np.save(f, seq)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, seq_p)
    with open(meta_p + ".part", "w") as f:
        json.dump({"lens": [len(c) for c in ctgs]}, f)
    os.replace(meta_p + ".part", meta_p)
    return Genome(seq, [len(c) for c in ctgs]), True

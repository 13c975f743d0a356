"""Read models, drawn from the genome by a seed, with stratified lengths.

Every mini-batch holds the same multiset of lengths, taken at fixed
quantiles of the traffic's distributions; the seed chooses only which
read gets which length, and the sequences, positions, strands and
errors. So two seeds give the same work in every batch, in another
order and on other sequences.

- `ont_batch`: ONT-like reads (the model of
  `scripts/make_workload.py::make`): a stretch of one contig, chosen by
  length, with iid errors (substitutions, deletions, insertions in the
  ratio 0.5 : 0.25 : 0.25, `mutate`), the reverse complement half of the
  time.
- `spliced_batch`: cDNA-like reads (the model of
  `chip_smoke.py::make_spliced_reads`, rewritten): exons taken in order
  from one contig, each intron starting at the first GT at or after its
  exon's end and ending at the first AG that keeps it at least its drawn
  length (a canonical GT-AG junction), then `mutate`d.

A read's name carries where it came from and what was drawn for it:
`r<batch>.<i>_<contig>_<start>_<strand>_<length>` (ONT) or
`..._<strand>_<exons>x` (spliced).
"""
from __future__ import annotations

from statistics import NormalDist
from typing import List, Tuple

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.zeros(256, np.uint8)
for _a, _b in zip(b"ACGTN", b"TGCAN"):
    _COMP[_a] = _b


def revcomp(s: np.ndarray) -> np.ndarray:
    return _COMP[s[::-1]]


def lognormal_quantiles(n: int, median: float, sigma: float, lo: float,
                        hi: float) -> np.ndarray:
    """n lengths at the quantiles (i + 0.5) / n of a log-normal of this
    median and log-sigma, cut to [lo, hi]."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    return np.clip(np.round(median * np.exp(sigma * z)), lo, hi).astype(
        np.int64)


def uniform_quantiles(n: int, lo: int, hi: int) -> np.ndarray:
    """n whole numbers at the quantiles (i + 0.5) / n of [lo, hi]."""
    return (lo + np.floor((np.arange(n) + 0.5) / n * (hi - lo + 1))).astype(
        np.int64)


def mutate(rng, seq: np.ndarray, err: float) -> np.ndarray:
    """iid errors at rate `err`: substitutions, deletions and one-base
    insertions in the ratio 0.5 : 0.25 : 0.25 (make_workload's
    `mutate_read`)."""
    r = rng.random(len(seq))
    subs = r < err * 0.5
    dels = (r >= err * 0.5) & (r < err * 0.75)
    ins = (r >= err * 0.75) & (r < err)
    out = seq.copy()
    out[subs] = BASES[(np.searchsorted(BASES, out[subs]) +
                       rng.integers(1, 4, int(subs.sum()))) % 4]
    ins_base = BASES[rng.integers(0, 4, int(ins.sum()))]
    keep = ~dels
    kept = out[keep]
    pos = np.cumsum(keep)[ins]
    return np.insert(kept, np.minimum(pos, len(kept)), ins_base)


def ont_lengths(t: dict) -> np.ndarray:
    """The batch's multiset of read lengths (traffic `t`: `mean_len`,
    `sigma`, `min_len`, `max_len`, `reads_per_batch`): a log-normal of
    this mean, median = mean * exp(-sigma^2 / 2)."""
    median = t["mean_len"] * np.exp(-t["sigma"] ** 2 / 2)
    return lognormal_quantiles(t["reads_per_batch"], median, t["sigma"],
                               t["min_len"], t["max_len"])


def _pick_contig(rng, genome, span: int) -> int:
    ok = np.nonzero(genome.lens > span + 1000)[0]
    w = genome.lens[ok].astype(np.float64)
    return int(ok[rng.choice(len(ok), p=w / w.sum())])


def ont_batch(rng, genome, t: dict, tag: int):
    """One batch of ONT-like reads: (names, list of uint8 arrays)."""
    lens = rng.permutation(ont_lengths(t))
    names, seqs = [], []
    for i, L in enumerate(lens):
        L = int(L)
        ci = _pick_contig(rng, genome, L)
        g = genome.contig(ci)
        st = int(rng.integers(0, len(g) - L + 1))
        s = mutate(rng, np.asarray(g[st:st + L]), t["err"])
        strand = int(rng.integers(0, 2))
        if strand:
            s = revcomp(s)
        names.append("r%d.%d_%s_%d_%s_%d" % (tag, i, genome.names[ci], st,
                                             "-+"[strand == 0], L))
        seqs.append(s)
    return names, seqs


def spliced_structure(t: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The batch's multisets: exons a read (`exons` [lo, hi], spread
    evenly), exon lengths (`exon_len` [lo, hi], uniform quantiles) and
    intron lengths (log-normal `intron_median`, `intron_sigma`, cut to
    [`intron_min`, `intron_max`])."""
    n = t["reads_per_batch"]
    lo, hi = t["exons"]
    n_ex = lo + (np.arange(n) * (hi - lo + 1)) // n
    ex_len = uniform_quantiles(int(n_ex.sum()), *t["exon_len"])
    in_len = lognormal_quantiles(int((n_ex - 1).sum()), t["intron_median"],
                                 t["intron_sigma"], t["intron_min"],
                                 t["intron_max"])
    return n_ex, ex_len, in_len


def spliced_plan(rng, t: dict) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each read's drawn (exon lengths, intron lengths): the batch's
    multisets (`spliced_structure`) dealt out in an order from `rng`, or,
    where the traffic says `"plan": "fixed"`, from its own `plan_seed`:
    then every seed's batches hold the same reads' shapes in the same
    order, and the seed chooses only sequences, positions, strands and
    errors (a splice fill's cells grow with its read's summed introns, so
    how the introns are dealt out changes the work)."""
    n_ex, ex_len, in_len = spliced_structure(t)
    if t.get("plan") == "fixed":
        rng = np.random.default_rng(int(t["plan_seed"]))
    n_ex = rng.permutation(n_ex)
    ex_len, in_len = rng.permutation(ex_len), rng.permutation(in_len)
    plan, ei, ii = [], 0, 0
    for ne in n_ex:
        plan.append((ex_len[ei:ei + ne], in_len[ii:ii + ne - 1]))
        ei, ii = ei + ne, ii + ne - 1
    return plan


def spliced_batch(rng, genome, t: dict, tag: int):
    """One batch of spliced reads: (names, list of uint8 arrays)."""
    names, seqs = [], []
    for i, (exons, introns) in enumerate(spliced_plan(rng, t)):
        slack = 200 * len(introns) + 1000
        span = int(exons.sum() + introns.sum()) + slack
        while True:
            ci = _pick_contig(rng, genome, span)
            g = genome.contig(ci)
            start = int(rng.integers(0, len(g) - span))
            region = np.asarray(g[start:start + span])
            rb = region.tobytes()
            parts, pos, ok = [], 0, True
            for j, el in enumerate(exons):
                end = pos + int(el)
                if j == len(exons) - 1:
                    parts.append(region[pos:end])
                    break
                donor = rb.find(b"GT", end)
                acc = rb.find(b"AG", donor + int(introns[j])) \
                    if donor >= 0 else -1
                if acc < 0:
                    ok = False
                    break
                parts.append(region[pos:donor])
                pos = acc + 2
            if ok:
                break
        s = mutate(rng, np.concatenate(parts), t["err"])
        strand = int(rng.integers(0, 2))
        if strand:
            s = revcomp(s)
        names.append("r%d.%d_%s_%d_%s_%dx" % (tag, i, genome.names[ci],
                                              start, "-+"[strand == 0],
                                              len(exons)))
        seqs.append(s)
    return names, seqs


MODELS = {"ont": ont_batch, "spliced": spliced_batch}


def make_pool(seed: int, genome, t: dict) -> List[Tuple[List[str],
                                                        List[np.ndarray]]]:
    """`t["pool_batches"]` distinct batches of the traffic's read model
    from `seed` (any whole number)."""
    rng = np.random.default_rng([abs(int(seed)), int(seed < 0), 17])
    make = MODELS[t["model"]]
    return [make(rng, genome, t, b) for b in range(t["pool_batches"])]

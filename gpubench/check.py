"""What decides `correct`: the program's own outputs in the window,
judged by the plain reference (`ref/`) on a sample drawn from the seed.

The harness drives `cli.map_batch` with observers on the kernels'
entries (`Observer`): `chain_fn` and `seed_fn` of `map_batch`, which call
the program's own `chain_scores` and `seed_chain`, and the extension
batcher's `extd2_batch` and `exts2_batch`. In one batch of the window,
drawn from the seed, they keep what those entries return, copied to
pinned host memory without a wait; in a traced run they also count the
work the rooflines divide (`counts`). After the window, for each sampled
read of that batch the reference works out, from the read and the
genome alone, the anchors (its own index and seeding), the chaining
scores and predecessors (the bounded-lookback DP) and the chains, and
compares:

- `seed_miss`: sampled reads with anchors whose anchors no chained row
  of the program holds, exactly (K5/K6 or host seeding);
- `chain_diff`: anchors of those rows whose score or predecessor differs
  (K1, K2);
- `ext_diff`: the batch's largest extension fill by its cells and
  `check_fills` others drawn from the seed, of those with at most
  `check_fill_max_cells` cells, whose result (score, maxima,
  ends, z-drop, CIGAR) differs from the reference's fill of the same
  query and target under the same parameters (K3, K4; the fills' bounds
  are the program's, from its chains);
- `rec_missing`: sampled reads without the records they must have (PAF:
  a read the reference maps and no line; SAM: not exactly one primary
  line);
- `rec_bad`: records of the batch that name no read of it, or sampled
  reads' SAM records whose SEQ, or NM recounted along the CIGAR against
  the genome, disagree with the read;
- `rec_diff`: sampled reads whose records disagree with the reference's
  post-chain (`ref/post.py`: regions, primary and secondary choice, the
  long join, divergence, mapping quality). PAF: the read's lines differ
  from the reference's in any byte. SAM: the primary record does not lie
  on one of the reference's regions of the read (contig, strand and an
  overlap); the alignment itself is what `rec_bad` and `ext_diff` judge.

Each is exact, so each limit is 0. The control (`control=True`) puts
the reference's DP without the log2 term of its gap cost (chain.c:
dd * avg + log2(dd) / 2) in the program's place: a cheaper recurrence
that would tempt a faster chaining kernel, and breaks the
configuration's guarantee of minimap2 v2.18's chaining.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np

from .counts import (CHAIN_BYTES_IN, CHAIN_BYTES_OUT, CHAIN_OPS,
                     EXT_RESULT_BYTES, EXTD2_OPS, EXTS2_OPS, chain_pairs_t,
                     extd2_cells, exts2_cells)
from .ref import chain as rchain
from .ref import post as rpost
from .ref import seeds as rseeds
from .ref.ksw2_ref import ksw_extd2
from .ref.ksw2_splice_ref import ksw_exts2

LIMITS = {"seed_miss": 0, "chain_diff": 0, "ext_diff": 0, "rec_missing": 0,
          "rec_bad": 0, "rec_diff": 0}
EXT_FIELDS = ("max", "zdropped", "max_q", "max_t", "mqe", "mqe_t", "mte",
              "mte_q", "score", "reach_end", "cigar")


class Work:
    """The rooflines' counts of one kernel: operations and bytes."""

    def __init__(self):
        self.ops = 0
        self.bytes = 0
        self._dev = []   # device scalars not yet read

    def add_device(self, pairs, anchors):
        self._dev.append((pairs, anchors))

    def settle(self):
        for pairs, anchors in self._dev:
            self.ops += int(pairs) * CHAIN_OPS
            self.bytes += int(anchors) * (CHAIN_BYTES_IN + CHAIN_BYTES_OUT)
        self._dev = []


class Observer:
    """The kernels' entries, as `map_batch` and the batcher call them.
    `capture` keeps their outputs (pinned host copies, no wait); `count`
    adds their work to `work` ("k1".."k4")."""

    def __init__(self, faults: Optional[dict] = None):
        self.capture = False
        self.count = False
        self.rows: List[tuple] = []
        self.fills: List[tuple] = []
        self.work: Dict[str, Work] = {k: Work() for k in
                                      ("k1", "k2", "k3", "k4")}
        self.faults = faults or {}

    # -- chaining ----------------------------------------------------------
    def chain_fn(self, hi, lo, qi, span, sid, n, avg, **kw):
        from mm2tpu_torch.ops.chain_packed import chain_scores
        f, p = chain_scores(hi, lo, qi, span, sid, n, avg, **kw)
        if self.faults.get("alter_chain"):
            f = f.clone()
            f[:, 0] += 1
        if self.count:
            k = "k1" if (not kw["is_cdna"] and kw["n_segs"] == 1) else "k2"
            self.work[k].add_device(
                chain_pairs_t(hi, lo, n, kw["max_dist_x"], kw["iter_cap"]),
                n.to(dtype=hi.dtype).sum())
        if self.capture:
            self.rows.append(("chain", [t.to("cpu", non_blocking=True)
                                        for t in (hi, lo, qi, span, n, f,
                                                  p)]))
        return f, p

    def seed_fn(self, index, q, qpos, qyhi, qlen, avg, **kw):
        from mm2tpu_torch.ops.seed_device import seed_chain
        out = seed_chain(index, q, qpos, qyhi, qlen, avg, **kw)
        if self.faults.get("alter_chain"):
            out = list(out)
            out[4] = out[4].clone()
            out[4][:, 0] += 1
            out = tuple(out)
        hi, lo, yhi, ylo, f, prel, n = out
        if self.count:
            self.work["k1"].add_device(
                chain_pairs_t(hi, lo, n, kw["max_dist_x"], kw["iter_cap"]),
                n.to(dtype=hi.dtype).sum())
        if self.capture:
            self.rows.append(("seed", [t.to("cpu", non_blocking=True)
                                       for t in out]))
        return out

    # -- extension ---------------------------------------------------------
    @contextlib.contextmanager
    def on_batcher(self):
        """Observe the batcher's flushes (`extd2_batch`, `exts2_batch` as
        `mapping.extbatch` calls them) while the block runs."""
        from mm2tpu_torch.mapping import extbatch
        d2, s2 = extbatch.extd2_batch, extbatch.exts2_batch

        def observe(kind, fn):
            def call(tasks, mat, *params, **kw):
                res = fn(tasks, mat, *params, **kw)
                if self.faults.get("alter_ext"):
                    for rz in res:      # a kernel whose scores are off
                        rz.score += 1
                self._fills(kind, tasks, mat, params, res)
                return res
            return call

        extbatch.extd2_batch = observe("extd2", d2)
        extbatch.exts2_batch = observe("exts2", s2)
        try:
            yield
        finally:
            extbatch.extd2_batch, extbatch.exts2_batch = d2, s2

    def _fills(self, kind, tasks, mat, params, res):
        if self.count:
            w = self.work["k3" if kind == "extd2" else "k4"]
            for t, rz in zip(tasks, res):
                ql, tl = len(t[0]), len(t[1])
                if ql == 0 or tl == 0:
                    continue
                if kind == "extd2":
                    w.ops += extd2_cells(ql, tl, params[4]) * EXTD2_OPS
                else:
                    w.ops += exts2_cells(ql, tl) * EXTS2_OPS
                w.bytes += ql + tl + 4 * len(rz.cigar) + EXT_RESULT_BYTES
        if self.capture:
            for t, rz in zip(tasks, res):
                self.fills.append((kind, t, mat, params, rz))


# ---- the program's rows, decoded --------------------------------------


def _rows(captured) -> Dict[tuple, tuple]:
    """{(n, x, qi, span bytes): (f, p)} of every chained row."""
    out = {}
    for kind, ts in captured:
        if kind == "chain":
            hi, lo, qi, span, n, f, p = (t.numpy() for t in ts)
            for r in range(hi.shape[0]):
                m = int(n[r, 0])
                if m == 0:
                    continue
                x = (hi[r, :m].astype(np.uint32).astype(np.uint64)
                     << np.uint64(32)) | lo[r, :m].astype(np.uint32).astype(
                    np.uint64)
                key = (m, x.tobytes(), qi[r, :m].astype(np.int32).tobytes(),
                       (span[r, :m].astype(np.int32) & 0xFF).tobytes())
                out[key] = (f[r, :m].astype(np.int64),
                            p[r, :m].astype(np.int64))
        else:
            hi, lo, yhi, ylo, f, prel, n = (t.numpy() for t in ts)
            for r in range(hi.shape[0]):
                m = int(n[r, 0])
                if m == 0:
                    continue
                x = (hi[r, :m].astype(np.uint32).astype(np.uint64)
                     << np.uint64(32)) | lo[r, :m].astype(np.uint32).astype(
                    np.uint64)
                span = yhi[r, :m].astype(np.int32) & 0xFF
                rel = prel[r, :m].astype(np.int64)
                i = np.arange(m)
                key = (m, x.tobytes(), ylo[r, :m].astype(np.int32).tobytes(),
                       span.tobytes())
                out[key] = (f[r, :m].astype(np.int64),
                            np.where(rel > 0, i - rel, -1))
    return out


def _key(a: np.ndarray) -> tuple:
    qi = (a[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    span = ((a[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    return (len(a), a[:, 0].tobytes(), qi.tobytes(), span.tobytes())


# ---- records ----------------------------------------------------------

_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def _sam_nm(cigar: str, seq: bytes, ref: np.ndarray, pos0: int):
    """(NM along the CIGAR, query bases consumed, reference end) or None
    when the CIGAR runs off the contig."""
    import re
    qi, ri, nm, ql = 0, pos0, 0, 0
    for ln, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar):
        ln = int(ln)
        if op in "M=X":
            if ri + ln > len(ref):
                return None
            a = np.frombuffer(seq[qi:qi + ln], np.uint8)
            nm += int((a != ref[ri:ri + ln]).sum())
            qi, ri, ql = qi + ln, ri + ln, ql + ln
        elif op == "I":
            nm += ln
            qi, ql = qi + ln, ql + ln
        elif op == "D":
            nm += ln
            ri += ln
        elif op == "N":
            ri += ln
        elif op == "S":
            qi, ql = qi + ln, ql + ln
        elif op == "H":
            ql += ln
    return nm, ql, ri


def check_records(text: str, fmt: str, batch_names: set, sample: dict,
                  genome, ref_regs: dict, ref_lines: dict):
    """(rec_missing, rec_bad, rec_diff) of the batch's records: `sample`
    maps a sampled read's name to its bases, `ref_regs` to the
    reference's regions of it and `ref_lines` to its PAF lines."""
    ctg = {n: i for i, n in enumerate(genome.names)}
    lines: Dict[str, List[str]] = {}
    bad = 0
    for ln in text.splitlines():
        if not ln or ln.startswith("@"):
            continue
        name = ln.split("\t", 1)[0]
        if name not in batch_names:
            bad += 1
            continue
        if name in sample:
            lines.setdefault(name, []).append(ln)
    missing = diff = 0
    for name, seq in sample.items():
        recs = [ln.split("\t") for ln in lines.get(name, [])]
        if fmt == "paf":
            missing += bool(ref_regs[name]) and not recs
            diff += lines.get(name, []) != ref_lines[name]
            continue
        prim = [f for f in recs if int(f[1]) & 0x900 == 0]
        if len(prim) != 1:
            missing += 1
        for f in prim:
            ok, end = _sam_ok(f, seq, ctg, genome)
            bad += not ok
            diff += ok and not _on_a_region(f, end, ctg, ref_regs[name])
    return missing, bad, diff


def _on_a_region(f, end: int, ctg, regs) -> bool:
    """Whether a SAM record lies on one of the reference's regions of its
    read (the same contig and strand, and an overlap), or is unmapped."""
    flag = int(f[1])
    if flag & 4:
        return True
    rid, rev, pos0 = ctg[f[2]], bool(flag & 16), int(f[3]) - 1
    return any(r.rid == rid and r.rev == rev and pos0 < r.re and r.rs < end
               for r in regs)


def _sam_ok(f, seq: np.ndarray, ctg, genome):
    """(whether the record's SEQ and NM agree with the read and the
    genome along its CIGAR, the end of its alignment on the contig)."""
    flag = int(f[1])
    if flag & 4:
        return f[9] in ("*", seq.tobytes().decode()), 0
    rid = ctg.get(f[2])
    if rid is None:
        return False, 0
    read = seq.tobytes()
    want = read.translate(_COMP)[::-1] if flag & 16 else read
    if f[9].encode() != want:
        return False, 0
    tags = {t[:2]: t[5:] for t in f[11:]}
    if "NM" not in tags:
        return False, 0
    got = _sam_nm(f[5], want, np.asarray(genome.contig(rid)), int(f[3]) - 1)
    if got is None:
        return False, 0
    nm, ql, end = got
    return ql == len(read) and nm == int(tags["NM"]), end


# ---- the judgement ----------------------------------------------------


def judge(obs: Observer, text: str, fmt: str, batch, sample_idx,
          genome, cfg: dict, device, rng, control: bool = False) -> dict:
    """The compared numbers: {name: value}, plus `reads_checked`,
    `fills_checked` and `anchors_checked` (not compared)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()
    names, seqs = batch
    r = cfg["reference"]
    po = rpost.PostOpt.of(r)
    t0 = time.perf_counter()
    index = rseeds.RefIndex(genome, r["w"], r["k"], device)
    mid_occ = rseeds.mid_occ(index, r["mid_occ_frac"], r["min_mid_occ"])
    t_index = time.perf_counter() - t0
    rows = _rows(obs.rows)
    out = dict(seed_miss=0, chain_diff=0)
    sample, ref_regs, ref_lines = {}, {}, {}
    n_anchors = 0
    for i in sample_idx:
        seq, name = seqs[i], names[i]
        sample[name] = seq
        a, rep_len, mini_pos = rseeds.read_anchors(index, seq, mid_occ)
        b, u, miss, n_diff = _chain_read(a, r, rows, control)
        n_anchors += len(a)
        if len(u) == 0 and r["max_occ"] > mid_occ and rep_len > 0:
            # the re-seed of map.c:318-340, every other minimizer kept
            a, rep_len, mini_pos = rseeds.read_anchors(index, seq,
                                                       r["max_occ"])
            b, u, miss2, diff2 = _chain_read(a, r, rows, control)
            miss, n_diff = miss + miss2, n_diff + diff2
            n_anchors += len(a)
        out["seed_miss"] += miss
        out["chain_diff"] += n_diff
        regs = rpost.regions(po, name, len(seq), b, u, rep_len, mini_pos,
                             genome.lens)
        ref_regs[name] = regs
        ref_lines[name] = [rpost.paf_line(name, len(seq), g,
                                          genome.names[g.rid],
                                          int(genome.lens[g.rid]), rep_len)
                           for g in regs]
    out["rec_missing"], out["rec_bad"], out["rec_diff"] = check_records(
        text, fmt, set(names), sample, genome, ref_regs, ref_lines)
    extra = dict(reads_checked=len(sample_idx), anchors_checked=n_anchors,
                 ref_index_s=t_index,
                 ref_reads_s=time.perf_counter() - t0 - t_index)
    if fmt == "sam":
        t1 = time.perf_counter()
        out["ext_diff"], extra["fills_checked"], extra["largest_fill"] = \
            _judge_fills(obs.fills, cfg, rng)
        extra["ref_fills_s"] = time.perf_counter() - t1
        extra["fills_in_batch"] = len(obs.fills)
    return out, extra


def _chain_read(a, r: dict, rows: dict, control: bool):
    """(the chains' anchors, the chains, 1 where no chained row of the
    program holds the read's anchors `a`, anchors whose score or
    predecessor differs) of one read."""
    if len(a) == 0:
        return a, np.zeros(0, np.uint64), 0, 0
    gap_qry, gap_ref = rchain.chain_gaps(r["max_gap"], r["max_gap_ref"], 0,
                                         False, 0)
    f, p, v = rchain.chain_scores_window(
        a, gap_ref, gap_qry, r["bw"], r["max_chain_iter"], 1.0,
        r["splice"], 1)
    b, u = rchain.chain_backtrack(len(a), f, p, v, a, r["min_cnt"],
                                  r["min_chain_score"])
    got = rows.get(_key(a))
    if got is None:
        return b, u, 1, 0
    pf, pp = got
    if control:
        pf, pp, _ = rchain.chain_scores_window(
            a, gap_ref, gap_qry, r["bw"], r["max_chain_iter"], 1.0,
            r["splice"], 1, log_gap=False)
    return b, u, 0, int(((pf != f) | (pp != p)).sum())


def _judge_fills(fills, cfg, rng):
    """(fills whose result differs, fills compared, the cells of the
    largest compared): a sample of the batch's fills (`pick_fills`), each
    worked out again by the reference in a pool of processes (one fill
    each, at once)."""
    if not fills:
        return 0, 0, 0
    cells = [_cells(f) for f in fills]
    pick = pick_fills(cells, cfg["check_fill_max_cells"],
                      cfg["check_fills"], rng)
    if not pick:
        return 0, 0, 0
    jobs = [(kind, np.asarray(t[0]), np.asarray(t[1]),
             None if kind == "extd2" else t[2], np.asarray(mat), params)
            for kind, t, mat, params, _ in (fills[i] for i in pick)]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    workers = min(len(jobs), max(1, len(os.sched_getaffinity(0)) - 1))
    with ProcessPoolExecutor(workers, multiprocessing.get_context(
            "spawn")) as ex:
        refs = list(ex.map(ref_fill, jobs))
    diff = sum(any(getattr(fills[i][4], k) != v for k, v in zip(EXT_FIELDS,
                                                                ref))
               for i, ref in zip(pick, refs))
    return diff, len(pick), cells[pick[0]]


def pick_fills(cells: List[int], max_cells: int, n: int, rng) -> List[int]:
    """The fills to compare: the largest by its cells, and `n` others
    drawn from the seed, of those with at most `max_cells` cells (the
    reference's time grows with the cells: a run has to end in time)."""
    ok = [i for i, c in enumerate(cells) if c <= max_cells]
    if not ok:
        return []
    big = max(ok, key=lambda i: cells[i])
    rest = [i for i in ok if i != big]
    n = min(n, len(rest))
    return [big] + [rest[i] for i in rng.choice(len(rest), n, replace=False)]


def _cells(fill) -> int:
    kind, t, _, params, _ = fill
    ql, tl = len(t[0]), len(t[1])
    if ql == 0 or tl == 0:
        return 0
    return extd2_cells(ql, tl, params[4]) if kind == "extd2" else \
        exts2_cells(ql, tl)


def ref_fill(job) -> tuple:
    """The reference's result of one fill, as EXT_FIELDS."""
    kind, q8, t8, junc, mat, params = job
    if kind == "extd2":
        q, e, q2, e2, w, zdrop, end_bonus, flag = params
        ref = ksw_extd2(len(q8), q8, len(t8), t8, mat, q, e, q2, e2, w,
                        zdrop, end_bonus, flag)
    else:
        q, e, q2, noncan, zdrop, junc_bonus, flag = params
        ref = ksw_exts2(len(q8), q8, len(t8), t8, mat, q, e, q2, noncan,
                        zdrop, junc_bonus, flag, junc=junc)
    return tuple(getattr(ref, k) for k in EXT_FIELDS)

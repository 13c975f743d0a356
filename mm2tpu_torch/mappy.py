"""mappy-compatible Python API (reference: python/mappy.pyx, cmappy.h).

Drop-in equivalents of the Cython binding's public surface:
`Aligner` (python/mappy.pyx:110-273), `Alignment` (:10-98),
`ThreadBuffer` (:101-108, a no-op here — per-call state is local),
`fastx_read` (:255-273), `revcomp` (:275-281), `verbose` (:283-285).

Counterpart of `mm2tpu/mappy.py`, verbatim apart from its imports (the
port's index loaders, `read_fastx`, `write_cs_or_md` and `map_frag`) and
one addition: `Aligner(..., device="cuda")`, the device on which the
chaining tasks that the router (`mapping/chain.py::ChainRouter`, by
`map_opt.chain_backend`) places on the device, and with
`map_opt.align_backend = "gpu"` the large extension fills, run. It is
resolved once, in `__init__` (`device.resolve_device`: "cuda" without a
card raises there; "cpu" runs the kernels' plain versions), and nothing
falls back from it. On a CUDA device `Aligner.map` raises what the
router's warm-up of the card raised before it yields a hit.
"""
from __future__ import annotations

from typing import Iterator, Optional

from .device import resolve_device
from .index.build import MMIndex, build_index
from .index.mmi import MAGIC, read_mmi
from .io.bseq import read_fastx
from .io.format import write_cs_or_md
from .mapping import costmodel
from .mapping.pipeline import map_frag
from .options import MM_F_CIGAR, set_opt, mapopt_update

def revcomp(seq: str) -> str:
    """mappy.revcomp (cmappy.h:111-120): IUPAC complement + reverse
    (seq_comp_table, bseq.c:11-27)."""
    return seq.translate(str.maketrans(
        "ACGTUBDHKMNRSVWYacgtubdhkmnrsvwy",
        "TGCAAVHDMKNYSBWRtgcaavhdmknysbwr"))[::-1]


class Alignment:
    """mappy.Alignment (python/mappy.pyx:10-98)."""

    def __init__(self, ctg, ctg_len, r_st, r_en, strand, q_st, q_en, mapq,
                 cigar, is_primary, mlen, blen, NM, trans_strand, seg_id,
                 cs_str="", MD_str=""):
        self._ctg = ctg
        self._ctg_len = ctg_len
        self._r_st, self._r_en = r_st, r_en
        self._q_st, self._q_en = q_st, q_en
        self._strand = strand
        self._mapq = mapq
        self._cigar = cigar
        self._is_primary = is_primary
        self._mlen, self._blen, self._NM = mlen, blen, NM
        self._trans_strand = trans_strand
        self._seg_id = seg_id
        self._cs, self._MD = cs_str, MD_str

    ctg = property(lambda s: s._ctg)
    ctg_len = property(lambda s: s._ctg_len)
    r_st = property(lambda s: s._r_st)
    r_en = property(lambda s: s._r_en)
    strand = property(lambda s: s._strand)
    trans_strand = property(lambda s: s._trans_strand)
    blen = property(lambda s: s._blen)
    mlen = property(lambda s: s._mlen)
    NM = property(lambda s: s._NM)
    is_primary = property(lambda s: s._is_primary != 0)
    q_st = property(lambda s: s._q_st)
    q_en = property(lambda s: s._q_en)
    mapq = property(lambda s: s._mapq)
    cigar = property(lambda s: s._cigar)
    read_num = property(lambda s: s._seg_id + 1)
    cs = property(lambda s: s._cs)
    MD = property(lambda s: s._MD)

    @property
    def cigar_str(self):
        return "".join(str(l) + "MIDNSH"[op] for l, op in self._cigar)

    def __str__(self):
        strand = "+" if self._strand > 0 else "-" if self._strand < 0 else "?"
        tp = "tp:A:P" if self._is_primary else "tp:A:S"
        ts = ("ts:A:+" if self._trans_strand > 0 else
              "ts:A:-" if self._trans_strand < 0 else "ts:A:.")
        a = [str(self._q_st), str(self._q_en), strand, self._ctg,
             str(self._ctg_len), str(self._r_st), str(self._r_en),
             str(self._mlen), str(self._blen), str(self._mapq), tp, ts,
             "cg:Z:" + self.cigar_str]
        if self._cs != "":
            a.append("cs:Z:" + self._cs)
        return "\t".join(a)


class ThreadBuffer:
    """mappy.ThreadBuffer — kept for API compatibility; per-call scratch
    is managed internally, so this carries no state."""


class Aligner:
    """mappy.Aligner (python/mappy.pyx:110-253), mapping on `device`
    ("cuda", the default, or "cpu")."""

    def __init__(self, fn_idx_in=None, preset=None, k=None, w=None,
                 min_cnt=None, min_chain_score=None, min_dp_score=None,
                 bw=None, best_n=None, n_threads=3, fn_idx_out=None,
                 max_frag_len=None, extra_flags=None, seq=None,
                 scoring=None, device="cuda"):
        self._device = resolve_device(device)
        self._idx: Optional[MMIndex] = None
        io, mo = set_opt(preset)
        mo.flag |= MM_F_CIGAR  # always perform alignment (mappy.pyx:117)
        if k is not None:
            io.k = k
        if w is not None:
            io.w = w
        if min_cnt is not None:
            mo.min_cnt = min_cnt
        if min_chain_score is not None:
            mo.min_chain_score = min_chain_score
        if min_dp_score is not None:
            mo.min_dp_max = min_dp_score
        if bw is not None:
            mo.bw = bw
        if best_n is not None:
            mo.best_n = best_n
        if max_frag_len is not None:
            mo.max_frag_len = max_frag_len
        if extra_flags is not None:
            mo.flag |= extra_flags
        if scoring is not None and len(scoring) >= 4:
            mo.a, mo.b = scoring[0], scoring[1]
            mo.q, mo.e = scoring[2], scoring[3]
            mo.q2, mo.e2 = mo.q, mo.e
            if len(scoring) >= 6:
                mo.q2, mo.e2 = scoring[4], scoring[5]
                if len(scoring) >= 7:
                    mo.sc_ambi = scoring[6]
        self.idx_opt, self.map_opt = io, mo

        if seq is None:
            if fn_idx_in is None:
                return
            try:  # an unopenable file yields a falsy Aligner, like the
                with open(fn_idx_in, "rb") as f:  # Cython binding
                    magic = f.read(4)
            except OSError:
                return
            if magic == MAGIC:
                self._idx = read_mmi(fn_idx_in)
            elif magic == b"MMX1":
                # the TPU build's native mmap index (index/build.py);
                # genome-scale opens in milliseconds
                from .index.build import load_index
                self._idx = load_index(fn_idx_in)
            else:
                refs = list(read_fastx(fn_idx_in))
                self._idx = build_index(
                    [r.name for r in refs], [r.seq for r in refs],
                    w=io.w, k=io.k, flag=io.flag,
                    bucket_bits=io.bucket_bits)
                if fn_idx_out is not None:
                    from .index.mmi import write_mmi
                    write_mmi(self._idx, fn_idx_out)
            mapopt_update(self.map_opt, self._idx)
        else:
            # in-memory single-sequence index (cmappy.h:140-150)
            self._idx = build_index(["N/A"], [seq], w=io.w, k=io.k,
                                    flag=io.flag & 1,
                                    bucket_bits=io.bucket_bits)
            mapopt_update(self.map_opt, self._idx)
            self.map_opt.mid_occ = 1000  # don't filter high-occ seeds

    def __bool__(self):
        return self._idx is not None

    def map(self, seq, seq2=None, buf=None, cs=False, MD=False,
            max_frag_len=None, extra_flags=None) -> Iterator[Alignment]:
        """mappy.Aligner.map (python/mappy.pyx:164-214): iterator of
        Alignment hits for one read (or a read pair via seq2)."""
        if self._idx is None:
            return
        import copy
        opt = copy.copy(self.map_opt)
        if max_frag_len is not None:
            opt.max_frag_len = max_frag_len
        if extra_flags is not None:
            opt.flag |= extra_flags

        mi = self._idx
        if seq2 is None:
            res = map_frag(mi, [seq], opt, device=self._device)
            regs = res.regs[0]
        else:
            # mm_map_aux (cmappy.h:74-109): map (seq1, revcomp(seq2)),
            # then flip the second segment's strand back
            res = map_frag(mi, [seq, revcomp(seq2)], opt,
                           device=self._device)
            for r in res.regs[1]:
                r.rev = not r.rev
            regs = res.regs[0] + res.regs[1]
        if costmodel.is_cuda(self._device):
            # the API has no end of run: a failed warm-up of the card
            # surfaces here, never as hits mapped without it
            costmodel.raise_probe_error()

        for r in regs:
            if r.p is None:
                continue
            cs_str = md_str = ""
            qseq = seq if r.seg_id == 0 or seq2 is None else revcomp(seq2)
            if cs:
                cs_str = write_cs_or_md(mi, qseq, r, no_iden=True,
                                        is_md=False, write_tag=False)
            if MD:
                md_str = write_cs_or_md(mi, qseq, r, no_iden=False,
                                        is_md=True, write_tag=False)
            trans = (1 if r.p.trans_strand == 1 else
                     -1 if r.p.trans_strand == 2 else 0)
            yield Alignment(
                mi.seq[r.rid].name, mi.seq[r.rid].length, r.rs, r.re,
                -1 if r.rev else 1, r.qs, r.qe, r.mapq,
                [[c >> 4, c & 0xF] for c in r.p.cigar],
                1 if r.id == r.parent else 0, r.mlen, r.blen,
                r.blen - r.mlen + r.p.n_ambi, trans, r.seg_id,
                cs_str, md_str)

    def seq(self, name: str, start: int = 0, end: int = 0x7FFFFFFF):
        """mappy.Aligner.seq (cmappy.h:122-138)."""
        if self._idx is None:
            return None
        rid = self._idx.name2id(name)
        if rid < 0:
            return None
        slen = self._idx.seq[rid].length
        if start >= slen or start >= end:
            return None
        if end < 0 or end > slen:
            end = slen
        codes = self._idx.getseq_fast(rid, start, end)
        return "".join("ACGTN"[c] for c in codes)

    @property
    def k(self):
        return self._idx.k

    @property
    def w(self):
        return self._idx.w

    @property
    def n_seq(self):
        return len(self._idx.seq)

    @property
    def seq_names(self):
        if self._idx is None:
            return None
        return [s.name for s in self._idx.seq]


def fastx_read(fn: str, read_comment: bool = False):
    """mappy.fastx_read (python/mappy.pyx:255-273)."""
    for rec in read_fastx(fn):
        qual = rec.qual if rec.qual else None
        if read_comment:
            yield rec.name, rec.seq, qual, getattr(rec, "comment", None)
        else:
            yield rec.name, rec.seq, qual


_verbose = 1


def verbose(v=None):
    """mappy.verbose: get/set the verbosity level."""
    global _verbose
    old = _verbose
    if v is not None and v >= 0:
        _verbose = v
    return old

"""PAF/SAM output formatting with the reference's exact tag set
(reference: format.c:280-561).

The port's copy of `mm2tpu/io/format.py`, verbatim apart from its
imports and its TPU branches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..mapping.hit import Region
from ..native import lib as _nlib
from ..options import (MM_F_OUT_CG, MM_F_OUT_CS, MM_F_OUT_MD, MM_F_OUT_CS_LONG,
                       MM_F_COPY_COMMENT, MM_F_SOFTCLIP, MM_F_NO_QUAL)

CIGAR_STR = "MIDNSHP=XB"
NT4_UPPER = "ACGTN"
NT4_LOWER = "acgtn"


def _fmt_float(v: float) -> str:
    """format.c:295-303: '0' for exact zero else %.4f."""
    if v == 0.0:
        return "0"
    return f"{v:.4f}"


def write_tags(r: Region) -> str:
    """format.c:280-306."""
    out = []
    if r.id == r.parent:
        typ = "I" if r.inv else "P"
    else:
        typ = "i" if r.inv else "S"
    if r.p:
        out.append(f"\tNM:i:{r.blen - r.mlen + r.p.n_ambi}\tms:i:{r.p.dp_max}"
                   f"\tAS:i:{r.p.dp_score}\tnn:i:{r.p.n_ambi}")
        if r.p.trans_strand in (1, 2):
            out.append(f"\tts:A:{'?+-?'[r.p.trans_strand]}")
    out.append(f"\ttp:A:{typ}\tcm:i:{r.cnt}\ts1:i:{r.score}")
    if r.parent == r.id:
        out.append(f"\ts2:i:{r.subsc}")
    if r.p:
        div = 1.0 - event_identity(r)
        out.append(f"\tde:f:{_fmt_float(div)}")
    elif 0.0 <= r.div <= 1.0:
        out.append(f"\tdv:f:{_fmt_float(r.div)}")
    if r.split:
        out.append(f"\tzd:i:{r.split}")
    return "".join(out)


def event_identity(r: Region) -> float:
    """mm_event_identity (format.c:268-278)."""
    if r.p is None:
        return -1.0
    n_gapo = n_gap = 0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op in (1, 2):
            n_gapo += 1
            n_gap += ln
    return r.mlen / (r.blen + r.p.n_ambi - n_gap + n_gapo)


def write_paf(mi, name: str, l_seq: int, r: Optional[Region], flag: int,
              rep_len: int, comment: Optional[str] = None,
              qseq: Optional[str] = None) -> str:
    """mm_write_paf3 (format.c:308-334)."""
    if r is None:
        s = f"{name}\t{l_seq}\t0\t0\t*\t*\t0\t0\t0\t0\t0\t0"
        if rep_len >= 0:
            s += f"\trl:i:{rep_len}"
        return s
    tname = mi.seq[r.rid].name if mi.seq[r.rid].name else str(r.rid)
    s = (f"{name}\t{l_seq}\t{r.qs}\t{r.qe}\t{'+-'[r.rev]}\t{tname}"
         f"\t{mi.seq[r.rid].length}\t{r.rs}\t{r.re}"
         f"\t{r.mlen}\t{r.blen}\t{r.mapq}")
    s += write_tags(r)
    if rep_len >= 0:
        s += f"\trl:i:{rep_len}"
    if r.p and (flag & MM_F_OUT_CG):
        if _nlib.has_cigar_str():
            s += "\tcg:Z:" + _nlib.cigar_str(r.p.cigar)
        else:
            s += "\tcg:Z:" + "".join(
                f"{c >> 4}{CIGAR_STR[c & 0xF]}" for c in r.p.cigar)
    if r.p and (flag & (MM_F_OUT_CS | MM_F_OUT_MD)) and qseq is not None:
        s += write_cs_or_md(mi, qseq, r, not (flag & MM_F_OUT_CS_LONG),
                            bool(flag & MM_F_OUT_MD), True)
    if (flag & MM_F_COPY_COMMENT) and comment:
        s += f"\t{comment}"
    return s


def write_cs_or_md(mi, qseq_str: str, r: Region, no_iden: bool, is_md: bool,
                   write_tag: bool) -> str:
    """write_cs_or_MD (format.c:220-243)."""
    from ..index.sketch import encode_nt4
    import numpy as np
    tseq = mi.getseq_fast(r.rid, r.rs, r.re)
    q_codes = encode_nt4(qseq_str)
    if not r.rev:
        qseq = q_codes[r.qs:r.qe]
    else:
        sub = q_codes[r.qs:r.qe][::-1]
        qseq = np.where(sub >= 4, 4, 3 - sub).astype(sub.dtype)
    if is_md:
        return _write_md(tseq, qseq, r, write_tag)
    return _write_cs(tseq, qseq, r, no_iden, write_tag)


def _write_cs(tseq, qseq, r: Region, no_iden: bool, write_tag: bool) -> str:
    out = ["\tcs:Z:"] if write_tag else []
    q_off = t_off = 0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8):  # match
            tmp = []
            for j in range(ln):
                if qseq[q_off + j] != tseq[t_off + j]:
                    if tmp:
                        out.append("=" + "".join(tmp) if not no_iden else f":{len(tmp)}")
                        tmp = []
                    out.append(f"*{NT4_LOWER[tseq[t_off + j]]}{NT4_LOWER[qseq[q_off + j]]}")
                else:
                    tmp.append(NT4_UPPER[qseq[q_off + j]])
            if tmp:
                out.append("=" + "".join(tmp) if not no_iden else f":{len(tmp)}")
            q_off += ln
            t_off += ln
        elif op == 1:
            out.append("+" + "".join(NT4_LOWER[b] for b in qseq[q_off:q_off + ln]))
            q_off += ln
        elif op == 2:
            out.append("-" + "".join(NT4_LOWER[b] for b in tseq[t_off:t_off + ln]))
            t_off += ln
        else:  # intron
            out.append(f"~{NT4_LOWER[tseq[t_off]]}{NT4_LOWER[tseq[t_off + 1]]}{ln}"
                       f"{NT4_LOWER[tseq[t_off + ln - 2]]}{NT4_LOWER[tseq[t_off + ln - 1]]}")
            t_off += ln
    return "".join(out)


def _write_md(tseq, qseq, r: Region, write_tag: bool) -> str:
    out = ["\tMD:Z:"] if write_tag else []
    q_off = t_off = l_md = 0
    for c in r.p.cigar:
        op, ln = c & 0xF, c >> 4
        if op in (0, 7, 8):
            for j in range(ln):
                if qseq[q_off + j] != tseq[t_off + j]:
                    out.append(f"{l_md}{NT4_UPPER[tseq[t_off + j]]}")
                    l_md = 0
                else:
                    l_md += 1
            q_off += ln
            t_off += ln
        elif op == 1:
            q_off += ln
        elif op == 2:
            out.append(f"{l_md}^" + "".join(NT4_UPPER[b] for b in tseq[t_off:t_off + ln]))
            l_md = 0
            t_off += ln
        elif op == 3:
            t_off += ln
    if l_md > 0:
        out.append(str(l_md))
    return "".join(out)


COMP = str.maketrans("ACGTacgt", "TGCAtgca")


_RG_ID = ""      # the reference's global mm_rg_id (format.c:9)
_RG_FAILED = False  # sam_write_rg_line returned -1 -> main exits 1


def _mm_escape(s: str) -> str:
    """mm_escape (format.c:68-80): \\t -> tab, \\\\ -> backslash,
    any other escape pair is dropped."""
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\":
            i += 1
            if i < len(s):
                if s[i] == "t":
                    out.append("\t")
                elif s[i] == "\\":
                    out.append("\\")
                # other escape pairs are dropped
        else:
            out.append(c)
        i += 1
    return "".join(out)


def _set_rg_line(rg: str):
    """sam_write_rg_line (format.c:82-116): validate, unescape, extract the
    ID field into the module rg-id; on error, print, omit the line and
    flag failure (the CLI exits 1 after printing the header, main.c:390)."""
    import sys as _sys
    global _RG_ID, _RG_FAILED
    _RG_ID = ""
    _RG_FAILED = True
    if not rg.startswith("@RG"):
        print("[ERROR] the read group line is not started with @RG",
              file=_sys.stderr)
        return None
    if "\t" in rg:
        print("[ERROR] the read group line contained literal <tab> "
              "characters -- replace with escaped tabs: \\t",
              file=_sys.stderr)
        return None
    line = _mm_escape(rg)
    i = line.find("\tID:")
    if i < 0:
        print("[ERROR] no ID within the read group line", file=_sys.stderr)
        return None
    j = i + 4
    k = j
    while k < len(line) and line[k] not in "\t\n":
        k += 1
    if k - j + 1 > 256:
        print("[ERROR] @RG:ID is longer than 255 characters",
              file=_sys.stderr)
        return None
    _RG_ID = line[j:k]
    _RG_FAILED = False
    return line


def sam_header(mi, rg: Optional[str], ver: str, cmdline: Optional[str]) -> str:
    global _RG_ID, _RG_FAILED
    _RG_ID = ""  # reset: in-process runs must not inherit a previous -R
    _RG_FAILED = False
    lines = []
    if mi is not None:
        for s in mi.seq:
            lines.append(f"@SQ\tSN:{s.name}\tLN:{s.length}")
    if rg:
        rg_line = _set_rg_line(rg)
        if rg_line:
            lines.append(rg_line)
    pg = f"@PG\tID:minimap2\tPN:minimap2\tVN:{ver}"
    if cmdline:
        pg += f"\tCL:{cmdline}"
    lines.append(pg)
    return "\n".join(lines)


def write_sam(mi, seq, seg_idx: int, reg_idx: int, n_seg: int,
              n_regss: Sequence[int], regss, flag: int, rep_len: int,
              rg_id: str = "") -> str:
    """mm_write_sam3 (format.c:391-548)."""
    regs: List[Region] = regss[seg_idx]
    n_regs = n_regss[seg_idx]
    r = regs[reg_idx] if (0 <= reg_idx < n_regs) else None

    r_prev = r_next = None
    if n_seg > 1:
        next_sid = (seg_idx + 1) % n_seg
        r_next = _get_sam_pri(regss[next_sid])
        if n_seg > 2:
            for i in range(1, n_seg):
                prev_sid = (seg_idx + n_seg - i) % n_seg
                if n_regss[prev_sid] > 0:
                    r_prev = _get_sam_pri(regss[prev_sid])
                    break
        else:
            r_prev = r_next

    name = seq.name
    if n_seg > 1:
        from .bseq import _qname_len
        name = name[: _qname_len(name)]
    out = [name]

    sam_flag = 0x1 if n_seg > 1 else 0x0
    if r is None:
        sam_flag |= 0x4
    else:
        if r.rev:
            sam_flag |= 0x10
        if r.parent != r.id:
            sam_flag |= 0x100
        elif not r.sam_pri:
            sam_flag |= 0x800
    if n_seg > 1:
        if r and r.proper_frag:
            sam_flag |= 0x2
        if seg_idx == 0:
            sam_flag |= 0x40
        elif seg_idx == n_seg - 1:
            sam_flag |= 0x80
        if r_next is None:
            sam_flag |= 0x8
        elif r_next.rev:
            sam_flag |= 0x20
    out.append(f"\t{sam_flag}")

    this_rid = this_pos = -1
    if r is None:
        if r_prev:
            this_rid, this_pos = r_prev.rid, r_prev.rs
            out.append(f"\t{mi.seq[this_rid].name}\t{this_pos + 1}\t0\t*")
        else:
            out.append("\t*\t0\t0\t*")
    else:
        this_rid, this_pos = r.rid, r.rs
        out.append(f"\t{mi.seq[r.rid].name}\t{r.rs + 1}\t{r.mapq}\t")
        out.append(_sam_cigar(sam_flag, seq.l_seq, r, flag))

    if n_seg > 1:
        tlen = 0
        if this_rid >= 0 and r_next:
            if this_rid == r_next.rid:
                if r:
                    this_pos5 = r.re - 1 if r.rev else this_pos
                    next_pos5 = r_next.re - 1 if r_next.rev else r_next.rs
                    tlen = next_pos5 - this_pos5
                out.append("\t=\t")
            else:
                out.append(f"\t{mi.seq[r_next.rid].name}\t")
            out.append(f"{r_next.rs + 1}\t")
        elif r_next:
            out.append(f"\t{mi.seq[r_next.rid].name}\t{r_next.rs + 1}\t")
        elif this_rid >= 0:
            out.append(f"\t=\t{this_pos + 1}\t")
        else:
            out.append("\t*\t0\t")
        if tlen > 0:
            tlen += 1
        elif tlen < 0:
            tlen -= 1
        out.append(f"{tlen}\t")
    else:
        out.append("\t*\t0\t0\t")

    # SEQ and QUAL (-Q drops quals at read time in the reference,
    # map.c's mm_bseq_read3 with_qual arg; observably: QUAL becomes *)
    qual = None if (flag & MM_F_NO_QUAL) else seq.qual
    if r is None:
        out.append(seq.seq)
        out.append("\t")
        out.append(qual if qual else "*")
    else:
        if (sam_flag & 0x900) == 0 or (flag & MM_F_SOFTCLIP):
            out.append(_revcomp(seq.seq) if r.rev else seq.seq)
            out.append("\t")
            if qual:
                out.append(qual[::-1] if r.rev else qual)
            else:
                out.append("*")
        elif sam_flag & 0x100:
            out.append("*\t*")
        else:
            sub = seq.seq[r.qs:r.qe]
            out.append(_revcomp(sub) if r.rev else sub)
            out.append("\t")
            if qual:
                qsub = qual[r.qs:r.qe]
                out.append(qsub[::-1] if r.rev else qsub)
            else:
                out.append("*")

    rg_eff = rg_id or _RG_ID
    if rg_eff:
        out.append(f"\tRG:Z:{rg_eff}")
    if n_seg > 2:
        out.append(f"\tFI:i:{seg_idx}")
    if r is not None:
        out.append(write_tags(r))
        if r.parent == r.id and r.p and n_regs > 1:
            sa = []
            for q in regs:
                if q is r or q.parent != q.id or q.p is None:
                    continue
                if q.qe - q.qs < q.re - q.rs:
                    l_m = q.qe - q.qs
                    l_d = (q.re - q.rs) - l_m
                    l_i = 0
                else:
                    l_m = q.re - q.rs
                    l_i = (q.qe - q.qs) - l_m
                    l_d = 0
                clip5 = seq.l_seq - q.qe if q.rev else q.qs
                clip3 = q.qs if q.rev else seq.l_seq - q.qe
                part = f"{mi.seq[q.rid].name},{q.rs + 1},{'+-'[q.rev]},"
                if clip5:
                    part += f"{clip5}S"
                if l_m:
                    part += f"{l_m}M"
                if l_i:
                    part += f"{l_i}I"
                if l_d:
                    part += f"{l_d}D"
                if clip3:
                    part += f"{clip3}S"
                part += f",{q.mapq},{q.blen - q.mlen + q.p.n_ambi};"
                sa.append(part)
            if sa:
                out.append("\tSA:Z:" + "".join(sa))
        if r.p and (flag & (MM_F_OUT_CS | MM_F_OUT_MD)):
            out.append(write_cs_or_md(mi, seq.seq, r, not (flag & MM_F_OUT_CS_LONG),
                                      bool(flag & MM_F_OUT_MD), True))
    if rep_len >= 0:
        out.append(f"\trl:i:{rep_len}")
    if (flag & MM_F_COPY_COMMENT) and seq.comment:
        out.append(f"\t{seq.comment}")
    return "".join(out)


def _get_sam_pri(regs: List[Region]) -> Optional[Region]:
    for r in regs:
        if r.sam_pri:
            return r
    return None


def _sam_cigar(sam_flag: int, qlen: int, r: Region, opt_flag: int) -> str:
    """write_sam_cigar (format.c:365-389)."""
    if r.p is None:
        return "*"
    clip0 = qlen - r.qe if r.rev else r.qs
    clip1 = r.qs if r.rev else qlen - r.qe
    clip_char = "H" if (sam_flag & 0x800) and not (opt_flag & MM_F_SOFTCLIP) else "S"
    if _nlib.has_cigar_str():
        return _nlib.cigar_str(r.p.cigar, clip0, clip1, clip_char)
    s = ""
    if clip0:
        s += f"{clip0}{clip_char}"
    s += "".join(f"{c >> 4}{CIGAR_STR[c & 0xF]}" for c in r.p.cigar)
    if clip1:
        s += f"{clip1}{clip_char}"
    return s


def _revcomp(s: str) -> str:
    return s.translate(COMP)[::-1]

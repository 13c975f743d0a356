"""PAF post-processing toolkit — the `paftools` companion of the mapper.

A from-scratch Python implementation of the toolkit the reference ships as
`misc/paftools.js` (k8 JavaScript).  Subcommand semantics and output formats
follow the reference (cited per function); the code is new and idiomatic
Python.  Usage:

    python -m mm2tpu_torch.tools.paftools <command> [options] [args]

Commands: view, stat, sam2paf, liftover, call, mapeval, junceval, gff2bed,
splice2bed, bedcov, ov-eval, vcfstat, pbsim2fq, mason2fq, version.

The port's copy of `mm2tpu/tools/paftools.py`, verbatim apart from this
docstring (its imports are the standard library's and its own package's).
"""
from __future__ import annotations

import gzip
import re
import sys
from typing import Dict, List, Optional, TextIO

VERSION = "0.1.0 (paftools parity target: misc/paftools.js 2.18-r1015)"

RE_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")
RE_CS = re.compile(r"([:=*+\-])(\d+|[A-Za-z]+)")

_RC = str.maketrans("WSATUGCYRKMBDHVNwsatugcyrkmbdhvn",
                    "WSTAACGRYMKVHDBNwstaacgrymkvhdbn")


def revcomp(s: str) -> str:
    return s.translate(_RC)[::-1]


def _open(fn: str) -> TextIO:
    if fn == "-":
        return sys.stdin
    if fn.endswith(".gz"):
        return gzip.open(fn, "rt")
    return open(fn)


def _p(*cols) -> None:
    print("\t".join(str(c) for c in cols))


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr)


def fasta_read(fn: str):
    """{name: seq} plus ordered [(name, len)] (paftools.js:134-160)."""
    h: Dict[str, str] = {}
    order: List[tuple] = []
    name, parts = None, []
    with _open(fn) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    seq = "".join(parts)
                    h[name] = seq
                    order.append((name, len(seq)))
                name = line[1:].split()[0]
                parts = []
            elif name is not None:
                parts.append(line.strip())
    if name is not None:
        seq = "".join(parts)
        h[name] = seq
        order.append((name, len(seq)))
    return h, order


# ---------------------------------------------------------------------------
# Interval operations (paftools.js:55-128)

def intv_sort(a: List[list]) -> None:
    a.sort(key=lambda x: (x[0], x[1]))


def intv_merge(a: List[list], sorted_: bool = True) -> None:
    if not a:
        return
    if not sorted_:
        intv_sort(a)
    k = 0
    for i in range(1, len(a)):
        if a[k][1] >= a[i][0]:
            a[k][1] = max(a[k][1], a[i][1])
        else:
            k += 1
            a[k] = list(a[i])
    del a[k + 1:]


def intv_index_end(a: List[list], sorted_: bool = True) -> None:
    """Append, to each interval, the smallest index whose end might overlap
    it — enables the linear scan in intv_find_ovlp (paftools.js:77-93)."""
    if not a:
        return
    if not sorted_:
        intv_sort(a)
    a[0].append(0)
    k, k_en = 0, a[0][1]
    for i in range(1, len(a)):
        if k_en <= a[i][0]:
            k += 1
            while k < i and a[k][1] <= a[i][0]:
                k += 1
            k_en = a[k][1]
        a[i].append(k)


def _find_intv(a: List[list], x: int) -> int:
    left, right = -1, len(a)
    while right - left > 1:
        mid = left + ((right - left) >> 1)
        if a[mid][0] > x:
            right = mid
        elif a[mid][0] < x:
            left = mid
        else:
            return mid
    return left


def intv_find_ovlp(a: List[list], st: int, en: int) -> List[list]:
    if not a or st >= en:
        return []
    l = _find_intv(a, st)
    k = 0 if l < 0 else a[l][-1]
    b = []
    for i in range(k, len(a)):
        if a[i][0] >= en:
            break
        if st < a[i][1]:
            b.append(a[i])
    return b


def _read_bed_simple(fn: str, to_merge: bool):
    """chr -> sorted/merged/end-indexed [st, en] list (paftools.js:208-230)."""
    bed: Dict[str, List[list]] = {}
    with _open(fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            bed.setdefault(t[0], []).append([int(t[1]), int(t[2])])
    for chrom in bed:
        intv_sort(bed[chrom])
        if to_merge:
            intv_merge(bed[chrom], True)
        intv_index_end(bed[chrom], True)
    return bed


# ---------------------------------------------------------------------------
# liftover (paftools.js:206-337)

def cmd_liftover(argv: List[str]) -> int:
    to_merge, min_mapq, min_len, max_div = False, 5, 50000, 2.0
    args = _getopt(argv, "mq:l:d:")
    for o, v in args.opts:
        if o == "m":
            to_merge = True
        elif o == "q":
            min_mapq = int(v)
        elif o == "l":
            min_len = int(v)
        elif o == "d":
            max_div = float(v)
    if len(args.pos) < 2:
        _warn("Usage: paftools liftover [options] <aln.paf> <query.bed>")
        _warn("Options:")
        _warn("  -q INT    min mapping quality [%d]" % min_mapq)
        _warn("  -l INT    min alignment length [%d]" % min_len)
        _warn("  -d FLOAT  max sequence divergence (>=1 to disable) [1]")
        return 1
    bed = _read_bed_simple(args.pos[1], to_merge)

    with _open(args.pos[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0] not in bed:
                continue
            tp = cg = None
            for col in t[12:]:
                if col.startswith("tp:A:"):
                    tp = col[5:]
                elif col.startswith("cg:Z:"):
                    cg = col[5:]
            if tp not in ("P", "I"):
                continue
            if cg is None:
                raise RuntimeError("unable to find the 'cg' tag")
            qlen, qs, qe = int(t[1]), int(t[2]), int(t[3])
            strand = t[4]
            ts, te, mlen, blen, mapq = (int(t[7]), int(t[8]), int(t[9]),
                                        int(t[10]), int(t[11]))
            if mapq < min_mapq or blen < min_len:
                continue
            regs = intv_find_ovlp(bed[t[0]], qs, qe)
            if not regs:
                continue
            if 0.0 <= max_div < 1.0:
                n_gaps = n_opens = 0
                for m in RE_CIGAR.finditer(cg):
                    if m.group(2) in "ID":
                        n_gaps += int(m.group(1))
                        n_opens += 1
                n_mm = blen - mlen - n_gaps
                n_diff2 = n_mm + n_opens
                if n_diff2 / (n_diff2 + mlen) > max_div:
                    continue
            # query positions to lift, in strand-of-alignment coordinates
            a: List[list] = []
            r: List[list] = []
            for i, reg in enumerate(regs):
                s, e = reg[0], reg[1]
                if strand == "+":
                    a.append([s, 0, i, -2])
                    a.append([e - 1, 1, i, -2])
                else:
                    a.append([qlen - e, 0, i, -2])
                    a.append([qlen - s - 1, 1, i, -2])
                r.append([-2, -2])
            a.sort(key=lambda x: x[0])

            k, x = 0, ts
            y = qs if strand == "+" else qlen - qe
            for m in RE_CIGAR.finditer(cg):
                ln, op = int(m.group(1)), m.group(2)
                if op == "D":
                    x += ln
                    continue
                while k < len(a) and a[k][0] < y:
                    k += 1
                for i in range(k, len(a)):
                    if y <= a[i][0] < y + ln:
                        a[i][3] = x + (a[i][0] - y) if op == "M" else x
                    else:
                        break
                y += ln
                if op == "M":
                    x += ln
            if x != te or (strand == "+" and y != qe) or \
                    (strand == "-" and y != qlen - qs):
                raise RuntimeError(
                    "CIGAR is inconsistent with mapping coordinates")
            for pos, which, i, lifted in a:
                if which == 0:
                    r[i][0] = lifted
                else:
                    r[i][1] = lifted + 1
            for i, reg in enumerate(regs):
                name = "_".join(map(str, (t[0], reg[0], reg[1])))
                if r[i][0] < 0:
                    name += "_t5"
                    r[i][0] = ts
                if r[i][1] < 0:
                    name += "_t3"
                    r[i][1] = te
                _p(t[5], r[i][0], r[i][1], name, 0, strand)
    return 0


# ---------------------------------------------------------------------------
# call (paftools.js:340-564)

def cmd_call(argv: List[str]) -> int:
    min_cov_len, min_var_len = 10000, 50000
    gap_thres, gap_thres_long, min_mapq = 50, 1000, 5
    fa = fa_lens = None
    sample_name = "sample"
    args = _getopt(argv, "l:L:g:G:q:B:f:s:")
    for o, v in args.opts:
        if o == "l":
            min_cov_len = int(v)
        elif o == "L":
            min_var_len = int(v)
        elif o == "g":
            gap_thres = int(v)
        elif o == "G":
            gap_thres_long = int(v)
        elif o == "q":
            min_mapq = int(v)
        elif o == "f":
            fa, fa_lens = fasta_read(v)
        elif o == "s":
            sample_name = v
    is_vcf = fa is not None
    if not args.pos:
        _warn("Usage: sort -k6,6 -k8,8n <with-cs.paf> | paftools call "
              "[options] -")
        return 1

    tot_len = 0
    n_sub = [0, 0, 0]
    n_ins = [0] * 5
    n_del = [0] * 5

    def print_vcf(o):
        if o[3] != 1 or (o[5] == "-" and o[6] == "-"):
            return
        if o[5] != "-" and o[6] != "-":
            v = [o[0], o[1] + 1, ".", o[5].upper(), o[6].upper()]
        elif o[1] > 0:
            if o[0] not in fa:
                raise RuntimeError(
                    'sequence "%s" is absent from the reference FASTA' % o[0])
            if o[1] >= len(fa[o[0]]):
                raise RuntimeError(
                    "position %d exceeds the length of sequence %s"
                    % (o[1], o[0]))
            ref = fa[o[0]][o[1] - 1].upper()
            if o[5] == "-":
                v = [o[0], o[1], ".", ref, ref + o[6].upper()]
            else:
                v = [o[0], o[1], ".", ref + o[5].upper(), ref]
        else:
            return
        v += [o[4], ".",
              "QNAME=%s;QSTART=%d;QSTRAND=%s" % (o[7], o[8] + 1, o[10]),
              "GT", "1/1"]
        _p(*v)

    def count_var(o):
        if o[3] > 1 or (o[5] == "-" and o[6] == "-"):
            return
        if o[5] == "-":
            l = len(o[6])
            bins = n_ins
        elif o[6] == "-":
            l = len(o[5])
            bins = n_del
        else:
            n_sub[0] += 1
            s = (o[5] + o[6]).lower()
            if s in ("ag", "ga", "ct", "tc"):
                n_sub[1] += 1
            else:
                n_sub[2] += 1
            return
        if l == 1:
            bins[0] += 1
        elif l == 2:
            bins[1] += 1
        elif l < gap_thres:
            bins[2] += 1
        elif l < gap_thres_long:
            bins[3] += 1
        else:
            bins[4] += 1

    if is_vcf:
        print("##fileformat=VCFv4.1")
        for name, ln in fa_lens:
            print("##contig=<ID=%s,length=%d>" % (name, ln))
        print('##INFO=<ID=QNAME,Number=1,Type=String,'
              'Description="Query name">')
        print('##INFO=<ID=QSTART,Number=1,Type=Integer,'
              'Description="Query start">')
        print('##INFO=<ID=QSTRAND,Number=1,Type=String,'
              'Description="Query strand">')
        print('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">')
        _p("#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO",
           "FORMAT", sample_name)

    a: List[list] = []
    out: List[list] = []
    c1_ctg, c1_start, c1_end, c1_counted, c1_len = None, 0, 0, False, 0
    with _open(args.pos[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            t = line.split("\t")
            if len(t) < 12 or t[5] == "*":
                continue
            blen, mapq = int(t[10]), int(t[11])
            if blen < min_cov_len or mapq < min_mapq:
                continue
            ctg, x, end = t[5], int(t[7]), int(t[8])
            query, rev = t[0], t[4] == "-"
            y = int(t[3]) if rev else int(t[2])
            cs = tp = None
            have_s1 = have_s2 = False
            for col in t[12:]:
                if col.startswith("cs:Z:"):
                    cs = col[5:]
                elif col.startswith("tp:A:"):
                    tp = col[5:]
                elif col.startswith("s1:i:"):
                    have_s1 = True
                elif col.startswith("s2:i:"):
                    have_s2 = True
            if have_s1 and not have_s2:
                continue
            if tp in ("S", "i"):
                continue
            # regions covered by exactly one contig
            if ctg != c1_ctg or x >= c1_end:
                if c1_counted and c1_end > c1_start:
                    c1_len += c1_end - c1_start
                    if not is_vcf:
                        _p("R", c1_ctg, c1_start, c1_end)
                c1_ctg, c1_start, c1_end = ctg, x, end
                c1_counted = blen >= min_var_len
            elif end > c1_end:  # overlap
                if c1_counted and x > c1_start:
                    c1_len += x - c1_start
                    if not is_vcf:
                        _p("R", c1_ctg, c1_start, x)
                c1_start, c1_end = c1_end, end
                c1_counted = blen >= min_var_len
            elif end > c1_start:  # contained
                if c1_counted and x > c1_start:
                    c1_len += x - c1_start
                    if not is_vcf:
                        _p("R", c1_ctg, c1_start, x)
                c1_start = end
            # flush variants entirely before this alignment
            while out:
                if out[0][0] != ctg or out[0][2] <= x:
                    count_var(out[0])
                    if is_vcf:
                        print_vcf(out[0])
                    else:
                        _p("V", *out[0])
                    out.pop(0)
                else:
                    break
            for o in out:
                if o[1] >= x and o[2] <= end:
                    o[3] += 1
            a = [al for al in a if al[0] == ctg and al[2] > x]
            if blen >= min_var_len and cs is not None:
                tot_len += blen
                for m in RE_CS.finditer(cs):
                    op, val = m.group(1), m.group(2)
                    cov = 1
                    if op in "*+-":
                        cov += sum(1 for al in a if al[2] > x)
                    if op in ":=":
                        l = len(val) if op == "=" else int(val)
                        y = y - l if rev else y + l
                        x += l
                    elif op == "*":
                        if rev:
                            qs, qe = y - 1, y
                            y -= 1
                        else:
                            qs, qe = y, y + 1
                            y += 1
                        br, bq = val[0], val[1]
                        if br != "n" and bq != "n":
                            out.append([ctg, x, x + 1, cov, mapq, br, bq,
                                        query, qs, qe, "-" if rev else "+"])
                        x += 1
                    elif op == "+":
                        l = len(val)
                        if rev:
                            qs, qe = y - l, y
                            y -= l
                        else:
                            qs, qe = y, y + l
                            y += l
                        out.append([ctg, x, x, cov, mapq, "-", val,
                                    query, qs, qe, "-" if rev else "+"])
                    elif op == "-":
                        l = len(val)
                        out.append([ctg, x, x + l, cov, mapq, val, "-",
                                    query, y, y, "-" if rev else "+"])
                        x += l
            a.append([ctg, int(t[7]), end])
    if c1_counted and c1_end > c1_start:
        c1_len += c1_end - c1_start
        if not is_vcf:
            _p("R", c1_ctg, c1_start, c1_end)
    for o in out:
        count_var(o)
        if is_vcf:
            print_vcf(o)
        else:
            _p("V", *o)

    _warn("%d reference bases covered by exactly one contig" % c1_len)
    tstv = n_sub[1] / n_sub[2] if n_sub[2] else float("nan")
    _warn("%d substitutions; ts/tv = %.3f" % (n_sub[0], tstv))
    _warn("%d 1bp deletions" % n_del[0])
    _warn("%d 1bp insertions" % n_ins[0])
    _warn("%d 2bp deletions" % n_del[1])
    _warn("%d 2bp insertions" % n_ins[1])
    _warn("%d [3,%d) deletions" % (n_del[2], gap_thres))
    _warn("%d [3,%d) insertions" % (n_ins[2], gap_thres))
    _warn("%d [%d,%d) deletions" % (n_del[3], gap_thres, gap_thres_long))
    _warn("%d [%d,%d) insertions" % (n_ins[3], gap_thres, gap_thres_long))
    _warn("%d >=%d deletions" % (n_del[4], gap_thres_long))
    _warn("%d >=%d insertions" % (n_ins[4], gap_thres_long))
    return 0


# ---------------------------------------------------------------------------
# stat (paftools.js:963-1128)

def cmd_stat(argv: List[str]) -> int:
    gap_out_len: Optional[int] = None
    count_err = False
    args = _getopt(argv, "cl:")
    for o, v in args.opts:
        if o == "l":
            gap_out_len = int(v)
        elif o == "c":
            count_err = True
    if not args.pos:
        _warn("Usage: paftools stat [-c] [-l gapOutLen] <in.sam>|<in.paf>")
        return 1

    lineno = n_pri = n_2nd = n_seq = n_cigar_64k = l_tot = l_cov = 0
    n_gap = [[0] * 6, [0] * 6]

    def cov_len(regs: List[list]) -> int:
        regs.sort(key=lambda r: r[0])
        st, en, l = regs[0][0], regs[0][1], 0
        for r in regs[1:]:
            if r[0] < en:
                en = max(en, r[1])
            else:
                l += en - st
                st, en = r[0], r[1]
        return l + (en - st)

    last = last_qlen = None
    regs: List[list] = []
    with _open(args.pos[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            lineno += 1
            if line.startswith("@"):
                continue
            t = line.split("\t")
            if len(t) < 2:
                continue
            NM = atlen = None
            is_sam = is_rev = False
            if t[4] in "+-*":  # PAF
                if t[4] == "*":
                    continue
                if "\ts2:i:" not in line:
                    n_2nd += 1
                    continue
                m = re.search(r"\tNM:i:(\d+)", line)
                if m:
                    NM = int(m.group(1))
                m = re.search(r"\tcg:Z:(\S+)", line)
                cigar = m.group(1) if m else None
                if cigar is None:
                    _warn("WARNING: no CIGAR at line %d" % lineno)
                    continue
                tname = t[5]
                qs, qe = int(t[2]), int(t[3])
                aqlen = qe - qs
                is_rev = t[4] == "-"
                rs = int(t[7])
                atlen = int(t[8]) - rs
                mapq = int(t[11])
                ori_qlen = int(t[1])
            else:  # SAM
                flag = int(t[1])
                if (flag & 4) or t[2] == "*" or t[5] == "*":
                    continue
                if flag & 0x100:
                    n_2nd += 1
                    continue
                m = re.search(r"\tNM:i:(\d+)", line)
                if m:
                    NM = int(m.group(1))
                cigar = t[5]
                tname = t[2]
                rs = int(t[3]) - 1
                mapq = int(t[4])
                aqlen = len(t[9])
                is_sam = True
                is_rev = bool(flag & 0x10)
            n_pri += 1
            if last != t[0]:
                if last is not None:
                    l_tot += last_qlen
                    l_cov += cov_len(regs)
                regs = []
                n_seq += 1
                last = t[0]
            M = tl = ql = sclip = n_cigar = 0
            clip = [0, 0]
            n_gapo = n_gap_all = l_match = 0
            for m in RE_CIGAR.finditer(cigar):
                l, op = int(m.group(1)), m.group(2)
                n_cigar += 1
                if op in "M=X":
                    tl += l
                    ql += l
                    M += l
                    l_match += l
                elif op in "ID":
                    if l < 50:
                        typ = 0
                    elif l < 100:
                        typ = 1
                    elif l < 300:
                        typ = 2
                    elif l < 400:
                        typ = 3
                    elif l < 1000:
                        typ = 4
                    else:
                        typ = 5
                    if op == "I":
                        ql += l
                        n_gap[0][typ] += 1
                    else:
                        tl += l
                        n_gap[1][typ] += 1
                    if gap_out_len is not None and l >= gap_out_len:
                        _p(t[0], ql, "-" if is_rev else "+", tname,
                           rs + tl, op, l)
                    n_gapo += 1
                    n_gap_all += l
                elif op == "N":
                    tl += l
                elif op == "S":
                    clip[0 if M == 0 else 1] = l
                    sclip += l
                elif op == "H":
                    clip[0 if M == 0 else 1] = l
            if n_cigar > 65535:
                n_cigar_64k += 1
            if ql + sclip != aqlen:
                _warn("WARNING: aligned query length is inconsistent with "
                      "CIGAR at line %d (%d != %d)"
                      % (lineno, ql + sclip, aqlen))
            if atlen is not None and atlen != tl:
                _warn("WARNING: aligned reference length is inconsistent "
                      "with CIGAR at line %d" % lineno)
            if is_sam:
                qs = clip[1 if is_rev else 0]
                qe = qs + ql
                ori_qlen = clip[0] + ql + clip[1]
            if count_err and NM is not None:
                n_mm = max(NM - n_gap_all, 0)
                if NM - n_gap_all < 0:
                    _warn("WARNING: NM is smaller than the number of gaps "
                          "at line %d" % lineno)
                _p(t[0], ori_qlen, t[11], ori_qlen - (qe - qs), NM,
                   l_match + n_gap_all, n_mm + n_gapo, l_match + n_gapo)
            regs.append([qs, qe])
            last_qlen = ori_qlen
    if regs:
        l_tot += last_qlen
        l_cov += cov_len(regs)

    if gap_out_len is None and not count_err:
        print("Number of mapped sequences: %d" % n_seq)
        print("Number of primary alignments: %d" % n_pri)
        print("Number of secondary alignments: %d" % n_2nd)
        print("Number of primary alignments with >65535 CIGAR operations: %d"
              % n_cigar_64k)
        print("Number of bases in mapped sequences: %d" % l_tot)
        print("Number of mapped bases: %d" % l_cov)
        bounds = ["[0,50)", "[50,100)", "[100,300)", "[300,400)",
                  "[400,1000)", "[1000,inf)"]
        for i, b in enumerate(bounds):
            print("Number of insertions in %s: %d" % (b, n_gap[0][i]))
        for i, b in enumerate(bounds):
            print("Number of deletions in %s: %d" % (b, n_gap[1][i]))
    return 0


# ---------------------------------------------------------------------------
# bedcov (paftools.js:1130-1249)

def cmd_bedcov(argv: List[str]) -> int:
    print_len, to_merge, to_dedup, fn_excl = False, True, False, None
    args = _getopt(argv, "pde:")
    for o, v in args.opts:
        if o == "p":
            print_len = True
        elif o == "d":
            to_dedup, to_merge = True, False
        elif o == "e":
            fn_excl = v
    if len(args.pos) < 2:
        _warn("Usage: paftools bedcov [options] <regions.bed> <target.bed>")
        return 1

    def read_bed(fn: str, merge: bool, dedup: bool):
        h: Dict[str, List[list]] = {}
        with _open(fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                lst = h.setdefault(t[0], [])
                bst, ben = int(t[1]), int(t[2])
                if len(t) >= 12 and t[9].isdigit():
                    nb = int(t[9])
                    sz = t[10].split(",")
                    st = t[11].split(",")
                    for i in range(nb):
                        s = bst + int(st[i])
                        lst.append([s, s + int(sz[i]), 0, 0, 0])
                else:
                    lst.append([bst, ben, 0, 0, 0])
        for chrom in h:
            if merge:
                intv_merge(h[chrom], False)
            elif dedup:
                intv_sort(h[chrom])
                k = 0
                e = h[chrom]
                for i in range(1, len(e)):
                    if e[i][0] != e[k][0] or e[i][1] != e[k][1]:
                        k += 1
                        e[k] = e[i]
                del e[k + 1:]
            else:
                intv_sort(h[chrom])
            intv_index_end(h[chrom])
        return h

    excl = read_bed(fn_excl, True, False) if fn_excl else None
    target = read_bed(args.pos[0], to_merge, to_dedup)

    tot_len = hit_len = 0
    with _open(args.pos[1]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            a: List[list] = []
            bst, ben = int(t[1]), int(t[2])
            if len(t) >= 12 and t[9].isdigit():
                nb = int(t[9])
                sz = t[10].split(",")
                st = t[11].split(",")
                for i in range(nb):
                    s = bst + int(st[i])
                    a.append([s, s + int(sz[i]), False])
            else:
                a.append([bst, ben, False])
            feat_len = 0
            for blk in a:
                if excl is not None and t[0] in excl and \
                        intv_find_ovlp(excl[t[0]], blk[0], blk[1]):
                    continue
                blk[2] = True
                feat_len += blk[1] - blk[0]
            tot_len += feat_len
            if t[0] not in target:
                continue
            b: List[list] = []
            for blk in a:
                if not blk[2]:
                    continue
                for o in intv_find_ovlp(target[t[0]], blk[0], blk[1]):
                    max_st = max(o[0], blk[0])
                    min_en = min(o[1], blk[1])
                    b.append([max_st, min_en])
                    o[2] += min_en - max_st
                    o[3] += 1
                    if max_st == o[0] and min_en == o[1]:
                        o[4] += 1
            feat_hit_len = 0
            if b:
                b.sort(key=lambda x: x[0])
                st_, en_ = b[0][0], b[0][1]
                for x in b[1:]:
                    if x[0] <= en_:
                        en_ = max(en_, x[1])
                    else:
                        feat_hit_len += en_ - st_
                        st_, en_ = x[0], x[1]
                feat_hit_len += en_ - st_
            hit_len += feat_hit_len
            if print_len:
                _p("F", "\t".join(t[:4]), feat_len, feat_hit_len)
    _warn("# target bases: %d" % tot_len)
    _warn("# target bases overlapping regions: %d (%.2f%%)"
          % (hit_len, 100.0 * hit_len / tot_len if tot_len else 0.0))
    return 0


# ---------------------------------------------------------------------------
# view (paftools.js:1354-1514)

def cmd_view(argv: List[str]) -> int:
    line_len, fmt = 80, "aln"
    args = _getopt(argv, "f:l:")
    for o, v in args.opts:
        if o == "f":
            fmt = v
            if fmt not in ("aln", "lastz-cigar", "maf"):
                raise RuntimeError(
                    "format must be one of aln, lastz-cigar and maf")
        elif o == "l":
            line_len = int(v)
    if line_len == 0:
        line_len = 0x7FFFFFFF
    if not args.pos:
        _warn("Usage: paftools view [options] <in.paf>")
        return 1

    def pad(x, ln: int, right: bool) -> str:
        s = str(x)
        return s.ljust(ln) if right else s.rjust(ln)

    class Aln:
        def __init__(self):
            self.ref: List[str] = []
            self.qry: List[str] = []
            self.mid: List[str] = []

        def __len__(self):
            return sum(len(s) for s in self.ref)

        def clear(self):
            self.ref, self.qry, self.mid = [], [], []

        def update(self, op: str, seq: str, elen: List[int]):
            l = 1 if op == "*" else len(seq)
            if op in ":=":
                self.ref.append(seq)
                self.qry.append(seq)
                self.mid.append("|" * l)
                elen[0] += l
                elen[1] += l
            elif op == "*":
                self.ref.append(seq[0])
                self.qry.append(seq[1])
                self.mid.append(" ")
                elen[0] += 1
                elen[1] += 1
            elif op == "+":
                self.ref.append("-" * l)
                self.qry.append(seq)
                self.mid.append(" " * l)
                elen[1] += l
            elif op == "-":
                self.ref.append(seq)
                self.qry.append("-" * l)
                self.mid.append(" " * l)
                elen[0] += l

        def emit(self, rs: int, qs: int, strand: str, slen: List[int],
                 elen: List[int]):
            print(" ".join(["Ref+:", pad(rs + slen[0] + 1, 10, False),
                            "".join(self.ref), pad(rs + elen[0], 10, True)]))
            print("                 " + "".join(self.mid))
            if strand == "+":
                st, en = qs + slen[1] + 1, qs + elen[1]
            else:
                st, en = qs - slen[1], qs - elen[1] + 1
            print(" ".join(["Qry" + strand + ":", pad(st, 10, False),
                            "".join(self.qry), pad(en, 10, True)]))

    aln = Aln()
    lineno = 0
    if fmt == "maf":
        print("##maf version=1\n")
    with _open(args.pos[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            t = line.split("\t")
            lineno += 1
            aln.clear()
            slen, elen = [0, 0], [0, 0]
            if fmt == "lastz-cigar":
                m = re.search(r"\tcg:Z:(\S+)", line)
                if m is None:
                    _warn("WARNING: converting to LASTZ-cigar format requires"
                          " the 'cg' tag, which is absent on line %d"
                          % lineno)
                    continue
                cg = m.group(1)
                ms = re.search(r"\tAS:i:(\d+)", line)
                score = ms.group(1) if ms else 0
                out = ["cigar:", t[0], t[2], t[3], t[4], t[5], t[7], t[8],
                       "+", score]
                for m2 in RE_CIGAR.finditer(cg):
                    out += [m2.group(2), m2.group(1)]
                print(" ".join(map(str, out)))
                continue
            m = re.search(r"\tcs:Z:(\S+)", line)
            if m is None:
                _warn("WARNING: converting to %s requires the 'cs' tag, "
                      "which is absent on line %d"
                      % ("MAF" if fmt == "maf" else "BLAST-like alignment",
                         lineno))
                continue
            cs = m.group(1)
            if fmt == "maf":
                for m2 in RE_CS.finditer(cs):
                    if m2.group(1) == ":":
                        raise RuntimeError(
                            "converting to MAF only works with "
                            "'--cs=long' output")
                    aln.update(m2.group(1), m2.group(2), elen)
                ms = re.search(r"\tAS:i:(\d+)", line)
                score = int(ms.group(1)) if ms else 0
                ln = max(len(t[0]), len(t[5]))
                print("a %d" % score)
                print(" ".join(["s", pad(t[5], ln, True),
                                pad(t[7], 10, False),
                                pad(int(t[8]) - int(t[7]), 10, False), "+",
                                pad(t[6], 10, False), "".join(aln.ref)]))
                ql = int(t[1])
                if t[4] == "+":
                    qs, qe = int(t[2]), int(t[3])
                else:
                    qs, qe = ql - int(t[3]), ql - int(t[2])
                print(" ".join(["s", pad(t[0], ln, True),
                                pad(qs, 10, False), pad(qe - qs, 10, False),
                                t[4], pad(ql, 10, False),
                                "".join(aln.qry)]))
                print("")
                continue
            # BLAST-like
            print(">" + re.sub(r"\tc[sg]:Z:\S+", "", line))
            rs = int(t[7])
            qs = int(t[2]) if t[4] == "+" else int(t[3])
            n_blocks = 0
            for m2 in RE_CS.finditer(cs):
                op, val = m2.group(1), m2.group(2)
                if op == ":":
                    val = "=" * int(val)
                start, rest = 0, 1 if op == "*" else len(val)
                while rest > 0:
                    if len(aln) + rest >= line_len:
                        l_proc = line_len - len(aln)
                        aln.update(op, val if op == "*"
                                   else val[start:start + l_proc], elen)
                        if n_blocks > 0:
                            print("")
                        aln.emit(rs, qs, t[4], slen, elen)
                        n_blocks += 1
                        aln.clear()
                        slen[0], slen[1] = elen[0], elen[1]
                    else:
                        l_proc = rest
                        aln.update(op, val if op == "*"
                                   else val[start:start + l_proc], elen)
                    rest -= l_proc
                    start += l_proc
            if len(aln) > 0:
                if n_blocks > 0:
                    print("")
                aln.emit(rs, qs, t[4], slen, elen)
            print("//")
    return 0


# ---------------------------------------------------------------------------
# gff2bed (paftools.js:1516-1649)

def cmd_gff2bed(argv: List[str]) -> int:
    fn_ucsc_fai, is_short, keep_gff, print_junc = None, False, False, False
    args = _getopt(argv, "u:sgj")
    for o, v in args.opts:
        if o == "u":
            fn_ucsc_fai = v
        elif o == "s":
            is_short = True
        elif o == "g":
            keep_gff = True
        elif o == "j":
            print_junc = True
    if not args.pos:
        _warn("Usage: paftools gff2bed [options] <in.gff>")
        return 1

    ens2ucsc: Dict[str, str] = {}
    if fn_ucsc_fai:
        with _open(fn_ucsc_fai) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                s = t[0]
                if re.search(r"_(random|alt|decoy)$", s):
                    s = re.sub(r"_(random|alt|decoy)$", "", s)
                    s = re.sub(r"^chr\S+_", "", s)
                else:
                    s = re.sub(r"^chrUn_", "", s)
                s = re.sub(r"v(\d+)", r".\1", s)
                if s != t[0]:
                    ens2ucsc[s] = t[0]

    colors = {"protein_coding": "0,128,255", "mRNA": "0,128,255",
              "lincRNA": "0,192,0", "snRNA": "0,192,0",
              "miRNA": "0,192,0", "misc_RNA": "0,192,0"}

    def print_bed12(exons, cds_st, cds_en):
        if not exons:
            return
        name = (exons[0][7] + "|" + exons[0][5] if is_short
                else "|".join(exons[0][4:7]))
        a = sorted(exons, key=lambda e: e[1])
        if print_junc:
            for i in range(1, len(a)):
                _p(a[i][0], a[i - 1][2], a[i][1], name, 1000, a[i][3])
            return
        st, en = a[0][1], a[-1][2]
        if cds_st == 1 << 30:
            cds_st = st
        if cds_en == 0:
            cds_en = en
        if cds_st < st or cds_en > en:
            raise RuntimeError("inconsistent thick start or end for "
                               "transcript " + a[0][4])
        sizes = ",".join(str(e[2] - e[1]) for e in a) + ","
        starts = ",".join(str(e[1] - st) for e in a) + ","
        color = colors.get(a[0][5], "196,196,196")
        _p(a[0][0], st, en, name, 1000, a[0][3], cds_st, cds_en, color,
           len(a), sizes, starts)

    re_gtf = re.compile(r'\b(transcript_id|transcript_type|'
                        r'transcript_biotype|gene_name|gene_id|gbkey|'
                        r'transcript_name) "([^"]+)";')
    re_gff3 = re.compile(r"\b(transcript_id|transcript_type|"
                         r"transcript_biotype|gene_name|gene_id|gbkey|"
                         r"transcript_name)=([^;]+)")
    exons: List[list] = []
    cds_st, cds_en, last_id = 1 << 30, 0, None
    with _open(args.pos[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if keep_gff:
                if not t[0].startswith("#") and t[0] in ens2ucsc:
                    t[0] = ens2ucsc[t[0]]
                print("\t".join(t))
                continue
            if t[0].startswith("#") or len(t) < 9:
                continue
            if t[2] not in ("CDS", "exon"):
                continue
            st3, en4 = int(t[3]) - 1, int(t[4])
            tid, typ, name, biotype, tname = None, "", "N/A", "", "N/A"
            for m in list(re_gtf.finditer(t[8])) + \
                    list(re_gff3.finditer(t[8])):
                key, val = m.group(1), m.group(2)
                if key == "transcript_id":
                    tid = val
                elif key == "transcript_type":
                    typ = val
                elif key in ("transcript_biotype", "gbkey"):
                    biotype = val
                elif key in ("gene_name", "gene_id"):
                    name = val
                elif key == "transcript_name":
                    tname = val
            if typ == "" and biotype != "":
                typ = biotype
            if tid is None:
                raise RuntimeError("No transcript_id")
            if tid != last_id:
                print_bed12(exons, cds_st, cds_en)
                exons, cds_st, cds_en = [], 1 << 30, 0
                last_id = tid
            if t[2] == "CDS":
                cds_st = min(cds_st, st3)
                cds_en = max(cds_en, en4)
            else:
                chrom = t[0]
                if fn_ucsc_fai:
                    if chrom in ens2ucsc:
                        chrom = ens2ucsc[chrom]
                    elif re.match(r"^[A-Z]+\d+\.\d+$", chrom):
                        chrom = re.sub(r"([A-Z]+\d+)\.(\d+)",
                                       r"chrUn_\1v\2", chrom)
                exons.append([chrom, st3, en4, t[6], tid, typ, name, tname])
    if last_id is not None:
        print_bed12(exons, cds_st, cds_en)
    return 0


# ---------------------------------------------------------------------------
# sam2paf (paftools.js:1651-1811)
#
# One deliberate divergence: cs components reconstructed from the MD tag are
# case-normalized to the cs spec (lowercase for -/+/* bases), matching what
# the mapper itself emits (format.c:141-187); the reference JS passes MD's
# uppercase through.

def cmd_sam2paf(argv: List[str]) -> int:
    pri_only = long_cs = False
    args = _getopt(argv, "pL")
    for o, _v in args.opts:
        if o == "p":
            pri_only = True
        elif o == "L":
            long_cs = True
    if not args.pos:
        _warn("Usage: paftools sam2paf [options] <in.sam>")
        return 1

    re_md = re.compile(r"(\d+)|(\^[A-Za-z]+)|([A-Za-z])")
    ctg_len: Dict[str, int] = {}
    lineno = 0
    with _open(args.pos[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            lineno += 1
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    mn = re.search(r"\tSN:(\S+)", line)
                    ml = re.search(r"\tLN:(\d+)", line)
                    if mn and ml:
                        ctg_len[mn.group(1)] = int(ml.group(1))
                continue
            t = line.split("\t")
            flag = int(t[1])
            if t[9] != "*" and t[10] != "*" and len(t[9]) != len(t[10]):
                raise RuntimeError(
                    "at line %d: inconsistent SEQ and QUAL lengths - "
                    "%d != %d" % (lineno, len(t[9]), len(t[10])))
            if t[2] == "*" or (flag & 4) or t[5] == "*":
                continue
            if pri_only and (flag & 0x100):
                continue
            if t[2] not in ctg_len:
                raise RuntimeError("at line %d: can't find the length of "
                                   "contig %s" % (lineno, t[2]))
            tlen = ctg_len[t[2]]
            nn, NM, MD, cs_str = 0, None, None, None
            for col in t[11:]:
                if col.startswith("NM:i:"):
                    NM = int(col[5:])
                elif col.startswith("nn:i:"):
                    nn = int(col[5:])
                elif col.startswith("MD:Z:"):
                    MD = col[5:]
                elif col.startswith("cs:Z:"):
                    cs_str = col[5:]
            del nn  # parsed for parity; unused in the conversion
            if t[9] == "*":
                MD = cs_str = None
            clip = [0, 0]
            soft_clip = 0
            I = [0, 0]
            D = [0, 0]
            M = N = mm = 0
            have_M = have_ext = False
            cigar: List[list] = []
            n_cigar = 0
            for m in RE_CIGAR.finditer(t[5]):
                l, op = int(m.group(1)), m.group(2)
                if op == "M":
                    M += l
                    have_M = True
                elif op == "I":
                    I[0] += 1
                    I[1] += l
                elif op == "D":
                    D[0] += 1
                    D[1] += l
                elif op == "N":
                    N += l
                elif op == "S":
                    clip[0 if n_cigar == 0 else 1] = l
                    soft_clip += l
                elif op == "H":
                    clip[0 if n_cigar == 0 else 1] = l
                elif op == "=":
                    M += l
                    have_ext = True
                    op = "M"
                elif op == "X":
                    M += l
                    mm += l
                    have_ext = True
                    op = "M"
                n_cigar += 1
                if MD is not None and op != "H":
                    if cigar and cigar[-1][1] == op:
                        cigar[-1][0] += l
                    else:
                        cigar.append([l, op])
            ql = M + I[1] + soft_clip
            tl = M + D[1] + N
            ts = int(t[3]) - 1
            te = ts + tl
            if n_cigar > 65535:
                _warn("WARNING at line %d: %d CIGAR operations"
                      % (lineno, n_cigar))
            if te > tlen:
                _warn("WARNING at line %d: alignment end position larger "
                      "than ref length; skipped" % lineno)
                continue
            if t[9] != "*" and len(t[9]) != ql:
                _warn("WARNING at line %d: SEQ length inconsistent with "
                      "CIGAR (%d != %d); skipped" % (lineno, len(t[9]), ql))
                continue
            # reconstruct cs from MD
            cs: List[str] = []
            if MD is not None and cs_str is None and t[9] != "*":
                k = cx = cy = mx = my = 0
                ok = True
                for m in re_md.finditer(MD):
                    if m.group(2) is not None:  # deletion
                        dl = len(m.group(2)) - 1
                        cs += ["-", m.group(2)[1:].lower()]
                        mx += dl
                        cx += dl
                        k += 1
                    else:
                        ml = int(m.group(1)) if m.group(1) is not None else 1
                        while k < len(cigar) and cigar[k][1] != "D":
                            cl, op = cigar[k]
                            if op == "M":
                                if my + ml < cy + cl:
                                    if ml > 0:
                                        if m.group(3) is not None:
                                            cs += ["*", m.group(3).lower(),
                                                   t[9][my].lower()]
                                        elif long_cs:
                                            cs += ["=",
                                                   t[9][my:my + ml].upper()]
                                        else:
                                            cs += [":", str(ml)]
                                    mx += ml
                                    my += ml
                                    ml = 0
                                    break
                                dl2 = cy + cl - my
                                if long_cs:
                                    cs += ["=", t[9][my:my + dl2].upper()]
                                else:
                                    cs += [":", str(dl2)]
                                cx += cl
                                cy += cl
                                k += 1
                                mx += dl2
                                my += dl2
                                ml -= dl2
                            elif op == "I":
                                cs += ["+", t[9][cy:cy + cl].lower()]
                                cy += cl
                                my += cl
                                k += 1
                            elif op == "S":
                                cy += cl
                                my += cl
                                k += 1
                            else:
                                raise RuntimeError(
                                    "at line %d: inconsistent MD tag"
                                    % lineno)
                        if ml != 0:
                            raise RuntimeError(
                                "at line %d: inconsistent MD tag" % lineno)
                if cx != mx or cy != my:
                    raise RuntimeError("at line %d: inconsistent MD tag"
                                       % lineno)
                del ok
            # NM calibration
            if have_ext and not have_M:
                if NM is not None and NM != I[1] + D[1] + mm:
                    _warn("WARNING at line %d: NM is different from sum of "
                          "gaps and mismatches" % lineno)
                NM = I[1] + D[1] + mm
            elif NM is not None:
                if NM < I[1] + D[1]:
                    _warn("WARNING at line %d: NM is less than the total "
                          "number of gaps (%d < %d)"
                          % (lineno, NM, I[1] + D[1]))
                    NM = I[1] + D[1]
                mm = NM - (I[1] + D[1])
            else:
                _warn("WARNING at line %d: unable to find the number of "
                      "mismatches; assuming zero" % lineno)
                mm = 0
            mlen = M - mm
            blen = M + I[1] + D[1]
            qlen = M + I[1] + clip[0] + clip[1]
            qname = t[0]
            if (flag & 1) and (flag & 0x40):
                qname += "/1"
            if (flag & 1) and (flag & 0x80):
                qname += "/2"
            if flag & 16:
                qs, qe = clip[1], qlen - clip[0]
            else:
                qs, qe = clip[0], qlen - clip[1]
            tags = ["tp:A:" + ("S" if flag & 0x100 else "P")]
            if NM is not None:
                tags.append("mm:i:%d" % mm)
            tags += ["gn:i:%d" % (I[1] + D[1]), "go:i:%d" % (I[0] + D[0]),
                     "cg:Z:" + re.sub(r"\d+[SH]", "", t[5])]
            if cs_str is not None:
                tags.append("cs:Z:" + cs_str)
            elif cs:
                tags.append("cs:Z:" + "".join(cs))
            _p(qname, qlen, qs, qe, "-" if flag & 16 else "+", t[2], tlen,
               ts, te, mlen, blen, t[4], *tags)
    return 0


# ---------------------------------------------------------------------------
# delta2paf (paftools.js:1813-1874)

def cmd_delta2paf(argv: List[str]) -> int:
    args = _getopt(argv, "")
    if not args.pos:
        _warn("Usage: paftools delta2paf <in.delta>")
        return 1
    rname = qname = rlen = qlen = qs = qe = rs = re_ = None
    strand = NM = x = y = 0
    cigar: List[int] = []
    seen_gt = False
    with _open(args.pos[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            m = re.match(r"^>(\S+)\s+(\S+)\s+(\d+)\s+(\d+)", line)
            if m:
                rname, qname = m.group(1), m.group(2)
                rlen, qlen = int(m.group(3)), int(m.group(4))
                seen_gt = True
                continue
            if not seen_gt:
                continue
            t = line.split(" ")
            if len(t) == 7:
                t = [int(v) for v in t[:5]]
                strand = 1 if ((t[0] < t[1] and t[2] < t[3]) or
                               (t[0] > t[1] and t[2] > t[3])) else -1
                rs, re_ = min(t[0], t[1]) - 1, max(t[0], t[1])
                qs, qe = min(t[2], t[3]) - 1, max(t[2], t[3])
                x = y = 0
                NM = t[4]
                cigar = []
            elif len(t) == 1:
                d = int(t[0])
                if d == 0:
                    blen = 0
                    cigar_str = []
                    if re_ - rs - x != qe - qs - y:
                        raise RuntimeError("inconsistent alignment")
                    cigar.append((re_ - rs - x) << 4)
                    for c in cigar:
                        blen += c >> 4
                        cigar_str.append("%d%s" % (c >> 4, "MID"[c & 0xF]))
                    _p(qname, qlen, qs, qe, "+" if strand > 0 else "-",
                       rname, rlen, rs, re_, blen - NM, blen, 0,
                       "NM:i:%d" % NM, "cg:Z:" + "".join(cigar_str))
                elif d > 0:
                    l = d - 1
                    x += l + 1
                    y += l
                    if l > 0:
                        cigar.append(l << 4)
                    if cigar and (cigar[-1] & 0xF) == 2:
                        cigar[-1] += 1 << 4
                    else:
                        cigar.append(1 << 4 | 2)  # deletion
                else:
                    l = -d - 1
                    x += l
                    y += l + 1
                    if l > 0:
                        cigar.append(l << 4)
                    if cigar and (cigar[-1] & 0xF) == 1:
                        cigar[-1] += 1 << 4
                    else:
                        cigar.append(1 << 4 | 1)  # insertion
    return 0


# ---------------------------------------------------------------------------
# splice2bed (paftools.js:1876-1989)

def cmd_splice2bed(argv: List[str]) -> int:
    colors = ["0,128,255", "255,0,0", "0,192,0"]
    fmt, fn_name_conv, keep_multi = "bed", None, False
    args = _getopt(argv, "f:n:m")
    for o, v in args.opts:
        if o == "f":
            fmt = v
        elif o == "n":
            fn_name_conv = v
        elif o == "m":
            keep_multi = True
    if not args.pos:
        _warn("Usage: paftools splice2bed [options] <in.paf>|<in.sam>")
        return 1

    conv = None
    if fn_name_conv:
        conv = {}
        with _open(fn_name_conv) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                conv[t[0]] = t[1]

    def print_lines(a: List[list]):
        if not a:
            return
        if fmt == "bed":
            n_pri = sum(1 for x in a if x[8] == 0)
            if n_pri > 1:
                for x in a:
                    if x[8] == 0:
                        x[8] = 1
            elif n_pri == 0:
                _warn("Warning: %s doesn't have a primary alignment"
                      % a[0][3])
            for x in a:
                if not keep_multi and x[8] == 2:
                    continue
                x[8] = colors[x[8]]
                _p(*x)
        a.clear()

    a: List[list] = []
    with _open(args.pos[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("@"):
                continue
            t = line.split("\t")
            is_pri, cigar = False, None
            if conv is not None and t[0] in conv:
                t[0] = conv[t[0]]
            if len(t) >= 10 and t[4] not in "+-" and \
                    re.match(r"^\d+", t[1]):
                flag = int(t[1])
                if flag & 1:
                    t[0] += "/%d" % ((flag >> 6) & 3)
            if a and a[0][3] != t[0]:
                print_lines(a)
            if len(t) >= 12 and t[4] in "+-":  # PAF
                for col in t[12:]:
                    if col.startswith("cg:Z:"):
                        cigar = col[5:]
                    elif col.startswith("s2:i:"):
                        is_pri = True
                a1 = [t[5], int(t[7]), int(t[8]), t[0],
                      int(t[9]) * 1000 // int(t[10]), t[4]]
            elif len(t) >= 10:  # SAM
                flag = int(t[1])
                if (flag & 4) or t[2] == "*":
                    continue
                cigar = t[5]
                is_pri = not (flag & 0x100)
                a1 = [t[2], int(t[3]) - 1, None, t[0], 1000,
                      "-" if flag & 16 else "+"]
            else:
                raise RuntimeError("unrecognized input format")
            if cigar is None:
                raise RuntimeError("missing CIGAR")
            x0 = x = 0
            bs: List[int] = []
            bl: List[int] = []
            for m in RE_CIGAR.finditer(cigar):
                if m.group(2) in "MD":
                    x += int(m.group(1))
                elif m.group(2) == "N":
                    bs.append(x0)
                    bl.append(x - x0)
                    x += int(m.group(1))
                    x0 = x
            bs.append(x0)
            bl.append(x - x0)
            if a1[2] is None:
                a1[2] = a1[1] + x
            a1 += [a1[1], a1[2], 0 if is_pri else 2, len(bs),
                   ",".join(map(str, bl)) + ",",
                   ",".join(map(str, bs)) + ","]
            a.append(a1)
    print_lines(a)
    return 0


# ---------------------------------------------------------------------------
# mapeval (paftools.js:1996-2162)

RE_PBSIM = re.compile(r"^(\S+)!(\S+)!(\d+)!(\d+)!([\+\-])$")
RE_MASON = re.compile(r"^(\S+)!(\S+)!(\d+)_(\d+)!(\d+)_(\d+)!"
                      r"([\+\-])([\+\-])/([12])$")


def cmd_mapeval(argv: List[str]) -> int:
    max_mapq, mode, err_out_q, ovlp_ratio = 60, 0, 256, 0.1
    cap_short_mapq = False
    args = _getopt(argv, "Q:r:m:c")
    for o, v in args.opts:
        if o == "Q":
            err_out_q = int(v)
        elif o == "r":
            ovlp_ratio = float(v)
        elif o == "m":
            mode = int(v)
        elif o == "c":
            cap_short_mapq = True
    if not args.pos:
        _warn("Usage: paftools mapeval [options] <in.paf>|<in.sam>")
        return 1

    tot = [0] * (max_mapq + 1)
    err = [0] * (max_mapq + 1)

    def is_correct(s, b) -> bool:
        if s[0] != b[0] or s[3] != b[3]:
            return False
        if s[1] < b[1]:
            if s[2] <= b[1]:
                return False
            o = min(s[2], b[2]) - b[1]
            l = max(s[2], b[2]) - s[1]
        else:
            if b[2] <= s[1]:
                return False
            o = min(s[2], b[2]) - s[1]
            l = max(s[2], b[2]) - b[1]
        return o / l > ovlp_ratio

    def count_read(qname: str, a: List[list]):
        if not a:
            return
        m = RE_PBSIM.match(qname)
        if m:
            s = [m.group(2), int(m.group(3)), int(m.group(4)), m.group(5)]
        else:
            m = RE_MASON.match(qname)
            if m is None:
                raise RuntimeError(
                    "Failed to parse simulated read names '%s'" % qname)
            if m.group(9) == "1":
                s = [m.group(2), int(m.group(3)), int(m.group(5)),
                     m.group(7)]
            else:
                s = [m.group(2), int(m.group(4)), int(m.group(6)),
                     m.group(8)]
        if mode in (0, 1):
            max_i = 0
            if mode == 0:
                mx = 0
                for i, x in enumerate(a):
                    if x[5] > mx:
                        mx, max_i = x[5], i
            mapq = a[max_i][4]
            tot[mapq] += 1
            if not is_correct(s, a[max_i]):
                if mapq >= err_out_q:
                    _p("E", qname, *a[max_i])
                err[mapq] += 1
        elif mode == 2:
            if cap_short_mapq:
                mx, max_q = 0, 0
                for x in a:
                    if x[5] > mx:
                        mx, max_q = x[5], x[4]
                for x in a:
                    x[4] = min(max_q, x[4])
            max_err_mapq, mmax_mapq, max_err_i = -1, 0, -1
            for i, x in enumerate(a):
                mmax_mapq = max(mmax_mapq, x[4])
                if not is_correct(s, x) and x[4] > max_err_mapq:
                    max_err_mapq, max_err_i = x[4], i
            if max_err_mapq >= 0:
                tot[max_err_mapq] += 1
                err[max_err_mapq] += 1
                if max_err_mapq >= err_out_q:
                    _p("E", qname, *a[max_err_i])
            else:
                tot[mmax_mapq] += 1

    last = None
    a: List[list] = []
    n_unmapped = None
    with _open(args.pos[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("@"):
                continue
            t = line.split("\t")
            if len(t) > 4 and t[4] in "+-":  # PAF
                if last != t[0]:
                    if last is not None:
                        count_read(last, a)
                    a, last = [], t[0]
                if "\ts1:i:" in line and "\ts2:i:" not in line:
                    continue
                mapq = min(int(t[11]), max_mapq)
                a.append([t[5], int(t[7]), int(t[8]), t[4], mapq,
                          int(t[9])])
            else:  # SAM
                flag = int(t[1])
                read_no = (flag >> 6) & 0x3
                qname = t[0]
                if not re.search(r"/[12]$", qname) and read_no in (1, 2):
                    qname = t[0] + "/%d" % read_no
                if last != qname:
                    if last is not None:
                        count_read(last, a)
                    a, last = [], qname
                if flag & 0x100:
                    continue
                if (flag & 0x4) or t[2] == "*":
                    n_unmapped = (n_unmapped or 0) + 1
                    continue
                mapq = min(int(t[4]), max_mapq)
                pos = int(t[3]) - 1
                pos_end = pos
                n_gap = mlen = 0
                for m in RE_CIGAR.finditer(t[5]):
                    ln, op = int(m.group(1)), m.group(2)
                    if op == "M":
                        pos_end += ln
                        mlen += ln
                    elif op == "I":
                        n_gap += ln
                    elif op == "D":
                        n_gap += ln
                        pos_end += ln
                score = pos_end - pos
                m = re.search(r"\tNM:i:(\d+)", line)
                if m:
                    NM = int(m.group(1))
                    if NM >= n_gap:
                        score = mlen - (NM - n_gap)
                a.append([t[2], pos, pos_end, "-" if flag & 16 else "+",
                          mapq, score])
    if last is not None:
        count_read(last, a)

    sum_tot = sum_err = sum_tot2 = sum_err2 = 0
    q_out = -1
    for q in range(max_mapq, -1, -1):
        if tot[q] == 0:
            continue
        if q_out < 0 or err[q] > 0:
            if q_out >= 0:
                _p("Q", q_out, sum_tot, sum_err,
                   "%.9f" % (sum_err2 / sum_tot2), sum_tot2)
            sum_tot = sum_err = 0
            q_out = q
        sum_tot += tot[q]
        sum_err += err[q]
        sum_tot2 += tot[q]
        sum_err2 += err[q]
    if sum_tot2 > 0:
        _p("Q", q_out, sum_tot, sum_err, "%.9f" % (sum_err2 / sum_tot2),
           sum_tot2)
    if n_unmapped is not None:
        _p("U", n_unmapped)
    return 0


# ---------------------------------------------------------------------------
# mason2fq / pbsim2fq (paftools.js:2165-2300)

def cmd_mason2fq(argv: List[str]) -> int:
    args = _getopt(argv, "")
    if not args.pos:
        _warn("Usage: paftools mason2fq <mason.sam>")
        return 1

    def print_se(a):
        print("@" + "!".join(map(str, a[:5])) + " " + a[8])
        print(a[5])
        print("+")
        print(a[6])

    last = None
    with _open(args.pos[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("@"):
                continue
            l_ref = sum(int(m.group(1)) for m in RE_CIGAR.finditer(t[5])
                        if m.group(2) in "DMN")
            flag = int(t[1])
            rev = bool(flag & 16)
            if rev:
                seq = revcomp(t[9])
                qual = t[10][::-1]
            else:
                seq, qual = t[9], t[10]
            qname = re.sub(r"^simulated\.", "", t[0])
            chrom, pos = t[2], int(t[3]) - 1
            strand = "-" if flag & 16 else "+"
            read_no = flag & 0xC0
            read_no = 1 if read_no == 0x40 else 2 if read_no == 0x80 else 0
            err = snp = indel = 0
            for col in t[11:]:
                if col.startswith("XE:i:"):
                    err = int(col[5:])
                elif col.startswith("XS:i:"):
                    snp = int(col[5:])
                elif col.startswith("XI:i:"):
                    indel = int(col[5:])
            comment = "%s:%s:%s" % (err, snp, indel)
            cur = [qname, chrom, pos, pos + l_ref, strand, seq, qual,
                   read_no, comment]
            if last is None:
                last = cur
            elif last[0] != qname:
                print_se(last)
                last = cur
            else:
                if read_no == 2:
                    if last[7] != 1:
                        raise RuntimeError("ERROR: can't find read1")
                    name = "!".join(map(str, (
                        qname, chrom, "%d_%d" % (last[2], pos),
                        "%d_%d" % (last[3], pos + l_ref),
                        last[4] + strand)))
                    print("@" + name + "/1 " + last[8])
                    print(last[5])
                    print("+")
                    print(last[6])
                    print("@" + name + "/2 " + comment)
                    print(seq)
                    print("+")
                    print(qual)
                else:
                    if last[7] != 2:
                        raise RuntimeError("ERROR: can't find read2")
                    name = "!".join(map(str, (
                        qname, chrom, "%d_%d" % (pos, last[2]),
                        "%d_%d" % (pos + l_ref, last[3]),
                        strand + last[4])))
                    print("@" + name + "/1 " + comment)
                    print(seq)
                    print("+")
                    print(qual)
                    print("@" + name + "/2 " + last[8])
                    print(last[5])
                    print("+")
                    print(last[6])
                last = None
    if last is not None:
        print_se(last)
    return 0


def cmd_pbsim2fq(argv: List[str]) -> int:
    args = _getopt(argv, "")
    if len(args.pos) < 2:
        _warn("Usage: paftools pbsim2fq <ref.fa.fai> <pbsim1.maf> "
              "[[pbsim2.maf] ...]")
        return 1
    chr_list = []
    with _open(args.pos[0]) as f:
        for line in f:
            chr_list.append(line.split()[0])
    for fn in args.pos[1:]:
        state, reg = 0, None
        with _open(fn) as f:
            for line in f:
                line = line.rstrip("\n")
                if state == 0 and line.startswith("a"):
                    state = 1
                elif state == 1 and line.startswith("s"):
                    t = re.split(r"\s+", line)
                    st = int(t[2])
                    reg = [st, st + int(t[3])]
                    state = 2
                elif state == 2 and line.startswith("s"):
                    t = re.split(r"\s+", line)
                    m = re.search(r"S(\d+)_\d+", t[1])
                    if m is None:
                        raise RuntimeError("Failed to parse the read name")
                    chr_id = int(m.group(1)) - 1
                    if chr_id >= len(chr_list):
                        raise RuntimeError("Index outside the chr list")
                    name = "!".join(map(str, (t[1], chr_list[chr_id],
                                              reg[0], reg[1], t[4])))
                    seq = t[6].replace("-", "")
                    if len(seq) != int(t[5]):
                        raise RuntimeError("Inconsistent read length")
                    if "NN" not in seq:
                        if t[4] == "-":
                            seq = revcomp(seq)
                        print(">" + name)
                        print(seq)
                    state = 0
    return 0


# ---------------------------------------------------------------------------
# junceval (paftools.js:2302-2455)

def cmd_junceval(argv: List[str]) -> int:
    l_fuzzy, print_ovlp, print_err_only, chr_only = 0, False, False, False
    args = _getopt(argv, "l:epc")
    for o, v in args.opts:
        if o == "l":
            l_fuzzy = int(v)
        elif o == "e":
            print_err_only = print_ovlp = True
        elif o == "p":
            print_ovlp = True
        elif o == "c":
            chr_only = True
    if len(args.pos) < 1:
        _warn("Usage: paftools junceval [options] <gene.gtf> <aln.sam>")
        return 1

    tr: Dict[str, list] = {}
    with _open(args.pos[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("#") or len(t) < 9 or t[2] != "exon":
                continue
            m = re.search(r'transcript_id "(\S+)"', t[8])
            if m is None:
                continue
            tid = m.group(1)
            if tid not in tr:
                tr[tid] = [t[0], t[6], 0, 0, []]
            tr[tid][4].append([int(t[3]) - 1, int(t[4])])

    anno: Dict[str, List[list]] = {}
    for tid, tinfo in tr.items():
        s = tinfo[4]
        intv_sort(s)
        anno.setdefault(tinfo[0], [])
        for i in range(len(s) - 1):
            if s[i][1] >= s[i + 1][0]:
                _warn("WARNING: incorrect annotation for transcript "
                      "%s (%d >= %d)" % (tid, s[i][1], s[i + 1][0]))
            anno[tinfo[0]].append([s[i][1], s[i + 1][0]])
    del tr

    for chrom in anno:
        e = anno[chrom]
        if not e:
            continue
        intv_sort(e)
        k = 0
        for i in range(1, len(e)):
            if e[i][0] != e[k][0] or e[i][1] != e[k][1]:
                k += 1
                e[k] = list(e[i])
        del e[k + 1:]
        intv_index_end(e)

    n_pri = n_unmapped = n_mapped = 0
    n_sgl = n_splice = n_splice_hit = n_splice_novel = 0
    fn = args.pos[1] if len(args.pos) > 1 else "-"
    last_qname = None
    with _open(fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("@"):
                continue
            if chr_only and not re.match(r"^(chr)?([0-9]+|X|Y)$", t[2]):
                continue
            flag = int(t[1])
            if flag & 0x100:
                continue
            if t[2] == "*":
                n_unmapped += 1
                continue
            n_pri += 1
            if last_qname != t[0]:
                n_mapped += 1
                last_qname = t[0]
            pos = int(t[3]) - 1
            introns: List[list] = []
            for m in RE_CIGAR.finditer(t[5]):
                ln, op = int(m.group(1)), m.group(2)
                if op == "N":
                    introns.append([pos, pos + ln])
                    pos += ln
                elif op in "MX=D":
                    pos += ln
            if not introns:
                n_sgl += 1
                continue
            n_splice += len(introns)
            chrom = anno.get(t[2])
            if chrom is not None:
                for i, intr in enumerate(introns):
                    o = intv_find_ovlp(chrom, intr[0], intr[1])
                    if o:
                        hit = False
                        for oj in o:
                            if abs(intr[0] - oj[0]) <= l_fuzzy and \
                                    abs(intr[1] - oj[1]) <= l_fuzzy:
                                n_splice_hit += 1
                                hit = True
                            if hit:
                                break
                        if print_ovlp:
                            if hit and print_err_only:
                                continue
                            x = "[" + ", ".join(
                                "(%d,%d)" % (oj[0], oj[1]) for oj in o) + "]"
                            _p("C" if hit else "P", t[0], i + 1, t[2],
                               intr[0], intr[1], x)
                    else:
                        n_splice_novel += 1
                        if print_ovlp:
                            _p("N", t[0], i + 1, t[2], intr[0], intr[1])
            else:
                n_splice_novel += len(introns)
    if not print_ovlp:
        print("# unmapped reads: %d" % n_unmapped)
        print("# mapped reads: %d" % n_mapped)
        print("# primary alignments: %d" % n_pri)
        print("# singletons: %d" % n_sgl)
        print("# predicted introns: %d" % n_splice)
        print("# non-overlapping introns: %d" % n_splice_novel)
        pct = n_splice_hit / n_splice * 100 if n_splice else 0.0
        print("# correct introns: %d (%.2f%%)" % (n_splice_hit, pct))
    return 0


# ---------------------------------------------------------------------------
# ov-eval (paftools.js:2458-2527)

def cmd_ov_eval(argv: List[str]) -> int:
    min_ovlp, min_frac, min_mapq = 2000, 0.95, 10
    args = _getopt(argv, "q:l:f:")
    for o, v in args.opts:
        if o == "q":
            min_mapq = int(v)
        elif o == "l":
            min_ovlp = int(v)
        elif o == "f":
            min_frac = float(v)
    if len(args.pos) < 2:
        _warn("Usage: sort -k6,6 -k8,8n to-ref.paf | paftools ov-eval "
              "[options] - <ovlp.paf>")
        return 1

    a: List[list] = []
    h: Dict[str, int] = {}
    with _open(args.pos[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if int(t[11]) < min_mapq:
                continue
            if "tp:A:P" not in t[12:]:
                continue
            qlen, qs, qe = int(t[1]), int(t[2]), int(t[3])
            st, en = int(t[7]), int(t[8])
            if qe - qs < min_ovlp or en - st < min_ovlp or \
                    (qe - qs) / qlen < min_frac:
                continue
            ctg = t[5]
            while a and not (a[0][0] == ctg and a[0][2] > st):
                a.pop(0)
            for x in a:
                if x[3] == t[0]:
                    continue
                ln = min(en, x[2]) - st
                if ln >= min_ovlp:
                    key = (x[3] + "\t" + t[0] if x[3] < t[0]
                           else t[0] + "\t" + x[3])
                    h[key] = ln
            a.append([ctg, st, en, t[0]])
    with _open(args.pos[1]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            key = t[0] + "\t" + t[5] if t[0] < t[5] else t[5] + "\t" + t[0]
            if h.get(key, 0) > 0:
                h[key] = -h[key]
    n_ovlp = len(h)
    n_missing = sum(1 for v in h.values() if v > 0)
    print("%d overlaps inferred from the reference mapping" % n_ovlp)
    print("%d missed by the read overlapper" % n_missing)
    sens = 100 * (1 - n_missing / n_ovlp) if n_ovlp else 0.0
    print("%.2f%% sensitivity" % sens)
    return 0


# ---------------------------------------------------------------------------
# vcfstat (paftools.js:2529-2592)

def cmd_vcfstat(argv: List[str]) -> int:
    ts = {"AG", "GA", "CT", "TC"}
    args = _getopt(argv, "")
    fn = args.pos[0] if args.pos else "-"
    x = {k: 0 for k in ("sub", "ts", "tv", "ins", "del", "ins1", "del1",
                        "ins2", "del2", "ins50", "del50", "ins1k", "del1k",
                        "ins7k", "del7k", "insinf", "delinf")}
    with _open(fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("#"):
                continue
            ref = t[3]
            for alt in t[4].split(","):
                if alt.startswith("<") or (len(alt) > 1 and alt[1] == ">"):
                    continue
                for j in range(min(len(ref), len(alt))):
                    if ref[j] != alt[j]:
                        x["sub"] += 1
                        if ref[j] + alt[j] in ts:
                            x["ts"] += 1
                        else:
                            x["tv"] += 1
                d = len(alt) - len(ref)
                key = None
                if d > 0:
                    x["ins"] += 1
                    key = ("ins1" if d == 1 else "ins2" if d == 2 else
                           "ins50" if d < 50 else "ins1k" if d < 1000 else
                           "ins7k" if d < 7000 else "insinf")
                elif d < 0:
                    d = -d
                    x["del"] += 1
                    key = ("del1" if d == 1 else "del2" if d == 2 else
                           "del50" if d < 50 else "del1k" if d < 1000 else
                           "del7k" if d < 7000 else "delinf")
                if key:
                    x[key] += 1
    print("# substitutions: %d" % x["sub"])
    tstv = x["ts"] / x["tv"] if x["tv"] else float("nan")
    print("ts/tv: %.3f" % tstv)
    for pre, word in (("ins", "insertions"), ("del", "deletions")):
        print("# %s: %d" % (word, x[pre]))
        print("# 1bp %s: %d" % (word, x[pre + "1"]))
        print("# 2bp %s: %d" % (word, x[pre + "2"]))
        print("# [3,50) %s: %d" % (word, x[pre + "50"]))
        print("# [50,1000) %s: %d" % (word, x[pre + "1k"]))
        print("# [1000,7000) %s: %d" % (word, x[pre + "7k"]))
        print("# >=7000 %s: %d" % (word, x[pre + "inf"]))
    return 0


# ---------------------------------------------------------------------------
# getopt-style option scanner (paftools.js:13-49 behavior)

class _Args:
    def __init__(self):
        self.opts: List[tuple] = []
        self.pos: List[str] = []


def _getopt(argv: List[str], ostr: str) -> _Args:
    out = _Args()
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("-") or arg == "-":
            break
        if arg == "--":
            i += 1
            break
        j = 1
        while j < len(arg):
            c = arg[j]
            k = ostr.find(c)
            if k < 0:
                raise SystemExit("unknown option: -%s" % c)
            needs_arg = k + 1 < len(ostr) and ostr[k + 1] == ":"
            if needs_arg:
                if j + 1 < len(arg):
                    out.opts.append((c, arg[j + 1:]))
                else:
                    i += 1
                    if i >= len(argv):
                        raise SystemExit("option -%s requires an argument"
                                         % c)
                    out.opts.append((c, argv[i]))
                break
            out.opts.append((c, None))
            j += 1
        i += 1
    out.pos = argv[i:]
    return out


def _asm_commands():
    from . import paftools_asm
    return paftools_asm.COMMANDS


COMMANDS = {
    "view": cmd_view,
    "stat": cmd_stat,
    "sam2paf": cmd_sam2paf,
    "delta2paf": cmd_delta2paf,
    "liftover": cmd_liftover,
    "liftOver": cmd_liftover,
    "call": cmd_call,
    "mapeval": cmd_mapeval,
    "junceval": cmd_junceval,
    "gff2bed": cmd_gff2bed,
    "splice2bed": cmd_splice2bed,
    "bedcov": cmd_bedcov,
    "ov-eval": cmd_ov_eval,
    "vcfstat": cmd_vcfstat,
    "pbsim2fq": cmd_pbsim2fq,
    "mason2fq": cmd_mason2fq,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print("Usage: paftools <command> [arguments]")
        print("Commands:")
        print("  view       convert PAF to BLAST-like (for eyeballing) or "
              "MAF")
        print("  stat       mapping statistics from PAF or SAM")
        print("  sam2paf    convert SAM to PAF")
        print("  liftover   lift over regions through an alignment")
        print("  call       call variants from asm-to-ref alignment")
        print("  mapeval    evaluate mapping accuracy using simulated reads")
        print("  junceval   evaluate splice junction consistency with "
              "annotations")
        print("  gff2bed    convert GTF/GFF3 to BED12")
        print("  splice2bed convert spliced alignment in PAF/SAM to BED12")
        print("  bedcov     compute the number of bases covered")
        print("  ov-eval    evaluate read overlap sensitivity")
        print("  vcfstat    VCF statistics")
        print("  asmstat    assembly statistics (NG50/NGA50, breaks)")
        print("  asmgene    evaluate gene completeness in an assembly")
        print("  misjoin    count candidate misjoins in an assembly")
        print("  vcfpair    merge a phased-pair VCF into one sample")
        print("  sveval     structural-variant call evaluation")
        print("  delta2paf  convert MUMmer delta to PAF")
        print("  pbsim2fq   convert pbsim MAF to FASTA")
        print("  mason2fq   convert mason2 SAM to FASTQ")
        print("  version    print version number")
        return 0 if argv else 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(VERSION)
        return 0
    fn = COMMANDS.get(cmd) or _asm_commands().get(cmd)
    if fn is None:
        _warn("ERROR: unknown command '%s'" % cmd)
        return 1
    return fn(rest)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # downstream pipe (e.g. head) closed early
        sys.exit(0)

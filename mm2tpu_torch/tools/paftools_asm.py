"""Assembly-evaluation subcommands of the PAF toolkit
(reference: misc/paftools.js — asmstat, asmgene, misjoin, vcfpair, sveval).
Registered into mm2tpu_torch.tools.paftools's command table.

The port's copy of `mm2tpu/tools/paftools_asm.py`, verbatim apart from
this docstring."""
from __future__ import annotations

import re
from typing import Dict, List

from .paftools import (RE_CIGAR, _getopt, _open, _p, _warn, intv_find_ovlp,
                       intv_index_end, intv_merge, intv_sort)


def parse_num(s: str) -> float:
    """Numbers with k/m/g suffixes (paftools.js:2594-2603)."""
    m = re.match(r"^(\d*\.?\d*)([mMgGkK]?)", s)
    x = float(m.group(1))
    suf = m.group(2).lower()
    if suf == "k":
        x *= 1000
    elif suf == "m":
        x *= 1e6
    elif suf == "g":
        x *= 1e9
    return x


# ---------------------------------------------------------------------------
# asmstat (paftools.js:566-818)

def cmd_asmstat(argv: List[str]) -> int:
    min_query_len, min_seg_len, max_diff = 0, 10000, 0.01
    bp_flank_len = 0
    args = _getopt(argv, "l:d:b:g:q:")
    for o, v in args.opts:
        if o == "l":
            min_seg_len = int(v)
        elif o == "d":
            max_diff = float(v)
        elif o == "b":
            bp_flank_len = int(v)
        elif o == "q":
            min_query_len = int(v)
    if not args.pos:
        _warn("Usage: paftools asmstat [options] <ref.fa.fai> <asm1.paf> "
              "[...]")
        return 1

    ref_len = 0
    with _open(args.pos[0]) as f:
        for line in f:
            ref_len += int(line.split("\t")[1])

    def process_query(qblocks, qblock_len, bp):
        qblocks.sort(key=lambda x: x[0])
        last_blen = None
        st = en = -1
        qcov = 0
        for k, qb in enumerate(qblocks):
            blen = qb[1] - qb[0]
            if k > 0 and qb[0] < qblocks[k - 1][1]:
                if qb[1] < qblocks[k - 1][1]:
                    continue
                blen = qb[1] - qblocks[k - 1][1]
            qblock_len.append(blen)
            if qb[0] > en:
                qcov += en - st
                st, en = qb[0], qb[1]
            else:
                en = max(en, qb[1])
            if last_blen is not None:
                prev = qblocks[k - 1]
                gap = 1000000000
                if qb[2] == prev[2] and qb[3] == prev[3]:
                    g1 = qb[0] - prev[1]
                    g2 = (qb[4] - prev[5] if qb[2] == "+"
                          else prev[4] - qb[5])
                    gap = abs(g1 - g2)
                bp.append([blen, gap])  # flank is blen past the first block
            last_blen = blen
        qcov += en - st
        return qcov

    def n50(lens, tot, quantile):
        lens = sorted(lens, reverse=True)
        if tot is None:
            tot = sum(lens)
        s = 0
        for l in lens:
            if s <= quantile * tot < s + l:
                return l
            s += l
        return None

    def aun(lens, tot):
        lens = sorted(lens, reverse=True)
        if tot is None:
            tot = sum(lens)
        x = y = 0.0
        for l in lens:
            ll = l if x + l <= tot else tot - x
            x += l
            y += ll * (ll / tot)
            if x >= tot:
                break
        return "%.0f" % y

    def count_bp(bp, min_blen, min_gap):
        return sum(1 for b in bp if b[0] >= min_blen and b[1] >= min_gap)

    def compute_diff(cigar, NM):
        n_M = n_gapo = n_gaps = 0
        for m in RE_CIGAR.finditer(cigar):
            l, op = int(m.group(1)), m.group(2)
            if op == "M":
                n_M += l
            elif op in "ID":
                n_gapo += 1
                n_gaps += l
        if NM < n_gaps:
            raise RuntimeError("NM is smaller than the number of gaps")
        return (NM - n_gaps + n_gapo) / (n_M + n_gapo)

    labels = ["Length", "l_cov", "Rcov", "Rdup", "Qcov", "NG75", "NG50",
              "NGA50", "AUNGA", "#breaks",
              "bp(%d,0)" % min_seg_len, "bp(%d,10k)" % min_seg_len]
    n_asm = len(args.pos) - 1
    rst = [[None] * n_asm for _ in labels]
    header = ["Metric"]
    for i in range(n_asm):
        fn = args.pos[1 + i]
        header.append(re.sub(r"\.paf(\.gz)?$", "", fn))
        n_breaks, qcov = 0, 0
        ref_blocks: List[list] = []
        qblock_len: List[int] = []
        qblocks: List[list] = []
        bp: List[list] = []
        query: Dict[str, int] = {}
        last_qname = None
        with _open(fn) as f:
            for line in f:
                line = line.rstrip("\n")
                t = line.split("\t")
                if len(t) < 2:
                    continue
                qlen = int(t[1])
                if qlen < min_query_len:
                    continue
                query[t[0]] = qlen
                if len(t) < 9 or t[5] == "*":
                    continue
                if not re.search(r"\ttp:A:[PI]", line):
                    continue
                m = re.search(r"\tcg:Z:(\S+)", line)
                cigar = m.group(1) if m else None
                m = re.search(r"\tNM:i:(\d+)", line)
                NM = int(m.group(1)) if m else None
                diff = (compute_diff(cigar, NM)
                        if cigar is not None and NM is not None else 0)
                qs, qe = int(t[2]), int(t[3])
                ts, te = int(t[7]), int(t[8])
                if t[0] == last_qname:
                    n_breaks += 1
                if diff > max_diff:
                    continue
                if qe - qs < min_seg_len:
                    continue
                if t[0] != last_qname:
                    if last_qname is not None:
                        qcov += process_query(qblocks, qblock_len, bp)
                    qblocks = []
                    last_qname = t[0]
                ref_blocks.append([t[5], ts, te])
                qblocks.append([qs, qe, t[4], t[5], ts, te])
        if last_qname is not None:
            qcov += process_query(qblocks, qblock_len, bp)

        asm_len = sum(query.values())
        asm_lens = list(query.values())
        rst[0][i] = asm_len
        rst[5][i] = n50(asm_lens, ref_len, 0.75)
        rst[6][i] = n50(asm_lens, ref_len, 0.5)

        l_cov = 0
        ref_blocks.sort(key=lambda b: (b[0], b[1]))
        last_ref, st, en = None, -1, -1
        for rb in ref_blocks:
            if rb[0] != last_ref or rb[1] > en:
                l_cov += en - st
                last_ref, st, en = rb[0], rb[1], rb[2]
            else:
                en = max(en, rb[2])
        l_cov += en - st
        rst[1][i] = l_cov
        rst[2][i] = "%.2f%%" % (100.0 * l_cov / ref_len)
        rst[4][i] = "%.2f%%" % (100.0 * qcov / asm_len if asm_len else 0.0)

        # single-coverage length (same sweep as paf_call)
        c1_ctg, c1_start, c1_end, c1_len = None, 0, 0, 0
        for rb in ref_blocks:
            if rb[0] != c1_ctg or rb[1] >= c1_end:
                if c1_end > c1_start:
                    c1_len += c1_end - c1_start
                c1_ctg, c1_start, c1_end = rb[0], rb[1], rb[2]
            elif rb[2] > c1_end:
                if rb[1] > c1_start:
                    c1_len += rb[1] - c1_start
                c1_start, c1_end = c1_end, rb[2]
            elif rb[2] > c1_start:
                if rb[1] > c1_start:
                    c1_len += rb[1] - c1_start
                c1_start = rb[2]
        if c1_end > c1_start:
            c1_len += c1_end - c1_start
        rst[3][i] = "%.2f%%" % (100.0 * (l_cov - c1_len) / l_cov
                                if l_cov else 0.0)
        rst[7][i] = n50(qblock_len, ref_len, 0.5)
        rst[8][i] = aun(qblock_len, ref_len)
        rst[9][i] = n_breaks
        rst[10][i] = count_bp(bp, 500, 0)
        rst[11][i] = count_bp(bp, 500, 10000)

    if bp_flank_len <= 0:
        print("\t".join(header))
        for i, lab in enumerate(labels):
            _p(lab, *[("" if v is None else v) for v in rst[i]])
    return 0


# ---------------------------------------------------------------------------
# asmgene (paftools.js:820-961)

def cmd_asmgene(argv: List[str]) -> int:
    min_cov, min_iden = 0.99, 0.99
    print_err = auto_only = False
    args = _getopt(argv, "i:c:ea")
    for o, v in args.opts:
        if o == "i":
            min_iden = float(v)
        elif o == "c":
            min_cov = float(v)
        elif o == "e":
            print_err = True
        elif o == "a":
            auto_only = True
    if len(args.pos) < 2:
        _warn("Usage: paftools asmgene [options] <ref-splice.paf> "
              "<asm-splice.paf> [...]")
        return 1

    def process_query(a):
        b = [row for row in a if row[4] >= row[5] * min_iden]
        cnt = [0, 0, 0]
        if not b:
            return cnt
        cnt[0] = sum(1 for row in b if row[3] - row[2] >= row[1] * min_cov)
        b.sort(key=lambda x: x[2])
        l_cov, st, en = 0, b[0][2], b[0][3]
        for row in b[1:]:
            if row[2] <= en:
                en = max(en, row[3])
            else:
                l_cov += en - st
                st, en = row[2], row[3]
        l_cov += en - st
        cnt[1] = l_cov / b[0][1]
        cnt[2] = len(b)
        return cnt

    n_fn = len(args.pos)
    gene: Dict[str, list] = {}
    header: List[str] = []
    refpos: Dict[str, list] = {}
    for i, fn in enumerate(args.pos):
        header.append(re.sub(r"\.paf(\.gz)?$", "", fn))
        a: List[list] = []
        t = None
        with _open(fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                ql, qs, qe = int(t[1]), int(t[2]), int(t[3])
                mlen, blen = int(t[9]), int(t[10])
                if i == 0:
                    refpos[t[0]] = [t[0], t[1], t[5], int(t[7]), int(t[8])]
                gene.setdefault(t[0], [None] * n_fn)
                if a and t[0] != a[0][0]:
                    gene[a[0][0]][i] = process_query(a)
                    a = []
                a.append([t[0], ql, qs, qe, mlen, blen])
        if a and t is not None:
            gene[a[0][0]][i] = process_query(a)

    # select the longest gene per overlapping cluster
    gene_list = sorted(refpos.values(), key=lambda g: (g[2], g[3]))
    gene_nr: Dict[str, int] = {}
    if gene_list:
        last = 0
        for j in range(1, len(gene_list)):
            if gene_list[j][2] != gene_list[last][2] or \
                    gene_list[j][3] >= gene_list[last][4]:
                gene_nr[gene_list[last][0]] = 1
                last = j
            elif int(gene_list[j][1]) > int(gene_list[last][1]):
                last = j
        gene_nr[gene_list[last][0]] = 1

    col1 = ["full_sgl", "full_dup", "frag", "part50+", "part10+",
            "part10-", "dup_cnt", "dup_sum"]
    rst = [[0] * n_fn for _ in col1]
    for g, per_fn in gene.items():
        if per_fn[0] is None or per_fn[0][0] != 1:
            continue
        if g not in gene_nr:
            continue
        if auto_only and re.match(r"^(chr)?[XY]$", refpos[g][2]):
            continue
        for i in range(n_fn):
            gi = per_fn[i]
            if gi is None:
                rst[5][i] += 1
                if print_err:
                    _p("M", header[i], *refpos[g])
            elif gi[0] == 1:
                rst[0][i] += 1
            elif gi[0] > 1:
                rst[1][i] += 1
                if print_err:
                    _p("D", header[i], *refpos[g])
            elif gi[1] >= min_cov:
                rst[2][i] += 1
                if print_err:
                    _p("F", header[i], *refpos[g])
            elif gi[1] >= 0.5:
                rst[3][i] += 1
                if print_err:
                    _p("5", header[i], *refpos[g])
            elif gi[1] >= 0.1:
                rst[4][i] += 1
                if print_err:
                    _p("1", header[i], *refpos[g])
            else:
                rst[5][i] += 1
                if print_err:
                    _p("0", header[i], *refpos[g])
    for g, per_fn in gene.items():  # multi-copy genes
        if per_fn[0] is None or per_fn[0][0] <= 1:
            continue
        if g not in gene_nr:
            continue
        if auto_only and re.match(r"^(chr)?[XY]$", refpos[g][2]):
            continue
        for i in range(n_fn):
            if per_fn[i] is not None:
                rst[7][i] += per_fn[i][0]
            if per_fn[i] is not None and per_fn[i][0] > 1:
                rst[6][i] += 1
            elif print_err:
                _p("d", header[i], per_fn[0][0], *refpos[g])
    _p("H", "Metric", *header)
    for k, lab in enumerate(col1):
        _p("X", lab, *rst[k])
    return 0


# ---------------------------------------------------------------------------
# misjoin (paftools.js:2605-2719)

def cmd_misjoin(argv: List[str]) -> int:
    min_seg_len, max_gap, fn_cen = 1000000, 1000000, None
    show_long = show_err = False
    cen_ratio = 0.5
    args = _getopt(argv, "l:g:c:per:")
    for o, v in args.opts:
        if o == "l":
            min_seg_len = int(parse_num(v))
        elif o == "g":
            max_gap = int(parse_num(v))
        elif o == "c":
            fn_cen = v
        elif o == "r":
            cen_ratio = float(v)
        elif o == "p":
            show_long = True
        elif o == "e":
            show_err = True
    if not args.pos:
        _warn("Usage: paftools misjoin [options] <in.paf>")
        return 1
    n_diff, n_gap = [0, 0], [0, 0]
    n_inv, n_inv_end = [0, 0], [0, 0]
    cen: Dict[str, List[list]] = {}
    if fn_cen:
        with _open(fn_cen) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                cen.setdefault(t[0], []).append([int(t[1]), int(t[2])])

    def test_cen(chrom, st, en):
        b = cen.get(chrom)
        if b is None:
            return False
        length = sum(min(x[1], en) - max(x[0], st)
                     for x in b if x[0] < en and x[1] > st)
        return length >= (en - st) * cen_ratio

    def process(a):
        rows = []
        for t in a:
            row = list(t)
            for j in (1, 2, 3):
                row[j] = int(row[j])
            for j in range(6, 12):
                row[j] = int(row[j])
            if row[10] >= min_seg_len:
                rows.append(row)
        if len(rows) <= 1:
            return
        rows.sort(key=lambda x: x[2])
        if show_long:
            for row in rows:
                _p(*row)
        i = 1
        while i < len(rows):
            prev, cur = rows[i - 1], rows[i]
            ov0 = test_cen(prev[5], prev[7], prev[8])
            ov1 = test_cen(cur[5], cur[7], cur[8])
            if prev[5] != cur[5]:  # different chr
                if ov0 or ov1:
                    n_diff[1] += 1
                elif show_err:
                    _p("J", *prev[:12])
                    _p("J", *cur[:12])
                n_diff[0] += 1
            elif prev[4] == cur[4]:  # a gap
                dq = cur[2] - prev[3]
                dr = cur[7] - prev[8] if cur[4] == "+" else prev[7] - cur[8]
                if abs(dr - dq) > max_gap:
                    if ov0 or ov1:
                        n_gap[1] += 1
                    elif show_err:
                        _p("G", *prev[:12])
                        _p("G", *cur[:12])
                    n_gap[0] += 1
            elif i + 1 < len(rows) and rows[i + 1][4] == prev[4]:
                if ov0 or ov1:
                    n_inv[1] += 1
                elif show_err:
                    _p("M", *prev[:12])
                    _p("M", *cur[:12])
                    _p("M", *rows[i + 1][:12])
                n_inv[0] += 1
                i += 1
            else:  # hanging inversion
                if ov0 or ov1:
                    n_inv_end[1] += 1
                n_inv_end[0] += 1
            i += 1

    a: List[list] = []
    with _open(args.pos[0]) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if a and a[0][0] != t[0]:
                process(a)
                a = []
            a.append(t)
    if a:
        process(a)
    print("# inter-chromosomal misjoins: %d,%d" % tuple(n_diff))
    print("# intra-chromosomal gaps: %d,%d" % tuple(n_gap))
    print("# candidate inversions in the middle: %d,%d" % tuple(n_inv))
    print("# candidate inversions at contig ends: %d,%d" % tuple(n_inv_end))
    return 0


# ---------------------------------------------------------------------------
# vcfpair (paftools.js:1251-1348)

def cmd_vcfpair(argv: List[str]) -> int:
    is_male, sample, hgver = False, "syndip", None
    PAR = {"37": [[0, 2699520], [154931043, 155260560]]}
    args = _getopt(argv, "ms:g:")
    for o, v in args.opts:
        if o == "m":
            is_male = True
        elif o == "s":
            sample = v
        elif o == "g":
            hgver = v
    if is_male and (hgver is None or hgver not in PAR):
        raise RuntimeError("for a male, -g must be specified to properly "
                           "handle PARs on chrX")
    if not args.pos:
        _warn("Usage: paftools vcfpair [options] <in.pair.vcf>")
        return 1
    re_ctg = re.compile(r"^(chr)?([0-9]+|X|Y)$" if is_male
                        else r"^(chr)?([0-9]+|X)$")
    with _open(args.pos[0]) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("#"):
                if re.match(r"^##(source|reference)=", line):
                    continue
                m = re.match(r"^##contig=.*ID=([^\s,]+)", line)
                if m is not None:
                    if not re_ctg.match(m.group(1)):
                        continue
                elif line.startswith("#CHROM"):
                    t = line.split("\t")[:-1]
                    t[-1] = sample
                    line = "\t".join(t)
                    print('##FILTER=<ID=HET1,Description="Heterozygous in '
                          'the first haplotype">')
                    print('##FILTER=<ID=HET2,Description="Heterozygous in '
                          'the second haplotype">')
                    print('##FILTER=<ID=GAP1,Description="Uncalled in the '
                          'first haplotype">')
                    print('##FILTER=<ID=GAP2,Description="Uncalled in the '
                          'second haplotype">')
                print(line)
                continue
            t = line.split("\t")
            if not re_ctg.match(t[0]):
                continue
            AD = None
            FILTER: List[str] = []
            HT = [None, None]
            for i in range(2):
                m = re.match(r"^(\.|[0-9]+)/(\.|[0-9]+):(\S+)", t[9 + i])
                if m is None:
                    _warn(line)
                    raise RuntimeError("malformatted VCF")
                s = m.group(3).split(",")
                if AD is None:
                    AD = [0] * len(s)
                for j, x in enumerate(s):
                    AD[j] += int(x)
                if m.group(1) == ".":
                    FILTER.append("GAP%d" % (i + 1))
                    HT[i] = "."
                elif m.group(1) != m.group(2):
                    FILTER.append("HET%d" % (i + 1))
                    HT[i] = "."
                else:
                    HT[i] = m.group(1)
            t = t[:-1]
            hap, st = 0, int(t[1])
            en = st + len(t[3])
            if is_male:
                if re.match(r"^(chr)?X", t[0]):
                    in_par = any(r[0] <= st and en <= r[1]
                                 for r in PAR[hgver])
                    hap = 0 if in_par else 2
                elif re.match(r"^(chr)?Y", t[0]):
                    hap = 1
            if hap > 0 and len(FILTER) == 1:
                if (hap == 2 and FILTER[0] == "GAP1") or \
                        (hap == 1 and FILTER[0] == "GAP2"):
                    FILTER = []
            t[5] = "30"
            t[6] = ";".join(FILTER) if FILTER else "."
            t[9] = "|".join(HT) + ":" + ",".join(map(str, AD))
            print("\t".join(map(str, t)))
    return 0


# ---------------------------------------------------------------------------
# sveval (paftools.js:2721-2831)

def cmd_sveval(argv: List[str]) -> int:
    min_flt, min_size, max_size, win_size = 30, 50, 10000, 500
    print_err, bed_fn = False, None
    args = _getopt(argv, "f:i:x:w:er:")
    for o, v in args.opts:
        if o == "f":
            min_flt = int(parse_num(v))
        elif o == "i":
            min_size = int(parse_num(v))
        elif o == "x":
            max_size = int(parse_num(v))
        elif o == "w":
            win_size = int(parse_num(v))
        elif o == "r":
            bed_fn = v
        elif o == "e":
            print_err = True
    if len(args.pos) < 2:
        _warn("Usage: paftools sveval [options] <base.vcf> <call.vcf>")
        return 1

    bed = None
    if bed_fn:
        bed = {}
        with _open(bed_fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                bed.setdefault(t[0], []).append([int(t[1]), int(t[2])])
        for x in bed:
            intv_sort(bed[x])
            intv_merge(bed[x])
            intv_index_end(bed[x])

    def read_vcf(fn):
        v: Dict[str, List[list]] = {}
        with _open(fn) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                if t[0].startswith("#"):
                    continue
                if bed is not None and t[0] not in bed:
                    continue
                if t[4] in ("<INV>", "<INVDUP>"):
                    continue
                if re.search(r"[\[\]]", t[4]):
                    continue
                st = int(t[1]) - 1
                en = st + len(t[3])
                m = re.search(r"(?:^|;)END=(\d+)", t[7])
                if m:
                    en = int(m.group(1))
                if bed is not None and \
                        not intv_find_ovlp(bed[t[0]], st, en):
                    continue
                max_del = max_ins = 0
                for alt in t[4].split(","):
                    l = len(alt) - len(t[3])
                    if l > 0:
                        max_ins = max(max_ins, l)
                    elif l < 0:
                        max_del = max(max_del, -l)
                if max_ins < min_flt and max_del < min_flt:
                    continue
                svlen = max_ins if max_ins > max_del else -max_del
                m = re.search(r"(?:^|;)SVLEN=(\d+)", t[7])
                if m:
                    svlen = int(m.group(1))
                abslen = abs(svlen)
                if abslen < min_flt or abslen > max_size:
                    continue
                v.setdefault(t[0], []).append([st, en, svlen, abslen])
        for x in v:
            intv_sort(v[x])
            intv_index_end(v[x])
        return v

    def compare(v0, v1, label):
        m = n = 0
        for x, a1 in v1.items():
            a0 = v0.get(x)
            for row in a1:
                if row[3] < min_size:
                    continue
                n += 1
                if a0 is None:
                    continue
                st = row[0] - win_size if row[0] > win_size else 0
                if intv_find_ovlp(a0, st, row[1] + win_size):
                    m += 1
                elif print_err:
                    _p(label, x, *row[:3])
        return n, m

    v_base = read_vcf(args.pos[0])
    v_call = read_vcf(args.pos[1])
    fn_n, fn_m = compare(v_call, v_base, "FN")
    fp_n, fp_m = compare(v_base, v_call, "FP")
    _p("SN", fn_n, fn_m, "%.6f" % (fn_m / fn_n if fn_n else 0.0))
    _p("PC", fp_n, fp_m, "%.6f" % (fp_m / fp_n if fp_n else 0.0))
    _p("F1", "%.6f" % (((fn_m / fn_n if fn_n else 0.0) +
                        (fp_m / fp_n if fp_n else 0.0)) / 2))
    return 0


COMMANDS = {
    "asmstat": cmd_asmstat,
    "asmgene": cmd_asmgene,
    "misjoin": cmd_misjoin,
    "vcfpair": cmd_vcfpair,
    "sveval": cmd_sveval,
}

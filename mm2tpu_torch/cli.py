"""Command-line entry point of the port: minimap2-style arguments,
chaining (and with `--align-backend gpu` the extension fills) on a torch
device, in stream mode (the default, as in the JAX package) or batch
mode.

Counterpart of `mm2tpu/cli.py` (`main`, `_map_batch`, `_map_one_frag`,
`_map_all`, `_split_merge`, `cli_entry`). The option surface
(`build_parser`, `_parse_num`, `apply_args`), the index reader
(`index_parts`, `_mmi_cached_parts`), `_revcomp_bseq` and the emission
(`emit`) are the port's verbatim copies of that module's; `--router-params`
loads the port's cost model (`mapping/costmodel.py`). Added: `--device
{cuda,cpu}` and the value `gpu` of `--align-backend`, `--seed-backend`
and `--chain-backend`. The default map mode is `stream`, as in the JAX
package: every chaining task is placed on its own (`--chain-backend
auto`: by the H100 cost model and the card's queue; `gpu`: all on K1/K2
at B = 1; `native`, `python`: the host DP), on a pool of `-t` threads
whose results are emitted in input order. `--map-mode batch` chains a
size bucket of reads a launch. `--split-prefix` works in both modes.
`--mesh N` (batch mode) splits each bucket's rows over N shards: the
cards cuda:0 .. N-1 with `--device cuda` (fewer visible cards is an
error, where the JAX package quietly takes fewer), N CPU shards with
`--device cpu`. `--hosts N` runs N host processes, each mapping every
N-th fragment and joined by a `torch.distributed.TCPStore` at
`--coordinator` (`parallel/multihost.py`); host 0 merges their stripes
into `-o OUTPUT`. `--profile-trace DIR` writes a `torch.profiler` trace
of the mapping loop into DIR (`utils/profiling.py`). Usage:

    python -m mm2tpu_torch.cli -x map-ont [--chain-backend
        auto|gpu|native|python] [--router-params JSON] [-t N]
        [--device cuda] ref.fa reads.fa
    python -m mm2tpu_torch.cli -x map-ont --map-mode batch [--device cuda]
        ref.fa reads.fa
    python -m mm2tpu_torch.cli -x map-ont -a --align-backend gpu \
        [--align-tpu-min-mat N] [--device cuda] ref.fa reads.fa
    python -m mm2tpu_torch.cli -x sr [-a [--align-backend gpu]] \
        [--device cuda] ref.fa reads_1.fq reads_2.fq
    python -m mm2tpu_torch.cli -x splice [-a] [--device cuda] ref.fa reads.fa
    python -m mm2tpu_torch.cli -x map-ont --map-mode batch --seed-backend \
        gpu [--device cuda] ref.fa reads.fa
    python -m mm2tpu_torch.cli -x map-ont --mesh N [--device cuda] ref.fa \
        reads.fa
    python -m mm2tpu_torch.cli -x map-ont --hosts N --host-id I \
        --coordinator ADDR:PORT -o out.paf [--device cuda] ref.fa reads.fa
    python -m mm2tpu_torch.cli -x map-ont --profile-trace DIR [--device \
        cuda] ref.fa reads.fa
"""
from __future__ import annotations

import argparse
import contextlib
import io as io_mod
import os
import sys
from typing import List, Optional

import torch

from . import __version__
from .device import DEVICES, resolve_device
from .index.build import build_index, save_index, MM_I_HPC, MM_I_NO_SEQ
from .index.mmi import write_mmi, MAGIC
from .io.bseq import FastxReader, read_fastx
from .io.format import write_paf, write_sam, sam_header
from .mapping import costmodel
from .options import (set_opt, mapopt_update, check_opt, MapOptions, IdxOptions,
                      MM_F_CIGAR, MM_F_OUT_SAM, MM_F_OUT_CG, MM_F_OUT_CS,
                      MM_F_OUT_CS_LONG, MM_F_OUT_MD, MM_F_NO_PRINT_2ND,
                      MM_F_ALL_CHAINS, MM_F_NO_DIAG, MM_F_NO_DUAL,
                      MM_F_NO_LJOIN, MM_F_SR, MM_F_FRAG_MODE, MM_F_EQX,
                      MM_F_SOFTCLIP, MM_F_PAF_NO_HIT, MM_F_SAM_HIT_ONLY,
                      MM_F_FOR_ONLY, MM_F_REV_ONLY, MM_F_COPY_COMMENT,
                      MM_F_SPLICE, MM_F_SPLICE_FOR, MM_F_SPLICE_REV,
                      MM_F_HARD_MLEVEL, MM_F_NO_END_FLT, MM_F_INDEPEND_SEG,
                      MM_F_LONG_CIGAR, MM_F_NO_QUAL, MM_F_HEAP_SORT)
from .parallel import multihost
from .parallel.mesh import make_mesh
from .utils import profiling, timing

# ---- copied verbatim from mm2tpu/cli.py ----

MM_VERSION = f"2.18-mm2tpu-{__version__}"


def _parse_num(s: str) -> int:
    mult = 1
    if s and s[-1] in "GgMmKk":
        mult = {"g": 10**9, "m": 10**6, "k": 10**3}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult + 0.499)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mm2tpu", add_help=True,
                                description="TPU-native minimap2-class mapper")
    p.add_argument("target", nargs="?")
    p.add_argument("query", nargs="*")
    p.add_argument("-x", dest="preset")
    p.add_argument("-k", type=int)
    p.add_argument("-w", type=int)
    p.add_argument("-H", action="store_true", help="HPC k-mers")
    p.add_argument("-d", dest="dump_index")
    p.add_argument("-r", dest="bw")
    p.add_argument("-t", type=int, default=3, help="threads (host-side)")
    p.add_argument("-v", type=int, default=3)
    p.add_argument("-g", dest="max_gap")
    p.add_argument("-G", "--max-intron-len", dest="max_intron_len")
    p.add_argument("-F", dest="max_frag_len")
    p.add_argument("-N", dest="best_n", type=int)
    p.add_argument("-p", dest="pri_ratio", type=float)
    p.add_argument("-M", "--mask-level", dest="mask_level", type=float)
    p.add_argument("-c", action="store_true", help="PAF CIGAR")
    p.add_argument("-D", action="store_true", help="--no-self")
    p.add_argument("-P", action="store_true", help="--all-chain")
    p.add_argument("-X", action="store_true")
    p.add_argument("-a", action="store_true", help="SAM output")
    p.add_argument("-Q", action="store_true")
    p.add_argument("-Y", action="store_true")
    p.add_argument("-L", action="store_true")
    p.add_argument("-y", action="store_true")
    p.add_argument("-T", dest="sdust_thres", type=int)
    p.add_argument("-n", "--min-count", dest="min_cnt", type=int)
    p.add_argument("-m", "--min-chain-score", dest="min_chain_score", type=int)
    p.add_argument("-A", dest="match_sc", type=int)
    p.add_argument("-B", dest="mismatch", type=int)
    p.add_argument("-s", "--min-dp-score", dest="min_dp_max", type=int)
    p.add_argument("-I", dest="batch_size")
    p.add_argument("-K", "--mb-size", dest="mb_size")
    p.add_argument("-R", dest="rg")
    p.add_argument("-2", dest="two_io", action="store_true")
    p.add_argument("-o", dest="output")
    p.add_argument("-f", dest="occ_frac")
    p.add_argument("-u", dest="splice_dir")
    p.add_argument("-z", dest="zdrop")
    p.add_argument("-O", dest="gap_open")
    p.add_argument("-E", dest="gap_ext")
    p.add_argument("-V", "--version", action="store_true")
    p.add_argument("--seed", type=int)
    p.add_argument("--bucket-bits", type=int)
    p.add_argument("--max-chain-skip", type=int)
    p.add_argument("--max-chain-iter", type=int)
    p.add_argument("--min-dp-len", type=int)
    p.add_argument("--splice", action="store_true")
    p.add_argument("--no-long-join", action="store_true")
    p.add_argument("--sr", action="store_true")
    p.add_argument("--frag", choices=["yes", "no"])
    p.add_argument("--secondary", choices=["yes", "no"])
    p.add_argument("--cs", nargs="?", const="short")
    p.add_argument("--MD", action="store_true")
    p.add_argument("--eqx", action="store_true")
    p.add_argument("--end-bonus", type=int)
    p.add_argument("--no-pairing", action="store_true")
    p.add_argument("--splice-flank", choices=["yes", "no"])
    p.add_argument("--idx-no-seq", action="store_true")
    p.add_argument("--end-seed-pen", type=int)
    p.add_argument("--for-only", action="store_true")
    p.add_argument("--rev-only", action="store_true")
    p.add_argument("--heap-sort", choices=["yes", "no"])
    p.add_argument("--dual", choices=["yes", "no"])
    p.add_argument("--max-clip-ratio", type=float)
    p.add_argument("--min-occ-floor", type=int)
    p.add_argument("--lj-min-ratio", type=float)
    p.add_argument("--score-N", type=int)
    p.add_argument("--paf-no-hit", action="store_true")
    p.add_argument("--split-prefix")
    p.add_argument("--no-end-flt", action="store_true")
    p.add_argument("--hard-mask-level", action="store_true")
    p.add_argument("--max-qlen")
    p.add_argument("--junc-bed")
    p.add_argument("--junc-bonus", type=int)
    p.add_argument("--sam-hit-only", action="store_true")
    p.add_argument("--chain-gap-scale", type=float)
    p.add_argument("--alt")
    p.add_argument("--alt-drop", type=float)
    p.add_argument("--mask-len")
    p.add_argument("--print-seeds", action="store_true")
    p.add_argument("--print-qname", action="store_true")
    p.add_argument("-C", "--cost-non-gt-ag", dest="noncan", type=int)
    p.add_argument("--cap-sw-mem", dest="cap_sw_mem")
    p.add_argument("--no-kalloc", action="store_true",
                   help="accepted for compatibility (no arena allocator)")
    p.add_argument("--print-aln-seq", action="store_true")
    p.add_argument("--chain-backend", choices=["auto", "tpu", "native", "python"])
    p.add_argument("--router-params", metavar="JSON",
                   help="trained chaining cost-model constants "
                        "(scripts/train_router.py)")
    p.add_argument("--align-backend", choices=["host", "tpu"],
                   help="send large DP fills to the Pallas ksw2 kernels "
                        "(bit-exact)")
    p.add_argument("--seed-backend", choices=["host", "tpu"],
                   help="tpu = probe the index, build and sort anchors on "
                        "device, fused with chaining (batch mode only)")
    p.add_argument("--align-tpu-min-mat", type=int,
                   help="matrix-size threshold (cells) for the tpu align "
                        "backend [1M]")
    p.add_argument("--map-mode", choices=["stream", "batch"],
                   default="stream",
                   help="batch = one device chaining dispatch per size "
                        "bucket of reads (amortizes TPU launch latency)")
    p.add_argument("--mesh", type=int, metavar="N",
                   help="shard batched chaining over an N-device data-"
                        "parallel mesh (implies --map-mode batch)")
    p.add_argument("--hosts", type=int, metavar="N",
                   help="multi-host data parallelism: total number of "
                        "host processes (jax.distributed runtime)")
    p.add_argument("--host-id", type=int, default=0, metavar="I",
                   help="this process's host rank in [0, N)")
    p.add_argument("--coordinator", metavar="ADDR:PORT",
                   help="jax.distributed coordinator address "
                        "(host 0's address)")
    p.add_argument("--host-timeout", type=int, default=600, metavar="SEC",
                   help="multi-host rendezvous/barrier timeout: if any "
                        "host dies, the others exit nonzero after SEC "
                        "seconds with no merged output [600]")
    p.add_argument("--mmi-cache", action="store_true",
                   help="when mapping from a .mmi index, persist each "
                        "part as an MMX sidecar (<index>.mmxcache/): the "
                        "first load converts, later loads mmap in "
                        "milliseconds (genome-scale .mmi parsing is "
                        "sort-bound; see docs/STATUS.md)")
    p.add_argument("--profile", action="store_true",
                   help="print a per-stage timing table on exit (the "
                        "MEASURE_* macros' equivalent, chain_hardware.h:39-45)")
    p.add_argument("--profile-trace", metavar="DIR",
                   help="additionally capture a jax.profiler trace of the "
                        "mapping loop into DIR (implies --profile)")
    return p


def apply_args(args, io: IdxOptions, mo: MapOptions) -> None:
    if args.k is not None:
        io.k = args.k
    if args.w is not None:
        io.w = args.w
    if args.H:
        io.flag |= MM_I_HPC
    if args.bucket_bits is not None:
        io.bucket_bits = args.bucket_bits
    if args.idx_no_seq:
        io.flag |= MM_I_NO_SEQ
    if args.batch_size:
        io.batch_size = _parse_num(args.batch_size)
    if args.mmi_cache:
        io.mmi_cache = True

    if args.bw is not None:
        mo.bw = _parse_num(args.bw)
    if args.max_gap is not None:
        mo.max_gap = _parse_num(args.max_gap)
    if args.max_intron_len is not None and (mo.flag & MM_F_SPLICE):
        mo.max_gap_ref = mo.bw = _parse_num(args.max_intron_len)
    if args.max_frag_len is not None:
        mo.max_frag_len = _parse_num(args.max_frag_len)
    if args.best_n is not None:
        mo.best_n = args.best_n
    if args.pri_ratio is not None:
        mo.pri_ratio = args.pri_ratio
    if args.mask_level is not None:
        mo.mask_level = args.mask_level
    if args.c:
        mo.flag |= MM_F_OUT_CG | MM_F_CIGAR
    if args.D:
        mo.flag |= MM_F_NO_DIAG
    if args.P:
        mo.flag |= MM_F_ALL_CHAINS
    if args.X:
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
    if args.a:
        mo.flag |= MM_F_OUT_SAM | MM_F_CIGAR
    if args.Q:
        mo.flag |= MM_F_NO_QUAL
    if args.Y:
        mo.flag |= MM_F_SOFTCLIP
    if args.L:
        mo.flag |= MM_F_LONG_CIGAR
    if args.y:
        mo.flag |= MM_F_COPY_COMMENT
    if args.sdust_thres is not None:
        mo.sdust_thres = args.sdust_thres
    if args.noncan is not None:
        mo.noncan = args.noncan
    if args.cap_sw_mem is not None:
        mo.max_sw_mat = _parse_num(args.cap_sw_mem)
    if args.print_qname:
        mo.dbg_print_qname = True
    if args.min_cnt is not None:
        mo.min_cnt = args.min_cnt
    if args.min_chain_score is not None:
        mo.min_chain_score = args.min_chain_score
    if args.match_sc is not None:
        mo.a = args.match_sc
    if args.mismatch is not None:
        mo.b = args.mismatch
    if args.min_dp_max is not None:
        mo.min_dp_max = args.min_dp_max
    if args.mb_size:
        mo.mini_batch_size = _parse_num(args.mb_size)
    if args.seed is not None:
        mo.seed = args.seed
    if args.max_chain_skip is not None:
        mo.max_chain_skip = args.max_chain_skip
    if args.max_chain_iter is not None:
        mo.max_chain_iter = args.max_chain_iter
    if args.min_dp_len is not None:
        mo.min_ksw_len = args.min_dp_len
    if args.splice:
        mo.flag |= MM_F_SPLICE
    if args.no_long_join:
        mo.flag |= MM_F_NO_LJOIN
    if args.sr:
        mo.flag |= MM_F_SR
    if args.frag == "yes":
        mo.flag |= MM_F_FRAG_MODE
    elif args.frag == "no":
        mo.flag &= ~MM_F_FRAG_MODE
    if args.secondary == "no":
        mo.flag |= MM_F_NO_PRINT_2ND
    elif args.secondary == "yes":
        mo.flag &= ~MM_F_NO_PRINT_2ND
    if args.cs is not None:
        mo.flag |= MM_F_OUT_CS | MM_F_CIGAR
        if args.cs == "long":
            mo.flag |= MM_F_OUT_CS_LONG
        elif args.cs == "none":
            mo.flag &= ~MM_F_OUT_CS
    if args.MD:
        mo.flag |= MM_F_OUT_MD
    if args.eqx:
        mo.flag |= MM_F_EQX
    if args.end_bonus is not None:
        mo.end_bonus = args.end_bonus
    if args.no_pairing:
        mo.flag |= MM_F_INDEPEND_SEG
    if args.end_seed_pen is not None:
        mo.anchor_ext_shift = args.end_seed_pen
    if args.for_only:
        mo.flag |= MM_F_FOR_ONLY
    if args.rev_only:
        mo.flag |= MM_F_REV_ONLY
    if args.heap_sort == "yes":
        mo.flag |= MM_F_HEAP_SORT
    elif args.heap_sort == "no":
        mo.flag &= ~MM_F_HEAP_SORT
    if args.dual == "no":
        mo.flag |= MM_F_NO_DUAL
    elif args.dual == "yes":
        mo.flag &= ~MM_F_NO_DUAL
    if args.max_clip_ratio is not None:
        mo.max_clip_ratio = args.max_clip_ratio
    if args.min_occ_floor is not None:
        mo.min_mid_occ = args.min_occ_floor
    if args.lj_min_ratio is not None:
        mo.min_join_flank_ratio = args.lj_min_ratio
    if args.score_N is not None:
        mo.sc_ambi = args.score_N
    if args.paf_no_hit:
        mo.flag |= MM_F_PAF_NO_HIT
    if args.split_prefix:
        mo.split_prefix = args.split_prefix
    if args.no_end_flt:
        mo.flag |= MM_F_NO_END_FLT
    if args.hard_mask_level:
        mo.flag |= MM_F_HARD_MLEVEL
    if args.max_qlen:
        mo.max_qlen = _parse_num(args.max_qlen)
    if args.junc_bonus is not None:
        mo.junc_bonus = args.junc_bonus
    if args.sam_hit_only:
        mo.flag |= MM_F_SAM_HIT_ONLY
    if args.chain_gap_scale is not None:
        mo.chain_gap_scale = args.chain_gap_scale
    if args.alt_drop is not None:
        mo.alt_drop = args.alt_drop
    if args.mask_len:
        mo.mask_len = _parse_num(args.mask_len)
    if args.occ_frac:
        x = float(args.occ_frac.split(",")[0])
        if x < 1.0:
            mo.mid_occ_frac = x
            mo.mid_occ = 0
        else:
            mo.mid_occ = int(x + 0.499)
        if "," in args.occ_frac:
            mo.max_occ = int(float(args.occ_frac.split(",")[1]) + 0.499)
    if args.splice_dir:
        d = args.splice_dir[0]
        if d == "b":
            mo.flag |= MM_F_SPLICE_FOR | MM_F_SPLICE_REV
        elif d == "f":
            mo.flag |= MM_F_SPLICE_FOR
            mo.flag &= ~MM_F_SPLICE_REV
        elif d == "r":
            mo.flag |= MM_F_SPLICE_REV
            mo.flag &= ~MM_F_SPLICE_FOR
        elif d == "n":
            mo.flag &= ~(MM_F_SPLICE_FOR | MM_F_SPLICE_REV)
    if args.zdrop:
        parts = args.zdrop.split(",")
        mo.zdrop = mo.zdrop_inv = int(parts[0])
        if len(parts) > 1:
            mo.zdrop_inv = int(parts[1])
    if args.gap_open:
        parts = args.gap_open.split(",")
        mo.q = mo.q2 = int(parts[0])
        if len(parts) > 1:
            mo.q2 = int(parts[1])
    if args.gap_ext:
        parts = args.gap_ext.split(",")
        mo.e = mo.e2 = int(parts[0])
        if len(parts) > 1:
            mo.e2 = int(parts[1])
    if args.chain_backend:
        mo.chain_backend = args.chain_backend
    if args.router_params:
        from .mapping import costmodel
        costmodel.set_default_model(costmodel.CostModel.load(
            args.router_params))
    if args.align_backend:
        mo.align_backend = args.align_backend
    if args.seed_backend:
        mo.seed_backend = args.seed_backend
    if args.align_tpu_min_mat is not None:
        mo.align_tpu_min_mat = args.align_tpu_min_mat
    if args.print_seeds:  # forces -t 1 like main.c:194
        mo.dbg_print_seed = True
        args.t = 1
    if args.print_aln_seq:  # main.c:198
        mo.dbg_print_aln_seq = True
        args.t = 1


def _mmi_cached_parts(target: str):
    """`--mmi-cache`: serve .mmi parts from an MMX sidecar directory
    (<target>.mmxcache/), building it on the first load. Genome-scale
    .mmi parsing is bound by the global key sort (~400 ns/key; the
    reference rebuilds per-bucket khashes instead, index.c:481-534) —
    the MMX sidecar mmaps in milliseconds. The cache key is the .mmi's
    (size, mtime); a stale or unwritable cache degrades to plain
    parsing, never to an error."""
    import json
    from .index.build import load_index, save_index
    from .index.mmi import read_mmi_parts
    d = target + ".mmxcache"
    meta_p = os.path.join(d, "meta.json")
    st = os.stat(target)
    sig = [st.st_size, st.st_mtime_ns]
    try:
        with open(meta_p) as fh:
            meta = json.load(fh)
        if meta.get("sig") == sig:
            # load EVERY part before yielding any: a missing/torn part
            # file must fall through to the rebuild path cleanly, not
            # after part 0's mappings were already emitted
            parts = [load_index(os.path.join(d, "part%d.mmx" % i))
                     for i in range(meta["n_parts"])]
            yield from parts
            return
    except Exception:
        pass
    writable = True
    try:
        os.makedirs(d, exist_ok=True)
    except Exception:
        writable = False
    n = 0
    pid = os.getpid()
    for mi in read_mmi_parts(target):
        if writable:
            # tmp + atomic replace: concurrent first runs and readers
            # holding mmaps of an old cache each see a complete file
            # (the old inode stays alive under its maps)
            try:
                tmp = os.path.join(d, ".part%d.%d.tmp" % (n, pid))
                save_index(mi, tmp)
                os.replace(tmp, os.path.join(d, "part%d.mmx" % n))
            except Exception:
                writable = False
        n += 1
        yield mi
    if writable:
        try:
            tmp = meta_p + ".%d.tmp" % pid
            with open(tmp, "w") as fh:
                json.dump({"sig": sig, "n_parts": n}, fh)
            os.replace(tmp, meta_p)
        except Exception:
            pass


def index_parts(target: str, io: IdxOptions, n_threads: int = 1):
    """Generator over index parts (mm_idx_reader semantics, index.c:560-605).
    A prebuilt .mmi yields its stored parts; a FASTA is split into ~`-I`
    (batch_size) base parts at mini-batch granularity (index.c:280-302,
    bseq.c mm_bseq_read chunking)."""
    with open(target, "rb") as f:
        magic = f.read(4)
    if magic == MAGIC:
        from .index.mmi import read_mmi_parts
        if io.mmi_cache:
            yield from _mmi_cached_parts(target)
        else:
            yield from read_mmi_parts(target)
        return
    if magic == b"MMX1" or (magic == b"PK\x03\x04" and
                            target.endswith(".npz")):
        # native device-ready index (the .mmi analogue for the TPU build,
        # SURVEY §5 checkpoint/resume: 'serialized device-ready index
        # arrays'); single-part by construction
        from .index.build import load_index
        yield load_index(target)
        return
    it = iter(read_fastx(target))
    pending = None
    # the reference clamps the mini-batch to the part size (index.c:359),
    # so small -I values actually split parts
    mini = min(io.mini_batch_size, io.batch_size)
    while True:
        part, sum_len = [], 0
        while sum_len <= io.batch_size:
            mb, mb_len = [], 0
            while mb_len < mini:
                r = pending if pending is not None else next(it, None)
                pending = None
                if r is None:
                    break
                mb.append(r)
                mb_len += len(r.seq)
            if not mb:
                break
            part.extend(mb)
            sum_len += mb_len
        if not part:
            return
        yield build_index([r.name for r in part], [r.seq for r in part],
                          w=io.w, k=io.k, flag=io.flag,
                          bucket_bits=io.bucket_bits, n_threads=n_threads)


def _revcomp_bseq(s) -> None:
    """mm_revcomp_bseq: reverse-complement the bases, reverse the quals."""
    from .io.bseq import revcomp as _rc
    s.seq = _rc(s.seq)
    if s.qual:
        s.qual = s.qual[::-1]


def emit(mi, mo: MapOptions, frag, res, out) -> None:
    """Ordered per-fragment emission (map.c:563-618 step 2)."""
    n_seg = len(frag)
    n_regss = [len(r) for r in res.regs]
    rep_lens = getattr(res, "rep_lens", None)
    for i, seq in enumerate(frag):
        rep_len = rep_lens[i] if rep_lens else res.rep_len
        regs = res.regs[i]
        if regs:
            for j, r in enumerate(regs):
                if (mo.flag & MM_F_NO_PRINT_2ND) and r.id != r.parent:
                    continue
                if mo.flag & MM_F_OUT_SAM:
                    print(write_sam(mi, seq, i, j, n_seg, n_regss, res.regs,
                                    mo.flag, rep_len), file=out)
                else:
                    print(write_paf(mi, seq.name, seq.l_seq, r, mo.flag,
                                    rep_len, seq.comment, seq.seq), file=out)
        elif (mo.flag & MM_F_PAF_NO_HIT) or ((mo.flag & MM_F_OUT_SAM) and
                                             not (mo.flag & MM_F_SAM_HIT_ONLY)):
            if mo.flag & MM_F_OUT_SAM:
                print(write_sam(mi, seq, i, -1, n_seg, n_regss, res.regs,
                                mo.flag, rep_len), file=out)
            else:
                print(write_paf(mi, seq.name, seq.l_seq, None, mo.flag,
                                rep_len, seq.comment), file=out)


# ---- the port's driver ----


def _unsupported(args, mo: MapOptions) -> Optional[str]:
    """What this slice of the port does not run, by ROADMAP item."""
    if args.seed_backend == "tpu":
        return ("--seed-backend tpu (the JAX package's device seeding; the "
                "port's is --seed-backend gpu)")
    if args.align_backend == "tpu":
        return ("--align-backend tpu (the Pallas kernels; the port's device "
                "extension is --align-backend gpu)")
    if args.chain_backend == "tpu":
        return ("--chain-backend tpu (the Pallas chaining kernels; the "
                "port's device route is --chain-backend gpu)")
    return None


def build_torch_parser():
    p = build_parser()
    p.prog = "mm2tpu-torch"
    p.description = "minimap2-class mapper, chaining on a PyTorch device"
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="where the chaining DP (and with --align-backend "
                        "gpu the extension and splice fills) runs: cuda = "
                        "the Hopper kernels, cpu = their plain PyTorch "
                        "versions [cuda]")
    act = next(a for a in p._actions if a.dest == "align_backend")
    act.choices = ["host", "tpu", "gpu"]
    act.help = ("gpu = extension fills (extd2, and exts2 for spliced "
                "reads) of at least --align-tpu-min-mat cells, batched "
                "across reads, on --device (bit-exact); host = the native "
                "extension")
    act = next(a for a in p._actions if a.dest == "chain_backend")
    act.choices = ["auto", "tpu", "gpu", "native", "python"]
    act.help = ("--map-mode stream: where each chaining task runs; auto = "
                "by the cost model (--router-params, else the H100 "
                "constants of mm2tpu_torch/data) and the card's queue, gpu "
                "= K1/K2 on --device, native/python = the exact host DP "
                "[auto]")
    act = next(a for a in p._actions if a.dest == "mesh")
    act.help = ("split each batch bucket's rows over N shards (implies "
                "--map-mode batch): the cards cuda:0..N-1 with --device "
                "cuda (fewer visible cards is an error), N CPU shards with "
                "--device cpu")
    act = next(a for a in p._actions if a.dest == "hosts")
    act.help = ("multi-host data parallelism: total number of host "
                "processes, joined by a torch.distributed.TCPStore; host h "
                "maps every fragment i with i %% N == h and host 0 merges "
                "the stripes into -o OUTPUT, which must lie on a "
                "filesystem every host sees")
    act = next(a for a in p._actions if a.dest == "coordinator")
    act.help = "host 0's address: it serves the torch.distributed TCPStore"
    act = next(a for a in p._actions if a.dest == "map_mode")
    act.help = ("batch = one chaining launch per size bucket of reads; "
                "stream = each read on its own, each chaining task placed "
                "by --chain-backend [stream]")
    act = next(a for a in p._actions if a.dest == "profile_trace")
    act.help = ("additionally write a torch.profiler trace of the mapping "
                "loop into DIR, TensorBoard's layout (one *.pt.trace.json "
                "a process; every thread's stage ranges, and the kernels "
                "on the card), implies --profile")
    act = next(a for a in p._actions if a.dest == "seed_backend")
    act.choices = ["host", "tpu", "gpu"]
    act.help = ("gpu = the index probe, the anchor build and sort and the "
                "chaining on --device, in one dispatch per bucket, for "
                "single-segment reads outside the ava presets (the others "
                "seed on the host; byte-identical output); host = seeding "
                "on the host")
    return p


def main(argv: Optional[List[str]] = None, *, chain_fn=None,
         ext_fn=None, exts2_fn=None, seed_fn=None, mesh=None) -> int:
    """Run the CLI on `argv`; returns the exit code. `chain_fn` replaces
    the chaining function of every batch (see
    `ops.chain_packed.chain_scores_packed`), `ext_fn` and `exts2_fn` the
    extension function of every extd2 and splice flush of
    `--align-backend gpu` (see `ops.ksw2_extd2.extd2_batch` and
    `ops.ksw2_exts2.exts2_batch`), `seed_fn` the fused seeding and
    chaining of every bucket of `--seed-backend gpu` (see
    `ops.seed_device.seed_chain`): a check runs the same arguments
    through the kernels' plain versions with them. They apply to batch
    mode only. `mesh` (`parallel.mesh.make_mesh`) takes the place of the
    mesh that `--mesh` builds, as when a check puts two shards on one
    card. The cost model that `--router-params` loads, a finished
    warm-up of the card with its failure, and the trace directory of
    `--profile-trace` are dropped when the call returns."""
    try:
        return _main(argv, chain_fn, ext_fn, exts2_fn, seed_fn, mesh)
    finally:
        costmodel.reset_default_model()
        costmodel.reset_probe()
        profiling.end_trace()


def _main(argv, chain_fn, ext_fn, exts2_fn, seed_fn, mesh) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    # ketopt optional-argument semantics (as mm2tpu.cli.main)
    argv = ["--cs=short" if a == "--cs" else a for a in argv]
    parser = build_torch_parser()
    args = parser.parse_args(argv)
    if args.version:
        print(MM_VERSION)
        return 0
    if not args.target:
        parser.print_usage()
        return 1
    timing.verbose = args.v
    if args.profile or args.profile_trace:
        profiling.enable(args.profile_trace)

    io, mo = set_opt(None)
    if args.preset:
        io, mo = set_opt(args.preset, io, mo)
    apply_args(args, io, mo)
    if not args.dump_index and not (mo.flag & MM_F_CIGAR):
        io.flag |= MM_I_NO_SEQ
    check_opt(io, mo)
    why = _unsupported(args, mo)
    if why:
        print("[ERROR] mm2tpu_torch does not support %s yet" % why,
              file=sys.stderr)
        return 1
    hostcfg = multihost.HostConfig(args.hosts or 1, args.host_id,
                                   args.coordinator,
                                   timeout_s=args.host_timeout)
    if hostcfg.active:   # as mm2tpu.cli.main, in the same words
        if not (0 <= hostcfg.host_id < hostcfg.n_hosts) or \
                not hostcfg.coordinator:
            print("[ERROR] --hosts needs --coordinator and a valid "
                  "--host-id", file=sys.stderr)
            return 1
        if not args.output or args.output == "-":
            print("[ERROR] --hosts requires -o OUTPUT (host 0 merges the "
                  "per-host stripes there)", file=sys.stderr)
            return 1
        if mo.split_prefix:
            print("[ERROR] --hosts with --split-prefix is not supported",
                  file=sys.stderr)
            return 1
    if args.mesh or mesh is not None:
        args.map_mode = "batch"   # as in mm2tpu.cli: --mesh is batch mode
    if args.map_mode == "stream":
        # device seeding is batch-only, as in the JAX package; the batch
        # hooks have no stream counterpart
        if mo.seed_backend == "gpu":
            print("[ERROR] --seed-backend gpu runs in --map-mode batch only "
                  "(the default map mode is stream): add --map-mode batch",
                  file=sys.stderr)
            return 1
        if any(fn is not None for fn in (chain_fn, ext_fn, exts2_fn,
                                         seed_fn)):
            raise ValueError("chain_fn, ext_fn, exts2_fn and seed_fn apply "
                             "to --map-mode batch only")
    if args.mesh and mesh is None:
        # cuda: the cards cuda:0 .. N-1, or an error naming how many are
        # visible; cpu: N shards on the CPU
        try:
            mesh = make_mesh(args.mesh, devices=["cpu"] * args.mesh
                             if args.device == "cpu" else None)
        except ValueError as e:
            print("[ERROR] --mesh %d: %s" % (args.mesh, e), file=sys.stderr)
            return 1
    try:
        device = resolve_device(mesh[0] if mesh else args.device)
    except RuntimeError as e:
        print("[ERROR] %s" % e, file=sys.stderr)
        return 1
    # the rendezvous comes after the device check (a host without its
    # card never joins a run) and before the output is opened
    try:
        coord = multihost.init_distributed(hostcfg)
    except RuntimeError as e:
        print("[ERROR] multi-host rendezvous failed on host %d: %s"
              % (hostcfg.host_id, e), file=sys.stderr)
        return 1

    # only host 0 writes -o; the others' headers go nowhere
    if coord is not None and coord.host_id != 0:
        out = io_mod.StringIO()
    elif args.output and args.output != "-":
        out = open(args.output, "w")
    else:
        out = sys.stdout
    rc = 1
    try:
        rc = _run(args, argv, io, mo, device, out, chain_fn, ext_fn,
                  exts2_fn, seed_fn, mesh, coord)
    finally:
        if out is not sys.stdout:
            out.close()
        if coord is not None and coord.host_id == 0 and rc != 0:
            # a failed multi-host run leaves no merged output behind
            with contextlib.suppress(OSError):
                os.remove(args.output)
    if rc == 0:
        if costmodel.is_cuda(device):
            costmodel.raise_probe_error()
        if profiling.enabled:
            profiling.report()
        timing.log_trailer(MM_VERSION, "mm2tpu-torch " + " ".join(argv))
    return rc


def _run(args, argv, io, mo: MapOptions, device, out, chain_fn,
         ext_fn, exts2_fn, seed_fn, mesh=None, coord=None) -> int:
    parts = index_parts(args.target, io, n_threads=args.t)
    with profiling.stage("index"):
        mi = next(parts, None)
    if mi is None:
        print("[ERROR] empty target", file=sys.stderr)
        return 1
    n_parts = 0
    while mi is not None:
        timing.log("main", "loaded/built the index for %d target "
                   "sequence(s)" % len(mi.seq))
        if timing.verbose >= 3:  # mm_idx_stat (index.c:100-122)
            st = mi.stat()
            timing.log("mm_idx_stat", "kmer size: %d; skip: %d; is_hpc: %d;"
                       " #seq: %d" % (mi.k, mi.w,
                                      1 if (mi.flag & MM_I_HPC) else 0,
                                      len(mi.seq)))
            timing.log("mm_idx_stat", "distinct minimizers: %d (%.2f%% are "
                       "singletons); average occurrences: %.3f; average "
                       "spacing: %.3f; total length: %d"
                       % (st["distinct_minimizers"], st["singleton_pct"],
                          st["avg_occurrences"], st["avg_spacing"],
                          st["total_length"]))
        with profiling.stage("index"):
            nxt = next(parts, None)
        first, last = n_parts == 0, nxt is None
        if args.dump_index:
            if args.dump_index.endswith((".npz", ".mmx")):
                save_index(mi, args.dump_index)
            else:
                write_mmi(mi, args.dump_index, append=not first)
        if args.query and (mo.flag & MM_F_CIGAR) and (mi.flag & MM_I_NO_SEQ):
            print("[ERROR] the prebuilt index doesn't contain sequences.",
                  file=sys.stderr)
            return 1
        if first and args.query and (mo.flag & MM_F_OUT_SAM):
            # multi-part or split-prefix: header without @SQ (main.c:380-390)
            cmdline = "minimap2 " + " ".join(argv)
            hdr_mi = mi if last and not mo.split_prefix else None
            print(sam_header(hdr_mi, args.rg, MM_VERSION, cmdline), file=out)
            from .io import format as _fmt
            if _fmt._RG_FAILED:  # bad -R: header printed, then exit 1
                return 1
            if not last and not mo.split_prefix:
                print("[WARNING] For a multi-part index, no @SQ lines will "
                      "be outputted. Please use --split-prefix.",
                      file=sys.stderr)
        if args.junc_bed:
            from .index.bed import read_bed
            mi.junc = read_bed(mi, args.junc_bed, read_junc=True)
        if args.alt:
            n_alt = 0
            with open(args.alt) as f:
                for line in f:
                    nm = line.split()[0] if line.split() else ""
                    rid = mi.name2id(nm)
                    if rid >= 0:
                        mi.seq[rid].is_alt = True
                        n_alt += 1
            mi.n_alt = n_alt
        if args.query:
            if coord is not None and not last:
                print("[ERROR] --hosts with a multi-part index is not "
                      "supported (use a single-part index per host)",
                      file=sys.stderr)
                return 1
            mapopt_update(mo, mi)
            n_mapped = map_all(args.query, mi, mo, out, device, chain_fn,
                               ext_fn, exts2_fn, seed_fn, part_idx=n_parts,
                               n_threads=max(1, args.t),
                               map_mode=args.map_mode, mesh=mesh,
                               coord=coord, out_path=args.output)
            timing.log("worker_pipeline", "mapped %d sequences" % n_mapped)
        n_parts += 1
        mi = nxt

    if args.query and mo.split_prefix:
        _split_merge(args.query, mo, n_parts, args.rg, out)
    return 0


def map_batch(mi, mo: MapOptions, batch, consume, device,
              chain_fn=None, ext_fn=None, exts2_fn=None,
              seed_fn=None, mesh=None) -> None:
    """Batched mapping of one mini-batch (mm2tpu.cli._map_batch): paired
    orientation and INDEPEND_SEG splitting as in mm2tpu.cli; with `mesh`,
    each bucket's rows are split over its devices."""
    from .mapping.pipeline import map_frags_batched

    tasks, meta, flips = [], [], []
    for fi, frag in enumerate(batch):
        flip = [len(frag) == 2 and bool((mo.pe_ori >> (1 - j)) & 1)
                for j in range(len(frag))]
        for j, f in enumerate(flip):
            if f:
                _revcomp_bseq(frag[j])
        flips.append(flip)
        seqs = [s.seq for s in frag]
        if (mo.flag & MM_F_INDEPEND_SEG) and len(frag) > 1:
            for j in range(len(frag)):
                tasks.append(([seqs[j]], frag[j].name))
                meta.append((fi, j))
        else:
            tasks.append((seqs, frag[0].name))
            meta.append((fi, None))
    ress = map_frags_batched(mi, [t[0] for t in tasks], mo,
                             [t[1] for t in tasks], device,
                             chain_fn=chain_fn, ext_fn=ext_fn,
                             exts2_fn=exts2_fn, seed_fn=seed_fn, mesh=mesh)
    frag_res = {}
    for (fi, seg), r in zip(meta, ress):
        if seg is None or fi not in frag_res:
            frag_res[fi] = r
            if seg is not None:
                r.rep_lens = [r.rep_len]
        else:
            frag_res[fi].regs.append(r.regs[0])
            frag_res[fi].rep_lens.append(r.rep_len)
    for fi, frag in enumerate(batch):
        res = frag_res[fi]
        seqs = [s.seq for s in frag]
        for j, f in enumerate(flips[fi]):
            if f:
                _revcomp_bseq(frag[j])
                for r in res.regs[j]:
                    r.qs, r.qe = len(seqs[j]) - r.qe, len(seqs[j]) - r.qs
                    r.rev = not r.rev
        consume(frag, res)


def map_one_frag(mi, mo: MapOptions, frag, device):
    """Map one fragment in stream mode (mm2tpu.cli._map_one_frag, the body
    of worker_for, map.c:427-467), its chaining tasks placed one by one
    and its device work on `device`. Pure with respect to shared state,
    so it can run on any mapping thread."""
    from .mapping.pipeline import map_frag

    if mo.dbg_print_qname:  # --print-qname (map.c:434-435)
        import threading
        tid = threading.get_ident() % 1000
        print(f"QR\t{frag[0].name}\t{tid}\t{len(frag[0].seq)}",
              file=sys.stderr)
    # orient mates per pe_ori before joint chaining (map.c:436-441)
    flip = [len(frag) == 2 and bool((mo.pe_ori >> (1 - j)) & 1)
            for j in range(len(frag))]
    for j, f in enumerate(flip):
        if f:
            _revcomp_bseq(frag[j])
    seqs = [s.seq for s in frag]
    if (mo.flag & MM_F_INDEPEND_SEG) and len(frag) > 1:
        # map each segment independently (map.c:442-447)
        res = map_frag(mi, [seqs[0]], mo, frag[0].name, device)
        res.rep_lens = [res.rep_len]
        for j in range(1, len(frag)):
            rj = map_frag(mi, [seqs[j]], mo, frag[j].name, device)
            res.regs.append(rj.regs[0])
            res.rep_lens.append(rj.rep_len)
    else:
        res = map_frag(mi, seqs, mo, frag[0].name, device)
    # flip the query strand/coords back to the read's own strand
    # (map.c:455-466)
    for j, f in enumerate(flip):
        if f:
            _revcomp_bseq(frag[j])
            for r in res.regs[j]:
                r.qs, r.qe = len(seqs[j]) - r.qe, len(seqs[j]) - r.qs
                r.rev = not r.rev
    return res


def map_all(query_paths, mi, mo: MapOptions, out, device,
            chain_fn=None, ext_fn=None, exts2_fn=None, seed_fn=None, *,
            part_idx: int = 0, n_threads: int = 1,
            map_mode: str = "stream", mesh=None, coord=None,
            out_path=None) -> int:
    """Map every query mini-batch against one index part and emit in
    input order, or with --split-prefix dump the part's raw hits to its
    temporary file (mm2tpu.cli._map_all, map.c:571-585, mm_split_init).
    Returns the number of sequences mapped. Each of the three mapping
    loops (batch, stream on one thread, stream on the pool) runs inside
    `profiling.trace_if_enabled`, as in the JAX package.

    Batch mode maps a mini-batch at a time (`map_batch`; with `mesh`,
    each bucket's rows are split over its devices). Stream mode
    maps each fragment on its own (`map_one_frag`): with one thread in
    this thread, with more on a pool of `n_threads` fed by a reader
    thread, whose results are consumed in submission order (the
    reference's 3-step kt_pipeline, map.c:526-621). With
    `--align-backend gpu` and `--profile`, the fills left on the host's
    native extension are counted as `ext.host_fills`.

    With a `coord` (`parallel.multihost.Coordinator`, `--hosts`), both
    map modes map only this host's stripe of the fragments (index %
    n_hosts == host_id) and write each fragment's output, empty or not,
    as one record of its part file of `out_path`; after the `map_done`
    barrier host 0 merges the parts into `out` (mm2tpu.cli._map_all). A
    failure there exits 1."""
    import pickle
    import queue as queue_mod
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from .mapping.pipeline import _count_host_fills

    dump = None
    if mo.split_prefix:
        dump = dict(k=mi.k, seq=[(s.name, s.length) for s in mi.seq],
                    reads=[])
    reader = FastxReader(query_paths, mo.mini_batch_size,
                         bool(mo.flag & MM_F_FRAG_MODE))
    n_mapped = 0
    part_writer = multihost.PartWriter(out_path, coord.host_id) \
        if coord is not None else None

    def consume(frag, res):
        nonlocal n_mapped
        n_mapped += len(frag)
        if dump is not None:
            for j in range(len(frag)):
                dump["reads"].append(
                    (res.regs[j], res.rep_len, res.frag_gap))
        elif part_writer is not None:
            # one record a fragment, an unmapped one's empty, to keep the
            # round-robin merge aligned
            buf = io_mod.StringIO()
            with profiling.stage("emit"):
                emit(mi, mo, frag, res, buf)
            part_writer.write(buf.getvalue())
        else:
            with profiling.stage("emit"):
                emit(mi, mo, frag, res, out)

    def batches():
        """The mini-batches, or with --hosts this host's stripe of them."""
        if coord is None:
            yield from reader.batches()
            return
        idx = 0
        for batch in reader.batches():
            mine = [frag for j, frag in enumerate(batch)
                    if (idx + j) % coord.n_hosts == coord.host_id]
            idx += len(batch)
            if mine:
                yield mine

    if map_mode == "batch":
        with profiling.trace_if_enabled(device):
            for batch in batches():
                map_batch(mi, mo, batch, consume, device, chain_fn, ext_fn,
                          exts2_fn, seed_fn, mesh)
    else:
        counted = _count_host_fills() \
            if mo.align_backend == "gpu" and (mo.flag & MM_F_CIGAR) \
            else contextlib.nullcontext()
        on_device = torch.cuda.device(device) if device.type == "cuda" \
            else contextlib.nullcontext()

        def one(frag):
            # a pool thread does not inherit the caller's CUDA device
            with on_device:
                return map_one_frag(mi, mo, frag, device)

        with counted:
            if n_threads <= 1:
                with profiling.trace_if_enabled(device):
                    for batch in batches():
                        for frag in batch:
                            consume(frag, one(frag))
            else:
                queue: queue_mod.Queue = queue_mod.Queue(maxsize=2)

                def produce():
                    try:
                        for batch in batches():
                            queue.put(batch)
                        queue.put(None)
                    except BaseException as e:  # surface reader errors
                        queue.put(e)

                threading.Thread(target=produce, daemon=True).start()
                with profiling.trace_if_enabled(device), \
                        ThreadPoolExecutor(n_threads) as ex:
                    while True:
                        batch = queue.get()
                        if batch is None:
                            break
                        if isinstance(batch, BaseException):
                            raise batch
                        for frag, res in zip(batch, ex.map(one, batch)):
                            consume(frag, res)
    if dump is not None:
        with open(f"{mo.split_prefix}.{part_idx:04d}.tmp", "wb") as f:
            pickle.dump(dump, f)
    if coord is not None:
        part_writer.close()
        try:
            coord.barrier("map_done")
            if coord.host_id == 0:
                with profiling.stage("merge"):
                    multihost.merge_parts(out_path, coord.n_hosts, out)
                out.flush()
            coord.barrier("merge_done")
            coord.finish()
        except Exception as e:
            # a peer stopped or died, or the shared filesystem lost a
            # part: never a partial merged output (_main removes it)
            print("[ERROR] multi-host run failed on host %d: %s"
                  % (coord.host_id, e), file=sys.stderr)
            raise SystemExit(1)
        if coord.host_id == 0:
            multihost.cleanup_parts(out_path, coord.n_hosts)
    return n_mapped


# ---- copied verbatim from mm2tpu/cli.py ----

def _split_merge(query_paths, mo: MapOptions, n_parts: int, rg, out) -> None:
    """--split-prefix merge pass (mm_split_merge, map.c:469-524,671-714):
    re-read queries in order, concatenate each read's per-part hits with
    rid renumbering, then re-sort/re-select/re-mapq and emit."""
    import os
    import pickle
    from .index.build import MMIndex, RefSeq
    from .mapping import hit as hit_mod
    from .mapping.pipeline import FragResult

    parts = []
    for j in range(n_parts):
        with open(f"{mo.split_prefix}.{j:04d}.tmp", "rb") as f:
            parts.append(pickle.load(f))
    merged = MMIndex(w=0, k=parts[0]["k"], b=0, flag=0)
    rid_shift, off = [], 0
    for pt in parts:
        rid_shift.append(off)
        for name, length in pt["seq"]:
            merged.seq.append(RefSeq(name=name, offset=0, length=length))
            off += 1
    if mo.flag & MM_F_OUT_SAM:
        for s in merged.seq:
            print(f"@SQ\tSN:{s.name}\tLN:{s.length}", file=out)

    frag_mode = bool(mo.flag & MM_F_FRAG_MODE)
    reader = FastxReader(query_paths, mo.mini_batch_size, frag_mode)
    cursor = 0
    for batch in reader.batches():
        for frag in batch:
            res = FragResult(regs=[])
            res.rep_lens = []
            frag_gap0 = 0
            for i in range(len(frag)):
                regs, rep_len = [], 0
                for j, pt in enumerate(parts):
                    pregs, prep, pgap = pt["reads"][cursor + i]
                    for r in pregs:
                        r.rid += rid_shift[j]
                        regs.append(r)
                    rep_len = max(rep_len, prep)
                    if j == 0:
                        frag_gap0 = pgap
                regs = hit_mod.hit_sort(regs, mo.alt_drop)
                hit_mod.set_parent(regs, mo.mask_level, mo.mask_len,
                                   mo.a * 2 + mo.b,
                                   bool(mo.flag & MM_F_HARD_MLEVEL),
                                   mo.alt_drop)
                if not (mo.flag & MM_F_ALL_CHAINS):
                    regs = hit_mod.select_sub(regs, mo.pri_ratio,
                                              merged.k * 2, mo.best_n)
                    hit_mod.set_sam_pri(regs)
                hit_mod.set_mapq(regs, mo.min_chain_score, mo.a, rep_len,
                                 bool(mo.flag & MM_F_SR))
                res.regs.append(regs)
                # the max-over-parts rep_len feeds mapQ only; the merge
                # pipeline's s->rep_len stays zero-initialized, so merged
                # records always print rl:i:0 (map.c:479-505,592-603)
                res.rep_lens.append(0)
            cursor += len(frag)
            if len(frag) == 2 and mo.pe_ori >= 0 and (mo.flag & MM_F_CIGAR):
                from .mapping.pe import pair
                pair(frag_gap0, mo.pe_bonus, mo.a * 2 + mo.b, mo.a,
                     [len(s.seq) for s in frag], res.regs)
            emit(merged, mo, frag, res, out)
    for j in range(n_parts):
        os.remove(f"{mo.split_prefix}.{j:04d}.tmp")


def cli_entry():
    """Process entry point (python -m mm2tpu_torch.cli, mm2tpu-torch). A
    stream run may leave the backend warm-up thread building the kernels;
    the process waits for it and fails if it failed."""
    rc = main()
    costmodel.join_backend_probe()
    if rc == 0:
        costmodel.raise_probe_error()
    sys.exit(rc)


if __name__ == "__main__":
    cli_entry()

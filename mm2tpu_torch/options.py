"""Option/preset system (reference: options.c, minimap.h:103-156).

MapOptions mirrors mm_mapopt_t; presets are applied before other flags,
exactly as the reference CLI does (main.c:131-145).

The port's copy of `mm2tpu/options.py`, verbatim apart from its imports
and its TPU branches.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

# mm_mapopt_t flag bits (minimap.h:8-38)
MM_F_NO_DIAG = 0x001
MM_F_NO_DUAL = 0x002
MM_F_CIGAR = 0x004
MM_F_OUT_SAM = 0x008
MM_F_NO_QUAL = 0x010
MM_F_OUT_CG = 0x020
MM_F_OUT_CS = 0x040
MM_F_SPLICE = 0x080
MM_F_SPLICE_FOR = 0x100
MM_F_SPLICE_REV = 0x200
MM_F_NO_LJOIN = 0x400
MM_F_OUT_CS_LONG = 0x800
MM_F_SR = 0x1000
MM_F_FRAG_MODE = 0x2000
MM_F_NO_PRINT_2ND = 0x4000
MM_F_2_IO_THREADS = 0x8000
MM_F_LONG_CIGAR = 0x10000
MM_F_INDEPEND_SEG = 0x20000
MM_F_SPLICE_FLANK = 0x40000
MM_F_SOFTCLIP = 0x80000
MM_F_FOR_ONLY = 0x100000
MM_F_REV_ONLY = 0x200000
MM_F_HEAP_SORT = 0x400000
MM_F_ALL_CHAINS = 0x800000
MM_F_OUT_MD = 0x1000000
MM_F_COPY_COMMENT = 0x2000000
MM_F_EQX = 0x4000000
MM_F_PAF_NO_HIT = 0x8000000
MM_F_NO_END_FLT = 0x10000000
MM_F_HARD_MLEVEL = 0x20000000
MM_F_SAM_HIT_ONLY = 0x40000000

MM_MAX_SEG = 255

# anchor flag bits (mmpriv.h:17-23)
MM_SEED_LONG_JOIN = 1 << 40
MM_SEED_IGNORE = 1 << 41
MM_SEED_TANDEM = 1 << 42
MM_SEED_SELF = 1 << 43
MM_SEED_SEG_SHIFT = 48
MM_SEED_SEG_MASK = 0xFF << MM_SEED_SEG_SHIFT

INT32_MAX = 2**31 - 1


@dataclass
class MapOptions:
    """mm_mapopt_t equivalent; defaults = mm_mapopt_init (options.c:17-57)."""
    flag: int = 0
    # preset name the options came from (None = raw defaults): the device
    # router selects its trained constants per regime, mirroring the
    # reference's two pasted-in parameter sets (chain_hardware.h:18-30,
    # loaded per-preset in options.c:95-99,118-122)
    preset: Optional[str] = None
    seed: int = 11
    sdust_thres: int = 0
    max_qlen: int = 0

    bw: int = 500
    max_gap: int = 5000
    max_gap_ref: int = -1
    max_frag_len: int = 0
    max_chain_skip: int = 25
    max_chain_iter: int = 5000
    min_cnt: int = 3
    min_chain_score: int = 40
    chain_gap_scale: float = 1.0

    mask_level: float = 0.5
    mask_len: int = INT32_MAX
    pri_ratio: float = 0.8
    best_n: int = 5

    max_join_long: int = 20000
    max_join_short: int = 2000
    min_join_flank_sc: int = 1000
    min_join_flank_ratio: float = 0.5

    alt_drop: float = 0.15

    a: int = 2
    b: int = 4
    q: int = 4
    e: int = 2
    q2: int = 24
    e2: int = 1
    sc_ambi: int = 1
    noncan: int = 0
    junc_bonus: int = 0
    zdrop: int = 400
    zdrop_inv: int = 200
    end_bonus: int = -1
    min_dp_max: int = 80  # min_chain_score * a
    min_ksw_len: int = 200
    anchor_ext_len: int = 20
    anchor_ext_shift: int = 6
    max_clip_ratio: float = 1.0

    pe_ori: int = 0
    pe_bonus: int = 33

    mid_occ_frac: float = 2e-4
    min_mid_occ: int = 0
    mid_occ: int = 0
    max_occ: int = 0
    mini_batch_size: int = 500_000_000
    max_sw_mat: int = 0

    split_prefix: Optional[str] = None

    # mm2tpu extension: chaining backend routing ("auto" mimics the
    # reference's learned HW/SW cost-model split, chain.c:80-111)
    chain_backend: str = "auto"  # auto | tpu | native | python
    # mm2tpu extension: base-level alignment backend; "gpu" sends dual-
    # affine fills above align_tpu_min_mat cells to the extd2 kernel
    align_backend: str = "host"  # host | gpu
    align_tpu_min_mat: int = 1 << 20
    # device-side seeding in --map-mode batch (ops/seed_device.py)
    seed_backend: str = "host"  # host | gpu
    # debug channels (mm_dbg_flag, mmpriv.h:12-15)
    dbg_print_aln_seq: bool = False
    dbg_print_qname: bool = False
    dbg_print_seed: bool = False


@dataclass
class IdxOptions:
    """mm_idxopt_t equivalent (options.c:8-15)."""
    k: int = 15
    w: int = 10
    flag: int = 0
    bucket_bits: int = 14
    mini_batch_size: int = 50_000_000
    batch_size: int = 4_000_000_000
    # --mmi-cache: on .mmi load, persist each part as an MMX sidecar
    # (<path>.mmxcache/) so repeat genome-scale loads are mmap-speed
    mmi_cache: bool = False


def set_opt(preset: Optional[str], io: IdxOptions | None = None,
            mo: MapOptions | None = None) -> tuple[IdxOptions, MapOptions]:
    """mm_set_opt (options.c:77-153). Returns fresh defaults when preset is
    None; otherwise mutates copies of the given options."""
    if preset is None:
        return IdxOptions(), MapOptions()
    io = replace(io) if io else IdxOptions()
    mo = replace(mo) if mo else MapOptions()
    mo.preset = preset
    if preset == "ava-ont":
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_gap, mo.max_chain_skip = 100, 0.0, 10000, 25
        mo.bw = 2000
    elif preset == "ava-pb":
        io.flag |= 0x1  # MM_I_HPC
        io.k, io.w = 19, 5
        mo.flag |= MM_F_ALL_CHAINS | MM_F_NO_DIAG | MM_F_NO_DUAL | MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_gap, mo.max_chain_skip = 100, 0.0, 10000, 25
    elif preset in ("map10k", "map-pb"):
        io.flag |= 0x1
        io.k = 19
    elif preset == "map-ont":
        io.flag, io.k = 0, 15
    elif preset == "asm5":
        io.flag, io.k, io.w = 0, 19, 19
        mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 19, 39, 81, 3, 1
        mo.zdrop = mo.zdrop_inv = 200
        mo.min_mid_occ, mo.min_dp_max, mo.best_n = 100, 200, 50
    elif preset == "asm10":
        io.flag, io.k, io.w = 0, 19, 19
        mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 9, 16, 41, 2, 1
        mo.zdrop = mo.zdrop_inv = 200
        mo.min_mid_occ, mo.min_dp_max, mo.best_n = 100, 200, 50
    elif preset == "asm20":
        io.flag, io.k, io.w = 0, 19, 10
        mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
        mo.zdrop = mo.zdrop_inv = 200
        mo.min_mid_occ, mo.min_dp_max, mo.best_n = 100, 200, 50
    elif preset in ("short", "sr"):
        io.flag, io.k, io.w = 0, 21, 11
        mo.flag |= MM_F_SR | MM_F_FRAG_MODE | MM_F_NO_PRINT_2ND | MM_F_2_IO_THREADS | MM_F_HEAP_SORT
        mo.pe_ori = 0 << 1 | 1  # FR
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 2, 8, 12, 2, 24, 1
        mo.zdrop = mo.zdrop_inv = 100
        mo.end_bonus = 10
        mo.max_frag_len, mo.max_gap, mo.bw = 800, 100, 100
        mo.pri_ratio, mo.min_cnt, mo.min_chain_score = 0.5, 2, 25
        mo.min_dp_max, mo.best_n = 40, 20
        mo.mid_occ, mo.max_occ = 1000, 5000
        mo.mini_batch_size = 50_000_000
    elif preset.startswith("splice") or preset == "cdna":
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= MM_F_SPLICE | MM_F_SPLICE_FOR | MM_F_SPLICE_REV | MM_F_SPLICE_FLANK
        mo.max_gap = 2000
        mo.max_gap_ref = mo.bw = 200000
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 2, 2, 1, 32, 0
        mo.noncan = 9
        mo.junc_bonus = 9
        mo.zdrop, mo.zdrop_inv = 200, 100
        if preset == "splice:hq":
            mo.junc_bonus, mo.b, mo.q, mo.q2 = 5, 4, 6, 24
    else:
        raise ValueError(f"unknown preset '{preset}'")
    return io, mo


def mapopt_update(mo: MapOptions, mi) -> None:
    """mm_mapopt_update (options.c:59-69): derive mid_occ from the index."""
    if (mo.flag & MM_F_SPLICE_FOR) or (mo.flag & MM_F_SPLICE_REV):
        mo.flag |= MM_F_SPLICE
    if mo.mid_occ <= 0:
        mo.mid_occ = mi.cal_max_occ(mo.mid_occ_frac)
    if mo.mid_occ < mo.min_mid_occ:
        mo.mid_occ = mo.min_mid_occ


def check_opt(io: IdxOptions, mo: MapOptions) -> None:
    """mm_check_opt (options.c:155-210); raises on invalid combinations."""
    if mo.split_prefix and (mo.flag & (MM_F_OUT_CS | MM_F_OUT_MD)):
        raise ValueError("--cs or --MD doesn't work with --split-prefix")
    if io.k <= 0 or io.w <= 0:
        raise ValueError("-k and -w must be positive")
    if mo.best_n < 0:
        raise ValueError("-N must be no less than 0")
    if not (0.0 <= mo.pri_ratio <= 1.0):
        raise ValueError("-p must be within 0 and 1")
    if (mo.flag & MM_F_FOR_ONLY) and (mo.flag & MM_F_REV_ONLY):
        raise ValueError("--for-only and --rev-only can't be applied at the same time")
    if mo.e <= 0 or mo.q <= 0:
        raise ValueError("-O and -E must be positive")
    if (mo.q != mo.q2 or mo.e != mo.e2) and not (mo.e > mo.e2 and mo.q + mo.e < mo.q2 + mo.e2):
        raise ValueError("dual gap penalties violating E1>E2 and O1+E1<O2+E2")
    if (mo.q + mo.e) + (mo.q2 + mo.e2) > 127:
        raise ValueError("scoring system violating ({-O}+{-E})+({-O2}+{-E2}) <= 127")
    if mo.zdrop < mo.zdrop_inv:
        raise ValueError("Z-drop should not be less than inversion-Z-drop")
    if (mo.flag & MM_F_NO_PRINT_2ND) and (mo.flag & MM_F_ALL_CHAINS):
        raise ValueError("-X/-P and --secondary=no can't be applied at the same time")

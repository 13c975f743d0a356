"""Command-line entry point of the port: minimap2-style arguments, batch
mode, chaining (and with `--align-backend gpu` the extension fills) on a
torch device.

Counterpart of `mm2tpu/cli.py` (`main`, `_map_batch`, `_map_all`'s batch
branch). The option surface, the index reader, the query reader and the
PAF/SAM emission are the JAX package's, imported as is. Added:
`--device {cuda,cpu}` and the value `gpu` of `--align-backend`. Usage:

    python -m mm2tpu_torch.cli -x map-ont [--device cuda] ref.fa reads.fa
    python -m mm2tpu_torch.cli -x map-ont -a --align-backend gpu \
        [--align-tpu-min-mat N] [--device cuda] ref.fa reads.fa
"""
from __future__ import annotations

import sys
from typing import List, Optional

from mm2tpu.cli import (MM_VERSION, _revcomp_bseq, apply_args, build_parser,
                        emit, index_parts)
from mm2tpu.index.build import MM_I_HPC, MM_I_NO_SEQ, save_index
from mm2tpu.index.mmi import write_mmi
from mm2tpu.io.bseq import FastxReader
from mm2tpu.io.format import sam_header
from mm2tpu.options import (MM_F_CIGAR, MM_F_FRAG_MODE, MM_F_INDEPEND_SEG,
                            MM_F_OUT_SAM, MM_F_SPLICE, MapOptions, check_opt,
                            mapopt_update, set_opt)

from .device import DEVICES, resolve_device
from .utils import profiling, timing


def _unsupported(args, mo: MapOptions) -> Optional[str]:
    """What this slice of the port does not run, by ROADMAP item."""
    if args.mesh:
        return "--mesh (multi-GPU, ROADMAP M8)"
    if args.hosts:
        return "--hosts (multi-host, ROADMAP M9)"
    if args.seed_backend == "tpu":
        return "--seed-backend tpu (device seeding, ROADMAP M7)"
    if args.align_backend == "tpu":
        return ("--align-backend tpu (the Pallas kernels; the port's device "
                "extension is --align-backend gpu)")
    if args.chain_backend:
        return ("--chain-backend (per-task routing of the stream mode, "
                "ROADMAP M3; the port always chains in batch mode)")
    if args.map_mode == "stream":
        return "--map-mode stream (per-task routing, ROADMAP M3)"
    if args.split_prefix:
        return "--split-prefix (ROADMAP M1)"
    if args.profile_trace:
        return "--profile-trace (torch.profiler tracing, ROADMAP M10)"
    if mo.flag & MM_F_SPLICE:
        return "-x splice / --splice (cDNA chaining, ROADMAP M4)"
    if (mo.flag & MM_F_FRAG_MODE) and not (mo.flag & MM_F_INDEPEND_SEG):
        # one file or two: reads sharing a name form one multi-segment task
        return ("fragment mode (-x sr, --frag=yes; multi-segment chaining, "
                "ROADMAP M4; --frag=no or --no-pairing maps each segment "
                "alone)")
    return None


def build_torch_parser():
    p = build_parser()
    p.prog = "mm2tpu-torch"
    p.description = "minimap2-class mapper, chaining on a PyTorch device"
    p.set_defaults(map_mode="batch")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="where the chaining DP (and with --align-backend "
                        "gpu the extension fills) runs: cuda = the Hopper "
                        "kernels, cpu = their plain PyTorch versions [cuda]")
    act = next(a for a in p._actions if a.dest == "align_backend")
    act.choices = ["host", "tpu", "gpu"]
    act.help = ("gpu = extension fills of at least --align-tpu-min-mat "
                "cells, batched across reads, on --device (bit-exact); "
                "host = the native extension")
    return p


def main(argv: Optional[List[str]] = None, *, chain_fn=None,
         ext_fn=None) -> int:
    """Run the CLI on `argv`; returns the exit code. `chain_fn` replaces
    the chaining function of every batch (see
    `ops.chain_packed.chain_scores_packed`) and `ext_fn` the extension
    function of every flush of `--align-backend gpu` (see
    `ops.ksw2_extd2.extd2_batch`): a check runs the same arguments
    through the kernels' plain versions with them."""
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
    if args.profile:
        profiling.enable()

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
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print("[ERROR] %s" % e, file=sys.stderr)
        return 1

    out = open(args.output, "w") if args.output and args.output != "-" \
        else sys.stdout
    try:
        rc = _run(args, argv, io, mo, device, out, chain_fn, ext_fn)
    finally:
        if out is not sys.stdout:
            out.close()
    if rc == 0:
        if profiling.enabled:
            profiling.report()
        timing.log_trailer(MM_VERSION, "mm2tpu-torch " + " ".join(argv))
    return rc


def _run(args, argv, io, mo: MapOptions, device, out, chain_fn,
         ext_fn) -> int:
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
            # multi-part: header without @SQ (main.c:380-390)
            cmdline = "minimap2 " + " ".join(argv)
            print(sam_header(mi if last else None, args.rg, MM_VERSION,
                             cmdline), file=out)
            from mm2tpu.io import format as _fmt
            if _fmt._RG_FAILED:  # bad -R: header printed, then exit 1
                return 1
            if not last:
                print("[WARNING] For a multi-part index, no @SQ lines will "
                      "be outputted. Please use --split-prefix.",
                      file=sys.stderr)
        if args.junc_bed:
            from mm2tpu.index.bed import read_bed
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
            mapopt_update(mo, mi)
            n_mapped = map_all(args.query, mi, mo, out, device, chain_fn,
                               ext_fn)
            timing.log("worker_pipeline", "mapped %d sequences" % n_mapped)
        n_parts += 1
        mi = nxt
    return 0


def map_batch(mi, mo: MapOptions, batch, consume, device,
              chain_fn=None, ext_fn=None) -> None:
    """Batched mapping of one mini-batch (mm2tpu.cli._map_batch): paired
    orientation and INDEPEND_SEG splitting as in mm2tpu.cli."""
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
                             chain_fn=chain_fn, ext_fn=ext_fn)
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


def map_all(query_paths, mi, mo: MapOptions, out, device,
            chain_fn=None, ext_fn=None) -> int:
    """Map every query mini-batch against one index part and emit in
    input order. Returns the number of sequences mapped."""
    reader = FastxReader(query_paths, mo.mini_batch_size,
                         bool(mo.flag & MM_F_FRAG_MODE))
    n_mapped = 0

    def consume(frag, res):
        nonlocal n_mapped
        n_mapped += len(frag)
        with profiling.stage("emit"):
            emit(mi, mo, frag, res, out)

    for batch in reader.batches():
        map_batch(mi, mo, batch, consume, device, chain_fn, ext_fn)
    return n_mapped


def cli_entry():
    """Process entry point (python -m mm2tpu_torch.cli, mm2tpu-torch)."""
    sys.exit(main())


if __name__ == "__main__":
    cli_entry()

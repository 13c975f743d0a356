"""`--profile-trace DIR` (`utils/profiling.py::trace_if_enabled`, a
torch.profiler trace around each of `cli.map_all`'s mapping loops) on
the CPU.

In each loop (batch SAM with `--align-backend gpu`, whose align
threads post each read's fills to the extension batcher, all under its
cell threshold here, so on the host; batch PAF of spliced reads, the
benchmark's `splice.paf` path; stream on one thread; stream on a pool
of two): the traced run's output, its
`--profile` counters and its launch counts equal the untraced run's; DIR
holds one `*.pt.trace.json` whose ranges carry the `--profile` stage
names, from the main thread and, where the loop maps on other threads,
from those threads too (which a trace of the main thread alone would
miss). The index is built outside the trace, which wraps the mapping
loop, as in the JAX package. `--profile` alone writes no file.

In the spliced batch PAF loop the host work has leaf stages
(`seed.prep`, `seed.sketch`, `seed.hits`, `chain.plan`,
`chain.rechain`, `post.finish`, `batch.assemble`, `batch.free`): none
encloses another range, the sketch and the hits nest in `seed`, and
the ranges cover nearly all of `map_batch`'s wall. With the native runtime made
unavailable, each of the path's Python twins counts its runs under
`fallback.<op>` and the PAF is the same."""
import glob
import json

import pytest
import torch

from mm2tpu_torch import cli as tcli
from mm2tpu_torch.mapping import esterr
from mm2tpu_torch.native import lib as native_lib
from mm2tpu_torch.ops import chain_v3, ksw2_extd2
from mm2tpu_torch.utils import profiling
from test_torch_cli_sr_splice import load_chip_smoke
from test_torch_pipeline import load_make_workload

# the leaf stages of the batch driver's host work
HOST_STAGES = {"seed.prep", "seed.sketch", "seed.hits", "chain.plan",
               "chain.rechain", "post.finish", "batch.assemble",
               "batch.free"}

MODES = {
    # batch, SAM on the align threads (the plain extd2 records a few
    # hundred thousand CPU ops a fill, so the fills stay under the cell
    # threshold)
    "batch-sam": (["-x", "map-ont", "--map-mode", "batch", "-a",
                   "--align-backend", "gpu"],
                  "reads", {"seed", "chain.device", "chain.backtrack",
                            "post", "align", "emit"}, True),
    "stream-t1": (["-x", "map-ont", "--map-mode", "stream", "-t", "1"],
                  "reads", {"seed", "route", "chain", "post", "emit"},
                  False),
    "stream-t2": (["-x", "map-ont", "--map-mode", "stream", "-t", "2"],
                  "reads", {"seed", "route", "chain", "post", "emit"},
                  True),
    # the benchmark's splice.paf path: host seeding, K2, post-chain
    "batch-splice-paf": (["-x", "splice", "--map-mode", "batch"],
                         "spliced", {"seed", "chain.device",
                                     "chain.backtrack", "post", "emit"} |
                         HOST_STAGES, False),
}

# the Python twins of the native calls on the spliced batch PAF path
FALLBACKS = ("fallback.seed_batch", "fallback.sketch",
             "fallback.seed_hits", "fallback.gen_regs_fast",
             "fallback.est_err", "fallback.v_carry", "fallback.backtrack")


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    ref, reads = load_make_workload().make(str(d), genome_mb=0.3,
                                           n_reads=12, mean_len=2500,
                                           seed=3)
    spliced = load_chip_smoke().make_spliced_reads(
        ref, str(d / "tx.fa"), 12, seed=12, exons=(3, 5),
        intron_len=(100, 1000))
    return {"ref": ref, "reads": reads, "spliced": spliced}


def run(args, out):
    """(output text, counters, launch and plain-version counts)."""
    mods = (chain_v3, ksw2_extd2)
    before = [(m.launches, m.reference_calls) for m in mods]
    assert tcli.main([*args, "--device", "cpu", "-o", str(out)]) == 0
    counts = [(m.launches - a, m.reference_calls - b)
              for m, (a, b) in zip(mods, before)]
    counters = dict(profiling.counters)
    profiling.disable()
    return out.read_text(), counters, counts


def trace_events(d):
    files = glob.glob(str(d / "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as fh:
        return json.load(fh)["traceEvents"]


@pytest.mark.parametrize("mode", list(MODES))
def test_trace_keeps_output_and_holds_every_thread(workload, tmp_path,
                                                   mode):
    argv, reads, stages, threaded = MODES[mode]
    inputs = [workload["ref"], workload[reads]]
    plain = run([*argv, "--profile", *inputs], tmp_path / "plain.out")
    trace_dir = tmp_path / "trace"
    traced = run([*argv, "--profile-trace", str(trace_dir), *inputs],
                 tmp_path / "traced.out")
    strip = (lambda s: "".join(ln for ln in s.splitlines(True)
                               if not ln.startswith("@PG")))
    assert strip(traced[0]) == strip(plain[0])
    assert traced[1] == plain[1]
    assert traced[2] == plain[2]
    if mode == "batch-sam":   # the plain K1 did the work, the host's fills
        assert traced[2][0][1] > 0 and traced[1]["ext.host_fills"] > 0
    ranges = [e for e in trace_events(trace_dir)
              if e.get("cat") == "user_annotation"]
    names = {e["name"] for e in ranges}
    assert stages <= names, sorted(stages - names)
    main_tid = {e["tid"] for e in ranges if e["name"] == "emit"}
    assert len(main_tid) == 1
    other = {e["tid"] for e in ranges} - main_tid
    assert bool(other) == threaded, (mode, sorted(other))
    if threaded:   # the mapping threads' own stages
        assert {e["name"] for e in ranges if e["tid"] in other} >= \
            ({"post", "align"} if mode == "batch-sam" else
             {"seed", "chain", "post"})


def test_profile_alone_writes_no_file(workload, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "out.paf"
    run(["--profile", "-t", "2", workload["ref"], workload["reads"]], out)
    assert [p.name for p in tmp_path.iterdir()] == ["out.paf"]
    assert profiling._trace_dir is None


def test_host_stages_are_leaves_and_cover_map_batch(workload, tmp_path,
                                                    monkeypatch):
    """The spliced batch PAF loop, traced, with `map_batch` inside a
    range of the test's own: every range of a new host stage encloses no
    other range of its thread; every `seed.sketch` and every `seed.hits`
    but those of the re-seeded reads lies in a `seed`; the union of the
    ranges covers at least 95% of `map_batch`'s wall."""
    real = tcli.map_batch

    def map_batch(*a, **kw):
        with torch.profiler.record_function("test.map_batch"):
            return real(*a, **kw)

    monkeypatch.setattr(tcli, "map_batch", map_batch)
    trace_dir = tmp_path / "trace"
    argv, reads, _, _ = MODES["batch-splice-paf"]
    _, counters, _ = run([*argv, "--profile-trace", str(trace_dir),
                          workload["ref"], workload[reads]],
                         tmp_path / "out.paf")
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"], e["tid"])
              for e in trace_events(trace_dir)
              if e.get("cat") == "user_annotation"]
    (w0, w1, _, _), = [r for r in ranges if r[2] == "test.map_batch"]
    ranges = [r for r in ranges if r[2] != "test.map_batch"]
    for a, b, name, tid in ranges:
        if name in HOST_STAGES:
            inner = [r for r in ranges if r[3] == tid and a <= r[0] < b and
                     r[1] <= b and r[:2] != (a, b)]
            assert not inner, (name, inner[:3])
    seeds = [(a, b, tid) for a, b, name, tid in ranges if name == "seed"]

    def in_seed(r):
        return any(t == r[3] and a <= r[0] and r[1] <= b
                   for a, b, t in seeds)

    sketches = [r for r in ranges if r[2] == "seed.sketch"]
    hits = [r for r in ranges if r[2] == "seed.hits"]
    assert sketches and all(in_seed(r) for r in sketches)
    assert len([r for r in hits if not in_seed(r)]) == \
        counters.get("chain.rechained", 0)
    covered, end = 0.0, w0
    for a, b in sorted((max(a, w0), min(b, w1)) for a, b, _, _ in ranges
                       if b > w0 and a < w1):
        covered += max(0.0, b - max(a, end))
        end = max(end, b)
    assert covered >= 0.95 * (w1 - w0), covered / (w1 - w0)


def test_fallbacks_are_counted_and_keep_the_output(workload, tmp_path,
                                                   monkeypatch):
    """The native runtime made unavailable: the spliced batch PAF is the
    native run's byte for byte, and each Python twin on the path counts
    its runs; with the runtime there, none does."""
    argv, reads, _, _ = MODES["batch-splice-paf"]
    args = [*argv, "--profile", workload["ref"], workload[reads]]
    native, counters, _ = run(args, tmp_path / "native.paf")
    assert not [k for k in counters if k.startswith("fallback.")]
    for name in ("available", "has_seed_hits", "has_set_parent",
                 "has_backtrack", "has_est_err"):
        monkeypatch.setattr(native_lib, name, lambda: False)
    monkeypatch.setattr(esterr, "_NATIVE", None)   # its cached look-up
    python, counters, _ = run(args, tmp_path / "python.paf")
    assert python == native
    assert {k: counters.get(k, 0) > 0 for k in FALLBACKS} == \
        dict.fromkeys(FALLBACKS, True)


def test_disabled_stage_is_the_shared_no_op():
    profiling.disable()
    profiling.reset()
    assert profiling.stage("seed") is profiling.NO_STAGE
    assert profiling.stage("post.finish") is profiling.NO_STAGE
    with profiling.stage("seed"):
        pass
    assert profiling.timed("seed.native", max, 2, 3) == 3
    assert "seed.native" not in profiling.snapshot()

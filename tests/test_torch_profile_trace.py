"""`--profile-trace DIR` (`utils/profiling.py::trace_if_enabled`, a
torch.profiler trace around each of `cli.map_all`'s mapping loops) on
the CPU.

In each loop (batch SAM with `--align-backend gpu`, whose align
threads post each read's fills to the extension batcher, all under its
cell threshold here, so on the host; stream on one thread; stream on a
pool of two): the traced run's output, its
`--profile` counters and its launch counts equal the untraced run's; DIR
holds one `*.pt.trace.json` whose ranges carry the `--profile` stage
names, from the main thread and, where the loop maps on other threads,
from those threads too (which a trace of the main thread alone would
miss). The index is built outside the trace, which wraps the mapping
loop, as in the JAX package. `--profile` alone writes no file."""
import glob
import json

import pytest

from mm2tpu_torch import cli as tcli
from mm2tpu_torch.ops import chain_v3, ksw2_extd2
from mm2tpu_torch.utils import profiling
from test_torch_pipeline import load_make_workload

MODES = {
    # batch, SAM on the align threads (the plain extd2 records a few
    # hundred thousand CPU ops a fill, so the fills stay under the cell
    # threshold)
    "batch-sam": (["--map-mode", "batch", "-a", "--align-backend", "gpu"],
                  "reads", {"seed", "chain.device", "chain.backtrack",
                            "post", "align", "emit"}, True),
    "stream-t1": (["--map-mode", "stream", "-t", "1"], "reads",
                  {"seed", "route", "chain", "post", "emit"},
                  False),
    "stream-t2": (["--map-mode", "stream", "-t", "2"], "reads",
                  {"seed", "route", "chain", "post", "emit"},
                  True),
}


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    ref, reads = load_make_workload().make(str(d), genome_mb=0.3,
                                           n_reads=12, mean_len=2500,
                                           seed=3)
    return {"ref": ref, "reads": reads}


def run(args, out):
    """(output text, counters, launch and plain-version counts)."""
    mods = (chain_v3, ksw2_extd2)
    before = [(m.launches, m.reference_calls) for m in mods]
    assert tcli.main([*args, "-x", "map-ont", "--device", "cpu", "-o",
                      str(out)]) == 0
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

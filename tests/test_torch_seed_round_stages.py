"""The device seeding round's host glue and counters
(`mapping/pipeline.py::_seed_device_round`), on the CPU with
`--seed-backend gpu --device cpu` (the plain versions of K5, K6 and K1):

- its three leaf stages: `seed.split` and `seed.meta` once a round,
  `seed.pack` once a dispatch, each a range of its own in a trace that
  encloses no other;
- `seed.device_reads` (the reads the round seeds) and `seed.host_frags`
  (those left to the host) add up to `seed.reads`;
- with `DEVICE_ANCHOR_CAP` set low, the reads past it are counted in
  `seed.capped`, seeded on the host, and the PAF is byte-identical to the
  host-seeded run's;
- `prepare_index_device` uploads the index's own uint64 arrays as int64
  views: the device index equals one made from int64 copies, from a
  built index and from its MMX file; `device_index` refuses positions
  that K6's int32 offsets cannot reach.
"""
import glob
import json

import numpy as np
import pytest
import torch

from mm2tpu_torch.cli import main as port_main
from mm2tpu_torch.index.build import build_index, load_index, save_index
from mm2tpu_torch.mapping import pipeline
from mm2tpu_torch.ops import seed_device as sd
from mm2tpu_torch.utils import profiling
from test_torch_pipeline import load_make_workload

ROUND_STAGES = ("seed.split", "seed.meta", "seed.pack")


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """A 0.3 Mb workload of 12 reads of 8 kb mean at 2% errors (seed 3,
    some reads over 1024 anchors), in two mini-batches (`-K`), so that
    two rounds run."""
    d = tmp_path_factory.mktemp("seed_round")
    ref, reads = load_make_workload().make(str(d), genome_mb=0.3,
                                           n_reads=12, mean_len=8000,
                                           err=0.02, seed=3)
    return {"ref": ref, "reads": reads, "dir": d}


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """4 reads of 2 kb mean on a 0.1 Mb genome, for the traced run."""
    d = tmp_path_factory.mktemp("seed_round_small")
    ref, reads = load_make_workload().make(str(d), genome_mb=0.1,
                                           n_reads=4, mean_len=2000,
                                           seed=5)
    return {"ref": ref, "reads": reads, "dir": d}


def run(workload, seed_gpu, *extra, **kw):
    """(PAF, stages, counters) of a batch run with --profile."""
    out = workload["dir"] / ("gpu.paf" if seed_gpu else "host.paf")
    args = ["-x", "map-ont", "--map-mode", "batch", "--device", "cpu",
            "-K", "50k", "--profile", *extra]
    if seed_gpu:
        args += ["--seed-backend", "gpu"]
    rc = port_main([*args, "-o", str(out), workload["ref"],
                    workload["reads"]], **kw)
    stages, counters = profiling.snapshot(), dict(profiling.counters)
    profiling.disable()
    assert rc == 0
    return out.read_text(), stages, counters


def counting_seed_fn(calls):
    def seed_fn(*a, **kw):
        calls.append(1)
        return sd.seed_chain(*a, **kw)
    return seed_fn


@pytest.fixture(scope="module")
def host_run(workload):
    return run(workload, False)


def test_round_stages_once_a_round_and_a_dispatch(workload):
    calls = []
    _, stages, counters = run(workload, True,
                              seed_fn=counting_seed_fn(calls))
    rounds = stages["seed.device_probe"][1]
    assert rounds == 2                      # one round a mini-batch
    assert stages["seed.split"][1] == rounds
    assert stages["seed.meta"][1] == rounds
    assert len(calls) > 0 and stages["seed.pack"][1] == len(calls)
    assert counters["seed.capped"] == 0


def test_device_and_host_reads_add_up(workload, host_run):
    paf, _, counters = run(workload, True)
    assert counters["seed.reads"] == 12
    assert counters["seed.device_reads"] > 0
    assert counters["seed.device_reads"] + \
        counters.get("seed.host_frags", 0) == counters["seed.reads"]
    assert paf == host_run[0]


@pytest.mark.parametrize("cap", [1024, 2048])
def test_reads_past_the_cap_seed_on_the_host(workload, host_run,
                                             monkeypatch, cap):
    monkeypatch.setattr(pipeline, "DEVICE_ANCHOR_CAP", cap)
    paf, _, counters = run(workload, True)
    assert 0 < counters["seed.capped"] < counters["seed.reads"]
    assert counters["seed.host_frags"] == counters["seed.capped"]
    assert counters["seed.device_reads"] + counters["seed.capped"] == \
        counters["seed.reads"]
    assert paf == host_run[0]


def test_round_stages_are_leaf_ranges_in_a_trace(small, tmp_path):
    trace_dir = tmp_path / "trace"
    run(small, True, "--profile-trace", str(trace_dir))
    files = glob.glob(str(trace_dir / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as fh:
        ranges = [e for e in json.load(fh)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    mine = [e for e in ranges if e["name"] in ROUND_STAGES]
    assert {e["name"] for e in mine} == set(ROUND_STAGES)
    for e in mine:
        a, b = e["ts"], e["ts"] + e["dur"]
        inner = [o for o in ranges if o is not e and
                 o.get("tid") == e.get("tid") and
                 a <= o["ts"] and o["ts"] + o["dur"] <= b]
        assert inner == [], (e["name"], [o["name"] for o in inner])


def _genome(seed=11, n=120_000):
    rng = np.random.default_rng(seed)
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


@pytest.mark.parametrize("from_mmx", [False, True])
def test_device_index_from_views_equals_copies(tmp_path, from_mmx):
    mi = build_index(["a", "b"], [_genome(11), _genome(12, 50_000)], w=10,
                     k=15)
    if from_mmx:
        save_index(mi, str(tmp_path / "i.mmx"))
        mi = load_index(str(tmp_path / "i.mmx"))
        assert not mi.pos.flags.writeable
    assert mi.keys.dtype == np.uint64 and mi.pos.dtype == np.uint64
    assert np.shares_memory(sd._as_int64(mi.pos), mi.pos)
    assert np.shares_memory(sd._as_int64(mi.keys), mi.keys)
    got = sd.prepare_index_device(mi, "cpu")
    want = sd.device_index(mi.keys.astype(np.int64), mi.start, mi.cnt,
                           "cpu", pos=mi.pos.astype(np.int64))
    for k in ("keys", "start", "cnt", "pos"):
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    for k in ("rid_bits", "pos_bits"):
        assert got[k] == want[k]
    for k in ("lut", "sc"):
        assert torch.equal(getattr(got["table"], k),
                           getattr(want["table"], k))
    assert got["table"][3:] == want["table"][3:]
    q = torch.as_tensor(sd.split_query_minimizers(
        np.stack([mi.keys[:50] << np.uint64(8),
                  np.zeros(50, np.uint64)], 1))[0])
    for a, b in zip(sd.probe_index(got, q), sd.probe_index(want, q)):
        assert torch.equal(a, b)


def test_device_index_refuses_positions_past_int32():
    pos = np.lib.stride_tricks.as_strided(np.zeros(1, np.int64),
                                          shape=(1 << 31,), strides=(0,))
    keys = np.zeros(1, np.int64)
    one = np.ones(1, np.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        sd.device_index(keys, one * 0, one, "cpu", pos=pos)


def test_as_int64_copies_only_other_dtypes():
    a = np.arange(5, dtype=np.int64)
    assert sd._as_int64(a) is a
    b = np.arange(5, dtype=np.int32)
    c = sd._as_int64(b)
    assert c.dtype == np.int64 and not np.shares_memory(b, c)

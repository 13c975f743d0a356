"""The `map_ont_wg` configuration (map-ont against a whole human-scale
genome, the index on the card) and its cell `map_ont_wg.paf`: the
configuration's preset numbers are the program's map-ont options; the
cell runs correct on the CPU at a tiny size (`tiny_root` cuts every
configuration's genome), every compared number 0; the control and the
faults come out not correct; the device seeding round's two new
per-layer metrics read right, and None where there is nothing to read."""
import json
import os

import pytest

from gpubench import harness

from conftest import REPO

CELL = "map_ont_wg.paf"


def run(root, seed, **kw):
    return harness.run_cell(root, CELL, seed, 1.0, False, "cpu",
                            log=lambda s: None, **kw)


def test_config_is_the_map_ont_preset():
    cell, cfg, traffic, metrics = harness.cell_spec(REPO, CELL)
    assert cell["config"] == cfg["name"] == "map_ont_wg"
    assert cell["traffic"] == "ont_paf" and cell["chips"] == 1
    assert cfg["genome"]["length"] == 3_100_000_000
    assert cfg["genome"]["contigs"] == 195
    with open(os.path.join(REPO, "gpubench", "configs",
                           "map_ont.json")) as f:
        assert cfg["reference"] == json.load(f)["reference"]
    # raises where the parsed options differ from the stated numbers
    io, mo = harness._options(cfg["cli"] + traffic["cli"] +
                              ["--device", "cpu"], cfg)
    assert (io.k, io.w, mo.bw, mo.max_gap) == (15, 10, 500, 5000)
    assert mo.seed_backend == "gpu"
    assert {m["name"] for m in metrics["per_layer"]} == {
        "k1_roofline", "seed.card_ms_per_Mb", "seed.glue_s_per_Mb",
        "seed.device_share"}


def test_sound_run_is_correct(tiny_root):
    res = run(tiny_root, 2 ** 31 + 7)
    assert res["correct"] is True, res["compared"]
    assert all(v["value"] == 0 for v in res["compared"].values())
    assert res["metrics"]["query_Mb_per_s"]["value"] > 0


def test_control_is_not_correct(tiny_root):
    res = run(tiny_root, 13, control=True)
    assert res["correct"] is False
    assert res["compared"]["chain_diff"]["value"] > 0


@pytest.mark.parametrize("fault,number", [
    ("drop_half", "rec_missing"),     # half a batch left out
    ("alter_chain", "chain_diff"),    # K1 after device seeding
])
def test_fault_is_not_correct(tiny_root, fault, number):
    res = run(tiny_root, 14, faults={fault: True})
    assert res["correct"] is False
    assert res["compared"][number]["value"] > 0


def test_traced_run_reads_the_round(tiny_root):
    res = harness.run_cell(tiny_root, CELL, 15, 1.0, True, "cpu",
                           log=lambda s: None)
    assert res["correct"] is True
    m = res["metrics"]
    assert m["seed.glue_s_per_Mb"]["value"] > 0
    assert m["seed.device_share"]["value"] == 100.0   # no read over the cap


QUERY_MB = 4.0


def fake_run(stages, counters):
    run = harness._Run.__new__(harness._Run)
    run.stages, run.counters, run.query_Mb = stages, counters, QUERY_MB
    return run


@pytest.mark.parametrize("stages,want", [
    ({"seed.split": (0.2, 2), "seed.meta": (0.5, 2),
      "seed.pack": (0.3, 40), "seed": (1.0, 2)}, 1.0 / QUERY_MB),
    ({"seed.split": (0.2, 2)}, 0.2 / QUERY_MB),
    ({"seed": (1.0, 2), "seed.sketch": (0.4, 2)}, None),
    ({}, None),
])
def test_glue_reader(stages, want):
    read = harness.metric_reader(REPO, "seed.glue_s_per_Mb")
    got = read(fake_run(stages, {}))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("counters,want", [
    ({"seed.reads": 3600.0, "seed.device_reads": 3598.0}, 100.0 * 3598 /
     3600),
    ({"seed.reads": 3600.0, "seed.device_reads": 0.0}, 0.0),
    ({"seed.reads": 3600.0, "seed.batched": 3600.0}, None),
    ({"seed.device_reads": 10.0}, None),
    ({}, None),
])
def test_device_share_reader(counters, want):
    read = harness.metric_reader(REPO, "seed.device_share")
    got = read(fake_run({}, counters))
    assert got == (None if want is None else pytest.approx(want))

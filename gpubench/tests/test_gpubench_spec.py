"""BENCHMARK.json keeps to the benchmark's contract, and the harness
finds every configuration, traffic mix and per-layer metric by its name,
so that adding one takes new files and entries only."""
import json
import os
import re

import pytest

from gpubench import harness

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["gpubench"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + \
        [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["name"] for m in spec["end_to_end"]} == {
        "query_Mb_per_s", "setup_s"}
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_piece_is_a_file_of_its_own(spec):
    used = set()
    for c in spec["configs"]:
        assert c["file"] == "gpubench/configs/%s.json" % c["name"]
        assert os.path.exists(os.path.join(REPO, c["file"]))
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert w["chips"] == 1
        used.add(w["config"])
        cell, cfg, traffic, metrics = harness.cell_spec(REPO, w["name"])
        assert cfg["name"] == w["config"] and traffic["cli"]
        e2e = {m["name"] for m in metrics["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and metrics["per_layer"]
    assert used == {c["name"] for c in spec["configs"]}
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] == "query_Mb_per_s"
        assert set(m["workloads"]) <= cells
        assert callable(harness.metric_reader(REPO, m["name"]))


def test_shares_are_percent(spec):
    for m in spec["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_needs_only_new_files(tiny_root, tmp_path):
    """A configuration, a traffic mix and a per-layer metric added as new
    files and entries run without an edit to any file there was."""
    import shutil
    root = str(tmp_path)
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    g = os.path.join(root, "gpubench")
    with open(os.path.join(g, "configs", "map_ont.json")) as f:
        cfg = json.load(f)
    cfg.update(name="map_ont_w12")
    cfg["cli"] = cfg["cli"] + ["-w", "12"]
    cfg["reference"]["w"] = 12
    with open(os.path.join(g, "configs", "map_ont_w12.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(g, "traffic", "ont_paf.json")) as f:
        t = json.load(f)
    t["mean_len"] = 2000
    with open(os.path.join(g, "traffic", "ont_paf_2k.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(g, "metrics", "reads_per_s.py"), "w") as f:
        f.write("def read(run):\n"
                "    return run.counters.get('chain.launches', 0) + 1.0\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "map_ont_w12", "source": "test",
                         "file": "gpubench/configs/map_ont_w12.json",
                         "reduced": ["genome"], "why": "test"})
    b["workloads"].append({"name": "map_ont_w12.paf2k",
                           "config": "map_ont_w12",
                           "traffic": "ont_paf_2k", "chips": 1,
                           "why": "test"})
    b["per_layer"].append({"name": "reads_per_s", "unit": "1/s",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "query_Mb_per_s",
                           "workloads": ["map_ont_w12.paf2k"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    res = harness.run_cell(root, "map_ont_w12.paf2k", 5, 1.0, True, "cpu",
                           log=lambda s: None)
    assert res["correct"] is True
    assert res["metrics"]["reads_per_s"]["value"] >= 1.0

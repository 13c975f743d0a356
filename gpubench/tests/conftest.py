"""CPU tests of the benchmark. `tiny_root` is a temporary checkout of
the benchmark (BENCHMARK.json and gpubench/) whose configurations and
traffic are cut to a few megabases and a few reads a batch, so that the
program's plain versions run them on the CPU in seconds."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY_GENOME = {"length": 1500000, "contigs": 3}
TINY_TRAFFIC = {
    "ont_paf": {"reads_per_batch": 8, "mean_len": 3000, "max_len": 8000},
    "ont_sam": {"reads_per_batch": 4, "mean_len": 2000, "max_len": 4000,
                "cli_extra": ["--align-tpu-min-mat", "1"]},
    "cdna_sam": {"reads_per_batch": 8, "intron_median": 300,
                 "intron_max": 3000,
                 "cli_extra": ["--align-tpu-min-mat", "1"]},
    "cdna_paf": {"reads_per_batch": 16, "intron_median": 300,
                 "intron_max": 3000},
}


# cells the tests run whatever BENCHMARK.json holds: the held-out
# map_ont.paf, map_ont.sam and splice.sam, whose files the benchmark keeps
TEST_CELLS = [{"name": "map_ont.paf", "config": "map_ont",
               "traffic": "ont_paf", "chips": 1, "why": "tests"},
              {"name": "map_ont.sam", "config": "map_ont",
               "traffic": "ont_sam", "chips": 1, "why": "tests"},
              {"name": "splice.sam", "config": "splice",
               "traffic": "cdna_sam", "chips": 1, "why": "tests"}]


def make_tiny(dst: str) -> str:
    """A tiny copy of the benchmark at `dst`; returns it."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        b = json.load(f)
    have = {w["name"] for w in b["workloads"]}
    b["workloads"] += [c for c in TEST_CELLS if c["name"] not in have]
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    shutil.copytree(os.path.join(REPO, "gpubench"),
                    os.path.join(dst, "gpubench"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    g = os.path.join(dst, "gpubench")
    for c in os.listdir(os.path.join(g, "configs")):
        p = os.path.join(g, "configs", c)
        d = json.load(open(p))
        d["genome"].update(TINY_GENOME)
        json.dump(d, open(p, "w"))
    for t, ch in TINY_TRAFFIC.items():
        p = os.path.join(g, "traffic", t + ".json")
        d = json.load(open(p))
        ch = dict(ch)
        d["cli"] = d["cli"] + ch.pop("cli_extra", [])
        d.update(ch, pool_batches=2, check_reads=3, check_fills=2)
        json.dump(d, open(p, "w"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny")))

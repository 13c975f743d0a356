"""Whole runs on the CPU at a tiny size (the program's plain versions):
sound runs come out correct; the control, in the program's place, and
each fault a cell can have, planted under the timed path, come out not
correct. The harness's look for a card is skipped here (`run_cell`)."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gpubench import check, harness

from conftest import REPO


def run(root, cell, seed, **kw):
    return harness.run_cell(root, cell, seed, 1.0, False, "cpu",
                            log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", ["map_ont.paf", "splice.paf",
                                  "map_ont.sam"])
def test_sound_run_is_correct(tiny_root, cell):
    res = run(tiny_root, cell, 2 ** 31 + 5)
    assert res["correct"] is True, res["compared"]
    assert list(res)[-1] == "compared"
    assert res["metrics"]["query_Mb_per_s"]["value"] > 0
    e2e = harness.cell_spec(tiny_root, cell)[3]["end_to_end"]
    assert set(res["metrics"]) == {m["name"] for m in e2e}


@pytest.mark.parametrize("cell", ["map_ont.paf", "splice.paf"])
def test_control_is_not_correct(tiny_root, cell):
    res = run(tiny_root, cell, 11, control=True)
    assert res["correct"] is False
    assert res["compared"]["chain_diff"]["value"] > 0


@pytest.mark.parametrize("cell,fault,number", [
    ("map_ont.paf", "drop_half", "rec_missing"),     # half a batch left out
    ("map_ont.paf", "alter_chain", "chain_diff"),    # K1 after device seeding
    ("splice.paf", "alter_chain", "chain_diff"),     # K2 on host seeds
    ("map_ont.sam", "alter_ext", "ext_diff"),        # a fill's answer
    ("splice.paf", "shift_ts", "rec_diff"),          # records: post-chain
    ("map_ont.paf", "flip_strand", "rec_diff"),
    ("splice.sam", "shift_ts", "rec_bad"),
    ("map_ont.sam", "flip_strand", "rec_bad"),
])
def test_fault_is_not_correct(tiny_root, cell, fault, number):
    res = run(tiny_root, cell, 12, faults={fault: True})
    assert res["correct"] is False
    assert res["compared"][number]["value"] > 0


def test_fill_sample_takes_the_largest_under_the_cap():
    cells = [5, 200, 50, 10, 7, 0]
    for seed in range(20):
        pick = check.pick_fills(cells, 100, 3, np.random.default_rng(seed))
        assert pick[0] == 2 and len(pick) == 4 and 1 not in pick
        assert len(set(pick)) == 4
    assert check.pick_fills([200], 100, 3, np.random.default_rng(0)) == []


def test_no_jax_in_a_run(tiny_root):
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from gpubench import harness, run\n"
            "harness.run_cell(%r, 'map_ont.paf', 3, 0.5, False, 'cpu',"
            " log=lambda s: None)\n"
            "print(run.forbidden_modules())\n" % (REPO, tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(REPO, "gpubench",
                                                       "run.py"),
                          "--workload", "splice.paf", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         cwd=str(tmp_path), env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "needs 1 CUDA card(s)" in out.stderr, out.stderr[-2000:]


def test_run_without_the_program_prints_no_result(tmp_path):
    """Only BENCHMARK.json and gpubench/: past the look for a card (made
    to find one), the run fails on the program's import."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "gpubench"),
                    os.path.join(tmp_path, "gpubench"))
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "sys.argv = ['gpubench/run.py', '--workload', 'splice.paf',"
            " '--seed', '1', '--seconds', '1', '--trace', '0']\n"
            "runpy.run_path('gpubench/run.py', run_name='__main__')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "No module named 'mm2tpu_torch'" in out.stderr, \
        out.stderr[-2000:]


def test_forbidden_names_are_whole():
    from gpubench import run as r
    probe = "mm2tpu_torch_probe_x"
    sys.modules[probe] = type(sys)(probe)
    sys.modules["mm2tpu.probe_x"] = type(sys)("mm2tpu.probe_x")
    try:
        found = r.forbidden_modules()
        assert probe not in found and "mm2tpu_torch" not in found
        assert "mm2tpu" in found        # a whole top-level name
    finally:
        del sys.modules[probe], sys.modules["mm2tpu.probe_x"]

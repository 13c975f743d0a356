"""The port's entry points (`mm2tpu_torch/entry.py`) against
`__graft_entry__.py`: `entry()`'s example planes equal the JAX entry's
arrays, and its `fn` (K1 through `ops/chain_v3.py`, the plain version on
the CPU) gives the Pallas v3 kernel's f and p, run in interpret mode at
a reduced shape with one group a program (the kernel needs B % (8 * G)
== 0; G changes only the interleave). Integer DP: tolerance 0."""
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from mm2tpu.ops.chain_pallas_v3 import chain_scores_device_v3
from mm2tpu_torch import entry as port_entry
from test_torch_pipeline import REPO


def test_example_args_match_graft_entry():
    fn, args = port_entry.entry(device="cpu")
    want = graft._example_batch(B=32, N=4096)
    assert len(args) == len(want) == 7
    for got, w in zip(args, want):
        assert got.device.type == "cpu" and got.dtype == torch.from_numpy(
            w).dtype
        np.testing.assert_array_equal(got.numpy(), w)


def test_fn_matches_pallas_v3_interpret():
    fn, _ = port_entry.entry(device="cpu")
    planes = graft._example_batch(B=8, N=1024, seed=5)
    f, p = fn(*(torch.from_numpy(a) for a in planes))
    hi, lo, qi, span, _sid, n, avg = planes
    f_ref, p_ref = chain_scores_device_v3(
        hi, lo, qi, span, n, avg, interpret=True, groups_per_program=1,
        **port_entry.SETTINGS)
    np.testing.assert_array_equal(f.numpy(), np.asarray(f_ref))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_ref))
    assert int(f.max()) > 15        # rows chain beyond one anchor


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port_entry.entry(device="cuda")
    r = subprocess.run([sys.executable, "-m", "mm2tpu_torch.entry"],
                       cwd=str(REPO), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "entry OK" not in r.stdout
    assert "torch.cuda.is_available" in r.stderr

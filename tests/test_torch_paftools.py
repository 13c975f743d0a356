"""The port's paftools (`mm2tpu_torch/tools/`) against the JAX package's
(`mm2tpu/tools/`): every case of `tests/test_paftools.py` and
`tests/test_paftools_asm.py` runs with its module's `pt_main` replaced by
a call of both packages' `main` on the same argv and the same inputs,
which requires equal stdout, stderr and return code (or the same
exception) before the case's own checks see the JAX package's output.
Together the cases run all 21 subcommands."""
import inspect
import io
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

import test_paftools
import test_paftools_asm
from mm2tpu.tools import paftools as jax_pt
from mm2tpu.tools import paftools_asm as jax_asm
from mm2tpu_torch.tools import paftools as port_pt
from mm2tpu_torch.tools import paftools_asm as port_asm

CASES = [(mod, name) for mod in (test_paftools, test_paftools_asm)
         for name, fn in inspect.getmembers(mod, inspect.isfunction)
         if name.startswith("test_") and fn.__module__ == mod.__name__]


def _call(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            rc, exc = main(list(argv)), None
        except BaseException as e:   # compared, then re-raised below
            rc, exc = None, e
    return out.getvalue(), err.getvalue(), rc, exc


def _run_case(mod, name, tmp_path, golden_dir, monkeypatch, seen):
    def both(argv):
        want = _call(jax_pt.main, argv)
        got = _call(port_pt.main, argv)
        assert got[:3] == want[:3], argv
        assert (type(got[3]), str(got[3])) == (type(want[3]), str(want[3]))
        seen.append(list(argv))
        print(want[0], end="")
        print(want[1], end="", file=sys.stderr)
        if want[3] is not None:
            raise want[3]
        return want[2]

    monkeypatch.setattr(mod, "pt_main", both)
    fn = getattr(mod, name)
    fixtures = {"tmp_path": tmp_path, "golden_dir": golden_dir}
    fn(**{k: fixtures[k] for k in inspect.signature(fn).parameters})


@pytest.mark.parametrize("mod,name", CASES,
                         ids=["%s::%s" % (m.__name__, n) for m, n in CASES])
def test_port_paftools_matches_jax(mod, name, tmp_path, golden_dir,
                                   monkeypatch):
    seen = []
    _run_case(mod, name, tmp_path, golden_dir, monkeypatch, seen)
    assert seen, "the case ran no paftools command"


def test_cases_cover_every_subcommand(tmp_path, golden_dir, monkeypatch):
    """The two packages list the same subcommands, 21 with `version` (and
    the `liftOver` alias), and the cases above run each of them."""
    commands = set(port_pt.COMMANDS) | set(port_asm.COMMANDS) | {"version"}
    assert commands == set(jax_pt.COMMANDS) | set(jax_asm.COMMANDS) | {
        "version"}
    assert len(commands - {"liftOver"}) == 21
    seen = []
    for k, (mod, name) in enumerate(CASES):
        d = tmp_path / str(k)
        d.mkdir()
        _run_case(mod, name, d, golden_dir, monkeypatch, seen)
    ran = {a[0] for a in seen if a}
    assert commands - {"liftOver"} <= ran, sorted(commands - ran)

"""The port's CLI with no `--map-mode` against the JAX package's CLI with
none: both default to stream mode, so the same command line gives the
same bytes (SAM without the `@PG` line, which holds the port's extra
`--device cpu`). The port's run must also have chained in stream mode:
at the default route a `--device cpu` run places every task on the
host DP, where batch mode would have run the plain K1.

Inputs: the MT pair rebuilt from the goldens (`rebuild_mt`) and the
seeded 0.3 Mb workload (12 reads, seed 3); presets `-x map-ont` to PAF,
with `-c` and with `-a`. Both CLIs run in this process, the port with
`--device cpu`. Also: every default the two option parsers share is
equal."""
import functools

import pytest

from mm2tpu import cli as jcli
from mm2tpu_torch import cli as tcli
from mm2tpu_torch.ops import chain_v3
from test_torch_pipeline import load_make_workload
from test_torch_stream import no_pg, rebuild_mt


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("default_mode")
    ref, reads = load_make_workload().make(str(d), genome_mb=0.3,
                                           n_reads=12, mean_len=2500,
                                           seed=3)
    return {"mt": rebuild_mt(d), "workload": (ref, reads), "dir": d}


@functools.lru_cache(maxsize=None)
def _read(path):
    with open(path) as fh:
        return fh.read()


@pytest.mark.parametrize("extra", [(), ("-c",), ("-a",)],
                         ids=["paf", "c", "a"])
@pytest.mark.parametrize("which", ["mt", "workload"])
def test_default_mode_matches_jax(inputs, which, extra):
    ref, reads = inputs[which]
    d = inputs["dir"]
    tag = "%s%s" % (which, "".join(extra))
    args = ["-x", "map-ont", *extra]
    port_out, jax_out = d / (tag + ".port"), d / (tag + ".jax")
    calls = chain_v3.reference_calls
    assert tcli.main([*args, "--device", "cpu", "-o", str(port_out), ref,
                      reads]) == 0
    assert chain_v3.reference_calls == calls
    assert jcli.main([*args, "-o", str(jax_out), ref, reads]) == 0
    got, want = _read(str(port_out)), _read(str(jax_out))
    assert no_pg(got) == no_pg(want)
    assert any(not ln.startswith("@") for ln in got.splitlines())


def _defaults(parser):
    return {a.dest: a.default for a in parser._actions
            if a.dest != "help"}


def test_parsers_share_defaults():
    """Every option of `mm2tpu.cli.build_parser()` has the same default in
    the port's `build_torch_parser()` (the port only adds `--device`)."""
    port = _defaults(tcli.build_torch_parser())
    jax = _defaults(jcli.build_parser())
    assert set(port) - set(jax) == {"device"}
    assert {k: port[k] for k in jax} == jax
    assert port["map_mode"] == "stream"

"""Spliced reads through the port's splice extension with annotated
junctions: `mm2tpu_torch.cli -x splice -a --junc-bed BED --align-backend
gpu --align-tpu-min-mat 1 --device cpu` against `mm2tpu.cli -x splice -a
--junc-bed BED --map-mode batch`, byte for byte (SAM without @PG).

The BED holds the introns (N operations) of the JAX package's own SAM of
the same reads, so the junction bonus applies at real splice sites. The
inputs are those of tests/test_torch_cli_splice_gpu.py; the case lives
in a file of its own so that the two files run side by side."""
import re

import pytest

from test_torch_cli_sr_splice import strip_pg
from test_torch_cli_splice_gpu import (N_READS, check_counters, make_inputs,
                                       run_jax, run_port)


def junctions_bed(sam_text, path):
    """BED6 of every intron of the primary records: the reference span of
    each N operation, on the transcript's strand (ts:A, flipped for a
    reverse-strand read; + when the record has none)."""
    rows = set()
    for ln in sam_text.splitlines():
        if not ln or ln.startswith("@"):
            continue
        c = ln.split("\t")
        flag = int(c[1])
        if flag & 0x904:
            continue
        ts = next((f[5:] for f in c[11:] if f.startswith("ts:A:")), "+")
        strand = "+" if (ts == "+") != bool(flag & 16) else "-"
        pos = int(c[3]) - 1
        for n, op in re.findall(r"(\d+)([MIDNSHP=X])", c[5]):
            if op == "N":
                rows.add((c[2], pos, pos + int(n), strand))
            if op in "MDN=X":
                pos += int(n)
    path.write_text("".join("%s\t%d\t%d\tj%d\t0\t%s\n" % (ctg, st, en, k, s)
                            for k, (ctg, st, en, s) in
                            enumerate(sorted(rows))))
    return len(rows)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(tmp_path_factory.mktemp("splice_junc"))


def test_splice_gpu_extension_with_junc_bed_matches_jax(inputs, tmp_path):
    ref, reads = inputs
    plain = run_jax(["-a", ref, reads], tmp_path / "jax_nobed.sam")
    bed = tmp_path / "junc.bed"
    assert junctions_bed(plain, bed) >= N_READS
    got, counters, calls, launches = run_port(
        ["-a", "--junc-bed", str(bed), ref, reads], tmp_path / "port.sam")
    check_counters(counters, calls, launches)
    want = run_jax(["-a", "--junc-bed", str(bed), ref, reads],
                   tmp_path / "jax.sam")
    assert strip_pg(got) == strip_pg(want)
    assert sum("N" in ln.split("\t")[5] for ln in got.splitlines()
               if ln and not ln.startswith("@")) >= N_READS - 1

"""The port's mappy-compatible API (`mm2tpu_torch/mappy.py`, on
`device="cpu"`): the counterparts of tests/test_mappy.py on the MT pair
rebuilt from the repository's goldens (`test_torch_stream.rebuild_mt`),
held against minimap2's goldens (the `-c` PAF holds exactly the fields an
`Alignment` exposes), and field by field against `mm2tpu.mappy` on the
same reads and read pairs. `Aligner`'s device defaults to "cuda", which
raises without a card."""
import pytest
import torch

from mm2tpu import mappy as jmappy
from mm2tpu_torch import mappy
from mm2tpu_torch.ops import chain_v2, chain_v3
from test_torch_stream import GOLDEN, rebuild_mt


@pytest.fixture(scope="module")
def mt(tmp_path_factory):
    d = tmp_path_factory.mktemp("mappy")
    orang, human = rebuild_mt(d)
    return {"orang": orang, "human": human, "dir": d}


@pytest.fixture(scope="module")
def aligner(mt):
    return mappy.Aligner(mt["orang"], preset="map-ont", device="cpu")


def golden_rows(name):
    rows = []
    for line in (GOLDEN / name).read_text().splitlines():
        c = line.split("\t")
        tags = dict((t.split(":", 1)[0], t.split(":", 2)[2]) for t in c[12:])
        rows.append((c[0], int(c[1]), int(c[2]), int(c[3]), c[4], c[5],
                     int(c[6]), int(c[7]), int(c[8]), int(c[9]), int(c[10]),
                     int(c[11]), tags))
    return rows


def index_file(mt, kind):
    """MT_orang as a FASTA, as the port's MMX index, or as minimap2's own
    .mmi (tests/golden/mapont_MTorang.mmi)."""
    if kind == "fasta":
        return mt["orang"]
    if kind == "mmi":
        return str(GOLDEN / "mapont_MTorang.mmi")
    from mm2tpu_torch.index.build import build_index, save_index
    from mm2tpu_torch.io.bseq import read_fastx
    refs = list(read_fastx(mt["orang"]))
    mmx = str(mt["dir"] / "mt.mmx")
    save_index(build_index([r.name for r in refs], [r.seq for r in refs]),
               mmx)
    return mmx


@pytest.mark.parametrize("kind", ["fasta", "mmx", "mmi"])
def test_map_vs_golden_paf(mt, kind):
    """tests/test_mappy.py::test_map_vs_golden_paf, with the index read
    from a FASTA, from the port's MMX index (test_aligner_accepts_mmx) and
    from minimap2's .mmi."""
    a = mappy.Aligner(index_file(mt, kind), preset="map-ont", device="cpu")
    assert a and a.seq_names == ["MT_orang"]
    reads = {name: seq for name, seq, _ in mappy.fastx_read(mt["human"])}
    gold = golden_rows("mapont_MT_cs.paf")
    assert gold
    for (qn, qlen, qs, qe, strand, ctg, clen, rs, re, mlen, blen, mapq,
         tags) in gold:
        hits = list(a.map(reads[qn], cs=True))
        h = [x for x in hits if (x.q_st, x.r_st) == (qs, rs)][0]
        assert h.ctg == ctg and h.ctg_len == clen
        assert (h.q_en, h.r_en) == (qe, re)
        assert h.strand == (1 if strand == "+" else -1)
        assert (h.mlen, h.blen, h.mapq) == (mlen, blen, mapq)
        assert h.is_primary == (tags["tp"] == "P")
        assert h.cigar_str == tags["cg"]
        assert h.cs == tags["cs"]
        assert h.NM == int(tags["NM"])
        assert str(h).startswith(f"{qs}\t{qe}\t{strand}\t{ctg}")


def test_md(aligner, mt):
    reads = {n: s for n, s, _ in mappy.fastx_read(mt["human"])}
    md_gold = {}
    for line in (GOLDEN / "mapont_MT_md.sam").read_text().splitlines():
        if line.startswith("@"):
            continue
        c = line.split("\t")
        for t in c[11:]:
            if t.startswith("MD:Z:"):
                md_gold[(c[0], int(c[3]) - 1)] = t[5:]
    n = 0
    for h in aligner.map(reads["MT_human"], MD=True):
        if ("MT_human", h.r_st) in md_gold:
            assert h.MD == md_gold[("MT_human", h.r_st)]
            n += 1
    assert n >= 1


def test_seq_fetch(aligner, mt):
    ref = {n: s for n, s, _ in mappy.fastx_read(mt["orang"])}
    name = aligner.seq_names[0]
    assert aligner.seq(name) == ref[name].upper()
    assert aligner.seq(name, 100, 132) == ref[name].upper()[100:132]
    assert aligner.seq("nonexistent") is None
    assert aligner.k == 15 and aligner.w == 10 and aligner.n_seq == 1


def test_seq_index_and_revcomp(mt):
    ref = next(mappy.fastx_read(mt["orang"]))[1]
    a = mappy.Aligner(seq=ref, device="cpu")
    assert a and a.seq_names == ["N/A"]
    read = ref[3000:3500]
    hits = list(a.map(read))
    assert hits and hits[0].r_st == 3000 and hits[0].strand == 1
    rhits = list(a.map(mappy.revcomp(read)))
    assert rhits and rhits[0].r_st == 3000 and rhits[0].strand == -1
    assert mappy.revcomp("ACGTNacgtnRYKM") == "KMRYnacgtNACGT"


def test_empty_aligner():
    a = mappy.Aligner(device="cpu")
    assert not a
    assert list(a.map("ACGT") or []) == []
    assert not mappy.Aligner("/nonexistent/ref.fa", device="cpu")


def test_fastx_read_comment(tmp_path):
    p = tmp_path / "x.fq"
    p.write_text("@r1 some comment\nACGT\n+\nIIII\n")
    assert list(mappy.fastx_read(str(p), read_comment=True)) == \
        [("r1", "ACGT", "IIII", "some comment")]
    assert list(mappy.fastx_read(str(p))) == [("r1", "ACGT", "IIII")]
    assert mappy.verbose() == mappy.verbose(3) and mappy.verbose() == 3
    mappy.verbose(1)


def fields(h):
    return (h.ctg, h.ctg_len, h.r_st, h.r_en, h.strand, h.q_st, h.q_en,
            h.mapq, h.cigar, h.is_primary, h.mlen, h.blen, h.NM,
            h.trans_strand, h.read_num, h.cs, h.MD, str(h))


@pytest.fixture(scope="module")
def queries(mt):
    """30 reads cut from MT_human (2000-2240 bp, as tests/test_multihost.py
    cuts them), MT_human itself, and the 30 golden read pairs."""
    seq = next(mappy.fastx_read(mt["human"]))[1]
    singles = [seq] + [seq[(i * 379) % (len(seq) - 2300):][:2000 + (i % 7)
                                                            * 40]
                       for i in range(30)]
    r1 = [s for _, s, _ in mappy.fastx_read(str(GOLDEN / "sr_reads_1.fq"))]
    r2 = [s for _, s, _ in mappy.fastx_read(str(GOLDEN / "sr_reads_2.fq"))]
    return {"map-ont": [(s, None) for s in singles],
            "sr": list(zip(r1, r2))}


@pytest.mark.parametrize("preset,route,n", [
    ("map-ont", "auto", 31), ("sr", "auto", 30),
    ("map-ont", "gpu", 3), ("sr", "gpu", 4),
], ids=["map-ont", "sr-pairs", "map-ont-gpu-route", "sr-pairs-gpu-route"])
def test_hits_match_jax_mappy(mt, queries, preset, route, n):
    """Every hit's fields (cs and MD included) equal mm2tpu.mappy's, single
    reads and read pairs through seq2, at the default route and with
    every task on the device route (the port's plain K1/K2 against the
    JAX package's Pallas kernels in interpret mode)."""
    port = mappy.Aligner(mt["orang"], preset=preset, device="cpu")
    jax = jmappy.Aligner(mt["orang"], preset=preset)
    if route == "gpu":
        port.map_opt.chain_backend = "gpu"
        jax.map_opt.chain_backend = "tpu"
    calls = chain_v3.reference_calls + chain_v2.reference_calls
    n_hits = 0
    for seq, seq2 in queries[preset][:n]:
        got = [fields(h) for h in port.map(seq, seq2, cs=True, MD=True)]
        want = [fields(h) for h in jax.map(seq, seq2, cs=True, MD=True)]
        assert got == want
        n_hits += len(got)
    assert n_hits >= n
    used = chain_v3.reference_calls + chain_v2.reference_calls - calls
    assert (used >= n) == (route == "gpu")


def test_device_defaults_to_cuda(mt):
    """No device named: "cuda", which without a card raises at
    construction, before any index is read."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mappy.Aligner(mt["orang"], preset="map-ont")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mappy.Aligner(seq="ACGT" * 100, device="cuda")
    with pytest.raises(ValueError):
        mappy.Aligner(mt["orang"], device="auto")

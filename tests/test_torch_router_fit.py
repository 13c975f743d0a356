"""scripts/train_router_torch.py's fit, its check and its real tasks, and
the card-time spans of `mm2tpu_torch.ops` (`card_spans`, `launching`)
on the CPU."""
import importlib.util
import pathlib
import threading

import numpy as np
import pytest

from mm2tpu_torch import ops
from mm2tpu_torch.mapping import costmodel as tcm

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def trainer():
    spec = importlib.util.spec_from_file_location(
        "train_router_torch", REPO / "scripts" / "train_router_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRUE = tcm.CostModel(k1_dev=6e-4, k2_dev=2e-6, c_dev=0.55, k_host=1.2e-6,
                     c_host=0.08)


def _rows(seed, noise=0.1):
    """Rows from TRUE with a relative noise of `noise`, over task sizes
    from 64 to 32768 anchors."""
    rng = np.random.default_rng(seed)
    rows = []
    for n in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768):
        for per in (30.0, 250.0):
            sub, trip = 4.0 * n, per * n
            dev = TRUE.predict_dev(n, sub) * rng.uniform(1 - noise, 1 + noise)
            host = TRUE.predict_host(trip) * rng.uniform(1 - noise,
                                                         1 + noise)
            rows.append((n, sub, trip, dev, host))
    return rows


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_relative_fit_predicts_every_row(trainer, seed):
    """The relative fit predicts every row within 2x, small tasks
    included, and keeps the bounds; the unweighted fit of the same rows
    (`fit_cost_model`) of rows whose large tasks stray from the line
    lets them set c_host and misses the small tasks' host time by more
    than 2x."""
    rows = _rows(seed)
    m = trainer.fit_relative(rows, floor_dev_ms=0.5)
    assert max(trainer.misses(m, rows)) < 1.25
    assert m.c_dev >= 0.5 and min(m.k1_dev, m.k2_dev, m.k_host) >= 0
    assert m.c_host == pytest.approx(TRUE.c_host, rel=0.3)
    # the large sparse tasks 1.7x slower on the host than the line says
    skew = [r[:4] + (r[4] * (1.7 if r[0] >= 8192 and r[2] < 100 * r[0]
                             else 1.0),) for r in rows]
    assert max(trainer.misses(tcm.fit_cost_model(skew, 0.5), skew)) > 2
    assert max(trainer.misses(trainer.fit_relative(skew, 0.5), skew)) < 2


def test_misses_counts_both_ways(trainer):
    m = tcm.CostModel(0.0, 0.0, 1.0, 0.0, 2.0)
    assert trainer.misses(m, [(10, 1, 1, 0.25, 4.0), (10, 1, 1, 1.0, 2.0),
                              (10, 1, 1, 2.0, 2.0)]) == (4.0, 2.0)
    neg = tcm.CostModel(0.0, 0.0, 1.0, 0.0, -1.0)
    assert trainer.misses(neg, [(10, 1, 1, 1.0, 1.0),
                                (10, 1, 1, 1.0, 1.0)])[1] == np.inf


def test_regret_of_a_placement(trainer):
    """Placement regret: each row on the side the model predicts faster,
    over each row's faster side."""
    rows = [(100, 1, 10 ** 6, 1.0, 3.0), (100, 1, 1000, 1.0, 0.5)]
    assert trainer.regret(tcm.CostModel(0.0, 0.0, 0.1, 1.0, 0.0),
                          rows) == pytest.approx(2.0 / 1.5)  # all on the card
    assert trainer.regret(tcm.CostModel(0.0, 0.0, 1.0, 0.0, 0.0),
                          rows) == pytest.approx(3.5 / 1.5)  # all on the host
    assert trainer.regret(tcm.CostModel(0.0, 0.0, 1.0, 1e-5, 0.0),
                          rows) == 1.0  # by trips: each on its faster side


def test_real_tasks_are_what_chain_dp_gets(trainer, tmp_path, monkeypatch):
    """The trainer's real tasks are the anchors and chaining arguments
    that `map_frag` hands to `chain_dp` for each read."""
    from mm2tpu_torch.mapping import pipeline
    from mm2tpu_torch.cli import index_parts
    from mm2tpu_torch.io.bseq import read_fastx
    from mm2tpu_torch.options import check_opt, mapopt_update, set_opt

    ref, reads = trainer.make_workload(str(tmp_path), 1, 6)
    tasks = trainer.real_tasks(ref, reads, limit=4)
    assert len(tasks) == 4
    seen = []
    real = pipeline.chain_dp

    def spy(max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt, min_sc,
            gap_scale, is_cdna, n_segs, a, **kw):
        seen.append((a.copy(), dict(
            max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
            max_skip=max_skip, max_iter=max_iter, gap_scale=gap_scale,
            is_cdna=is_cdna, n_segs=n_segs)))
        return real(max_dist_x, max_dist_y, bw, max_skip, max_iter, min_cnt,
                    min_sc, gap_scale, is_cdna, n_segs, a, **kw)

    monkeypatch.setattr(pipeline, "chain_dp", spy)
    io, mo = set_opt(None)
    io, mo = set_opt("map-ont", io, mo)
    check_opt(io, mo)
    mi = next(index_parts(ref, io))
    mapopt_update(mo, mi)
    firsts = []
    for rec in list(read_fastx(reads))[:4]:
        seen.clear()
        pipeline.map_frag(mi, [rec.seq], mo, rec.name, device="cpu")
        firsts.append(seen[0])
    for (a, kw), (b, kw2) in zip(tasks, firsts):
        assert np.array_equal(a, b) and kw == kw2
        assert len(a) > 0


def test_card_spans_off_the_card():
    """Without `card_spans`, or with it off, `launching` only holds the
    launch lock and records nothing; the spans end with their block and
    are per thread."""
    with ops.card_spans(False) as spans:
        with ops.launching():
            assert ops.launch_lock.locked()
        assert spans is None
    assert not ops.launch_lock.locked()
    assert ops.span_seconds(None) == 0.0 and ops.span_seconds([]) == 0.0
    with ops.card_spans() as spans:
        assert spans == [] and ops._spans.open is spans
        other = []
        t = threading.Thread(
            target=lambda: other.append(getattr(ops._spans, "open", None)))
        t.start()
        t.join()
        assert other == [None]
    assert ops._spans.open is None

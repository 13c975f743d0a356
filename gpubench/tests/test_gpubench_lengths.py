"""Stratified lengths: every batch of every seed holds the same multiset
of drawn lengths; the seed changes only who gets which, and where."""
import json
import os

import numpy as np
import pytest

from gpubench.gen import genome as ggen
from gpubench.gen import reads as greads

TRAFFIC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "traffic")


def traffic(name, **kw):
    with open(os.path.join(TRAFFIC, name + ".json")) as f:
        return dict(json.load(f), **kw)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    g, _ = ggen.load_genome({"length": 2000000, "contigs": 3, "seed": 5,
                             "repeat_frac": 0.35, "repeat_div": 0.04},
                            str(tmp_path_factory.mktemp("g")))
    return g


@pytest.mark.parametrize("seeds", [(1, 2), (7, 2 ** 31 + 11)])
def test_ont_batches_hold_one_multiset(genome, seeds):
    t = traffic("ont_paf", reads_per_batch=40, pool_batches=2,
                max_len=20000)
    drawn = []
    for seed in seeds:
        for names, seqs in greads.make_pool(seed, genome, t):
            L = [int(n.rsplit("_", 1)[1]) for n in names]
            drawn.append(sorted(L))
            for n, s, l in zip(names, seqs, L):   # errors move it a little
                assert abs(len(s) - l) <= 0.1 * l + 20
    assert all(d == drawn[0] for d in drawn)
    assert drawn[0] == sorted(greads.ont_lengths(t).tolist())


@pytest.mark.parametrize("seeds", [(1, 2), (3, 2 ** 33)])
def test_spliced_batches_hold_one_multiset(seeds):
    t = traffic("cdna_paf", reads_per_batch=24)
    plans = [greads.spliced_plan(np.random.default_rng(s), t) for s in seeds]
    for key in (lambda p: sorted(len(e) for e, _ in p),
                lambda p: sorted(np.concatenate([e for e, _ in p])),
                lambda p: sorted(np.concatenate([i for _, i in p]))):
        assert key(plans[0]) == key(plans[1])
    assert [len(e) for e, _ in plans[0]] != [len(e) for e, _ in plans[1]]


@pytest.mark.parametrize("seeds", [(1, 2), (3, 2 ** 33)])
def test_fixed_plan_is_every_seeds(seeds):
    t = traffic("cdna_sam", reads_per_batch=24)
    assert t["plan"] == "fixed"
    plans = [greads.spliced_plan(np.random.default_rng(s), t) for s in seeds]
    for (e0, i0), (e1, i1) in zip(*plans):
        assert e0.tolist() == e1.tolist() and i0.tolist() == i1.tolist()
    seeded = greads.spliced_plan(np.random.default_rng(seeds[0]),
                                 dict(t, plan="seeded"))
    assert sorted(np.concatenate([i for _, i in seeded]).tolist()) == \
        sorted(np.concatenate([i for _, i in plans[0]]).tolist())


def test_spliced_reads_follow_their_plan(genome):
    t = traffic("cdna_sam", reads_per_batch=16, intron_max=20000)
    names, seqs = greads.spliced_batch(np.random.default_rng(4), genome, t, 0)
    plan = greads.spliced_plan(np.random.default_rng(4), t)
    assert [int(n.rsplit("_", 1)[1][:-1]) for n in names] == \
        [len(e) for e, _ in plan]
    for s, (e, _) in zip(seqs, plan):   # exons reach to their donor's GT
        assert 0.85 * e.sum() - 20 <= len(s)


def test_quantiles():
    q = greads.lognormal_quantiles(1000, 1500, 1.48, 60, 200000)
    assert np.median(q) == pytest.approx(1500, rel=0.01)
    assert 0.08 < (q > 10000).mean() < 0.12
    u = greads.uniform_quantiles(8, 80, 400)
    assert u.min() >= 80 and u.max() <= 400 and len(set(u)) == 8

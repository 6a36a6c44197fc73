"""The generators repeat exactly for a seed, and every seed does the same
work: only the order of the lengths and the sequences change."""

import json

import numpy as np
import pytest

from hmmbench_tiny import BENCH

from hb import workload

SEED = 2**31 + 12345  # past 32 signed bits, as a check's seeds can be


def _cell(config, traffic):
    cfg = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    tr = json.loads((BENCH / "traffic" / f"{traffic}.json").read_text())
    return cfg, dict(tr, sets=2)


@pytest.mark.parametrize("config, traffic", [("lambda-ctl", "train-full"),
                                             ("zymo-16s", "train-full-16s")])
def test_generators_repeat_for_a_seed(config, traffic):
    cfg, tr = _cell(config, traffic)
    a_refs = workload.references(cfg, SEED)
    b_refs = workload.references(cfg, SEED)
    assert [n for n, _ in a_refs] == [n for n, _ in b_refs]
    assert all(np.array_equal(x, y) for (_, x), (_, y) in zip(a_refs, b_refs))
    a = workload.read_sets(cfg, tr, a_refs, SEED)
    b = workload.read_sets(cfg, tr, b_refs, SEED)
    for sa, sb in zip(a, b):
        for (ta, qa), (tb, qb) in zip(sa, sb):
            assert np.array_equal(ta, tb) and np.array_equal(qa, qb)
    other = workload.read_sets(cfg, tr, workload.references(cfg, SEED + 1),
                               SEED + 1)
    assert any(not np.array_equal(x[0], y[0])
               for x, y in zip(a[0], other[0]))


def test_lambda_sizes_do_not_depend_on_the_seed():
    cfg, tr = _cell("lambda-ctl", "train-full")
    sizes = []
    for seed in (1, SEED):
        refs = workload.references(cfg, seed)
        assert [len(t) for _, t in refs] == [48502]
        sets = workload.read_sets(cfg, tr, refs, seed)
        assert all(len(s) == tr["reads_per_set"] for s in sets)
        sizes.append(sorted(len(q) for _, q in sets[0]))
    # whole DCS amplicons, their lengths changed by the simulated indels
    assert all(abs(n - 3560) < 100 for n in sizes[0] + sizes[1])


def test_panel_follows_the_mock_community():
    cfg, tr = _cell("zymo-16s", "train-full-16s")
    refs = workload.references(cfg, SEED)
    species = cfg["references"]["species"]
    assert len(refs) == sum(sp["copies"] for sp in species) == 49
    first = np.cumsum([0] + [sp["copies"] for sp in species])[:-1]
    for sp, k in zip(species, first):
        assert len(refs[k][1]) == sp["length"]
        assert int(np.sum(refs[k][1] != refs[k + 1][1])) == 3

    def apart(a, b):
        n = min(len(refs[first[a]][1]), len(refs[first[b]][1]))
        return float(np.mean(refs[first[a]][1][:n] != refs[first[b]][1][:n]))

    assert 0.02 < apart(1, 2) < 0.04  # E. coli, S. enterica
    assert 0.15 < apart(0, 7) < 0.30  # across the phyla
    # reads by the 16S composition: the same counts on every seed
    counts = workload.apportion([sp["share"] for sp in species], 32)
    assert counts == [1, 3, 3, 6, 3, 5, 5, 6]
    sets = workload.read_sets(cfg, tr, refs, SEED)
    assert all(len(s) == 32 for s in sets)
    assert all(1400 < len(t) < 1560 for t, _ in sets[0])

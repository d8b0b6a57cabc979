"""Every traffic generator repeats from its seed; the sweep's bases are
distinct and coprime to C; the semiclassical draws are float32 in [0, 1)."""

import math

import numpy as np
import pytest

from portbench import core
from portbench.testing import small


def runner(workload: str, seed: int):
    c = core.cell(workload)
    c["config"].update(small(workload)["config"])
    c["device"] = "cpu"
    return core.load_module("generators", c["generator"]).setup(c, seed)


@pytest.mark.parametrize("workload", ["shor8191-n28.gather", "shor8191-n28.benes", "shor8191-n28.gather-sweep"])
def test_full_register_draws_and_bases_repeat_from_seed(workload):
    big = 2**31 + 12345
    one, two, other = runner(workload, big), runner(workload, big), runner(workload, big + 1)
    first = [(one.base_of(i), one.draw(i)) for i in range(40)]
    assert first == [(two.base_of(i), two.draw(i)) for i in range(40)]
    assert [r for _, r in first] != [other.draw(i) for i in range(40)]
    assert all(0.0 <= r < 1.0 for _, r in first)
    assert one.warm_bases == two.warm_bases


def test_sweep_bases_distinct_coprime_and_outside_warm_up():
    sweep = core.load_module("generators", "base_sweep")
    C = 8191 * 3  # a modulus with non-units, so the walk has bases to skip
    got = [a for a, _ in zip(sweep.walk(C, sweep.FIRST, 1), range(2000))]
    assert got[:4] == [2, 4, 5, 7]
    assert len(set(got)) == len(got)
    assert all(math.gcd(a, C) == 1 and 2 <= a <= C - 2 for a in got)
    r = runner("shor8191-n28.gather-sweep", 99)
    window = {r.base_of(i) for i in range(6)}  # C = 21 has 10 bases: 2 warm, 8 before the walk wraps
    assert not window.intersection(r.warm_bases)
    assert [r.base_of(i) for i in range(3)] == [2, 4, 5]


def test_sweep_walk_wraps_within_range():
    sweep = core.load_module("generators", "base_sweep")
    got = [a for a, _ in zip(sweep.walk(21, 19, 1), range(12))]
    assert got[:4] == [19, 2, 4, 5] and all(2 <= a <= 19 for a in got)
    assert [a for a, _ in zip(sweep.walk(21, 19, -1), range(3))] == [19, 17, 16]


def test_semiclassical_draws_repeat_from_seed():
    one, two = runner("sc1060314373-m30.attempts", 5), runner("sc1060314373-m30.attempts", 5)
    other = runner("sc1060314373-m30.attempts", 6)
    for i in range(3):
        assert np.array_equal(one.draws(i), two.draws(i))
        assert one.draws(i).dtype == np.float32 and one.draws(i).shape == (one.L,)
        assert ((one.draws(i) >= 0) & (one.draws(i) < 1)).all()
    assert not np.array_equal(one.draws(0), other.draws(0))

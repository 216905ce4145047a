"""The serving cell's arrivals and request seeds are a pure function of
``--seed``, and the arrivals are a Poisson process at the mix's rate,
given its count."""
from __future__ import annotations

import numpy as np
import pytest

from _tiny import ROOT  # noqa: F401  (puts the checkout on the path)
from perfbench.harness.weights import sub_seeds
from perfbench.generators.serve import arrivals, request_seeds


def test_arrivals_are_a_function_of_the_seed():
    big = 2 ** 31 + 12345
    a = arrivals(28.0, 20.0, sub_seeds(big)["arrivals"])
    b = arrivals(28.0, 20.0, sub_seeds(big)["arrivals"])
    assert np.array_equal(a, b)
    assert not np.array_equal(a[:100], arrivals(28.0, 20.0, sub_seeds(big + 1)["arrivals"])[:100])
    assert request_seeds(5, big) == request_seeds(5, big)
    assert sub_seeds(big) == sub_seeds(big) and sub_seeds(big) != sub_seeds(big + 1)


@pytest.mark.parametrize("seed", (1, 2 ** 33 + 5))
def test_arrivals_are_poisson(seed):
    """Over a long window: the count rate x seconds whatever the seed, the
    gaps' mean 1/rate and their coefficient of variation 1 (an
    exponential's), every arrival inside the window and in order."""
    rate, seconds = 28.0, 2000.0
    a = arrivals(rate, seconds, seed)
    assert len(a) == rate * seconds
    assert len(arrivals(rate, 20.0, seed + 1)) == 560
    gaps = np.diff(a)
    assert abs(gaps.mean() * rate - 1) < 0.02
    assert abs(gaps.std() / gaps.mean() - 1) < 0.03
    assert 0.0 <= a.min() and a.max() < seconds and np.all(gaps >= 0)
    # clusters as a Poisson process has them: the busiest second of the
    # window well above the mean
    per_second = np.bincount(a.astype(int), minlength=int(seconds))
    assert per_second.max() >= rate + 3 * np.sqrt(rate)

"""The operation and byte counts of one ADMM iteration against a hand
count (counts.py)."""
import pytest

import counts


def test_lane_flops_hand_count():
    n, m, k = 2, 3, 1
    hand = (2 * m          # R z - y
            + 2 * m * n    # A'(.)
            + 3 * n        # sigma x - q + .
            + 2 * n * n    # M^-1 rhs
            + 2 * m * n    # A x~
            + 3 * n        # x+
            + 3 * m        # w
            + 4 * m        # prox: divide, add, clip (2)
            + 3 * m        # y+
            + (2 * m * n + 2 * n * n + 2 * m * n) / k)   # A x, P x, A'y
    assert hand == 112
    assert counts.lane_flops(n, m, k) == hand
    assert counts.lane_flops(n, m, 4) == 112 - 32 + 32 / 4


def test_words_hand_count():
    n, m = 2, 3
    # read x, z, y, l, u and write x, z, y
    assert counts.lane_words(n, m) == (n + 4 * m) + (n + 2 * m)
    assert counts.shared_words(n, m) == m * n + n * n


def test_least_time_takes_the_binding_bound():
    n, m = 450, 456
    t, bound = counts.least_time(1024 * 350, 350, 1, n, m, 4, 25,
                                 67e12, 3.35e12)
    flops = 1024 * 350 * counts.lane_flops(n, m, 25)
    assert bound == "compute"
    assert t == pytest.approx(flops / 67e12)
    t, bound = counts.least_time(1024 * 350, 350, 1, n, m, 4, 25,
                                 67e12, 1e9)
    assert bound == "memory"
    words = 1024 * 350 * counts.lane_words(n, m) + 350 * counts.shared_words(
        n, m)
    assert t == pytest.approx(4 * words / 1e9)

"""The KKT reference on problems whose answers are known by hand."""
import numpy as np
import pytest

import reference

INF = np.inf


def prob_of(P, q, A, m_box, m_l1=0, soc_dims=(), lam=()):
    return {"P": np.atleast_2d(P).astype(float), "q": np.asarray(q, float),
            "A": np.atleast_2d(A).astype(float), "m_box": m_box,
            "m_l1": m_l1, "soc_dims": tuple(soc_dims),
            "lam": np.asarray(lam, float)}


def ratio(prob, l, u, x, z, y):
    r = reference.kkt_ratio(prob, np.atleast_2d(l), np.atleast_2d(u),
                            np.atleast_2d(x), np.atleast_2d(z),
                            np.atleast_2d(y), 1e-6, 1e-6)
    return float(r["kkt_ratio"][0])


def test_box_upper_bound_active():
    # min 1/2 x^2 - x  s.t. 0 <= x <= 0.5: x = 0.5, multiplier 0.5 > 0.
    prob = prob_of([[1.0]], [-1.0], [[1.0]], 1)
    assert ratio(prob, [0.0], [0.5], [0.5], [0.5], [0.5]) == 0.0
    # The right stationarity with a multiplier of the wrong sign is not
    # an answer: -y is the multiplier of the lower bound, not active.
    assert ratio(prob, [0.0], [0.5], [0.5], [0.5], [-0.5]) > 1e5
    # Nor is a point off the optimum with a matching multiplier on an
    # inactive bound.
    assert ratio(prob, [0.0], [0.5], [0.4], [0.4], [0.6]) > 1e4


def test_soc_boundary_block():
    # x = (t, w): min t  s.t.  w = 1 (box row), (t, w) in SOC(2).
    # Optimum t = w = 1; z_soc on the cone's boundary, y_soc = (-1, 1)
    # in the polar cone, complementary to z_soc; the box multiplier -1.
    A = np.array([[0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    prob = prob_of(np.zeros((2, 2)), [1.0, 0.0], A, 1, soc_dims=(2,))
    l, u = [1.0, -INF, -INF], [1.0, INF, INF]
    x, z = [1.0, 1.0], [1.0, 1.0, 1.0]
    assert ratio(prob, l, u, x, z, [-1.0, -1.0, 1.0]) == pytest.approx(
        0.0, abs=1e-9)
    # A dual outside the polar cone with the same stationarity residual.
    assert ratio(prob, l, u, x, z, [-1.0, -1.0, 1.0 + 1e-3]) > 100.0
    # A primal point outside the cone.
    assert ratio(prob, l, u, [0.5, 1.0], [1.0, 0.5, 1.0],
                 [-1.0, -1.0, 1.0]) > 1e5


def test_l1_row():
    # min 1/2 (x - 2)^2 + |x|: x = 1, y = sign(x) = 1.
    prob = prob_of([[1.0]], [-2.0], [[1.0]], 0, m_l1=1, lam=[1.0])
    assert ratio(prob, [-INF], [INF], [1.0], [1.0], [1.0]) == 0.0
    assert ratio(prob, [-INF], [INF], [1.5], [1.5], [0.5]) > 1e5

"""Unit tests for prox operators X1-X4 (SURVEY.md §4.1)."""
import jax.numpy as jnp
import numpy as np
import pytest

from admm_library.ops import prox
from admm_library.problem import ConeSpec


def test_box_projection():
    v = jnp.array([-2.0, 0.5, 3.0, 10.0])
    l = jnp.array([-1.0, 0.0, -jnp.inf, 4.0])
    u = jnp.array([1.0, 1.0, 2.0, jnp.inf])
    out = prox.project_box(v, l, u)
    np.testing.assert_allclose(out, [-1.0, 0.5, 2.0, 10.0])


def test_soft_threshold_piecewise():
    v = jnp.array([-3.0, -0.5, 0.0, 0.5, 3.0])
    out = prox.soft_threshold(v, 1.0)
    np.testing.assert_allclose(out, [-2.0, 0.0, 0.0, 0.0, 2.0])


def test_soft_threshold_is_prox_of_l1():
    # prox_{t|.|}(v) minimises t|z| + 0.5(z-v)^2 — check by fine grid.
    v, t = 1.7, 0.6
    zgrid = np.linspace(-5, 5, 200001)
    obj = t * np.abs(zgrid) + 0.5 * (zgrid - v) ** 2
    zstar = zgrid[np.argmin(obj)]
    out = prox.soft_threshold(jnp.array(v), t)
    assert abs(float(out) - zstar) < 1e-4


@pytest.mark.parametrize("case", ["inside", "polar", "boundary_split"])
def test_soc_projection_branches(case):
    if case == "inside":
        t, u = 2.0, np.array([1.0, 1.0])  # ||u|| = 1.41 <= 2
        et, eu = t, u
    elif case == "polar":
        t, u = -2.0, np.array([1.0, 1.0])  # ||u|| <= -t
        et, eu = 0.0, np.zeros(2)
    else:
        t, u = 0.0, np.array([3.0, 4.0])  # split: c = 2.5
        et, eu = 2.5, np.array([1.5, 2.0])
    t2, u2 = prox.project_soc_block(jnp.asarray(t), jnp.asarray(u))
    np.testing.assert_allclose(t2, et, atol=1e-12)
    np.testing.assert_allclose(u2, eu, atol=1e-12)


def test_soc_projection_is_idempotent_and_in_cone():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((50, 4))
    t2, u2 = prox.project_soc_block(jnp.asarray(v[:, 0]), jnp.asarray(v[:, 1:]))
    assert np.all(np.linalg.norm(u2, axis=-1) <= np.asarray(t2) + 1e-10)
    t3, u3 = prox.project_soc_block(t2, u2)
    np.testing.assert_allclose(t3, t2, atol=1e-12)
    np.testing.assert_allclose(u3, u2, atol=1e-12)


def test_soc_projection_optimality():
    # Projection must beat random feasible points in distance.
    rng = np.random.default_rng(1)
    v = rng.standard_normal(5) * 3
    t2, u2 = prox.project_soc_block(jnp.asarray(v[0]), jnp.asarray(v[1:]))
    p = np.concatenate([[np.asarray(t2)], np.asarray(u2)])
    d_star = np.linalg.norm(p - v)
    for _ in range(200):
        w = rng.standard_normal(4)
        tt = np.linalg.norm(w) + abs(rng.standard_normal()) * 2
        cand = np.concatenate([[tt], w])
        assert np.linalg.norm(cand - v) >= d_star - 1e-9


def test_product_cone_layout():
    cone = ConeSpec(m_box=2, m_l1=2, soc_dims=(3, 3))
    v = jnp.arange(10.0) - 4.0
    # L1 rows honour their bounds (composite soft-threshold+clip prox);
    # +-inf bounds recover the plain soft-threshold.
    l = jnp.asarray([-0.5, -0.5, -jnp.inf, -jnp.inf] + [-0.5] * 6)
    u = jnp.asarray([0.5, 0.5, jnp.inf, jnp.inf] + [0.5] * 6)
    lam_rho = jnp.array([1.0, 1.0])
    out = prox.project_cone(v, l, u, lam_rho, cone)
    assert out.shape == (10,)
    np.testing.assert_allclose(out[:2], [-0.5, -0.5])       # box clip
    np.testing.assert_allclose(out[2:4], [-1.0, 0.0])       # soft-threshold
    # Bounded L1: clip(soft_threshold(v)).
    out_b = prox.soft_threshold_box(
        jnp.asarray([-2.0, 3.0]), 1.0, -0.5, 0.5)
    np.testing.assert_allclose(out_b, [-0.5, 0.5])
    # SOC blocks are valid cone members
    for off in (4, 7):
        blk = np.asarray(out[off:off + 3])
        assert np.linalg.norm(blk[1:]) <= blk[0] + 1e-10


def test_mixed_soc_dims():
    cone_dims = (3, 4)
    v = jnp.asarray(np.random.default_rng(2).standard_normal(7))
    out = prox.project_soc_rows(v, cone_dims)
    blk1 = np.asarray(out[:3])
    blk2 = np.asarray(out[3:])
    assert np.linalg.norm(blk1[1:]) <= blk1[0] + 1e-10
    assert np.linalg.norm(blk2[1:]) <= blk2[0] + 1e-10

"""Tangent-linearized SOC polish (round 4, core/polish.py docstring).

Covers the NON-DEGENERATE regime where the SQP step lands: strictly
convex P so the reduced Hessian on the tangent space is positive
definite. The degenerate min-fuel regime (cost linear in the cone t's)
is a documented limitation — there the acceptance test vetoes the
candidate and the solver keeps the unpolished point (exercised by the
config-4 path in tests/test_restart.py, not here).
"""
import jax.numpy as jnp
import numpy as np

from admm_library import Settings, Status, solve
from admm_library.core.polish import polish
from admm_library.problem import ConeSpec, QPData


def _loose_settings():
    # Plain single-path solve, no staged pipeline, coarse tolerance:
    # gives polish a genuinely unconverged starting point.
    return Settings(eps_abs=1e-2, eps_rel=0.0, max_iter=2000,
                    precision="double", polish=False, recenter_rounds=0,
                    restart_every=0, stall_checks=0)


def test_polish_soc_projection_analytic():
    """min 1/2||x-c||^2 s.t. x in SOC(3), c=(1,2,0) outside the cone.

    Analytic solution is the cone projection x* = (1.5, 1.5, 0); the
    dual under the solver's r_d convention Px + q + A'y = 0 is
    y = c - x* = (-0.5, 0.5, 0) (valid normal ray, y_t < 0). Active,
    single cone, strictly convex P: the tangent step must land at
    machine precision in one polish call.
    """
    n = 3
    c = jnp.array([1.0, 2.0, 0.0])
    qp = QPData(P=jnp.eye(n), q=-c, A=jnp.eye(n),
                l=jnp.full(n, -jnp.inf), u=jnp.full(n, jnp.inf),
                lam=jnp.zeros(0), cone=ConeSpec(soc_dims=(3,)))
    sol0 = solve(qp, _loose_settings())
    p = polish(qp, sol0, eps_abs=1e-6, eps_rel=0.0)
    assert int(p.status) == int(Status.SOLVED)
    assert float(p.r_prim) <= 1e-6
    assert float(p.r_dual) <= 1e-6
    np.testing.assert_allclose(
        np.asarray(p.x), [1.5, 1.5, 0.0], atol=1e-6)
    # Polish must strictly improve the coarse point.
    assert float(jnp.maximum(p.r_prim, p.r_dual)) < float(
        jnp.maximum(sol0.r_prim, sol0.r_dual))


def test_polish_soc_mixed_box_active_and_interior():
    """Box rows + two SOC blocks, one active and one interior, strictly
    convex random P: classification (bnd/tip/interior + dual-ray
    override) and the mixed reduced system must reach absolute 1e-6 residuals (the polish
    contract; the floor is O(delta*|y|) from the penalty formulation).
    """
    rng = np.random.default_rng(7)
    n, mb = 6, 4
    G = rng.normal(size=(n, n))
    P = jnp.asarray(G @ G.T + n * np.eye(n))
    q = jnp.asarray(rng.normal(size=n) * 5.0)
    Ab = jnp.asarray(rng.normal(size=(mb, n)))
    # Two SOC blocks on fixed row maps; generous t-row gain on block 2
    # so it ends up strictly interior.
    As1 = jnp.asarray(rng.normal(size=(3, n)))
    As2 = jnp.asarray(np.vstack([10.0 * np.abs(rng.normal(size=n)),
                                 0.1 * rng.normal(size=(2, n))]))
    A = jnp.concatenate([Ab, As1, As2], axis=0)
    m = mb + 6
    l = jnp.concatenate([jnp.full(mb, -1.0), jnp.full(6, -jnp.inf)])
    u = jnp.concatenate([jnp.full(mb, 1.0), jnp.full(6, jnp.inf)])
    qp = QPData(P=P, q=q, A=A, l=l, u=u, lam=jnp.zeros(0),
                cone=ConeSpec(m_box=mb, soc_dims=(3, 3)))
    sol0 = solve(qp, _loose_settings())
    p = polish(qp, sol0, eps_abs=1e-6, eps_rel=0.0)
    assert int(p.status) == int(Status.SOLVED)
    assert float(p.r_prim) <= 1e-6, float(p.r_prim)
    assert float(p.r_dual) <= 1e-6, float(p.r_dual)
    # Feasibility of the polished point wrt the cone blocks.
    Ax = np.asarray(A @ p.x)
    for s in (slice(mb, mb + 3), slice(mb + 3, mb + 6)):
        blk = Ax[s]
        assert blk[0] >= np.linalg.norm(blk[1:]) - 1e-8


def test_polish_soc_interior_is_unconstrained_minimum():
    """When the unconstrained minimum is strictly inside every cone,
    polish must classify all blocks interior and return it exactly."""
    n = 3
    # Minimum at x* = (2, 0.3, 0): strictly inside SOC(3).
    xstar = jnp.array([2.0, 0.3, 0.0])
    qp = QPData(P=jnp.eye(n), q=-xstar, A=jnp.eye(n),
                l=jnp.full(n, -jnp.inf), u=jnp.full(n, jnp.inf),
                lam=jnp.zeros(0), cone=ConeSpec(soc_dims=(3,)))
    sol0 = solve(qp, _loose_settings())
    p = polish(qp, sol0, eps_abs=1e-6, eps_rel=0.0)
    assert int(p.status) == int(Status.SOLVED)
    np.testing.assert_allclose(np.asarray(p.x), np.asarray(xstar),
                               atol=1e-8)
    np.testing.assert_allclose(np.asarray(p.y), 0.0, atol=1e-8)


def test_polish_soc_non_uniform_dims_fallback():
    """Non-uniform soc_dims must not crash polish (ADVICE r4: the
    uniform reshape raised on soc_dims=(3,4)) — the fallback never
    activates SOC rows, keeps the input dual there, and the acceptance
    test decides. Reachable via polish() on any heterogeneous-cone
    problem."""
    n = 7
    c = jnp.arange(1.0, 8.0)
    qp = QPData(P=jnp.eye(n), q=-c, A=jnp.eye(n),
                l=jnp.full(n, -jnp.inf), u=jnp.full(n, jnp.inf),
                lam=jnp.zeros(0), cone=ConeSpec(soc_dims=(3, 4)))
    sol0 = solve(qp, _loose_settings())
    p = polish(qp, sol0, eps_abs=1e-6, eps_rel=0.0)   # must not raise
    assert np.all(np.isfinite(np.asarray(p.x)))
    # Fallback keeps a point no worse than the input.
    assert float(jnp.maximum(p.r_prim, p.r_dual)) <= float(
        jnp.maximum(sol0.r_prim, sol0.r_dual)) + 1e-12

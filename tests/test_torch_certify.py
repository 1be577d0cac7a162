"""Parity of dpgo_tpu_torch.solvers.certify (the dual certificate and the
Riemannian staircase) with dpgo_tpu.solvers.certify, float64 on the CPU.

Both packages get the same graph from the numpy synthesizers; the JAX
package's random Lanczos start (jax.random.normal(PRNGKey(0))) is injected
into the port as v0. The float64 host pieces agree to 1e-12 relative,
Lanczos's alpha and beta to 1e-10, lambda_min to 1e-8; lambda_min is also
held against a dense eigendecomposition of S = Q - LambdaHat built
independently (tests/oracle.py's connection Laplacian)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu import quadratic as jq
from dpgo_tpu.measurements import EdgeArrays as JEdges
from dpgo_tpu.measurements import RelativeSEMeasurement as JMeas
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.solvers import certify as jc
from dpgo_tpu.solvers import rtr as jr
from dpgo_tpu.solvers.pgo import chordal_initialization, odometry_initialization
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.measurements import RelativeSEMeasurement as TMeas
from dpgo_tpu_torch.solvers import certify as tc

from tests import oracle


@functools.lru_cache(maxsize=None)
def setup(n_poses=125, r=5):
    """grid3d(n_poses): (measurements, n, JAX qd, port qd, lifted chordal X0,
    a tightly solved X)."""
    edges, n, _ = jd.synthesize_grid3d(n_poses, seed=0)
    meas = edges.to_measurements()
    d, dh = 3, 4
    jp = jq.from_private_measurements(JEdges.from_measurements(meas), n=n, d=d)
    jqd = jq.build_quadratic_data(jp, jnp.zeros((1, r, dh)), r=r,
                                  precond="auto")
    tp = tq.from_private_measurements(edges, n=n, d=d, device="cpu")
    tqd = tq.build_quadratic_data(
        tp, torch.zeros((1, r, dh), dtype=torch.float64), r=r, precond="auto")
    T = np.asarray(chordal_initialization(meas))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, r)),
                   T)
    X, _ = jr.rtr_solve(jqd, jnp.asarray(X0), gradnorm_tol=1e-10,
                        initial_radius=100.0, max_iterations=100,
                        max_inner=200)
    return meas, n, jqd, tqd, X0, np.asarray(X)


def jax_v0(m, seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (m,),
                                        jnp.float64))


def t64(x):
    return torch.as_tensor(np.array(x), dtype=torch.float64)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("point", ["init", "solved"])
def test_kkt_matvec_stationarity_match_jax(point):
    """kkt_multipliers, certificate_matvec (k = 3) and stationarity_gap at a
    non-critical and a critical point: 1e-12 relative."""
    _, n, jqd, tqd, X0, Xs = setup()
    X = X0 if point == "init" else Xs
    Lj = jc.kkt_multipliers(jqd, jnp.asarray(X))
    Lt = tc.kkt_multipliers(tqd, t64(X))
    assert rel(Lt, Lj) < 1e-12
    V = np.random.default_rng(0).standard_normal((n, 3, 4))
    assert rel(tc.certificate_matvec(tqd, Lt, t64(V)),
               jc.certificate_matvec(jqd, Lj, jnp.asarray(V))) < 1e-12
    # ||X S|| cancels at a critical point: its scale is ||X Q||
    sj = float(jc.stationarity_gap(jqd, jnp.asarray(X), Lj))
    st = float(tc.stationarity_gap(tqd, t64(X), Lt))
    scale = float(jnp.linalg.norm(jq.q_matvec(jqd, jnp.asarray(X))))
    assert abs(st - sj) <= 1e-12 * scale


def test_lanczos_matches_jax():
    """_lanczos on the same symmetric operator from the same start: alpha
    and beta within 1e-10."""
    _, n, jqd, tqd, _, Xs = setup()
    m = n * 4
    Lj = jc.kkt_multipliers(jqd, jnp.asarray(Xs))
    Lt = tc.kkt_multipliers(tqd, t64(Xs))
    v0 = jax_v0(m, 3)

    def mv_j(w):
        return jc.certificate_matvec(jqd, Lj, w.reshape(n, 1, 4)).reshape(m)

    def mv_t(w):
        return tc.certificate_matvec(tqd, Lt, w.reshape(n, 1, 4)).reshape(m)

    aj, bj, Vj = jax.jit(lambda v: jc._lanczos(mv_j, v, 40))(jnp.asarray(v0))
    at, bt, Vt = tc._lanczos(mv_t, t64(v0), 40)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=0,
                               atol=1e-10 * float(np.abs(aj).max()))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0,
                               atol=1e-10 * float(np.abs(bj).max()))
    assert rel(Vt, Vj) < 1e-8


def dense_S(meas, n, X):
    """S = Q - LambdaHat, dense and independent of either package's
    operators: Q from tests/oracle.py, Lambda_i = sym(Y_i^T (X Q)_i^rot)."""
    d = meas[0].d
    dh = d + 1
    Q = oracle.dense_connection_laplacian(meas, n)
    XQ = oracle.unflat(oracle.flat(X) @ Q, n, d)
    YtG = np.einsum("nra,nrb->nab", X[..., :d], XQ[..., :d])
    Lam = 0.5 * (YtG + np.swapaxes(YtG, -1, -2))
    S = Q.copy()
    for i in range(n):
        S[i * dh:i * dh + d, i * dh:i * dh + d] -= Lam[i]
    return 0.5 * (S + S.T)


def test_min_eig_matches_dense_oracle_and_jax():
    """At a non-critical point the estimate bounds the dense lambda_min
    from above and the rigorous bound from below; at a tightly solved
    critical point both pinch it within 1e-8 (full-rank Lanczos). Every
    number agrees with the JAX package's from the same start within
    1e-8."""
    meas, n, jqd, tqd, X0, Xs = setup(64)
    m = n * 4
    v0 = jax_v0(m)
    for X in (X0, Xs):
        lam = float(np.linalg.eigvalsh(dense_S(meas, n, X))[0])
        rt = tc.min_eig_certificate(tqd, t64(X), k=m, v0=v0)
        rj = jc.min_eig_certificate(jqd, jnp.asarray(X), k=m)
        assert rt.lambda_min_lower <= lam + 1e-8
        assert rt.lambda_min >= lam - 1e-8
        assert rt.certified == rj.certified
        for f in ("lambda_min", "lambda_min_lower", "stationarity"):
            assert abs(getattr(rt, f) - getattr(rj, f)) <= 1e-8, f
    assert rt.certified and rt.eig_residual < 1e-6
    assert abs(rt.lambda_min - lam) <= 1e-8
    assert rt.lambda_min_lower > lam - 1e-6


@pytest.mark.parametrize("point", ["init", "solved"])
def test_certify_solution_matches_jax(point):
    """certify_solution (precond 'auto', k = 64) from the measurements: the
    same verdict, lambda_min and its lower bound within 1e-8 (the
    refinement runs at the chordal point)."""
    meas, n, _, _, X0, Xs = setup()
    X = X0 if point == "init" else Xs
    rj = jc.certify_solution(meas, jnp.asarray(X))
    rt = tc.certify_solution([TMeas(**vars(m)) for m in meas], X,
                             v0=jax_v0(n * 4), device="cpu")
    assert rt.certified == rj.certified == (point == "solved")
    assert abs(rt.lambda_min - rj.lambda_min) <= 1e-8
    assert abs(rt.lambda_min_lower - rj.lambda_min_lower) <= 1e-8
    assert abs(rt.eig_residual - rj.eig_residual) <= 1e-8


def conflicted_ring(cls, n=12, lc_angle=np.pi):
    """tests/test_certify.py's SE(2) ring whose loop closure contradicts
    the odometry by lc_angle: at pi the r = d problem has a suboptimal
    critical point reachable from the odometry init."""
    theta = 2 * np.pi / n

    def rot(a):
        return np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])

    meas = [cls(r1=0, p1=i, r2=0, p2=i + 1, R=rot(theta),
                t=np.array([1.0, 0.0]), kappa=10.0, tau=10.0)
            for i in range(n - 1)]
    meas.append(cls(r1=0, p1=n - 1, r2=0, p2=0, R=rot(lc_angle),
                    t=np.array([1.0, 0.0]), kappa=10.0, tau=10.0))
    return meas


def test_staircase_escapes_like_jax():
    """solve_pgo_staircase from the odometry init of the conflicted ring:
    the r = 2 point is rejected, the staircase escapes and certifies at the
    same final r as the JAX package, with the same verdict at every rank
    and the cost within 1e-8 relative."""
    jmeas = conflicted_ring(JMeas)
    T0 = np.asarray(odometry_initialization(jmeas[:-1]))
    kw = dict(r0=2, r_max=8, gradnorm_tol=1e-9, eta=1e-6, T0=T0)
    rj = jc.solve_pgo_staircase(jmeas, **kw)
    rt = tc.solve_pgo_staircase(conflicted_ring(TMeas), device="cpu", **kw)
    assert not rt.history[0]["certified"]
    assert rt.history[0]["lambda_min"] < -1e-2
    assert rt.certified and rj.certified and rt.r == rj.r > 2
    assert [h["certified"] for h in rt.history] == \
        [h["certified"] for h in rj.history]
    assert abs(rt.cost - rj.cost) <= 1e-8 * abs(rj.cost)
    assert rt.cost < rt.history[0]["cost"] - 1.0

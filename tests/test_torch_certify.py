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


# ---------------------------------------------------------------------------
# solve_certified: the staircase on edge arrays, mixed precision where safe
# ---------------------------------------------------------------------------

from benchmark.harness import worlds  # noqa: E402
from benchmark.reference import certificate as ref_cert  # noqa: E402
from benchmark.reference import objective as ref_objective  # noqa: E402
from dpgo_tpu_torch import trace  # noqa: E402
from dpgo_tpu_torch.measurements import EdgeArrays as TEdges  # noqa: E402
from dpgo_tpu_torch.solvers.pgo import (  # noqa: E402
    odometry_initialization as t_odometry)


@functools.lru_cache(maxsize=None)
def grid216():
    """The benchmark's grid3d world at 216 poses (world seed 1), its edges
    and the port's certified solve of it with the default stages, from a
    fresh count: (benchmark edges, measurements, result, counts)."""
    e = worlds.synthesize_grid3d(216, seed=1)
    arrays = TEdges(**e._asdict())
    before = trace.COUNTS.copy()
    res = tc.solve_certified(arrays, 216, 3, csr_min_edges=0, device="cpu")
    counts = trace.COUNTS.copy()
    counts.subtract(before)
    return e, arrays.to_measurements(), res, counts


def deflated_min(S, X):
    """The smallest eigenvalue of S on the complement of X's rows and the
    gauge vector, dense."""
    n, r, dh = X.shape
    gauge = np.zeros((1, n, dh))
    gauge[..., -1] = 1.0
    M = np.concatenate([np.transpose(X, (1, 0, 2)), gauge]).reshape(r + 1, -1)
    _u, sv, Vt = np.linalg.svd(M)
    q = int((sv > 1e-6 * sv[0]).sum())
    Z = Vt[q:].T  # orthonormal complement
    return float(np.linalg.eigvalsh(Z.T @ S @ Z)[0])


def test_solve_certified_matches_dense_oracle_and_reference():
    """The default stages on a 216-pose grid: certified at r = 5 without an
    escape, the polish below 1e-6 by the benchmark's plain objective; the
    verdict is the dense S's, the lower bound below and the estimate within
    1e-8 of the dense lambda_min; the deflated Ritz value within its
    residual of the dense deflated lambda_min, which the reference's Lanczos
    bounds from above; and the plain reference of the certificate
    agrees."""
    e, meas, res, _ = grid216()
    X = res.X.numpy()
    c = res.certificate
    assert res.r == 5 and res.escapes == 0 and c.certified
    assert ref_objective.readings(e, res.X)["gradnorm"] <= 1e-6
    S = dense_S(meas, 216, X)
    lam = float(np.linalg.eigvalsh(S)[0])
    assert c.certified == (lam >= -1e-6)
    assert c.lambda_min_lower <= lam + 1e-10
    assert abs(c.lambda_min - lam) <= 1e-8
    lam_defl = deflated_min(S, X)
    assert abs(c.ritz - lam_defl) <= max(c.eig_residual, 1e-10)
    rd = ref_cert.readings(e, res.X, c.eigvec, c.ritz, c.eig_residual,
                           c.stationarity)
    assert rd["rho"] >= lam_defl - 1e-9
    assert abs(rd["stationarity"] - c.stationarity) <= 1e-12
    assert ref_cert.agrees(rd, 1e-6)


def test_solve_certified_escapes_like_the_staircase():
    """The conflicted ring from its odometry start at r = 2, through the
    default mixed stages: the r = 2 point is rejected, each escape is
    counted, and the final rank and verdict are solve_pgo_staircase's."""
    meas = conflicted_ring(TMeas)
    T0 = t_odometry(meas[:-1], device="cpu")
    st = tc.solve_pgo_staircase(meas, r0=2, r_max=8, gradnorm_tol=1e-9,
                                eta=1e-6, T0=T0, device="cpu")
    before = trace.COUNTS["certify.escapes"]
    res = tc.solve_certified(TEdges.from_measurements(meas), 12, 2, X0=T0,
                             r_max=8, device="cpu")
    first = res.stages[0]["certificate"]
    assert not first.certified and first.lambda_min < -1e-2
    assert trace.COUNTS["certify.escapes"] - before == res.escapes == \
        res.r - 2 > 0
    assert [s["r"] for s in res.stages] == list(range(2, res.r + 1))
    assert (res.r, res.certificate.certified) == (st.r, st.certified)


@pytest.mark.parametrize("spans", [False, True])
def test_solve_certified_counts_with_spans_on_and_off(spans):
    """The same counts with spans on and off (the spans read nothing), each
    counter the result's own figures; with spans on, the stages nest under
    certify.solve and the certificate's parts under certify.certificate."""
    _, _, ref_res, ref_counts = grid216()
    e = worlds.synthesize_grid3d(216, seed=1)
    trace.drain()
    if spans:
        trace.enable()
    try:
        before = trace.COUNTS.copy()
        res = tc.solve_certified(TEdges(**e._asdict()), 216, 3,
                                 csr_min_edges=0, device="cpu")
        counts = trace.COUNTS.copy()
        counts.subtract(before)
    finally:
        trace.disable()
    recs = trace.drain()
    c = res.certificate
    assert +counts == +ref_counts
    assert counts["certify.solves"] == 1 and counts["certify.calls"] == 1
    assert counts["certify.lanczos_steps"] == c.lanczos_steps == 64
    assert counts["certify.refine_iters"] == c.refine_iters > 0
    assert counts["certify.escapes"] == res.escapes == 0
    # one read a block of REFINE_BLOCK iterations (the iterations run and
    # the stop test that ends them), one for the Rayleigh quotient returned
    steps = c.refine_iters + (c.refine_iters < tc.CERTIFICATE["refine_iters"])
    assert counts["sync.certify.refine"] == -(-steps // tc.REFINE_BLOCK) + 1
    if not spans:
        assert recs == []
        return
    names = [r[0] for r in recs]
    assert names[0] == "certify.solve"
    parent = {name: names[p] if p >= 0 else None for name, p, _, _ in recs}
    for stage in ("plan", "chordal", "rtr", "polish", "certificate"):
        assert parent["certify." + stage] == "certify.solve"
    for part in ("lanczos", "refine", "bound"):
        assert parent["certify." + part] == "certify.certificate"


@pytest.mark.parametrize("spectrum", [
    (0.62, 3.0, 9.5), (0.62, 1e3, 1e4), (-2.0, -1.0, 5.0),
    (1.0, 1.0 + 1e-6, 4.0), (0.5, 7.0, 7.0 + 1e-9), (0.62, 0.62, 0.62)])
def test_min_eigvec3_matches_eigh(spectrum):
    """The refinement's closed-form 3 x 3 Rayleigh-Ritz step against
    torch.linalg.eigh on rotated diagonal matrices, well separated, widely
    spread, negative, with a near-double smallest or largest eigenvalue and
    a triple one: a unit vector whose Rayleigh quotient is the smallest
    eigenvalue to 1e-12 of the spread, and the eigenvector itself to 1e-8
    where the smallest eigenvalue is simple."""
    lam = torch.tensor(spectrum, dtype=torch.float64)
    rng = np.random.default_rng(7)
    for _ in range(20):
        Q = torch.as_tensor(np.linalg.qr(rng.standard_normal((3, 3)))[0])
        T = (Q * lam) @ Q.T
        T = 0.5 * (T + T.T)
        v = tc._min_eigvec3(T)
        scale = float(lam.abs().max())
        assert abs(float(v @ v) - 1.0) <= 1e-14
        assert abs(float(v @ T @ v) - float(lam[0])) <= 1e-12 * scale
        if lam[1] - lam[0] > 1e-3:
            e = torch.linalg.eigh(T)[1][:, 0]
            assert min(float((v - e).abs().max()),
                       float((v + e).abs().max())) <= 1e-8

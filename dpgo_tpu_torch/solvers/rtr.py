"""Riemannian trust-region solver with preconditioned truncated CG.

The counterpart of dpgo_tpu/solvers/rtr.py, which replaces ROPTLIB's
RTRNewton as driven by the reference's QuadraticOptimizer
(src/QuadraticOptimizer.cpp:50-108):
  * stop on the absolute Riemannian gradient norm,
  * outer-iteration cap (RTR_iterations), inner tCG cap (RTR_tCG_iterations),
  * initial radius RTR_initial_radius, max radius 5x initial,
  * the Max_Iteration==1 "shrink the trust region until a step is accepted"
    mode of every RBCD step (QuadraticOptimizer.cpp:80-98): at most 10
    shrinks by 1/4, else the initial iterate is returned.

The truncated CG is the Steihaug-Toint scheme with the trust region measured
in the preconditioner norm and the theta/kappa residual stop (theta=1,
kappa=0.1, the ROPTLIB defaults).

The loops are Python loops. The tCG loop reads its `done` flag on the host
once per iteration, and the outer loop reads the gradient norm once per
iteration: the same numbers as the JAX while-loops, at the price of one host
sync each. A tCG cap of at most `tcg_unroll` runs as masked steps with no
sync (the JAX package's unrolled form).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dpgo_tpu_torch import quadratic
from dpgo_tpu_torch.ops import lifted
from dpgo_tpu_torch.quadratic import QuadraticData
from dpgo_tpu_torch.types import ROptMethod, ROptParameters

_THETA = 1.0
_KAPPA = 0.1
_RHO_PRIME = 0.1
_MAX_SHRINKS = 10  # QuadraticOptimizer.cpp:90 ("total_steps > 10")


class TCGResult(NamedTuple):
    eta: torch.Tensor
    Heta: torch.Tensor
    hit_boundary: torch.Tensor  # bool: negative curvature or radius exceeded
    num_iters: torch.Tensor


class RTRState(NamedTuple):
    X: torch.Tensor
    fx: torch.Tensor
    grad: torch.Tensor  # Riemannian gradient
    gnorm: torch.Tensor
    S: torch.Tensor  # Weingarten correction sym(Y^T g_euc)
    eg: torch.Tensor  # Euclidean gradient at X
    radius: torch.Tensor
    it: int
    accepted: torch.Tensor  # whether the latest step was accepted
    tcg_iters: torch.Tensor


class RTRStats(NamedTuple):
    f_init: torch.Tensor
    gnorm_init: torch.Tensor
    f_opt: torch.Tensor
    gnorm_opt: torch.Tensor
    iterations: int
    accepted: torch.Tensor
    tcg_iters: torch.Tensor


def _tcg(
    qd: QuadraticData,
    X: torch.Tensor,
    S: torch.Tensor,
    grad: torch.Tensor,
    radius: torch.Tensor,
    max_inner: int,
    tcg_unroll: int = 4,
) -> TCGResult:
    """Preconditioned Steihaug-Toint truncated CG for
    min_eta <grad, eta> + 0.5 <eta, H eta>  s.t. ||eta||_P <= radius.

    max_inner <= tcg_unroll runs all max_inner steps masked by `done` (no
    host sync; a step past `done` is computed and discarded); larger caps
    loop until done with one host sync per iteration. Both give the same
    numbers."""
    dtype, dev = X.dtype, X.device
    zero = torch.zeros_like(grad)

    r0 = grad
    z0 = quadratic.apply_precond(qd, X, r0)
    r_r0 = lifted.inner(r0, r0)
    z_r0 = lifted.inner(z0, r0)
    norm_r0 = torch.sqrt(r_r0)
    # residual target: ||r|| <= ||r0|| * min(kappa, ||r0||^theta)
    r_target = norm_r0 * torch.clamp(norm_r0**_THETA, max=_KAPPA)
    rr = radius * radius

    def body(c):
        j, eta, Heta, r, z, delta, e_Pe, e_Pd, d_Pd, z_r, done, boundary = c
        Hd = quadratic.rie_hess_vec(qd, X, S, delta)
        d_Hd = lifted.inner(delta, Hd)
        alpha = z_r / d_Hd
        e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd

        # negative curvature or leaving the trust region -> go to the boundary
        hit = (d_Hd <= 0.0) | (e_Pe_new >= rr)
        disc = e_Pd * e_Pd + d_Pd * (rr - e_Pe)
        tau = (-e_Pd + torch.sqrt(torch.clamp(disc, min=0.0))) / d_Pd
        step = torch.where(hit, tau, alpha)

        eta_n = eta + step * delta
        Heta_n = Heta + step * Hd

        r_n = r + alpha * Hd
        resid_ok = torch.sqrt(lifted.inner(r_n, r_n)) <= r_target

        z_n = quadratic.apply_precond(qd, X, r_n)
        z_r_n = lifted.inner(z_n, r_n)
        beta = z_r_n / z_r
        delta_n = -z_n + beta * delta
        e_Pd_n = beta * (e_Pd + alpha * d_Pd)
        d_Pd_n = z_r_n + beta * beta * d_Pd

        return (
            j + 1,
            eta_n,
            Heta_n,
            torch.where(hit, r, r_n),
            torch.where(hit, z, z_n),
            torch.where(hit, delta, delta_n),
            torch.where(hit, e_Pe, e_Pe_new),
            torch.where(hit, e_Pd, e_Pd_n),
            torch.where(hit, d_Pd, d_Pd_n),
            torch.where(hit, z_r, z_r_n),
            hit | resid_ok,
            boundary | hit,
        )

    scalar0 = torch.zeros((), dtype=dtype, device=dev)
    false = torch.zeros((), dtype=torch.bool, device=dev)
    c = (
        torch.zeros((), dtype=torch.int64, device=dev), zero, zero, r0, z0,
        -z0, scalar0, scalar0, z_r0, z_r0, false, false,
    )
    if max_inner <= tcg_unroll:
        for _ in range(max_inner):
            done_prev = c[-2]
            c = tuple(
                torch.where(done_prev, o, n_) for o, n_ in zip(c, body(c))
            )
    else:
        for _ in range(max_inner):
            if bool(c[-2]):
                break
            c = body(c)
    j, eta, Heta, *_, _done, boundary = c
    return TCGResult(eta=eta, Heta=Heta, hit_boundary=boundary, num_iters=j)


def _rtr_iteration(
    qd: QuadraticData,
    state: RTRState,
    max_inner: int,
    max_radius: torch.Tensor,
    shrink_only: bool,
    qd_inner: Optional[QuadraticData] = None,
    exact_inner_hessian: bool = True,
    inner_control_matvecs: bool = False,
    residual_control: bool = False,
    tcg_unroll: int = 4,
) -> RTRState:
    """One outer RTR iteration: tCG, rho test, radius update.

    qd_inner: optionally a lower-precision copy of qd (mixed precision): the
    tCG runs in qd_inner's dtype while the trust-region control (cost,
    gradient, rho, retraction) stays in the outer dtype.

    exact_inner_hessian: with mixed precision, recompute H(eta) in outer
    precision for the model decrease.

    inner_control_matvecs: with mixed precision, take the cost decrease from
    the cancellation-free identity f(X') - f(X) = 0.5 <(X + X') Q, X' - X>
    + <X' - X, G> with the matvecs in inner precision."""
    if residual_control:
        raise NotImplementedError(
            "residual_control needs the residual form, not ported yet"
        )
    if qd_inner is not None:
        dt = qd_inner.diag.dtype
        tcg = _tcg(
            qd_inner, state.X.to(dt), state.S.to(dt), state.grad.to(dt),
            state.radius.to(dt), max_inner, tcg_unroll,
        )
        eta = lifted.proj_tangent(state.X, tcg.eta.to(state.X.dtype))
        if exact_inner_hessian:
            Heta = quadratic.rie_hess_vec(qd, state.X, state.S, eta)
        else:
            Heta = tcg.Heta.to(state.X.dtype)
        tcg = tcg._replace(eta=eta, Heta=Heta)
    else:
        tcg = _tcg(qd, state.X, state.S, state.grad, state.radius, max_inner,
                   tcg_unroll)
    X_new = lifted.retract(state.X, tcg.eta)
    if qd_inner is not None and inner_control_matvecs:
        dt = qd_inner.diag.dtype
        D = X_new - state.X
        qs = quadratic.q_matvec(qd_inner, (state.X + X_new).to(dt))
        qs = qs.to(state.X.dtype)
        f_new = state.fx + (0.5 * lifted.inner(qs, D) + lifted.inner(D, qd.G))
        qm_new = quadratic.q_matvec(qd_inner, X_new.to(dt)).to(state.X.dtype)
        eg = qm_new + qd.G
    else:
        # one matvec serves both the new cost and the new Euclidean gradient
        qm_new = quadratic.q_matvec(qd, X_new)
        f_new = 0.5 * lifted.inner(qm_new, X_new) + lifted.inner(X_new, qd.G)
        eg = qm_new + qd.G

    model_decrease = -(
        lifted.inner(state.grad, tcg.eta)
        + 0.5 * lifted.inner(tcg.eta, tcg.Heta)
    )
    # small regularization guards rho against cancellation near convergence
    eps = torch.finfo(state.fx.dtype).eps
    reg = 1e3 * eps * torch.clamp(torch.abs(state.fx), min=1.0)
    rho = (state.fx - f_new + reg) / (model_decrease + reg)

    accept = rho > _RHO_PRIME
    if shrink_only:
        # the caller controls the radius (shrinks by 4 on rejection)
        radius_new = state.radius
    else:
        radius_new = torch.where(
            rho < 0.25,
            0.25 * state.radius,
            torch.where(
                (rho > 0.75) & tcg.hit_boundary,
                torch.minimum(2.0 * state.radius, max_radius),
                state.radius,
            ),
        )

    # on rejection the previous gradient/correction are still valid
    grad_new = lifted.proj_tangent(X_new, eg)
    S_new = quadratic.hess_correction(X_new, eg)
    grad_next = torch.where(accept, grad_new, state.grad)
    return RTRState(
        X=torch.where(accept, X_new, state.X),
        fx=torch.where(accept, f_new, state.fx),
        grad=grad_next,
        gnorm=lifted.norm(grad_next),
        S=torch.where(accept, S_new, state.S),
        eg=torch.where(accept, eg, state.eg),
        radius=radius_new,
        it=state.it + 1,
        accepted=accept,
        tcg_iters=state.tcg_iters + tcg.num_iters,
    )


def _initial_state(
    qd: QuadraticData,
    Y0: torch.Tensor,
    radius: float,
    qd_inner: Optional[QuadraticData] = None,
    inner_control_matvecs: bool = False,
    residual_control: bool = False,
) -> RTRState:
    """Cost, gradients and Weingarten correction at Y0 from one matvec (in
    inner precision with inner control matvecs)."""
    if residual_control:
        raise NotImplementedError(
            "residual_control needs the residual form, not ported yet"
        )
    if qd_inner is not None and inner_control_matvecs:
        qm = quadratic.q_matvec(qd_inner, Y0.to(qd_inner.diag.dtype))
        qm = qm.to(Y0.dtype)
    else:
        qm = quadratic.q_matvec(qd, Y0)
    eg = qm + qd.G
    grad = lifted.proj_tangent(Y0, eg)
    dev = Y0.device
    return RTRState(
        X=Y0,
        fx=0.5 * lifted.inner(qm, Y0) + lifted.inner(Y0, qd.G),
        grad=grad,
        gnorm=lifted.norm(grad),
        S=quadratic.hess_correction(Y0, eg),
        eg=eg,
        radius=torch.tensor(radius, dtype=Y0.dtype, device=dev),
        it=0,
        accepted=torch.zeros((), dtype=torch.bool, device=dev),
        tcg_iters=torch.zeros((), dtype=torch.int64, device=dev),
    )


def _inner_copy(qd: QuadraticData, Y0: torch.Tensor, inner_dtype):
    if inner_dtype is None or inner_dtype == Y0.dtype:
        return None
    return qd.to(inner_dtype)


def rtr_solve(
    qd: QuadraticData,
    Y0: torch.Tensor,
    gradnorm_tol: float,
    initial_radius: float,
    max_iterations: int = 3,
    max_inner: int = 50,
    shrink_until_accept: bool = False,
    inner_dtype: Optional[torch.dtype] = None,
    exact_inner_hessian: bool = True,
    inner_control_matvecs: bool = False,
    residual_control: bool = False,
    tcg_unroll: int = 4,
) -> Tuple[torch.Tensor, RTRStats]:
    """Riemannian trust-region solve of the lifted PGO quadratic.

    With shrink_until_accept=True this is the reference's per-RBCD-step mode
    (QuadraticOptimizer.cpp:80-98): one RTR iteration retried with radius/4
    until acceptance (at most 10 shrinks, else the initial iterate).
    Otherwise a standard RTR loop of up to max_iterations.

    inner_dtype (e.g. torch.float32): run the tCG in reduced precision while
    the trust-region control stays in Y0's dtype; the tCG then works on
    qd.to(inner_dtype), so with CSR plans attached its matvecs go through the
    segment-sum kernel. residual_control is not ported yet and raises."""
    if residual_control:
        raise NotImplementedError(
            "residual_control needs the residual form, not ported yet"
        )
    qd_inner = _inner_copy(qd, Y0, inner_dtype)
    state0 = _initial_state(qd, Y0, initial_radius, qd_inner,
                            inner_control_matvecs)
    skip = state0.gnorm < gradnorm_tol

    def step(state, max_radius, shrink_only):
        return _rtr_iteration(
            qd, state, max_inner, max_radius, shrink_only, qd_inner=qd_inner,
            exact_inner_hessian=exact_inner_hessian,
            inner_control_matvecs=inner_control_matvecs,
            tcg_unroll=tcg_unroll,
        )

    state = state0
    if shrink_until_accept:
        attempts = 0
        while attempts <= _MAX_SHRINKS and not bool(state.accepted):
            nxt = step(state, state.radius, True)
            # on rejection: keep the original iterate, shrink the radius by 4
            state = nxt._replace(
                radius=torch.where(nxt.accepted, nxt.radius, 0.25 * state.radius)
            )
            attempts += 1
    else:
        max_radius = 5.0 * torch.tensor(initial_radius, dtype=Y0.dtype,
                                        device=Y0.device)
        while state.it < max_iterations and bool(state.gnorm >= gradnorm_tol):
            state = step(state, max_radius, False)

    stats = RTRStats(
        f_init=state0.fx,
        gnorm_init=state0.gnorm,
        f_opt=torch.where(skip, state0.fx, state.fx),
        gnorm_opt=torch.where(skip, state0.gnorm, state.gnorm),
        iterations=0 if bool(skip) else state.it,
        accepted=skip | state.accepted,
        tcg_iters=state.tcg_iters,
    )
    return torch.where(skip, Y0, state.X), stats


def initial_cost_gradnorm(
    qd: QuadraticData,
    Y0: torch.Tensor,
    inner_dtype: Optional[torch.dtype] = None,
    inner_control_matvecs: bool = False,
    residual_control: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cost and Riemannian gradient norm at Y0, exactly as rtr_solve's
    f_init/gnorm_init under the same flags (one matvec, no solve)."""
    st = _initial_state(qd, Y0, 0.0, _inner_copy(qd, Y0, inner_dtype),
                        inner_control_matvecs, residual_control)
    return st.fx, st.gnorm


def optimize(
    qd: QuadraticData, Y0: torch.Tensor, params: ROptParameters
) -> Tuple[torch.Tensor, RTRStats]:
    """Dispatch mirroring QuadraticOptimizer::optimize (reference:
    QuadraticOptimizer.cpp:26-48). Only the RTR method is ported."""
    if params.method != ROptMethod.RTR:
        raise NotImplementedError(f"{params.method} is not ported yet")
    return rtr_solve(
        qd,
        Y0,
        gradnorm_tol=params.gradnorm_tol,
        initial_radius=params.RTR_initial_radius,
        max_iterations=params.RTR_iterations,
        max_inner=params.RTR_tCG_iterations,
        shrink_until_accept=(params.RTR_iterations == 1),
    )

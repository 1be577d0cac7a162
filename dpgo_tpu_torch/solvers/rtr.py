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

Batches: given Y0 of shape (A, n, r, dh) and a QuadraticData of the A
problems stacked (quadratic.py), rtr_solve solves the A problems at once,
each exactly as it would be solved alone: every inner product and control
scalar (radius, cost, gradient norm, acceptance, tCG's alpha, beta, P-norms
and `done`) is an (A,) tensor, and a loop runs until every problem is done,
each finished problem frozen by torch.where. That is the JAX package's vmap
of rtr_solve over agents (parallel/spmd.py), with one host sync per tCG
iteration for the whole batch. The counts in RTRStats are then (A,)
tensors.

Float32 products run in full float32 (devices.highest): the port's
counterpart of every tCG precision of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dpgo_tpu_torch import devices, quadratic
from dpgo_tpu_torch.devices import highest
from dpgo_tpu_torch.ops import lifted
from dpgo_tpu_torch.quadratic import QuadraticData
from dpgo_tpu_torch.types import ROptMethod, ROptParameters

_THETA = 1.0
_KAPPA = 0.1
_RHO_PRIME = 0.1
_MAX_SHRINKS = 10  # QuadraticOptimizer.cpp:90 ("total_steps > 10")

# host reads of the tCG's `done` flag (caps above tcg_unroll only)
TCG_SYNCS = 0


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
    it: int  # an (A,) tensor for a batch
    accepted: torch.Tensor  # whether the latest step was accepted
    tcg_iters: torch.Tensor


class RTRStats(NamedTuple):
    f_init: torch.Tensor
    gnorm_init: torch.Tensor
    f_opt: torch.Tensor
    gnorm_opt: torch.Tensor
    iterations: int  # an (A,) tensor for a batch
    accepted: torch.Tensor
    tcg_iters: torch.Tensor


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """<a, b> per problem: a scalar for one (n, r, dh) problem, (A,) for an
    (A, n, r, dh) batch."""
    if a.dim() == 3:
        return lifted.inner(a, b)
    return (a * b).sum(dim=(-3, -2, -1))


def _bc(s: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per-problem scalars s shaped to broadcast against `like`."""
    return s.reshape(s.shape + (1,) * (like.dim() - s.dim()))


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-problem mask."""
    return torch.where(_bc(mask, a), a, b)


def _freeze(active: torch.Tensor, new, old):
    """Per problem: the new tuple where active, the old one elsewhere."""
    vals = [_where(active, n_, o) for n_, o in zip(new, old)]
    return old._make(vals) if hasattr(old, "_make") else tuple(vals)


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
    loop until done with one host sync per iteration (in a batch: until
    every problem is done, each finished one masked). Both give the same
    numbers."""
    dtype, dev = X.dtype, X.device
    batch = X.shape[:-3]
    zero = torch.zeros_like(grad)

    r0 = grad
    z0 = quadratic.apply_precond(qd, X, r0)
    r_r0 = _dot(r0, r0)
    z_r0 = _dot(z0, r0)
    norm_r0 = torch.sqrt(r_r0)
    # residual target: ||r|| <= ||r0|| * min(kappa, ||r0||^theta)
    r_target = norm_r0 * torch.clamp(norm_r0**_THETA, max=_KAPPA)
    rr = radius * radius

    def body(c):
        j, eta, Heta, r, z, delta, e_Pe, e_Pd, d_Pd, z_r, done, boundary = c
        Hd = quadratic.rie_hess_vec(qd, X, S, delta)
        d_Hd = _dot(delta, Hd)
        alpha = z_r / d_Hd
        e_Pe_new = e_Pe + 2.0 * alpha * e_Pd + alpha * alpha * d_Pd

        # negative curvature or leaving the trust region -> go to the boundary
        hit = (d_Hd <= 0.0) | (e_Pe_new >= rr)
        disc = e_Pd * e_Pd + d_Pd * (rr - e_Pe)
        tau = (-e_Pd + torch.sqrt(torch.clamp(disc, min=0.0))) / d_Pd
        step = torch.where(hit, tau, alpha)

        eta_n = eta + _bc(step, delta) * delta
        Heta_n = Heta + _bc(step, Hd) * Hd

        r_n = r + _bc(alpha, Hd) * Hd
        resid_ok = torch.sqrt(_dot(r_n, r_n)) <= r_target

        z_n = quadratic.apply_precond(qd, X, r_n)
        z_r_n = _dot(z_n, r_n)
        beta = z_r_n / z_r
        delta_n = -z_n + _bc(beta, delta) * delta
        e_Pd_n = beta * (e_Pd + alpha * d_Pd)
        d_Pd_n = z_r_n + beta * beta * d_Pd

        return (
            j + 1,
            eta_n,
            Heta_n,
            _where(hit, r, r_n),
            _where(hit, z, z_n),
            _where(hit, delta, delta_n),
            torch.where(hit, e_Pe, e_Pe_new),
            torch.where(hit, e_Pd, e_Pd_n),
            torch.where(hit, d_Pd, d_Pd_n),
            torch.where(hit, z_r, z_r_n),
            hit | resid_ok,
            boundary | hit,
        )

    scalar0 = torch.zeros(batch, dtype=dtype, device=dev)
    false = torch.zeros(batch, dtype=torch.bool, device=dev)
    c = (
        torch.zeros(batch, dtype=torch.int64, device=dev), zero, zero, r0, z0,
        -z0, scalar0, scalar0, z_r0, z_r0, false, false,
    )
    if max_inner <= tcg_unroll:
        for _ in range(max_inner):
            c = _freeze(~c[-2], body(c), c)
    else:
        global TCG_SYNCS
        for _ in range(max_inner):
            done = c[-2]
            TCG_SYNCS += 1
            if bool(done.all()):
                break
            c = body(c) if not batch else _freeze(~done, body(c), c)
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
    + <X' - X, G> with the matvecs in inner precision.

    residual_control: the new Euclidean gradient comes from the residual
    form (quadratic.cost_grad_residual on qd.res, in the inner precision
    where there is one) and the cost decrease from the identity, exact for
    a quadratic, f(X') - f(X) = 0.5 <X' - X, eg + eg'> with the Euclidean
    gradients carried in the state: both accurate to ~eps * residual in the
    control dtype, and no full matvec."""
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
    if residual_control:
        qd_c = qd if qd_inner is None else qd_inner
        D = X_new - state.X
        _, eg_new = quadratic.cost_grad_residual(
            qd_c.res, X_new.to(qd_c.diag.dtype))
        eg = eg_new.to(state.X.dtype)
        f_new = state.fx + 0.5 * (_dot(D, state.eg) + _dot(D, eg))
    elif qd_inner is not None and inner_control_matvecs:
        dt = qd_inner.diag.dtype
        D = X_new - state.X
        qs = quadratic.q_matvec(qd_inner, (state.X + X_new).to(dt))
        qs = qs.to(state.X.dtype)
        f_new = state.fx + (0.5 * _dot(qs, D) + _dot(D, qd.G))
        qm_new = quadratic.q_matvec(qd_inner, X_new.to(dt)).to(state.X.dtype)
        eg = qm_new + qd.G
    else:
        # one matvec serves both the new cost and the new Euclidean gradient
        qm_new = quadratic.q_matvec(qd, X_new)
        f_new = 0.5 * _dot(qm_new, X_new) + _dot(X_new, qd.G)
        eg = qm_new + qd.G

    model_decrease = -(
        _dot(state.grad, tcg.eta) + 0.5 * _dot(tcg.eta, tcg.Heta)
    )
    if residual_control:
        # rho without numerator inflation: the decrease is cancellation-free
        # here, so a true cost increase must be rejected (the cost-scaled
        # guard below would accept noise steps near convergence, which
        # Nesterov then amplifies). The denominator's floor only avoids 0/0
        # (the Steihaug decrease is >= 0).
        rho = (state.fx - f_new) / torch.clamp(
            model_decrease, min=torch.finfo(state.fx.dtype).tiny)
    else:
        # small regularization guards rho against cancellation near
        # convergence
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
    grad_next = _where(accept, grad_new, state.grad)
    return RTRState(
        X=_where(accept, X_new, state.X),
        fx=torch.where(accept, f_new, state.fx),
        grad=grad_next,
        gnorm=torch.sqrt(_dot(grad_next, grad_next)),
        S=_where(accept, S_new, state.S),
        eg=_where(accept, eg, state.eg),
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
    inner precision with inner control matvecs), or, under residual_control,
    from one pass of the residual form in the control precision (fx is then
    in the complete-residual convention: a constant away from 0.5 <X Q, X> +
    <X, G>, which cancels in every decision)."""
    if residual_control:
        qd_c = qd if qd_inner is None else qd_inner
        fx, eg = quadratic.cost_grad_residual(
            qd_c.res, Y0.to(qd_c.diag.dtype))
        fx, eg = fx.to(Y0.dtype), eg.to(Y0.dtype)
    else:
        if qd_inner is not None and inner_control_matvecs:
            qm = quadratic.q_matvec(qd_inner, Y0.to(qd_inner.diag.dtype))
            qm = qm.to(Y0.dtype)
        else:
            qm = quadratic.q_matvec(qd, Y0)
        eg = qm + qd.G
        fx = 0.5 * _dot(qm, Y0) + _dot(Y0, qd.G)
    grad = lifted.proj_tangent(Y0, eg)
    dev, batch = Y0.device, Y0.shape[:-3]
    return RTRState(
        X=Y0,
        fx=fx,
        grad=grad,
        gnorm=torch.sqrt(_dot(grad, grad)),
        S=quadratic.hess_correction(Y0, eg),
        eg=eg,
        radius=torch.full(batch, radius, dtype=Y0.dtype, device=dev),
        it=torch.zeros(batch, dtype=torch.int64, device=dev) if batch else 0,
        accepted=torch.zeros(batch, dtype=torch.bool, device=dev),
        tcg_iters=torch.zeros(batch, dtype=torch.int64, device=dev),
    )


def _inner_copy(qd: QuadraticData, Y0: torch.Tensor, inner_dtype,
                inner_data: Optional[QuadraticData]):
    if inner_dtype is None or inner_dtype == Y0.dtype:
        return None
    return qd.to(inner_dtype) if inner_data is None else inner_data


@highest
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
    inner_data: Optional[QuadraticData] = None,
) -> Tuple[torch.Tensor, RTRStats]:
    """Riemannian trust-region solve of the lifted PGO quadratic.

    With shrink_until_accept=True this is the reference's per-RBCD-step mode
    (QuadraticOptimizer.cpp:80-98): one RTR iteration retried with radius/4
    until acceptance (at most 10 shrinks, else the initial iterate).
    Otherwise a standard RTR loop of up to max_iterations.

    inner_dtype (e.g. torch.float32): run the tCG in reduced precision while
    the trust-region control stays in Y0's dtype; the tCG then works on
    qd.to(inner_dtype), so with CSR plans attached its matvecs go through the
    fused edge kernel. inner_data: that copy ready-made (qd.to(inner_dtype),
    G included), for a caller that solves the same data round after round
    and so casts it once.

    residual_control=True (needs qd.res, quadratic.build_residual_data, and
    in inner_data too where that is given): the control's cost differences
    come from the cancellation-free identity and its gradients from the
    residual form, both accurate to ~eps * residual in the control dtype
    (_rtr_iteration), so a float32 control reaches gradient norms that the
    matvec form loses to cancellation.

    Y0 of shape (A, n, r, dh) solves a batch (module docstring)."""
    if residual_control and qd.res is None:
        raise ValueError("residual_control needs qd.res "
                         "(quadratic.build_residual_data)")
    qd_inner = _inner_copy(qd, Y0, inner_dtype, inner_data)
    state0 = _initial_state(qd, Y0, initial_radius, qd_inner,
                            inner_control_matvecs, residual_control)
    skip = state0.gnorm < gradnorm_tol

    def step(state, max_radius, shrink_only):
        return _rtr_iteration(
            qd, state, max_inner, max_radius, shrink_only, qd_inner=qd_inner,
            exact_inner_hessian=exact_inner_hessian,
            inner_control_matvecs=inner_control_matvecs,
            residual_control=residual_control, tcg_unroll=tcg_unroll,
        )

    batched = Y0.dim() == 4
    state = state0
    if shrink_until_accept:
        for _ in range(_MAX_SHRINKS + 1):
            active = ~state.accepted
            if not bool(active.any()):
                break
            nxt = step(state, state.radius, True)
            # on rejection: keep the original iterate, shrink the radius by 4
            nxt = nxt._replace(
                radius=torch.where(nxt.accepted, nxt.radius, 0.25 * state.radius)
            )
            state = _freeze(active, nxt, state) if batched else nxt
    else:
        max_radius = 5.0 * torch.tensor(initial_radius, dtype=Y0.dtype,
                                        device=Y0.device)
        while True:
            active = state.gnorm >= gradnorm_tol
            if batched:
                active = active & (state.it < max_iterations)
            elif state.it >= max_iterations:
                break
            if not bool(active.any()):
                break
            nxt = step(state, max_radius, False)
            state = _freeze(active, nxt, state) if batched else nxt

    if batched:
        iterations = torch.where(skip, 0, state.it)
    else:
        iterations = 0 if bool(skip) else state.it
    stats = RTRStats(
        f_init=state0.fx,
        gnorm_init=state0.gnorm,
        f_opt=torch.where(skip, state0.fx, state.fx),
        gnorm_opt=torch.where(skip, state0.gnorm, state.gnorm),
        iterations=iterations,
        accepted=skip | state.accepted,
        tcg_iters=state.tcg_iters,
    )
    return _where(skip, Y0, state.X), stats


@highest
def initial_cost_gradnorm(
    qd: QuadraticData,
    Y0: torch.Tensor,
    inner_dtype: Optional[torch.dtype] = None,
    inner_control_matvecs: bool = False,
    residual_control: bool = False,
    inner_data: Optional[QuadraticData] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cost and Riemannian gradient norm at Y0, exactly as rtr_solve's
    f_init/gnorm_init under the same flags (one matvec or one pass of the
    residual form, no solve); (A,) each for a batch."""
    st = _initial_state(qd, Y0, 0.0,
                        _inner_copy(qd, Y0, inner_dtype, inner_data),
                        inner_control_matvecs, residual_control)
    return st.fx, st.gnorm


@highest
def rtr_solve_auto(
    problem: quadratic.LocalProblem,
    X0: torch.Tensor,
    gradnorm_tol: float,
    initial_radius: float = 100.0,
    max_iterations: int = 100,
    max_inner: int = 200,
    probe_iterations: int = 15,
    inner_dtype: Optional[torch.dtype] = None,
    device=None,
) -> Tuple[torch.Tensor, RTRStats]:
    """Centralized solve with a measured preconditioner choice (the
    counterpart of dpgo_tpu.solvers.rtr.rtr_solve_auto).

    Phase 1 runs up to `probe_iterations` outer RTR iterations with the
    cheap block-Jacobi preconditioner. Only on a measured stall (phase 1
    ends at or above the tolerance with iterations left) is the data
    rebuilt with the exact banded factor (RCM + superblock cyclic
    reduction, Cholmod-LDL^T parity; build_q_data's 'banded', with its
    fallbacks) and the solve continued from the phase-1 iterate. Returns
    the iterate and the two phases' merged stats. Both phases attach the
    CSR plans (quadratic.attach_csr_plans), so a float32 tCG runs the fused
    edge kernel on the card.

    device: None (the default) solves on the CUDA card and raises where
    there is none; problem and X0 move there."""
    device = devices.resolve(device, "rtr_solve_auto")
    problem = devices.move(problem, device)
    X0 = X0.to(device)
    r, dh = X0.shape[-2], X0.shape[-1]
    zeros_nbr = torch.zeros((1, r, dh), dtype=X0.dtype, device=device)

    def phase(precond, Y0, iterations):
        qd = quadratic.attach_csr_plans(quadratic.build_quadratic_data(
            problem, zeros_nbr, r=r, precond=precond))
        return rtr_solve(qd, Y0, gradnorm_tol, initial_radius,
                         max_iterations=iterations, max_inner=max_inner,
                         inner_dtype=inner_dtype)

    probe = min(probe_iterations, max_iterations)
    X, stats = phase("jacobi", X0, probe)
    if float(stats.gnorm_opt) < gradnorm_tol or probe >= max_iterations:
        return X, stats

    # measured stall: escalate to the exact factor and continue
    X2, stats2 = phase("banded", X, max_iterations - probe)
    return X2, RTRStats(
        f_init=stats.f_init,
        gnorm_init=stats.gnorm_init,
        f_opt=stats2.f_opt,
        gnorm_opt=stats2.gnorm_opt,
        iterations=stats.iterations + stats2.iterations,
        accepted=stats2.accepted,
        tcg_iters=stats.tcg_iters + stats2.tcg_iters,
    )


@highest
def rgd_step(
    qd: QuadraticData,
    Y0: torch.Tensor,
    stepsize: float,
    use_preconditioner: bool = True,
) -> torch.Tensor:
    """One preconditioned Riemannian gradient step with retraction
    (reference: QuadraticOptimizer.cpp:110-137)."""
    g = quadratic.rie_grad(qd, Y0)
    direction = quadratic.apply_precond(qd, Y0, g) if use_preconditioner else g
    return lifted.retract(Y0, -stepsize * direction)


@highest
def rsd_line_search(
    qd: QuadraticData,
    Y0: torch.Tensor,
    gradnorm_tol: float = 1e-2,
    max_iterations: int = 10,
    initial_step: float = 1.0,
    backtrack: float = 0.5,
    armijo: float = 1e-4,
    max_backtracks: int = 20,
) -> Tuple[torch.Tensor, RTRStats]:
    """Riemannian steepest descent with Armijo backtracking line search: the
    counterpart of the reference's (unused) ROPTLIB::RSD path
    (QuadraticOptimizer.cpp:139-160: tol 1e-2, 10 iterations). One problem
    (Y0 of shape (n, r, dh)); both loops read their condition on the host,
    one sync per trial step."""
    X = Y0
    fx = f_init = quadratic.cost(qd, X)
    grad = quadratic.rie_grad(qd, X)
    gnorm = g_init = lifted.norm(grad)
    it = 0
    while it < max_iterations and float(gnorm) >= gradnorm_tol:
        t = initial_step
        X_new = lifted.retract(X, -t * grad)
        f_new = quadratic.cost(qd, X_new)
        k = 0
        while k < max_backtracks and \
                not bool(f_new <= fx - armijo * t * gnorm**2):
            t = t * backtrack
            X_new = lifted.retract(X, -t * grad)
            f_new = quadratic.cost(qd, X_new)
            k += 1
        if bool(f_new < fx):
            X, fx = X_new, f_new
        grad = quadratic.rie_grad(qd, X)
        gnorm = lifted.norm(grad)
        it += 1
    dev = Y0.device
    stats = RTRStats(
        f_init=f_init, gnorm_init=g_init, f_opt=fx, gnorm_opt=gnorm,
        iterations=it, accepted=torch.ones((), dtype=torch.bool, device=dev),
        tcg_iters=torch.zeros((), dtype=torch.int64, device=dev),
    )
    return X, stats


def optimize(
    qd: QuadraticData, Y0: torch.Tensor, params: ROptParameters
) -> Tuple[torch.Tensor, RTRStats]:
    """Dispatch mirroring QuadraticOptimizer::optimize (reference:
    QuadraticOptimizer.cpp:26-48): the trust-region solve, or one RGD
    step."""
    if params.method == ROptMethod.RTR:
        return rtr_solve(
            qd,
            Y0,
            gradnorm_tol=params.gradnorm_tol,
            initial_radius=params.RTR_initial_radius,
            max_iterations=params.RTR_iterations,
            max_inner=params.RTR_tCG_iterations,
            shrink_until_accept=(params.RTR_iterations == 1),
        )
    Y = rgd_step(qd, Y0, params.RGD_stepsize, params.RGD_use_preconditioner)
    dev = Y0.device
    stats = RTRStats(
        f_init=quadratic.cost(qd, Y0),
        gnorm_init=quadratic.rie_grad_norm(qd, Y0),
        f_opt=quadratic.cost(qd, Y),
        gnorm_opt=quadratic.rie_grad_norm(qd, Y),
        iterations=1,
        accepted=torch.ones((), dtype=torch.bool, device=dev),
        tcg_iters=torch.zeros((), dtype=torch.int64, device=dev),
    )
    return Y, stats

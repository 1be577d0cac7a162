"""Global-optimality certification and the Riemannian staircase.

The counterpart of dpgo_tpu/solvers/certify.py: an SE-Sync / Cartan-Sync
style dual certificate, evaluated matrix-free on the same block-sparse
q_matvec the solvers use. The reference stops on gradient norm alone
(PGOAgent.cpp:846-878); this module supplies the certificate its papers
name.

Math. The centralized lifted problem (every edge private, no linear term) is
min f(X) = 0.5 <X Q, X> over X in (St(d, r) x R^r)^n, stored (n, r, d+1).
At a first-order critical point the KKT multipliers of the per-pose
constraints Y_i^T Y_i = I are Lambda_i = sym(Y_i^T (X Q)_i^rot), and the
certificate matrix S = Q - LambdaHat (LambdaHat block-diagonal with
[Lambda_i, 0] on pose i's block) satisfies X S = 0. S >= 0 means X is a
global minimizer of the rank-r problem (and, with rank(X) = d, rounds to
the global SE(d) optimum); lambda_min(S) < 0 with eigenvector v gives the
staircase's escape direction X+ = [X; eps v^T] at rank r + 1.

lambda_min comes from deflated Lanczos with full reorthogonalization on the
matrix-free S-action (a Python loop with no host read inside), refined by a
preconditioned Rayleigh-quotient iteration (LOBPCG, block 1) driven from the
host when the Lanczos residual is too large for the rigorous bound. The
certificate runs in the dtype of X, float64 in practice: q_matvec's float32
CSR branch, and so the hand-written kernels, never run here.

Entry points (certify_solution, solve_pgo_staircase) run on the CUDA card
unless given another device; the random Lanczos start comes from a
torch.Generator seeded with `seed` (the JAX package draws from
jax.random.normal, so min_eig_certificate takes that draw as v0).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dpgo_tpu_torch import devices, quadratic
from dpgo_tpu_torch.devices import highest
from dpgo_tpu_torch.measurements import EdgeArrays, num_poses_and_dim
from dpgo_tpu_torch.ops import lifted


@highest
def kkt_multipliers(qd: quadratic.QuadraticData,
                    X: torch.Tensor) -> torch.Tensor:
    """Lambda_i = sym(Y_i^T (X Q + G)_i^rot): (n, d, d). The linear term is
    included, so the multipliers are exact for local (agent) problems too;
    for the centralized certificate G = 0."""
    eg = quadratic.euc_grad(qd, X)
    YtG = lifted.rotations(X).transpose(-1, -2) @ lifted.rotations(eg)
    return 0.5 * (YtG + YtG.transpose(-1, -2))


@highest
def certificate_matvec(qd: quadratic.QuadraticData, Lam: torch.Tensor,
                       V: torch.Tensor) -> torch.Tensor:
    """Row action V S = V Q - V LambdaHat for V: (n, k, dh), k arbitrary:
    one q_matvec plus one batched small product."""
    VQ = quadratic.q_matvec(qd, V)
    corr = lifted.rotations(V) @ Lam
    return VQ - torch.cat([corr, torch.zeros_like(V[..., -1:])], dim=-1)


def stationarity_gap(qd: quadratic.QuadraticData, X: torch.Tensor,
                     Lam: torch.Tensor) -> torch.Tensor:
    """||X S||_F: how far X is from a true critical point (the Riemannian
    gradient norm up to the symmetric-part split)."""
    return lifted.norm(certificate_matvec(qd, Lam, X))


def _lanczos(matvec, v0: torch.Tensor, k: int):
    """k-step Lanczos with full reorthogonalization (twice, Parlett), as a
    Python loop with no host read. matvec: (m,) -> (m,) symmetric. Returns
    (alpha (k,), beta (k,), V (k, m)); beta[-1] is the final residual
    norm."""
    m = v0.shape[0]
    dt, dev = v0.dtype, v0.device
    v = v0 / torch.linalg.vector_norm(v0)
    V = torch.zeros((k, m), dtype=dt, device=dev)
    alpha = torch.zeros((k,), dtype=dt, device=dev)
    beta = torch.zeros((k,), dtype=dt, device=dev)
    b_prev = torch.zeros((), dtype=dt, device=dev)
    for i in range(k):
        V[i] = v
        w = matvec(v)
        a = torch.dot(v, w)
        w = w - a * v
        if i > 0:
            w = w - b_prev * V[i - 1]
        # rows > i are zero, so the products over all of V are exact
        w = w - V.T @ (V @ w)
        w = w - V.T @ (V @ w)
        b = torch.linalg.vector_norm(w)
        alpha[i] = a
        beta[i] = b
        v = torch.where(b > 1e-12, w / torch.clamp(b, min=1e-30), w)
        b_prev = b
    return alpha, beta, V


def _pcg_refine_min(mv, prec, defl, x0, iters: int, tol: float):
    """Preconditioned Rayleigh-quotient minimization (LOBPCG, block 1) for
    the smallest eigenpair of the deflated certificate operator, driven
    from the host: mv, prec and defl map float64 numpy vectors to numpy
    vectors (each a device call). The preconditioner is the quadratic
    data's own (Q + shift I)^-1, a near-inverse of S, so the iteration
    converges in tens of matvecs where plain Lanczos stalls on a tiny
    relative gap.

    Returns (theta, x, residual_norm): the Rayleigh quotient and the exact
    residual of the returned vector, the ingredients of the rigorous bound
    lambda_min >= theta - ||r||."""
    x = np.array(defl(x0), np.float64)
    x /= np.linalg.norm(x)
    p = None
    for _ in range(iters):
        Sx = np.asarray(mv(x), np.float64)
        theta = float(x @ Sx)
        r = Sx - theta * x
        rn = float(np.linalg.norm(r))
        if rn < tol:
            return theta, x, rn
        w = np.asarray(defl(prec(r)), np.float64)
        cols = [x, w] if p is None else [x, w, p]
        Bq, _ = np.linalg.qr(np.stack(cols, axis=1))
        SB = np.stack([np.asarray(mv(Bq[:, i]), np.float64)
                       for i in range(Bq.shape[1])], axis=1)
        T = Bq.T @ SB
        T = 0.5 * (T + T.T)
        _evals, evecs = np.linalg.eigh(T)
        x_new = Bq @ evecs[:, 0]
        # LOBPCG history direction: the part of the step orthogonal to x
        p = x_new - x * float(x @ x_new)
        pn = np.linalg.norm(p)
        p = p / pn if pn > 1e-12 else None
        x = x_new / np.linalg.norm(x_new)
    Sx = np.asarray(mv(x), np.float64)
    theta = float(x @ Sx)
    return theta, x, float(np.linalg.norm(Sx - theta * x))


class CertificateResult(NamedTuple):
    certified: bool
    lambda_min: float  # point estimate: min over both subspaces
    lambda_min_lower: float  # rigorous lower bound on lambda_min(S)
    eigvec: np.ndarray  # (n, dh) unit vector: most-negative direction found
    stationarity: float  # ||X S||_F at the tested point
    eig_residual: float  # residual of the deflated Ritz pair


def _start_vector(m: int, seed: int) -> torch.Tensor:
    g = torch.Generator()
    g.manual_seed(seed)
    return torch.randn((m,), generator=g, dtype=torch.float64)


@highest
def min_eig_certificate(
    qd: quadratic.QuadraticData,
    X: torch.Tensor,
    k: int = 64,
    eta: float = 1e-6,
    seed: int = 0,
    refine_iters: int = 400,
    seeds: Optional[Tuple[int, ...]] = None,
    v0=None,
) -> CertificateResult:
    """lambda_min(S) via deflated matrix-free Lanczos, on X's device.

    At a critical point S annihilates the row space of X and the
    translation-gauge vector, a cluster of zero eigenvalues at the decision
    boundary. Deflate B = an orthonormal basis of span{rows(X), gauge} (its
    SVD: unpivoted QR of a rank-deficient stack emits columns outside the
    span) and run Lanczos on P S P (P = I - B B^T), then refine (the
    preconditioned Rayleigh-quotient iteration) where the Lanczos residual
    exceeds max(0.1 eta, 1e-10). The bound

        lambda_min(S) >= min(lambda_min(B^T S B), lambda_defl - res) - ||P S B||

    (Weyl on the 2x2 block form) passes when >= -eta. The bound is rigorous
    for the eigenvalue nearest the Ritz value; seeds=(0, 1, ...) re-runs
    from independent starts and keeps the worst result.

    v0: the (n*dh,) Lanczos start vector; None draws it from a
    torch.Generator seeded with `seed`."""
    if seeds is not None:
        results = [min_eig_certificate(qd, X, k=k, eta=eta, seed=s,
                                       refine_iters=refine_iters)
                   for s in seeds]
        return min(results, key=lambda c: c.lambda_min_lower)
    n, r, dh = X.shape
    d = dh - 1
    m = n * dh
    dt, dev = X.dtype, X.device
    Lam = kkt_multipliers(qd, X)

    def mv(w):
        return certificate_matvec(qd, Lam, w.reshape(n, 1, dh)).reshape(m)

    # deflation basis: the rows of X and the translation-gauge vector
    gauge = np.zeros((1, n, dh))
    gauge[0, :, d] = 1.0
    raw = np.concatenate(
        [X.detach().cpu().numpy().astype(np.float64).transpose(1, 0, 2)
         .reshape(r, m), gauge.reshape(1, m)], axis=0)
    _u, sv, Vt = np.linalg.svd(raw, full_matrices=False)
    B = torch.as_tensor(Vt[sv > 1e-6 * sv[0]], device=dev).to(dt)  # (q, m)
    q = B.shape[0]
    k = int(min(k, m - q))

    def defl_t(w):
        return w - B.T @ (B @ w)

    def mv_defl(w):
        return defl_t(mv(defl_t(w)))

    if v0 is None:
        v0 = _start_vector(m, seed)
    v0 = defl_t(torch.as_tensor(np.array(v0) if not torch.is_tensor(v0)
                                else v0).to(device=dev, dtype=dt))
    alpha, beta, V = _lanczos(mv_defl, v0, k)
    alpha = alpha.cpu().numpy().astype(np.float64)
    beta = beta.cpu().numpy().astype(np.float64)
    # Lanczos breakdown (an invariant subspace): truncate at the first tiny
    # beta, else the zero rows of T contribute spurious 0 eigenvalues
    small = np.nonzero(beta < 1e-10)[0]
    if small.size:
        k = int(small[0]) + 1
        alpha, beta = alpha[:k], beta[:k]
    T = np.diag(alpha)
    off = beta[: k - 1]
    T += np.diag(off, 1) + np.diag(off, -1)
    evals, evecs = np.linalg.eigh(T)
    lam_defl = float(evals[0])
    v = V[:k].cpu().numpy().astype(np.float64).T @ evecs[:, 0]
    v /= np.linalg.norm(v)
    v_dev = torch.as_tensor(v, device=dev).to(dt)
    res = float(torch.linalg.vector_norm(mv_defl(v_dev) - lam_defl * v_dev))

    res_target = max(0.1 * eta, 1e-10)
    if res > res_target and refine_iters > 0:
        def to_dev(w):
            return torch.as_tensor(np.asarray(w), device=dev).to(dt)

        def mv_np(w):
            return mv_defl(to_dev(w)).cpu().numpy()

        def prec_np(w):
            return quadratic.precond_solve(
                qd, to_dev(w).reshape(n, 1, dh)).reshape(m).cpu().numpy()

        def defl_np(w):
            return defl_t(to_dev(w)).cpu().numpy()

        lam_r, v_r, res_r = _pcg_refine_min(
            mv_np, prec_np, defl_np, v, iters=refine_iters, tol=res_target)
        if lam_r - res_r > lam_defl - res:  # keep the better bound
            lam_defl, v, res = lam_r, v_r, res_r

    # the q x q restriction and the coupling block: one certificate_matvec
    # with k = q
    SBt = certificate_matvec(
        qd, Lam, B.reshape(q, n, dh).transpose(0, 1)).transpose(0, 1) \
        .reshape(q, m)
    M_B = (B @ SBt.T).cpu().numpy().astype(np.float64)
    M_B = 0.5 * (M_B + M_B.T)
    lam_B = float(np.linalg.eigvalsh(M_B)[0]) if q else np.inf
    PSB = (SBt - (SBt @ B.T) @ B).cpu().numpy().astype(np.float64)
    coupling = float(np.linalg.norm(PSB, 2)) if q else 0.0

    lam_est = min(lam_defl, lam_B)
    lam_lower = min(lam_B, lam_defl - res) - coupling
    stat = float(stationarity_gap(qd, X, Lam))
    return CertificateResult(
        certified=bool(lam_lower >= -eta), lambda_min=lam_est,
        lambda_min_lower=lam_lower, eigvec=v.reshape(n, dh),
        stationarity=stat, eig_residual=res,
    )


@highest
def lift_and_escape(X: torch.Tensor, eigvec: np.ndarray, lambda_min: float,
                    qd_next: quadratic.QuadraticData,
                    max_backtracks: int = 20) -> torch.Tensor:
    """Rank lift r -> r + 1 along the negative-curvature direction:
    X+ = project([X; eps v^T]) with eps halved until the cost at rank r + 1
    (qd_next) strictly decreases (SE-Sync's staircase escape); where no
    step decreases it, the plain lift, whose cost equals the old one."""
    n, r, dh = X.shape
    v = torch.as_tensor(np.asarray(eigvec), device=X.device).to(
        X.dtype).reshape(n, 1, dh)
    X_pad = torch.cat([X, X.new_zeros((n, 1, dh))], dim=1)
    f0 = float(quadratic.cost(qd_next, X_pad))
    eps = 1.0
    for _ in range(max_backtracks):
        Xl = X_pad.clone()
        Xl[:, r:r + 1, :] += eps * v
        Xp = lifted.project_lifted(Xl)
        if float(quadratic.cost(qd_next, Xp)) < f0 - 1e-15:
            return Xp
        eps *= 0.5
    return X_pad


def _central_problem(measurements, device):
    d, n = num_poses_and_dim(measurements)
    edges = EdgeArrays.from_measurements(measurements)
    return d, n, quadratic.from_private_measurements(edges, n=n, d=d,
                                                     device=device)


def certify_solution(
    measurements: Sequence,
    X,
    k: int = 64,
    eta: float = 1e-6,
    precond: str = "auto",
    refine_iters: int = 400,
    v0=None,
    device=None,
) -> CertificateResult:
    """Certify a global iterate X (n, r, d+1) against the full measurement
    set: the entry point for distributed solutions (assemble the team's
    global iterate first, e.g. spmd.assemble_global), an offline
    verification step as in SE-Sync. The quadratic data takes `precond`
    (build_q_data's choices), whose factor the refinement uses. v0: as in
    min_eig_certificate.

    device: None (the default) certifies on the CUDA card and raises where
    there is none."""
    device = devices.resolve(device, "certify_solution")
    d, n, problem = _central_problem(measurements, device)
    X = torch.as_tensor(np.asarray(X) if not torch.is_tensor(X) else X)
    X = X.to(device=device, dtype=torch.float64)
    r = X.shape[-2]
    if tuple(X.shape) != (n, r, d + 1):
        raise ValueError(f"X must be ({n}, r, {d + 1}), got {tuple(X.shape)}")
    qd = quadratic.build_quadratic_data(
        problem, torch.zeros((1, r, d + 1), dtype=torch.float64,
                             device=device), r=r, precond=precond)
    return min_eig_certificate(qd, X, k=k, eta=eta, refine_iters=refine_iters,
                               v0=v0)


class StaircaseResult(NamedTuple):
    X: np.ndarray  # (n, r_final, d+1) certified (or last) iterate
    r: int
    certified: bool
    lambda_min: float
    cost: float
    gradnorm: float
    history: tuple


def solve_pgo_staircase(
    measurements: Sequence,
    r0: Optional[int] = None,
    r_max: int = 10,
    gradnorm_tol: float = 1e-6,
    eta: float = 1e-6,
    max_iterations: int = 200,
    max_inner: int = 200,
    T0: Optional[np.ndarray] = None,
    lanczos_k: int = 96,
    verbose: bool = False,
    device=None,
) -> StaircaseResult:
    """Certifiably-correct centralized PGO: solve at rank r (RTR, float64),
    test the dual certificate, escape to rank r + 1 along the negative
    eigenvector until certified or r_max (the SE-Sync Riemannian
    staircase). Starts from the chordal initialization unless T0 is given,
    lifted to r0 (default d). Returns the certified lifted iterate.

    device: None (the default) solves on the CUDA card and raises where
    there is none."""
    from dpgo_tpu_torch.solvers import rtr as rtr_mod
    from dpgo_tpu_torch.solvers.pgo import chordal_initialization

    device = devices.resolve(device, "solve_pgo_staircase")
    d, n, problem = _central_problem(measurements, device)
    r0 = d if r0 is None else r0
    if r0 < d:
        raise ValueError(f"r0 = {r0} is below d = {d}")
    if T0 is None:
        T0 = chordal_initialization(measurements, device=device)
    T0 = torch.as_tensor(np.asarray(T0) if not torch.is_tensor(T0) else T0)
    T0 = T0.to(device=device, dtype=torch.float64)

    def qd_at(r):
        return quadratic.build_quadratic_data(
            problem, torch.zeros((1, r, d + 1), dtype=torch.float64,
                                 device=device), r=r)

    if r0 == d:
        X = T0
    else:
        Y = lifted.fixed_stiefel_variable(d, r0, device=device)
        X = torch.einsum("rd,nde->nre", Y, T0)

    history = []
    r = r0
    while True:
        qd = qd_at(r)
        X, stats = rtr_mod.rtr_solve(
            qd, X, gradnorm_tol=gradnorm_tol, initial_radius=100.0,
            max_iterations=max_iterations, max_inner=max_inner)
        cert = min_eig_certificate(qd, X, k=lanczos_k, eta=eta)
        rec = {"r": r, "cost": 2 * float(stats.f_opt),
               "gradnorm": float(stats.gnorm_opt),
               "lambda_min": cert.lambda_min, "certified": cert.certified}
        history.append(rec)
        if verbose:
            print(f"staircase r={r}: cost={rec['cost']:.6f} "
                  f"gn={rec['gradnorm']:.2e} "
                  f"lambda_min={cert.lambda_min:.3e} "
                  f"certified={cert.certified}", flush=True)
        if cert.certified or r >= r_max:
            return StaircaseResult(
                X=X.cpu().numpy(), r=r, certified=cert.certified,
                lambda_min=cert.lambda_min, cost=rec["cost"],
                gradnorm=rec["gradnorm"], history=tuple(history))
        X = lift_and_escape(X, cert.eigvec, cert.lambda_min, qd_at(r + 1))
        r += 1

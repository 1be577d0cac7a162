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
preconditioned Rayleigh-quotient iteration (LOBPCG, block 1) when the
Lanczos residual is too large for the rigorous bound. The refinement keeps
its vectors, the 3-column basis (modified Gram-Schmidt) and the 3 x 3
Rayleigh-Ritz eigenproblem (in closed form) on X's device and reads its
stop test on the host once per block of REFINE_BLOCK masked iterations, on
CUDA each iteration a replay of a CUDA graph (_refine_min);
_pcg_refine_min, the JAX package's host-driven numpy loop, is its oracle
in the tests. The certificate runs in
the dtype of X, float64 in practice: q_matvec's float32 CSR branch, and so
the hand-written kernels, never run here.

Entry points (certify_solution, solve_pgo_staircase, solve_certified) run
on the CUDA card unless given another device; the random Lanczos start
comes from a torch.Generator seeded with `seed` (the JAX package draws from
jax.random.normal, so min_eig_certificate takes that draw as v0).

solve_certified is SE-Sync's certified solve on edge arrays (Rosen et al.,
IJRR 2019, Algorithm 1) with mixed precision where it is safe: at each rank
r from r0, (a) the centralized trust-region solve to a loose gradient norm,
its tCG in float32 over CSR plans, from the lifted chordal initialization;
(b) the float64 polish to the certificate's tolerance; (c)
min_eig_certificate over the exact banded preconditioner; (d) where not
certified, lift_and_escape to r + 1 and (a)-(c) again, up to r_max. The
measurement problem is assembled once a solve; the stages' quadratic data
are rebuilt at a new rank only by their zero linear term.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dpgo_tpu_torch import devices, quadratic, trace
from dpgo_tpu_torch.devices import highest
from dpgo_tpu_torch.measurements import EdgeArrays, num_poses_and_dim
from dpgo_tpu_torch.ops import lifted
from dpgo_tpu_torch.solvers import chordal, rtr


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
    relative gap. The JAX package's loop, kept as the oracle of
    _refine_min.

    Returns (theta, x, residual_norm, iterations): the Rayleigh quotient
    and the exact residual of the returned vector, the ingredients of the
    rigorous bound lambda_min >= theta - ||r||, and the iterations run."""
    x = np.array(defl(x0), np.float64)
    x /= np.linalg.norm(x)
    p = None
    for it in range(iters):
        Sx = np.asarray(mv(x), np.float64)
        theta = float(x @ Sx)
        r = Sx - theta * x
        rn = float(np.linalg.norm(r))
        if rn < tol:
            return theta, x, rn, it
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
    return theta, x, float(np.linalg.norm(Sx - theta * x)), iters


def _orthonormal_rows(cols, last=None):
    """Modified Gram-Schmidt, each vector swept twice ("twice is enough"):
    an orthonormal basis (c, m) of the c vectors' span, on their device
    (batched torch.linalg.qr is slow on the card for this shape). last: a
    bool tensor; where it is False the last row is zero (a vector that is
    not there)."""
    basis = []
    for v in cols:
        for _ in range(2):
            for q in basis:
                v = v - torch.dot(q, v) * q
        basis.append(v / torch.linalg.vector_norm(v))
    if last is not None:
        basis[-1] = torch.where(last, basis[-1], 0.0)
    return torch.stack(basis)


def _min_eigvec3(T: torch.Tensor) -> torch.Tensor:
    """A unit eigenvector of the smallest eigenvalue of the symmetric 3 x 3
    T, in closed form on T's device with no host read (torch.linalg.eigh
    reads the host on CUDA): the eigenvalue from the trigonometric solution
    of the characteristic cubic, the vector as the longest cross product of
    two rows of T - lambda I; (1, 0, 0) where T - lambda I has no two
    independent rows (lambda a double or triple eigenvalue)."""
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    q = torch.diagonal(T).sum() / 3
    A = T - q * eye
    p = torch.sqrt((A * A).sum() / 6)
    B = A / torch.clamp(p, min=torch.finfo(T.dtype).tiny)
    half_det = 0.5 * torch.dot(B[0], torch.linalg.cross(B[1], B[2]))
    phi = torch.acos(torch.clamp(half_det, -1.0, 1.0)) / 3
    M = T - (q + 2 * p * torch.cos(phi + 2 * math.pi / 3)) * eye
    C = torch.stack([torch.linalg.cross(M[0], M[1]),
                     torch.linalg.cross(M[0], M[2]),
                     torch.linalg.cross(M[1], M[2])])
    nrm = torch.linalg.vector_norm(C, dim=1)
    i = torch.argmax(nrm).reshape(1)
    v = torch.index_select(C, 0, i)[0] / torch.index_select(nrm, 0, i)
    return torch.where(torch.index_select(nrm, 0, i) > 0, v, eye[0])


# LOBPCG iterations a refinement block runs between two host reads of its
# stop test: the 400 of a certificate that runs its budget take 25 reads,
# and a converged refinement runs at most 15 frozen iterations.
REFINE_BLOCK = 16


def _refine_min(mv_rows, prec, defl, x0: torch.Tensor, iters: int,
                tol: float):
    """_pcg_refine_min's iteration on x0's device, in blocks of
    REFINE_BLOCK masked iterations with one host read a block.

    The state (x, the history direction p and its norm pn, the count k and
    active = the stop test not yet met and k < iters) lives in tensors that
    each iteration updates in place, and an iteration past the stop test
    changes nothing. An iteration is the oracle's: the stop test on the
    residual norm, the basis [x, w, p / pn] (_orthonormal_rows; without
    p where pn <= 1e-12, its row zero and its Ritz value pushed above the
    others) and its 3 x 3 Rayleigh-Ritz problem (_min_eigvec3). On CUDA
    each iteration is a replay of one CUDA graph captured per refinement
    (chordal._graphed). mv_rows maps rows (c, m) to their S-action (the
    basis's c <= 3 rows in one call); prec and defl map (m,) vectors.

    Returns (theta, x (m,) tensor, residual_norm, iterations), as
    _pcg_refine_min; theta and the residual norm of the last x take one
    read more."""
    x = defl(x0)
    x = x / torch.linalg.vector_norm(x)
    p = torch.zeros_like(x)
    pn = x.new_zeros(())
    k = torch.zeros((), dtype=torch.int64, device=x.device)
    active = k < iters

    def step():
        Sx = mv_rows(x[None])[0]
        theta = torch.dot(x, Sx)
        r = Sx - theta * x
        torch.logical_and(active, torch.linalg.vector_norm(r) >= tol,
                          out=active)
        has_p = pn > 1e-12
        w = defl(prec(r))
        Bq = _orthonormal_rows(
            [x, w, torch.where(has_p, p / torch.where(has_p, pn, 1.0), 0.0)],
            last=has_p)
        T = Bq @ mv_rows(Bq).T
        T = 0.5 * (T + T.T)
        # without p, its zero row and column: a Ritz value above the
        # 2 x 2 block's (Gershgorin), so that p takes no part
        T[2, 2] = torch.where(has_p, T[2, 2], 1.0 + T[0, 0].abs()
                              + T[1, 1].abs() + 2.0 * T[0, 1].abs())
        x_new = _min_eigvec3(T) @ Bq
        # LOBPCG history direction: the part of the step orthogonal to x
        p_new = x_new - x * torch.dot(x, x_new)
        for old, new in ((x, x_new / torch.linalg.vector_norm(x_new)),
                         (p, p_new), (pn, torch.linalg.vector_norm(p_new))):
            torch.where(active, new, old, out=old)
        k.add_(active)
        torch.logical_and(active, k < iters, out=active)

    run = (chordal._graphed(step, x.device, "certify.graph_replays")
           if x.is_cuda else chordal._eager(step))
    done = -1
    while done < 0:
        run(REFINE_BLOCK)
        done = trace.read("certify.refine", torch.where(active, -1, k))
    Sx = mv_rows(x[None])[0]
    theta = torch.dot(x, Sx)
    theta_h, res_h = trace.fetch("certify.refine", torch.stack(
        [theta, torch.linalg.vector_norm(Sx - theta * x)])).tolist()
    return theta_h, x, res_h, done


class CertificateResult(NamedTuple):
    certified: bool
    lambda_min: float  # point estimate: min over both subspaces
    lambda_min_lower: float  # rigorous lower bound on lambda_min(S)
    eigvec: np.ndarray  # (n, dh) unit vector: most-negative direction found
    stationarity: float  # ||X S||_F at the tested point
    eig_residual: float  # residual of the deflated Ritz pair
    ritz: float = math.nan  # the deflated Ritz value, eigvec's
    lanczos_steps: int = 0  # Lanczos steps run
    refine_iters: int = 0  # LOBPCG iterations run


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
    torch.Generator seeded with `seed`.

    Counts each call under trace.COUNTS "certify.calls", its Lanczos steps
    under "certify.lanczos_steps" and its LOBPCG iterations under
    "certify.refine_iters"; its three parts are the spans certify.lanczos
    (the deflation basis, the Lanczos run and its Ritz pair),
    certify.refine and certify.bound."""
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

    def mv_rows(W):
        # rows (c, m) -> their S-action, one certificate_matvec with k = c
        c = W.shape[0]
        return certificate_matvec(
            qd, Lam, W.reshape(c, n, dh).transpose(0, 1)).transpose(0, 1) \
            .reshape(c, m)

    def mv(w):
        return mv_rows(w[None])[0]

    with trace.span("certify.lanczos"):
        # deflation basis: the rows of X and the translation-gauge vector
        gauge = np.zeros((1, n, dh))
        gauge[0, :, d] = 1.0
        raw = np.concatenate(
            [trace.fetch("certify", X).astype(np.float64).transpose(1, 0, 2)
             .reshape(r, m), gauge.reshape(1, m)], axis=0)
        _u, sv, Vt = np.linalg.svd(raw, full_matrices=False)
        B = torch.as_tensor(Vt[sv > 1e-6 * sv[0]], device=dev).to(dt)  # (q, m)
        q = B.shape[0]
        k = steps = int(min(k, m - q))

        def defl_t(w):
            return w - B.T @ (B @ w)

        def defl_rows(W):
            return W - (W @ B.T) @ B

        def mv_defl(w):
            return defl_t(mv(defl_t(w)))

        if v0 is None:
            v0 = _start_vector(m, seed)
        v0 = defl_t(torch.as_tensor(np.array(v0) if not torch.is_tensor(v0)
                                    else v0).to(device=dev, dtype=dt))
        alpha, beta, V = _lanczos(mv_defl, v0, k)
        alpha = trace.fetch("certify", alpha).astype(np.float64)
        beta = trace.fetch("certify", beta).astype(np.float64)
        # Lanczos breakdown (an invariant subspace): truncate at the first
        # tiny beta, else the zero rows of T contribute spurious 0
        # eigenvalues
        small = np.nonzero(beta < 1e-10)[0]
        if small.size:
            k = int(small[0]) + 1
            alpha, beta = alpha[:k], beta[:k]
        T = np.diag(alpha)
        off = beta[: k - 1]
        T += np.diag(off, 1) + np.diag(off, -1)
        evals, evecs = np.linalg.eigh(T)
        lam_defl = float(evals[0])
        v = trace.fetch("certify", V[:k]).astype(np.float64).T @ evecs[:, 0]
        v /= np.linalg.norm(v)
        v_dev = torch.as_tensor(v, device=dev).to(dt)
        res = trace.read("certify", torch.linalg.vector_norm(
            mv_defl(v_dev) - lam_defl * v_dev))

    res_target = max(0.1 * eta, 1e-10)
    refined = 0
    if res > res_target and refine_iters > 0:
        def prec(w):
            return quadratic.precond_solve(qd, w.reshape(n, 1, dh)).reshape(m)

        with trace.span("certify.refine"):
            lam_r, v_r, res_r, refined = _refine_min(
                lambda W: defl_rows(mv_rows(defl_rows(W))), prec, defl_t,
                v_dev, iters=refine_iters, tol=res_target)
            if lam_r - res_r > lam_defl - res:  # keep the better bound
                lam_defl, res = lam_r, res_r
                v = trace.fetch("certify", v_r).astype(np.float64)

    with trace.span("certify.bound"):
        # the q x q restriction and the coupling block: one
        # certificate_matvec with k = q
        SBt = mv_rows(B)
        M_B = trace.fetch("certify", B @ SBt.T).astype(np.float64)
        M_B = 0.5 * (M_B + M_B.T)
        lam_B = float(np.linalg.eigvalsh(M_B)[0]) if q else np.inf
        PSB = trace.fetch("certify", SBt - (SBt @ B.T) @ B).astype(np.float64)
        coupling = float(np.linalg.norm(PSB, 2)) if q else 0.0

        lam_est = min(lam_defl, lam_B)
        lam_lower = min(lam_B, lam_defl - res) - coupling
        stat = trace.read("certify", stationarity_gap(qd, X, Lam))
    trace.COUNTS["certify.calls"] += 1
    trace.COUNTS["certify.lanczos_steps"] += steps
    trace.COUNTS["certify.refine_iters"] += refined
    return CertificateResult(
        certified=bool(lam_lower >= -eta), lambda_min=lam_est,
        lambda_min_lower=lam_lower, eigvec=v.reshape(n, dh),
        stationarity=stat, eig_residual=res, ritz=lam_defl,
        lanczos_steps=steps, refine_iters=refined,
    )


@highest
def lift_and_escape(X: torch.Tensor, eigvec: np.ndarray, lambda_min: float,
                    qd_next: quadratic.QuadraticData,
                    max_backtracks: int = 20) -> torch.Tensor:
    """Rank lift r -> r + 1 along the negative-curvature direction:
    X+ = project([X; eps v^T]) with eps halved until the cost at rank r + 1
    (qd_next) strictly decreases (SE-Sync's staircase escape); where no
    step decreases it, the plain lift, whose cost equals the old one.
    Counts each call under trace.COUNTS "certify.escapes"."""
    trace.COUNTS["certify.escapes"] += 1
    n, r, dh = X.shape
    v = torch.as_tensor(np.asarray(eigvec), device=X.device).to(
        X.dtype).reshape(n, 1, dh)
    X_pad = torch.cat([X, X.new_zeros((n, 1, dh))], dim=1)
    f0 = trace.read("certify", quadratic.cost(qd_next, X_pad))
    eps = 1.0
    for _ in range(max_backtracks):
        Xl = X_pad.clone()
        Xl[:, r:r + 1, :] += eps * v
        Xp = lifted.project_lifted(Xl)
        if trace.read("certify", quadratic.cost(qd_next, Xp)) < f0 - 1e-15:
            return Xp
        eps *= 0.5
    return X_pad


def _central_problem(measurements, device):
    if isinstance(measurements, EdgeArrays):
        edges = measurements
        d = edges.d
        n = int(max(edges.p1.max(), edges.p2.max())) + 1
    else:
        d, n = num_poses_and_dim(measurements)
        edges = EdgeArrays.from_measurements(measurements)
    return d, n, quadratic.from_private_measurements(edges, n=n, d=d,
                                                     device=device)


def quadratic_data(problem: quadratic.LocalProblem, r: int,
                   precond: str = "jacobi") -> quadratic.QuadraticData:
    """The centralized problem's quadratic data at rank r: no neighbors, so
    a zero linear term. precond: build_q_data's choices."""
    dev, dt = problem.priv_T.device, problem.priv_T.dtype
    return quadratic.build_quadratic_data(
        problem, torch.zeros((1, r, problem.d + 1), dtype=dt, device=dev),
        r=r, precond=precond)


def _at_rank(qd: quadratic.QuadraticData, r: int) -> quadratic.QuadraticData:
    """qd at rank r: the centralized data differ between ranks only by the
    shape of their zero linear term."""
    return dataclasses.replace(qd, G=qd.G.new_zeros((qd.n, r, qd.d + 1)))


# SE-Sync's float64 polish before the certificate: its coupling term scales
# with the gradient norm (scripts/torch_certify_scale.py)
POLISH = dict(gradnorm_tol=1e-6, initial_radius=1.0, max_iterations=100,
              max_inner=500)


def polish(qd: quadratic.QuadraticData, X: torch.Tensor,
           dtype: Optional[torch.dtype] = None, **settings):
    """Stage (b) of solve_certified: rtr_solve of X on qd in `dtype` (X's
    by default), tCG included, with POLISH's settings unless `settings`
    replace them. Returns (X in `dtype`, RTRStats)."""
    dtype = X.dtype if dtype is None else dtype
    return rtr.rtr_solve(qd.to(dtype), X.to(dtype),
                         **dict(POLISH, **settings))


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
    set (a sequence of measurements or their EdgeArrays): the entry point
    for distributed solutions (assemble the team's global iterate first,
    e.g. spmd.assemble_global), an offline verification step as in
    SE-Sync. The quadratic data takes `precond`
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
    return min_eig_certificate(quadratic_data(problem, r, precond), X, k=k,
                               eta=eta, refine_iters=refine_iters, v0=v0)


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
        return quadratic_data(problem, r)

    if r0 == d:
        X = T0
    else:
        Y = lifted.fixed_stiefel_variable(d, r0, device=device)
        X = torch.einsum("rd,nde->nre", Y, T0)

    history = []
    r = r0
    while True:
        qd = qd_at(r)
        X, stats = rtr.rtr_solve(
            qd, X, gradnorm_tol=gradnorm_tol, initial_radius=100.0,
            max_iterations=max_iterations, max_inner=max_inner)
        cert = min_eig_certificate(qd, X, k=lanczos_k, eta=eta)
        rec = {"r": r, "cost": 2 * trace.read("certify", stats.f_opt),
               "gradnorm": trace.read("certify", stats.gnorm_opt),
               "lambda_min": cert.lambda_min, "certified": cert.certified}
        history.append(rec)
        if verbose:
            print(f"staircase r={r}: cost={rec['cost']:.6f} "
                  f"gn={rec['gradnorm']:.2e} "
                  f"lambda_min={cert.lambda_min:.3e} "
                  f"certified={cert.certified}", flush=True)
        if cert.certified or r >= r_max:
            return StaircaseResult(
                X=trace.fetch("certify", X), r=r, certified=cert.certified,
                lambda_min=cert.lambda_min, cost=rec["cost"],
                gradnorm=rec["gradnorm"], history=tuple(history))
        X = lift_and_escape(X, cert.eigvec, cert.lambda_min, qd_at(r + 1))
        r += 1


# solve_certified's stages as the benchmark's sesync-cert configuration runs
# them (chip_smoke.SOLVE's centralized solve, then POLISH and the
# certificate of scripts/torch_certify_scale.py)
CHORDAL = dict(tol=1e-6, maxiter=1000)
RTR = dict(gradnorm_tol=1e-2, initial_radius=100.0, max_iterations=100,
           max_inner=200)
CERTIFICATE = dict(k=64, eta=1e-6, refine_iters=400, precond="auto")
PRECISION = dict(iterate=torch.float64, tcg=torch.float32,
                 chordal_cg=torch.float32, polish=torch.float64,
                 certificate=torch.float64)


class CertifiedSolve(NamedTuple):
    X: torch.Tensor  # (n, r, d+1) final iterate, on the device
    r: int
    certificate: CertificateResult  # the final rank's
    stages: tuple  # per rank: {"r", "rtr": RTRStats, "polish": RTRStats,
    #                "certificate": CertificateResult}
    escapes: int


@highest
def solve_certified(
    edges: EdgeArrays,
    n: int,
    d: int,
    X0: Optional[torch.Tensor] = None,
    r0: int = 5,
    r_max: int = 10,
    precision: Optional[dict] = None,
    chordal_settings: Optional[dict] = None,
    precond: str = "jacobi",
    csr_min_edges: int = 4096,
    rtr_settings: Optional[dict] = None,
    polish_settings: Optional[dict] = None,
    certificate: Optional[dict] = None,
    spans: Callable = trace.span,
    device=None,
) -> CertifiedSolve:
    """SE-Sync's certified centralized solve of the graph `edges` (n poses
    in dimension d): the Riemannian staircase from rank r0 (module
    docstring). Each rank runs (a) rtr_solve with rtr_settings (RTR by
    default) over the quadratic data with `precond` and CSR plans from
    csr_min_edges gather-path edges, its tCG in precision["tcg"]; (b)
    polish with polish_settings (POLISH); (c) min_eig_certificate with
    `certificate`'s settings (CERTIFICATE) over the data with its
    "precond"; (d) where not certified and r < r_max,
    lift_and_escape to r + 1. Starts from the chordal initialization
    (chordal_settings: CHORDAL, its PCG in precision["chordal_cg"]) lifted
    to r0, or from the rank-r iterate X0 (then r0 = r).

    precision: PRECISION's keys, any of them replaced: "iterate" the
    problem, the trust-region control and the iterate between stages;
    "polish" and "certificate" their stages' whole arithmetic.

    spans: a factory of context managers by name (trace.span by default)
    that opens the stages certify.solve > certify.plan, certify.chordal,
    certify.rtr, certify.polish, certify.certificate and certify.escape;
    a caller may pass its own. Counts the solve under trace.COUNTS
    "certify.solves". The result's certificate holds the verdict, the
    deflated Ritz pair with its residual and the stationarity that the
    certificate read anyway: no host read is added for them.

    device: None (the default) solves on the CUDA card and raises where
    there is none."""
    device = devices.resolve(device, "solve_certified")
    prec = dict(PRECISION, **(precision or {}))
    dt = prec["iterate"]
    cert_settings = dict(CERTIFICATE, **(certificate or {}))
    cert_precond = cert_settings.pop("precond")
    trace.COUNTS["certify.solves"] += 1
    with spans("certify.solve"):
        with spans("certify.plan"):
            problem = quadratic.from_private_measurements(
                edges, n=n, d=d, dtype=dt, device=device)
        if X0 is None:
            with spans("certify.chordal"):
                T = chordal.chordal_initialization_arrays(
                    edges, n=n, dtype=dt, cg_dtype=prec["chordal_cg"],
                    device=device, **dict(CHORDAL, **(chordal_settings or {})))
                X = torch.einsum("rd,nde->nre", lifted.fixed_stiefel_variable(
                    d, r0, device=device, dtype=dt), T)
        else:
            X = X0.to(device=device, dtype=dt)
        r = X.shape[1]
        with spans("certify.plan"):
            qd = quadratic.attach_csr_plans(
                quadratic_data(problem, r, precond), min_edges=csr_min_edges)
            qd_cert = quadratic_data(problem, r, cert_precond)
        stages = []
        while True:
            with spans("certify.rtr"):
                X, st_rtr = rtr.rtr_solve(
                    qd, X, inner_dtype=prec["tcg"],
                    **dict(RTR, **(rtr_settings or {})))
            with spans("certify.polish"):
                X, st_polish = polish(qd, X, prec["polish"],
                                      **(polish_settings or {}))
                X = X.to(dt)
            with spans("certify.certificate"):
                cert = min_eig_certificate(
                    qd_cert.to(prec["certificate"]),
                    X.to(prec["certificate"]), **cert_settings)
            stages.append({"r": r, "rtr": st_rtr, "polish": st_polish,
                           "certificate": cert})
            if cert.certified or r >= r_max:
                return CertifiedSolve(X=X, r=r, certificate=cert,
                                      stages=tuple(stages),
                                      escapes=len(stages) - 1)
            with spans("certify.escape"):
                qd, qd_cert = _at_rank(qd, r + 1), _at_rank(qd_cert, r + 1)
                X = lift_and_escape(X, cert.eigvec, cert.lambda_min, qd)
            r += 1

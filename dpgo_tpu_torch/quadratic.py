"""The lifted PGO quadratic problem  f(X) = 0.5 <X Q, X> + <X, G>.

The counterpart of dpgo_tpu/quadratic.py (reference: PoseGraph.cpp:381-613,
QuadraticProblem.cpp:29-83). Q is never materialized as a scalar sparse
matrix; it keeps its (d+1)x(d+1) block structure. With the block incidence
A and Omega_k = diag(w*kappa ... w*kappa, w*tau), per edge k (i -> j):

    Q_ii += T_k Omega_k T_k^T      Q_ij += -T_k Omega_k = -E_k
    Q_jj += Omega_k                Q_ji += -E_k^T

The Hessian-vector product (V Q), the innermost op of every tCG iteration,
is one batched (r,dh)x(dh,dh) product against the diagonal blocks, plus
shifted batched products for the edges on planned band lanes, plus a
gather / per-edge product / scatter-add for the remaining edges. With CSR
plans attached and float32 input, that gather-path term is one fused
gather-multiply-reduce over the destination-sorted edges, ops/edge_matvec.py
(the hand-written CUDA kernel on the card).

The preconditioner of (Q + shift I) is block-Jacobi, the cyclic-reduction
factor of its block-tridiagonal part, or the exact banded factor
(ops/block_tridiag.py). The residual form (build_residual_data,
cost_grad_residual) is not ported yet.

Batches of independent problems: the SPMD engine stacks its agents' poses
into one problem of A*n rows (block_rows = n, edges never leave a block) and
hands the solver (A, n, r, dh) tensors; q_matvec and precond_solve take any
leading shape over the same rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dpgo_tpu_torch.devices import highest
from dpgo_tpu_torch.ops import block_tridiag, edge_matvec, lifted, segsum
from dpgo_tpu_torch.types import PRECONDITIONER_SHIFT, PRIOR_KAPPA, PRIOR_TAU


# ---------------------------------------------------------------------------
# Problem data
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LocalProblem:
    """Static-shaped tensors describing one agent's local pose graph.

    Private edges (odometry + private loop closures) have both endpoints
    local. Shared edges reference one local pose (`shared_idx`) and one
    neighbor pose held in an external buffer at `shared_nbr_slot`;
    `shared_outgoing` marks edges whose tail is local and `shared_mask`
    zeroes edges whose neighbor is unavailable (reference:
    PoseGraph.cpp:412-458). Index tensors are int64.

    Band lanes: the first num_band private edges each have
    j - i == band_offsets[priv_lane[k]], and their matvec contributions are
    shifted dense batched products instead of gather/scatter (see plan_bands
    and q_matvec).
    """

    n: int
    d: int
    priv_i: torch.Tensor  # (mp,)
    priv_j: torch.Tensor
    priv_T: torch.Tensor  # (mp, dh, dh)
    priv_kappa: torch.Tensor
    priv_tau: torch.Tensor
    priv_weight: torch.Tensor
    shared_idx: torch.Tensor  # (ms,)
    shared_T: torch.Tensor  # (ms, dh, dh)
    shared_kappa: torch.Tensor
    shared_tau: torch.Tensor
    shared_weight: torch.Tensor
    shared_outgoing: torch.Tensor  # bool
    shared_nbr_slot: torch.Tensor  # into the neighbor-pose buffer
    shared_mask: torch.Tensor  # float multiplier in {0, 1}
    prior_idx: torch.Tensor  # (npr,)
    prior_pose: torch.Tensor  # (npr, r, dh)
    prior_mask: torch.Tensor
    priv_lane: Optional[torch.Tensor] = None  # (mp,)
    num_band: int = 0
    band_offsets: tuple = ()

    @property
    def dh(self) -> int:
        return self.d + 1

    @property
    def num_private(self) -> int:
        return int(self.priv_i.shape[0])

    @property
    def num_shared(self) -> int:
        return int(self.shared_idx.shape[0])


@dataclasses.dataclass(frozen=True)
class CSRPlans:
    """Sorted-edge plans for the fused edge term of q_matvec: the gather-path
    edge data pre-permuted into destination-sorted order for each scatter
    direction (make_csr_plans)."""

    src_by_j: torch.Tensor  # (mp,) gather index for the ->j contribution
    E_by_j: torch.Tensor  # (mp, dh, dh) edge blocks in j-sorted order
    dst_by_i: torch.Tensor  # (mp,) gather index for the ->i contribution
    E_by_i: torch.Tensor  # (mp, dh, dh) edge blocks in i-sorted order
    plan_i: segsum.SegsumPlan
    plan_j: segsum.SegsumPlan


@dataclasses.dataclass(frozen=True)
class QuadraticData:
    """Assembled data matrices of f(X) = 0.5 <X Q, X> + <X, G>.

    diag        : (n, dh, dh) diagonal blocks of Q
    off_i/off_j : (mp,) endpoints of the gather-path private edges
    off_E       : (mp, dh, dh) with Q_ij = -E_k, Q_ji = -E_k^T
    G           : (n, r, dh) linear term; (A, n/A, r, dh) for a batch
    precond_inv : (n, dh, dh) inverses of the block-Jacobi preconditioner
                  blocks (Q_ii + shift I) (reference: PoseGraph.cpp:598-613,
                  with the full LDL^T relaxed to its block diagonal); empty
                  when a factor replaces them
    band_E      : (L, n, dh, dh) band-lane blocks — lane l holds the merged
                  E blocks of edges (i, i + band_offsets[l]) at row i — or
                  None without a band plan
    csr         : optional CSRPlans (attach_csr_plans)
    btf         : optional factor of (Q + shift I) that precond_solve uses
                  instead of precond_inv: a block_tridiag.CRFactor of the
                  block-tridiagonal part ('tridiag') or a BandedFactor
                  ('banded'), batched over the blocks of a batch
    block_rows  : rows per independent block of a batch (0: one block); the
                  band lanes never reach across a block
    """

    n: int
    d: int
    diag: torch.Tensor
    off_i: torch.Tensor
    off_j: torch.Tensor
    off_E: torch.Tensor
    G: torch.Tensor
    precond_inv: torch.Tensor
    band_E: Optional[torch.Tensor] = None
    csr: Optional[CSRPlans] = None
    band_offsets: tuple = ()
    btf: Optional[object] = None
    block_rows: int = 0

    def to(self, dtype: torch.dtype) -> "QuadraticData":
        """Cast every floating tensor, the CSR plans' edge blocks and the
        preconditioner's factor included, to `dtype` (index tensors keep
        theirs). The mixed-precision solve runs its tCG on such a copy."""
        cast = lambda t: None if t is None else t.to(dtype)  # noqa: E731
        csr = self.csr
        if csr is not None:
            csr = dataclasses.replace(
                csr, E_by_j=cast(csr.E_by_j), E_by_i=cast(csr.E_by_i)
            )
        return dataclasses.replace(
            self, diag=cast(self.diag), off_E=cast(self.off_E),
            G=cast(self.G), precond_inv=cast(self.precond_inv),
            band_E=cast(self.band_E), csr=csr,
            btf=None if self.btf is None else self.btf.to(dtype),
        )


# ---------------------------------------------------------------------------
# Assembly
# ---------------------------------------------------------------------------

def _omega(kappa, tau, weight, d: int) -> torch.Tensor:
    """Per-edge weight diagonal diag(w k, ..., w k, w t): (m, dh)."""
    wk = (weight * kappa)[:, None].expand(-1, d)
    wt = (weight * tau)[:, None]
    return torch.cat([wk, wt], dim=1)


def _prior_omega(problem: LocalProblem, dtype) -> torch.Tensor:
    npr, d = problem.prior_idx.shape[0], problem.d
    dev = problem.prior_mask.device
    om = torch.cat(
        [torch.full((npr, d), PRIOR_KAPPA, dtype=dtype, device=dev),
         torch.full((npr, 1), PRIOR_TAU, dtype=dtype, device=dev)],
        dim=1,
    )
    return om * problem.prior_mask[:, None]


def build_quadratic_data(
    problem: LocalProblem,
    nbr_poses: torch.Tensor,
    r: int,
    precond_shift: float = PRECONDITIONER_SHIFT,
    precond: str = "jacobi",
) -> QuadraticData:
    """Assemble Q blocks, linear term G and the preconditioner
    (reference: PoseGraph.cpp:381-580): build_q_data + build_linear_term.

    nbr_poses: (p, r, dh) buffer of neighbor public poses indexed by
    `shared_nbr_slot`."""
    qd = build_q_data(problem, r, precond_shift=precond_shift, precond=precond)
    return dataclasses.replace(qd, G=build_linear_term(problem, nbr_poses, r))


def build_q_data(
    problem: LocalProblem,
    r: int,
    precond_shift: float = PRECONDITIONER_SHIFT,
    precond: str = "jacobi",
) -> QuadraticData:
    """Assemble the neighbor-pose-independent data: Q blocks and the
    preconditioner of (Q + shift I) (reference: PoseGraph.cpp:381-491,
    598-613). G = 0.

    precond: 'jacobi' (block inverses, one batched product per apply),
    'tridiag' (cyclic-reduction factor of the odometry lane's coupling plus
    every diagonal block; needs the offset-1 lane, else block-Jacobi),
    'banded' (the exact RCM banded factor, Cholmod-LDL^T parity; where the
    relabeled bandwidth is too large it falls back to 'tridiag' for chains
    of at most 5,000 poses and to 'jacobi' above), or 'auto' ('banded' for
    n > 1). These are the choices of dpgo_tpu.quadratic.build_q_data on
    concrete edge indices; the SPMD engine resolves its own
    (parallel/spmd.py)."""
    if precond not in ("jacobi", "tridiag", "banded", "auto"):
        raise ValueError(f"unknown preconditioner {precond!r}")
    n, d, dh = problem.n, problem.d, problem.d + 1
    dtype, dev = problem.priv_T.dtype, problem.priv_T.device

    # --- private edges ---
    om_p = _omega(problem.priv_kappa, problem.priv_tau, problem.priv_weight, d)
    E = problem.priv_T * om_p[:, None, :]  # T @ diag(om): column scaling
    W = E @ problem.priv_T.transpose(-1, -2)  # E @ T^T

    diag = torch.zeros((n, dh, dh), dtype=dtype, device=dev)
    diag.index_add_(0, problem.priv_i, W)
    diag.index_add_(0, problem.priv_j, torch.diag_embed(om_p))

    # band lanes: dense (L, n, dh, dh) blocks; the remaining edges go through
    # the gather/scatter path
    nb = problem.num_band
    offs = tuple(problem.band_offsets)
    if nb > 0 and n > 1 and offs:
        L = len(offs)
        flat = problem.priv_lane[:nb] * n + problem.priv_i[:nb]
        band_E = (
            torch.zeros((L * n, dh, dh), dtype=dtype, device=dev)
            .index_add_(0, flat, E[:nb])
            .reshape(L, n, dh, dh)
        )
        off_i, off_j, off_E = problem.priv_i[nb:], problem.priv_j[nb:], E[nb:]
    else:
        band_E = None
        offs = ()
        off_i, off_j, off_E = problem.priv_i, problem.priv_j, E

    # --- shared edges (diagonal contributions) ---
    om_s = _omega(
        problem.shared_kappa, problem.shared_tau, problem.shared_weight, d
    ) * problem.shared_mask[:, None]
    Es = problem.shared_T * om_s[:, None, :]
    Ws = Es @ problem.shared_T.transpose(-1, -2)
    out_f = problem.shared_outgoing[:, None, None].to(dtype)
    diag.index_add_(
        0, problem.shared_idx, out_f * Ws + (1.0 - out_f) * torch.diag_embed(om_s)
    )

    # --- priors (diagonal) ---
    if problem.prior_idx.shape[0] > 0:
        diag.index_add_(
            0, problem.prior_idx, torch.diag_embed(_prior_omega(problem, dtype))
        )

    # --- preconditioner of (Q + shift I) ---
    eye = torch.eye(dh, dtype=dtype, device=dev)
    shifted = diag + precond_shift * eye
    if precond == "auto":
        precond = "banded" if n > 1 else "jacobi"
    btf = None
    if precond == "banded":
        plan = block_tridiag.make_banded_plan(
            problem.priv_i.cpu().numpy(), problem.priv_j.cpu().numpy(), n, dh)
        if plan is not None:
            btf = block_tridiag.build_banded_factor(plan, shifted, E)
        else:
            precond = "tridiag" if tridiag_fits(offs, n) else "jacobi"
    if btf is None and precond == "tridiag" and 1 in offs and n > 1:
        # the offset-1 lane is the odometry chain; the other lanes' edges
        # still strengthen the factor through their diagonal blocks
        btf = block_tridiag.factorize(shifted, band_E[offs.index(1), : n - 1])
    if btf is None:
        Lc = torch.linalg.cholesky(shifted)
        precond_inv = torch.cholesky_solve(eye.expand(n, dh, dh), Lc)
    else:
        precond_inv = shifted.new_zeros((0, dh, dh))

    return QuadraticData(
        n=n, d=d, diag=diag,
        off_i=off_i, off_j=off_j, off_E=off_E,
        G=torch.zeros((n, r, dh), dtype=dtype, device=dev),
        precond_inv=precond_inv, band_E=band_E, csr=None, band_offsets=offs,
        btf=btf,
    )


def tridiag_fits(offsets: tuple, n: int) -> bool:
    """The size policy of the tridiagonal factor where the exact one is not
    taken: the planned band lanes (offsets, () without any) include the
    odometry lane, and the chain is short enough (<= 5,000 poses) for the
    O(log n)-depth solve to pay for itself."""
    return 1 in offsets and 1 < n <= 5_000


def build_linear_term(
    problem: LocalProblem, nbr_poses: torch.Tensor, r: int
) -> torch.Tensor:
    """The neighbor-pose-dependent linear term G (reference: constructG,
    PoseGraph.cpp:493-580)."""
    n, d, dh = problem.n, problem.d, problem.d + 1
    dtype, dev = problem.priv_T.dtype, problem.priv_T.device
    G = torch.zeros((n, r, dh), dtype=dtype, device=dev)
    if problem.num_shared > 0:
        om_s = _omega(
            problem.shared_kappa, problem.shared_tau, problem.shared_weight, d
        ) * problem.shared_mask[:, None]
        Es = problem.shared_T * om_s[:, None, :]
        Xnbr = nbr_poses[problem.shared_nbr_slot]  # (ms, r, dh)
        # outgoing edge (tail local):  G_i += -X_j Omega T^T = -X_j E^T
        # incoming edge (head local):  G_j += -X_i T Omega   = -X_i E
        contrib_out = -(Xnbr @ Es.transpose(-1, -2))
        contrib_in = -(Xnbr @ Es)
        contrib = torch.where(
            problem.shared_outgoing[:, None, None], contrib_out, contrib_in
        )
        G.index_add_(0, problem.shared_idx, contrib)
    if problem.prior_idx.shape[0] > 0:
        om_prior = _prior_omega(problem, dtype)
        G.index_add_(
            0, problem.prior_idx, -problem.prior_pose * om_prior[:, None, :]
        )
    return G


# ---------------------------------------------------------------------------
# Operator evaluations (reference: QuadraticProblem.cpp:29-83)
# ---------------------------------------------------------------------------

def q_matvec(qd: QuadraticData, V: torch.Tensor) -> torch.Tensor:
    """(V Q) in block form: out_j = sum_i V_i Q_ij. V: (n, r, dh), or any
    leading shape over the n rows (a batch's (A, n/A, r, dh)).

    Gathers and scatters run on flattened (n, r*dh) rows. With CSR plans
    attached and float32 V, the whole gather-path edge term is one fused
    gather-multiply-reduce (ops/edge_matvec.py)."""
    shape = V.shape
    r, dh = shape[-2], shape[-1]
    V = V.reshape(-1, r, dh)
    n = V.shape[0]
    out = V @ qd.diag
    if qd.band_E is not None:
        # Band lanes, fused across all offsets: lane l holds the E blocks of
        # edges (i, i + delta_l) at row i (zeros elsewhere).
        L = len(qd.band_offsets)
        offs = torch.tensor(qd.band_offsets, dtype=torch.int64, device=V.device)
        iota = torch.arange(n, device=V.device)
        # row within its block, and the block's first row
        blk = qd.block_rows or n
        loc = iota % blk
        base = iota - loc
        # tail side: out[i] -= sum_l V[i + delta_l] @ E[l, i]^T. Offsets may
        # be negative (backward edges stay on their lane un-flipped: the
        # lifted translation cost is not invariant under edge reversal).
        # Rows whose i + delta_l falls outside their block have zero E
        # blocks, so the clipped gather's garbage is annihilated.
        up = torch.clamp(loc[None, :] + offs[:, None], 0, blk - 1) + base
        Vs = V[up.reshape(-1)].reshape(L, n, r, dh)
        out = out - (Vs @ qd.band_E.transpose(-1, -2)).sum(dim=0)
        # head side: out[j] -= sum_l (V @ E)[l, j - delta_l]; j - delta_l
        # outside its block gathers the appended zero row.
        C = (V[None] @ qd.band_E).reshape(L * n, r, dh)
        C = torch.cat([C, C.new_zeros((1, r, dh))])
        down = loc[None, :] - offs[:, None]  # (L, n)
        flat = torch.where(
            (down >= 0) & (down < blk),
            torch.arange(L, device=V.device)[:, None] * n + base + down,
            L * n,
        )
        out = out - C[flat.reshape(-1)].reshape(L, n, r, dh).sum(dim=0)
    m = qd.off_E.shape[0]
    if m == 0:
        return out.reshape(shape)
    Vf = V.reshape(n, r * dh)
    outf = out.reshape(n, r * dh)
    if qd.csr is not None and V.dtype == torch.float32:
        # `out` is fresh here, so the fused edge op may update it in place
        edge_matvec.edge_matvec(outf, Vf.contiguous(), qd.csr)
        return out.reshape(shape)
    Vi = Vf[qd.off_i].reshape(m, r, dh)
    Vj = Vf[qd.off_j].reshape(m, r, dh)
    ci = (Vi @ qd.off_E).reshape(m, r * dh)
    cj = (Vj @ qd.off_E.transpose(-1, -2)).reshape(m, r * dh)
    outf.index_add_(0, qd.off_j, ci, alpha=-1)
    outf.index_add_(0, qd.off_i, cj, alpha=-1)
    return outf.reshape(shape)


def make_csr_plans(off_i, off_j, off_E, n: int) -> CSRPlans:
    """Host side: sort the edges (off_i -> off_j, blocks off_E) by each
    scatter destination (stable, so ties keep edge order) and build the CSR
    plans on off_E's device."""
    dev = off_E.device
    i_np = off_i.cpu().numpy()
    j_np = off_j.cpu().numpy()
    perm_j = np.argsort(j_np, kind="stable")
    perm_i = np.argsort(i_np, kind="stable")
    pj = torch.as_tensor(perm_j, device=dev)
    pi = torch.as_tensor(perm_i, device=dev)
    return CSRPlans(
        src_by_j=off_i[pj],
        E_by_j=off_E[pj],
        dst_by_i=off_j[pi],
        E_by_i=off_E[pi],
        plan_j=segsum.make_segsum_plan(j_np[perm_j], n, device=dev),
        plan_i=segsum.make_segsum_plan(i_np[perm_i], n, device=dev),
    )


def attach_csr_plans(qd: QuadraticData, min_edges: int = 4096) -> QuadraticData:
    """Host side: attach the CSR plans of the gather-path edges
    (make_csr_plans), used by q_matvec on float32 input.

    A no-op below `min_edges` gather-path edges (the threshold of the JAX
    package). Unlike the JAX package this attaches on every device: on the
    CPU the plans route through the plain version, so the CPU tests run the
    same code path as the card. `min_edges` lets small tests force it."""
    if qd.off_E.shape[0] < min_edges:
        return qd
    csr = make_csr_plans(qd.off_i, qd.off_j, qd.off_E, qd.n)
    return dataclasses.replace(qd, csr=csr)


def cost(qd: QuadraticData, X: torch.Tensor) -> torch.Tensor:
    """f(X) = 0.5 <X Q, X> + <X, G> (reference: QuadraticProblem.cpp:29-41)."""
    return 0.5 * lifted.inner(q_matvec(qd, X), X) + lifted.inner(X, qd.G)


def euc_grad(qd: QuadraticData, X: torch.Tensor) -> torch.Tensor:
    """Euclidean gradient X Q + G (reference: QuadraticProblem.cpp:43-47)."""
    return q_matvec(qd, X) + qd.G


def rie_grad(qd: QuadraticData, X: torch.Tensor) -> torch.Tensor:
    """Riemannian gradient: tangent projection of the Euclidean gradient
    (reference: QuadraticProblem.cpp:71-79)."""
    return lifted.proj_tangent(X, euc_grad(qd, X))


def rie_grad_norm(qd: QuadraticData, X: torch.Tensor) -> torch.Tensor:
    return lifted.norm(rie_grad(qd, X))


def rie_hess_vec(
    qd: QuadraticData, X: torch.Tensor, S: torch.Tensor, V: torch.Tensor
) -> torch.Tensor:
    """Riemannian Hessian action on the embedded product manifold: for a
    Stiefel block with S_i = sym(Y_i^T g_i), Hess[eta]_i =
    P_Y((eta Q)_i - eta_i S_i); the translation factor is Euclidean.
    S comes once per outer RTR iteration from hess_correction."""
    HV = q_matvec(qd, V)
    corr = lifted.rotations(V) @ S
    Hrot = lifted.stiefel_proj_tangent(
        lifted.rotations(X), lifted.rotations(HV) - corr
    )
    return lifted.assemble(Hrot, lifted.translations(HV))


@highest
def hess_correction(X: torch.Tensor, eg: torch.Tensor) -> torch.Tensor:
    """S_i = sym(Y_i^T g_i^rot): (n, d, d), the Weingarten correction."""
    YtG = lifted.rotations(X).transpose(-1, -2) @ lifted.rotations(eg)
    return 0.5 * (YtG + YtG.transpose(-1, -2))


def precond_solve(qd: QuadraticData, V: torch.Tensor) -> torch.Tensor:
    """Raw preconditioner solve (no tangent projection): out with out P = V
    for the SPD preconditioner P ~ Q + shift I. With a factor attached, the
    row-vector system P out^T = V^T per pose block (P symmetric); otherwise
    block-Jacobi, one batched product against the symmetric block inverses.
    V: (n, r, dh) or any leading shape over the n rows."""
    if isinstance(qd.btf, block_tridiag.BandedFactor):
        return block_tridiag.solve_banded(qd.btf, V)
    if qd.btf is not None:
        cr = qd.btf
        batch = tuple(cr.root_inv.shape[:-3])
        Vb = V.reshape(batch + (cr.n,) + V.shape[-2:]).transpose(-1, -2)
        return block_tridiag.solve(cr, Vb).transpose(-1, -2).reshape(V.shape)
    r, dh = V.shape[-2], V.shape[-1]
    return (V.reshape(-1, r, dh) @ qd.precond_inv).reshape(V.shape)


def apply_precond(
    qd: QuadraticData, X: torch.Tensor, V: torch.Tensor
) -> torch.Tensor:
    """Preconditioner solve + tangent projection at X (reference:
    QuadraticProblem.cpp:56-69)."""
    return lifted.proj_tangent(X, precond_solve(qd, V))


# ---------------------------------------------------------------------------
# Host-side constructors
# ---------------------------------------------------------------------------

def make_local_problem(
    n: int,
    d: int,
    priv_i,
    priv_j,
    priv_T,
    priv_kappa,
    priv_tau,
    priv_weight,
    shared_idx=None,
    shared_T=None,
    shared_kappa=None,
    shared_tau=None,
    shared_weight=None,
    shared_outgoing=None,
    shared_nbr_slot=None,
    shared_mask=None,
    prior_idx=None,
    prior_pose=None,
    prior_mask=None,
    r: Optional[int] = None,
    dtype=torch.float64,
    *,
    device,
) -> LocalProblem:
    """Build a LocalProblem from host arrays, filling empty defaults."""
    dh = d + 1
    r = d if r is None else r
    idx = torch.int64

    def arr(x, shape, dt=dtype):
        if x is None:
            return torch.zeros(shape, dtype=dt, device=device)
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    ms = 0 if shared_idx is None else len(shared_idx)
    npr = 0 if prior_idx is None else len(prior_idx)
    return LocalProblem(
        n=n,
        d=d,
        priv_lane=torch.zeros((len(priv_i),), dtype=idx, device=device),
        priv_i=arr(priv_i, None, idx),
        priv_j=arr(priv_j, None, idx),
        priv_T=arr(priv_T, None),
        priv_kappa=arr(priv_kappa, None),
        priv_tau=arr(priv_tau, None),
        priv_weight=arr(priv_weight, None),
        shared_idx=arr(shared_idx, (ms,), idx),
        shared_T=arr(shared_T, (ms, dh, dh)),
        shared_kappa=arr(shared_kappa, (ms,)),
        shared_tau=arr(shared_tau, (ms,)),
        shared_weight=arr(shared_weight, (ms,)),
        shared_outgoing=arr(shared_outgoing, (ms,), torch.bool),
        shared_nbr_slot=arr(shared_nbr_slot, (ms,), idx),
        shared_mask=arr(shared_mask, (ms,)),
        prior_idx=arr(prior_idx, (npr,), idx),
        prior_pose=arr(prior_pose, (npr, r, dh)),
        prior_mask=arr(prior_mask, (npr,)),
    )


def choose_band_offsets(
    i_np: np.ndarray,
    j_np: np.ndarray,
    n: int,
    max_lanes: int = 16,
    min_count: Optional[int] = None,
    rows: Optional[int] = None,
) -> tuple:
    """Host side: pick the edge offsets worth a dense band lane, by the cost
    model of dpgo_tpu.quadratic.choose_band_offsets (kept identical, so both
    packages plan the same lanes). A lane costs a dense shifted product over
    all `rows` rows; an edge left on the gather path costs about two lane
    rows, so a lane needs about rows//3 edges — unless the qualifying offsets
    cover every edge within the lane budget, which deletes the gather path
    entirely. The odometry offset 1 is always kept. Returns sorted offsets."""
    if n < 2 or len(i_np) == 0:
        return ()
    if rows is None:
        rows = n
    delta = j_np - i_np
    # negative offsets (backward edges j < i) get their own lane rather than
    # being flipped (see q_matvec)
    valid = (delta != 0) & (np.abs(delta) < n)
    vals, cnts = np.unique(delta[valid], return_counts=True)
    if min_count is None:
        m_total = int(valid.sum())
        if (
            len(vals) > 0
            and len(vals) <= max_lanes
            and rows * len(vals) <= 2 * m_total + 1300
        ):
            min_count = 1
        else:
            min_count = max(16, rows // 3)
    keep = vals[cnts >= min_count]
    kcnt = cnts[cnts >= min_count]
    if len(keep) > max_lanes:
        top = np.argsort(-kcnt)[:max_lanes]
        keep, kcnt = keep[top], kcnt[top]
    if 1 in vals and 1 not in keep:
        if len(keep) >= max_lanes:
            # evict the lowest-count lane
            order = np.argsort(-kcnt)
            keep = np.append(keep[order][: max_lanes - 1], 1)
        else:
            keep = np.append(keep, 1)
    return tuple(int(v) for v in np.sort(keep))


def plan_bands(
    problem: LocalProblem,
    max_lanes: int = 16,
    min_count: Optional[int] = None,
    offsets: Optional[tuple] = None,
) -> LocalProblem:
    """Host side: reorder private edges so banded edges (j - i in a small
    set of common offsets) come first, assign each a lane and record the
    offset set. Pass `offsets` to force a lane set."""
    i_np = problem.priv_i.cpu().numpy()
    j_np = problem.priv_j.cpu().numpy()
    if offsets is None:
        offsets = choose_band_offsets(
            i_np, j_np, problem.n, max_lanes=max_lanes, min_count=min_count
        )
    offsets = tuple(int(o) for o in offsets)
    dev = problem.priv_i.device
    if not offsets:
        return dataclasses.replace(
            problem,
            priv_lane=torch.zeros(i_np.shape, dtype=torch.int64, device=dev),
            num_band=0, band_offsets=(),
        )
    lane_of = {o: k for k, o in enumerate(offsets)}
    lane = np.array([lane_of.get(int(x), -1) for x in j_np - i_np], np.int64)
    banded = lane >= 0
    order = np.concatenate([np.flatnonzero(banded), np.flatnonzero(~banded)])
    o = torch.as_tensor(order, device=dev)
    return dataclasses.replace(
        problem,
        priv_i=problem.priv_i[o],
        priv_j=problem.priv_j[o],
        priv_T=problem.priv_T[o],
        priv_kappa=problem.priv_kappa[o],
        priv_tau=problem.priv_tau[o],
        priv_weight=problem.priv_weight[o],
        priv_lane=torch.as_tensor(np.maximum(lane[order], 0), device=dev),
        num_band=int(banded.sum()),
        band_offsets=offsets,
    )


def from_private_measurements(
    edges, n: int, d: int, dtype=torch.float64, band: bool = True, *, device
) -> LocalProblem:
    """LocalProblem with only private edges, from an EdgeArrays. band=True
    plans dense band lanes for the common edge offsets."""
    from dpgo_tpu_torch.measurements import homogeneous

    T = homogeneous(edges.R, edges.t).astype(np.float64)
    problem = make_local_problem(
        n=n, d=d,
        priv_i=edges.p1, priv_j=edges.p2, priv_T=T,
        priv_kappa=edges.kappa, priv_tau=edges.tau, priv_weight=edges.weight,
        dtype=dtype, device=device,
    )
    return plan_bands(problem) if band else problem

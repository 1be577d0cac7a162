"""Parity of the pieces of dpgo_tpu_torch.parallel.delta (the anchored delta
engine) with dpgo_tpu.parallel.delta, on the CPU.

Both packages get the identical float32 team through
dpgo_tpu_torch.convert.spmd_problem_from_numpy, and the same float64 anchor
(the lifted chordal init, stacked with identity-lifted padding). Teams:
synthesize_grid3d(125) in 4 agents (d = 3: the Newton-Schulz delta polar)
and synthesize_city2d(600) in 3 agents (d = 2: the closed-form polar), at
r = 5. The float64 host pieces agree to 1e-12 relative; the float32 device
pieces to 1e-5 of each quantity's own scale (orthonormality defects: of
the identity's). The run functions are in tests/test_torch_delta_run.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dpgo_tpu import datasets as jd
from dpgo_tpu.ops import lifted as jl
from dpgo_tpu.parallel import delta as jdm
from dpgo_tpu.parallel import spmd as js
from dpgo_tpu.solvers.pgo import chordal_initialization
from dpgo_tpu_torch import convert
from dpgo_tpu_torch import quadratic as tq
from dpgo_tpu_torch.parallel import delta as tdm
from dpgo_tpu_torch.trace import COUNTS

from tests.test_torch_spmd import jax_fields, jax_meta

# name -> (synthesizer, num_poses, d, agents)
CASES = {"grid125": ("grid3d", 125, 3, 4), "city600": ("city2d", 600, 2, 3)}
R = 5


def stack(jp, ranges, X0, d):
    """Global (n, r, dh) -> stacked (N, n_max, r, dh) float64, padded rows
    identity-lifted (initial_state's convention)."""
    Xs = np.zeros((jp.num_agents, jp.n_max, R, d + 1))
    Xs[:] = np.asarray(jl.identity_lifted(jp.n_max, R, d), np.float64)
    for a, (s, e) in enumerate(ranges):
        Xs[a, : e - s] = X0[s:e]
    return Xs


@functools.lru_cache(maxsize=None)
def team(name, dtype="float32"):
    """(JAX problem, port problem, ranges, stacked float64 anchor, edges, n)
    of a case in `dtype`."""
    kind, num, d, A = CASES[name]
    synth = jd.synthesize_grid3d if kind == "grid3d" else jd.synthesize_city2d
    edges, n, _ = synth(num, seed=0)
    meas = edges.to_measurements()
    jp, ranges = js.build_spmd_problem(meas, n, A, R,
                                       dtype=getattr(jnp, dtype))
    T = np.asarray(chordal_initialization(meas))
    X0 = np.einsum("rd,nde->nre", np.asarray(jl.fixed_stiefel_variable(d, R)),
                   T)
    tp = convert.spmd_problem_from_numpy(jax_fields(jp), jax_meta(jp),
                                         device="cpu",
                                         dtype=getattr(torch, dtype))
    return jp, tp, ranges, stack(jp, ranges, X0, d), edges, n


def close(t, j, tol=1e-5, scale=None):
    """max |t - j| <= tol * scale (default: max |j|)."""
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    t, j = t.astype(np.float64), j.astype(np.float64)
    s = float(np.abs(j).max()) if scale is None else scale
    err = float(np.abs(t - j).max()) if t.size else 0.0
    assert err <= tol * max(s, 1e-30), (err, s)


@pytest.mark.parametrize("name", list(CASES))
def test_build_delta_ref_matches_jax(name):
    """build_delta_ref in float64: reference residuals (private and shared)
    and orthonormality defects to 1e-12 relative."""
    jp, tp, _, Xs, _, _ = team(name, "float64")
    jref = jdm.build_delta_ref(jp, Xs, dtype=np.float64)
    tref = tdm.build_delta_ref(tp, Xs, dtype=torch.float64, device="cpu")
    for f in ("X_ref", "res_ref_priv", "res_ref_shared"):
        close(getattr(tref, f), getattr(jref, f), 1e-12)
    close(tref.M_ref, jref.M_ref, 1e-12, scale=1.0)
    st = tdm.initial_delta_state(tref)
    assert st.it == 0 and not bool(st.do_restart)
    assert torch.equal(st.D, torch.zeros_like(tref.X_ref))


@pytest.mark.parametrize("name", list(CASES))
def test_host_certify_matches_jax_and_central(name):
    """host_certify (numpy float64) equals the JAX package's to 1e-12, and
    the central evaluation: cost = 2 quadratic.cost within 1e-10 and the
    gradient norm within 1e-9 (shared edges counted once, backward edges
    included)."""
    jp, tp, ranges, Xs, edges, n = team(name, "float64")
    cj, gj = jdm.host_certify(jp, Xs)
    ct, gt = tdm.host_certify(tp, Xs)
    assert abs(ct - cj) <= 1e-12 * cj and abs(gt - gj) <= 1e-12 * gj
    d = CASES[name][2]
    prob = tq.from_private_measurements(edges, n=n, d=d, device="cpu")
    qd = tq.build_quadratic_data(
        prob, torch.zeros((1, R, d + 1), dtype=torch.float64), r=R)
    X = torch.zeros((n, R, d + 1), dtype=torch.float64)
    for a, (s, e) in enumerate(ranges):
        X[s:e] = torch.as_tensor(Xs[a, : e - s])
    cost_c = 2 * float(tq.cost(qd, X))
    gn_c = float(tq.rie_grad_norm(qd, X))
    assert abs(ct - cost_c) <= 1e-10 * cost_c
    assert abs(gt - gn_c) <= 1e-9 * gn_c


@pytest.mark.parametrize("name", list(CASES))
def test_lanes_usable_matches_jax(name):
    jp, tp, *_ = team(name)
    assert tdm._lanes_usable(tp) == jdm._lanes_usable(jp) is True
    # two positive-weight banded edges in one (lane, i) slot: refused
    lane = tp.priv_lane.clone()
    i = tp.priv_i.clone()
    i[0, 1], lane[0, 1] = i[0, 0], lane[0, 0]
    assert not tdm._lanes_usable(dataclasses.replace(tp, priv_i=i,
                                                     priv_lane=lane))


def polar_inputs(rng, batch, r, d, w_scale):
    Y0 = np.linalg.qr(rng.standard_normal(batch + (r, d)))[0]
    Y_ref = (Y0 + 1e-4 * rng.standard_normal(Y0.shape)).astype(np.float32)
    Y64 = Y_ref.astype(np.float64)
    M_ref = (np.swapaxes(Y64, -1, -2) @ Y64 - np.eye(d)).astype(np.float32)
    W = (w_scale * rng.standard_normal(Y0.shape)).astype(np.float32)
    return Y_ref, M_ref, W


def exact_polar(Y_ref, W):
    A = Y_ref.astype(np.float64) + W.astype(np.float64)
    U, _, Vt = np.linalg.svd(A, full_matrices=False)
    return U @ Vt


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("w_scale", [1e-3, 1.0])
def test_delta_polar_matches_jax_and_exact(d, w_scale):
    """_delta_K, and delta_polar (d = 3, the large-W case exercising the
    pre-scale) or delta_polar2 (d = 2), on 20 blocks at once: within 1e-5
    of scale of the JAX package's, and Y_ref + result within 5e-7 (small W)
    or 2e-5 (large W) of the exact polar factor."""
    rng = np.random.default_rng(50 + d)
    Y_ref, M_ref, W = polar_inputs(rng, (20,), 5, d, w_scale)
    tY, tM, tW = map(torch.as_tensor, (Y_ref, M_ref, W))
    close(tdm._delta_K(tY, tM, tW), jdm._delta_K(*map(jnp.asarray,
                                                       (Y_ref, M_ref, W))))
    if d == 2:
        out_j = jdm.delta_polar2(*map(jnp.asarray, (Y_ref, M_ref, W)))
        out_t = tdm.delta_polar2(tY, tM, tW)
    else:
        out_j = jdm.delta_polar(*map(jnp.asarray, (Y_ref, M_ref, W)))
        out_t = tdm.delta_polar(tY, tM, tW)
    close(out_t, out_j, scale=max(w_scale, float(np.abs(out_j).max())))
    Y_new = Y_ref.astype(np.float64) + out_t.numpy().astype(np.float64)
    np.testing.assert_allclose(Y_new, exact_polar(Y_ref, W),
                               atol=5e-7 if w_scale < 1 else 2e-5)


def test_delta_polar_freezes_each_agent():
    """A batch of agents whose Newton-Schulz loops stop at different counts
    (tiny and large deltas): each agent's result is the JAX package's under
    vmap (1e-5 of scale) and the port's for that agent alone; the batch
    runs as many checks as its slowest agent."""
    rng = np.random.default_rng(7)
    Ya, Ma, Wa = polar_inputs(rng, (6,), 5, 3, 1e-6)
    Yb, Mb, Wb = polar_inputs(rng, (6,), 5, 3, 1.0)
    Y, M, W = (np.stack(p) for p in ((Ya, Yb), (Ma, Mb), (Wa, Wb)))
    out_j = jax.vmap(jdm.delta_polar)(*map(jnp.asarray, (Y, M, W)))
    before = COUNTS["sync.delta.polar"]
    out_t = tdm.delta_polar(*map(torch.as_tensor, (Y, M, W)), batch_dims=1)
    checks = COUNTS["sync.delta.polar"] - before
    close(out_t, out_j)
    alone = []
    for a in range(2):
        before = COUNTS["sync.delta.polar"]
        o = tdm.delta_polar(*map(torch.as_tensor, (Y[a], M[a], W[a])))
        alone.append(COUNTS["sync.delta.polar"] - before)
        close(out_t[a], o.numpy(), 1e-7, scale=1.0)
    assert alone[0] < alone[1] == checks


def polar_counts():
    return {k: COUNTS[k] for k in ("delta.polar_calls", "delta.polar_steps",
                                   "sync.delta.polar")}


@pytest.mark.parametrize("agents", ["batch", "tiny", "large"])
def test_delta_polar_counts_its_calls_and_steps(agents):
    """On the freeze test's agents (both, or the tiny- or the large-delta
    one alone): one "delta.polar_calls" a call and 3 "delta.polar_steps" a
    trip of the loop, which is one check fewer than the checks read; the
    reads are those the loop read before it counted its steps (the
    batch's are its slowest agent's)."""
    rng = np.random.default_rng(7)
    Ya, Ma, Wa = polar_inputs(rng, (6,), 5, 3, 1e-6)
    Yb, Mb, Wb = polar_inputs(rng, (6,), 5, 3, 1.0)
    Y, M, W = (np.stack(p) for p in ((Ya, Yb), (Ma, Mb), (Wa, Wb)))
    args = {"batch": (Y, M, W), "tiny": (Ya, Ma, Wa),
            "large": (Yb, Mb, Wb)}[agents]
    before = polar_counts()
    tdm.delta_polar(*map(torch.as_tensor, args),
                    batch_dims=1 if agents == "batch" else 0)
    after = polar_counts()
    calls, steps, reads = (after[k] - before[k] for k in before)
    trips = reads - 1
    assert calls == 1 and steps == 3 * trips
    assert reads == {"batch": 4, "tiny": 2, "large": 4}[agents]


def test_delta_polar2_counts_no_polar_steps():
    """The d = 2 closed form: neither polar counter moves, nor any read."""
    rng = np.random.default_rng(52)
    Y_ref, M_ref, W = polar_inputs(rng, (20,), 5, 2, 1.0)
    before = polar_counts()
    tdm.delta_polar2(*map(torch.as_tensor, (Y_ref, M_ref, W)))
    assert polar_counts() == before


def carry_pieces(name, use_lanes, seed=0, scale=1e-3):
    """Both packages' CarryRef, lane arrays and omegas at the case's anchor,
    and random deltas D (A, n, r, dh) of `scale`."""
    jp, tp, _, Xs, _, _ = team(name)
    jref = jdm.build_delta_ref(jp, Xs)
    tref = tdm.build_delta_ref(tp, Xs, device="cpu")
    jom_p, jom_s = jdm._omegas(jp)
    tom_p, tom_s = tdm._omegas(tp)
    close(tom_p, jom_p, 0.0)
    close(tom_s, jom_s, 0.0)
    jc = jdm._make_carry_ref(jp, jref, jom_p, use_lanes)
    tc = tdm._make_carry_ref(tp, tref, use_lanes)
    jl_ = jdm._build_lane_static(jp, jom_p, use_lanes)
    tl_ = tdm._build_lane_static(tp, tom_p, use_lanes)
    D = (scale * np.random.default_rng(seed).standard_normal(Xs.shape)) \
        .astype(np.float32)
    return jp, tp, jc, tc, (jom_p, jom_s), (tom_p, tom_s), jl_, tl_, D


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("use_lanes", [True, False])
def test_delta_cost_grad_matches_jax(name, use_lanes):
    """_delta_cost_grad (and, lanes on, _lane_cost_grad and
    _build_lane_data) per agent against the JAX package's vmapped
    functions: costs and gradients within 1e-5 of scale; the lane scatters
    equal."""
    jp, tp, jc, tc, (jom_p, jom_s), (tom_p, tom_s), jls, tls, D = \
        carry_pieces(name, use_lanes)
    nb = jp.num_band if use_lanes else 0
    jD, tD = jnp.asarray(D), torch.as_tensor(D)
    jnbr = jnp.asarray(tdm._gather_nbr(tp, tD).numpy())
    tnbr = tdm._gather_nbr(tp, tD)
    jpriv = (jp.priv_i[:, nb:], jp.priv_j[:, nb:], jp.priv_T[:, nb:],
             jom_p[:, nb:])
    tpriv = (tp.priv_i[:, nb:], tp.priv_j[:, nb:], tp.priv_T[:, nb:],
             tom_p[:, nb:])
    jsh = (jp.shared_idx, jp.shared_T, jom_s, jp.shared_outgoing)
    tsh = (tp.shared_idx, tp.shared_T, tom_s, tp.shared_outgoing)
    joffs = jnp.asarray(jp.band_offsets, jnp.int32)
    toffs = torch.as_tensor(tp.band_offsets)

    def jone(rp, rs, priv, sh, Da, nd, lane):
        lanes = None if lane is None else (lane, joffs)
        return jdm._delta_cost_grad((rp, rs), priv, sh, Da, nd, lanes=lanes)

    jlanes = None if not use_lanes else (jls[0], jls[1], jc.res_lane)
    cj, Gj = jax.vmap(jone)(jc.res_rest, jc.res_shared, jpriv, jsh, jD, jnbr,
                            jlanes)
    tlanes = None if not use_lanes else ((tls[0], tls[1], tc.res_lane), toffs)
    ct, Gt = tdm._delta_cost_grad((tc.res_rest, tc.res_shared), tpriv, tsh,
                                  tD, tnbr, lanes=tlanes)
    close(ct, cj)
    close(Gt, Gj)
    if use_lanes:
        L, n = len(jp.band_offsets), jp.n_max
        res_p = jdm.build_delta_ref(jp, team(name)[3]).res_ref_priv[:, :nb]
        bj = jax.vmap(lambda *a: jdm._build_lane_data(*a, n, L))(
            jp.priv_i[:, :nb], jp.priv_lane[:, :nb], jp.priv_T[:, :nb],
            jom_p[:, :nb], res_p, jp.priv_weight[:, :nb])
        bt = tdm._build_lane_data(
            tp.priv_i[:, :nb], tp.priv_lane[:, :nb], tp.priv_T[:, :nb],
            tom_p[:, :nb], torch.as_tensor(np.array(res_p)),
            tp.priv_weight[:, :nb], n, L)
        for a, b in zip(bt, bj):
            close(a, b, 0.0)
        lj = jax.vmap(jdm._lane_cost_grad, in_axes=(0, None, 0))(
            jlanes, joffs, jD)
        lt = tdm._lane_cost_grad(tlanes[0], toffs, tD)
        close(lt[0], lj[0])
        close(lt[1], lj[1])


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("use_lanes", [True, False])
def test_fold_anchor_matches_jax(name, use_lanes):
    """_fold_anchor on random deltas: the folded residuals (edge and lane
    layout), the defects, the anchor witness and the shifted Nesterov
    deltas within 1e-5 of scale; _carry_to_delta_ref brings the lane layout
    back to the JAX package's edge order."""
    jp, tp, jc, tc, (jom_p, _), (tom_p, _), jls, tls, D = \
        carry_pieces(name, use_lanes, seed=1)
    rng = np.random.default_rng(2)
    f32 = {k: (1e-3 * rng.standard_normal(D.shape)).astype(np.float32)
           for k in ("DY", "DV", "ACC")}
    jst = jdm.DeltaState(D=jnp.asarray(D), gamma=jnp.float32(0.5),
                         it=jnp.int32(25), prev_cost=jnp.float32(1.0),
                         do_restart=jnp.asarray(False),
                         **{k: jnp.asarray(v) for k, v in f32.items()})
    tst = convert.delta_state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, device="cpu")
    jref2, jst2 = jdm._fold_anchor(jp, None, jc, jst, jls, use_lanes)
    tref2, tst2 = tdm._fold_anchor(tp, tc, tst, tls, use_lanes)
    for f in ("X_ref", "res_rest", "res_shared"):
        close(getattr(tref2, f), getattr(jref2, f))
    close(tref2.M_ref, jref2.M_ref, scale=1.0)
    if use_lanes:
        close(tref2.res_lane, jref2.res_lane)
    for f in ("D", "DY", "DV", "ACC"):
        close(getattr(tst2, f), getattr(jst2, f), scale=1e-3)
    assert tst2.it == 25
    jr = jdm._carry_to_delta_ref(jp, jref2, use_lanes)
    tr = tdm._carry_to_delta_ref(tp, tref2, use_lanes)
    close(tr.res_ref_priv, jr.res_ref_priv)
    close(tr.res_ref_shared, jr.res_ref_shared)


@pytest.mark.parametrize("name", list(CASES))
def test_residuals_and_gnc_reweight_match_jax(name):
    """delta_residuals_sq at anchor + D within 1e-5 of scale, and
    delta_gnc_reweight's weights (barc 5, mu 0.05) within 1e-5."""
    jp, tp, _, Xs, _, _ = team(name)
    jref = jdm.build_delta_ref(jp, Xs)
    tref = tdm.build_delta_ref(tp, Xs, device="cpu")
    D = (0.05 * np.random.default_rng(3).standard_normal(Xs.shape)) \
        .astype(np.float32)
    rj = jdm.delta_residuals_sq(jp, jref, jnp.asarray(D))
    rt = tdm.delta_residuals_sq(tp, tref, torch.as_tensor(D))
    for a, b in zip(rt, rj):
        close(a, b)
    wj = jdm.delta_gnc_reweight(jp, jref, jnp.asarray(D), 25.0, 0.05)
    wt = tdm.delta_gnc_reweight(tp, tref, torch.as_tensor(D), 25.0, 0.05)
    close(wt.priv_weight, wj.priv_weight, scale=1.0)
    close(wt.shared_weight, wj.shared_weight, scale=1.0)


def test_convert_round_trip():
    """delta_ref_from_numpy / delta_state_from_numpy carry the JAX
    package's arrays over unchanged (the round counter as a host int)."""
    jp, _, _, Xs, _, _ = team("city600")
    jref = jdm.build_delta_ref(jp, Xs)
    tref = convert.delta_ref_from_numpy(
        {k: np.asarray(v) for k, v in jref._asdict().items()}, device="cpu")
    for f in jref._fields:
        close(getattr(tref, f), getattr(jref, f), 0.0)
    jst = jdm.initial_delta_state(jref)._replace(it=jnp.int32(7))
    tst = convert.delta_state_from_numpy(
        {k: np.asarray(v) for k, v in jst._asdict().items()}, device="cpu")
    assert tst.it == 7 and isinstance(tst.it, int)
    assert tst.D.dtype == torch.float32 and tst.do_restart.dtype == torch.bool


#!/usr/bin/env python3
"""Reference values of chip_smoke.py's residual, gnc, modes, robust, delta,
delta-gnc and certify phases from the JAX package on the CPU (x64 on).

    JAX_PLATFORMS=cpu python3 scripts/jax_smoke_reference.py [phase ...]

Each phase prints one JSON line; chip_smoke.py holds the port to these
values (they are written into it as literals). Phases: residual, gnc, modes,
robust, delta, delta_gnc, certify (default: all).
"""

import dataclasses
import hashlib
import json
import os
import sys
import time

import jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpgo_tpu import datasets, quadratic  # noqa: E402
from dpgo_tpu.ops import lifted  # noqa: E402
from dpgo_tpu.parallel import delta, spmd  # noqa: E402
from dpgo_tpu.solvers import certify as certify_mod  # noqa: E402
from dpgo_tpu.solvers import chordal, pgo, rtr  # noqa: E402

R = 5


def pairs_digest(pairs):
    """A short digest of a set of (p1, p2) pairs, as chip_smoke.py's."""
    text = json.dumps(sorted([int(a), int(b)] for a, b in pairs))
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def lift(T, d):
    return np.einsum("rd,nde->nre",
                     np.asarray(lifted.fixed_stiefel_variable(d, R)),
                     np.asarray(T))


def residual():
    """The 100k city slice with residual-form control and float32 tCG."""
    edges, n, _ = datasets.synthesize_city2d(100000, seed=0)
    problem = quadratic.from_private_measurements(edges, n=n, d=2)
    T = chordal.chordal_initialization_arrays(
        edges, n=n, cg_dtype=jnp.float32, tol=1e-6, maxiter=1000)
    X0 = jnp.asarray(lift(T, 2))
    nbr = jnp.zeros((1, R, 3))
    qd = quadratic.build_quadratic_data(problem, nbr, r=R)
    qd = dataclasses.replace(
        qd, res=quadratic.build_residual_data(problem, nbr))
    t0 = time.perf_counter()
    X, st = rtr.rtr_solve(qd, X0, 1e-2, 100.0, max_iterations=100,
                          max_inner=200, inner_dtype=jnp.float32,
                          residual_control=True)
    X.block_until_ready()
    return {
        "rtr_iters": int(st.iterations), "tcg_iters": int(st.tcg_iters),
        "f_opt_residual_form_x2": 2 * float(st.f_opt),
        "gnorm_opt": float(st.gnorm_opt),
        # the matvec form in float64 at the returned iterate (no shared
        # edges and no priors: the residual form's constant is 0 here)
        "f64_2f": 2 * float(quadratic.cost(qd, X)),
        "f64_gradnorm": float(quadratic.rie_grad_norm(qd, X)),
        "seconds": time.perf_counter() - t0,
    }


def gnc(agents=8):
    """Distributed GNC-TLS with 15% planted outlier loop closures: the
    configuration of bench.py's intel-gnc-outliers on a synthetic city."""
    edges, n, _ = datasets.synthesize_city2d(10000, seed=0)
    meas, planted = datasets.plant_outliers(
        edges.to_measurements(), n, frac=0.15, seed=1)
    T = pgo.chordal_initialization(meas)
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=agents, r=R)
    state = spmd.initial_state(problem, lift(T, 2), ranges)
    cfg = spmd.SPMDConfig(mode="all", acceleration=False, rtr_iterations=1)
    t0 = time.perf_counter()
    problem_out, _, hist = spmd.run_rbcd_gnc(
        problem, state, cfg, barc=5.0, num_weight_updates=10, inner_rounds=20)
    by_pair = {e["pair"]: e["weight"]
               for e in spmd.edge_weight_table(problem_out, ranges)
               if not e["fixed"]}
    rejected = {p for p, w in by_pair.items() if w < 1e-6}
    return {
        "num_poses": n, "agents": agents, "measurements": len(meas),
        "planted": len(planted), "rejected": len(rejected),
        "missed": sorted(planted - rejected),
        "false_positives": sorted(rejected - planted),
        "rounds": [h["rounds"] for h in hist],
        "final_cost": hist[-1]["cost"], "final_mu": hist[-1]["mu"],
        "seconds": time.perf_counter() - t0,
    }


def modes(rounds=20, agents=8):
    """20 float64 rounds each of 'uniform' and 'async' on the grid3d-10k
    team, no acceleration, seed 0, with the draws that made them."""
    edges, n, _ = datasets.synthesize_grid3d(10000, seed=1)
    meas = edges.to_measurements()
    T = pgo.chordal_initialization(meas)
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=agents, r=R)
    state0 = spmd.initial_state(problem, lift(T, 3), ranges)
    key = jax.random.PRNGKey(0)
    out = {}
    for mode in ("uniform", "async"):
        cfg = spmd.SPMDConfig(
            mode=mode, acceleration=False, rtr_iterations=1,
            rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(agents)), precond="auto",
            seed=0)
        run = spmd.make_run_fn(problem, cfg)
        _, m, done = run(state0, rounds, 0.0)
        out[mode] = {"rounds": int(done), "cost": float(m.cost),
                     "gradnorm": float(m.gradnorm)}
    # the draw indexed by round counter `it`, one more than the rounds run
    out["uniform"]["draws"] = [
        int(jax.random.randint(jax.random.fold_in(key, it), (), 0, agents,
                               jnp.int32)) for it in range(rounds + 1)]
    p_fire = 1.0 - float(np.exp(-spmd.SPMDConfig().async_rate))
    out["async"]["draws"] = [
        "".join("1" if b else "0" for b in np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, it), p_fire, (agents,))))
        for it in range(rounds + 1)]
    return out


def robust():
    """solve_robust_pgo with default parameters on grid3d(1000) with 15%
    planted outlier loop closures."""
    edges, n, _ = datasets.synthesize_grid3d(1000, seed=0)
    meas, planted = datasets.plant_outliers(
        edges.to_measurements(), n, frac=0.15, seed=1)
    t0 = time.perf_counter()
    _, out = pgo.solve_robust_pgo(meas)
    free = [m for m in out if not m.fixed_weight]
    outliers = {(m.p1, m.p2) for m in free if m.weight < 1e-8}
    return {
        "measurements": len(meas), "planted": len(planted),
        "inliers": sum(m.weight > 1 - 1e-8 for m in free),
        "outliers": len(outliers),
        "undecided": sum(1e-8 <= m.weight <= 1 - 1e-8 for m in free),
        "missed": sorted(planted - outliers),
        "false_positives": len(outliers - planted),
        "outliers_digest": pairs_digest(outliers),
        "seconds": time.perf_counter() - t0,
    }


def stacked(problem, ranges, X0, d):
    """Global (n, r, dh) -> stacked float64 (N, n_max, r, dh), padded rows
    identity-lifted (initial_state's convention, kept in float64)."""
    Xs = np.zeros((problem.num_agents, problem.n_max, R, d + 1))
    Xs[:] = np.asarray(lifted.identity_lifted(problem.n_max, R, d), np.float64)
    for a, (s, e) in enumerate(ranges):
        Xs[a, : e - s] = X0[s:e]
    return Xs


def unstacked(Xs, ranges, n):
    X = np.zeros((n,) + Xs.shape[2:])
    for a, (s, e) in enumerate(ranges):
        X[s:e] = Xs[a, : e - s]
    return X


# scale_bench.py's certified schedule (its tCG cap 20 for the grid world)
DELTA_CFG = dict(
    mode="all", acceleration=True, rtr_iterations=1, adaptive_restart=True,
    restart_interval=10**6, nesterov_n=5, rtr_tcg_iterations=20,
    restart_scheme="exact", rtr_residual_control=True,
    rtr_tcg_precision="high")


def delta_phase(agents=8):
    """The delta engine on the rbcd phases' team (grid3d-10k, seed 1, 8
    agents, float32 problem) from the lifted float64 chordal init, then
    certify_solution on its iterate."""
    edges, n, _ = datasets.synthesize_grid3d(10000, seed=1)
    meas = edges.to_measurements()
    T = pgo.chordal_initialization(meas)
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=agents, r=R,
                                              dtype=jnp.float32)
    Xs = stacked(problem, ranges, lift(T, 3), 3)
    cfg = spmd.SPMDConfig(rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(agents)),
                          **DELTA_CFG)
    t0 = time.perf_counter()
    X, info = delta.run_delta_certified(problem, Xs, cfg, tol=0.9e-2,
                                        chunk=25, max_rounds=2000,
                                        reanchor_every=25)
    seconds = time.perf_counter() - t0
    cost, gn = delta.host_certify(problem, X)
    t0 = time.perf_counter()
    cert = certify_mod.certify_solution(meas, jnp.asarray(
        unstacked(X, ranges, n)), k=64, eta=1e-6, precond="auto")
    return {
        "rounds": info["rounds"], "device_gradnorm": info["device_gradnorm"],
        "host_cost": cost, "host_gradnorm": gn, "seconds": seconds,
        "certified": cert.certified, "lambda_min": cert.lambda_min,
        "lambda_min_lower": cert.lambda_min_lower,
        "stationarity": cert.stationarity,
        "eig_residual": cert.eig_residual,
        "certify_seconds": time.perf_counter() - t0,
    }


def delta_gnc(agents=8):
    """run_delta_gnc with the gnc phase's graph and settings, then
    bench.py's certified polish on the reweighted problem."""
    edges, n, _ = datasets.synthesize_city2d(10000, seed=0)
    clean = edges.to_measurements()
    meas, planted = datasets.plant_outliers(clean, n, frac=0.15, seed=1)
    T = pgo.chordal_initialization(meas)
    problem, ranges = spmd.build_spmd_problem(meas, n, num_agents=agents, r=R,
                                              dtype=jnp.float32)
    Xs = stacked(problem, ranges, lift(T, 2), 2)
    cfg = spmd.SPMDConfig(mode="all", acceleration=False, rtr_iterations=1)
    t0 = time.perf_counter()
    problem_out, _, _, X, hist = delta.run_delta_gnc(
        problem, Xs, cfg, barc=5.0, num_weight_updates=10, inner_rounds=20)
    gnc_s = time.perf_counter() - t0
    by_pair = {e["pair"]: e["weight"]
               for e in spmd.edge_weight_table(problem_out, ranges)
               if not e["fixed"]}
    rejected = {p for p, w in by_pair.items() if w < 1e-6}
    # bench.py's polish, with scale_bench.py's city schedule (tCG cap 3,
    # restart_scheme 'exact', nesterov_n 5, no periodic restart): with
    # bench.py's own settings (tCG cap 50, nesterov_n = team size, restart
    # every 30 rounds) 8 agents leave the host gradnorm at 1.06 after 1,000
    # rounds
    cfg_cert = spmd.SPMDConfig(
        rtr_gradnorm_tol=1e-2 / (2 * np.sqrt(agents)),
        **dict(DELTA_CFG, rtr_tcg_iterations=3))
    t0 = time.perf_counter()
    X_final, info = delta.run_delta_certified(
        problem_out, X, cfg_cert, tol=1e-2, chunk=25, max_rounds=1000)
    polish_s = time.perf_counter() - t0
    _, gn = delta.host_certify(problem_out, X_final)
    problem_clean, _ = spmd.build_spmd_problem(clean, n, num_agents=agents,
                                               r=R)
    cost_clean, gn_clean = delta.host_certify(problem_clean, X_final)
    return {
        "planted": len(planted), "rejected": len(rejected),
        "missed": sorted(planted - rejected),
        "false_positives": sorted(rejected - planted),
        "rounds": [h["rounds"] for h in hist],
        "costs": [h["cost"] for h in hist], "final_mu": hist[-1]["mu"],
        "gnc_seconds": gnc_s, "polish_rounds": info["rounds"],
        "polish_gradnorm": gn, "polish_seconds": polish_s,
        "clean_cost": cost_clean, "clean_gradnorm": gn_clean,
    }


def certify():
    """solve_pgo_staircase on the auto phase's graph (grid3d-3375, seed 0)
    from r0 = 3 (d) at gradnorm_tol 1e-6."""
    edges, n, _ = datasets.synthesize_grid3d(3375, seed=0)
    meas = edges.to_measurements()
    t0 = time.perf_counter()
    res = certify_mod.solve_pgo_staircase(meas, r0=3, gradnorm_tol=1e-6)
    return {
        "r": res.r, "certified": res.certified, "cost": res.cost,
        "lambda_min": res.lambda_min, "gradnorm": res.gradnorm,
        "history": list(res.history), "seconds": time.perf_counter() - t0,
    }


def main():
    phases = {"residual": residual, "gnc": gnc, "modes": modes,
              "robust": robust, "delta": delta_phase, "delta_gnc": delta_gnc,
              "certify": certify}
    for name in sys.argv[1:] or list(phases):
        print(json.dumps({name: phases[name]()}), flush=True)


if __name__ == "__main__":
    main()

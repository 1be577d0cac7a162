#!/usr/bin/env python3
"""How fast the JAX package's and the port's delta engines drift apart in
run_delta_gnc's first phase, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/delta_gnc_drift.py [rounds]

The first phase of chip_smoke.py's delta-gnc run: city2d-10k with 15%
planted outlier loop closures, 8 agents, float32 problem, mode 'all', no
acceleration, one RTR step per round (tCG cap 50), every weight 1. Both
packages start from the same anchor and run one round per call; each line
prints the round, both team costs and gradnorms, and the largest
difference of the deltas over the largest delta. At the end, the largest
squared residual in each package: run_delta_gnc's adaptive mu0 =
barc^2 / (2 max r^2 - barc^2) is read from it.
"""

import dataclasses
import os
import sys

import jax

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dpgo_tpu import datasets  # noqa: E402
from dpgo_tpu.ops import lifted  # noqa: E402
from dpgo_tpu.parallel import delta as jdm  # noqa: E402
from dpgo_tpu.parallel import spmd as js  # noqa: E402
from dpgo_tpu.solvers.pgo import chordal_initialization  # noqa: E402
from dpgo_tpu_torch import convert  # noqa: E402
from dpgo_tpu_torch.parallel import delta as tdm  # noqa: E402
from dpgo_tpu_torch.parallel import spmd as ts  # noqa: E402

R, AGENTS = 5, 8


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    edges, n, _ = datasets.synthesize_city2d(10000, seed=0)
    meas, _ = datasets.plant_outliers(edges.to_measurements(), n, frac=0.15,
                                      seed=1)
    jp, ranges = js.build_spmd_problem(meas, n, AGENTS, R, dtype=jnp.float32)
    fields = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp)
              if isinstance(getattr(jp, f.name), jax.Array)}
    meta = dict(num_agents=jp.num_agents, n_max=jp.n_max, d=jp.d, r=jp.r,
                num_band=jp.num_band, band_offsets=jp.band_offsets)
    tp = convert.spmd_problem_from_numpy(fields, meta, device="cpu",
                                         dtype=torch.float32)
    X0 = np.einsum("rd,nde->nre",
                   np.asarray(lifted.fixed_stiefel_variable(2, R)),
                   np.asarray(chordal_initialization(meas)))
    Xs = np.zeros((AGENTS, jp.n_max, R, 3))
    Xs[:] = np.asarray(lifted.identity_lifted(jp.n_max, R, 2), np.float64)
    for a, (s, e) in enumerate(ranges):
        Xs[a, : e - s] = X0[s:e]
    cfg = dict(mode="all", acceleration=False, rtr_iterations=1)
    jrun = jdm.make_delta_run_fn(jp, js.SPMDConfig(**cfg), reanchor_every=25)
    trun = tdm.make_delta_run_fn(tp, ts.SPMDConfig(**cfg), reanchor_every=25,
                                 device="cpu")
    jref = jdm.build_delta_ref(jp, Xs)
    jst = jdm.initial_delta_state(jref)
    tref = tdm.build_delta_ref(tp, Xs, device="cpu")
    tst = tdm.initial_delta_state(tref)
    print("round jax_cost port_cost jax_gradnorm port_gradnorm "
          "max|dD|/max|D|")
    for k in range(rounds):
        jst, jref, jm, _ = jrun(jref, jst, 1, 0.0)
        tst, tref, tm, _ = trun(tref, tst, 1, 0.0)
        jD = np.asarray(jst.D, np.float64)
        dD = np.abs(jD - tst.D.numpy()).max() / np.abs(jD).max()
        print(f"{k + 1} {float(jm.cost)!r} {float(tm.cost)!r} "
              f"{float(jm.gradnorm)!r} {float(tm.gradnorm)!r} {dD:.3e}",
              flush=True)
    rj = jdm.delta_residuals_sq(jp, jref, jst.D)
    rt = tdm.delta_residuals_sq(tp, tref, tst.D)
    print(f"max r^2: jax {max(float(rj[0].max()), float(rj[1].max()))!r} "
          f"port {max(float(rt[0].max()), float(rt[1].max()))!r}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Global-optimality certificate of a scale-bench iterate with the PyTorch
port: the counterpart of scripts/certify_scale.py.

    python3 scripts/torch_certify_scale.py [iterate.npz] [k] [eta] \\
        [--device cpu]

The certified pipeline (scripts/torch_scale_bench.py or
scripts/scale_bench.py with DPGO_SCALE_CERTIFIED=1 and DPGO_SCALE_SAVE_X)
proves first-order optimality: a float64 Riemannian gradient norm below
1e-2. This script adds the dual certificate (solvers/certify.py):
lambda_min(S(X)) >= -eta proves the lifted iterate a global minimizer of
the rank-r relaxation. It reads the npz (X global (n, r, d+1), or the
legacy stacked (N, n_max, r, d+1) layout), re-synthesizes the world from
its seed, replays the relabeling, and runs the package's polish and
certificate stages (those of certify.solve_certified) on one assembled
problem: certify.polish in float64 (rtr_solve to gradient norm 1e-6 from
radius 1, at most 100 iterations of at most 500 tCG iterations,
block-Jacobi: the certificate's coupling term scales with the gradient
norm; DPGO_CERT_POLISH=0 skips it), then min_eig_certificate over the
exact banded factor, as certify_solution builds it, with k Lanczos steps
(default 64), eta (1e-6) and DPGO_CERT_REFINE refinement iterations
(400). Runs on the CUDA card unless
--device names another device (without a card it exits); prints the
`polish:` and `CERTIFICATE ...` lines with the device's name and power
limit.
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from dpgo_tpu_torch import devices, quadratic  # noqa: E402
from dpgo_tpu_torch.solvers import certify  # noqa: E402
from scripts.torch_scale_bench import (  # noqa: E402
    Iterate, card_line, load_iterate, relabel, sync, synthesize)

# the package's polish settings (certify.POLISH, solve_certified's stage (b))
POLISH = certify.POLISH


def replay(it: Iterate):
    """(relabeled edges, n, d): the world re-synthesized, X's labels."""
    edges, n, _, d = synthesize(it.world, it.num_poses, it.seed)
    return relabel(edges, it.order), n, d


def polish(problem, X: torch.Tensor):
    """certify_scale.py's float64 polish, the package's stage
    (certify.polish over block-Jacobi data): (X, stats dict)."""
    qd = certify.quadratic_data(problem, X.shape[1])
    Xp, st = certify.polish(qd, X, **POLISH)
    return Xp, dict(gradnorm_init=float(st.gnorm_init),
                    gradnorm=float(st.gnorm_opt), f=float(st.f_opt),
                    iterations=int(st.iterations),
                    tcg_iters=int(st.tcg_iters))


def certify_scale(it: Iterate, k: int = 64, eta: float = 1e-6,
                  do_polish: bool = True, refine: int = 400,
                  device=None) -> dict:
    """certify_scale.py on a loaded iterate: replay, the optional polish,
    certify_solution. Returns the polish's stats (None without it), the
    certificate's numbers and the stage seconds."""
    device = devices.resolve(device, "certify_scale")
    t = {}
    t0 = time.perf_counter()
    edges, n, d = replay(it)
    problem = quadratic.from_private_measurements(edges, n=n, d=d,
                                                  device=device)
    t["replay_s"] = time.perf_counter() - t0
    X, pol = torch.as_tensor(it.X, dtype=torch.float64, device=device), None
    t0 = time.perf_counter()
    if do_polish:
        X, pol = polish(problem, X)
    sync(device)
    t["polish_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the package's certificate stage: min_eig_certificate over the exact
    # banded factor, as certify_solution builds it
    cert = certify.min_eig_certificate(
        certify.quadratic_data(problem, X.shape[1], "auto"), X, k=k, eta=eta,
        refine_iters=refine)
    sync(device)
    t["certificate_s"] = time.perf_counter() - t0
    return dict(world=it.world, n=n, r=int(X.shape[1]), k=k, eta=eta,
                refine=refine, polish=pol, certified=cert.certified,
                lambda_min=cert.lambda_min,
                lambda_min_lower=cert.lambda_min_lower,
                eig_residual=cert.eig_residual,
                stationarity=cert.stationarity, stage_s=t)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", "data",
        "scale_x.npz"))
    ap.add_argument("k", nargs="?", type=int, default=64)
    ap.add_argument("eta", nargs="?", type=float, default=1e-6)
    ap.add_argument("--device", default="cuda",
                    help="the device to run on (default: the CUDA card)")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA card: pass --device cpu to run on the CPU")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line(dev)
    it = load_iterate(args.path)
    print(f"{it.world} n={it.num_poses} r={it.X.shape[1]} k={args.k} "
          f"eta={args.eta} device=\"{card}\"", flush=True)
    res = certify_scale(
        it, k=args.k, eta=args.eta,
        do_polish=os.environ.get("DPGO_CERT_POLISH", "1") == "1",
        refine=int(os.environ.get("DPGO_CERT_REFINE", "400")), device=dev)
    s, pol = res["stage_s"], res["polish"]
    if pol is not None:
        print(f"polish: gradnorm {pol['gradnorm_init']:.3e} -> "
              f"{pol['gradnorm']:.3e} in {s['polish_s']:.1f}s "
              f"({pol['tcg_iters']} tCG)", flush=True)
    print(
        f"CERTIFICATE world={res['world']} n={res['n']} "
        f"lambda_min={res['lambda_min']:.3e} "
        f"lambda_min_lower={res['lambda_min_lower']:.3e} "
        f"eig_residual={res['eig_residual']:.3e} "
        f"certified={'YES' if res['certified'] else 'NO'} "
        f"(eta={args.eta:g}) wall_s={sum(s.values()):.1f} "
        f"device=\"{card}\"", flush=True)


if __name__ == "__main__":
    main()

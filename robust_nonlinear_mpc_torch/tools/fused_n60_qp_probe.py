"""QP-level A/B of the Newton paths as the horizon grows: kkt="fused" (the
hand-written Newton kernels, which run any N in one stage loop) against
kkt="riccati" (torch loops) on the same QPs (port of
`robust_nonlinear_mpc_tpu/tools/pallas_n60_qp_probe.py`, whose "pallas"
path splits the stage axis into windows above N = 30).

The QPs are the rocket's deviation problems around real SQP nominals
(`assemble_deviation_problem` on the seeded lanes: X0 perturbed by 0.02
standard normal, seed 0, the probe's SQP options), at each N of `--Ns`.
Both paths solve them with `--qp-iters` iterations at tolerance 3e-5; per
path the iterations, exit KKT residuals and success of every lane, and
between the paths the lanes whose iterations or success differ and the
largest |dX| and |dU| (absolute, and relative to each path's largest
entry). One JSON file under `build/`.

Float32 on the card (the default), float64 with `--device cpu`; without a
card `--device cuda` raises.

Usage:
  python -m robust_nonlinear_mpc_torch.tools.fused_n60_qp_probe --run
      [--lanes 8] [--Ns 15,30,60] [--qp-iters 15] [--device cuda|cpu]
      [--out build/fused_n60_qp_probe.json]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

KKTS = ("riccati", "fused")


def probe_options(solver):
    """The probe's SQP options (the JAX probe's): 25 iterations at step and
    feasibility tolerance 1e-4, each QP 15 IPM iterations at 3e-5."""
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions
    from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions

    solver.opts = solver.opts._replace(
        verbose=False,
        sqp=SQPOptions(ipm=IPMOptions(max_iter=15, tol=3e-5), tol_step=1e-4, tol_feas=1e-4,
                       max_iter=25),
    )
    return solver


def seeded_lanes(N, lanes, device, dtype):
    """The rocket problem at horizon N with the probe's options, and the
    lanes' initial states (X0 + 0.02 standard normal, seed 0)."""
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )

    m, solver = make_rocket_problem(N, device=device, dtype=dtype)
    probe_options(solver)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(np.asarray(X0)[None] + 0.02 * rng.standard_normal((lanes, m.nx)),
                          dtype=dtype, device=device)
    return m, solver, x0s


def deviation_qps(solver, X, U, x0s):
    """The deviation QPs around the nominals (X, U) from x0s."""
    from robust_nonlinear_mpc_torch.ops.qp_ipm import QPData

    A, Bm, c, qx, qu, g_res, gf_res, xi = solver.assemble_deviation_problem(X, U, x0s)
    return QPData(A=A, B=Bm, c=c, qx=qx, qu=qu, h=g_res, hf=gf_res, xinit=xi)


def solve_both(solver, data, qp_iters):
    """Solve the QPs by each Newton path. Returns ({kkt: QPSolution}, the
    row: per path the lanes' iterations, KKT residuals and success, and the
    gaps between the paths)."""
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions, solve_qp

    sols, row = {}, {}
    for kkt in KKTS:
        sol = solve_qp(solver.prob.stat, data, IPMOptions(max_iter=qp_iters, tol=3e-5, kkt=kkt))
        sols[kkt] = sol
        kres = sol.kkt_res.double().cpu().numpy()
        row[kkt] = {
            "iters": sol.iters.cpu().tolist(),
            "kkt_res": [float(v) for v in kres],
            "success": sol.success.int().cpu().tolist(),
            "worst_kkt": float(kres.max()),
            "n_success": int(sol.success.sum()),
            "mean_iters": float(sol.iters.double().mean()),
        }
    f, r = sols["fused"], sols["riccati"]
    gap = lambda a, b: float((a - b).abs().max())
    rel = lambda a, b: gap(a, b) / max(float(b.abs().max()), 1e-30)
    row.update(
        lanes_iters_differ=int((f.iters != r.iters).sum()),
        lanes_success_differ=int((f.success != r.success).sum()),
        max_X_gap=gap(f.X, r.X), max_U_gap=gap(f.U, r.U),
        rel_X_gap=rel(f.X, r.X), rel_U_gap=rel(f.U, r.U),
    )
    return sols, row


def probe(N, lanes, qp_iters, device="cuda", dtype=torch.float32):
    """One horizon: seed the lanes by the SQP, build their deviation QPs
    and solve them by both paths. Returns the row (with the SQP's success
    and seconds, and each path's seconds)."""
    from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve
    from robust_nonlinear_mpc_torch.utils.graph_loop import GraphSet

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    m, solver, x0s = seeded_lanes(N, lanes, device, dtype)
    t0 = time.perf_counter()
    # on the card the SQP loop runs as a CUDA graph (a WHILE node)
    nom = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s, opts=solver.opts.sqp,
                    graphs=GraphSet(x0s.device))
    sync()
    t1 = time.perf_counter()
    data = deviation_qps(solver, nom.X, nom.U, x0s)
    _, row = solve_both(solver, data, qp_iters)
    sync()
    row.update(N=N, lanes=lanes, dtype=str(dtype).replace("torch.", ""),
               sqp_success=int(nom.success.sum()), sqp_s=t1 - t0,
               solves_s=time.perf_counter() - t1)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", action="store_true")
    p.add_argument("--lanes", type=int, default=8)
    p.add_argument("--Ns", default="15,30,60")
    p.add_argument("--qp-iters", type=int, default=15, dest="qp_iters")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=os.path.join("build", "fused_n60_qp_probe.json"))
    args = p.parse_args(argv)
    if not args.run:
        p.print_help()
        return None

    dtype = torch.float32 if args.device == "cuda" else torch.float64
    results = {}
    for N in [int(s) for s in args.Ns.split(",")]:
        row = probe(N, args.lanes, args.qp_iters, args.device, dtype)
        results[f"N{N}"] = row
        ric, fus = row["riccati"], row["fused"]
        print(f"[qp_probe] N={N} B={args.lanes} {row['dtype']}: riccati success "
              f"{ric['n_success']}/{args.lanes} worst_kkt {ric['worst_kkt']:.2e} mean iters "
              f"{ric['mean_iters']:.2f}; fused success {fus['n_success']}/{args.lanes} worst_kkt "
              f"{fus['worst_kkt']:.2e} mean iters {fus['mean_iters']:.2f}; lanes whose iters "
              f"differ {row['lanes_iters_differ']}, success {row['lanes_success_differ']}; "
              f"max|dX| {row['max_X_gap']:.2e} max|dU| {row['max_U_gap']:.2e}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[qp_probe] saved {args.out}", flush=True)
    return results


if __name__ == "__main__":
    main()

"""The N = 60 rocket's failure fingerprint (port of
`robust_nonlinear_mpc_tpu/tools/n60_probe.py`).

Stage 1 (batched): the bench-protocol closed loop at horizon `--N` (B lanes
from X0 perturbed by 0.02 standard normal, w ~ U[-1, 1], seed 0) through
`build_batched_closed_loop`: per-lane first failure step, the longest streak
of failed steps, inner-solve failures against the others, and the
realized-state constraint rows active or violated at the first failure
(named by `Rocket.constraint_names`).

Stage 2 (replay): the first `--replay` lanes that fail mid-flight (first
failure at step 3 or later) re-run teacher-forced through the host driver
(`SCPSLSSolver.solve` on the lane's own visited states) up to the failure
step: the QP's KKT residual and iterations at the failure and the capacity
g - G z_nom_k - backoff_k of the last accepted solution per stage and row.
min <= 0 means the tightened QP had no feasible nominal left (structural),
else the failure is numerical.

The bench stack's features are off unless asked for (the plain
configuration): `--kkt`, `--recycle`, `--warm-qp`, `--streaming`,
`--adaptive` (6 steady / 15 cold IPM iterations), `--ipm-first` (8
iterations at 1e-3) and `--soft-fallback`. Float32 on the card, float64
with `--device cpu`; without a card `--device cuda` (the default) raises.

Usage:
  python -m robust_nonlinear_mpc_torch.tools.n60_probe --run [--N 60]
      [--lanes 128] [--steps 45] [--replay 4] [--device cuda|cpu]
      [--out build/n60_failure_fingerprint.npz]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", action="store_true")
    p.add_argument("--N", type=int, default=60)
    p.add_argument("--lanes", type=int, default=128)
    p.add_argument("--steps", type=int, default=45)
    p.add_argument("--replay", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--qp-iters", type=int, default=15, dest="qp_iters")
    p.add_argument("--kkt", default="riccati", choices=["riccati", "fused", "fused_iter", "condensed"])
    p.add_argument("--recycle", action="store_true")
    p.add_argument("--warm-qp", action="store_true", dest="warm_qp")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--ipm-first", action="store_true", dest="ipm_first")
    p.add_argument("--soft-fallback", action="store_true", dest="soft_fallback")
    p.add_argument("--out", default=os.path.join("build", "n60_failure_fingerprint.npz"))
    args = p.parse_args(argv)
    if not args.run:
        p.print_help()
        return

    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions
    from robust_nonlinear_mpc_torch.sim.closed_loop import build_batched_closed_loop
    from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions
    from robust_nonlinear_mpc_torch.tools.converged_probe import capacity_fields

    dtype = torch.float32 if args.device == "cuda" else torch.float64
    m, solver = make_rocket_problem(args.N, device=args.device, dtype=dtype)
    o = solver.opts._replace(verbose=False)
    if dtype == torch.float32:
        cold = max(args.qp_iters, 15) if args.adaptive else args.qp_iters
        o = o._replace(
            ipm=IPMOptions(max_iter=cold, tol=3e-5, kkt=args.kkt),
            adaptive_ipm_budget=(min(args.qp_iters, 6), cold) if args.adaptive else None,
            sqp=SQPOptions(ipm=IPMOptions(max_iter=15, tol=3e-5), tol_step=1e-4,
                           tol_feas=1e-4, max_iter=25),
        )
        if args.ipm_first:
            o = o._replace(ipm_first=IPMOptions(max_iter=8, tol=1e-3, kkt=args.kkt))
    else:
        o = o._replace(ipm=o.ipm._replace(kkt=args.kkt))
    solver.opts = o._replace(
        recycle_eta=args.recycle, streaming_response=args.streaming,
        recycle_warm_qp=args.recycle and args.warm_qp,
        nominal_soft_fallback=args.soft_fallback,
    )
    print(f"[n60] config: kkt={args.kkt} recycle={args.recycle} warm_qp={args.warm_qp} "
          f"streaming={args.streaming} adaptive={args.adaptive} ipm_first={args.ipm_first} "
          f"qp_iters={args.qp_iters} device={args.device}", flush=True)

    B, T, N = args.lanes, args.steps, args.N
    rng = np.random.default_rng(0)
    x0s = np.asarray(X0)[None] + 0.02 * rng.standard_normal((B, m.nx))
    Ws = 2 * rng.random((B, T, m.nw)) - 1
    logs = build_batched_closed_loop(solver, T)(x0s, Ws)
    host = lambda a: a.detach().cpu().numpy()
    succ, scpf = host(logs.success), host(logs.scp_failed)
    xs, us = host(logs.state_trajectory).astype(float), host(logs.input_trajectory).astype(float)

    G = m.G.detach().cpu().double().numpy()
    g = m.g.detach().cpu().double().numpy().reshape(-1)
    names = m.constraint_names
    lane_fail = ~succ.all(axis=1)
    fail_ids = np.flatnonzero(lane_fail)
    first_fail = np.array([int(np.argmax(~succ[i])) if lane_fail[i] else -1 for i in range(B)])
    streaks = []
    for i in fail_ids:
        best = cur = 0
        for v in ~succ[i]:
            cur = cur + 1 if v else 0
            best = max(best, cur)
        streaks.append(best)
    print(f"[n60] N={N} B={B} T={T}: per-step success {succ.mean():.4f}, failing lanes "
          f"{len(fail_ids)}/{B}", flush=True)
    if len(fail_ids):
        ff = first_fail[fail_ids]
        print(f"[n60] first-failure steps: min {ff.min()} / median {int(np.median(ff))} / max "
              f"{ff.max()}; longest streaks median {int(np.median(streaks))} max {max(streaks)}")
        n_inner = int((scpf[fail_ids] & ~succ[fail_ids]).sum())
        n_failed = int((~succ[fail_ids]).sum())
        print(f"[n60] failed steps: {n_failed} total, {n_inner} inner-solve failures, "
              f"{n_failed - n_inner} other")
        rows_hit = {}
        for i in fail_ids:
            k = first_fail[i]
            if k >= us.shape[1]:
                continue
            marg = G @ np.concatenate([xs[i, k], us[i, k]]) - g
            for r in np.flatnonzero(marg > -1e-3):
                rows_hit[names[r]] = rows_hit.get(names[r], 0) + 1
        print("[n60] active/violated constraint rows at first failure (count over failing lanes):")
        for name, v in sorted(rows_hit.items(), key=lambda kv: -kv[1])[:10]:
            print(f"    {name}: {v}")

    # stage 2: teacher-forced host-driver replay of mid-flight failures
    replay_out = []
    mid = fail_ids[first_fail[fail_ids] >= 3]
    for i in (mid if len(mid) else fail_ids)[: args.replay]:
        t_fail = int(first_fail[i])
        solver.reset()
        rec, sol_prev = {"lane": int(i), "t_fail": t_fail}, None
        for k in range(t_fail + 1):
            if k > 0:
                solver.reset_warm_start()
            sol = solver.solve(xs[i, k])
            if k == t_fail - 1:
                sol_prev = sol
        rec.update(success_at_fail=bool(sol.get("success", False)),
                   qp_kkt=float(sol.get("qp_kkt", np.nan)), qp_iters=int(sol.get("qp_iters", -1)))
        src = sol if sol.get("success", False) else (sol_prev or sol)
        if "primal_x" in src:
            rec.update(capacity_fields(m, np.asarray(src["primal_x"], float).T,
                                       np.asarray(src["primal_u"], float).T,
                                       np.asarray(src["backoff"], float)))
            print(f"[n60] lane {i} replay: fail step {t_fail}, success_at_fail="
                  f"{rec['success_at_fail']}, qp_kkt={rec['qp_kkt']:.2e}, min tightened "
                  f"capacity {rec['min_capacity']:.4f} at stage {rec['min_capacity_stage']} row "
                  f"'{rec['min_capacity_row']}' ({rec['n_rows_exhausted']} stage-rows exhausted; "
                  f"untightened min {rec['min_capacity_untightened']:.4f})", flush=True)
        replay_out.append(rec)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, N=N, lanes=B, steps=T, success=succ, scp_failed=scpf,
             qp_iters=host(logs.qp_iters), first_fail=first_fail, fail_ids=fail_ids,
             streaks=np.asarray(streaks, np.int32), replay=json.dumps(replay_out))
    print(f"[n60] saved {args.out}", flush=True)


if __name__ == "__main__":
    main()

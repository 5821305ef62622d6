"""Per-lane failure attribution of the until-convergence rocket Monte-Carlo
(port of `robust_nonlinear_mpc_tpu/tools/converged_probe.py`).

Chosen lanes of an MC artifact (its `success_mask` and `scp_failed_mask`)
are replayed one by one through a host loop that follows the
until-convergence closed loop iteration by iteration (accept
`ok = success & finite`, the warm shift and the fresh SLS state between
steps, the artifact's draws from `default_rng(seed)`):

* per SCP iteration: delta = |primal update|_inf, the QP's KKT residual and
  iterations, so a step that runs out of budget records how far from the
  criterion it stalled, and its contraction rate;
* on an inner-solve failure, or a step that runs out of budget: the capacity
  of the last accepted iterate, g - G z_nom_k - backoff_k per stage and named
  row (`Rocket.constraint_names`): min <= 0 means the tightened QP had no
  feasible nominal left (the tube met the bound), else the failure is
  numerical;
* each step's success against the artifact's, lane by lane.

The options are those of `expe/main_monte_carlo_validation.py --converged`
(SCP criterion 1e-3, 20 SCP iterations, 60 fast-SLS iterations, IPM 15
iterations at 3e-5, kkt="riccati" unless `--kkt`), float32 on the card,
float64 with `--device cpu`.

Usage:
  python -m robust_nonlinear_mpc_torch.tools.converged_probe --run
      [--artifact artifacts/mc_validation_rocket_converged_tpu_f32_128_r4.npz]
      [--lanes 0,19,37] [--steps 10] [--device cuda|cpu] [--out build/converged_failure_probe.npz]
Without a card, `--device cuda` (the default) raises.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def capacity(m, X, U, backoff):
    """(N, ni) capacity g - G z_k - backoff_k of a nominal (X (N+1, nx), U
    (N, nu), NumPy) under its backoff (N, ni)."""
    G = m.G.detach().cpu().double().numpy()
    g = m.g.detach().cpu().double().numpy().reshape(-1)
    z = np.concatenate([X[: U.shape[0]], U], axis=1)
    return g[None] - z @ G.T - backoff


def capacity_fields(m, X, U, backoff):
    """The record's capacity fields (the row named by `constraint_names`)."""
    cap = capacity(m, X, U, backoff)
    kk, rr = np.unravel_index(np.argmin(cap), cap.shape)
    return {
        "min_capacity": float(cap.min()), "min_capacity_stage": int(kk),
        "min_capacity_row": str(m.constraint_names[rr]),
        "n_rows_exhausted": int((cap <= 0).sum()),
        "min_capacity_untightened": float((cap + backoff).min()),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--run", action="store_true")
    p.add_argument("--artifact",
                   default="artifacts/mc_validation_rocket_converged_tpu_f32_128_r4.npz")
    p.add_argument("--lanes", default=None,
                   help="comma-separated lane ids; default: inner-failure lanes and "
                        "budget-exhausted lanes, --n-auto in all")
    p.add_argument("--n-auto", type=int, default=10, dest="n_auto")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--kkt", default="riccati", choices=["riccati", "fused", "fused_iter", "condensed"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", default=os.path.join("build", "converged_failure_probe.npz"))
    args = p.parse_args(argv)
    if not args.run:
        p.print_help()
        return

    from robust_nonlinear_mpc_torch.expe.main_monte_carlo_validation import configure, draws
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist
    from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve

    dtype = torch.float32 if args.device == "cuda" else torch.float64
    d = np.load(args.artifact, allow_pickle=True)
    fw_succ = np.asarray(d["success_mask"], bool)
    fw_scpf = np.asarray(d["scp_failed_mask"], bool)
    B, T = fw_succ.shape
    steps = min(args.steps, T)

    m, solver = make_rocket_problem(15, device=args.device, dtype=dtype)
    configure(solver, kkt=args.kkt, converged=True, scp_eps=1e-3, max_iter_scp=20)
    eps, max_scp, N = solver.opts.epsilon_convergence, int(solver.opts.max_iter_scp), solver.N
    x0s, Ws = draws(m, np.asarray(X0), 0.05, B, T, args.seed)

    if args.lanes:
        lanes = [int(s) for s in args.lanes.split(",")]
    else:
        lane_failed = ~fw_succ.all(axis=1)
        inner = np.flatnonzero((fw_scpf & ~fw_succ).any(axis=1))
        budget = np.flatnonzero(lane_failed & ~np.isin(np.arange(B), inner))
        k = args.n_auto // 2
        lanes = [*map(int, inner[:k]), *map(int, budget[:k])]
    print(f"[converged_probe] replaying lanes {lanes} (eps {eps}, scp cap {max_scp}, "
          f"{args.device})", flush=True)

    dev = solver.Q.device
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    host = lambda a: a[0].detach().cpu().double().numpy()

    def fresh_persist(keep_prev=None, have_prev=None):
        pz = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=1, dtype=dtype,
                                 device=dev, keep_prev=keep_prev)
        return pz if have_prev is None else pz._replace(have_prev=have_prev)

    records = []
    for lane in lanes:
        x = t(x0s[lane : lane + 1])
        nominal = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x, opts=solver.opts.sqp)
        X, U, persist = nominal.X, nominal.U, fresh_persist()
        rec = {"lane": int(lane), "steps": []}
        for k in range(steps):
            deltas, kkts = [], []
            last_ok, failed, done, it = None, False, False, 0
            while not done and not failed and it < max_scp:
                res = solver._iteration(X, U, x, persist, restore=False)
                ok = bool(res.success[0]) and bool(torch.isfinite(res.X).all()
                                                   and torch.isfinite(res.U).all())
                delta = float(res.delta_vec.abs().max())
                deltas.append(delta)
                kkts.append(float(res.sls.qp_kkt[0]))
                if ok:
                    X, U, persist = res.X, res.U, res.persist
                    last_ok = (host(res.X), host(res.U), host(res.sls.backoff))
                    done = delta < eps
                else:
                    failed = True
                it += 1
            srec = {
                "t": k, "iters": it, "success": bool(done),
                "mode": "inner_failure" if failed else ("converged" if done else "budget_exhausted"),
                "deltas": deltas, "final_delta": deltas[-1] if deltas else float("nan"),
                "qp_kkt_at_end": kkts[-1] if kkts else float("nan"),
                "artifact_success": bool(fw_succ[lane, k]),
                "artifact_scp_failed": bool(fw_scpf[lane, k]),
            }
            if len(deltas) >= 3:
                ds = np.asarray(deltas[-6:-1] if failed else deltas[-5:])
                ds = ds[ds > 0]
                if len(ds) >= 2:
                    srec["contraction"] = float(np.exp(np.mean(np.diff(np.log(ds)))))
            if (failed or not done) and last_ok is not None:
                srec.update(capacity_fields(m, *last_ok))
            rec["steps"].append(srec)
            agree = srec["success"] == srec["artifact_success"]
            cap = (f" cap={srec['min_capacity']:+.4f}@{srec['min_capacity_row']}"
                   if "min_capacity" in srec else "")
            print(f"  lane {lane} t={k}: {srec['mode']:>16} it={it:2d} "
                  f"delta={srec['final_delta']:.2e}{cap}"
                  + ("" if agree else "  [MASK MISMATCH vs artifact]"), flush=True)
            # advance: the plant step, the warm shift, a fresh SLS state
            x = m.ddyn(x, U[:, 0]) + t(Ws[lane, k][None]) @ m.E.T
            X, U = solver._warm_shift(X, U)
            persist = fresh_persist(keep_prev=persist.prev_primal, have_prev=persist.have_prev)
        records.append(rec)

    modes, agree, total = {}, 0, 0
    for rec in records:
        for s in rec["steps"]:
            modes[s["mode"]] = modes.get(s["mode"], 0) + 1
            agree += s["success"] == s["artifact_success"]
            total += 1
    print(f"[converged_probe] step modes over replayed lanes: {modes}; replay/artifact "
          f"success agreement {agree}/{total}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, records=json.dumps(records), lanes=np.asarray(lanes, np.int32),
             eps=eps, max_scp=max_scp, artifact=args.artifact)
    print(f"[converged_probe] saved {args.out}", flush=True)


if __name__ == "__main__":
    main()

"""Monte-Carlo tube validation: batched disturbance-realization closed-loop
rollouts on one card or sharded over a scenario mesh (port of
`robust_nonlinear_mpc_tpu/expe/main_monte_carlo_validation.py`).

B closed-loop scenarios of the chosen system run as one batch; the x0 and
disturbance draws come from `np.random.default_rng(seed)` in the JAX
driver's order, so lane b here is lane b of a JAX run. Reported:

  * closed-loop constraint violations across all scenarios and steps, and
    those on steps whose own solve and whose tube-predicting previous solve
    succeeded (`n_violation_steps_on_success`, the guarantee);
  * one-step tube containment: the realized next state must lie within the
    predicted nominal +- backoff_x[1] box of the previous step's solve;
  * mean closed-loop cost, failure counts and the failure taxonomy.

The statistics, the artifact's keys and its tag are the JAX driver's; the
closed loop's host reads and CUDA graph replays a step go beside it
(`graph_record`, `<artifact>.graphs.json`). The
type is float32 on the card and float64 on the CPU, as the JAX driver runs
float32 on the TPU and float64 on the CPU; `--kkt` applies in both types
(the JAX driver applies it in float32 only).

The mesh is one process per device (`parallel/mesh.py`): on the CPU,
`--host-devices W` starts W gloo processes (the counterpart of the JAX
driver's W virtual devices; the default here is 1, the JAX driver's 8); on
cards, one rank per GPU under torchrun. B is rounded down to a multiple of
W x chunks, every rank draws the same global ensemble, so lane b is still
lane b, and rank 0 alone writes the artifact ("devices" is W).

Usage:
  python -m robust_nonlinear_mpc_torch.expe.main_monte_carlo_validation --run \\
      [--system rocket] [--scenarios 256] [--steps 10] [--device cuda|cpu] \\
      [--host-devices W]
  torchrun --nproc-per-node W -m robust_nonlinear_mpc_torch.expe.main_monte_carlo_validation \\
      --run --device cuda [...]
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter
from pathlib import Path

import numpy as np
import torch

FOLDER = "monte_carlo_validation"


def make_problem(system, device, dtype):
    """(model, solver, x_center, x_spread) of one system at the JAX
    driver's settings."""
    from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver

    if system == "rocket":
        from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
            X0,
            make_rocket_problem,
        )

        m, solver = make_rocket_problem(15, device=device, dtype=dtype)
        return m, solver, np.array(X0), 0.05
    if system == "quadrotor":
        from robust_nonlinear_mpc_torch.models.quadrotor import Quadrotor

        m = Quadrotor(dtype=dtype, device=device)
        Q = np.diag([10.0] * 3 + [1.0] * 3 + [1.0] * 4 + [2.0] * 3)
        st = np.deg2rad(2.0)
        qv = 0.5 * st
        qw = 0.1 * qv
        m.E = torch.as_tensor(m.dt * 5 * np.diag(
            [0.10, 0.10, 0.10, 0.15, 0.15, 0.15, qw, qv, qv, qv, 0.2, 0.2, 0.2]
        ), dtype=dtype, device=m.G.device)
        solver = SCPSLSSolver(
            15, Q, np.eye(4), m, 10 * Q,
            Q_reg=1e4 * np.eye(13), R_reg=1e4 * np.eye(4), Q_reg_f=1e4 * np.eye(13),
            rti=1, fast_sls_rti_steps=1, dtype=dtype, device=m.G.device,
        )
        x_center = np.concatenate([np.full(3, 2.0), np.zeros(3), [1.0, 0, 0, 0], np.zeros(3)])
        return m, solver, x_center, 0.2
    if system == "pendulum":
        from robust_nonlinear_mpc_torch.models.pendulum import Pendulum

        m = Pendulum(dtype=dtype, device=device)
        m.E = torch.as_tensor(0.003 * np.eye(4), dtype=dtype, device=m.G.device)
        solver = SCPSLSSolver(
            15, np.eye(4), np.eye(1), m, 10 * np.eye(4),
            Q_reg=1e3 * np.eye(4), R_reg=1e3 * np.eye(1), Q_reg_f=1e4 * np.eye(4),
            rti=1, fast_sls_rti_steps=1, dtype=dtype, device=m.G.device,
        )
        return m, solver, np.array([0.5, 0.5, 0.0, 0.0]), 0.1
    raise ValueError(system)


def configure(solver, *, recycle=False, streaming=False, warm_qp=False, qp_iters=15,
              kkt="riccati", converged=False, adaptive=False, scp_eps=None,
              max_iter_scp=None, soft_fallback=False, restoration=False, qp_tol=None,
              stall_damping=0.0):
    """The JAX driver's option edits, in its order."""
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions
    from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions

    f32 = solver.dtype == torch.float32
    o = solver.opts._replace(verbose=False)
    if converged:
        # until convergence (the reference default): the SCP delta criterion
        # at what the type can reach (1e-3 float32, 1e-8 float64), a budget
        # scaled to it, and up to 60 inner fast-SLS iterations
        o = o._replace(
            rti=-1, fast_sls_rti_steps=0,
            epsilon_convergence=scp_eps if scp_eps is not None else (1e-3 if f32 else 1e-8),
            max_iter_scp=int(max_iter_scp if max_iter_scp is not None else (20 if f32 else 80)),
            sls_max_iter=60,
        )
    if f32:
        tol = float(qp_tol) if qp_tol is not None else 3e-5
        if adaptive:
            o = o._replace(ipm=IPMOptions(max_iter=15, tol=tol, kkt=kkt),
                           adaptive_ipm_budget=(int(qp_iters), 15))
        else:
            o = o._replace(ipm=IPMOptions(max_iter=int(qp_iters), tol=tol, kkt=kkt))
        o = o._replace(sqp=SQPOptions(ipm=IPMOptions(max_iter=15, tol=3e-5),
                                      tol_step=1e-4, tol_feas=1e-4, max_iter=25))
    else:
        o = o._replace(ipm=o.ipm._replace(kkt=kkt))
        if qp_tol is not None:
            o = o._replace(ipm=o.ipm._replace(tol=float(qp_tol)))
    o = o._replace(recycle_eta=recycle, streaming_response=streaming,
                   recycle_warm_qp=recycle and warm_qp)
    if soft_fallback:
        o = o._replace(nominal_soft_fallback=True)
    if restoration:
        o = o._replace(feasibility_restoration=True)
    if stall_damping:
        o = o._replace(scp_stall_damping=float(stall_damping))
    solver.opts = o
    return solver


def draws(m, x_center, x_spread, B, steps, seed):
    """x0s (B, nx) and disturbances Ws (B, steps, nw) in [-1, 1], in the JAX
    driver's order."""
    rng = np.random.default_rng(seed)
    x0s = np.asarray(x_center[None] + x_spread * rng.standard_normal((B, m.nx)))
    Ws = 2 * rng.random((B, steps, m.nw)) - 1
    return x0s, Ws


def statistics(logs, stats, m, steps):
    """The JAX driver's statistics from host logs (numpy, batch-leading) and
    the aggregate: the artifact's fields, without the run's settings."""
    B = logs["success"].shape[0]
    succ = np.asarray(logs["success"]).astype(bool)     # (B, T)
    xs = np.asarray(logs["state_trajectory"])           # (B, T, nx)
    us = np.asarray(logs["input_trajectory"])           # (B, T-1, nu)
    nom = np.asarray(logs["nominal_x"])                 # (B, T, N+1, nx)
    bo = np.asarray(logs["backoff_x"])                  # (B, T, N+1, nx)

    # one-step tube containment: |x_{t+1} - nominal_x[t, 1]| <= backoff_x[t, 1]
    dev = np.abs(xs[:, 1:] - nom[:, :-1, 1])
    margin = bo[:, :-1, 1] - dev                        # NaN: no tube
    ok_step = succ[:, :-1] & np.isfinite(margin).all(axis=-1)
    contained = margin >= -1e-6
    containment_rate = float(contained[ok_step].mean()) if ok_step.any() else float("nan")
    containment_rate_all = float(np.where(ok_step[..., None], contained, False).mean())
    worst_tube_margin = float(margin[ok_step].min()) if ok_step.any() else float("nan")
    cold = min(3, margin.shape[1])
    cont_cold = contained[:, :cold][ok_step[:, :cold]]
    cont_steady = contained[:, cold:][ok_step[:, cold:]]

    # closed-loop constraint margins G [x; u] - g per scenario and step
    Gm = m.G.detach().cpu().numpy().astype(float)
    gv = m.g.detach().cpu().numpy().astype(float).reshape(-1)
    z = np.concatenate([xs[:, :-1], us], axis=-1)
    worst_per_step = (z @ Gm.T - gv).max(axis=-1)       # (B, T-1)
    viol_step = worst_per_step > 0
    # solve t produced u_t; solve t-1 predicted the tube containing x_t
    prev_ok = np.concatenate([np.ones((B, 1), bool), succ[:, : max(steps - 2, 0)]], axis=1)
    viol_on_success = viol_step & succ[:, :-1] & prev_ok
    worst_per_scenario = worst_per_step.max(axis=1)
    viol_scen = np.flatnonzero(worst_per_scenario > 0)
    top = viol_scen[np.argsort(worst_per_scenario[viol_scen])[::-1]][:8]
    scp_failed = np.asarray(logs["scp_failed"]).astype(bool)
    miss = ok_step & ~contained.all(axis=-1)
    return {
        "n_violations": int(stats.n_violations),
        "n_violation_steps": int(viol_step.sum()),
        "n_violation_steps_on_success": int(viol_on_success.sum()),
        "worst_constraint_margin": float(stats.worst_margin),
        "worst_violation_per_scenario_top": worst_per_scenario[top],
        "violating_scenario_ids": top.astype(np.int32),
        "mean_cost": float(stats.mean_cost),
        "n_failed_lanes": int(stats.n_failed_lanes),
        "tube_miss_mask": miss,
        "viol_on_success_mask": viol_on_success,
        "tube_miss_lane_ids": np.flatnonzero(miss.any(axis=1)).astype(np.int32),
        "tube_containment_rate": containment_rate,
        "tube_containment_rate_all": containment_rate_all,
        "tube_containment_cold": float(cont_cold.mean()) if cont_cold.size else float("nan"),
        "tube_containment_steady": float(cont_steady.mean()) if cont_steady.size else float("nan"),
        "worst_tube_margin": worst_tube_margin,
        "success_rate": float(succ.mean()),
        "n_failed_steps": int((~succ).sum()),
        "n_failed_scenarios": int((~succ).any(axis=1).sum()),
        "n_failed_inner": int(((~succ) & scp_failed).sum()),
        "n_failed_unconverged": int(((~succ) & ~scp_failed).sum()),
        "scp_iters": np.asarray(logs["scp_iters"]),
        "scp_failed_mask": scp_failed,
        "success_mask": succ,
        "state_trajectories": xs[: min(B, 64)],
    }


def graph_record(records, scp_per_dispatch):
    """What the closed loop's `run.record` says of each chunk (this rank's
    lanes), written beside the artifact as `<artifact>.graphs.json` (the
    artifact keeps the JAX driver's keys): whether its loops and pieces ran
    as CUDA graphs (`captured`), the host reads of a device flag and the
    graph replays (a loop's: its body runs; eagerly: the pieces run) of the
    seed and of each step (chunk-major lists), each piece's replays summed
    over the steps, and the port's kernel launches of each step (as CUDA
    graphs: each graph's launches outside its loops once a replay and
    those of each loop body once a body run, from the WHILE nodes' device
    counters; eagerly: the wrappers' counts)."""
    runs = lambda c: sum(v for k, v in c.items() if k != "host_reads")
    by_piece = Counter()
    for r in records:
        for c in r["steps"]:
            by_piece.update(c)
    del by_piece["host_reads"]
    return {
        "captured": bool(records[0]["captured"]),
        "scp_per_dispatch": int(scp_per_dispatch),
        "seed_host_reads": [r["seed"]["host_reads"] for r in records],
        "seed_graph_replays": [runs(r["seed"]) for r in records],
        "host_reads_per_step": [c["host_reads"] for r in records for c in r["steps"]],
        "graph_replays_per_step": [runs(c) for r in records for c in r["steps"]],
        "graph_replays_by_piece": dict(sorted(by_piece.items())),
        "kernel_launches_per_step": [dict(c) for r in records for c in r["step_launches"]],
    }


def tag_of(system, recycle, streaming, warm_qp, converged, soft_fallback, restoration,
           stall_damping, qp_tol, max_iter_scp, adaptive):
    return (
        f"mc_validation_{system}"
        + ("_recycle" if recycle else "")
        + ("_streaming" if streaming else "")
        + ("_warmqp" if (recycle and warm_qp) else "")
        + ("_converged" if converged else "")
        + ("_softfb" if soft_fallback else "")
        + ("_restoration" if restoration else "")
        + (f"_damp{stall_damping:g}" if stall_damping else "")
        + (f"_qptol{qp_tol:g}" if qp_tol is not None else "")
        + (f"_cap{max_iter_scp}" if max_iter_scp is not None else "")
        + ("_adaptive" if adaptive else "")
    )


def generate(system="rocket", scenarios=256, steps=10, device="cuda", seed=0,
             recycle=False, streaming=False, warm_qp=False, qp_iters=15,
             kkt="riccati", converged=False, adaptive=False,
             scp_eps=None, max_iter_scp=None, chunks=1, scp_per_dispatch=2,
             soft_fallback=False, restoration=False, qp_tol=None,
             stall_damping=0.0, mesh=None):
    """Run the validation and save its artifact; returns the npz path. With
    a scenario `mesh` every rank calls this with the same arguments and
    rolls out its block of each chunk; rank 0 writes the artifact and
    returns its path, the other ranks return None."""
    from robust_nonlinear_mpc_torch.expe._common import save_results
    from robust_nonlinear_mpc_torch.parallel.mc import MCStats, run_monte_carlo
    from robust_nonlinear_mpc_torch.sim.closed_loop import (
        build_batched_closed_loop,
        build_chunked_converged_loop,
    )
    from robust_nonlinear_mpc_torch.utils.device import checked_device

    device = checked_device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    m, solver, x_center, x_spread = make_problem(system, device, dtype)
    configure(solver, recycle=recycle, streaming=streaming, warm_qp=warm_qp, qp_iters=qp_iters,
              kkt=kkt, converged=converged, adaptive=adaptive, scp_eps=scp_eps,
              max_iter_scp=max_iter_scp, soft_fallback=soft_fallback,
              restoration=restoration, qp_tol=qp_tol, stall_damping=stall_damping)

    n_dev = 1 if mesh is None else mesh.size
    chunks = max(1, int(chunks))
    B = (scenarios // (n_dev * chunks)) * n_dev * chunks
    if B == 0:
        raise ValueError(
            f"scenarios={scenarios} < devices*chunks={n_dev * chunks}: "
            f"the per-chunk shard would be empty. Raise --scenarios, lower "
            f"--chunks, or (on CPU) lower --host-devices."
        )
    Bc = B // chunks
    x0s_h, Ws_h = draws(m, x_center, x_spread, B, steps, seed)

    if converged and scp_per_dispatch > 0:
        rollout = build_chunked_converged_loop(solver, steps, scp_per_dispatch=scp_per_dispatch)
    else:
        rollout = build_batched_closed_loop(solver, steps)
    run = lambda x0s, Ws: run_monte_carlo(solver, steps, x0s, Ws, mesh=mesh, rollout=rollout)
    logs_np, stats_list, records = [], [], []
    for c in range(chunks):
        sl = slice(c * Bc, (c + 1) * Bc)
        lc, sc = run(x0s_h[sl], Ws_h[sl])
        logs_np.append({k: v.detach().cpu().numpy() for k, v in lc._asdict().items()})
        stats_list.append(sc)
        records.append(rollout.record)
    logs = {k: np.concatenate([lg[k] for lg in logs_np], axis=0) for k in logs_np[0]}
    n_ok_total = sum(s.n_scenarios - s.n_failed_lanes for s in stats_list)
    stats = MCStats(
        n_scenarios=sum(s.n_scenarios for s in stats_list),
        n_violations=sum(s.n_violations for s in stats_list),
        worst_margin=max(s.worst_margin for s in stats_list),
        # over the successful lanes, each chunk weighted by its count; a
        # chunk without a successful lane reports NaN and is skipped
        mean_cost=sum(
            s.mean_cost * (s.n_scenarios - s.n_failed_lanes)
            for s in stats_list if s.n_scenarios - s.n_failed_lanes > 0
        ) / max(n_ok_total, 1) if n_ok_total else float("nan"),
        n_failed_lanes=sum(s.n_failed_lanes for s in stats_list),
    )

    results = {
        "system": system,
        "recycle": bool(recycle),
        "adaptive": bool(adaptive),
        "converged": bool(converged),
        "restoration": bool(restoration),
        "soft_fallback": bool(soft_fallback),
        "qp_tol": float(qp_tol) if qp_tol is not None else -1.0,
        "stall_damping": float(stall_damping),
        "qp_iters": int(qp_iters),
        "max_iter_scp_override": int(max_iter_scp) if max_iter_scp is not None else -1,
        "streaming": bool(streaming),
        "warm_qp": bool(recycle and warm_qp),
        "scenarios": B,
        "steps": steps,
        "devices": int(n_dev),
        **statistics(logs, stats, m, steps),
    }
    if mesh is not None and mesh.rank != 0:
        return None
    r = results
    print(
        f"[mc] {system}: {B} scenarios x {steps} steps on {n_dev} device(s) — "
        f"violations={r['n_violations']} scen / {r['n_violation_steps']} steps "
        f"({r['n_violation_steps_on_success']} on successful solves), "
        f"tube containment={r['tube_containment_rate']:.4f} on successful solves "
        f"(cold {r['tube_containment_cold']:.4f} / steady {r['tube_containment_steady']:.4f}; "
        f"worst margin {r['worst_tube_margin']:.4g}), "
        f"success={r['success_rate']:.4f} "
        f"({r['n_failed_steps']} failed steps in {r['n_failed_scenarios']} scenarios; "
        f"{r['n_failed_inner']} inner-solve failures / "
        f"{r['n_failed_unconverged']} budget-exhausted unconverged)"
    )
    rec = graph_record(records, scp_per_dispatch)
    print(f"[mc] {'CUDA graph replays' if rec['captured'] else 'pieces run eagerly'} per step "
          f"{rec['graph_replays_per_step']}, host reads per step {rec['host_reads_per_step']} "
          f"(rank 0's lanes; scp_per_dispatch {scp_per_dispatch})")
    tag = tag_of(system, recycle, streaming, warm_qp, converged, soft_fallback, restoration,
                 stall_damping, qp_tol, max_iter_scp, adaptive)
    path = save_results(FOLDER, tag, results)
    Path(path).with_suffix(".graphs.json").write_text(json.dumps(rec, indent=1))
    return path


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--run", action="store_true", required=True,
                   help="run the validation and save its artifact")
    p.add_argument("--system", default="rocket", choices=["rocket", "pendulum", "quadrotor"])
    p.add_argument("--scenarios", type=int, default=256)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--recycle", action="store_true")
    p.add_argument("--streaming", action="store_true")
    p.add_argument("--warm-qp", action="store_true", dest="warm_qp")
    p.add_argument("--qp-iters", type=int, default=15, dest="qp_iters")
    p.add_argument("--qp-tol", type=float, default=None, dest="qp_tol",
                   help="IPM KKT tolerance (float32 default 3e-5); converged mode: "
                        "tighten (e.g. 1e-5) so the QP noise floor sits below the SCP "
                        "delta criterion")
    p.add_argument("--adaptive", action="store_true",
                   help="steady-state-aware IPM budget (qp_iters steady / 15 cold)")
    p.add_argument("--converged", action="store_true",
                   help="until-convergence SCP/SLS (the reference default) instead of RTI(1/1)")
    p.add_argument("--kkt", default="riccati",
                   choices=["riccati", "fused", "fused_iter", "condensed"],
                   help="the IPM's Newton solves: the torch Riccati loops, the fused "
                        "CUDA kernels, the whole iteration as one kernel, or the "
                        "condensed KKT (a research option)")
    p.add_argument("--chunks", type=int, default=1,
                   help="split the batch into this many equal runs and aggregate")
    p.add_argument("--scp-per-dispatch", type=int, default=2, dest="scp_per_dispatch",
                   help="converged mode: > 0 runs build_chunked_converged_loop (the soft "
                        "fallback in chunks), reading whether every lane is decided once "
                        "every this many SCP iterations (host reads, not results, change); "
                        "0 build_batched_closed_loop (a read after every SCP iteration)")
    p.add_argument("--max-iter-scp", type=int, default=None, dest="max_iter_scp",
                   help="converged-mode SCP budget (default 20 float32 / 80 float64)")
    p.add_argument("--scp-eps", type=float, default=None, dest="scp_eps",
                   help="converged-mode SCP delta criterion (default 1e-3 float32 / 1e-8 float64)")
    p.add_argument("--stall-damping", type=float, default=0.0, dest="stall_damping",
                   help="converged mode: damped step acceptance (alpha) after 15 SCP "
                        "iterations (0 = off)")
    p.add_argument("--restoration", action="store_true",
                   help="feasibility restoration on an inner infeasible-forward event")
    p.add_argument("--soft-fallback", action="store_true", dest="soft_fallback",
                   help="soft-slack cold-start fallback for the lanes whose hard SQP failed")
    p.add_argument("--host-devices", type=int, default=1, dest="host_devices",
                   help="--device cpu: run the mesh as this many gloo processes (the JAX "
                        "driver's virtual CPU devices); on cards run one rank per GPU under "
                        "torchrun instead")
    args = p.parse_args(argv)
    kw = dict(recycle=args.recycle, streaming=args.streaming, warm_qp=args.warm_qp,
              qp_iters=args.qp_iters, kkt=args.kkt, converged=args.converged,
              adaptive=args.adaptive, scp_eps=args.scp_eps,
              max_iter_scp=args.max_iter_scp, chunks=args.chunks,
              scp_per_dispatch=args.scp_per_dispatch,
              soft_fallback=args.soft_fallback, restoration=args.restoration,
              qp_tol=args.qp_tol, stall_damping=args.stall_damping)
    pos = (args.system, args.scenarios, args.steps, args.device, args.seed)
    if "WORLD_SIZE" in os.environ:
        # under torchrun: this process is one rank of the world
        return generate_on_mesh(pos, kw)
    if args.host_devices > 1:
        if args.device != "cpu":
            raise ValueError("--host-devices starts CPU processes; on cards run one rank per "
                             "GPU under torchrun")
        from robust_nonlinear_mpc_torch.parallel.distributed import launch

        return launch(generate_on_mesh, args.host_devices, pos, kw, backend="gloo")
    return generate(*pos, **kw)


def generate_on_mesh(pos, kw):
    """`generate` as one rank of the world (started by `launch` or torchrun),
    on the mesh of every rank."""
    from robust_nonlinear_mpc_torch.parallel.distributed import (
        global_scenario_mesh,
        init_distributed,
    )

    backend = "nccl" if pos[3] == "cuda" else "gloo"
    init_distributed(backend=backend)
    return generate(*pos, **kw, mesh=global_scenario_mesh())


if __name__ == "__main__":
    main()

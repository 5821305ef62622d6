"""Float32 on the card against float64 on the CPU: the rocket closed loop's
trajectory deviation (port of `robust_nonlinear_mpc_tpu/tools/dtype_deviation.py`).

The same seeded rocket closed loop (N = 15, RTI 1/1, 30 steps, the
disturbance realization of seed 42) runs on both paths; `--compare` reports
max |du| and the containment of each. The rocket loop amplifies any per-step
perturbation (PARITY.md: local gains |du0|/|dx| of 4-54), so the well-posed
measure is the matched-state controller map: the float32 solver is fed the
float64 trajectory's states (teacher forcing, keeping its own warm-start
state) and its u0 is compared at every step. A deviation counts as a dtype
error only where both sides' solves succeeded (see `compare`).

Phases, each its own process:
  python -m robust_nonlinear_mpc_torch.tools.dtype_deviation --phase f64        # the CPU
  python -m robust_nonlinear_mpc_torch.tools.dtype_deviation --phase f32 [--tube default]  # the card
  python -m robust_nonlinear_mpc_torch.tools.dtype_deviation --compare [--variant f32]

The float32 phase runs the bench twin's configuration (`bench.configure`:
kkt="fused", the streaming response, recycled eta, the cross-step QP warm
start, the adaptive (6, 15) IPM budget); `f32_full` the same kernels with
the validation budget (15 flat iterations, no recycling). Artifacts go to
`--out-dir` (default build/dtype_deviation); the float32 phases read the
float64 one's. The float32 phases need the card and raise without one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

SIM_STEPS = 30
NOISE_SEED = 42
OUT_DIR = os.path.join("build", "dtype_deviation")


def _noise(nw: int) -> np.ndarray:
    rng = np.random.default_rng(NOISE_SEED)
    return 2.0 * rng.random((SIM_STEPS, nw)) - 1.0


def _problem(device, dtype):
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )

    m, solver = make_rocket_problem(15, device=device, dtype=dtype)
    solver.opts = solver.opts._replace(verbose=False)
    return m, solver, np.asarray(X0, float)


def _rollout(solver, x0, W):
    """One-scenario closed loop; a dict of NumPy logs."""
    from robust_nonlinear_mpc_torch.sim.closed_loop import build_batched_closed_loop

    log = build_batched_closed_loop(solver, SIM_STEPS)(x0[None], W[None])
    host = lambda t: t[0].detach().cpu().double().numpy()
    return {
        "xs": host(log.state_trajectory),
        "us": np.concatenate([host(log.input_trajectory), host(log.nominal_u)[-1:, 0]]),
        "nominal_x": host(log.nominal_x),
        "backoff_x": host(log.backoff_x),
        "success": host(log.success.double()),
    }


def _matched_state(solver, xs_ref, W):
    """Teacher-forced controller map: at each step the solver sees the float64
    trajectory's state and keeps its own warm-start state. Returns (u0 per
    step, success per step)."""
    from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist
    from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve

    m, N, dt = solver.m, solver.N, solver.dtype
    dev = solver.Q.device
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)
    step = make_mpc_step(solver)
    nominal = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, t(xs_ref[:1]), opts=solver.opts.sqp)
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=1, dtype=dt,
                                  device=dev,
                                  store_phi=not solver._fast_sls_opts().streaming_response)
    carry = (nominal.X, nominal.U, persist, t(xs_ref[:1]))
    u0s, succ = [], []
    for k in range(SIM_STEPS):
        carry, out = step(carry, t(W[k : k + 1]))
        u0s.append(out[1][0].detach().cpu().double().numpy())
        succ.append(float(out[6][0]))
        if k + 1 < SIM_STEPS:
            carry = (carry[0], carry[1], carry[2], t(xs_ref[k + 1 : k + 2]))
    return np.stack(u0s), np.asarray(succ)


def _containment(xs, nominal_x, backoff_x):
    dev = np.abs(xs[1:] - nominal_x[:-1, 1])
    margin = backoff_x[:-1, 1] - dev
    return float((margin >= -1e-6).mean()), float(margin.min())


def phase_f64(out_dir=OUT_DIR):
    m, solver, x0 = _problem("cpu", torch.float64)
    log = _rollout(solver, x0, _noise(m.nw))
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "f64.npz"), **log)
    print(f"[dtype_deviation] f64 CPU: success={log['success'].mean():.4f}", flush=True)


def phase_f32(full_budget=False, out_dir=OUT_DIR):
    from robust_nonlinear_mpc_torch import bench
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions

    bench.require_cuda()
    m, solver, x0 = _problem("cuda", torch.float32)
    bench.configure(solver)
    if full_budget:
        # the same kernels with the validation budget: separates the float32
        # numerics from the throughput budget in the matched-state failures
        solver.opts = solver.opts._replace(
            ipm=IPMOptions(max_iter=15, tol=3e-5, kkt="fused"), adaptive_ipm_budget=None,
            recycle_eta=False, recycle_warm_qp=False)
    W = _noise(m.nw)
    log = _rollout(solver, x0, W)
    ref = np.load(os.path.join(out_dir, "f64.npz"))
    u_ms, succ_ms = _matched_state(solver, ref["xs"], W)
    tag = "f32_full" if full_budget else "f32"
    np.savez(os.path.join(out_dir, f"{tag}.npz"), **log, us_matched=u_ms, success_matched=succ_ms)
    print(f"[dtype_deviation] {tag} {torch.cuda.get_device_name(0)} ({bench.gpu_identity()[2]}): "
          f"success={log['success'].mean():.4f} matched-state success={succ_ms.mean():.4f}",
          flush=True)


def compare(tag="f32", out_dir=OUT_DIR):
    """The failure-aware deviation report. A deviation |du| measures the
    dtype's error only at steps where both solves succeeded: a failed
    teacher-forced float32 step keeps its previous u0 (staleness under a
    flagged failure), and where the float64 solve failed the two may pick
    different local solutions. So the bound is max |du| over steps where
    both succeeded; the others are counted and listed apart."""
    a = np.load(os.path.join(out_dir, "f64.npz"))
    b = np.load(os.path.join(out_dir, f"{tag}.npz"))
    du_cl = np.abs(a["us"] - b["us"]).max(axis=1)
    du_ms = np.abs(a["us"] - b["us_matched"]).max(axis=1)
    ok_a = a["success"] > 0.5
    ok_ms = (b["success_matched"] > 0.5) & ok_a
    ok_cl = (b["success"] > 0.5) & ok_a
    cont_a = _containment(a["xs"], a["nominal_x"], a["backoff_x"])
    cont_b = _containment(b["xs"], b["nominal_x"], b["backoff_x"])
    out = {
        "variant": tag,
        "matched_state_max_dU_success": float(du_ms[ok_ms].max()) if ok_ms.any() else None,
        "matched_state_median_dU_success": float(np.median(du_ms[ok_ms])) if ok_ms.any() else None,
        "n_both_success_steps": int(ok_ms.sum()),
        "matched_state_max_dU_all": float(du_ms.max()),
        "matched_state_failed_steps": np.flatnonzero(~ok_ms).tolist(),
        "matched_state_failed_dU": du_ms[~ok_ms].tolist(),
        "f64_failed_steps": np.flatnonzero(~ok_a).tolist(),
        "closed_loop_max_dU_success": float(du_cl[ok_cl].max()) if ok_cl.any() else None,
        "closed_loop_max_dU_all": float(du_cl.max()),
        "closed_loop_dU_step0": float(du_cl[0]),
        "u_scale": float(np.abs(a["us"]).max()),
        "f64_containment": cont_a[0], "f32_containment": cont_b[0],
        "f64_worst_margin": cont_a[1], "f32_worst_margin": cont_b[1],
        "f64_success": float(a["success"].mean()), "f32_success": float(b["success"].mean()),
        "f32_matched_success": float(b["success_matched"].mean()),
        "steps": SIM_STEPS,
    }
    print(json.dumps(out, indent=2), flush=True)
    return out


def main(argv=None):
    from robust_nonlinear_mpc_torch.utils.numerics import set_tube_precision

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--phase", choices=["f64", "f32", "f32_full"])
    p.add_argument("--compare", action="store_true")
    p.add_argument("--variant", default="f32", choices=["f32", "f32_full"],
                   help="which float32 artifact --compare reads")
    p.add_argument("--tube", default="highest", choices=["highest", "default"],
                   help="the float32 phases' tube precision (the JAX tool runs 'default')")
    p.add_argument("--out-dir", default=OUT_DIR, dest="out_dir")
    args = p.parse_args(argv)
    set_tube_precision(args.tube)
    if args.phase == "f64":
        phase_f64(args.out_dir)
    elif args.phase in ("f32", "f32_full"):
        phase_f32(args.phase == "f32_full", args.out_dir)
    if args.compare:
        compare(args.variant, args.out_dir)


if __name__ == "__main__":
    main()

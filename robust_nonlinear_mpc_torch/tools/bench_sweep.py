"""Multi-system throughput sweep: warm closed-loop MPC steps/s for every
reference model on the card (port of
`robust_nonlinear_mpc_tpu/tools/bench_sweep.py`).

The bench twin (`robust_nonlinear_mpc_torch.bench`) pins the headline
metric, the rocket in the reference's true-RTI configuration. This sweep
runs the other systems at their reference configurations, as the JAX sweep
does: the pendulum and the quadrotor take rti = 3 outer SCP iterations with
fast_sls_rti_steps = 2, so one "step" is a whole warm MPC step with all its
outer iterations. Every system runs in float32 with the JAX sweep's IPM
options (15 iterations, tolerance 3e-5; the first QP 8 and 1e-3), recycled
eta and the streaming response by default, every lane seeded by the SQP at
a perturbed initial state (seed 0), 30 untimed warm-in steps, then `--reps`
timed steps, each a replay of the step captured as one CUDA graph
(`sim.closed_loop.capture_mpc_step`). The tube runs at "highest" unless
`--tube default` (the JAX sweep's float32 setting, TF32 tube GEMMs here).

Usage (needs the card; raises without one):
  python -m robust_nonlinear_mpc_torch.tools.bench_sweep [systems...]
      [--batch 256] [--reps 10] [--warmup 30] [--kkt fused] [--no-recycle]
      [--no-streaming] [--tube highest|default]
Prints one JSON line per system, with the GPU's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from robust_nonlinear_mpc_torch import bench

SYSTEMS = ("pendulum", "quadrotor", "rocket")


def make_system(system, N, device, dtype):
    """(model, solver, x_center) of a system in the JAX sweep's (and JAX
    precompile's) configuration."""
    from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver

    if system == "rocket":
        from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
            X0,
            make_rocket_problem,
        )

        m, solver = make_rocket_problem(N=N, device=device, dtype=dtype)
        return m, solver, np.array(X0)
    if system == "quadrotor":
        from robust_nonlinear_mpc_torch.models.quadrotor import Quadrotor

        m = Quadrotor(dtype=dtype, device=device)
        Q = np.diag([10.0] * 3 + [1.0] * 3 + [1.0] * 4 + [2.0] * 3)
        m.E = torch.as_tensor(
            m.dt * 5 * np.diag([0.1] * 3 + [0.15] * 3 + [0.02] * 4 + [0.2] * 3),
            dtype=dtype, device=m.G.device)
        solver = SCPSLSSolver(
            N, Q, np.eye(4), m, 10 * Q,
            Q_reg=1e4 * np.eye(13), R_reg=1e4 * np.eye(4), Q_reg_f=1e4 * np.eye(13),
            rti=3, fast_sls_rti_steps=2, dtype=dtype, device=m.G.device,
        )
        return m, solver, np.concatenate([np.full(3, 2.0), np.zeros(3), [1, 0, 0, 0], np.zeros(3)])
    if system == "pendulum":
        from robust_nonlinear_mpc_torch.models.pendulum import Pendulum

        m = Pendulum(dtype=dtype, device=device)
        m.E = torch.as_tensor(0.003 * np.eye(4), dtype=dtype, device=m.G.device)
        solver = SCPSLSSolver(
            N, np.eye(4), np.eye(1), m, 10 * np.eye(4),
            Q_reg=1e3 * np.eye(4), R_reg=1e3 * np.eye(1), Q_reg_f=1e4 * np.eye(4),
            rti=3, fast_sls_rti_steps=2, dtype=dtype, device=m.G.device,
        )
        return m, solver, np.array([0.5, 0.5, 0.0, 0.0])
    raise ValueError(f"unknown system {system!r}")


def bench_system(system, B=256, n_rep=10, n_warm=30, kkt="fused", recycle=True,
                 streaming=True, N=15):
    """One system's JSON record."""
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions
    from robust_nonlinear_mpc_torch.sim.closed_loop import capture_mpc_step
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist
    from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve
    from robust_nonlinear_mpc_torch.utils.numerics import tube_prec

    bench.require_cuda()
    dtype, device = torch.float32, torch.device("cuda")
    m, solver, x_center = make_system(system, N, device, dtype)
    solver.opts = solver.opts._replace(
        verbose=False,
        ipm=IPMOptions(max_iter=15, tol=3e-5, kkt=kkt),
        ipm_first=IPMOptions(max_iter=8, tol=1e-3, kkt=kkt),
        streaming_response=streaming, recycle_eta=recycle, sls_block=0,
    )
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x0s = t(x_center[None] + 0.02 * rng.standard_normal((B, m.nx)))
    nominal = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s, opts=solver.opts.sqp)
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=B, dtype=dtype,
                                  device=device, store_phi=not streaming)
    carry = (nominal.X, nominal.U, persist, x0s)
    w_seq = t(rng.uniform(-1.0, 1.0, (max(1, n_warm) + n_rep, B, m.nw)))
    step = capture_mpc_step(solver, carry)
    for i in range(max(1, n_warm)):
        carry, out = step(carry, w_seq[i])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_rep):
        carry, out = step(carry, w_seq[max(1, n_warm) + i])
    torch.cuda.synchronize()
    dt_s = time.perf_counter() - t0
    return {
        "metric": f"{system}_sls_mpc_steps_per_s",
        "value": B * n_rep / dt_s,
        "unit": "closed-loop MPC steps/s",
        "rti": max(int(solver.opts.rti), 1),
        "fast_sls_rti_steps": int(solver.opts.fast_sls_rti_steps),
        "batch": B, "reps": n_rep, "warmup_reps": n_warm,
        "device": torch.cuda.get_device_name(0), "gpu": bench.gpu_identity()[2],
        "dtype": "float32", "kkt": kkt, "tube_precision": tube_prec(),
        "sqp_seed_success": float(nominal.success.float().mean()),
        "success_fraction": float(out[6].float().mean()),
        "finite": bool(torch.isfinite(carry[0]).all() and torch.isfinite(carry[3]).all()),
    }


def main(argv=None):
    from robust_nonlinear_mpc_torch.utils.numerics import set_tube_precision

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("systems", nargs="*", default=list(SYSTEMS))
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--kkt", default="fused", choices=["fused", "fused_iter", "riccati", "condensed"])
    ap.add_argument("--no-recycle", action="store_false", dest="recycle")
    ap.add_argument("--no-streaming", action="store_false", dest="streaming")
    ap.add_argument("--tube", default="highest", choices=["highest", "default"])
    a = ap.parse_args(argv)
    set_tube_precision(a.tube)
    for system in a.systems:
        print(json.dumps(bench_system(system, a.batch, a.reps, a.warmup, a.kkt, a.recycle,
                                      a.streaming)), flush=True)


if __name__ == "__main__":
    main()

"""Single-instance latency on the card: the device step against the host's
part (port of `robust_nonlinear_mpc_tpu/tools/latency_probe.py`).

The rocket at N = 15, float32, in the bench twin's configuration
(`bench.configure`), one lane seeded by the SQP at X0. Each K in (1, 2, 4,
8) is one captured CUDA graph of K closed-loop MPC steps
(`sim.closed_loop.capture_mpc_step`, the port's counterpart of the JAX
probe's `lax.scan` programs), replayed 30 times, each replay synchronized:

    wall(K) ~= intercept + K * device_step

The slope is the step's time on the card once the host is out of the loop;
the intercept is what one replay costs the host (the copies into the
graph's input buffers, the graph launch and the synchronization). Then the
rolling p50/p99/max over `--steps` synchronized replays of the one-step
graph (the deployed controller's distribution, as the bench twin's latency
loop). Prints one JSON line with the GPU's name and power limit. Needs a
card: it raises without CUDA.

Usage: python -m robust_nonlinear_mpc_torch.tools.latency_probe [--steps 200]
       [--kkt fused|fused_iter|riccati] [--response streaming|materialized|fused]
       [--sls-block 0]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from robust_nonlinear_mpc_torch import bench


def main(n_steps: int = 200, ks=(1, 2, 4, 8), reps: int = 30, kkt: str = "fused",
         response: str = "streaming", sls_block: int = 0):
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )
    from robust_nonlinear_mpc_torch.sim.closed_loop import capture_mpc_step
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist
    from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve

    bench.require_cuda()
    dtype, device = torch.float32, torch.device("cuda")
    m, solver = make_rocket_problem(N=15, device=device, dtype=dtype)
    bench.configure(solver, kkt=kkt, response=response, sls_block=sls_block)
    x0 = torch.as_tensor(np.array(X0)[None], dtype=dtype, device=device)
    nominal = sqp_solve(m, solver.N, solver.Q, solver.R, solver.Qf, x0, opts=solver.opts.sqp)
    persist0 = FastSLSPersist.init(solver.N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=1,
                                   dtype=dtype, device=device,
                                   store_phi=response != "streaming")
    carry0 = (nominal.X, nominal.U, persist0, x0)
    rng = np.random.default_rng(7)
    w_rand = lambda *s: torch.as_tensor(2 * rng.random(s) - 1, dtype=dtype, device=device)

    # --- captured K-step programs: wall(K) = intercept + K * slope ---------
    walls, _ = bench.k_step_walls(solver, carry0,
                                  lambda K: w_rand(1, m.nw) if K == 1 else w_rand(K, 1, m.nw),
                                  ks=ks, reps=reps)
    for K, w in walls.items():
        print(f"[latency] K={K:2d}: wall p50 = {w:.2f} ms ({w / K:.2f} ms/step amortized)",
              flush=True)
    slope, intercept = np.polyfit(np.array(list(walls), float), np.array(list(walls.values())), 1)

    # --- single-step replays (the deployed controller's distribution) -------
    single = capture_mpc_step(solver, carry0)
    carry, _ = single(carry0, w_rand(1, m.nw))
    torch.cuda.synchronize()
    lats = []
    for _ in range(n_steps):
        w = w_rand(1, m.nw)
        t0 = time.perf_counter()
        carry, _ = single(carry, w)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)
    lats = 1e3 * np.asarray(lats)

    name, limit_w, line = bench.gpu_identity()
    out = {
        "device_step_time_ms": round(float(slope), 3),
        "dispatch_overhead_ms": round(float(intercept), 3),
        "fit_points": {int(k): round(float(w), 3) for k, w in walls.items()},
        "single_step_p50_ms": round(float(np.median(lats)), 3),
        "single_step_p99_ms": round(float(np.percentile(lats, 99)), 3),
        "single_step_max_ms": round(float(lats.max()), 3),
        "n_single_steps": n_steps,
        "realtime_budget_ms": 50.0,
        "seed_success": bool(nominal.success.all()),
        "kkt": kkt, "response": response, "sls_block": sls_block,
        "gpu_name": name, "power_limit_w": limit_w, "nvidia_smi": line,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--kkt", default="fused")
    p.add_argument("--response", default="streaming", choices=bench.RESPONSES)
    p.add_argument("--sls-block", type=int, default=0)
    args = p.parse_args()
    main(args.steps, kkt=args.kkt, response=args.response, sls_block=args.sls_block)

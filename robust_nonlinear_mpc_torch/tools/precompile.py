"""Ahead-of-time build and warm-up of the solver on the card (port of
`robust_nonlinear_mpc_tpu/tools/precompile.py`).

The reference needs a per-system code-generation step before its first
solve; the JAX package instead lowers and compiles its MPC iteration ahead
of time into XLA's persistent cache. The port's first solve pays two costs:
building the CUDA kernels with nvcc (`ops/cuda_lib.build_extension`, cached
in the git-ignored build directory `build/robust_nonlinear_mpc_torch/`, so
one build serves later processes) and capturing the closed-loop step as a
CUDA graph (`sim.closed_loop.capture_mpc_step`, which lives only in its
process). `precompile()` does both for a system, horizon and batch, and
returns the captured step, so a controller that calls it at start runs its
first real step as a replay; the command line builds the extension for
later runs and reports both times.

The step is captured from the model's neutral state (zero where the model
has none) with a zero plan, in float32 with the bench twin's solver options
(`bench.configure`), for the systems of `tools/bench_sweep.make_system`.

Usage (needs the card; raises without one):
  python -m robust_nonlinear_mpc_torch.tools.precompile [--system rocket] [--N 15]
      [--batch 1] [--kkt fused]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def precompile(system="rocket", N=15, batch=1, kkt="fused", verbose=True):
    """Build the kernels and capture `system`'s step at (N, batch). Returns
    (the captured step, its carry, {"build_s", "capture_s", "launches"})."""
    from robust_nonlinear_mpc_torch import bench
    from robust_nonlinear_mpc_torch.ops import cuda_lib
    from robust_nonlinear_mpc_torch.sim.closed_loop import capture_mpc_step
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist
    from robust_nonlinear_mpc_torch.tools.bench_sweep import make_system

    bench.require_cuda()
    t0 = time.perf_counter()
    cuda_lib.build_extension()
    t1 = time.perf_counter()
    dtype, device = torch.float32, torch.device("cuda")
    m, solver, _ = make_system(system, N, device, dtype)
    bench.configure(solver, kkt=kkt)
    x = np.asarray(getattr(m, "neutral_state", np.zeros(m.nx)), float)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    carry = (t(np.broadcast_to(x, (batch, N + 1, m.nx))), t(np.zeros((batch, N, m.nu))),
             FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=batch, dtype=dtype,
                                 device=device, store_phi=False),
             t(np.broadcast_to(x, (batch, m.nx))))
    step = capture_mpc_step(solver, carry)
    step(carry, t(np.zeros((batch, m.nw))))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    info = {"build_s": t1 - t0, "capture_s": t2 - t1, "launches": dict(step.launched())}
    if verbose:
        print(f"precompiled {system} N={N} B={batch} on {torch.cuda.get_device_name(0)}: "
              f"kernels built in {info['build_s']:.1f} s, step captured and replayed in "
              f"{info['capture_s']:.1f} s (kernel launches of that replay {info['launches']})",
              flush=True)
    return step, carry, info


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--system", default="rocket", choices=["rocket", "pendulum", "quadrotor"])
    p.add_argument("--N", type=int, default=15)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--kkt", default="fused", choices=["fused", "fused_iter", "riccati", "condensed"])
    a = p.parse_args(argv)
    precompile(a.system, a.N, a.batch, a.kkt)


if __name__ == "__main__":
    main()

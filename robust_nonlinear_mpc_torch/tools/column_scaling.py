"""Horizon (N) scaling of the column-sharded SLS path (port of
`robust_nonlinear_mpc_tpu/tools/column_scaling.py`).

The N + 1 SLS columns are sharded over a mesh of ranks
(`parallel/columns.py`), with only the backoff and cost sums and the K /
beta gathers crossing ranks. This tool times one sharded tube iteration
(eta -> backward Riccati -> streaming response -> backoffs,
`sharded_tube_iteration`) at N in {30, 60, 120} on the pendulum's widths
(nx = 4, nu = 1, nw = 4, ni = 10, ni_f = 8), on a one-rank mesh and on the
mesh of all W ranks, and reports the ms per iteration and each rank's
column slab, ceil((N + 1) / W).

The W ranks are W processes (`parallel.distributed.launch`): gloo on the
CPU, and on one card both ranks share it under gloo (NCCL refuses two ranks
on one device), so the W-rank time there includes the host-staged
collectives and measures overhead, not a speed-up; the division of the work
is the column slab.

Usage: python -m robust_nonlinear_mpc_torch.tools.column_scaling
           [--world 2] [--device cuda|cpu] [--reps 20] [--horizons 30 60 120]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def tube_problem(N, device, dtype=torch.float64, seed=0):
    """One lane of the pendulum-width tube iteration's inputs (the JAX
    tool's)."""
    from robust_nonlinear_mpc_torch.ops.sls_kernels import SLSRegs

    rng = np.random.default_rng(seed)
    nx, nu, ni, ni_f = 4, 1, 10, 8
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return dict(
        A=t(np.eye(nx) + 0.02 * rng.standard_normal((1, N, nx, nx))),
        B=t(0.05 * rng.standard_normal((1, N, nx, nu))),
        E=t(np.tile(0.003 * np.eye(nx)[None], (N + 1, 1, 1))),
        Gmat=t(np.vstack([np.eye(nx + nu), -np.eye(nx + nu)])[:ni]),
        Gf=t(np.vstack([np.eye(nx), -np.eye(nx)])[:ni_f]),
        mu=t(np.abs(rng.standard_normal((1, N, ni)))),
        mu_f=t(np.abs(rng.standard_normal((1, ni_f)))),
        beta_prev=t(np.zeros((1, N, N, ni))),
        beta_f_prev=t(np.zeros((1, N + 1, ni_f))),
        regs=SLSRegs(t(1e3 * np.eye(nx)), t(1e3 * np.eye(nu)), t(1e4 * np.eye(nx))),
    )


def tube_iteration_ms(N, mesh, reps=20):
    """ms of one `sharded_tube_iteration` on `mesh` (on its device) at
    horizon N: the median of `reps` synchronized calls after one warm-up."""
    from robust_nonlinear_mpc_torch.parallel.columns import sharded_tube_iteration

    device = mesh.device
    p = tube_problem(N, device)
    args = (mesh, p["A"], p["B"], p["E"], p["Gmat"], p["Gf"], p["mu"], p["mu_f"],
            p["beta_prev"], p["beta_f_prev"], p["regs"], 1e-10)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    sharded_tube_iteration(*args)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        sharded_tube_iteration(*args)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def scaling_rows(horizons, reps, device):
    """Rank 0's rows: each N timed on a one-rank mesh (rank 0 alone while
    the others wait) and on the mesh of every rank."""
    import torch.distributed as dist

    from robust_nonlinear_mpc_torch.parallel.columns import column_mesh

    world = column_mesh(device=device)
    solo = dist.new_group([0])      # every rank takes part in creating it
    rows = []
    for N in horizons:
        t1 = tube_iteration_ms(N, column_mesh(group=solo, device=device), reps) \
            if world.rank == 0 else None
        dist.barrier()
        tw = tube_iteration_ms(N, world, reps)
        rows.append({
            "N": N, "tube_iter_ms_1rank": t1, f"tube_iter_ms_{world.size}rank": tw,
            "columns_per_rank_1rank": N + 1,
            f"columns_per_rank_{world.size}rank": -(-(N + 1) // world.size),
        })
    return rows


def main(argv=None):
    from robust_nonlinear_mpc_torch.parallel.distributed import launch
    from robust_nonlinear_mpc_torch.utils.device import checked_device

    p = argparse.ArgumentParser(description="column-sharded tube iteration against N")
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--horizons", type=int, nargs="+", default=[30, 60, 120])
    args = p.parse_args(argv)
    device = str(checked_device(args.device))
    rows = launch(scaling_rows, args.world, args.horizons, args.reps, device, backend="gloo")
    for row in rows:
        print(json.dumps(row))
    where = (torch.cuda.get_device_name(0) if device.startswith("cuda")
             else "the host CPU")
    print(json.dumps({
        "device": where,
        "note": f"{args.world} gloo ranks on {where}: the W-rank time includes the collectives "
                "(staged through the host for CUDA tensors) on shared hardware; the "
                "division of the work is columns_per_rank",
        "rows": rows,
    }))


if __name__ == "__main__":
    main()

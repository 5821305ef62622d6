"""Driver entry points of the port (the twin of the repository's
`__graft_entry__.py`).

`entry()` returns (fn, args): one warm SCP-SLS RTI iteration on the rocket
at N = 15 (linearization, the tightened QPs, the column-wise backward
Riccati, the response and the backoffs), `SCPSLSSolver._iteration` on one
lane from the JAX entry's x0 and a fresh persisted state.

`dryrun_multichip(n)` runs one sharded rocket Monte-Carlo (N = 15, B = 2n
lanes from seed 0, 2 steps, RTI 1/1, statistics reduced over the mesh) and
then the chunked until-convergence driver for one step at a dry-run budget,
on a scenario mesh of n ranks: the ranks of the world already initialized,
else this process alone (n = 1) or n spawned processes.

Usage: python -m robust_nonlinear_mpc_torch.entry [--device cuda|cpu] [--dryrun N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

X0_ENTRY = [1.75729, 4.15951, 4.72757, -0.18913, -0.38367, -0.08697, -0.79487, 0.00768,
            -0.21110, -0.56883, -0.12752, -0.58026, -0.76542, 0.20555, 0.54610, -0.40116,
            -0.35401]


def _rocket_solver(N=15, device="cuda", dtype=torch.float64):
    """The reference rocket solver, quiet; float32 takes the JAX entry's IPM
    settings (15 iterations, tolerance 1e-5)."""
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import make_rocket_problem
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions

    m, solver = make_rocket_problem(N, device=device, dtype=dtype)
    if dtype == torch.float32:
        solver.opts = solver.opts._replace(ipm=IPMOptions(max_iter=15, tol=1e-5))
    solver.opts = solver.opts._replace(verbose=False)
    return m, solver


def entry(device="cuda", dtype=None):
    """(fn, args): fn(X, U, x0, persist) -> (X, U, backoff, success) of one
    SCP-SLS iteration, batch-leading with one lane. `dtype` defaults to
    float32 on the card (the JAX entry's precision) and float64 on the CPU."""
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist

    if dtype is None:
        dtype = torch.float32 if torch.device(device).type == "cuda" else torch.float64
    m, solver = _rocket_solver(15, device, dtype)
    N, dev = solver.N, solver.Q.device
    X = torch.zeros((1, N + 1, m.nx), dtype=dtype, device=dev)
    U = torch.zeros((1, N, m.nu), dtype=dtype, device=dev)
    x0 = torch.tensor([X0_ENTRY], dtype=dtype, device=dev)
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=1, dtype=dtype,
                                  device=dev)

    def fn(X, U, x0, persist):
        res = solver._iteration(X, U, x0, persist)
        return res.X, res.U, res.sls.backoff, res.success

    return fn, (X, U, x0, persist)


def _dryrun(n_devices, device):
    from robust_nonlinear_mpc_torch.parallel.mc import run_monte_carlo
    from robust_nonlinear_mpc_torch.parallel.mesh import scenario_mesh
    from robust_nonlinear_mpc_torch.sim.closed_loop import build_chunked_converged_loop

    device = torch.device(device)
    dtype = torch.float32 if device.type == "cuda" else torch.float64
    mesh = scenario_mesh(n_devices=n_devices, device=device)
    m, solver = _rocket_solver(15, device, dtype)
    B, steps = 2 * n_devices, 2
    rng = np.random.default_rng(0)
    x0s = np.array(X0_ENTRY)[None] + 0.02 * rng.standard_normal((B, m.nx))
    Ws = 2 * rng.random((B, steps, m.nw)) - 1
    logs, stats = run_monte_carlo(solver, steps, x0s, Ws, mesh=mesh)
    if stats.n_scenarios != B or not bool(torch.isfinite(logs.state_trajectory).all()):
        raise RuntimeError(f"dryrun_multichip({n_devices}): {stats}")
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    say(f"dryrun_multichip({n_devices}): ok — rocket N=15, {B} scenarios, "
        f"violations={stats.n_violations}, mean_cost={stats.mean_cost:.4e}", flush=True)

    # the chunked until-convergence driver on the same mesh, one step at a
    # budget lanes can reach in about 10 SCP iterations
    _, solver_c = _rocket_solver(15, device, dtype)
    solver_c.opts = solver_c.opts._replace(
        rti=-1, fast_sls_rti_steps=0, epsilon_convergence=1e-3 if dtype == torch.float32 else 1e-4,
        max_iter_scp=12, sls_max_iter=20, verbose=False,
    )
    logs_c = build_chunked_converged_loop(solver_c, 1, scp_per_dispatch=2, mesh=mesh)(
        x0s, Ws[:, :1])
    if logs_c.success.shape != (B, 1) or not bool(torch.isfinite(logs_c.state_trajectory).all()):
        raise RuntimeError(f"dryrun_multichip({n_devices}): the converged driver failed")
    n_ok = int(logs_c.success.sum())
    say(f"dryrun_multichip({n_devices}): converged-mode chunked driver ok — "
        f"success {n_ok}/{B} at the dryrun budget", flush=True)
    return {"scenarios": B, "violations": stats.n_violations, "mean_cost": stats.mean_cost,
            "converged_success": n_ok, "scp_iters": logs_c.scp_iters[:, 0].tolist()}


def dryrun_multichip(n_devices: int, device="cuda"):
    """The sharded rocket MC and the chunked converged driver on a mesh of
    `n_devices` ranks (see the module docstring); returns rank 0's summary.
    NCCL on the card (one card a rank), gloo on the CPU."""
    import torch.distributed as dist

    from robust_nonlinear_mpc_torch.parallel.distributed import init_distributed, launch

    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if dist.is_initialized():
        return _dryrun(n_devices, device)
    if n_devices > 1:
        return launch(_dryrun, n_devices, n_devices, device, backend=backend)
    init_distributed(backend=backend)
    try:
        return _dryrun(1, device)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="also run dryrun_multichip(N)")
    args = p.parse_args(argv)
    fn, fargs = entry(device=args.device)
    out = fn(*fargs)
    print("entry(): ok", [tuple(o.shape) for o in out], flush=True)
    if args.dryrun:
        dryrun_multichip(args.dryrun, device=args.device)


if __name__ == "__main__":
    main()

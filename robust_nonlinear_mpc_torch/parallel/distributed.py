"""Process-group start-up, the global scenario mesh and the multi-process
throughput measurement (port of
`robust_nonlinear_mpc_tpu/parallel/distributed.py`).

The JAX package runs `jax.distributed` in its multi-controller form; the
port runs torch.distributed with one process per device:

  * `init_distributed` joins the process group (a `tcp://` or `file://`
    address with the world size and rank, torchrun's `env://`, or a
    one-process world when neither is given), NCCL on the card and gloo on
    the CPU, and tolerates a group that is already initialized;
  * `global_scenario_mesh` is the 1-D scenario mesh over every rank;
  * `multihost_throughput` measures the sharded Monte-Carlo's scenario-steps
    per second over the whole world;
  * `launch` runs a function in W fresh processes that form one world (the
    counterpart of W virtual CPU devices), for the CLIs and tools.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from robust_nonlinear_mpc_torch.parallel.mesh import scenario_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> int:
    """Join the process group; returns the world size.

    `coordinator_address`: "tcp://host:port" (or JAX's "host:port") or
    "file:///path" with `num_processes` and `process_id`; "env://", or None
    under torchrun (its RANK / WORLD_SIZE / MASTER_ADDR environment); None
    outside torchrun starts a one-process world. `backend` defaults to NCCL
    when a card is present and gloo otherwise; under NCCL each rank takes
    the card of its local rank. A group that is already initialized is
    kept as it is."""
    if dist.is_initialized():
        return dist.get_world_size()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None and "WORLD_SIZE" in os.environ:
        coordinator_address = "env://"
    if coordinator_address == "env://":
        rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
    else:
        rank = 0 if process_id is None else int(process_id)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator_address is None:
        if num_processes not in (None, 1):
            raise ValueError(f"a world of {num_processes} processes needs a coordinator_address "
                             "(or torchrun's environment)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif coordinator_address == "env://":
        dist.init_process_group(backend, init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator_address needs num_processes and process_id")
        addr = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        dist.init_process_group(backend, init_method=addr, world_size=int(num_processes),
                                rank=int(process_id))
    return dist.get_world_size()


def global_scenario_mesh(device=None):
    """The 1-D scenario mesh over every rank of the world."""
    return scenario_mesh(device=device)


def multihost_throughput(solver, sim_steps: int, scenarios_per_device: int = 32,
                         reps: int = 3, x_center=None, x_spread: float = 0.3):
    """The sharded Monte-Carlo's throughput over the whole world: every rank
    calls this; returns the processes, devices, scenarios, scenario-steps per
    second and the violation count. With the default ensemble (the origin
    with spread 0.3) the scenarios are a throughput workload far outside the
    validated MC regime, so `violations` is not a robustness statistic: pass
    the system's validated MC center (e.g. the rocket's X0 with spread 0.05)
    to make it one; `violations_note` says which it is."""
    from robust_nonlinear_mpc_torch.parallel.mc import run_monte_carlo

    device = solver.Q.device
    mesh = global_scenario_mesh(device=device)
    B = scenarios_per_device * mesh.size
    # one shared seed: every rank draws the same global ensemble and takes
    # its own block of it
    rng = np.random.default_rng(0)
    m = solver.m
    center = np.zeros(m.nx) if x_center is None else np.asarray(x_center, float).reshape(-1)
    x0s = center[None] + x_spread * rng.standard_normal((B, m.nx))
    Ws = 2 * rng.random((B, sim_steps, m.nw)) - 1

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    logs, stats = run_monte_carlo(solver, sim_steps, x0s, Ws, mesh=mesh)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        logs, stats = run_monte_carlo(solver, sim_steps, x0s, Ws, mesh=mesh)
    sync()
    dt = (time.perf_counter() - t0) / reps
    return {
        "processes": dist.get_world_size(),
        "devices": mesh.size,
        "scenarios": B,
        "mpc_steps_per_s": B * sim_steps / dt,
        "violations": int(stats.n_violations),
        "violations_note": (
            "validated MC x0 ensemble" if x_center is not None else
            "x0 = {:.2g}*randn around the ORIGIN — a throughput workload "
            "far outside the validated MC regime; this count is NOT a "
            "robustness statistic (compare the MC validation artifacts "
            "instead)".format(x_spread)
        ),
    }


def _rank_main(fn, args, rank, world, address, backend, out):
    if backend == "gloo":
        # W ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    init_distributed(address, world, rank, backend=backend)
    try:
        result = fn(*args)
        if rank == 0:
            out.put(result)
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, *args, backend: str = "gloo", timeout: float | None = None):
    """Run `fn(*args)` in `world` fresh processes (spawned) that form one
    process group over a file store in a temporary directory; returns rank
    0's result. `fn` must be importable (a module-level function). Raises
    if a rank fails (the others are stopped) or the run outlasts `timeout`
    seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        address = f"file://{os.path.join(tmp, 'store')}"
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(fn, args, r, world, address, backend, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, t0 = [], time.monotonic()
        try:
            # drain the queue while the ranks run: a rank blocks on a put
            # that nobody reads
            while any(p.is_alive() for p in procs):
                try:
                    results.append(out.get(timeout=0.2))
                except queue.Empty:
                    pass
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if timeout is not None and time.monotonic() - t0 > timeout:
                    break
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        while True:
            try:
                results.append(out.get(timeout=0.2))
            except queue.Empty:
                break
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes) or not results:
        raise RuntimeError(f"launch: the ranks ended with exit codes {codes}")
    return results[0]

"""Monte-Carlo closed-loop rollouts and tube-violation statistics, on one
card or sharded over a scenario mesh (port of
`robust_nonlinear_mpc_tpu/parallel/mc.py`). Scenarios never communicate:
each rank rolls out its block of the batch, and the statistics reduce over
the mesh (psum -> all_reduce(SUM) for the counts and the cost sum, pmax ->
all_reduce(MAX) for the worst margin); the logs are gathered into the
global layout on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from robust_nonlinear_mpc_torch.parallel.mesh import Mesh, all_reduce, shard_batch, sharded
from robust_nonlinear_mpc_torch.sim.closed_loop import build_batched_closed_loop


class MCStats(NamedTuple):
    """Monte-Carlo aggregate. Solver failure and constraint violation are
    separate events: the cost and margin aggregates are over the successful
    lanes (every step succeeded and the trajectory is finite), and the
    failed lanes are counted beside them."""

    n_scenarios: int
    n_violations: int       # scenarios with any constraint violation
    worst_margin: float     # max constraint value over successful lanes
    mean_cost: float        # mean closed-loop cost over successful lanes
    n_failed_lanes: int     # lanes with a failed step or a non-finite state


def lane_reductions(logs, G, g, Q, R):
    """Per-lane success mask, worst constraint margin and quadratic cost.
    A non-finite margin is masked to -inf, so a failed lane can neither
    count as a violation nor poison the max."""
    finite = torch.isfinite(logs.state_trajectory).all(dim=2).all(dim=1) & \
        torch.isfinite(logs.input_trajectory).all(dim=2).all(dim=1)
    lane_ok = logs.success.all(dim=1) & finite
    z = torch.cat([logs.state_trajectory[:, :-1], logs.input_trajectory], dim=-1)
    margins = torch.einsum("ri,bti->btr", G, z) - g
    margins = torch.where(torch.isfinite(margins), margins, -torch.inf)
    worst = margins.amax(dim=(1, 2))
    xs, us = logs.state_trajectory, logs.input_trajectory
    cost = torch.einsum("bti,ij,btj->b", xs, Q, xs) + torch.einsum("bti,ij,btj->b", us, R, us)
    return lane_ok, worst, cost


def _aggregate(logs, solver, reduce) -> MCStats:
    """The statistics of the lanes of `logs`, each partial sum and maximum
    passed through `reduce(tensor, op)` (identity on one card, all_reduce
    over a mesh): mean_cost = the cost sum over the successful lanes /
    max(n_ok, 1)."""
    m = solver.m
    lane_ok, worst, cost = lane_reductions(logs, m.G, m.g, solver.Q, solver.R)
    counts = torch.stack([
        torch.tensor(lane_ok.numel(), device=lane_ok.device), (worst > 0).sum(), lane_ok.sum(),
        (~lane_ok).sum(),
    ]).to(torch.int64)
    n_scen, n_viol, n_ok, n_failed = reduce(counts, "sum").tolist()
    worst_ok = reduce(torch.where(lane_ok, worst, -torch.inf).amax(), "max")
    cost_sum = reduce(torch.where(lane_ok, cost, torch.zeros_like(cost)).sum(), "sum")
    return MCStats(
        n_scenarios=n_scen, n_violations=n_viol, worst_margin=float(worst_ok),
        mean_cost=float(cost_sum / max(n_ok, 1)), n_failed_lanes=n_failed,
    )


def mc_stats(logs, solver) -> MCStats:
    """The aggregate of one batch of logs."""
    return _aggregate(logs, solver, lambda t, op: t)


def make_sharded_mc(solver, sim_steps: int, mesh: Mesh, rollout=None):
    """fn(x0s (B, nx), Ws (B, T, nw)) -> (ClosedLoopLog, MCStats) over the
    mesh: every rank calls it with the same global inputs (B divisible by
    the mesh size), rolls out its own block with `rollout` (default
    `build_batched_closed_loop(solver, sim_steps)`), and gets the global log
    and the statistics of its own block reduced over every rank."""
    run = sharded(mesh, rollout or build_batched_closed_loop(solver, sim_steps))
    dev = solver.Q.device

    def fn(x0s, Ws):
        logs = run(x0s, Ws)
        stats = _aggregate(shard_batch(mesh, logs), solver,
                           lambda t, op: all_reduce(mesh, t.to(dev), op))
        return logs, stats

    return fn


def run_monte_carlo(solver, sim_steps, x0s, Ws, mesh: Mesh | None = None, rollout=None):
    """Roll out every scenario and aggregate: (ClosedLoopLog, MCStats). One
    card when `mesh` is None, else sharded over the mesh
    (`make_sharded_mc`). `rollout` defaults to
    `build_batched_closed_loop(solver, sim_steps)`."""
    if mesh is not None:
        return make_sharded_mc(solver, sim_steps, mesh, rollout)(x0s, Ws)
    if rollout is None:
        rollout = build_batched_closed_loop(solver, sim_steps)
    logs = rollout(x0s, Ws)
    return logs, mc_stats(logs, solver)

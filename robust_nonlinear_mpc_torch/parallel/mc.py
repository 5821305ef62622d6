"""Monte-Carlo closed-loop rollouts and tube-violation statistics on one
card (port of `MCStats`, `lane_reductions` and, in place of
`make_sharded_mc` / `run_monte_carlo`, a one-card `run_monte_carlo` from
`robust_nonlinear_mpc_tpu/parallel/mc.py`). The multi-process reduction is
ROADMAP.md Open items, queue 1 item 6 (parallel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

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


def mc_stats(logs, solver) -> MCStats:
    """The aggregate of one batch of logs."""
    m = solver.m
    lane_ok, worst, cost = lane_reductions(logs, m.G, m.g, solver.Q, solver.R)
    n_ok = int(lane_ok.sum())
    return MCStats(
        n_scenarios=int(lane_ok.numel()),
        n_violations=int((worst > 0).sum()),
        worst_margin=float(worst[lane_ok].max()) if n_ok else float("-inf"),
        mean_cost=float(cost[lane_ok].mean()) if n_ok else float("nan"),
        n_failed_lanes=int((~lane_ok).sum()),
    )


def run_monte_carlo(solver, sim_steps, x0s, Ws, rollout=None):
    """Roll out every scenario on the solver's device and aggregate:
    (ClosedLoopLog, MCStats). `rollout` defaults to
    `build_batched_closed_loop(solver, sim_steps)`."""
    if rollout is None:
        rollout = build_batched_closed_loop(solver, sim_steps)
    logs = rollout(x0s, Ws)
    return logs, mc_stats(logs, solver)

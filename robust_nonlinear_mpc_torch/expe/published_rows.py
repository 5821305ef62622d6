"""The published guarantee rows: the JAX package's r5 Monte-Carlo validation
results (README "Guarantee results", BASELINE.md), run through the port's
Monte-Carlo driver (`main_monte_carlo_validation`) and held lane by lane
against their artifacts, which are read as plain npz files.

The driver draws the JAX driver's x0s and disturbances from the same seed,
so lane b of a port run is lane b of the published run: `compare` sets the
two side by side, per lane and step (success flags, SCP iterations and
failures, the stored states, the violations on successful solves and the
tube misses, each attributed to its lane and step), and `settle_lanes`
names the lanes whose guarantee a float64 re-run of the same draw must
settle (`--dtype float64 --lanes ...`).

Usage (prints the driver's command line of a row):
  python -m robust_nonlinear_mpc_torch.expe.published_rows --system rocket
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import NamedTuple

import numpy as np

ARTIFACTS = Path(__file__).resolve().parents[2] / "artifacts"
# README's full-mitigation stack of the rocket and quadrotor rows
FULL_MITIGATION = ("--converged", "--soft-fallback", "--restoration", "--max-iter-scp", "40",
                   "--qp-tol", "1e-5", "--stall-damping", "0.5")
# stall damping starts after this many SCP iterations (SCPOptions.stall_damping_after)
STALL_AFTER = 15


class Row(NamedTuple):
    artifact: str          # file under artifacts/
    flags: tuple           # the driver's flags of the row
    success_rate: float    # the published figures
    violations_on_success: int
    containment: float


ROWS = {
    "rocket": Row("mc_validation_rocket_converged_tpu_f32_1024_fullmit_r5.npz",
                  FULL_MITIGATION, 0.96298828125, 0, 1.0),
    "quadrotor": Row("mc_validation_quadrotor_converged_tpu_f32_1024_fullmit_r5.npz",
                     FULL_MITIGATION, 0.9951171875, 2, 0.9889918109813398),
    # the JAX row ran the driver's default kkt="riccati"; the port runs
    # kkt="fused" (the same Newton solve, by K1/K2) so that the kernels are
    # on the path (ROADMAP.md section 3 item 2)
    "pendulum": Row("mc_validation_pendulum_converged_tpu_f32_1024_r5.npz",
                    ("--converged",), 1.0, 0, 1.0),
}
SCENARIOS, STEPS = 1024, 10


def argv(system, scenarios=SCENARIOS, steps=STEPS, chunks=1, device="cuda", extra=()):
    """The Monte-Carlo driver's command line of a published row (at
    `scenarios` x `steps`; the draws are always those of the published
    STEPS-step run, so lane b is the published lane b)."""
    return ["--run", "--system", system, "--scenarios", str(scenarios), "--steps", str(steps),
            "--draw-steps", str(max(steps, STEPS)), "--kkt", "fused", "--device", device,
            "--chunks", str(chunks), *ROWS[system].flags, *extra]


def published(system):
    return np.load(ARTIFACTS / ROWS[system].artifact, allow_pickle=True)


def _side(path):
    return np.load(Path(path).with_suffix(".lanes.npz"))


def _attribute(kind, lane, b, t, excess, it, pub, pub_miss):
    """One violation or tube miss of the port run at (lane, step t), beside
    the published lane's flags at that step."""
    return {
        "kind": kind, "lane": int(lane), "step": int(t), "excess": float(excess),
        "scp_iters": int(it[b, t]), "stall_damped": bool(it[b, t] >= STALL_AFTER),
        "published": {
            "success": bool(pub["success_mask"][lane, t]),
            "scp_iters": int(pub["scp_iters"][lane, t]),
            "scp_failed": bool(pub["scp_failed_mask"][lane, t]),
            "among_violating_ids": bool(np.isin(lane, pub["violating_scenario_ids"])),
            "tube_miss": None if pub_miss is None else bool(pub_miss[lane, t]),
        },
    }


def compare(path, pub=None):
    """The run saved at `path` (the driver's artifact and its `.lanes.npz`)
    against the published artifact of its system, lane by lane over the
    run's steps (and lanes, for a `--lanes` run). Returns a dict of plain
    values; `violations` and `tube_misses` attribute each violation on a
    successful solve and each tube miss to its lane and step."""
    got = np.load(path, allow_pickle=True)
    side = _side(path)
    system = str(got["system"])
    pub = published(system) if pub is None else pub
    gs = got["success_mask"].astype(bool)
    B, T = gs.shape
    lanes = got["lanes"] if "lanes" in got.files else np.arange(B)
    ps = pub["success_mask"][lanes, :T].astype(bool)
    both = gs & ps
    g_it, p_it = got["scp_iters"], pub["scp_iters"][lanes, :T]
    g_fail, p_fail = got["scp_failed_mask"], pub["scp_failed_mask"][lanes, :T]
    pub_miss = pub["tube_miss_mask"] if "tube_miss_mask" in pub.files else None

    # the stored lanes' states x_t where both runs succeeded at every step before t
    n = min(len(got["state_trajectories"]), len(pub["state_trajectories"]))
    stored = lanes[:n] < len(pub["state_trajectories"])
    ok_before = np.concatenate([np.ones((B, 1), bool), np.cumprod(both, axis=1)[:, :-1]
                                .astype(bool)], axis=1)[:n][stored]
    dx = np.abs(got["state_trajectories"][:n][stored]
                - pub["state_trajectories"][lanes[:n][stored], :T])
    dx = dx.max(axis=-1)[ok_before]

    vos, miss = got["viol_on_success_mask"], got["tube_miss_mask"]
    violations = [_attribute("violation", lanes[b], b, t, side["constraint_margin"][b, t], g_it,
                             pub, pub_miss) for b, t in zip(*np.nonzero(vos))]
    misses = [_attribute("tube_miss", lanes[b], b, t, -np.nanmin(side["tube_margin"][b, t]),
                         g_it, pub, pub_miss) for b, t in zip(*np.nonzero(miss))]
    pm = None if pub_miss is None else pub_miss[lanes, : T - 1]
    return {
        "system": system, "B": int(B), "T": int(T),
        "success_rate": float(gs.mean()), "published_success_rate": float(ps.mean()),
        "success_flags_differing": int((gs != ps).sum()),
        "success_flags_differing_per_step": (gs != ps).sum(axis=0).tolist(),
        "success_port_only": int((gs & ~ps).sum()),
        "success_published_only": int((~gs & ps).sum()),
        "both_succeeded": int(both.sum()),
        "scp_iters_equal_on_both": int((g_it == p_it)[both].sum()),
        "scp_iters_mean_abs_diff_on_both": float(np.abs(g_it - p_it)[both].mean())
        if both.any() else 0.0,
        "scp_failed_differing_on_both": int(((g_fail != p_fail) & both).sum()),
        "scp_failed_differing": int((g_fail != p_fail).sum()),
        "n_violation_steps_on_success": int(got["n_violation_steps_on_success"]),
        "n_violation_steps": int(got["n_violation_steps"]),
        "tube_containment_rate": float(got["tube_containment_rate"]),
        "tube_miss_lane_steps": int(miss.sum()),
        "published_tube_miss_lane_steps": None if pm is None else int(pm.sum()),
        "tube_miss_lane_steps_on_both": None if pm is None else int((miss & pm).sum()),
        "states_compared": int(dx.size),
        "states_max_abs_diff": float(dx.max()) if dx.size else 0.0,
        "states_median_abs_diff": float(np.median(dx)) if dx.size else 0.0,
        "violations": violations,
        "tube_misses": misses,
    }


def flagged(a):
    """Whether the published lane of an attribution was itself flagged: it
    failed or missed its tube at that step, or is among the published
    violating scenarios."""
    p = a["published"]
    return (not p["success"]) or bool(p["tube_miss"]) or p["among_violating_ids"]


def settle_lanes(cmp):
    """The lanes whose guarantee a float64 re-run must settle: the rocket's
    and the pendulum's every violation on a successful solve and every tube
    miss (their published rows have none); the quadrotor's violations on a
    lane that is neither stall-damped nor flagged in the published run
    (its published row has 2 violation steps on success and misses)."""
    if cmp["system"] == "quadrotor":
        hits = [a for a in cmp["violations"] if not a["stall_damped"] and not flagged(a)]
    else:
        hits = cmp["violations"] + cmp["tube_misses"]
    return sorted({a["lane"] for a in hits})


def main(args=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--system", required=True, choices=sorted(ROWS))
    p.add_argument("--chunks", type=int, default=1)
    a = p.parse_args(args)
    print("python -m robust_nonlinear_mpc_torch.expe.main_monte_carlo_validation "
          + " ".join(argv(a.system, chunks=a.chunks)))


if __name__ == "__main__":
    main()

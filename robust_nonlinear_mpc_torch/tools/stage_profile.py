"""Stage times of the warm MPC step of the bench workload (port of
`robust_nonlinear_mpc_tpu/tools/stage_profile.py`).

The JAX tool jits each stage of the rocket RTI(1/1) iteration on its own and
feeds it the previous stage's outputs. Here the solver marks its stages
(`utils.stages`), so the tool runs the bench twin's step itself
(`bench.build_workload`, warmed in by replays of the captured step) and
reads each stage's host-clock time, the device synchronized at its ends, by
`bench.stage_breakdown`, the function behind the stage breakdowns of
`chip_smoke.py` phases 6-8: the linearization, the backward Riccati, the
response, the QP, the whole fast-SLS solve and the step, medians over
`--reps` eager steps from one warm state. The synchronizations cut the
overlap of the stages, so the stage sum exceeds the captured step's time:
the ratios are the signal. XLA's per-stage cost analysis has no torch
counterpart and is left out.

Usage (needs the card; raises without one):
  python -m robust_nonlinear_mpc_torch.tools.stage_profile [--batch 512]
      [--reps 10] [--warmup 30] [--kkt fused|fused_iter|riccati|condensed]
      [--response streaming|materialized|fused] [--sls-block 0]
      [--tube highest|default] [--qp-direction highest|default]
Prints one JSON line with the GPU's name and power limit.
"""

from __future__ import annotations

import argparse
import json

import torch

from robust_nonlinear_mpc_torch import bench

STAGES = ("linearize", "backward_riccati", "response", "qp")


def profile(B=512, reps=10, n_warm=30, kkt="fused", response="streaming", sls_block=0):
    """{stage: median ms} of one warm step of the bench workload, with the
    stage fractions; the precision switches as they are set."""
    from robust_nonlinear_mpc_torch.sim.closed_loop import capture_mpc_step
    from robust_nonlinear_mpc_torch.utils.batch import tree_map

    bench.require_cuda()
    wl = bench.build_workload(B=B, n_rep=1, n_warm=n_warm, kkt=kkt, response=response,
                              sls_block=sls_block)
    step = capture_mpc_step(wl.solver, wl.carry)
    carry = wl.carry
    for i in range(max(1, n_warm)):
        carry, _ = step(carry, wl.w_seq[i])
    carry = tree_map(torch.clone, carry)
    st = bench.stage_breakdown(wl, carry, wl.w_seq[-1], reps=reps)
    stage_ms = {k: st[k] for k in STAGES}
    total = sum(stage_ms.values())
    return {
        "stage_ms": stage_ms,
        "stage_frac": {k: v / total for k, v in stage_ms.items()},
        "stage_sum_ms": total,
        "fast_sls_ms": st["fast_sls"],
        "step_ms": st["step"],
        "soft_fallback_lanes": wl.n_soft_fallback,
    }


def main(argv=None):
    from robust_nonlinear_mpc_torch.utils.numerics import (
        qp_dir_prec,
        set_qp_direction_precision,
        set_tube_precision,
        tube_prec,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=30)
    ap.add_argument("--kkt", default="fused", choices=["fused", "fused_iter", "riccati", "condensed"])
    ap.add_argument("--response", default="streaming", choices=list(bench.RESPONSES))
    ap.add_argument("--sls-block", type=int, default=0, dest="sls_block")
    ap.add_argument("--tube", default="highest", choices=["highest", "default"])
    ap.add_argument("--qp-direction", default="highest", choices=["highest", "default"],
                    dest="qp_direction")
    a = ap.parse_args(argv)
    set_tube_precision(a.tube)
    set_qp_direction_precision(a.qp_direction)
    out = profile(a.batch, a.reps, a.warmup, a.kkt, a.response, a.sls_block)
    print(json.dumps({
        "metric": "rocket_mpc_stage_profile", "batch": a.batch, "reps": a.reps,
        "device": torch.cuda.get_device_name(0), "gpu": bench.gpu_identity()[2],
        "kkt": a.kkt, "response": a.response, "sls_block": a.sls_block,
        "tube_precision": tube_prec(), "qp_direction_precision": qp_dir_prec(), **out,
    }), flush=True)


if __name__ == "__main__":
    main()

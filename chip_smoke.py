"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints a line; any failed check raises and exits non-zero
before the result lines):
  1. the device and its nvidia-smi name and power limit;
  2. build every kernel (csrc/fused_qp.cu, fused_ipm.cu, fused_response.cu,
     fused_backward.cu, graph_while.cu) with nvcc for sm_90a; then (2b,
     untimed, `check_device_while`) the WHILE node that every captured loop
     is (`utils.graph_loop.device_while`): a captured toy loop whose count
     comes from device data exits at exactly that count over replays with
     other data (0, and past the cap, where it stops at the cap), a nested
     WHILE does the same, a body with a cuBLAS GEMM and a K1 launch
     captures and replays, the toy loop in a plain `torch.cuda.graph`
     sharing a pool counts the same, and `solve_qp` captured as one graph
     equals the eager solve bit for bit with its K1/K2 (K6) launches at
     B = 512 (fused, fused_iter, riccati; float32 and float64); record in
     `chiprun_out/chip_smoke_while.json`;
  3. each kernel's registers per thread, shared bytes per block, resident
     blocks per SM, waves and whether a lane's stage sequences sit in
     shared memory at B = 512, N = 15, and K1/K2's at B = 512, N = 60 (from
     the CUDA runtime); each kernel
     against its plain torch version on the card, relative to each output's
     max |value|: the Newton kernels K1/K2 float64 to 1e-10 and float32 to
     1e-4 at (B, N) in {(512, 15), (37, 15), (8, 60), (512, 60)} with nx =
     17, nu = 4 (at (512, 60) the JAX package runs them as its windowed
     kernels K5a-c), nu in {1, 2} at B = 8, a batch of 529 (the last wave part-filled) and
     the other widths: the pendulum's and the quadrotor's (4, 1), (13, 4)
     and the general path at (7, 3), (32, 2); the whole-iteration kernel K6 at the same (B, N) with ni = 42,
     ni_f = 34 (a lane marked done and a lane whose step is not finite
     included) and at the same batch of 529 and widths; the response
     kernel K4, float32 to 1e-4, and the SLS backward kernel K3 (ni =
     2 (nx + nu), ni_f = 2 nx) at the same (B, N), batch of 529 and widths
     (K3 also at nu in {1, 2}); per-call times
     of every kernel and its plain version at (512, 15) float32, and of
     K1/K2 at (512, 60) float32 (the K5a-c rows), beside the
     least time the card could take (bytes over 3.35 TB/s, operations over
     the CUDA-core peak), and for K3 also the column-blocked torch backward
     (a kernel's time is its device time from torch.profiler, taken from a
     window in which every launch was recorded);
  4. solve_qp on rocket QPs at B = 512: kkt="fused" against kkt="riccati"
     in float32 (identical iteration counts, X/U within 1e-4); kkt=
     "fused_iter" against "riccati" in float64 (identical iteration counts
     on every lane) and float32 (success identical, X/U within 1e-4);
  5. 3 closed-loop MPC steps at N = 6, B = 8, float64 on the card (kernels)
     against the CPU (plain versions): identical success and QP iterations,
     X/U within 1e-8; then 3 steps of the reference's own two-QP RTI
     configuration (make_rocket_problem's options) at N = 15, B = 16,
     float64: the card with sls_block = -1 (K3) against the CPU with
     sls_block = 0 (the folded torch backward), checked the same way;
  6. the bench twin (robust_nonlinear_mpc_torch.bench) at its full
     configuration (the folded SLS kernels, sls_block = 0): the main path
     (K1, K2), run as the step captured in one CUDA graph
     (sim.closed_loop.capture_mpc_step), at B = 512 and at B = 1, with
     on_device_step_ms from captured K = 1 and K = 8 step programs, and the
     eager step from the last timed replay's input, which must give the
     same success and QP iterations;
  7. the bench twin in the fused-kernel configuration (kkt="fused_iter",
     response="fused"): the second path (K6, K4). Both configurations start
     from one SQP seed and run twice, default, fused, fused, default, each
     with its stage breakdown (the eager step) and the device busy share of
     the eager and of the captured step after its first run;
  8. the bench twin with sls_block = -1 from the same seed, once, with its
     stage breakdown and busy shares: the third path (K3), which must launch
     in the timed replays. Each bench run's B = 1 latency loop is cut to 50
     steps (the twin alone runs 200);
  9. guarantee mode, the until-convergence closed loop in the JAX form
     (every lane, masked, fixed shapes; on the card the seed's loops and
     each piece of an SCP round are CUDA graphs, their loops WHILE nodes,
     with host reads of a device flag between them): (a) the rocket at
     N = 6, B = 8, float64,
     2 steps, until the SCP criterion 1e-3 (at most 40 SCP iterations),
     with feasibility restoration, stall damping 0.5 after 5 SCP
     iterations and the soft fallback, kkt="fused" on the card (K1/K2)
     against the CPU (plain versions): identical success, SCP iterations,
     scp_failed and QP iterations on every lane, X/U and the finite
     backoffs within 1e-8, for build_batched_closed_loop and for
     build_chunked_converged_loop at scp_per_dispatch 1 and 5; and each
     chunked run on the card's CUDA graphs against the eager masked loop
     on the card (`capture=False`): the same flags and counts, X/U and
     the backoffs within 1e-9, each step's K1/K2 launches equal and no
     host read by a captured loop (each a WHILE node), with the host reads
     of each step;
     (b) the full-mitigation Monte-Carlo validation of the rocket
     (main_monte_carlo_validation --converged --soft-fallback --restoration
     --max-iter-scp 40 --qp-tol 1e-5 --stall-damping 0.5 --kkt fused, the
     command line of `expe/published_rows.py`), float32, N = 15, seed 0,
     lanes 0..B-1 of the published 1024-lane draw (`GUARANTEE_B`), the
     first T = 3 of its 10 steps (3 is the least at which the violation
     count checks a state the controller produced), through CUDA graphs
     (scp_per_dispatch 2): the guarantee n_violation_steps_on_success == 0
     over a check that covers closed-loop states, tube containment 1 on
     successful solves, the run captured and K1/K2 launched in every step's
     replays; seconds of the seed, of each step and of every kind of graph
     replay (each synchronized at its ends), the peak device memory, each
     step's host reads, graph replays and K1/K2 launches, the comparison
     with the published artifact lane by lane (success flags, SCP
     iterations, tube misses, stored states; every violation and tube miss
     attributed to its lane and step), and the last step's first SCP round
     through its graphs (`profile_round`: its ms on the host clock and
     between CUDA events, and under the profiler the K1/K2 records against
     the launches the WHILE nodes' counters give, the busy share and the
     idle time by gap length); (c) after (b), in the same process, the
     quadrotor's full-mitigation row and the pendulum's row (`--converged`)
     at `PAIR_B` lanes and T = 3 the same way, with (b)'s checks: the
     pendulum with no violation on success and containment 1, the
     quadrotor with at most 2 violation steps on success (its full row's
     published count), each attributed (`chiprun_out/chip_smoke_9c.json`).
     Phases 9b and 9c run in a second process,
     started first, which waits for this one's build (its graphs' WHILE
     nodes need the library) and then runs while this one runs the
     untimed phases 4, 5, 10-12 and 9a, so its seconds are contended; phases 3 and 6-8, which time,
     run after it, alone on the card. `--guarantee-alone steps|stages` runs
     phase 9b alone (after the build), with the seed and steps timed or
     every stage timed; `--guarantee-scaling 128,256,512,1024` the first
     two steps of the rocket's row at each B (`chiprun_out/
     chip_smoke_scaling.json`); `--published-rows rocket,quadrotor,pendulum
     [--chunks C]` the three published rows at their full size, B = 1024,
     T = 10, each held lane by lane against its artifact, its lanes to
     settle re-run in float64 from the same draws, and its criteria
     checked (`chiprun_out/chip_smoke_published_<system>.json`);
 10. the RTI step captured as one CUDA graph against the eager step on the
     card (run after phase 5, among the untimed phases): (a) B = 512,
     N = 15, float32, 3 steps from the bench seed in the default, the
     fused-kernel and the K3 configuration, each with its kernels in the
     graph and each replay with the eager step's kernel launches (its QP a
     WHILE node that runs the eager loop's iterations); (b) the default
     configuration at B = 529, the same; (c) float64, N = 6,
     B = 8, the captured step on the card against the eager step on the
     CPU, phase 5's criteria; (d) the captured K = 8 program against 8
     replays of the one-step graph, with the same launches; (e) build_batched_closed_loop in RTI
     mode (the reference's two-QP RTI options, kkt="fused", float64, N = 6,
     B = 8, 3 steps), on the card on the captured step against the CPU,
     phase 9a's criteria. (a), (b) and (d): identical success,
     QP and SCP iterations and scp_failed on every lane, the plant state,
     X, U and the backoffs bit for bit (else within 1e-6 relative, with a
     line that says so).
 11. the robust-vs-soft comparison and the QP front end (untimed, after
     phase 10): (a) `expe/main_rocket_compare_closed_loop.generate` at
     N = 15, T = 4, float64, on the card with the robust solver at
     kkt="fused" (K1/K2) against the CPU at kkt="riccati" (the plain path),
     which a second worker started with the script runs meanwhile:
     identical robust success and soft success and iterations at every
     step, the applied inputs and both closed-loop costs within 1e-8
     relative, K1 launched, each controller's seconds a step; (b) the QP
     front end (`solvers/qp_frontend.QP`) on the rocket LTV along lane 0 of
     the bench's SQP seed and on the double integrator of
     tests/test_qp_frontend.py: backend "torch" with kkt="fused" on the
     card against kkt="riccati" on the CPU (identical success, X/U/duals
     within 1e-8) and against backend "native" (X/U 1e-7, duals 1e-6, cost
     1e-9 relative), K1/K2 launched, ms a solve of each backend.
 12. the multi-device layer (`parallel/`, untimed, after phase 11, beside
     phase 9b's worker): this process joins a one-rank NCCL world, and two
     gloo ranks (`--parallel-rank`, started once phase 11a's CPU worker has
     ended) share the card:
     (a) the sharded Monte-Carlo (`parallel/mc.run_monte_carlo` with a mesh)
     of the rocket at N = 15, B = 512, float32, kkt="fused", RTI 1/1, T = 3
     on the NCCL rank, bit for bit the one-card run, K1/K2 launched; (b) the
     same in float64 at B = 2 x 16 on the two gloo ranks against one rank:
     flags and counts equal, X/U within 1e-9 relative; (c) the
     column-sharded `fast_sls_solve` (`FastSLSOptions.column_mesh`) at the
     rocket's widths, N = 60, B = 8, float64, kkt="fused", on 1 NCCL and 2
     gloo ranks against the unsharded solve on the card within 1e-9, and the
     ms of one sharded tube iteration at N = 30, 60, 120
     (`tools/column_scaling.py`); (d) `entry.entry()` on the card against
     the CPU within 1e-9 (float64) and `entry.dryrun_multichip(1)`, in a
     worker of their own (`--entry-worker`, started with the gloo ranks).
 13. the condensed IPM and the tube precision switch (timed, after phases
     6-8, alone on the card; about a minute): (a) kkt="condensed" (torch
     ops, no kernel of its own) against kkt="riccati" in float64 on
     well-conditioned random QPs at the rocket's widths, B = 512, N = 15:
     on every lane that riccati solves the same iteration count, success,
     X/U within 1e-9 (the others are printed); then condensed,
     riccati and fused on phase 4's rocket QPs in float32 with the bench's
     IPM options, the median ms of 3 solves (CUDA events), success and mean
     iterations; (b) the bench step (the default configuration, captured)
     with the tube at "default" (TF32 tube GEMMs) against "highest", from
     the bench seed after 10 replays: the largest backoff deviation of one
     step and solves/s of 10 replays in alternating pairs; TF32 must be on
     inside the switch's context and off after it. Record in
     `chiprun_out/chip_smoke_13.json`.
 14. the long horizon, N = 60, where the JAX package windows its Newton
     kernels (K5a-c; phase 3 holds K1/K2 at (512, 60) in both types and
     reports their occupancy there): (a) the QP probe (`tools/fused_n60_qp_probe.py`) on 512
     float32 rocket QPs around the lanes' SQP nominals: kkt="fused" against
     kkt="riccati", identical iterations and success on every lane, X/U
     within 1e-4 relative (phase 4's criteria); (b) the bench twin at
     N = 60 from its own SQP seed, cut to `LONG_SMOKE` (lanes, warm-in,
     timed steps) and a `LONG_SMOKE_LAT`-step latency loop: success 1.0,
     the state finite, the eager check, and K1/K2 launched in the captured
     step's timed replays (the kernels record's `factor_predictor_n60` and
     `resolve_n60` launches). It runs in phase 9b's worker after 9c, beside
     the untimed phases (alone with `--phases 14`); record in
     `chiprun_out/chip_smoke_14.json`. `--long-horizon 30,60` runs the
     bench twin's full configuration (B = 512, 30 warm-in and 10 timed
     steps) at each N, kkt="fused" and "riccati" from one SQP seed in the
     order fused, riccati, riccati, fused, each with its peak memory, the
     first of each with its stage breakdown and the first fused one with
     the captured step's busy share
     (`chiprun_out/chip_smoke_long_horizon.json`); each run fails as the
     bench runs of phases 6-8 do.
Every launch counter is zeroed just before each bench run and before each
guarantee row of phases 9b and 9c (in their own process), and read just
after. A wrapper counts a launch
recorded into a CUDA graph once, at capture; a replay launches without it.
So a captured graph counts its launches outside loops once a replay, and
those of a loop's body (an IPM iteration) once a body run, from the WHILE
node's device counter (`utils.graph_loop.Recording`): the bench record's
`kernel_launches`, the guarantee record's K1/K2 a step and the kernels
record's `launches` (the first run of each path's timed window) are
counted so. Phases 10 and 9a require each captured step's launches to be
the eager step's. The last lines are the kernels record, the nvidia-smi
line and {"ok": true, "device": {...}}. `--phases 9` (or `--phases 11`, `12`, `13`, `14`)
runs a subset (phases 1 and 2 always run) and then prints neither result
line; so do `--guarantee-alone`, `--guarantee-scaling`, `--published-rows`
and `--long-horizon`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from robust_nonlinear_mpc_torch import bench
from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
    X0,
    make_rocket_problem,
)
from robust_nonlinear_mpc_torch.ops import cuda_lib, fused_backward, fused_qp, fused_response
from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions, QPData, solve_qp
from robust_nonlinear_mpc_torch.ops.sls_kernels import backward_solve_blocked
from robust_nonlinear_mpc_torch.sim.closed_loop import (
    build_batched_closed_loop,
    build_chunked_converged_loop,
    capture_mpc_step,
    make_mpc_step,
)
from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist
from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve
from robust_nonlinear_mpc_torch.tools.kernel_times import (
    NI,
    NI_F,
    NU,
    NX,
    backward_inputs,
    device_ms,
    ipm_inputs,
    newton_inputs,
    response_inputs,
)
from robust_nonlinear_mpc_torch.utils.batch import tree_leaves, tree_map
from robust_nonlinear_mpc_torch.utils.graph_loop import device_while
from robust_nonlinear_mpc_torch.utils.hardware import PEAK_BYTES, PEAK_FLOPS

OUT_DIR = Path("chiprun_out")
TPU_SOURCE = "robust_nonlinear_mpc_tpu/ops/pallas_qp.py"
REPLACES = {
    "factor_predictor": f"{TPU_SOURCE}:161",
    "resolve": f"{TPU_SOURCE}:293",
    # above N = 30 the JAX package runs K1's backward sweep and K2's as the
    # windowed kernels K5a and K5c (their forward sweeps as K5b, `:709`); the
    # port runs K1/K2 at any N, so these rows are K1/K2 at N = 60
    "factor_predictor_n60": f"{TPU_SOURCE}:568",
    "resolve_n60": f"{TPU_SOURCE}:664",
    "ipm_iteration": f"{TPU_SOURCE}:1234",
    "fused_response": "robust_nonlinear_mpc_tpu/ops/pallas_response.py:40",
    "backward_K": "robust_nonlinear_mpc_tpu/ops/pallas_sls.py:138",
}
SOURCES = {
    "factor_predictor": "robust_nonlinear_mpc_torch/csrc/fused_qp.cu",
    "resolve": "robust_nonlinear_mpc_torch/csrc/fused_qp.cu",
    "factor_predictor_n60": "robust_nonlinear_mpc_torch/csrc/fused_qp.cu",
    "resolve_n60": "robust_nonlinear_mpc_torch/csrc/fused_qp.cu",
    "ipm_iteration": "robust_nonlinear_mpc_torch/csrc/fused_ipm.cu",
    "fused_response": "robust_nonlinear_mpc_torch/csrc/fused_response.cu",
    "backward_K": "robust_nonlinear_mpc_torch/csrc/fused_backward.cu",
}
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# the B = 1 latency loop of each bench run here (the bench twin alone runs
# the reference's 200 steps): cut to keep the script inside its time limit
LATENCY_STEPS = 50
ALL_PHASES = range(3, 15)
# the long horizon: the JAX package windows its Newton kernels above N = 30
# (`pallas_qp._pick_window`); the port's K1/K2 run it in one stage loop
LONG_N = 60
# the Newton kernels K1/K2, which the long horizon runs
NEWTON = ("factor_predictor", "resolve")
# the kernels of each bench path: the main path (phase 6), the fused-kernel
# path (7) and the sls_block = -1 path (8)
PATH_KERNELS = {"6": NEWTON, "7": ("ipm_iteration", "fused_response"), "8": ("backward_K",)}
# phase 14's cut bench run at N = LONG_N: lanes, warm-in and timed steps,
# and its B = 1 latency loop (the full configuration, B = 512 with 30 and
# 10 steps, runs under --long-horizon). 16 lanes are one soft-fallback
# chunk at N = 60 (`soft_fallback_chunk`), which costs about a minute on
# the card whatever its lanes: the seed sets this run's seconds
LONG_SMOKE = dict(B=16, n_warm=3, n_rep=3)
LONG_SMOKE_LAT = 5
# phase 9b's lanes (the rocket) and phase 9c's (the quadrotor and the
# pendulum), lanes 0..B-1 of the published 1024-lane draws. 9b at B = 1024
# took 497.0 s beside the untimed phases and held the timed ones back by
# about 180 s (the whole run 960.5 s; NVIDIA H100 80GB HBM3, 700 W), so it
# stays at 128
GUARANTEE_B = 128
PAIR_B = 1024


_START = time.perf_counter()


def say(msg):
    """Print a progress line with the seconds since the script started."""
    print(f"{msg}  [{time.perf_counter() - _START:.1f} s]", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def rel_err(a, b):
    scale = max(float(b.abs().max()), 1e-30)
    return float((a - b).abs().max()) / scale, float((a - b).abs().max())


def compare_kernels(Bsz, N, nu, dtype, nx=17):
    """Both kernels and their plain versions on the same card inputs.
    Returns {(kernel, output): (relative error, absolute error)}."""
    mats, rhs, rhs2 = newton_inputs(Bsz, N, nx, nu, dtype, "cuda", seed=Bsz + N + nu)
    A, B = mats[0], mats[1]
    got = fused_qp.factor_predictor(*mats, *rhs)
    ref = fused_qp._plain_factor_predictor(*mats, *rhs)
    got_rs = fused_qp.resolve(A, B, got[3], *rhs2)
    ref_rs = fused_qp._plain_resolve(A, B, ref[3], *rhs2)
    torch.cuda.synchronize()
    names = ["dX", "dU", "dnu", "K", "FxuT", "Fuu_tri", "Fiv_tri", "Pseq"]
    out = {}
    for name, a, b in zip(names, list(got[:3]) + list(got[3]), list(ref[:3]) + list(ref[3])):
        out[("factor_predictor", name)] = rel_err(a, b)
    for name, a, b in zip(names[:3], got_rs, ref_rs):
        out[("resolve", name)] = rel_err(a, b)
    return out


KERNEL_CASES = [(512, 15, 4), (37, 15, 4), (8, 60, 4), (8, 15, 1), (8, 15, 2)]
# K1/K2 at the long horizon's full batch, where the JAX package runs K5a-c
LONG_CASE = (512, LONG_N, 4)
# the Newton kernels' and K6's edges, as (B, N, nx, nu): a batch that does not
# fill the last wave of one-block-per-lane kernels (529 > 4 x 132), the other
# models' instantiated widths, the pendulum's (4, 1) and the quadrotor's
# (13, 4), and the general (runtime-width) path at nx = 7 and at the largest
# width, 32
EDGE_CASES = [(529, 15, NX, NU), (8, 15, 4, 1), (8, 15, 7, 3), (8, 15, 13, 4), (8, 15, 32, 2)]
# K6's and K4's cases: the main shape, a ragged batch, a long horizon, the edges
IPM_CASES = [(512, 15, NX, NU), (37, 15, NX, NU), (8, 60, NX, NU)] + EDGE_CASES


KERNEL_SYMBOLS = {
    "factor_predictor": "factor_predictor_kernel",
    "resolve": "resolve_kernel",
    "ipm_iteration": "ipm_iter_kernel",
    "fused_response": "response_kernel",
    "backward_K": "backward_K_kernel",
}
WRAPPERS = {
    "factor_predictor": fused_qp.factor_predictor,
    "resolve": fused_qp.resolve,
    "ipm_iteration": fused_qp.ipm_iteration,
    "fused_response": fused_response.fused_response,
    "backward_K": fused_backward.backward_K,
}


def kernel_ms(fn, kernel, n):
    """Device time of one launch of the kernel, from torch.profiler over n
    calls of its wrapper, in a window in which the profiler recorded every
    launch that the wrapper's counter made (`kernel_times.device_ms`; what
    the wrapper runs around the kernel is not counted). Returns the time
    and the launches recorded in each window measured."""
    try:
        return device_ms(fn, KERNEL_SYMBOLS[kernel], n, lambda: WRAPPERS[kernel].launches)
    except RuntimeError as e:
        fail(str(e))


IPM_OUTPUTS = ("X", "U", "lam", "s", "lam_f", "s_f", "nu_dyn", "req", "rineq", "rineq_f",
               "rx_pad", "rxN", "ru", "res", "bad")


def compare_ipm(Bsz, N, dtype, nx=NX, nu=NU):
    """K6 against its plain version on the same card inputs."""
    args, kw = ipm_inputs(Bsz, N, dtype, "cuda", seed=Bsz + N, nx=nx, nu=nu)
    got = fused_qp.ipm_iteration(*args, **kw)
    ref = fused_qp._plain_ipm_iter(*args, **kw)
    torch.cuda.synchronize()
    out = {}
    for name, a, b in zip(IPM_OUTPUTS, got, ref):
        if name == "bad":
            if not torch.equal(a, b):
                fail(f"ipm_iteration B={Bsz} N={N} {dtype}: reverted lanes differ")
            continue
        if not bool(torch.isfinite(a).all()):
            fail(f"ipm_iteration {name} B={Bsz} N={N} {dtype}: not finite")
        out[("ipm_iteration", name)] = rel_err(a, b)
    if Bsz >= 3 and got[-1][:3].tolist() != [False, False, True]:
        fail(f"ipm_iteration B={Bsz} N={N} {dtype}: lane 2 was not reverted")
    return out


RESPONSE_OUTPUTS = ("Phi_x", "Phi_u", "beta", "beta_f", "backoff", "backoff_f", "tube")


def compare_response(Bsz, N=15, nx=NX, nu=NU):
    """K4 against its plain version on the same card inputs (nw = nx, ni =
    2 (nx + nu), ni_f = 2 nx)."""
    args = response_inputs(Bsz, N, "cuda", seed=Bsz + N + nx, nx=nx, nu=nu)
    got = fused_response.fused_response(*args)
    ref = fused_response._plain_fused_response(*args)
    torch.cuda.synchronize()
    return {("fused_response", name): rel_err(a, b)
            for name, a, b in zip(RESPONSE_OUTPUTS, got, ref)}


def compare_backward(Bsz, N, nu, dtype, nx=NX):
    """K3 against its plain version on the same card inputs (ni = 2 (nx +
    nu), ni_f = 2 nx: the rocket's 42 and 34)."""
    args = backward_inputs(Bsz, N, nx, nu, dtype, "cuda", seed=Bsz + N + nu)
    got = fused_backward.backward_K(*args)
    ref = fused_backward._plain_backward_K(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        fail(f"backward_K B={Bsz} N={N} nx={nx} nu={nu} {dtype}: not finite")
    return {("backward_K", "K"): rel_err(got, ref)}


def check_kernels():
    """Phase 3: every kernel against its plain version on the card. Returns
    each kernel's largest absolute error at the main path's shape."""
    cases = [(dtype, (B, N), lambda B=B, N=N, nu=nu, dtype=dtype: compare_kernels(B, N, nu, dtype))
             for dtype in (torch.float64, torch.float32) for B, N, nu in KERNEL_CASES + [LONG_CASE]]
    cases += [(dtype, (B, N), lambda B=B, N=N, nx=nx, nu=nu, dtype=dtype:
               compare_kernels(B, N, nu, dtype, nx=nx))
              for dtype in (torch.float64, torch.float32) for B, N, nx, nu in EDGE_CASES]
    cases += [(dtype, (B, N), lambda B=B, N=N, nx=nx, nu=nu, dtype=dtype:
               compare_ipm(B, N, dtype, nx=nx, nu=nu))
              for dtype in (torch.float64, torch.float32) for B, N, nx, nu in IPM_CASES]
    cases += [(torch.float32, (B, N), lambda B=B, N=N, nx=nx, nu=nu:
               compare_response(B, N, nx=nx, nu=nu)) for B, N, nx, nu in IPM_CASES]
    cases += [(dtype, (B, N), lambda B=B, N=N, nu=nu, dtype=dtype: compare_backward(B, N, nu, dtype))
              for dtype in (torch.float64, torch.float32) for B, N, nu in KERNEL_CASES]
    cases += [(dtype, (B, N), lambda B=B, N=N, nx=nx, nu=nu, dtype=dtype:
               compare_backward(B, N, nu, dtype, nx=nx))
              for dtype in (torch.float64, torch.float32) for B, N, nx, nu in EDGE_CASES]
    worst, main_err = {}, {}
    for dtype, (Bsz, N), run in cases:
        for (kname, oname), (r, ab) in run().items():
            if not (r <= TOL[dtype]):
                fail(f"{kname} {oname} B={Bsz} N={N} {dtype}: rel err {r:.3e}")
            worst[(kname, dtype)] = max(worst.get((kname, dtype), 0.0), r)
            if (Bsz, N, dtype) == (512, 15, torch.float32):
                main_err[kname] = max(main_err.get(kname, 0.0), ab)
            if (Bsz, N, dtype) == (512, LONG_N, torch.float32):
                main_err[f"{kname}_n60"] = max(main_err.get(f"{kname}_n60", 0.0), ab)
    for (kname, dtype), r in worst.items():
        say(f"[3] {kname} {dtype}: worst rel err {r:.3e} (tol {TOL[dtype]:g})")
    return main_err


def report_occupancy(Bsz=512):
    """Phase 3: what each kernel costs the SM at the main path's widths
    (N = 15), and K1/K2 at the long horizon (N = LONG_N), from the CUDA
    runtime: registers per thread, shared bytes per block (static +
    dynamic), spill bytes, resident blocks per SM, the waves of a grid at
    B = 512 and whether a lane's stage sequences sit in shared memory."""
    cases = [(name, 15) for name in cuda_lib.INFO_KERNELS] + [(name, LONG_N) for name in NEWTON]
    for name, N in cases:
        for sfx in cuda_lib.INFO_KERNELS[name]:
            dtype = torch.float32 if sfx == "f32" else torch.float64
            info = cuda_lib.kernel_info(name, dtype, Bsz, N, NX, NU, NI, NI_F)
            say(f"[3] occupancy {name} {sfx} at B={Bsz} N={N}: {info['registers']} registers, "
                f"{info['static_smem'] + info['dynamic_smem']} shared bytes "
                f"({info['dynamic_smem']} dynamic), {info['local_bytes']} local (stack) bytes, "
                f"{info['blocks_per_sm']} blocks/SM on {info['sms']} SMs, {info['waves']} wave(s), "
                f"sequences on chip {info['on_chip']}")


def kernel_bound(name, Bsz=512, N=15, nx=NX, nu=NU, ni=NI, ni_f=NI_F, nw=NX, dtype=torch.float32):
    """(bound_ms, bound_by): the least time the card could take for one call
    at these shapes, the larger of its bytes (each input read once, each
    output written once) over the memory rate and its operations over the
    CUDA-core peak for the type."""
    nxx, nxu, nuu = nx * nx, nx * nu, nu * (nu + 1) // 2
    # per lane: Riccati stage (PA, PB, w, Fxx, Fxu', Fuu, f_u, pnew, the
    # nu x nu solves, P and p updates), feedforward stage, forward stage
    fact = 4 * nx ** 3 + 4 * nxx * nu + 4 * nxx + 2 * nu * nu * nx + 2 * nxu \
        + (nx + 1) * 6 * nu * nu + 4 * nxx * nu + 2 * nxu
    ff = 4 * nxx + 4 * nxu + 6 * nu * nu
    fwd = 4 * nxx + 4 * nxu
    newton_in = N * (nxx + nxu) + 2 * N * nx + N * nu + nx       # A, B, rbx, rbxN, rbu, req
    newton_out = (N + 1) * nx + N * nu + N * nx                  # dX, dU, dnu
    factors = N * (2 * nxu + 2 * nuu + nxx)                      # K, Fxu', triangles, Pseq
    curv = N * (nxx + nu * nu + nxu) + nxx                       # Cxx, Cuu, Cxu, PN
    size = 4 if dtype == torch.float32 else 8
    if name == "factor_predictor":
        words, flops = Bsz * (newton_in + curv + newton_out + factors), Bsz * N * (fact + fwd)
    elif name == "resolve":
        words, flops = Bsz * (newton_in + factors + newton_out), Bsz * N * (ff + fwd)
    elif name == "backward_K":
        # what this run needs: the eta rows of the active (k, j) pairs
        # (j <= k), all of A and B, eta_f of the N gain columns (column N is
        # all zero), K written whole (zeros for j > k)
        pairs = N * (N + 1) // 2
        words = Bsz * (N * (nxx + nxu) + pairs * ni + N * ni_f + N * (N + 1) * nxu) \
            + ni * (nx + nu) + ni_f * nx + 2 * nxx + nu * nu
        # the least work of a pair: the rows of [Gx Gu] scaled by eta once,
        # the symmetric products (Cxx, Cuu, A'SA, B'SB, F'K) on one triangle
        # (a triangle of an n-square from m-term dots: n (n + 1) m), S [A B]
        # and F = B'SA whole, K = -H^{-1} F
        tri = lambda n, m: n * (n + 1) * m
        per_pair = ni * (nx + nu) + tri(nx, ni) + tri(nu, ni) + 2 * nxx * (nx + nu) \
            + tri(nx, nx) + 2 * nu * nxx + tri(nu, nx) + 2 * nu * nu * nx + tri(nx, nu)
        # the terminal Gf' diag(eta_f[j]) Gf of each of the N gain columns
        flops = Bsz * (pairs * per_pair + N * (ni_f * nx + tri(nx, ni_f)))
    elif name == "ipm_iteration":
        Nni = N * ni
        iterate = (N + 1) * nx + N * nu + 2 * Nni + 2 * ni_f + N * nx
        resid = 2 * N * nx + Nni + ni_f + nx + N * nu
        data = N * (nxx + nxu) + N * nx + (N + 1) * nx + N * nu + Nni + ni_f + 1
        shared = N * (ni * (nx + nu) + nxx + nu * nu) + ni_f * nx + nxx
        weights = N * ni + ni_f                                  # W, W_f
        words = Bsz * (data + weights + 2 * iterate + 2 * resid + 1) + shared
        rhs = 2 * Nni * (nx + nu) + 2 * ni_f * nx
        resid_flops = N * (4 * nxx + 2 * nxu + 2 * ni * nx) + Nni * 2 * (nx + nu) \
            + 2 * ni_f * nx + 2 * nxx + 2 * ni_f * nx + N * (2 * nu * nu + 2 * ni * nu + 2 * nxu)
        # the curvature Gx' diag(W) Gx + Hx, Gx' diag(W) Gu, Gu' diag(W) Gu + Hu
        # per stage and HxN + Gf' diag(W_f) Gf: the rows of G scaled by W once,
        # then 2 operations a term
        curv_flops = 2 * (N * ni * (nxx + nxu + nu * nu) + ni_f * nxx) \
            + N * ni * (nx + nu) + ni_f * nx
        flops = Bsz * (N * (fact + ff + 2 * fwd) + 4 * rhs + resid_flops + curv_flops
                       + 40 * (Nni + ni_f))
    else:   # fused_response, always float32
        size = 4
        # the active (k, j) pairs (j <= k): K is read there only, Phi and
        # beta are written whole (zeros for j > k)
        cols = N * (N + 1) // 2
        words = Bsz * (N * (nxx + nxu) + cols * nu * nx
                       + (N + 1) ** 2 * nx * nw + N * (N + 1) * nu * nw
                       + N * N * ni + (N + 1) * ni_f + N * ni + ni_f + 1) \
            + (N + 1) * nx * nw + (ni + ni_f) * nx + ni * nu + 2 * nxx + nu * nu
        per_col = 2 * nu * nx * nw + 2 * ni * nw * (nx + nu + 1) + 2 * nxx * nw \
            + 2 * nu * nu * nw + 2 * nx * nw * (nx + nu)
        flops = Bsz * (cols * per_col + (N + 1) * (2 * ni_f * nw * (nx + 1) + 2 * nxx * nw))
        dtype = torch.float32
    t_bytes = 1e3 * words * size / PEAK_BYTES
    t_ops = 1e3 * flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels():
    """Per-call times at the main path's shape (B=512, N=15, f32), and K1/K2's
    at the long horizon (B=512, N=60, f32), in the order plain, kernel,
    kernel, plain: the kernel's device time (profiler),
    the plain version's and the wrapper's by CUDA events (the wrapper's
    includes its allocations, its torch ops and any host gaps)."""
    mats, rhs, rhs2 = newton_inputs(512, 15, NX, NU, torch.float32, "cuda", seed=1)
    A, B = mats[0], mats[1]
    fact = fused_qp.factor_predictor(*mats, *rhs)[3]
    args, kw = ipm_inputs(512, 15, torch.float32, "cuda", seed=2)
    rargs = response_inputs(512, 15, "cuda", seed=2)
    bargs = backward_inputs(512, 15, NX, NU, torch.float32, "cuda", seed=2)
    pairs = {
        "factor_predictor": (lambda: fused_qp.factor_predictor(*mats, *rhs),
                             lambda: fused_qp._plain_factor_predictor(*mats, *rhs)),
        "resolve": (lambda: fused_qp.resolve(A, B, fact, *rhs2),
                    lambda: fused_qp._plain_resolve(A, B, fact, *rhs2)),
        "ipm_iteration": (lambda: fused_qp.ipm_iteration(*args, **kw),
                          lambda: fused_qp._plain_ipm_iter(*args, **kw)),
        "fused_response": (lambda: fused_response.fused_response(*rargs),
                           lambda: fused_response._plain_fused_response(*rargs)),
        "backward_K": (lambda: fused_backward.backward_K(*bargs),
                       lambda: fused_backward._plain_backward_K(*bargs)),
    }
    # K3's plain version is the folded torch backward; the column-blocked
    # one (sls_block > 0) is timed beside it
    blocked = lambda: backward_solve_blocked(*bargs, block=2)[1]
    # K1/K2 at the long horizon (the rows of the JAX package's K5a-c)
    lmats, lrhs, lrhs2 = newton_inputs(512, LONG_N, NX, NU, torch.float32, "cuda", seed=3)
    lfact = fused_qp.factor_predictor(*lmats, *lrhs)[3]
    pairs["factor_predictor_n60"] = (lambda: fused_qp.factor_predictor(*lmats, *lrhs),
                                     lambda: fused_qp._plain_factor_predictor(*lmats, *lrhs))
    pairs["resolve_n60"] = (lambda: fused_qp.resolve(lmats[0], lmats[1], lfact, *lrhs2),
                            lambda: fused_qp._plain_resolve(lmats[0], lmats[1], lfact, *lrhs2))
    t = {}
    for k, (kern, plain) in pairs.items():
        kernel, N = (k[:-4], LONG_N) if k.endswith("_n60") else (k, 15)
        p1 = bench.cuda_ms(plain, 5)
        (k1, seen1), (k2, seen2) = kernel_ms(kern, kernel, 30), kernel_ms(kern, kernel, 30)
        w = bench.cuda_ms(kern, 30)
        p2 = bench.cuda_ms(plain, 5)
        t[k] = (min(k1, k2), min(p1, p2))
        extra = f", torch blocked(2) {bench.cuda_ms(blocked, 5):.4f} ms" if k == "backward_K" else ""
        say(f"[3] {kernel} at B=512 N={N} f32: kernel {t[k][0]:.4f} ms (wrapper {w:.4f} ms), "
            f"plain {t[k][1]:.4f} ms{extra}, bound "
            + "{:.4f} ms ({})".format(*kernel_bound(kernel, N=N))
            + f", profiler windows of 30 recorded {seen1} and {seen2} launches")
    return t


def rocket_qps(Bsz, N, dtype, device, seed):
    """Deviation QPs of the rocket problem around perturbed X0 plans."""
    m, solver = make_rocket_problem(N=N, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    x0 = np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, m.nx))
    X = x0[:, None, :] + 0.01 * rng.standard_normal((Bsz, N + 1, m.nx))
    U = 0.05 * rng.standard_normal((Bsz, N, m.nu))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    A, B, c, qx, qu, g_res, gf_res, xd = solver.assemble_deviation_problem(t(X), t(U), t(x0))
    return solver.prob.stat, QPData(A=A, B=B, c=c, qx=qx, qu=qu, h=g_res, hf=gf_res, xinit=xd)


def check_solve_qp():
    """Phase 4: kkt="fused" against kkt="riccati" on the card."""
    stat, data = rocket_qps(512, 15, torch.float32, "cuda", seed=3)
    opts = IPMOptions(max_iter=30, tol=3e-5)
    ric = solve_qp(stat, data, opts._replace(kkt="riccati"))
    fus = solve_qp(stat, data, opts._replace(kkt="fused"))
    torch.cuda.synchronize()
    Bsz = data.A.shape[0]
    same = int((ric.iters == fus.iters).sum())
    ex, _ = rel_err(fus.X, ric.X)
    eu, _ = rel_err(fus.U, ric.U)
    say(f"[4] solve_qp fused vs riccati B=512 f32: iters equal on {same}/{Bsz} lanes, "
        f"mean iters {ric.iters.float().mean():.2f}, success {ric.success.float().mean():.4f}, "
        f"X rel err {ex:.2e}, U rel err {eu:.2e}")
    if same != Bsz:
        fail("iteration counts differ between kkt='fused' and kkt='riccati'")
    if not (ex <= 1e-4 and eu <= 1e-4):
        fail("fused and riccati solutions differ by more than 1e-4")


def check_fused_iter():
    """Phase 4: kkt="fused_iter" (K6) against kkt="riccati" on the card."""
    for dtype in (torch.float64, torch.float32):
        stat, data = rocket_qps(512, 15, dtype, "cuda", seed=5)
        opts = IPMOptions(max_iter=30, tol=3e-5)
        ric = solve_qp(stat, data, opts._replace(kkt="riccati"))
        it = solve_qp(stat, data, opts._replace(kkt="fused_iter"))
        torch.cuda.synchronize()
        same = int((ric.iters == it.iters).sum())
        ex, _ = rel_err(it.X, ric.X)
        eu, _ = rel_err(it.U, ric.U)
        say(f"[4] solve_qp fused_iter vs riccati B=512 {dtype}: iters equal on {same}/512 "
            f"lanes, mean iters {ric.iters.float().mean():.2f}/{it.iters.float().mean():.2f}, "
            f"success {ric.success.float().mean():.4f}/{it.success.float().mean():.4f}, "
            f"X rel err {ex:.2e}, U rel err {eu:.2e}")
        if dtype == torch.float64 and same != 512:
            fail("float64 iteration counts differ between kkt='fused_iter' and kkt='riccati'")
        if not torch.equal(ric.success, it.success):
            fail("success differs between kkt='fused_iter' and kkt='riccati'")
        if not (ex <= 1e-4 and eu <= 1e-4):
            fail("fused_iter and riccati solutions differ by more than 1e-4")


def _count_to(state, target):
    """A toy masked loop: lane b counts x up to target[b] (device data),
    stirring a float state on its way."""
    x, acc = state
    run = x < target
    return x + run.to(x.dtype), acc + run.to(acc.dtype)[:, None] * torch.tanh(acc + 1.0)


def _any_below(state, target):
    return (state[0] < target).any()


def _outer_body(state, n_outer, base, cap):
    """The nested toy: outer iteration i runs an inner WHILE of base[i]
    iterations that adds one to x each time."""
    i, x = state
    inner = lambda s, m: (s[0] + 1, s[1] + 1)
    below = lambda s, m: (s[0] < m).any()
    _, x = device_while(below, inner, (torch.zeros_like(i), x), base[i.long()], cap=cap)
    return i + 1, x


def _gemm_k1_body(state, n, W, newton, rhs):
    """A body holding a cuBLAS GEMM and a K1 launch."""
    k, M, s = state
    dX, dU, _, _ = fused_qp.factor_predictor(*newton, *rhs)
    return k + 1, torch.tanh(M @ W), s + 1e-3 * (dX.sum() + dU.sum())


def _runs(rec, before):
    return [a - b for a, b in zip(rec.runs(), before)]


def check_device_while(B=64, cap=100):
    """Phase 2b: the WHILE node (`utils.graph_loop.device_while`,
    `csrc/graph_while.cu`), untimed. (a) A captured toy loop whose count
    comes from device data exits at exactly that count, with the plain
    loop's state bit for bit, over replays with other data (the count 0,
    and one above the cap, which stops at the cap); (b) a nested WHILE (each
    outer iteration an inner WHILE of a device-given count) does the same;
    (c) a body holding a cuBLAS GEMM and a K1 launch captures and replays,
    with the eager loop's result and K1 counted once a body run; (d) the
    toy loop captured inside a plain `torch.cuda.graph` sharing a pool with
    another graph counts the same. (e) `solve_qp` captured as one graph
    (its loop a WHILE node) against the eager solve on rocket QPs at
    B = 512 for kkt fused, fused_iter and riccati, float32 and float64:
    the same iterations and X/U bit for bit, and the eager solve's K1/K2 (or
    K6) launches. Returns the record of the checks."""
    from robust_nonlinear_mpc_torch.ops import graph_while
    from robust_nonlinear_mpc_torch.utils import graph_loop as gl

    dev = torch.device("cuda")
    graph_while.prepare(dev)
    rng = np.random.default_rng(11)
    record = {}
    state0 = (torch.zeros(B, dtype=torch.int32, device=dev),
              torch.as_tensor(rng.standard_normal((B, 8)), dtype=torch.float32, device=dev))
    target = torch.zeros(B, dtype=torch.int32, device=dev)
    draws = [rng.integers(0, 8, B), rng.integers(0, 24, B), np.zeros(B, int),
             np.minimum(rng.integers(0, 150, B), 149)]
    draws[3][5] = 149

    def toy_replays(label, graph, rec, out):
        """Replays with each draw against the node's plain twin
        (`graph_while.plain_condition` driving the same body eagerly)."""
        counts = []
        for d in draws:
            target.copy_(torch.as_tensor(d, dtype=torch.int32))
            before = rec.runs()
            graph.replay()
            n = _runs(rec, before)[0]
            ref, runs = state0, torch.zeros(2, dtype=torch.int64, device=dev)
            go = graph_while.plain_condition(_any_below(ref, target), runs, cap, False)
            while bool(go):
                ref = _count_to(ref, target)
                go = graph_while.plain_condition(_any_below(ref, target), runs, cap, True)
            want = min(int(d.max()), cap)
            if not n == int(runs[1]) == want:
                fail(f"[2b {label}] the WHILE node ran {n} bodies, its plain twin "
                     f"{int(runs[1])}, the data ask for {want}")
            for a, b in zip(out, ref):
                if not torch.equal(a, b):
                    fail(f"[2b {label}] the captured loop's state differs from the plain twin's")
            counts.append(n)
        return counts

    # (a) through graph_loop.capturing
    g = torch.cuda.CUDAGraph()
    with gl.capturing(g) as rec:
        out = device_while(_any_below, _count_to, state0, target, cap=cap)
    record["a_runs"] = toy_replays("a", g, rec, out)
    # (b) nested
    n_outer = torch.zeros((1,), dtype=torch.int32, device=dev)
    base = torch.zeros((16,), dtype=torch.int32, device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    gn = torch.cuda.CUDAGraph()
    outer = lambda s, n, b: _outer_body(s, n, b, cap)
    with gl.capturing(gn) as recn:
        outn = device_while(lambda s, n, b: (s[0] < n).any(), outer, (zero, zero), n_outer, base,
                            cap=16)
    record["b_runs"] = []
    for k in range(3):
        nb = rng.integers(0, 12, 16)
        no = (5, 0, 16)[k]
        base.copy_(torch.as_tensor(nb, dtype=torch.int32))
        n_outer.fill_(no)
        before = recn.runs()
        gn.replay()
        runs = _runs(recn, before)
        want = [no, int(nb[:no].sum())]
        if runs != want or int(outn[1]) != want[1] or int(outn[0]) != no:
            fail(f"[2b b] nested WHILE: runs {runs} and state {[int(t) for t in outn]}, "
                 f"the data ask for {want}")
        record["b_runs"].append(runs)
    # (c) a cuBLAS GEMM and K1 in the body
    newton, rhs, _ = newton_inputs(16, 15, NX, NU, torch.float32, dev, seed=4)
    W = torch.as_tensor(rng.standard_normal((8, 8)) / 3, dtype=torch.float32, device=dev)
    n_c = torch.full((1,), 9, dtype=torch.int32, device=dev)
    st_c = (torch.zeros((1,), dtype=torch.int32, device=dev),
            torch.as_tensor(rng.standard_normal((4, 8, 8)), dtype=torch.float32, device=dev),
            torch.zeros((), dtype=torch.float32, device=dev))
    cond_c = lambda s, n, *_: (s[0] < n).any()
    args_c = (n_c, W, newton, rhs)
    fused_qp.reset_launch_counts()
    ref_c = gl.while_loop(cond_c, _gemm_k1_body, st_c, args_c, cap=cap)
    eager_k1 = fused_qp.launch_counts()["factor_predictor"]
    gc = torch.cuda.CUDAGraph()
    with gl.capturing(gc) as recc:
        outc = device_while(cond_c, _gemm_k1_body, st_c, *args_c, cap=cap)
    gc.replay()
    k1 = recc.launches(1)["factor_predictor"]
    dm = float((outc[1] - ref_c[1]).abs().max())
    ds = float((outc[2] - ref_c[2]).abs())
    if int(outc[0]) != 9 or k1 != eager_k1 or dm > 1e-6 or ds > 1e-4:
        fail(f"[2b c] GEMM + K1 body: {int(outc[0])} bodies, K1 {k1} (eager {eager_k1}), "
             f"|dM| {dm:.2e}, |ds| {ds:.2e}")
    record["c"] = {"bodies": int(outc[0]), "k1": k1, "bit_for_bit":
                   bool(torch.equal(outc[1], ref_c[1]) and torch.equal(outc[2], ref_c[2]))}
    # (d) a plain torch.cuda.graph sharing a pool with another graph
    pool = torch.cuda.graph_pool_handle()
    gd, ge = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with gl.recording() as recd, torch.cuda.graph(gd, pool=pool):
        outd = device_while(_any_below, _count_to, state0, target, cap=cap)
    with torch.cuda.graph(ge, pool=pool):
        other = state0[1] * 2.0 + 1.0
    ge.replay()
    record["d_runs"] = toy_replays("d", gd, recd, outd)
    if record["d_runs"] != record["a_runs"] or not torch.equal(other, state0[1] * 2.0 + 1.0):
        fail(f"[2b d] the loop in a shared pool counts {record['d_runs']}, "
             f"through capturing {record['a_runs']}")
    say(f"[2b] WHILE nodes: toy loop bodies {record['a_runs']} (device-given counts, the "
        f"last at its cap {cap}), nested (outer, inner) {record['b_runs']}, GEMM + K1 body "
        f"{record['c']}, in a shared-pool torch.cuda.graph {record['d_runs']}")
    del g, gn, gc, gd, ge
    # (e) solve_qp as one graph against the eager solve
    record["e"] = []
    for dtype in (torch.float32, torch.float64):
        stat, data = rocket_qps(512, 15, dtype, "cuda", seed=3)
        for kkt in ("fused", "fused_iter", "riccati"):
            opts = IPMOptions(max_iter=30, tol=3e-5, kkt=kkt)
            fused_qp.reset_launch_counts()
            ref = solve_qp(stat, data, opts)
            eager = {k: v for k, v in fused_qp.launch_counts().items() if v}
            call = gl.CapturedCall(lambda d: solve_qp(stat, d, opts), (data,))
            got = call(data)
            launched = {k: v for k, v in call.launched().items() if v}
            same = (torch.equal(got.iters, ref.iters) and torch.equal(got.X, ref.X)
                    and torch.equal(got.U, ref.U))
            row = {"dtype": str(dtype), "kkt": kkt, "bit_for_bit": same, "launches": launched,
                   "eager_launches": eager, "max_iters": int(ref.iters.max()),
                   "mean_iters": float(ref.iters.float().mean())}
            record["e"].append(row)
            if not same or launched != eager:
                fail(f"[2b e] solve_qp as a graph against eager: {row}")
            del call
    say(f"[2b] solve_qp as one graph (a WHILE node) equals the eager solve bit for bit, with "
        f"its launches: " + "; ".join(f"{r['kkt']} {r['dtype'][6:]} {r['launches']} "
                                      f"(iterations mean {r['mean_iters']:.2f}, max "
                                      f"{r['max_iters']})" for r in record["e"]))
    record["f"] = while_overhead()
    torch.cuda.empty_cache()
    return record


KERNELS_A_BODY = 50


def _tiny_body(state, *_):
    """KERNELS_A_BODY small elementwise kernels and the count's increment."""
    x, i = state
    for _ in range(KERNELS_A_BODY):
        x = x * 1.0001
    return x, i + 1


def while_overhead(bodies=200, inner=10):
    """Phase 2b (f): what a body costs inside a WHILE node. The same body
    of small kernels run `bodies` times as a straight graph (the body
    unrolled 20 times, replayed), as the body of one WHILE node, and as the
    body of a WHILE node nested `inner` deep in another: device us a kernel
    of the body (CUDA events around a replay), and the kernel records
    torch.profiler sees in one replay against the kernels launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robust_nonlinear_mpc_torch.utils import graph_loop as gl

    dev = torch.device("cuda")
    x0 = torch.ones((512, 32), device=dev)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    n = torch.full((1,), bodies, dtype=torch.int32, device=dev)
    m = torch.full((1,), inner, dtype=torch.int32, device=dev)
    below = lambda s, k: (s[1] < k).any()

    def unrolled():
        s = (x0, zero)
        for _ in range(20):
            s = _tiny_body(s)
        return s

    def nested():
        outer = lambda s, k: (device_while(below, _tiny_body, (s[0], zero), m, cap=inner)[0],
                              s[1] + 1)
        return device_while(below, outer, (x0, zero), n // inner, cap=bodies)

    forms = {"straight": (unrolled, bodies // 20),
             "while": (lambda: device_while(below, _tiny_body, (x0, zero), n, cap=bodies), 1),
             "nested": (nested, 1)}
    out = {}
    for name, (fn, replays) in forms.items():
        g = torch.cuda.CUDAGraph()
        with gl.capturing(g):
            fn()
        g.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            g.replay()
            torch.cuda.synchronize()
        seen = sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
        launched = (bodies // replays) * KERNELS_A_BODY
        out[name] = {"us_a_kernel": 1e3 * start.elapsed_time(end) / (bodies * KERNELS_A_BODY),
                     "profiler_records": seen, "body_kernels_a_replay": launched}
        del g
    say("[2b f] a body of small kernels, device us a kernel: " + ", ".join(
        f"{k} {v['us_a_kernel']:.2f} (profiler saw {v['profiler_records']} kernel records "
        f"of a replay holding {v['body_kernels_a_replay']} body kernels)" for k, v in out.items()))
    return out


def card_vs_cpu(label, N, Bsz, configure, store_phi, seed, nominal=None, captured=False):
    """3 MPC steps from one nominal, the card against the CPU, each with its
    solver options from `configure(opts, device)`: identical success and QP
    iterations, X/U within 1e-8 (float64). The nominal is an SQP solve on
    the card at tolerance 1e-6, or `nominal` = (X, U, x0) of the first Bsz
    lanes of a bench seed. `captured`: the card runs the step captured as a
    CUDA graph (`capture_mpc_step`), the CPU the eager step."""
    dtype = torch.float64
    runs = {}
    for device in ("cuda", "cpu"):
        m, solver = make_rocket_problem(N=N, device=device, dtype=dtype)
        solver.opts = configure(solver.opts, device)
        runs[device] = (m, solver)
    rng = np.random.default_rng(seed)
    if nominal is None:
        x0s = torch.as_tensor(np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, NX)),
                              dtype=dtype, device="cuda")
        m, solver = runs["cuda"]
        # tolerance 1e-6: past it the float64 SQP only chases rounding noise
        # (ROADMAP.md section 3)
        sqp_opts = solver.opts.sqp._replace(tol_step=1e-6, tol_feas=1e-6)
        nom = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s, opts=sqp_opts)
        if not bool(nom.success.all()):
            fail(f"[{label}] SQP seed failed on the card")
        X, U = nom.X, nom.U
    else:
        X, U, x0s = (t[:Bsz].to(dtype) for t in nominal)
    w = rng.uniform(-1.0, 1.0, (3, Bsz, NX))
    outs = {}
    for device, (m, solver) in runs.items():
        to = lambda a: torch.as_tensor(a, dtype=dtype).to(device)
        persist = FastSLSPersist.init(N, NX, NU, m.ni, m.ni_f, NX, batch=Bsz, dtype=dtype,
                                      device=device, store_phi=store_phi)
        carry = (X.to(device), U.to(device), persist, x0s.to(device))
        step = (capture_mpc_step(solver, carry) if captured and device == "cuda"
                else make_mpc_step(solver))
        outs[device] = []
        for i in range(3):
            carry, out = step(carry, to(w[i]))
            outs[device].append(tree_map(lambda t: t.cpu(), out))
    for i, (g, c) in enumerate(zip(outs["cuda"], outs["cpu"])):
        ok_same = all(bool((g[j] == c[j]).all()) for j in (6, 7, 8))
        ex = float((g[2] - c[2]).abs().max())
        eu = float((g[3] - c[3]).abs().max())
        say(f"[{label}] step {i}: success {g[6].tolist()} qp iters {g[7].tolist()} "
            f"|dX| {ex:.2e} |dU| {eu:.2e}")
        if not ok_same or ex > 1e-8 or eu > 1e-8:
            fail(f"[{label}] closed-loop step {i} differs between the card and the CPU")


def check_closed_loop(seed_wl):
    """Phase 5: the bench's recycled-eta step (K1/K2 on the card) at N = 6,
    B = 8, then the reference's two-QP RTI step (K3 on the card) at N = 15,
    B = 16 from the first 16 lanes of the bench's SQP seed (`seed_wl`, N =
    15), each against the CPU's plain versions."""
    card_vs_cpu("5", 6, 8, lambda opts, device: opts._replace(
        verbose=False, ipm=IPMOptions(max_iter=15, tol=3e-5, kkt="fused"),
        adaptive_ipm_budget=(6, 15), streaming_response=True,
        recycle_eta=True, recycle_warm_qp=True,
    ), store_phi=False, seed=0)
    fused_backward.reset_launch_counts()
    Xs, Us, _, x0s = seed_wl.carry
    card_vs_cpu("5 two-QP", 15, 16, lambda opts, device: opts._replace(
        verbose=False, sls_block=-1 if device == "cuda" else 0,
    ), store_phi=True, seed=1, nominal=(Xs, Us, x0s))
    if fused_backward.launch_counts()["backward_K"] <= 0:
        fail("the two-QP step on the card did not launch backward_K")


CAPTURE_OUTS = ("x", "u0", "X", "U", "backoff_x", "backoff_u", "success", "qp_iters",
                "scp_iters", "scp_failed")


def compare_outs(label, got, ref):
    """The captured step's outs against the eager step's: identical success,
    QP and SCP iterations and scp_failed on every lane; the plant state, the
    plan and the backoffs bit for bit (NaN where the other has NaN). Where
    they are not bit for bit, within 1e-6 relative to each output's max
    |value|, and the line says so. Returns the largest relative difference."""
    worst = 0.0
    for name, a, b in zip(CAPTURE_OUTS, got, ref):
        if name in ("success", "qp_iters", "scp_iters", "scp_failed"):
            if not torch.equal(a, b):
                fail(f"[{label}] {name} differs on {int((a != b).sum())} lanes")
            continue
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            fail(f"[{label}] {name}: the NaN pattern differs")
        a, b = torch.nan_to_num(a), torch.nan_to_num(b)
        if torch.equal(a, b):
            continue
        r, ab = rel_err(a, b)
        worst = max(worst, r)
        say(f"[{label}] {name} not bit for bit: max |diff| {ab:.3e}, relative {r:.3e} "
            "(a library may pick another algorithm under capture)")
        if not r <= 1e-6:
            fail(f"[{label}] {name}: captured and eager differ by {r:.3e} relative")
    return worst


def captured_vs_eager(label, wl, carry, w_seq, steps=3):
    """`steps` replays of the captured step against as many eager steps
    from the same carry and disturbances, each replay with the eager step's
    kernel launches (counted by the WHILE nodes' device counters: the IPM
    runs the eager step's iterations, not its cap); the kernels of the
    configuration must be in the graph. Frees the graph's pool after.
    Returns the launches of the captured steps, one dict a step."""
    eager, eager_launches, c = [], [], carry
    for i in range(steps):
        before = Counter(bench.launch_counts())
        c, out = wl.mpc_step(c, w_seq[i])
        eager.append(out)
        eager_launches.append(dict(Counter(bench.launch_counts()) - before))
    t0 = time.perf_counter()
    step = capture_mpc_step(wl.solver, carry)
    t_capture = time.perf_counter() - t0
    worst, c, launches = 0.0, carry, []
    for i in range(steps):
        before = step.launched()
        c, out = step(c, w_seq[i])
        worst = max(worst, compare_outs(f"{label} step {i}", out, eager[i]))
        launches.append(dict(step.launched() - before))
        if launches[-1] != eager_launches[i]:
            fail(f"[{label}] step {i}: the captured step launched {launches[-1]}, the eager "
                 f"step {eager_launches[i]}")
    torch.cuda.synchronize()
    say(f"[{label}] B={carry[3].shape[0]} kkt={wl.solver.opts.ipm.kkt} response={wl.response} "
        f"sls_block={wl.sls_block}: {steps} captured steps equal the eager steps "
        f"({'bit for bit' if worst == 0.0 else f'max relative {worst:.3e}'}) with their "
        f"kernel launches {launches}; success {float(out[6].float().mean()):.4f}, mean QP "
        f"iterations {[round(float(o[7].float().mean()), 3) for o in eager]}, max "
        f"{[int(o[7].max()) for o in eager]}; warm-up and capture {t_capture:.1f} s; WHILE "
        f"nodes {len(step.recording.loops)}")
    del step
    torch.cuda.empty_cache()
    return launches


def check_capture(wls):
    """Phase 10: the RTI step captured as one CUDA graph against the eager
    step on the card. (a) B = 512, N = 15, float32, 3 steps from the bench
    seed in each configuration: default (K1/K2), fused-kernel (K6/K4) and
    K3; (b) the default configuration at B = 529 (the seed's 512 lanes and
    again its first 17), so the last wave of the kernels is part-filled;
    (c) float64, N = 6, B = 8: the captured step on the card against the
    eager step on the CPU (plain versions), phase 5's criteria; (d) the
    captured K = 8 program against 8 replays of the one-step graph; (e)
    `build_batched_closed_loop` in RTI mode on the captured step against
    the CPU."""
    for label, kernels in PATH_KERNELS.items():
        wl = wls[label]
        launched = captured_vs_eager(f"10a {label}", wl, wl.carry, wl.w_seq)
        if not all(k in step for step in launched for k in kernels):
            fail(f"[10a {label}] a captured step launched none of {kernels}: {launched}")
    wl = wls["6"]
    X, U, _, x0s = wl.carry
    more = lambda t: torch.cat([t, t[:17]])
    m = wl.m
    persist = FastSLSPersist.init(wl.solver.N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=529,
                                  dtype=wl.dtype, device=wl.device, store_phi=False)
    captured_vs_eager("10b", wl, (more(X), more(U), persist, more(x0s)),
                      torch.cat([wl.w_seq[:3], wl.w_seq[:3, :17]], dim=1))
    card_vs_cpu("10c", 6, 8, lambda opts, device: opts._replace(
        verbose=False, ipm=IPMOptions(max_iter=15, tol=3e-5, kkt="fused"),
        adaptive_ipm_budget=(6, 15), streaming_response=True,
        recycle_eta=True, recycle_warm_qp=True,
    ), store_phi=False, seed=0, captured=True)
    # (d) K = 8 in one graph against 8 replays of the one-step graph
    K = 8
    one = capture_mpc_step(wl.solver, wl.carry)
    prog = capture_mpc_step(wl.solver, wl.carry, steps=K)
    c, singles = wl.carry, []
    for i in range(K):
        c, out = one(c, wl.w_seq[i])
        singles.append(tree_map(torch.clone, out))
    c_single = tree_map(torch.clone, c)
    c_prog, outs = prog(wl.carry, wl.w_seq[:K])
    for i in range(K):
        compare_outs(f"10d step {i}", tuple(o[i] for o in outs), singles[i])
    for a, b in zip(tree_leaves(c_prog), tree_leaves(c_single)):
        if not torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)):
            fail("[10d] the K = 8 program's carry differs from 8 single replays'")
    k_prog, k_one = dict(prog.launched()), dict(one.launched())
    if k_prog != k_one:
        fail(f"[10d] the K = {K} program launched {k_prog}, {K} single replays {k_one}")
    say(f"[10d] the captured K = {K} program equals {K} replays of the one-step graph "
        f"(outs, carry and kernel launches {k_prog})")
    del one, prog
    torch.cuda.empty_cache()
    check_rti_closed_loop()


def check_rti_closed_loop(Bsz=8, N=6, steps=3, seed=0, devices=("cuda", "cpu")):
    """Phase 10e: `build_batched_closed_loop` in RTI mode with the
    reference's two-QP RTI options (what the Monte-Carlo validation's RTI
    rows run), kkt="fused", float64, SQP seed at tolerance 1e-6: on the
    card its steps are replays of the captured step, on the CPU eager steps
    (plain versions); phase 9a's criteria (`compare_logs`)."""
    rng = np.random.default_rng(seed)
    x0s = np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, NX))
    Ws = 2 * rng.random((Bsz, steps, NX)) - 1
    logs = {}
    fused_qp.reset_launch_counts()
    for device in devices:
        m, solver = make_rocket_problem(N=N, device=device, dtype=torch.float64)
        solver.opts = solver.opts._replace(
            verbose=False, ipm=solver.opts.ipm._replace(kkt="fused"),
            sqp=solver.opts.sqp._replace(tol_step=1e-6, tol_feas=1e-6))
        logs[device] = build_batched_closed_loop(solver, steps)(x0s, Ws)
    launches = fused_qp.launch_counts()
    if devices[0] == "cuda" and min(launches["factor_predictor"], launches["resolve"]) <= 0:
        fail(f"[10e] the captured closed loop did not hold K1/K2: {launches}")
    worst = compare_logs("10e", logs[devices[0]], logs[devices[1]])
    say(f"[10e] build_batched_closed_loop RTI (two-QP) N={N} B={Bsz} f64 {steps} steps, "
        f"{devices[0]} (captured) against {devices[1]} (eager): success "
        f"{logs[devices[1]].success.tolist()}, QP iterations "
        f"{logs[devices[1]].qp_iters.tolist()}, max |diff| {worst:.2e}")


def run_bench(label, wl, n_lat=LATENCY_STEPS):
    """One bench twin run (warm-in, timed window, B = 1 latency loop of
    `n_lat` steps) of a built workload, its launch counts zeroed just before
    and read just after (the WHILE nodes' tests too: each captured step
    holds some). It fails on success below 1.0, the captured step against
    the eager one or no on-device step time."""
    from robust_nonlinear_mpc_torch.ops import graph_while

    bench.reset_launch_counts()
    graph_while.reset_launch_counts()
    t0 = time.perf_counter()
    record, carry = bench.run(wl, n_lat=n_lat)
    launches = bench.launch_counts()
    while_launches = graph_while.launch_counts()
    if min(while_launches.values()) <= 0:
        fail(f"bench twin [{label}]: the captured steps hold no WHILE node: {while_launches}")
    say(f"[{label}] bench twin kkt={record['kkt']} response={record['response']} "
        f"sls_block={record['sls_block']} N={record['horizon_N']} B={record['batch']} on the "
        f"captured step "
        f"ran in {time.perf_counter() - t0:.1f} s: {record['value']} solves/s, "
        f"on_device_step_ms {record['on_device_step_ms']} (K walls "
        f"{record['on_device_fit_points_ms']}), latency p50 "
        f"{record['single_step_latency_ms']} ms, wrapper counts (warm-ups, captures, the "
        f"eager check) {launches}, a timed step (mean) {record['kernel_launches_per_step']}, "
        f"WHILE tests captured {while_launches}")
    print(json.dumps(record), flush=True)
    check = record["eager_check"]
    if record["success_fraction"] != 1.0 or not record["finite"]:
        fail(f"bench twin [{label}]: success_fraction must be 1.0 and the state finite")
    if not (check["success_equal"] and check["qp_iters_equal"]):
        fail(f"bench twin [{label}]: the captured step and the eager step differ: {check}")
    if record["on_device_step_ms"] is None:
        fail(f"bench twin [{label}]: on_device_step_ms is not positive: "
             f"{record['on_device_fit_points_ms']}")
    return record, carry, launches


def breakdown(label, wl, carry, profiled=(False, True)):
    """Stage breakdown of the eager step, and the device busy share of the
    eager and the captured step (`profiled`: which of them, by `captured`),
    of one configuration."""
    stages = bench.stage_breakdown(wl, carry, wl.w_seq[0])
    say(f"[{label}] stage ms (eager) {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    out = {"stages": stages}
    for captured in profiled:
        name = "profile_captured" if captured else "profile"
        prof = bench.profile_kernels(wl, carry, wl.w_seq, captured=captured)
        say(f"[{label}] profiler, {'captured' if captured else 'eager'} step: {prof['steps']} "
            f"steps, wall {prof['wall_ms']:.2f} ms (profiled {prof['profiled_ms']:.2f} ms), "
            f"device kernels {prof['device_kernel_ms']:.2f} ms summed, "
            f"{prof['device_busy_ms']:.2f} ms busy (their union), busy share "
            f"{prof['device_busy_share']:.4f}, {prof['kernel_records']} kernel records, K1/K2 "
            f"records {prof['k1k2_records']} of launches {prof['k1k2_launches']} (complete "
            f"{prof['records_complete']})")
        out[name] = prof
    torch.cuda.empty_cache()
    return out


def bench_workloads():
    """The workloads of phases 6, 7 and 8, from one SQP seed."""
    t0 = time.perf_counter()
    wls = {"6": bench.build_workload()}
    wls["7"] = bench.build_workload(kkt="fused_iter", response="fused", seed_from=wls["6"])
    wls["8"] = bench.build_workload(sls_block=-1, seed_from=wls["6"])
    say(f"[6] bench workloads built (one SQP seed) in {time.perf_counter() - t0:.1f} s")
    return wls


def bench_phases(wls):
    """Phases 6, 7 and 8: the main path (K1, K2), the fused-kernel path (K6,
    K4) and the sls_block = -1 path (K3), all from one SQP seed. Phases 6
    and 7 run twice, in the order default, fused, fused, default, so the
    host's drift shows in the pairs; phase 8 runs once. Returns each
    kernel's launches in the first run of its path."""
    launches, profile = {}, {label: {"records": []} for label in wls}
    for label in ("6", "7", "7", "6", "8"):
        record, carry, counts = run_bench(label, wls[label])
        kernels = PATH_KERNELS[label]
        if min(counts[k] for k in kernels) <= 0:
            fail(f"the bench path [{label}] did not launch {kernels}: {counts}")
        if min(record["kernel_launches"][k] for k in kernels) <= 0:
            fail(f"the bench path [{label}] did not launch {kernels} in the timed steps")
        profile[label]["records"].append(record)
        if "stages" not in profile[label]:
            # the timed window's launches, the IPM iterations by the WHILE
            # nodes' device counters
            launches.update({k: record["kernel_launches"][k] for k in kernels})
            profile[label].update(breakdown(label, wls[label], carry))
        torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.json").write_text(json.dumps(profile, indent=1))
    return launches


def check_long_probe(lanes=512):
    """Phase 14 (a): the QP probe (`tools/fused_n60_qp_probe.py`) at N = 60
    on `lanes` float32 rocket QPs around the lanes' SQP nominals: kkt="fused"
    against kkt="riccati", identical iterations and success on every lane,
    X/U within 1e-4 relative (phase 4's criteria)."""
    from robust_nonlinear_mpc_torch.tools import fused_n60_qp_probe as probe

    row = probe.probe(LONG_N, lanes, 15, "cuda", torch.float32)
    ric, fus = row["riccati"], row["fused"]
    say(f"[14] QP probe N={LONG_N} B={lanes} f32: SQP nominals {row['sqp_s']:.1f} s "
        f"({row['sqp_success']} converged), solves {row['solves_s']:.1f} s; riccati success "
        f"{ric['n_success']} mean iters {ric['mean_iters']:.3f} worst KKT {ric['worst_kkt']:.2e}; "
        f"fused success {fus['n_success']} mean iters {fus['mean_iters']:.3f} worst KKT "
        f"{fus['worst_kkt']:.2e}; lanes differing in iters {row['lanes_iters_differ']}, in "
        f"success {row['lanes_success_differ']}; X rel {row['rel_X_gap']:.2e}, U rel "
        f"{row['rel_U_gap']:.2e}")
    if row["lanes_iters_differ"] or row["lanes_success_differ"]:
        fail("[14] the probe's fused and riccati paths differ in iterations or success")
    if not (row["rel_X_gap"] <= 1e-4 and row["rel_U_gap"] <= 1e-4):
        fail("[14] the probe's fused and riccati solutions differ by more than 1e-4")
    return {k: v for k, v in row.items() if k not in ("riccati", "fused")} | {
        kkt: {k: row[kkt][k] for k in ("n_success", "mean_iters", "worst_kkt")}
        for kkt in ("riccati", "fused")}


def long_horizon_phase(out="chip_smoke_14.json"):
    """Phase 14: the long horizon, N = 60, where the JAX package runs its
    windowed Newton kernels K5a-c (phase 3 holds K1/K2 against their plain
    versions at (512, 60) and reports their occupancy there): (a) the QP
    probe at B = 512; (b) a cut bench run at N = 60 (`LONG_SMOKE`: lanes,
    warm-in and timed steps cut; latency loop `LONG_SMOKE_LAT`) from its
    own SQP seed, which must launch K1/K2 in the captured step's timed replays with success 1.0
    and the state finite. Writes the record; returns it (with the timed
    window's K1/K2 launches)."""
    t0 = time.perf_counter()
    record = {"probe": check_long_probe()}
    t1 = time.perf_counter()
    wl = bench.build_workload(N=LONG_N, **LONG_SMOKE)
    seed_s = time.perf_counter() - t1
    bench_record, _, _ = run_bench("14", wl, n_lat=LONG_SMOKE_LAT)
    timed = bench_record["kernel_launches"]
    if min(timed.get(k, 0) for k in NEWTON) <= 0:
        fail(f"[14] the N = {LONG_N} bench step did not launch K1/K2 in its timed replays: {timed}")
    record.update(bench=bench_record, seed_s=seed_s, cuts=LONG_SMOKE | {"n_lat": LONG_SMOKE_LAT},
                  launches={f"{k}_n60": timed[k] for k in NEWTON},
                  phase_s=time.perf_counter() - t0)
    say(f"[14] cut bench N={LONG_N} ({LONG_SMOKE}, latency loop {LONG_SMOKE_LAT}): seed "
        f"{seed_s:.1f} s ({wl.n_soft_fallback} soft-fallback lanes), success "
        f"{bench_record['success_fraction']}, finite {bench_record['finite']}, K1/K2 in the "
        f"timed replays {record['launches']}; phase 14 took {record['phase_s']:.1f} s")
    del wl
    torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out).write_text(json.dumps(record, indent=1))
    return record


def long_horizon_runs(horizons, out="chip_smoke_long_horizon.json"):
    """`--long-horizon`: the bench twin's record at each N of `horizons`, at
    its full configuration (B = 512, 30 warm-in and 10 timed steps, float32,
    the B = 1 latency loop cut to LATENCY_STEPS), kkt="fused" (K1/K2) and
    kkt="riccati" (the plain Newton path the JAX record compares against)
    from one SQP seed, in the order fused, riccati, riccati, fused; the
    first run of each with its stage breakdown, and the first fused run
    with the captured step's busy share (`bench.profile_kernels`); the
    seed's seconds and each run's peak device memory. Each run fails as every bench run does
    (`run_bench`). Writes after each run."""
    result = {"gpu": bench.gpu_identity()[2], "horizons": {}}
    path = OUT_DIR / out
    OUT_DIR.mkdir(exist_ok=True)
    for N in horizons:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        wls = {"fused": bench.build_workload(N=N)}
        seed_s = time.perf_counter() - t0
        wls["riccati"] = bench.build_workload(N=N, kkt="riccati", seed_from=wls["fused"])
        entry = result["horizons"][str(N)] = {
            "seed_s": seed_s, "soft_fallback_lanes": wls["fused"].n_soft_fallback,
            "seed_peak_gib": torch.cuda.max_memory_allocated() / 2**30, "runs": []}
        say(f"[lh] N={N}: SQP seed of B=512 lanes in {seed_s:.1f} s, "
            f"{entry['soft_fallback_lanes']} soft-fallback lanes")
        for kkt in ("fused", "riccati", "riccati", "fused"):
            torch.cuda.reset_peak_memory_stats()
            record, carry, _ = run_bench(f"lh N={N} {kkt}", wls[kkt])
            timed = record["kernel_launches"]
            newton = [timed.get(k, 0) for k in NEWTON]
            if kkt == "fused" and min(newton) <= 0:
                fail(f"[lh] N={N}: the fused step did not launch K1/K2 in its timed replays")
            if kkt == "riccati" and max(newton) > 0:
                fail(f"[lh] N={N}: the riccati step launched K1/K2")
            run = {"kkt": kkt, "record": record,
                   "captured_step_ms": 1e3 * record["batch"] / record["value"],
                   "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            if all(r["kkt"] != kkt for r in entry["runs"]):
                # the captured fused step's profile only: with CPU activity
                # the eager profile took 270 s for riccati at N = 30 (290,247
                # kernel records in 3 steps), and the profiled captured
                # riccati step at N = 60 ended the process (SIGSEGV)
                run.update(breakdown(f"lh N={N} {kkt}", wls[kkt], carry,
                                     profiled=(True,) if kkt == "fused" else ()))
            say(f"[lh] N={N} {kkt}: captured step {run['captured_step_ms']:.3f} ms, peak "
                f"{run['peak_gib']:.2f} GiB")
            entry["runs"].append(run)
            path.write_text(json.dumps(result, indent=1))
            del carry
            torch.cuda.empty_cache()
        del wls
        torch.cuda.empty_cache()
    return result


def random_qps(Bsz, N, nx, nu, dtype, device, seed):
    """Well-conditioned random QPs at the given widths (ni = 2 (nx + nu),
    ni_f = 2 nx), made with numpy: stable dynamics, interior-feasible
    bounds."""
    from robust_nonlinear_mpc_torch.ops.qp_ipm import QPStatics

    rng = np.random.default_rng(seed)
    ni, ni_f = 2 * (nx + nu), 2 * nx
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    stat = QPStatics(Hx=t(2 * np.eye(nx)), Hu=t(2 * np.eye(nu)), HxN=t(10 * np.eye(nx)),
                     Gx=t(rng.standard_normal((ni, nx))), Gu=t(rng.standard_normal((ni, nu))),
                     Gf=t(rng.standard_normal((ni_f, nx))))
    data = QPData(
        A=t(0.9 * np.eye(nx) + 0.1 * rng.standard_normal((Bsz, N, nx, nx)) / np.sqrt(nx)),
        B=t(0.3 * rng.standard_normal((Bsz, N, nx, nu))),
        c=t(0.05 * rng.standard_normal((Bsz, N, nx))),
        qx=t(0.3 * rng.standard_normal((Bsz, N + 1, nx))),
        qu=t(0.3 * rng.standard_normal((Bsz, N, nu))),
        h=t(3.0 + np.abs(rng.standard_normal((Bsz, N, ni)))),
        hf=t(3.0 + np.abs(rng.standard_normal((Bsz, ni_f)))),
        xinit=t(0.2 * rng.standard_normal((Bsz, nx))))
    return stat, data


def median_call_ms(fn, n=3):
    """Median over n calls of one call's time (ms) between CUDA events, after
    one call to warm up."""
    fn()
    samples = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end))
    return float(np.median(samples))


def check_condensed(Bsz=512, N=15, device="cuda"):
    """Phase 13a: kkt="condensed" (torch ops, no kernel of its own) on the
    card. Float64 on well-conditioned random QPs at the rocket's widths:
    on every lane that kkt="riccati" solves, the same iteration count,
    success and X/U within 1e-9. Then float32 on the bench's rocket QPs (phase 4's, the bench's
    IPM options): condensed, riccati and fused, median ms a solve of 3
    calls, success and mean iterations."""
    stat, data = random_qps(Bsz, N, NX, NU, torch.float64, device, seed=4)
    opts = IPMOptions(max_iter=30, tol=1e-9)
    ric = solve_qp(stat, data, opts._replace(kkt="riccati"))
    con = solve_qp(stat, data, opts._replace(kkt="condensed"))
    # held on the lanes the reference path solves: riccati stops short on a
    # few lanes, where condensed may go on to converge
    ok = ric.success
    same = int((ric.iters == con.iters)[ok].sum())
    ex, _ = rel_err(con.X[ok], ric.X[ok])
    eu, _ = rel_err(con.U[ok], ric.U[ok])
    say(f"[13a] condensed vs riccati, random QPs B={Bsz} N={N} nx={NX} nu={NU} float64: on the "
        f"{int(ok.sum())} lanes riccati solves, iters equal on {same} (mean "
        f"{ric.iters[ok].float().mean():.2f}), condensed success {int(con.success[ok].sum())}, "
        f"X rel err {ex:.2e}, U rel err {eu:.2e}; the other lanes: riccati iters "
        f"{ric.iters[~ok].tolist()} KKT {ric.kkt_res[~ok].tolist()}, condensed iters "
        f"{con.iters[~ok].tolist()} KKT {con.kkt_res[~ok].tolist()}")
    if same != int(ok.sum()) or not bool(con.success[ok].all()):
        fail("[13a] kkt='condensed' and kkt='riccati' differ in iterations or success")
    if not (ex <= 1e-9 and eu <= 1e-9):
        fail("[13a] condensed and riccati solutions differ by more than 1e-9")
    stat, data = rocket_qps(Bsz, N, torch.float32, device, seed=3)
    opts = IPMOptions(max_iter=bench.COLD_CAP, tol=3e-5)
    out = {}
    for kkt in ("condensed", "riccati", "fused"):
        o = opts._replace(kkt=kkt)
        sol = solve_qp(stat, data, o)
        ms = median_call_ms(lambda: solve_qp(stat, data, o))
        out[kkt] = {"ms": ms, "success": float(sol.success.float().mean()),
                    "mean_iters": float(sol.iters.float().mean()),
                    "finite_lanes": int(torch.isfinite(sol.X).flatten(1).all(1).sum())}
    say(f"[13a] rocket QPs B={Bsz} N={N} float32 (max_iter {bench.COLD_CAP}, tol 3e-5), ms a "
        f"solve (median of 3, CUDA events): {json.dumps(out)}")
    return out


def tube_precision_pairs(wl, n_warm=10, n_rep=10, pairs=2):
    """Phase 13b: the bench step with the tube at "default" (TF32 tube GEMMs)
    against "highest", from the bench seed after n_warm replays: the largest
    backoff deviation of one step from the same state, then solves/s of
    n_rep replays in alternating pairs (highest, default, default, highest,
    ...). The switch must set TF32 inside its context only."""
    from robust_nonlinear_mpc_torch.utils.numerics import (
        set_tube_precision,
        tf32_enabled,
        tube_precision,
    )

    step_h = capture_mpc_step(wl.solver, wl.carry)
    carry = wl.carry
    for i in range(n_warm):
        carry, _ = step_h(carry, wl.w_seq[i])
    carry = tree_map(torch.clone, carry)
    set_tube_precision("default")
    try:
        with tube_precision():
            inside = tf32_enabled()
        step_d = capture_mpc_step(wl.solver, carry)
    finally:
        set_tube_precision("highest")
    if not inside or tf32_enabled():
        fail(f"[13b] the tube switch: TF32 inside its context {inside}, after it {tf32_enabled()}")
    w = wl.w_seq[n_warm]
    out_h = tree_map(torch.clone, step_h(carry, w)[1])
    out_d = tree_map(torch.clone, step_d(carry, w)[1])
    dev = {}
    for name, i in (("backoff_x", 4), ("backoff_u", 5)):
        h, d = out_h[i], out_d[i]
        ok = torch.isfinite(h) & torch.isfinite(d)
        diff = float((h - d).abs()[ok].max()) if bool(ok.any()) else float("nan")
        dev[name] = {"max_abs": diff, "rel": diff / max(float(h[ok].abs().max()), 1e-30)}
    steps = {"highest": step_h, "default": step_d}
    rates = {"highest": [], "default": []}
    for mode in ("highest", "default", "default", "highest") * (pairs // 2):
        c = carry
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n_rep):
            c, out = steps[mode](c, wl.w_seq[n_warm + i])
        torch.cuda.synchronize()
        rates[mode].append(wl.B * n_rep / (time.perf_counter() - t0))
        if not bool(torch.isfinite(c[0]).all()):
            fail(f"[13b] the tube at {mode!r} gave a non-finite plan")
    record = {"backoff_deviation": dev, "solves_per_s": rates,
              "success_highest": float(out_h[6].float().mean()),
              "success_default": float(out_d[6].float().mean()),
              "qp_iters_equal_lanes": int((out_h[7] == out_d[7]).sum())}
    say(f"[13b] tube 'default' (TF32) vs 'highest', bench step B={wl.B} float32: "
        f"{json.dumps(record)}")
    return record


def precision_phase(wl):
    """Phase 13: the condensed IPM and the tube precision switch, alone on
    the card; its record goes to chiprun_out/chip_smoke_13.json."""
    t0 = time.perf_counter()
    record = {"condensed": check_condensed(), "tube": tube_precision_pairs(wl)}
    record["phase_s"] = time.perf_counter() - t0
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_13.json").write_text(json.dumps(record, indent=1))
    say(f"[13] phase 13 took {record['phase_s']:.1f} s")
    torch.cuda.empty_cache()


def converged_options(opts):
    """Phase 9a's guarantee-mode options: until convergence (the published
    criterion 1e-3 and budget of 40 SCP iterations), restoration, stall
    damping 0.5 after 5 SCP iterations, the soft fallback, the fused Newton
    kernels, and the SQP seed at tolerance 1e-6 (ROADMAP.md section 3)."""
    return opts._replace(
        verbose=False, rti=-1, fast_sls_rti_steps=0, epsilon_convergence=1e-3,
        max_iter_scp=40, ipm=IPMOptions(max_iter=30, tol=1e-9, kkt="fused"),
        feasibility_restoration=True, scp_stall_damping=0.5, stall_damping_after=5,
        nominal_soft_fallback=True,
        sqp=opts.sqp._replace(tol_step=1e-6, tol_feas=1e-6),
    )


def compare_logs(label, got, ref, tol=1e-8):
    """Identical success, SCP iterations, scp_failed and QP iterations on
    every lane; X/U and the finite backoffs within tol, NaN where ref has
    NaN. Returns the largest difference."""
    for f in ("success", "scp_iters", "scp_failed", "qp_iters"):
        a, b = getattr(got, f).cpu(), getattr(ref, f).cpu()
        if not torch.equal(a, b):
            fail(f"[{label}] {f} differs on {int((a != b).sum())} lane-steps")
    worst = 0.0
    for f in ("nominal_x", "nominal_u", "state_trajectory", "backoff_x", "backoff_u"):
        a, b = getattr(got, f).cpu(), getattr(ref, f).cpu()
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            fail(f"[{label}] {f}: the NaN pattern differs")
        d = torch.nan_to_num(a - b).abs().max()
        worst = max(worst, float(d))
    if worst > tol:
        fail(f"[{label}] trajectories or backoffs differ by {worst:.3e} > {tol:g}")
    return worst


def check_converged(Bsz=8, N=6, steps=2, seed=0, devices=("cuda", "cpu"), chunked=(1, 5),
                    ref_lanes=None):
    """Phase 9a: the until-convergence closed loop with every mitigation,
    devices[0] (the kernels; on the card the seed's loops and the SCP
    rounds' pieces run as CUDA graphs) against devices[1] (the plain
    versions), from the same draws (x0 spread 0.05 around X0, w in [-1, 1]),
    for build_batched_closed_loop and for build_chunked_converged_loop at
    each scp_per_dispatch in `chunked`; and each chunked run captured
    against the eager masked loop on devices[0] (`capture=False`, run once,
    at the first scp_per_dispatch: the masked loop's results do not depend
    on it): identical flags and iteration counts, X/U and the backoffs
    within 1e-9.
    `ref_lanes`: the reference runs only the first lanes (each lane's result
    does not depend on the others in its batch)."""
    dtype = torch.float64
    solvers = {}
    for device in devices:
        m, solver = make_rocket_problem(N=N, device=device, dtype=dtype)
        solver.opts = converged_options(solver.opts)
        solvers[device] = solver
    rng = np.random.default_rng(seed)
    x0s = np.array(X0)[None] + 0.05 * rng.standard_normal((Bsz, NX))
    Ws = 2 * rng.random((Bsz, steps, NX)) - 1
    card, host = devices
    restored = []
    restore = solvers[card]._restore

    def counting(*a):
        out = restore(*a)
        restored.append(int(out[2].sum()))
        return out

    solvers[card]._restore = counting
    fused_qp.reset_launch_counts()
    t0 = time.perf_counter()
    run = build_batched_closed_loop(solvers[card], steps)
    got = run(x0s, Ws)
    t_card = time.perf_counter() - t0
    launches = fused_qp.launch_counts()
    if card == "cuda" and not run.record["captured"]:
        fail("[9a] the converged loop on the card did not run as CUDA graphs")
    t0 = time.perf_counter()
    ref = build_batched_closed_loop(solvers[host], steps)(x0s[:ref_lanes], Ws[:ref_lanes])
    t_host = time.perf_counter() - t0
    lanes = lambda log: type(log)(*(t[:ref_lanes] for t in log))
    if card == "cuda" and min(launches["factor_predictor"], launches["resolve"]) <= 0:
        fail(f"[9a] the converged loop on the card did not launch K1/K2: {launches}")
    worst = compare_logs("9a batched", lanes(got), ref)
    shown = lanes(got)
    say(f"[9a] converged rocket N={N} B={Bsz} f64 {steps} steps, {card} {t_card:.1f} s "
        f"against {host} {t_host:.1f} s on {ref.success.shape[0]} lanes: success "
        f"{shown.success.tolist()}, SCP iterations {shown.scp_iters.tolist()} (max of all "
        f"{int(got.scp_iters.max())}), scp_failed {int(got.scp_failed.sum())}, QP iterations "
        f"{shown.qp_iters.tolist()}, restored lane-iterations {sum(restored)}, max |diff| "
        f"{worst:.2e}, launches {launches}, host reads per step "
        f"{[c['host_reads'] for c in run.record['steps']]}")
    eager = None
    for kpd in chunked:
        t0 = time.perf_counter()
        run = build_chunked_converged_loop(solvers[card], steps, scp_per_dispatch=kpd)
        ch = run(x0s, Ws)
        t_ch = time.perf_counter() - t0
        if eager is None:
            # the masked loop's results do not depend on scp_per_dispatch:
            # one eager run is the reference of every captured one
            t0 = time.perf_counter()
            eager_run = build_chunked_converged_loop(solvers[card], steps, scp_per_dispatch=kpd,
                                                     capture=False)
            eager = eager_run(x0s, Ws)
            t_eager = time.perf_counter() - t0
        same = compare_logs(f"9a chunked {kpd} captured/eager", ch, eager, tol=1e-9)
        worst = compare_logs(f"9a chunked {kpd}", lanes(ch), ref)
        steps_rec = run.record["steps"]
        k12 = lambda rec: [[c.get("factor_predictor", 0), c.get("resolve", 0)]
                           for c in rec["step_launches"]]
        if card == "cuda":
            # at the eager run's scp_per_dispatch the same rounds run; at a
            # larger one the rounds after the last lane is decided and before
            # the next read run too (every lane frozen, the QPs still solved)
            got_k, eager_k = np.array(k12(run.record)), np.array(k12(eager_run.record))
            if not (np.array_equal(got_k, eager_k) if kpd == chunked[0]
                    else (got_k >= eager_k).all()):
                fail(f"[9a] chunked {kpd}: K1/K2 launches a step {k12(run.record)} as CUDA "
                     f"graphs, {k12(eager_run.record)} eagerly at scp_per_dispatch "
                     f"{chunked[0]}")
            if run.record["loop_host_reads"] != 0:
                fail(f"[9a] chunked {kpd}: the captured loops read the device "
                     f"{run.record['loop_host_reads']} times")
        say(f"[9a] chunked scp_per_dispatch={kpd} on {card}, captured {t_ch:.1f} s "
            f"(host reads per step {[c['host_reads'] for c in steps_rec]}, of them by loops "
            f"{run.record['loop_host_reads']}; graph replays "
            f"{[sum(c.values()) - c['host_reads'] for c in steps_rec]}; K1/K2 launches a step "
            f"{k12(run.record)}) against the eager masked loop (scp_per_dispatch="
            f"{chunked[0]}, {t_eager:.1f} s, host reads per step "
            f"{[c['host_reads'] for c in eager_run.record['steps']]}, K1/K2 "
            f"{k12(eager_run.record)}): max |diff| {same:.2e}; against the {host} batched "
            f"loop: max |diff| {worst:.2e}")


# torch.profiler on a guarantee round (its graphs hold WHILE nodes): at
# B = 128 it kept 2 of the round's 105 K1 records, at B = 256 all of them,
# and at B = 512 the profiled round ended in an illegal memory access that
# unprofiled rounds of the same state do not make (NVIDIA H100 80GB HBM3,
# torch 2.11, CUDA 12.8); so it profiles only up to this B
PROFILER_MAX_B = 256


def profile_round(solver, st, x, graphs, profiler=False):
    """One masked SCP round of every lane (`sim.closed_loop._scp_round`, the
    undecided lanes running) from a step's entry state `st` (a
    `sim.closed_loop._ConvState`) at plant state x, through the run's CUDA
    graphs `graphs`, as the step's first SCP round runs it. Returns its ms
    on the host clock and between CUDA events on the stream, its graph
    replays and host reads, its K1/K2 launches (the graphs' counters, a
    WHILE body's from the node's device counter) and the graph-busy share:
    the union of the replays' device intervals (CUDA events around each
    replay, `GraphSet.timeline`) over the round's event ms; the rest is
    the card waiting for the host (its reads and enqueues). With `profiler`
    the round runs once more under torch.profiler (CUDA activity only):
    the K1/K2 kernel records it kept against the counters' launches
    (`records_complete`), the summed kernel ms, the kernels' busy share
    and the idle time between kernels by gap length."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robust_nonlinear_mpc_torch.sim import closed_loop as cl

    max_scp = int(solver.opts.max_iter_scp)
    k12 = lambda c: {k: c.get(k, 0) for k in ("factor_predictor", "resolve")}

    def one_round():
        s, xs = graphs.static("scp.state", st), graphs.static("scp.x", x)
        cl._scp_round(solver, s, xs, cl._undecided(s, max_scp), graphs)
        torch.cuda.synchronize()

    one_round()
    counts, launched = graphs.counts, graphs.kernel_launches()
    t0 = time.perf_counter()
    one_round()
    round_ms = 1e3 * (time.perf_counter() - t0)
    per_round = graphs.counts - counts
    launches = k12(graphs.kernel_launches() - launched)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graphs.timeline = []
    try:
        start.record()
        one_round()
        stop.record()
        torch.cuda.synchronize()
        spans = [(start.elapsed_time(a), start.elapsed_time(b)) for a, b in graphs.timeline]
    finally:
        graphs.timeline = None
    event_ms, graph_ms = start.elapsed_time(stop), bench.union_ms(spans)
    out = {"round_ms": round_ms, "event_ms": event_ms, "graph_busy_ms": graph_ms,
           "graph_busy_share": graph_ms / event_ms,
           "graph_replays": sum(v for k, v in per_round.items() if k != "host_reads"),
           "host_reads": per_round["host_reads"], "k1k2_launches": launches}
    if not profiler:
        return out
    launched = graphs.kernel_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_round()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    profiled = k12(graphs.kernel_launches() - launched)
    kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    records = {"factor_predictor": sum("factor_predictor_kernel" in ev.name for ev in kernels),
               "resolve": sum("resolve_kernel" in ev.name for ev in kernels)}
    intervals = sorted((ev.time_range.start, ev.time_range.end) for ev in kernels)
    gaps = {"under_10us": 0.0, "10_to_100us": 0.0, "over_100us": 0.0}
    end = None
    for s, e in intervals:
        if end is not None and s > end:
            gap = s - end
            gaps["under_10us" if gap < 10 else "10_to_100us" if gap < 100 else "over_100us"] += gap / 1e3
        end = e if end is None else max(end, e)
    busy_ms = bench.union_ms(intervals) / 1e3
    out.update(profiled_ms=profiled_ms, kernel_records=len(kernels),
               device_kernel_ms=sum(ev.self_device_time_total for ev in prof.key_averages()
                                    if ev.device_type == DeviceType.CUDA) / 1e3,
               device_busy_ms=busy_ms, device_busy_share=busy_ms / profiled_ms,
               idle_ms_by_gap=gaps, k1k2_launches_profiled=profiled, k1k2_records=records,
               records_complete=records == profiled)
    return out


def say_round(label, B, fr):
    say(f"[{label}] a first SCP round at B={B}: {fr['round_ms']:.1f} ms on the host clock, "
        f"{fr['event_ms']:.1f} ms between CUDA events, {fr['graph_replays']} graph replays "
        f"and {fr['host_reads']} host reads, K1/K2 launches {fr['k1k2_launches']}; the graphs "
        f"ran {fr['graph_busy_ms']:.1f} ms of it (graph-busy share "
        f"{fr['graph_busy_share']:.4f})")
    if "kernel_records" in fr:
        say(f"[{label}] the round under torch.profiler ({fr['profiled_ms']:.1f} ms): "
            f"{fr['kernel_records']} kernel records, K1/K2 records {fr['k1k2_records']} against "
            f"the counters' launches {fr['k1k2_launches_profiled']} (complete: "
            f"{fr['records_complete']}), device kernels {fr['device_kernel_ms']:.1f} ms summed, "
            f"busy {fr['device_busy_ms']:.1f} ms (their union), busy share "
            f"{fr['device_busy_share']:.4f} of the profiled round, idle ms by gap "
            + json.dumps({k: round(v, 2) for k, v in fr["idle_ms_by_gap"].items()}))


def mc_row(system, B, T, chunks=1, stages=False, profile=False, extra=()):
    """A published guarantee row (`expe/published_rows.py`) through the
    Monte-Carlo driver's command line (`main_monte_carlo_validation.main`)
    on the card, float32, at B lanes (below 1024: lanes 0..B-1 of the
    published 1024-lane draw, so lane b is the published lane b) and T
    steps of the published 10-step draw. Times the seed and each step
    (`utils.stages`: "seed" and "step" only, which synchronize the card at
    their ends; with `stages` every stage: the seconds of each kind of
    graph replay) and reads the peak device memory, each step's host
    reads, graph replays (a loop's: its body runs) and K1/K2 launches
    (outside loops once a replay, in a loop's body once a body run) from
    the driver's `.graphs.json`; `profile`: and the first SCP round of the
    last step (`profile_round`). Returns (the artifact's path, the record),
    the record holding the comparison with the published artifact
    (`published_rows.compare`)."""
    from robust_nonlinear_mpc_torch.expe import main_monte_carlo_validation as mc
    from robust_nonlinear_mpc_torch.expe import published_rows as pr
    from robust_nonlinear_mpc_torch.sim import closed_loop as cl
    from robust_nonlinear_mpc_torch.utils.stages import timed

    mc.FOLDER = str(OUT_DIR / "monte_carlo_validation")
    lanes = [] if B >= pr.SCENARIOS else ["--lanes", ",".join(map(str, range(B)))]
    entry = {}
    until_converged = cl._scp_until_converged

    def keep_entry(solver, st, x, per_read=1, graphs=None):
        # the entry state of the latest step (a copy: on the card it lives in
        # the graphs' static buffers), profiled again after the run
        entry.update(solver=solver, st=tree_map(torch.clone, st), x=x.clone(), graphs=graphs)
        return until_converged(solver, st, x, per_read, graphs)

    if profile:
        cl._scp_until_converged = keep_entry
    bench.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with timed(None if stages else ("seed", "step")) as rec:
            path = mc.main(pr.argv(system, steps=T, chunks=chunks, extra=[*lanes, *extra]))
    finally:
        cl._scp_until_converged = until_converged
    wall = time.perf_counter() - t0
    launches = bench.launch_counts()
    r = np.load(path, allow_pickle=True)
    graphs = json.loads(Path(path).with_suffix(".graphs.json").read_text())
    keys = ("success_rate", "n_violation_steps_on_success", "n_violation_steps",
            "tube_containment_rate", "worst_tube_margin", "n_failed_inner",
            "n_failed_unconverged", "n_failed_scenarios", "mean_cost")
    res = {k: r[k].item() for k in keys}
    succ = r["success_mask"].astype(bool)
    # the lane-steps the violation count covers: solve t succeeded and solve
    # t - 1 (which predicted the tube around x_t) too, for t < T - 1
    covered = succ[:, :-1] & np.concatenate([np.ones((len(succ), 1), bool), succ[:, : T - 2]],
                                            axis=1)
    scp = r["scp_iters"]
    step_s = rec["step"]
    res.update(
        system=system, B=len(succ), T=T, chunks=chunks, seconds=wall, stages_timed=stages,
        seed_s=rec["seed"], step_s=step_s, launches=launches,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        violation_lane_steps_checked=int(covered.sum()),
        closed_loop_lane_steps_checked=int(covered[:, 1:].sum()),
        scp_iters_mean=float(scp.mean()), scp_iters_max=int(scp.max()),
        scp_lane_iterations=int(scp.sum()),
        captured=graphs["captured"], scp_per_dispatch=graphs["scp_per_dispatch"],
        seed_host_reads=graphs["seed_host_reads"], seed_graph_replays=graphs["seed_graph_replays"],
        host_reads_per_step=graphs["host_reads_per_step"],
        graph_replays_per_step=graphs["graph_replays_per_step"],
        graph_replays_by_piece=graphs["graph_replays_by_piece"],
        k1k2_launches_per_step=[[c.get("factor_predictor", 0), c.get("resolve", 0)]
                                for c in graphs["kernel_launches_per_step"]],
        comparison=pr.compare(path),
    )
    if stages:
        res.update(stages_s={k: sum(v) for k, v in rec.items()},
                   stage_calls={k: len(v) for k, v in rec.items()})
    if profile:
        res["first_round"] = profile_round(entry["solver"], entry["st"], entry["x"],
                                           entry["graphs"], profiler=B <= PROFILER_MAX_B)
    return path, res


def say_row(label, res):
    """Print a row's record (`mc_row`)."""
    keys = ("success_rate", "n_violation_steps_on_success", "n_violation_steps",
            "tube_containment_rate", "worst_tube_margin", "n_failed_inner",
            "n_failed_unconverged", "n_failed_scenarios", "mean_cost")
    say(f"[{label}] {res['system']} B={res['B']} T={res['T']} chunks={res['chunks']} f32 on the "
        f"card in {res['seconds']:.1f} s (seed {[round(v, 2) for v in res['seed_s']]} s, steps "
        f"{[round(v, 2) for v in res['step_s']]} s, "
        f"{'every stage' if res['stages_timed'] else 'seed and steps'} timed; peak device "
        f"memory {res['peak_memory_bytes'] / 2**30:.2f} GiB): "
        + json.dumps({k: res[k] for k in keys})
        + f", violation check over {res['violation_lane_steps_checked']} lane-steps "
        f"({res['closed_loop_lane_steps_checked']} at a closed-loop state), SCP iterations "
        f"mean {res['scp_iters_mean']:.2f} max {res['scp_iters_max']}")
    say(f"[{label}] CUDA graphs: {res['captured']}; per step host reads "
        f"{res['host_reads_per_step']}, graph replays {res['graph_replays_per_step']}, "
        f"K1/K2 launches {res['k1k2_launches_per_step']}; seed host reads "
        f"{res['seed_host_reads']}, replays {res['seed_graph_replays']} (scp_per_dispatch "
        f"{res['scp_per_dispatch']}); replays by piece {res['graph_replays_by_piece']}")
    if res["stages_timed"]:
        say(f"[{label}] stage s (calls): " + ", ".join(
            f"{k} {v:.2f} ({res['stage_calls'][k]})" for k, v in res["stages_s"].items()))
    c = res["comparison"]
    say(f"[{label}] against the published row, lane by lane: success flags differing "
        f"{c['success_flags_differing']} of {c['B'] * c['T']} (per step "
        f"{c['success_flags_differing_per_step']}; port only {c['success_port_only']}, "
        f"published only {c['success_published_only']}); on the {c['both_succeeded']} lane-steps "
        f"both solved: SCP iterations equal on {c['scp_iters_equal_on_both']} (mean |diff| "
        f"{c['scp_iters_mean_abs_diff_on_both']:.3f}), scp_failed differing "
        f"{c['scp_failed_differing_on_both']}; tube-miss lane-steps {c['tube_miss_lane_steps']} "
        f"(published {c['published_tube_miss_lane_steps']}, on both "
        f"{c['tube_miss_lane_steps_on_both']}); stored states where both solved every step "
        f"before: max |diff| {c['states_max_abs_diff']:.3e}, median "
        f"{c['states_median_abs_diff']:.3e} over {c['states_compared']}")
    for a in c["violations"] + c["tube_misses"]:
        say(f"[{label}] {a['kind']} lane {a['lane']} step {a['step']}: excess {a['excess']:.4g}, "
            f"SCP iterations {a['scp_iters']} (stall-damped {a['stall_damped']}); the published "
            f"lane: {json.dumps(a['published'])}")


def check_row(label, res, max_violations=0, containment=True):
    """Phase 9b's checks of a guarantee row: run as CUDA graphs, K1/K2 in
    every step's replays (every chunk's), at most `max_violations`
    violation steps on successful solves (each attributed), a violation
    check that covered a state the closed loop produced and, with
    `containment`, every successful step's tube containing the next state."""
    if not res["captured"]:
        fail(f"[{label}] the {res['system']} row did not run as CUDA graphs")
    if min(res["launches"]["factor_predictor"], res["launches"]["resolve"]) <= 0 or \
            min(min(k) for k in res["k1k2_launches_per_step"]) <= 0:
        fail(f"[{label}] the {res['system']} row did not launch K1/K2 in every step: "
             f"{res['launches']}, per step {res['k1k2_launches_per_step']}")
    n_viol = res["n_violation_steps_on_success"]
    if n_viol > max_violations or len(res["comparison"]["violations"]) != n_viol:
        fail(f"[{label}] {res['system']}: {n_viol} violation steps on successful solves "
             f"(at most {max_violations}; {len(res['comparison']['violations'])} attributed)")
    if res["closed_loop_lane_steps_checked"] <= 0:
        fail(f"[{label}] the violation check covered no state the closed loop produced")
    if containment and not res["tube_containment_rate"] == 1.0:
        fail(f"[{label}] {res['system']}: tube containment on successful solves "
             f"{res['tube_containment_rate']} < 1")


def guarantee_mode(B=GUARANTEE_B, T=3, stages=False, out="chip_smoke_guarantee.json"):
    """Phase 9b: the published full-mitigation converged Monte-Carlo
    validation of the rocket on the card (float32, N = 15), through the
    driver a user runs (`mc_row`), at B lanes with T cut from 10 to 3: the
    seed's loops and every piece of an SCP round as CUDA graphs, their loops
    WHILE nodes, with host reads of a device flag between them (the
    restoration's and, once every scp_per_dispatch = 2 rounds, whether
    every lane is decided). The violation count checks (x_t, u_t) for
    t < T - 1 and x_0 is the draw, so T = 3 is the least at which it checks
    a state the controller produced (x_1); the tube containment checks x_1
    and x_2. Fails unless `check_row` passes (no violation on success,
    containment 1). Reports the seconds, host reads, replays and launches
    of `mc_row`, the success flags against the published run's first 3
    steps and the last step's first SCP round (`profile_round`).
    Writes its record to chiprun_out/`out` and returns it."""
    _, res = mc_row("rocket", B, T, stages=stages, profile=True)
    say_row("9b", res)
    check_row("9b", res)
    say_round("9b", B, res["first_round"])
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out).write_text(json.dumps(res, indent=1))
    return res


def published_pair(B=PAIR_B, T=3, out="chip_smoke_9c.json"):
    """Phase 9c (after 9b, in its worker): the quadrotor's full-mitigation
    row and the pendulum's row (`--converged`) at B lanes, T cut from 10 to
    3 as 9b's, with 9b's checks: run as CUDA graphs with K1/K2 in every
    step, the pendulum without a violation on a successful solve and with
    containment 1, the quadrotor with at most 2 (the full row's published
    count), each attributed to its lane and step, the violation check over
    closed-loop states, and the success flags against the published
    artifact's first 3 steps."""
    record = {}
    for system, max_viol, contained in (("quadrotor", 2, False), ("pendulum", 0, True)):
        _, res = mc_row(system, B, T)
        say_row("9c", res)
        check_row("9c", res, max_violations=max_viol, containment=contained)
        record[system] = res
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out).write_text(json.dumps(record, indent=1))
    return record


def guarantee_scaling(batches, out="chip_smoke_scaling.json"):
    """`--guarantee-scaling`: the first two steps of the rocket's published
    row (the driver's least T) at each B in `batches` (lanes 0..B-1 of the
    published draw), with the seed's and the steps' seconds, the peak
    device memory, host reads and replays, and the last step's first SCP
    round (`profile_round`) at that B."""
    record = []
    for B in batches:
        _, res = mc_row("rocket", B, 2, profile=True)
        say_row("scaling", res)
        say_round("scaling", B, res["first_round"])
        record.append(res)
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / out).write_text(json.dumps(record, indent=1))
    return record


def published_rows(systems, chunks=1):
    """`--published-rows`: each system's published row at its full size
    (B = 1024, T = 10) through the driver's command line, held lane by lane
    against its artifact (`mc_row`, `published_rows.compare`); the lanes
    that `published_rows.settle_lanes` names re-run from the same draw in
    float64 on the card (`--dtype float64 --lanes`), which settles whether
    rounding explains them. Then the row's criteria: success within 0.02 of
    the published rate; the rocket and the pendulum without a violation on
    a successful solve, the pendulum with success and containment 1; every
    lane to settle settled by float64 (no violation on success and no tube
    miss there); run as CUDA graphs with K1/K2 in every step of every
    chunk. Writes chiprun_out/chip_smoke_published_<system>.json; fails
    after the last row if a criterion failed."""
    from robust_nonlinear_mpc_torch.expe import published_rows as pr

    failed = []
    for system in systems:
        row = pr.ROWS[system]
        _, res = mc_row(system, pr.SCENARIOS, pr.STEPS, chunks=chunks)
        say_row("rows", res)
        cmp = res["comparison"]
        settle = pr.settle_lanes(cmp)
        res["settle_lanes"] = settle
        if settle:
            # lane b of the float64 run is settle[b]
            _, f64 = mc_row(system, pr.SCENARIOS, pr.STEPS,
                            extra=["--lanes", ",".join(map(str, settle)), "--dtype", "float64"])
            c64 = f64["comparison"]
            kept = [lane for lane in settle
                    if not any(a["lane"] == lane for a in c64["violations"] + c64["tube_misses"])]
            res["float64"] = {"lanes": settle, "guarantee_kept": kept, "seconds": f64["seconds"],
                              "violations": c64["violations"], "tube_misses": c64["tube_misses"],
                              "success_rate": f64["success_rate"]}
            say(f"[rows] {system}: float64 re-run of lanes {settle} from the same draws in "
                f"{f64['seconds']:.1f} s: guarantee kept on {kept}; violations "
                f"{[(a['lane'], a['step'], round(a['excess'], 6)) for a in c64['violations']]}, "
                f"tube misses {[(a['lane'], a['step'], round(a['excess'], 6)) for a in c64['tube_misses']]}")
        criteria = {
            "success_within_0.02": abs(res["success_rate"] - row.success_rate) <= 0.02,
            "captured": bool(res["captured"]),
            "k1k2_every_step": min(min(k) for k in res["k1k2_launches_per_step"]) > 0,
            "settled_by_float64": not settle or res["float64"]["guarantee_kept"] == settle,
            "violations_attributed": len(cmp["violations"]) == res["n_violation_steps_on_success"],
        }
        if system != "quadrotor":
            criteria["no_violation_on_success"] = res["n_violation_steps_on_success"] == 0
        if system == "pendulum":
            criteria["success_1"] = res["success_rate"] == 1.0
            criteria["containment_1"] = res["tube_containment_rate"] == 1.0
        res["criteria"] = criteria
        say(f"[rows] {system}: published success {row.success_rate:.4f}, violations on success "
            f"{row.violations_on_success}, containment {row.containment:.4f}; criteria "
            + json.dumps(criteria))
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / f"chip_smoke_published_{system}.json").write_text(json.dumps(res, indent=1))
        failed += [f"{system}: {k}" for k, ok in criteria.items() if not ok]
    if failed:
        fail(f"[rows] criteria not met: {failed}")


COMPARE_N, COMPARE_T = 15, 4


def compare_run(device, kkt, out=None):
    """Phase 11a on one device: the comparison CLI's `generate` (N = 15, T =
    4, float64) with the robust solver's Newton solves by `kkt`. Returns
    each step's robust success and soft success and iterations (recorded by
    wrapping both solvers' `solve`), the applied inputs, both closed-loop
    costs and each controller's seconds a step (`utils.stages`, which
    synchronizes the card at each step's ends); writes it to
    chiprun_out/`out` when given."""
    from robust_nonlinear_mpc_torch.expe import main_rocket_compare_closed_loop as cmp
    from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver
    from robust_nonlinear_mpc_torch.solvers.soft_nlp import NLPSoftSolver
    from robust_nonlinear_mpc_torch.utils.stages import timed

    log = {"robust": [], "soft": []}
    robust_solve, soft_solve = SCPSLSSolver.solve, NLPSoftSolver.solve

    def robust(self, x0):
        sol = robust_solve(self, x0)
        log["robust"].append(bool(sol["success"]))
        return sol

    def soft(self, *a, **kw):
        sol = soft_solve(self, *a, **kw)
        log["soft"].append([bool(sol["success"]), int(sol["iters"])])
        return sol

    cmp.FOLDER = str(OUT_DIR / f"compare_{device}")
    SCPSLSSolver.solve, NLPSoftSolver.solve = robust, soft
    t0 = time.perf_counter()
    try:
        with timed(("compare.robust", "compare.soft")) as rec:
            path = cmp.generate(COMPARE_N, COMPARE_T, device=device, kkt=kkt)
    finally:
        SCPSLSSolver.solve, NLPSoftSolver.solve = robust_solve, soft_solve
    d = np.load(path)
    record = dict(log, device=device, kkt=kkt, seconds=time.perf_counter() - t0,
                  step_s={k: list(v) for k, v in rec.items()},
                  r_input=d["r_input_trajectory"].tolist(), s_input=d["s_input_trajectory"].tolist(),
                  Jr_total=float(d["Jr_total"]), Js_total=float(d["Js_total"]))
    if out is not None:
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / out).write_text(json.dumps(record, indent=1))
    return record


COMPARE_REFERENCE = "chip_smoke_compare_cpu.json"


def check_compare(reference):
    """Phase 11a: the robust-vs-soft comparison on the card (kkt="fused",
    K1/K2) against the CPU (kkt="riccati", the plain path), which
    `reference` (a worker started with the script) runs meanwhile:
    identical robust success and soft success and iterations at every
    step, the applied inputs and both closed-loop costs within 1e-8
    relative, K1 launched."""
    fused_qp.reset_launch_counts()
    card = compare_run("cuda", "fused")
    launches = fused_qp.launch_counts()
    join_worker(*reference, "11a")
    host = json.loads((OUT_DIR / COMPARE_REFERENCE).read_text())
    for key in ("robust", "soft"):
        if card[key] != host[key]:
            fail(f"[11a] {key} success/iterations differ: card {card[key]}, CPU {host[key]}")
    worst = 0.0
    for key in ("r_input", "s_input", "Jr_total", "Js_total"):
        a, b = np.asarray(card[key]), np.asarray(host[key])
        r = float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)
        worst = max(worst, r)
        if not r <= 1e-8:
            fail(f"[11a] {key} differs between the card and the CPU by {r:.3e} relative")
    if launches["factor_predictor"] <= 0:
        fail(f"[11a] the robust solver on the card did not launch K1: {launches}")
    per_step = lambda rec, k: [round(v, 3) for v in rec["step_s"][k]]
    say(f"[11a] comparison N={COMPARE_N} T={COMPARE_T} f64: robust success {card['robust']}, soft "
        f"(success, iterations) {card['soft']}, J robust {card['Jr_total']:.6e} soft "
        f"{card['Js_total']:.6e}, max relative difference card/CPU {worst:.3e}; s a step on the "
        f"card: robust {per_step(card, 'compare.robust')}, soft {per_step(card, 'compare.soft')} "
        f"({card['seconds']:.1f} s in all); on the CPU: robust {per_step(host, 'compare.robust')}, "
        f"soft {per_step(host, 'compare.soft')} ({host['seconds']:.1f} s, beside the card run's "
        f"phases); launches {launches}")
    return card


def frontend_problems(seed_wl):
    """Phase 11b's two QPs as NumPy data: the rocket LTV along lane 0 of the
    bench's SQP seed (the deviation QP of the reference's cost and box,
    linearized in float64 on the CPU, from a plant state 0.01 off the
    seed's x0) and the double integrator of tests/test_qp_frontend.py."""
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import make_rocket_problem

    host = lambda t: t.detach().cpu().double().numpy()
    X, U = host(seed_wl.carry[0][0]), host(seed_wl.carry[1][0])
    m, solver = make_rocket_problem(seed_wl.solver.N, device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    A, B, c = (host(v) for v in m.linearize_traj(t(X), t(U)))
    Q, R, Qf = host(solver.Q), host(solver.R), host(solver.Qf)
    G, g, Gf, gf = host(m.G), host(m.g), host(m.Gf), host(m.gf)
    N = U.shape[0]
    rocket = dict(
        kind="rocket", N=N, Q=Q, R=R, Qf=Qf, A=A, B=B, c=c,
        h=g[None] - np.concatenate([X[:N], U], axis=1) @ G.T, hf=gf - Gf @ X[N],
        qx=np.concatenate([2 * X[:N] @ Q.T, (2 * Qf @ X[N])[None]]), qu=2 * U @ R.T,
        x0=-0.01 * np.random.default_rng(11).standard_normal(m.nx),
    )
    integrator = dict(
        kind="lti", N=6, Q=np.eye(2), R=0.1 * np.eye(1), Qf=5 * np.eye(2),
        A=np.array([[1.0, 0.1], [0.0, 1.0]]), B=np.array([[0.005], [0.1]]), E=0.1 * np.eye(2),
        G=np.vstack([np.eye(3), -np.eye(3)]), g=np.array([4.0, 4.0, 2.0, 4.0, 4.0, 2.0]),
        Gf=np.vstack([np.eye(2), -np.eye(2)]), gf=np.array([4.0, 4.0, 4.0, 4.0]),
        x0=np.array([-3.0, -0.5]),
    )
    return [rocket, integrator]


def frontend_qp(p, device, backend, kkt="riccati"):
    """The front end's QP of problem `p` on `device`, with the front end's
    default IPM settings (30 iterations, tolerance 1e-9). At 1e-10 the
    torch IPM stops on the rocket QP at its complementarity floor (KKT
    residual 2e-9, duals up to 1e2) where the native one goes on to 1e-10,
    and their duals part by 3e-6."""
    from robust_nonlinear_mpc_torch.models.linear import LTI, LTV
    from robust_nonlinear_mpc_torch.models.rocket import Rocket
    from robust_nonlinear_mpc_torch.solvers.qp_frontend import QP

    ipm = IPMOptions(kkt=kkt)
    if p["kind"] == "lti":
        m = LTI(p["A"], p["B"], p["E"], G=p["G"], g=p["g"], Gf=p["Gf"], gf=p["gf"], device=device)
        return QP(p["N"], p["Q"], p["R"], m, p["Qf"], backend=backend, ipm=ipm)
    m = LTV(Rocket(device=device), p["N"])
    m.update_model(p["A"], p["B"], np.zeros((p["N"] + 1, m.nx, m.nw)), p["h"], p["hf"])
    qp = QP(p["N"], p["Q"], p["R"], m, p["Qf"], backend=backend, ipm=ipm)
    qp.offset_constraints(p["c"])
    qp.update_q_cost_lin(p["qx"], p["qu"])
    return qp


def check_frontend(seed_wl, devices=("cuda", "cpu")):
    """Phase 11b: the QP front end, `backend="torch"` with kkt="fused" on
    devices[0] against kkt="riccati" on devices[1] (identical success,
    X/U/duals within 1e-8 of each output's largest magnitude, at least 1),
    and against `backend="native"` (test_native_qp.py's tolerances: X/U
    1e-7, duals 1e-6, cost 1e-9 relative); K1/K2 launched; ms a solve of
    each backend."""
    for p in frontend_problems(seed_wl):
        fused_qp.reset_launch_counts()
        card = frontend_qp(p, devices[0], "torch", kkt="fused")
        got = card.solve(p["x0"])
        launches = fused_qp.launch_counts()
        host = frontend_qp(p, devices[1], "torch").solve(p["x0"])
        native = frontend_qp(p, "cpu", "native").solve(p["x0"])
        if not (got["success"] and host["success"] and native["success"]):
            fail(f"[11b] {p['kind']}: success card {got['success']}, CPU {host['success']}, "
                 f"native {native['success']}")
        worst = 0.0
        for k in ("primal_x", "primal_u", "dual_mu", "dual_mu_f"):
            d = float(np.abs(got[k] - host[k]).max(initial=0.0))
            worst = max(worst, d / max(1.0, float(np.abs(host[k]).max(initial=0.0))))
        if not worst <= 1e-8:
            fail(f"[11b] {p['kind']}: card and CPU differ by {worst:.3e}")
        dn = {k: float(np.abs(got[k] - native[k]).max(initial=0.0))
              for k in ("primal_x", "primal_u", "dual_mu", "dual_mu_f")}
        dcost = abs(got["cost"] - native["cost"]) / max(abs(native["cost"]), 1e-30)
        if not (dn["primal_x"] <= 1e-7 and dn["primal_u"] <= 1e-7 and dn["dual_mu"] <= 1e-6
                and dn["dual_mu_f"] <= 1e-6 and dcost <= 1e-9):
            fail(f"[11b] {p['kind']}: the native backend differs: {dn}, cost {dcost:.3e}")
        if devices[0] == "cuda" and min(launches["factor_predictor"], launches["resolve"]) <= 0:
            fail(f"[11b] {p['kind']}: the card's solve did not launch K1/K2: {launches}")
        ms = {}
        for name, qp in (("card fused", card), ("cpu riccati", frontend_qp(p, devices[1], "torch")),
                         ("native", frontend_qp(p, "cpu", "native"))):
            qp.solve(p["x0"])
            t0 = time.perf_counter()
            for _ in range(5):
                qp.solve(p["x0"])
            ms[name] = round(1e3 * (time.perf_counter() - t0) / 5, 3)
        say(f"[11b] front end {p['kind']} (N={p['N']}, nx={p['A'].shape[-1]}): card/CPU max "
            f"difference {worst:.3e}, native max |diff| {max(dn.values()):.3e} (cost "
            f"{dcost:.2e} relative), cost {got['cost']:.9e}, K1/K2 launches a solve "
            f"{launches['factor_predictor']}/{launches['resolve']}, ms a solve {ms}")


PAR_STEPS = 3
PAR_N = 60
PAR_HORIZONS = (30, 60, 120)
PAR_GLOO = "chip_smoke_12_gloo.npz"
PAR_ENTRY = "chip_smoke_12d.json"


def mc_rocket(B, dtype):
    """The MC driver's rocket (N = 15, RTI 1/1, kkt="fused") on the card and
    its draws from seed 0: (solver, x0s, Ws)."""
    from robust_nonlinear_mpc_torch.expe.main_monte_carlo_validation import (
        configure,
        draws,
        make_problem,
    )

    m, solver, x_center, x_spread = make_problem("rocket", "cuda", dtype)
    configure(solver, kkt="fused")
    x0s, Ws = draws(m, x_center, x_spread, B, PAR_STEPS, 0)
    return solver, x0s, Ws


def column_problem(N=PAR_N, Bsz=8):
    """`fast_sls_solve`'s inputs at the rocket's widths, N = 60, float64: the
    deviation problem along the plant's own trajectory from the hover point
    (the origin, + 0.02 randn, seed 1) under u = 0 (every lane's QPs are
    feasible there), built on the CPU so that every process has the same
    bits, then put on the card; and the solver, with the streaming response
    and the fused Newton kernels."""
    m, solver = make_rocket_problem(N, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(1)
    xs = [torch.as_tensor(0.02 * rng.standard_normal((Bsz, NX)))]
    U = torch.zeros((Bsz, N, NU), dtype=torch.float64)
    for k in range(N):
        xs.append(m.ddyn(xs[-1], U[:, k]))
    X = torch.stack(xs, dim=1)
    args = [t.cuda() for t in solver.assemble_deviation_problem(X, U, X[:, 0])]
    solver.to("cuda")
    solver.opts = solver.opts._replace(verbose=False, streaming_response=True,
                                       ipm=solver.opts.ipm._replace(kkt="fused"))
    return solver, args


def column_solve(solver, args, mesh):
    """One fast-SLS solve (RTI 1/1), column-sharded over `mesh` (None:
    unsharded): X, U, backoff, success, QP iterations."""
    from robust_nonlinear_mpc_torch.solvers.fast_sls import fast_sls_solve

    m, N, Bsz = solver.m, solver.N, args[0].shape[0]
    solver.opts = solver.opts._replace(column_mesh=mesh)
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=Bsz,
                                  dtype=torch.float64, device="cuda", store_phi=False)
    sol = fast_sls_solve(solver.prob, *args, persist, solver._fast_sls_opts())
    return {"X": sol.X, "U": sol.U, "backoff": sol.backoff, "success": sol.success,
            "qp_iters": sol.qp_iters}


def scaling_ms(mesh, reps=10):
    """ms of one sharded tube iteration (`tools/column_scaling.py`) at each
    of PAR_HORIZONS."""
    from robust_nonlinear_mpc_torch.tools.column_scaling import tube_iteration_ms

    return {N: tube_iteration_ms(N, mesh, reps) for N in PAR_HORIZONS}


def parallel_rank(rank, store):
    """Phase 12's gloo rank `rank` of 2, both on the one card: (b) the
    float64 rocket MC at B = 2 x 16, (c) the column-sharded fast-SLS solve
    at N = 60 and the tube iteration's ms. Rank 0 writes the results."""
    from robust_nonlinear_mpc_torch.parallel.distributed import init_distributed
    from robust_nonlinear_mpc_torch.parallel.mc import run_monte_carlo
    from robust_nonlinear_mpc_torch.parallel.mesh import scenario_mesh

    torch.set_num_threads(1)
    init_distributed(f"file://{store}", 2, rank, backend="gloo")
    mesh = scenario_mesh(device="cuda")
    fused_qp.reset_launch_counts()
    t0 = time.perf_counter()
    solver, x0s, Ws = mc_rocket(32, torch.float64)
    logs, stats = run_monte_carlo(solver, PAR_STEPS, x0s, Ws, mesh=mesh)
    t_mc = time.perf_counter() - t0
    launches = fused_qp.launch_counts()
    col = column_solve(*column_problem(), mesh)
    ms = scaling_ms(mesh)
    if rank == 0:
        out = {f"mc_{k}": v.cpu().numpy() for k, v in logs._asdict().items()}
        out.update({f"col_{k}": v.cpu().numpy() for k, v in col.items()})
        out["meta"] = json.dumps({"stats": list(stats), "mc_s": t_mc, "launches": launches,
                                  "tube_ms": ms})
        np.savez(OUT_DIR / PAR_GLOO, **out)
    torch.distributed.destroy_process_group()


def same_log(label, got, ref, rtol=None):
    """Two dicts of tensors (or arrays): flags and counts equal; the float
    fields bit for bit (rtol None) or within rtol relative to each field's
    max |value|, NaN where ref has NaN. Returns the largest relative
    difference."""
    worst = 0.0
    for f, b in ref.items():
        a, b = torch.as_tensor(got[f]).cpu(), b.cpu()
        if not b.is_floating_point():
            if not torch.equal(a, b):
                fail(f"[{label}] {f} differs on {int((a != b).sum())} entries")
            continue
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            fail(f"[{label}] {f}: the NaN pattern differs")
        scale = max(float(torch.nan_to_num(b).abs().max()), 1e-30)
        d = float(torch.nan_to_num(a - b).abs().max()) / scale
        worst = max(worst, d)
        if (rtol is None and d != 0.0) or (rtol is not None and d > rtol):
            fail(f"[{label}] {f} differs by {d:.3e} relative")
    return worst


def entry_phase():
    """Phase 12 (d), in a worker of its own: `entry()` on the card against
    the CPU (float64) and `dryrun_multichip(1)`, which starts its own
    one-rank NCCL world. Writes chiprun_out/`PAR_ENTRY`."""
    from robust_nonlinear_mpc_torch import entry as port_entry

    outs = {}
    for device in ("cuda", "cpu"):
        fn, a = port_entry.entry(device=device, dtype=torch.float64)
        t0 = time.perf_counter()
        outs[device] = (fn(*a), time.perf_counter() - t0)
    diffs = [rel_err(c.double().cpu(), h.double())[0]
             for c, h in zip(outs["cuda"][0], outs["cpu"][0])]
    if max(diffs) > 1e-9:
        fail(f"[12d] entry() on the card against the CPU: {diffs}")
    t0 = time.perf_counter()
    dry = port_entry.dryrun_multichip(1)
    t_dry = time.perf_counter() - t0
    say(f"[12d] entry() card ({outs['cuda'][1]:.2f} s) against CPU "
        f"({outs['cpu'][1]:.2f} s): max relative diff {max(diffs):.2e}; "
        f"dryrun_multichip(1) {t_dry:.1f} s: {dry}")
    (OUT_DIR / PAR_ENTRY).write_text(json.dumps({
        "entry_max_rel": max(diffs), "entry_card_s": outs["cuda"][1],
        "entry_cpu_s": outs["cpu"][1], "dryrun_s": t_dry, "dryrun": dry}))


def check_parallel(gloo, entry_worker):
    """Phase 12: the multi-device layer (`parallel/`) on the card. (a) and
    (c, W = 1) on a one-rank NCCL world in this process, (b) and (c, W = 2)
    read from the two gloo ranks started after phase 11, (d) the entry
    points from their own worker, started with them."""
    from robust_nonlinear_mpc_torch.parallel.distributed import init_distributed
    from robust_nonlinear_mpc_torch.parallel.mc import run_monte_carlo
    from robust_nonlinear_mpc_torch.parallel.mesh import scenario_mesh

    t_phase = time.perf_counter()
    init_distributed(backend="nccl")
    mesh = scenario_mesh()
    record = {}
    try:
        # (a) full width, float32, W = 1 over NCCL against the one-card run
        solver, x0s, Ws = mc_rocket(512, torch.float32)
        t0 = time.perf_counter()
        ref, ref_stats = run_monte_carlo(solver, PAR_STEPS, x0s, Ws)
        t_ref = time.perf_counter() - t0
        fused_qp.reset_launch_counts()
        t0 = time.perf_counter()
        got, stats = run_monte_carlo(solver, PAR_STEPS, x0s, Ws, mesh=mesh)
        t_got = time.perf_counter() - t0
        launches = fused_qp.launch_counts()
        if min(launches["factor_predictor"], launches["resolve"]) <= 0:
            fail(f"[12a] the sharded MC did not launch K1/K2: {launches}")
        same_log("12a", got._asdict(), ref._asdict())
        if tuple(stats) != tuple(ref_stats):
            fail(f"[12a] statistics {stats} != {ref_stats}")
        say(f"[12a] sharded rocket MC N=15 B=512 f32 T={PAR_STEPS}, 1 NCCL rank: bit for bit "
            f"the one-card run ({t_got:.1f} s, one card {t_ref:.1f} s), success "
            f"{float(got.success.float().mean()):.4f}, {stats}, launches {launches}")
        record["12a"] = {"s": t_got, "one_card_s": t_ref, "stats": list(stats),
                         "launches": launches}

        # (b) float64, B = 2 x 16: the two gloo ranks against one rank
        solver, x0s, Ws = mc_rocket(32, torch.float64)
        t0 = time.perf_counter()
        one, one_stats = run_monte_carlo(solver, PAR_STEPS, x0s, Ws, mesh=mesh)
        t_one = time.perf_counter() - t0
        join_worker(*gloo[0], "12")
        join_worker(*gloo[1], "12")
        two = dict(np.load(OUT_DIR / PAR_GLOO))
        meta = json.loads(str(two["meta"]))
        worst = same_log("12b", {k: two[f"mc_{k}"] for k in one._fields}, one._asdict(),
                         rtol=1e-9)
        counts = lambda st: (st[0], st[1], st[4])   # scenarios, violations, failed lanes
        if counts(meta["stats"]) != counts(one_stats):
            fail(f"[12b] counts {meta['stats']} != {one_stats}")
        if min(meta["launches"]["factor_predictor"], meta["launches"]["resolve"]) <= 0:
            fail(f"[12b] the gloo ranks did not launch K1/K2: {meta['launches']}")
        say(f"[12b] rocket MC B=2x16 f64 T={PAR_STEPS}: 2 gloo ranks on one card "
            f"({meta['mc_s']:.1f} s, contended) against 1 rank ({t_one:.1f} s): flags and "
            f"counts equal, max relative diff {worst:.2e}, success "
            f"{float(one.success.float().mean()):.4f}")
        record["12b"] = {"two_rank_s": meta["mc_s"], "one_rank_s": t_one, "max_rel": worst,
                         "launches_rank0": meta["launches"]}

        # (c) column-sharded fast-SLS at N = 60, and the tube iteration's ms
        solver, args = column_problem()
        dense = column_solve(solver, args, None)
        fused_qp.reset_launch_counts()
        one_col = column_solve(solver, args, mesh)
        col_launches = fused_qp.launch_counts()
        worst_c = {"W=1": same_log("12c W=1", one_col, dense, rtol=1e-9),
                   "W=2": same_log("12c W=2", {k: two[f"col_{k}"] for k in dense}, dense,
                                   rtol=1e-9)}
        ms1, ms2 = scaling_ms(mesh), {int(k): v for k, v in meta["tube_ms"].items()}
        say(f"[12c] column-sharded fast_sls_solve rocket N={PAR_N} B=8 f64 kkt=fused against "
            f"the unsharded solve: max relative diff {worst_c}, success "
            f"{dense['success'].tolist()}, QP iterations {dense['qp_iters'].tolist()}, "
            f"launches {col_launches}; sharded tube iteration ms (N: 1 NCCL rank / 2 gloo "
            f"ranks) " + ", ".join(f"{N}: {ms1[N]:.2f} / {ms2[N]:.2f}" for N in PAR_HORIZONS))
        record["12c"] = {"max_rel": worst_c, "tube_ms_1rank": ms1, "tube_ms_2rank_gloo": ms2,
                         "launches": col_launches}

        # (d) the entry points, from their worker
        join_worker(*entry_worker, "12d")
        record["12d"] = json.loads((OUT_DIR / PAR_ENTRY).read_text())
    finally:
        torch.distributed.destroy_process_group()
    record["phase_s"] = time.perf_counter() - t_phase
    (OUT_DIR / "chip_smoke_parallel.json").write_text(json.dumps(record, indent=1))
    say(f"[12] phase 12 took {record['phase_s']:.1f} s")


def start_worker(log_name, *flags):
    """This script in a second process with `flags`; its output goes to
    chiprun_out/`log_name`."""
    import subprocess

    OUT_DIR.mkdir(exist_ok=True)
    log = open(OUT_DIR / log_name, "w")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), *flags],
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def join_worker(proc, log, label, timeout=900, also=()):
    """Wait for a worker, echo its lines (those of its phase `label` and of
    the phases in `also`), fail if it failed."""
    import subprocess

    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    log.close()
    for line in Path(log.name).read_text().splitlines():
        if line.startswith((f"[{label}]", "[mc]", "chip_smoke FAILED", "Traceback")
                           + tuple(f"[{p}]" for p in also)) or "Error" in line:
            print(line, flush=True)
    if rc != 0:
        fail(f"phase {label}'s worker ended with {rc} (see {log.name})")


def main(argv=None):
    ap = argparse.ArgumentParser(description="smoke test of the port on one GPU")
    ap.add_argument("--phases", default="all",
                    help="comma-separated subset of 3-13 to run after phases 1-2 (default: all)")
    ap.add_argument("--guarantee-alone", choices=["steps", "stages"],
                    help="run only phase 9b, alone on the card after the build, with the "
                         "seed and the steps timed or every stage timed; no result lines")
    ap.add_argument("--published-rows", default=None,
                    help="comma-separated systems (rocket, quadrotor, pendulum): run their "
                         "published guarantee rows at B = 1024, T = 10 after the build, held "
                         "lane by lane against the artifacts; no result lines")
    ap.add_argument("--chunks", type=int, default=1,
                    help="--published-rows: the driver's --chunks")
    ap.add_argument("--guarantee-scaling", default=None,
                    help="comma-separated B: one step of the rocket's published row at each "
                         "B after the build; no result lines")
    ap.add_argument("--long-horizon", default=None,
                    help="comma-separated N (30,60): the bench twin's record at each N, B = "
                         "512, kkt fused and riccati in alternating pairs from one seed, after "
                         "the build; no result lines")
    ap.add_argument("--guarantee-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--long-check", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--compare-reference", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-store", help=argparse.SUPPRESS)
    ap.add_argument("--entry-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    if args.guarantee_worker:
        # the seed's first capture needs the library (its WHILE nodes): wait
        # for the main process's build before the timed run
        cuda_lib.build_extension()
        guarantee_mode(stages=True)
        published_pair()
        if args.long_check:
            # phase 14 after 9c, in this worker: the main process is still in
            # its untimed phases then
            long_horizon_phase()
        return 0
    if args.parallel_rank is not None or args.entry_worker:
        # phase 12's workers run at a lower priority: phase 9b's host-bound
        # worker, which sets the script's length, keeps the cores first
        os.nice(10)
    if args.parallel_rank is not None:
        # one of phase 12's two gloo ranks
        parallel_rank(args.parallel_rank, args.parallel_store)
        return 0
    if args.entry_worker:
        # beside the main process and the other workers: two cores
        torch.set_num_threads(2)
        entry_phase()
        return 0
    if args.compare_reference:
        # phase 11a's CPU run, beside the main process
        torch.set_num_threads(2)
        compare_run("cpu", "riccati", out=COMPARE_REFERENCE)
        return 0
    if args.guarantee_alone or args.published_rows or args.guarantee_scaling or args.long_horizon:
        say(f"[1] device {torch.cuda.get_device_name(0)}, nvidia-smi: {bench.gpu_identity()[2]}")
        t0 = time.perf_counter()
        cuda_lib.build_extension()
        say(f"[2] built the kernels in {time.perf_counter() - t0:.1f} s")
        if args.guarantee_scaling:
            guarantee_scaling([int(b) for b in args.guarantee_scaling.split(",")])
        if args.guarantee_alone:
            guarantee_mode(stages=args.guarantee_alone == "stages",
                           out=f"chip_smoke_guarantee_alone_{args.guarantee_alone}.json")
        if args.published_rows:
            published_rows(args.published_rows.split(","), chunks=args.chunks)
        if args.long_horizon:
            long_horizon_runs([int(n) for n in args.long_horizon.split(",")])
        return 0
    run = set(ALL_PHASES) if args.phases == "all" else {int(p) for p in args.phases.split(",")}
    name, limit_w, smi_line = bench.gpu_identity()
    kind = torch.cuda.get_device_name(0)
    say(f"[1] device {kind} (count {torch.cuda.device_count()}), nvidia-smi: {smi_line}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    bench.require_cuda()

    # the CPU-only runs start first, in processes of their own (phase 9b's
    # seed needs no kernel; phase 11a's reference needs no card)
    workers = {}
    if 9 in run:
        # phase 14 runs in this worker after 9c when both are asked for
        workers["9b"] = start_worker("chip_smoke_9b.log", "--guarantee-worker",
                                     *(["--long-check"] if 14 in run else []))
    if 11 in run:
        workers["11a"] = start_worker("chip_smoke_11a_cpu.log", "--compare-reference")
    try:
        t0 = time.perf_counter()
        cuda_lib.build_extension(verbose=True)
        say(f"[2] built {', '.join(s.name for s in cuda_lib.SOURCES)} for sm_90a "
            f"in {time.perf_counter() - t0:.1f} s")
        OUT_DIR.mkdir(exist_ok=True)
        (OUT_DIR / "chip_smoke_while.json").write_text(json.dumps(check_device_while(), indent=1))
        # untimed phases, beside the workers; the CPU references leave them two cores
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads - 2))
        if 4 in run:
            check_solve_qp()
            check_fused_iter()
        if run & {5, 6, 7, 8, 10, 11, 13}:
            wls = bench_workloads()
        if 5 in run:
            check_closed_loop(wls["6"])
        if 10 in run:
            check_capture(wls)
        if 11 in run:
            check_compare(workers["11a"])
            check_frontend(wls["6"])
        if 12 in run:
            # phase 12's two gloo ranks share the card and its entry worker
            # runs beside them; they start once phase 11a's CPU worker has
            # ended, so phase 9b's seed runs beside one worker at a time
            store = OUT_DIR / "chip_smoke_12_store"
            store.unlink(missing_ok=True)
            gloo = [start_worker(f"chip_smoke_12_rank{r}.log", "--parallel-rank", str(r),
                                 "--parallel-store", str(store.resolve())) for r in (0, 1)]
            workers.update({f"12r{r}": w for r, w in enumerate(gloo)})
            workers["12d"] = start_worker("chip_smoke_12d.log", "--entry-worker")
            check_parallel(gloo, workers["12d"])
        if 9 in run:
            check_converged()
            join_worker(*workers["9b"], "9b", also=("14",))
        torch.set_num_threads(threads)
        # timed phases, alone on the card
        if 3 in run:
            report_occupancy()
            main_err = check_kernels()
            times = time_kernels()
        if run & {6, 7, 8}:
            launches = bench_phases(wls)
        if 13 in run:
            precision_phase(wls["6"])
        if 14 in run:
            long_launches = (json.loads((OUT_DIR / "chip_smoke_14.json").read_text())
                             if 9 in run else long_horizon_phase())["launches"]
    finally:
        for proc, _ in workers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if run != set(ALL_PHASES):
        say(f"partial run (phases 1, 2 and {sorted(run)}): no result lines")
        return 0

    kernels = []
    launches |= long_launches
    # the run each count is from: a step launches K1/K2 as often as its
    # slowest lane needs, so the cut run's 16 lanes count fewer than 512
    # would (PERF.md, the K5a-c rows)
    launches_from = {k: f"the timed window of phase {p}'s first bench run: B = 512, N = 15, "
                        f"10 steps" for p, ks in PATH_KERNELS.items() for k in ks}
    launches_from |= {f"{k}_n60": (f"the timed window of phase 14's cut bench run: B = "
                                   f"{LONG_SMOKE['B']}, N = {LONG_N}, {LONG_SMOKE['n_rep']} steps")
                      for k in NEWTON}
    for k in ("factor_predictor", "resolve", "ipm_iteration", "fused_response", "backward_K",
              "factor_predictor_n60", "resolve_n60"):
        bound_ms, bound_by = (kernel_bound(k[:-4], N=LONG_N) if k.endswith("_n60")
                              else kernel_bound(k))
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": launches[k], "max_abs_err": main_err[k], "ms": times[k][0],
            "plain_ms": times[k][1], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "launches_from": launches_from[k],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints a line; any failed check raises and exits non-zero
before the result lines):
  1. the device and its nvidia-smi name and power limit;
  2. build every kernel (csrc/fused_qp.cu, fused_ipm.cu, fused_response.cu,
     fused_backward.cu) with nvcc for sm_90a;
  3. each kernel's registers per thread, shared bytes per block, resident
     blocks per SM and waves at B = 512 (from the CUDA runtime); each kernel
     against its plain torch version on the card, relative to each output's
     max |value|: the Newton kernels K1/K2 float64 to 1e-10 and float32 to
     1e-4 at (B, N) in {(512, 15), (37, 15), (8, 60)} with nx = 17, nu = 4,
     nu in {1, 2} at B = 8, a batch of 529 (the last wave part-filled) and
     the other widths: the pendulum's and the quadrotor's (4, 1), (13, 4)
     and the general path at (7, 3), (32, 2); the whole-iteration kernel K6 at the same (B, N) with ni = 42,
     ni_f = 34 (a lane marked done and a lane whose step is not finite
     included) and at the same batch of 529 and widths; the response
     kernel K4, float32 to 1e-4, and the SLS backward kernel K3 (ni =
     2 (nx + nu), ni_f = 2 nx) at the same (B, N), batch of 529 and widths
     (K3 also at nu in {1, 2}); per-call times
     of every kernel and its plain version at (512, 15) float32, beside the
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
  9. guarantee mode, the until-convergence closed loop: (a) the rocket at
     N = 6, B = 8, float64, 2 steps, until the SCP criterion 1e-3 (at most
     40 SCP iterations), with feasibility restoration, stall damping 0.5
     after 5 SCP iterations and the soft fallback, kkt="fused"
     on the card (K1/K2) against the CPU (plain versions): identical
     success, SCP iterations, scp_failed and QP iterations on every lane,
     X/U and the finite backoffs within 1e-8, for build_batched_closed_loop
     and for build_chunked_converged_loop at scp_per_dispatch 1 and 5;
     (b) the full-mitigation Monte-Carlo validation of the rocket
     (main_monte_carlo_validation --converged --soft-fallback --restoration
     --max-iter-scp 40 --qp-tol 1e-5 --stall-damping 0.5 --kkt fused),
     float32, N = 15, B = 128 lanes from seed 0, T = 3 steps (the published
     run has T = 10; 3 is the least at which the violation count checks a
     state the controller produced): the guarantee
     n_violation_steps_on_success == 0 over a check that covers closed-loop
     states, tube containment 1 on successful solves, K1/K2 launched,
     seconds of the seed, of each step and of every stage (each
     synchronized at its ends), the success flags against the published
     run's first 3 steps, and the device busy share of the last step's
     first SCP round (profiler). Phase 9b runs in a second process, started
     first (its seed needs no kernel), while this one builds and runs the
     untimed phases 4, 5 and 9a, so its seconds are contended; phases 3 and
     6-8, which time, run after it, alone on the card.
     `--guarantee-alone steps|stages` runs phase 9b alone (after the build),
     with the seed and steps timed or every stage timed;
 10. the RTI step captured as one CUDA graph against the eager step on the
     card (run after phase 5, among the untimed phases): (a) B = 512,
     N = 15, float32, 3 steps from the bench seed in the default, the
     fused-kernel and the K3 configuration, each with its kernels in the
     graph; (b) the default configuration at B = 529; (c) float64, N = 6,
     B = 8, the captured step on the card against the eager step on the
     CPU, phase 5's criteria; (d) the captured K = 8 program against 8
     replays of the one-step graph; (e) build_batched_closed_loop in RTI
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
Every launch counter is zeroed just before each bench run and before phase
9b (in its own process), and read just after. A wrapper counts a launch
recorded into a CUDA graph once, at capture; a replay launches without it,
so the bench record counts one replay's launches times the replays, and
the kernels record's `launches` are the first run of each path's timed
window, counted so. The last lines are the kernels record, the nvidia-smi
line and {"ok": true, "device": {...}}. `--phases 9` (or `--phases 11`, `12`)
runs a subset (phases 1 and 2 always run) and then prints neither result
line; so does `--guarantee-alone`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
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
from robust_nonlinear_mpc_torch.utils.hardware import PEAK_BYTES, PEAK_FLOPS

OUT_DIR = Path("chiprun_out")
TPU_SOURCE = "robust_nonlinear_mpc_tpu/ops/pallas_qp.py"
REPLACES = {
    "factor_predictor": f"{TPU_SOURCE}:161",
    "resolve": f"{TPU_SOURCE}:293",
    "ipm_iteration": f"{TPU_SOURCE}:1234",
    "fused_response": "robust_nonlinear_mpc_tpu/ops/pallas_response.py:40",
    "backward_K": "robust_nonlinear_mpc_tpu/ops/pallas_sls.py:138",
}
SOURCES = {
    "factor_predictor": "robust_nonlinear_mpc_torch/csrc/fused_qp.cu",
    "resolve": "robust_nonlinear_mpc_torch/csrc/fused_qp.cu",
    "ipm_iteration": "robust_nonlinear_mpc_torch/csrc/fused_ipm.cu",
    "fused_response": "robust_nonlinear_mpc_torch/csrc/fused_response.cu",
    "backward_K": "robust_nonlinear_mpc_torch/csrc/fused_backward.cu",
}
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}
# the B = 1 latency loop of each bench run here (the bench twin alone runs
# the reference's 200 steps): cut to keep the script inside its time limit
LATENCY_STEPS = 50
ALL_PHASES = range(3, 13)


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
             for dtype in (torch.float64, torch.float32) for B, N, nu in KERNEL_CASES]
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
    for (kname, dtype), r in worst.items():
        say(f"[3] {kname} {dtype}: worst rel err {r:.3e} (tol {TOL[dtype]:g})")
    return main_err


def report_occupancy(Bsz=512, N=15):
    """Phase 3: what each kernel costs the SM at the main path's widths, from
    the CUDA runtime: registers per thread, shared bytes per block (static +
    dynamic), spill bytes, resident blocks per SM and the waves of a grid at
    B = 512. Returns {(kernel, dtype name): info}."""
    rows = {}
    for name, suffixes in cuda_lib.INFO_KERNELS.items():
        for sfx in suffixes:
            dtype = torch.float32 if sfx == "f32" else torch.float64
            info = cuda_lib.kernel_info(name, dtype, Bsz, N, NX, NU, NI, NI_F)
            rows[(name, sfx)] = info
            say(f"[3] occupancy {name} {sfx} at B={Bsz} N={N}: {info['registers']} registers, "
                f"{info['static_smem'] + info['dynamic_smem']} shared bytes "
                f"({info['dynamic_smem']} dynamic), {info['local_bytes']} local (stack) bytes, "
                f"{info['blocks_per_sm']} blocks/SM on {info['sms']} SMs, {info['waves']} wave(s)")
    return rows


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
    """Per-call times at the main path's shape (B=512, N=15, f32), in the
    order plain, kernel, kernel, plain: the kernel's device time (profiler),
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
    t = {}
    for k, (kern, plain) in pairs.items():
        p1 = bench.cuda_ms(plain, 5)
        (k1, seen1), (k2, seen2) = kernel_ms(kern, k, 30), kernel_ms(kern, k, 30)
        w = bench.cuda_ms(kern, 30)
        p2 = bench.cuda_ms(plain, 5)
        t[k] = (min(k1, k2), min(p1, p2))
        extra = f", torch blocked(2) {bench.cuda_ms(blocked, 5):.4f} ms" if k == "backward_K" else ""
        say(f"[3] {k} at B=512 N=15 f32: kernel {t[k][0]:.4f} ms (wrapper {w:.4f} ms), "
            f"plain {t[k][1]:.4f} ms{extra}, bound " + "{:.4f} ms ({})".format(*kernel_bound(k))
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
    from the same carry and disturbances; the kernels of the configuration
    must be in the graph. Frees the graph's pool after."""
    eager, c = [], carry
    for i in range(steps):
        c, out = wl.mpc_step(c, w_seq[i])
        eager.append(out)
    t0 = time.perf_counter()
    step = capture_mpc_step(wl.solver, carry)
    t_capture = time.perf_counter() - t0
    worst, c = 0.0, carry
    for i in range(steps):
        c, out = step(c, w_seq[i])
        worst = max(worst, compare_outs(f"{label} step {i}", out, eager[i]))
    torch.cuda.synchronize()
    graph_kernels = {k: v for k, v in step.launches.items() if v}
    say(f"[{label}] B={carry[3].shape[0]} kkt={wl.solver.opts.ipm.kkt} response={wl.response} "
        f"sls_block={wl.sls_block}: {steps} captured steps equal the eager steps "
        f"({'bit for bit' if worst == 0.0 else f'max relative {worst:.3e}'}); success "
        f"{float(out[6].float().mean()):.4f}, mean QP iterations "
        f"{[round(float(o[7].float().mean()), 3) for o in eager]}; warm-up and capture "
        f"{t_capture:.1f} s; kernels per replay {graph_kernels}")
    del step
    torch.cuda.empty_cache()
    return graph_kernels


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
    path_kernels = {"6": ("factor_predictor", "resolve"), "7": ("ipm_iteration", "fused_response"),
                    "8": ("backward_K",)}
    for label, kernels in path_kernels.items():
        wl = wls[label]
        in_graph = captured_vs_eager(f"10a {label}", wl, wl.carry, wl.w_seq)
        if not all(k in in_graph for k in kernels):
            fail(f"[10a {label}] the captured step holds no launch of {kernels}: {in_graph}")
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
    say(f"[10d] the captured K = {K} program equals {K} replays of the one-step graph "
        f"(outs and carry), kernels per replay {prog.launches}")
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


def run_bench(label, wl):
    """One bench twin run (warm-in, timed window, B = 1 latency loop) of a
    built workload, its launch counts zeroed just before and read just
    after."""
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    record, carry = bench.run(wl, n_lat=LATENCY_STEPS)
    launches = bench.launch_counts()
    say(f"[{label}] bench twin kkt={record['kkt']} response={record['response']} "
        f"sls_block={record['sls_block']} on the captured step "
        f"ran in {time.perf_counter() - t0:.1f} s: {record['value']} solves/s, "
        f"on_device_step_ms {record['on_device_step_ms']} (K walls "
        f"{record['on_device_fit_points_ms']}), latency p50 "
        f"{record['single_step_latency_ms']} ms, wrapper counts (warm-ups, captures, the "
        f"eager check) {launches}, per replay {record['kernel_launches_per_step']}")
    print(json.dumps(record), flush=True)
    if record["success_fraction"] != 1.0 or not record["finite"]:
        fail(f"bench twin [{label}]: success_fraction must be 1.0 and the state finite")
    check = record["eager_check"]
    if not (check["success_equal"] and check["qp_iters_equal"]):
        fail(f"bench twin [{label}]: the captured step and the eager step differ: {check}")
    if record["on_device_step_ms"] is None:
        fail(f"bench twin [{label}]: on_device_step_ms is not positive: "
             f"{record['on_device_fit_points_ms']}")
    return record, carry, launches


def breakdown(label, wl, carry):
    """Stage breakdown of the eager step, and the device busy share of the
    eager and of the captured step, of one configuration."""
    stages = bench.stage_breakdown(wl, carry, wl.w_seq[0])
    say(f"[{label}] stage ms (eager) {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    out = {"stages": stages}
    for name, captured in (("profile", False), ("profile_captured", True)):
        prof = bench.profile_kernels(wl, carry, wl.w_seq, captured=captured)
        say(f"[{label}] profiler, {'captured' if captured else 'eager'} step: {prof['steps']} "
            f"steps, wall (unprofiled) {prof['wall_ms']:.2f} ms, device kernels "
            f"{prof['device_kernel_ms']:.2f} ms, busy share {prof['device_busy_share']}, "
            f"{sum(r['count'] for r in prof['top_kernels'])} kernel records in the top rows")
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
    path_kernels = {"6": ("factor_predictor", "resolve"), "7": ("ipm_iteration", "fused_response"),
                    "8": ("backward_K",)}
    launches, profile = {}, {label: {"records": []} for label in wls}
    for label in ("6", "7", "7", "6", "8"):
        record, carry, counts = run_bench(label, wls[label])
        kernels = path_kernels[label]
        if min(counts[k] for k in kernels) <= 0:
            fail(f"the bench path [{label}] did not launch {kernels}: {counts}")
        if min(record["kernel_launches"][k] for k in kernels) <= 0:
            fail(f"the bench path [{label}] did not launch {kernels} in the timed steps")
        profile[label]["records"].append(record)
        if "stages" not in profile[label]:
            # the timed window's launches: one replay's times the replays
            launches.update({k: record["kernel_launches"][k] for k in kernels})
            profile[label].update(breakdown(label, wls[label], carry))
        torch.cuda.empty_cache()
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.json").write_text(json.dumps(profile, indent=1))
    return launches


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
    devices[0] (the kernels) against devices[1] (the plain versions), from
    the same draws (x0 spread 0.05 around X0, w in [-1, 1]). `ref_lanes`:
    the reference runs only the first lanes (each lane's result does not
    depend on the others in its batch)."""
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
    got = build_batched_closed_loop(solvers[card], steps)(x0s, Ws)
    t_card = time.perf_counter() - t0
    launches = fused_qp.launch_counts()
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
        f"{worst:.2e}, launches {launches}")
    for kpd in chunked:
        t0 = time.perf_counter()
        ch = build_chunked_converged_loop(solvers[card], steps, scp_per_dispatch=kpd)(x0s, Ws)
        worst = compare_logs(f"9a chunked {kpd}", lanes(ch), ref)
        say(f"[9a] chunked scp_per_dispatch={kpd} on {card} ({time.perf_counter() - t0:.1f} s) "
            f"against the {host} batched loop: max |diff| {worst:.2e}")


GUARANTEE_FLAGS = dict(converged=True, soft_fallback=True, restoration=True, max_iter_scp=40,
                       qp_tol=1e-5, stall_damping=0.5, kkt="fused")
PUBLISHED_RUN = Path("artifacts/mc_validation_rocket_converged_tpu_f32_128_fullmit_r5.npz")


def profile_round(solver, st, x):
    """One SCP iteration of every lane (`solver._iteration`) from a step's
    entry state `st` (a `sim.closed_loop._ConvState`) at plant state x, as
    the step's first SCP round runs it, on the host clock and again under the
    profiler (CUDA activity only): its ms, the device kernel ms and their
    ratio, the device busy share of a full-batch round."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one_round():
        solver._iteration(st.X, st.U, x, st.persist)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_round()
    round_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        one_round()
    device_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type == DeviceType.CUDA) / 1e3
    return {"round_ms": round_ms, "device_kernel_ms": device_ms,
            "device_busy_share": device_ms / round_ms}


def guarantee_mode(B=128, T=3, stages=False, out="chip_smoke_guarantee.json"):
    """Phase 9b: the published full-mitigation converged Monte-Carlo
    validation of the rocket on the card (float32, N = 15), through the
    driver a user runs, with T cut from 10 to 3. The violation count checks
    (x_t, u_t) for t < T - 1 and x_0 is the draw, so T = 3 is the least at
    which it checks a state the controller produced (x_1); the tube
    containment checks x_1 and x_2. Fails unless K1/K2 launched, no
    successful step violates a constraint, the count covered a closed-loop
    state, and every successful step's tube contains the next state. Times
    the seed and each step (`utils.stages`: "seed" and "step" only, which
    synchronize the card once at each end; with `stages` every stage, each
    synchronized at its ends), and the busy share of the last step's first
    SCP round. Writes its record to chiprun_out/`out` and returns it."""
    from robust_nonlinear_mpc_torch.expe import main_monte_carlo_validation as mc
    from robust_nonlinear_mpc_torch.sim import closed_loop as cl
    from robust_nonlinear_mpc_torch.utils.stages import timed

    mc.FOLDER = str(OUT_DIR / "monte_carlo_validation")
    entry = {}
    until_converged = cl._scp_until_converged

    def keep_entry(solver, st, x):
        # the entry state of the latest step, profiled again after the run
        entry.update(solver=solver, st=st, x=x)
        return until_converged(solver, st, x)

    cl._scp_until_converged = keep_entry
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with timed(None if stages else ("seed", "step")) as rec:
            path = mc.generate("rocket", scenarios=B, steps=T, device="cuda", seed=0,
                               **GUARANTEE_FLAGS)
    finally:
        cl._scp_until_converged = until_converged
    wall = time.perf_counter() - t0
    launches = bench.launch_counts()
    r = np.load(path, allow_pickle=True)
    keys = ("success_rate", "n_violation_steps_on_success", "n_violation_steps",
            "tube_containment_rate", "worst_tube_margin", "n_failed_inner",
            "n_failed_unconverged", "n_failed_scenarios", "mean_cost")
    res = {k: r[k].item() for k in keys}
    succ = r["success_mask"].astype(bool)
    # the lane-steps the violation count covers: solve t succeeded and solve
    # t - 1 (which predicted the tube around x_t) too, for t < T - 1
    covered = succ[:, :-1] & np.concatenate([np.ones((B, 1), bool), succ[:, : T - 2]], axis=1)
    scp = r["scp_iters"]
    step_s = rec["step"]
    res.update(
        B=B, T=T, seconds=wall, stages_timed=stages, seed_s=sum(rec["seed"]), step_s=step_s,
        s_per_step=float(np.mean(step_s)), launches=launches,
        violation_lane_steps_checked=int(covered.sum()),
        closed_loop_lane_steps_checked=int(covered[:, 1:].sum()),
        scp_iters_mean=float(scp.mean()), scp_iters_max=int(scp.max()),
        scp_lane_iterations=int(scp.sum()),
    )
    if stages:
        res.update(stages_s={k: sum(v) for k, v in rec.items()},
                   stage_calls={k: len(v) for k, v in rec.items()})
    say(f"[9b] rocket full mitigation B={B} T={T} f32 on the card in {wall:.1f} s "
        f"(seed {res['seed_s']:.1f} s, steps {[round(v, 2) for v in step_s]} s, "
        f"{'every stage' if stages else 'seed and steps'} timed): "
        + json.dumps({k: res[k] for k in keys})
        + f", violation check over {res['violation_lane_steps_checked']} lane-steps "
        f"({res['closed_loop_lane_steps_checked']} at a closed-loop state), SCP iterations "
        f"mean {res['scp_iters_mean']:.2f} max {res['scp_iters_max']}, launches {launches}")
    if stages:
        say("[9b] stage s (calls): " + ", ".join(
            f"{k} {v:.2f} ({res['stage_calls'][k]})" for k, v in res["stages_s"].items()))
    if min(launches["factor_predictor"], launches["resolve"]) <= 0:
        fail(f"[9b] the guarantee run did not launch K1/K2: {launches}")
    if res["n_violation_steps_on_success"] != 0:
        fail(f"[9b] {res['n_violation_steps_on_success']} violation steps on successful solves")
    if res["closed_loop_lane_steps_checked"] <= 0:
        fail("[9b] the violation check covered no state the closed loop produced")
    if not res["tube_containment_rate"] == 1.0:
        fail(f"[9b] tube containment on successful solves {res['tube_containment_rate']} < 1")
    if PUBLISHED_RUN.is_file():
        pub = np.load(PUBLISHED_RUN, allow_pickle=True)["success_mask"][:B, :T]
        res["success_flags_differing_from_published"] = int((pub != succ).sum())
        say(f"[9b] success flags of the first {T} steps that differ from {PUBLISHED_RUN.name}: "
            f"{res['success_flags_differing_from_published']} of {pub.size} (same draws; "
            "the published run is float32 on a TPU)")
    res["first_round"] = profile_round(entry["solver"], entry["st"], entry["x"])
    fr = res["first_round"]
    say(f"[9b] step {T - 1}'s first SCP round at B={B}: {fr['round_ms']:.1f} ms, device "
        f"kernels {fr['device_kernel_ms']:.1f} ms, busy share {fr['device_busy_share']:.4f}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / out).write_text(json.dumps(res, indent=1))
    return res


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


def join_worker(proc, log, label, timeout=900):
    """Wait for a worker, echo its lines, fail if it failed."""
    import subprocess

    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    log.close()
    for line in Path(log.name).read_text().splitlines():
        if line.startswith((f"[{label}]", "[mc]", "chip_smoke FAILED", "Traceback")) or "Error" in line:
            print(line, flush=True)
    if rc != 0:
        fail(f"phase {label}'s worker ended with {rc} (see {log.name})")


def main(argv=None):
    ap = argparse.ArgumentParser(description="smoke test of the port on one GPU")
    ap.add_argument("--phases", default="all",
                    help="comma-separated subset of 3-12 to run after phases 1-2 (default: all)")
    ap.add_argument("--guarantee-alone", choices=["steps", "stages"],
                    help="run only phase 9b, alone on the card after the build, with the "
                         "seed and the steps timed or every stage timed; no result lines")
    ap.add_argument("--guarantee-worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--compare-reference", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-store", help=argparse.SUPPRESS)
    ap.add_argument("--entry-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    if args.guarantee_worker:
        # the seed needs no kernel; the first K1 launch loads the extension
        # that the main process builds meanwhile
        guarantee_mode(stages=True)
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
    if args.guarantee_alone:
        say(f"[1] device {torch.cuda.get_device_name(0)}, nvidia-smi: {bench.gpu_identity()[2]}")
        cuda_lib.build_extension()
        guarantee_mode(stages=args.guarantee_alone == "stages",
                       out=f"chip_smoke_guarantee_alone_{args.guarantee_alone}.json")
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
        workers["9b"] = start_worker("chip_smoke_9b.log", "--guarantee-worker")
    if 11 in run:
        workers["11a"] = start_worker("chip_smoke_11a_cpu.log", "--compare-reference")
    try:
        t0 = time.perf_counter()
        cuda_lib.build_extension(verbose=True)
        say(f"[2] built {', '.join(s.name for s in cuda_lib.SOURCES)} for sm_90a "
            f"in {time.perf_counter() - t0:.1f} s")
        # untimed phases, beside the workers; the CPU references leave them two cores
        threads = torch.get_num_threads()
        torch.set_num_threads(max(1, threads - 2))
        if 4 in run:
            check_solve_qp()
            check_fused_iter()
        if run & {5, 6, 7, 8, 10, 11}:
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
            join_worker(*workers["9b"], "9b")
        torch.set_num_threads(threads)
        # timed phases, alone on the card
        if 3 in run:
            report_occupancy()
            main_err = check_kernels()
            times = time_kernels()
        if run & {6, 7, 8}:
            launches = bench_phases(wls)
    finally:
        for proc, _ in workers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if run != set(ALL_PHASES):
        say(f"partial run (phases 1, 2 and {sorted(run)}): no result lines")
        return 0

    kernels = []
    for k in ("factor_predictor", "resolve", "ipm_iteration", "fused_response", "backward_K"):
        bound_ms, bound_by = kernel_bound(k)
        kernels.append({
            "name": k, "route": "cuda", "source": SOURCES[k], "replaces": REPLACES[k],
            "launches": launches[k], "max_abs_err": main_err[k], "ms": times[k][0],
            "plain_ms": times[k][1], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

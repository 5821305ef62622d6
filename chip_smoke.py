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
     (K1, K2);
  7. the bench twin in the fused-kernel configuration (kkt="fused_iter",
     response="fused"): the second path (K6, K4). Both configurations start
     from one SQP seed and run twice, default, fused, fused, default, each
     with its stage breakdown and device busy share after its first run;
  8. the bench twin with sls_block = -1 from the same seed, once, with its
     stage breakdown and busy share: the third path (K3), which must launch
     in the timed steps.
Every launch counter is zeroed just before each bench run and read just
after it. The last lines are the kernels record, the nvidia-smi line and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
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
from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step
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
from robust_nonlinear_mpc_torch.utils.batch import tree_map

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
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, CUDA-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


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


def card_vs_cpu(label, N, Bsz, configure, store_phi, seed, nominal=None):
    """3 MPC steps from one nominal, the card against the CPU, each with its
    solver options from `configure(opts, device)`: identical success and QP
    iterations, X/U within 1e-8 (float64). The nominal is an SQP solve on
    the card at tolerance 1e-6, or `nominal` = (X, U, x0) of the first Bsz
    lanes of a bench seed."""
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
        step = make_mpc_step(solver)
        outs[device] = []
        for i in range(3):
            carry, out = step(carry, to(w[i]))
            outs[device].append(tree_map(lambda t: t.cpu(), out))
    for i, (g, c) in enumerate(zip(outs["cuda"], outs["cpu"])):
        ok_same = bool((g[6] == c[6]).all()) and bool((g[7] == c[7]).all())
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


def run_bench(label, wl):
    """One bench twin run (warm-in, timed window, B = 1 latency loop) of a
    built workload, its launch counts zeroed just before and read just
    after."""
    bench.reset_launch_counts()
    t0 = time.perf_counter()
    record, carry = bench.run(wl)
    launches = bench.launch_counts()
    say(f"[{label}] bench twin kkt={record['kkt']} response={record['response']} "
        f"sls_block={record['sls_block']} "
        f"ran in {time.perf_counter() - t0:.1f} s, launches {launches}")
    print(json.dumps(record), flush=True)
    if record["success_fraction"] != 1.0 or not record["finite"]:
        fail(f"bench twin [{label}]: success_fraction must be 1.0 and the state finite")
    return record, carry, launches


def breakdown(label, wl, carry):
    """Stage breakdown and device busy share of one configuration."""
    stages = bench.stage_breakdown(wl, carry, wl.w_seq[0])
    prof = bench.profile_kernels(wl, carry, wl.w_seq)
    say(f"[{label}] stage ms {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    say(f"[{label}] profiler: {prof['steps']} steps, wall (unprofiled) {prof['wall_ms']:.2f} ms, "
        f"device kernels {prof['device_kernel_ms']:.2f} ms, busy share {prof['device_busy_share']}")
    return {"stages": stages, "profile": prof}


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
            launches.update({k: counts[k] for k in kernels})
            profile[label].update(breakdown(label, wls[label], carry))
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.json").write_text(json.dumps(profile, indent=1))
    return launches


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    name, limit_w, smi_line = bench.gpu_identity()
    kind = torch.cuda.get_device_name(0)
    say(f"[1] device {kind} (count {torch.cuda.device_count()}), nvidia-smi: {smi_line}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    bench.require_cuda()

    t0 = time.perf_counter()
    cuda_lib.build_extension(verbose=True)
    say(f"[2] built {', '.join(s.name for s in cuda_lib.SOURCES)} for sm_90a "
        f"in {time.perf_counter() - t0:.1f} s")

    report_occupancy()
    main_err = check_kernels()
    times = time_kernels()
    check_solve_qp()
    check_fused_iter()
    wls = bench_workloads()
    check_closed_loop(wls["6"])

    launches = bench_phases(wls)

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


if __name__ == "__main__":
    sys.exit(main())

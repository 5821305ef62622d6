"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints a line; any failed check raises and exits non-zero
before the result lines):
  1. the device and its nvidia-smi name and power limit;
  2. build the fused Newton kernels (csrc/fused_qp.cu) with nvcc for sm_90a;
  3. both kernels against their plain torch versions on the card, float64
     to 1e-10 and float32 to 1e-4 relative to each output's max |value|,
     at (B, N) in {(512, 15), (37, 15), (8, 60)} with nx = 17, nu = 4, and
     nu in {1, 2} at B = 8; per-call times at (512, 15) float32;
  4. solve_qp with kkt="fused" against kkt="riccati" on rocket QPs, B = 512,
     float32: identical iteration counts, X/U within 1e-4;
  5. 3 closed-loop MPC steps at N = 6, B = 8, float64 on the card (kernels)
     against the CPU (plain versions): identical success and QP iterations,
     X/U within 1e-8;
  6. the bench twin (robust_nonlinear_mpc_torch.bench) at its full
     configuration: the main path. Every launch counter is zeroed before it
     and read after it.
The last lines are the kernels record, the nvidia-smi line and
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
from robust_nonlinear_mpc_torch.ops import fused_qp
from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions, QPData, QPStatics, _curvature, solve_qp
from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step
from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist
from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve
from robust_nonlinear_mpc_torch.utils.batch import tree_map

OUT_DIR = Path("chiprun_out")
TPU_SOURCE = "robust_nonlinear_mpc_tpu/ops/pallas_qp.py"
REPLACES = {
    "factor_predictor": f"{TPU_SOURCE}:161",
    "resolve": f"{TPU_SOURCE}:293",
}
TOL = {torch.float64: 1e-10, torch.float32: 1e-4}


def say(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def newton_inputs(Bsz, N, nx, nu, dtype, device, seed):
    """Random well-posed Newton-solve inputs (curvature from random
    constraint geometry and IPM weights), made with numpy from a seed."""
    rng = np.random.default_rng(seed)
    ni, ni_f = 2 * (nx + nu), 2 * nx
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    stat = QPStatics(
        Hx=t(2 * np.eye(nx)), Hu=t(2 * np.eye(nu)), HxN=t(6 * np.eye(nx)),
        Gx=t(rng.standard_normal((ni, nx))), Gu=t(rng.standard_normal((ni, nu))),
        Gf=t(rng.standard_normal((ni_f, nx))),
    ).per_stage(N)
    W = t(np.abs(rng.standard_normal((Bsz, N, ni))) + 0.1)
    Wf = t(np.abs(rng.standard_normal((Bsz, ni_f))) + 0.1)
    Cxx, Cuu, Cxu, PN = _curvature(stat, W, Wf)
    A = t(0.9 * np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx)))
    B = t(0.2 * rng.standard_normal((Bsz, N, nx, nu)))
    rbx = rng.standard_normal((Bsz, N, nx))
    rbx[:, 0] = 0.0
    rhs = [t(rbx), t(rng.standard_normal((Bsz, nx))), t(rng.standard_normal((Bsz, N, nu))),
           t(rng.standard_normal((Bsz, N, nx)))]
    rhs2 = [t(rng.standard_normal(r.shape)) for r in rhs]
    return (A, B, Cxx, Cuu, Cxu, PN), rhs, rhs2


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


def check_kernels():
    """Phase 3: both kernels against their plain versions on the card."""
    worst = {}
    main_err = {}
    for dtype in (torch.float64, torch.float32):
        for Bsz, N, nu in KERNEL_CASES:
            for (kname, oname), (r, ab) in compare_kernels(Bsz, N, nu, dtype).items():
                if not (r <= TOL[dtype]):
                    fail(f"{kname} {oname} B={Bsz} N={N} nu={nu} {dtype}: rel err {r:.3e}")
                worst[(kname, dtype)] = max(worst.get((kname, dtype), 0.0), r)
                if (Bsz, N, nu, dtype) == (512, 15, 4, torch.float32):
                    main_err[kname] = max(main_err.get(kname, 0.0), ab)
    for (kname, dtype), r in worst.items():
        say(f"[3] {kname} {dtype}: worst rel err {r:.3e} (tol {TOL[dtype]:g})")
    return main_err


def cuda_ms(fn, n):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_kernels():
    """Per-call times at the main path's shape (B=512, N=15, f32)."""
    mats, rhs, rhs2 = newton_inputs(512, 15, 17, 4, torch.float32, "cuda", seed=1)
    A, B = mats[0], mats[1]
    fact = fused_qp.factor_predictor(*mats, *rhs)[3]
    pfact = fused_qp._plain_factor_predictor(*mats, *rhs)[3]
    t = {}
    # plain, kernel, kernel, plain
    p1 = cuda_ms(lambda: fused_qp._plain_factor_predictor(*mats, *rhs), 10)
    k1 = cuda_ms(lambda: fused_qp.factor_predictor(*mats, *rhs), 50)
    k2 = cuda_ms(lambda: fused_qp.factor_predictor(*mats, *rhs), 50)
    p2 = cuda_ms(lambda: fused_qp._plain_factor_predictor(*mats, *rhs), 10)
    t["factor_predictor"] = (min(k1, k2), min(p1, p2))
    p1 = cuda_ms(lambda: fused_qp._plain_resolve(A, B, pfact, *rhs2), 10)
    k1 = cuda_ms(lambda: fused_qp.resolve(A, B, fact, *rhs2), 50)
    k2 = cuda_ms(lambda: fused_qp.resolve(A, B, fact, *rhs2), 50)
    p2 = cuda_ms(lambda: fused_qp._plain_resolve(A, B, pfact, *rhs2), 10)
    t["resolve"] = (min(k1, k2), min(p1, p2))
    for k, (km, pm) in t.items():
        say(f"[3] {k} at B=512 N=15 f32: kernel {km:.4f} ms, plain {pm:.4f} ms")
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


def check_closed_loop():
    """Phase 5: 3 MPC steps, kernels on the card against plain on the CPU."""
    N, Bsz, dtype = 6, 8, torch.float64
    runs = {}
    for device in ("cuda", "cpu"):
        m, solver = make_rocket_problem(N=N, device=device, dtype=dtype)
        solver.opts = solver.opts._replace(
            verbose=False, ipm=IPMOptions(max_iter=15, tol=3e-5, kkt="fused"),
            adaptive_ipm_budget=(6, 15), streaming_response=True,
            recycle_eta=True, recycle_warm_qp=True,
        )
        runs[device] = (m, solver)
    rng = np.random.default_rng(0)
    x0s = np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, 17))
    w = rng.uniform(-1.0, 1.0, (3, Bsz, 17))
    m, solver = runs["cuda"]
    nom = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, torch.as_tensor(x0s, dtype=dtype, device="cuda"),
                    opts=solver.opts.sqp)
    if not bool(nom.success.all()):
        fail("SQP seed failed on the card")
    outs = {}
    for device, (m, solver) in runs.items():
        to = lambda a: torch.as_tensor(a, dtype=dtype).to(device)
        persist = FastSLSPersist.init(N, 17, 4, m.ni, m.ni_f, 17, batch=Bsz, dtype=dtype,
                                      device=device, store_phi=False)
        carry = (nom.X.to(device), nom.U.to(device), persist, to(x0s))
        step = make_mpc_step(solver)
        outs[device] = []
        for i in range(3):
            carry, out = step(carry, to(w[i]))
            outs[device].append(tree_map(lambda t: t.cpu(), out))
    for i, (g, c) in enumerate(zip(outs["cuda"], outs["cpu"])):
        ok_same = bool((g[6] == c[6]).all()) and bool((g[7] == c[7]).all())
        ex = float((g[2] - c[2]).abs().max())
        eu = float((g[3] - c[3]).abs().max())
        say(f"[5] step {i}: success {g[6].tolist()} qp iters {g[7].tolist()} "
            f"|dX| {ex:.2e} |dU| {eu:.2e}")
        if not ok_same or ex > 1e-8 or eu > 1e-8:
            fail(f"closed-loop step {i} differs between the card and the CPU")


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    name, limit_w, smi_line = bench.gpu_identity()
    kind = torch.cuda.get_device_name(0)
    say(f"[1] device {kind} (count {torch.cuda.device_count()}), nvidia-smi: {smi_line}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    bench.require_cuda()

    t0 = time.perf_counter()
    fused_qp.build_extension(verbose=True)
    say(f"[2] built {fused_qp.SOURCE.name} for sm_90a in {time.perf_counter() - t0:.1f} s")

    main_err = check_kernels()
    times = time_kernels()
    check_solve_qp()
    check_closed_loop()

    # phase 6: the main path
    fused_qp.reset_launch_counts()
    t0 = time.perf_counter()
    wl = bench.build_workload()
    record, carry = bench.run(wl)
    launches = fused_qp.launch_counts()
    say(f"[6] bench twin ran in {time.perf_counter() - t0:.1f} s")
    print(json.dumps(record), flush=True)
    if record["success_fraction"] != 1.0 or not record["finite"]:
        fail("bench twin: success_fraction must be 1.0 and the state finite")
    if min(launches.values()) <= 0:
        fail(f"the main path did not launch every kernel: {launches}")

    stages = bench.stage_breakdown(wl, carry, wl.w_seq[0])
    prof = bench.profile_kernels(wl, carry, wl.w_seq)
    say(f"[6] stage ms {json.dumps({k: round(v, 3) for k, v in stages.items()})}")
    say(f"[6] profiler: {prof['steps']} steps, wall (unprofiled) {prof['wall_ms']:.2f} ms, device kernels "
        f"{prof['device_kernel_ms']:.2f} ms, busy share {prof['device_busy_share']}")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.json").write_text(
        json.dumps({"record": record, "stages": stages, "profile": prof}, indent=1)
    )

    kernels = [
        {
            "name": k, "route": "cuda",
            "source": "robust_nonlinear_mpc_torch/csrc/fused_qp.cu",
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": main_err[k], "ms": times[k][0], "plain_ms": times[k][1],
        }
        for k in ("factor_predictor", "resolve")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())

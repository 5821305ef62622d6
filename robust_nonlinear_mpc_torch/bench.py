"""Benchmark: batched rocket SLS-MPC closed-loop steps per second on one
NVIDIA GPU (the twin of the repository's `bench.py`).

One "solve" is one full closed-loop MPC step (`sim.closed_loop.make_mpc_step`):
RK4 Jacobians, column-wise backward Riccati with the recycled eta weights,
the Phi-free streaming response, one tightened QP (Mehrotra IPM with the
fused CUDA Newton kernels, warm-started from the previous step, adaptive
(6, 15) iteration budget), plant step x+ = f(x, u0) + E w with
w ~ U[-1, 1]^nw, warm shift. Same configuration as `bench.py` on its
float32 path: B = 512, 10 timed reps after 30 warm-in steps, seeds 0 and 7,
QP tolerance 3e-5, every lane seeded by the SQP with the chunked soft-slack
fallback. The tube synthesis runs at full float32 ("highest"): the JAX
package's reduced-precision tube mode is not ported, and TF32 stays off.

Prints ONE JSON line. Usage: python -m robust_nonlinear_mpc_torch.bench
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from robust_nonlinear_mpc_torch.ops import fused_qp

METRIC = "rocket_sls_mpc_solves_per_s"


class BenchWorkload(NamedTuple):
    m: Any
    solver: Any
    mpc_step: Any
    carry: Any          # (Xs, Us, persist, x0s) at batch B
    w_seq: torch.Tensor  # (n_warm + n_rep, B, nw)
    B: int
    n_rep: int
    n_warm: int
    budget_mode: str
    dtype: Any
    device: Any
    n_soft_fallback: int


def gpu_identity():
    """(name, power limit in W) as nvidia-smi reports them, and the raw line."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = [s.strip() for s in line.rsplit(",", 1)]
    return name, float(limit.split()[0]), line


def require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark measures the GPU: no CUDA device is available")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmuls must stay off on the solver path")


def seed_nominal(m, solver, x0s):
    """SQP nominal per lane; lanes whose hard SQP fails get the soft-slack
    solve + hard polish, in chunks (the bench's cold start)."""
    from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_fallback_chunk, soft_nlp_solve
    from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve

    N = solver.N
    nominal = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s, opts=solver.opts.sqp)
    Xs, Us = nominal.X.clone(), nominal.U.clone()
    failed = (~nominal.success).nonzero().flatten()
    chunk = soft_fallback_chunk(N)
    for c0 in range(0, failed.numel(), chunk):
        idx = failed[c0 : c0 + chunk]
        soft = soft_nlp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s[idx],
                              rho_soft=1e6, rho_soft_l1=1e6)
        hard = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s[idx],
                         X_init=soft.X, U_init=soft.U, opts=solver.opts.sqp)
        ok = hard.success[:, None, None]
        fb_X = torch.where(ok, hard.X, soft.X)
        fb_U = torch.where(ok, hard.U, soft.U)
        use = soft.success[:, None, None]
        Xs[idx] = torch.where(use, fb_X, Xs[idx])
        Us[idx] = torch.where(use, fb_U, Us[idx])
    return Xs, Us, int(failed.numel())


def build_workload(*, device="cuda", dtype=torch.float32, B=512, n_rep=10,
                   n_warm=30, N=15) -> BenchWorkload:
    """The bench's workload; the defaults are the benchmarked configuration
    (the CPU tests build it at a tiny size)."""
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions
    from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist

    m, solver = make_rocket_problem(N=N, device=device, dtype=dtype)
    qp_iters, cold_cap = 6, 15
    solver.opts = solver.opts._replace(
        verbose=False,
        ipm=IPMOptions(max_iter=cold_cap, tol=3e-5, kkt="fused"),
        adaptive_ipm_budget=(qp_iters, cold_cap),
        ipm_first=IPMOptions(max_iter=8, tol=1e-3, kkt="fused"),
        streaming_response=True, recycle_eta=True, recycle_warm_qp=True,
    )
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        np.array(X0)[None] + 0.02 * rng.standard_normal((B, m.nx)), dtype=dtype, device=device
    )
    Xs, Us, n_fb = seed_nominal(m, solver, x0s)
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=B,
                                  dtype=dtype, device=device, store_phi=False)
    w_seq = torch.as_tensor(
        rng.uniform(-1.0, 1.0, (max(1, n_warm) + n_rep, B, m.nw)), dtype=dtype, device=device
    )
    return BenchWorkload(
        m=m, solver=solver, mpc_step=make_mpc_step(solver),
        carry=(Xs, Us, persist, x0s), w_seq=w_seq, B=B, n_rep=n_rep,
        n_warm=n_warm, budget_mode=f"adaptive({qp_iters},{cold_cap})",
        dtype=dtype, device=torch.device(device), n_soft_fallback=n_fb,
    )


def _lane0(carry):
    from robust_nonlinear_mpc_torch.utils.batch import tree_map

    return tree_map(lambda t: t[:1], carry)


def stage_breakdown(wl: BenchWorkload, carry, w, reps=5):
    """Median host-clock time (ms) of the stages of one step on the given
    state, synchronized after every stage. `fast_sls` is the whole fast-SLS
    solve (backward Riccati + response + the warm-started QP + eta refresh),
    so its QP part is `fast_sls - backward_riccati - response`."""
    from robust_nonlinear_mpc_torch.ops.sls_kernels import (
        backward_solve_folded,
        response_streaming_folded,
    )
    from robust_nonlinear_mpc_torch.solvers.fast_sls import fast_sls_solve

    solver = wl.solver
    X, U, persist, x = carry
    prob = solver.prob
    fopts = solver._fast_sls_opts()
    Gmat = torch.cat([prob.stat.Gx, prob.stat.Gu], dim=1)
    samples = {k: [] for k in ("linearize", "backward_riccati", "response", "fast_sls", "step")}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        samples[name].append(1e3 * (time.perf_counter() - t0))
        return out

    for _ in range(reps):
        dev = timed("linearize", lambda: solver.assemble_deviation_problem(X, U, x))
        A, B = dev[0], dev[1]
        K = timed("backward_riccati", lambda: backward_solve_folded(
            A, B, Gmat, prob.stat.Gf, persist.eta, persist.eta_f, prob.regs)[1])
        timed("response", lambda: response_streaming_folded(
            A, B, prob.E, K, prob.stat.Gx, prob.stat.Gu, prob.stat.Gf, prob.regs,
            fopts.epsilon_backoff))
        timed("fast_sls", lambda: fast_sls_solve(prob, *dev, persist, fopts))
        timed("step", lambda: wl.mpc_step(carry, w))
    out = {k: float(np.median(v)) for k, v in samples.items()}
    out["qp_share_of_step"] = (
        out["fast_sls"] - out["backward_riccati"] - out["response"]
    ) / out["step"]
    return out


def profile_kernels(wl: BenchWorkload, carry, w_seq, n=3):
    """Device kernel time of n steps by kernel name (torch.profiler), and
    the device busy share: that time over the host wall time of the same n
    steps run without the profiler, which slows the host side."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def steps():
        c = carry
        for i in range(n):
            c, _ = wl.mpc_step(c, w_seq[i])
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        steps()
    # device rows only: an operator's row repeats the time of its kernels
    rows = sorted(
        ((ev.key, ev.self_device_time_total / 1e3, ev.count)
         for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    return {
        "steps": n, "wall_ms": wall_ms, "device_kernel_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms if wall_ms > 0 else None,
        "top_kernels": [{"name": k[:120], "ms": ms, "count": c} for k, ms, c in rows[:25]],
    }


def run(wl: BenchWorkload | None = None, n_lat: int = 50):
    """Warm-in, the timed window and the B=1 latency loop. Returns the
    result record (the JSON line's fields) and the final batch carry."""
    require_cuda()
    if wl is None:
        wl = build_workload()
    step = wl.mpc_step
    carry = wl.carry
    n_warm = max(1, wl.n_warm)
    for i in range(n_warm):
        carry, out = step(carry, wl.w_seq[i])
    torch.cuda.synchronize()

    before = fused_qp.launch_counts()
    t0 = time.perf_counter()
    for i in range(wl.n_rep):
        carry, out = step(carry, wl.w_seq[n_warm + i])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {k: v - before[k] for k, v in fused_qp.launch_counts().items()}

    ok, qp_iters = out[6], out[7]
    solves_per_s = wl.B * wl.n_rep / (t1 - t0)
    finite = bool(torch.isfinite(carry[0]).all() and torch.isfinite(carry[3]).all())

    # single-instance rolling closed loop (B = 1) from the cold seed of lane 0
    rngl = np.random.default_rng(7)
    nw = wl.m.nw
    w1 = lambda: torch.as_tensor(2 * rngl.random((1, nw)) - 1, dtype=wl.dtype, device=wl.device)
    c1, _ = step(_lane0(wl.carry), w1())
    torch.cuda.synchronize()
    lats = []
    for _ in range(n_lat):
        w = w1()
        ts = time.perf_counter()
        c1, _ = step(c1, w)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - ts)

    name, limit_w, _ = gpu_identity()
    record = {
        "metric": METRIC,
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "batch": wl.B,
        "reps": wl.n_rep,
        "warmup_reps": wl.n_warm,
        "device": torch.cuda.get_device_name(wl.device),
        "dtype": str(wl.dtype).replace("torch.", ""),
        "success_fraction": round(float(ok.float().mean()), 4),
        "finite": finite,
        "mean_qp_iters": round(float(qp_iters.float().mean()), 2),
        "max_qp_iters": int(qp_iters.max()),
        "ipm_budget_mode": wl.budget_mode,
        "horizon_N": wl.solver.N,
        "gpu_name": name,
        "power_limit_w": limit_w,
        "tube_precision": "highest",
        "kkt": wl.solver.opts.ipm.kkt,
        "kernel_launches": launches,
        "soft_fallback_lanes": wl.n_soft_fallback,
        "single_step_latency_ms": round(1e3 * float(np.median(lats)), 3),
        "single_step_latency_p99_ms": round(1e3 * float(np.percentile(lats, 99)), 3),
        "single_step_latency_steps": n_lat,
        "on_device_step_ms": None,
        "latency_note": (
            "host wall clock around a synchronized B=1 step on a locally attached "
            "GPU; there is no remote dispatch to subtract, so on_device_step_ms is "
            "null (CUDA-graph capture of the step is later work)"
        ),
    }
    return record, carry


def main():
    record, _ = run()
    print(json.dumps(record))


if __name__ == "__main__":
    main()

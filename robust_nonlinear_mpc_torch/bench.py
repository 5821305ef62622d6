"""Benchmark: batched rocket SLS-MPC closed-loop steps per second on one
NVIDIA GPU (the twin of the repository's `bench.py`).

One "solve" is one full closed-loop MPC step (`sim.closed_loop.make_mpc_step`,
run on the card as one captured CUDA graph, `sim.closed_loop.capture_mpc_step`,
as the JAX bench runs `jax.jit(jax.vmap(mpc_step))`):
RK4 Jacobians, column-wise backward Riccati with the recycled eta weights,
the Phi-free streaming response, one tightened QP (Mehrotra IPM with the
fused CUDA Newton kernels, warm-started from the previous step, adaptive
(6, 15) iteration budget), plant step x+ = f(x, u0) + E w with
w ~ U[-1, 1]^nw, warm shift. Same configuration as `bench.py` on its
float32 path: B = 512, 10 timed reps after 30 warm-in steps, seeds 0 and 7,
QP tolerance 3e-5, every lane seeded by the SQP with the chunked soft-slack
fallback. The tube synthesis runs at full float32 ("highest",
`utils.numerics.set_tube_precision`), and TF32 stays off: the JAX bench sets
its tube to "default", whose H100 counterpart (TF32 tube GEMMs) stays off
here until a benchmark measures it (`chip_smoke.py` phase 13 prints its
backoff deviation and solves/s).

`build_workload(kkt=..., response=..., sls_block=...)` picks the IPM's
Newton path ("fused", the default, or "fused_iter": the whole iteration as
one kernel; "riccati"), the response ("streaming", the default;
"materialized": the Phi-materializing stages; "fused": the fused response
kernel), the twins of the JAX bench's RNM_BENCH_KKT and
RNM_BENCH_STREAMING, and the SLS kernels (`fast_sls.select_sls_kernels`):
0 by default (the folded torch backward and streaming response; the JAX
bench's accelerator setting, 2, the column-blocked segments, was not
faster per call on the H100 in alternating pairs: PERF.md), -1 the
hand-written backward kernel. The fused-kernel configuration is
kkt="fused_iter", response="fused".

Prints ONE JSON line. Usage:
  python -m robust_nonlinear_mpc_torch.bench [--N 15] [--batch 512]
      [--kkt fused|fused_iter|riccati] [--response streaming|materialized|fused]
      [--sls-block 0]
The record's `horizon_N`, `batch`, `kkt`, `response` and `sls_block` say
what ran (`--N 60` is the long-horizon configuration, on which the JAX
bench runs its windowed Newton kernels).
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import Any, NamedTuple

import numpy as np
import torch

# the kernels' launch counters, which the bench reports
from robust_nonlinear_mpc_torch.ops.cuda_lib import launch_counts, reset_launch_counts  # noqa: F401
from robust_nonlinear_mpc_torch.utils.batch import tree_map

METRIC = "rocket_sls_mpc_solves_per_s"
RESPONSES = ("streaming", "materialized", "fused")
# the adaptive IPM budget: steady-state and cold iteration caps
QP_ITERS, COLD_CAP = 6, 15


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
    response: str
    sls_block: int


def gpu_identity():
    """(name, power limit in W) as nvidia-smi reports them, and the raw line."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = [s.strip() for s in line.rsplit(",", 1)]
    return name, float(limit.split()[0]), line


def cuda_ms(fn, n):
    """Mean time (ms) of one call of `fn`: CUDA events around n calls, after
    one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("this benchmark measures the GPU: no CUDA device is available")
    from robust_nonlinear_mpc_torch.utils.numerics import tf32_enabled

    if tf32_enabled():
        raise RuntimeError("TF32 matmuls must stay off on the solver path")


def seed_nominal(solver, x0s):
    """SQP nominal per lane; lanes whose hard SQP fails get the soft-slack
    solve + hard polish, `soft_fallback_chunk(N)` lanes at a time (the
    bench's cold start). On the card the solvers' loops run as CUDA graphs,
    each a WHILE node (`utils.graph_loop.GraphSet`, as in the guarantee
    drivers' seed); eagerly elsewhere, with the same result. Returns
    (Xs, Us, the number of lanes whose hard SQP failed)."""
    from robust_nonlinear_mpc_torch.sim.closed_loop import _nominal, _soft_fallback
    from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_fallback_chunk
    from robust_nonlinear_mpc_torch.utils.graph_loop import GraphSet

    graphs = GraphSet(x0s.device)
    Xs, Us, ok = _nominal(solver, x0s, graphs)
    Xs, Us = _soft_fallback(solver, x0s, Xs, Us, ok, chunk=soft_fallback_chunk(solver.N),
                            graphs=graphs)
    return Xs, Us, int((~ok).sum())


def configure(solver, *, kkt="fused", response="streaming", sls_block=0):
    """Set the bench's solver options (the JAX bench's float32 throughput
    configuration: recycled eta, cross-step QP warm start, the adaptive
    IPM budget) with the given Newton path, response and SLS kernels."""
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions

    if response not in RESPONSES:
        raise ValueError(f"response must be one of {RESPONSES}, got {response!r}")
    solver.opts = solver.opts._replace(
        verbose=False,
        ipm=IPMOptions(max_iter=COLD_CAP, tol=3e-5, kkt=kkt),
        adaptive_ipm_budget=(QP_ITERS, COLD_CAP),
        ipm_first=IPMOptions(max_iter=8, tol=1e-3, kkt=kkt),
        streaming_response=response == "streaming",
        use_pallas_response=response == "fused",
        recycle_eta=True, recycle_warm_qp=True, sls_block=sls_block,
    )
    return solver


def build_workload(*, device="cuda", dtype=torch.float32, B=512, n_rep=10,
                   n_warm=30, N=15, kkt="fused", response="streaming",
                   sls_block=0,
                   seed_from: BenchWorkload | None = None) -> BenchWorkload:
    """The bench's workload; the defaults are the benchmarked configuration
    (the CPU tests build it at a tiny size). `seed_from`: a workload of the
    same size whose SQP seed is reused (the seed does not depend on `kkt`,
    `response` or `sls_block`), so that several configurations start from
    the same lanes without seeding again."""
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )
    from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist

    m, solver = make_rocket_problem(N=N, device=device, dtype=dtype)
    configure(solver, kkt=kkt, response=response, sls_block=sls_block)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(
        np.array(X0)[None] + 0.02 * rng.standard_normal((B, m.nx)), dtype=dtype, device=device
    )
    if seed_from is None:
        Xs, Us, n_fb = seed_nominal(solver, x0s)
    else:
        if not torch.equal(seed_from.carry[3], x0s):
            raise ValueError("seed_from was built for other initial states")
        Xs, Us, n_fb = seed_from.carry[0], seed_from.carry[1], seed_from.n_soft_fallback
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=B,
                                  dtype=dtype, device=device,
                                  store_phi=response != "streaming")
    w_seq = torch.as_tensor(
        rng.uniform(-1.0, 1.0, (max(1, n_warm) + n_rep, B, m.nw)), dtype=dtype, device=device
    )
    return BenchWorkload(
        m=m, solver=solver, mpc_step=make_mpc_step(solver),
        carry=(Xs, Us, persist, x0s), w_seq=w_seq, B=B, n_rep=n_rep,
        n_warm=n_warm, budget_mode=f"adaptive({QP_ITERS},{COLD_CAP})",
        dtype=dtype, device=torch.device(device), n_soft_fallback=n_fb,
        response=response, sls_block=sls_block,
    )


def _lane0(carry):
    return tree_map(lambda t: t[:1], carry)


def stage_breakdown(wl: BenchWorkload, carry, w, reps=5):
    """Median host-clock time (ms) of the stages of one step on the given
    state (`utils.stages`, synchronized at each stage's ends). `fast_sls` is
    the whole fast-SLS solve (backward Riccati + response + the warm-started
    QP + eta refresh) and `qp` its QP. The backward Riccati and the response
    are the configured ones."""
    from robust_nonlinear_mpc_torch.utils.stages import stage, timed

    names = {"linearize": "scp.linearize", "backward_riccati": "sls.backward",
             "response": "sls.response", "qp": "sls.qp", "fast_sls": "scp.fast_sls",
             "step": "step"}
    samples = {k: [] for k in names}
    for _ in range(reps):
        with timed() as rec:
            with stage("step"):
                wl.mpc_step(carry, w)
        for k, name in names.items():
            samples[k].append(1e3 * sum(rec[name]))
    out = {k: float(np.median(v)) for k, v in samples.items()}
    out["qp_share_of_step"] = out["qp"] / out["step"]
    return out


def union_ms(spans):
    """The length of the union of (start, end) intervals: time covered by
    at least one of them, overlaps counted once."""
    busy, end = 0.0, None
    for s, e in sorted(spans):
        busy += max(0.0, e - max(s, end if end is not None else s))
        end = e if end is None else max(end, e)
    return busy


def profile_kernels(wl: BenchWorkload, carry, w_seq, n=3, captured=False):
    """Device kernel time of n steps by kernel name (torch.profiler), and
    the device busy share: the union of the kernel records' intervals
    (kernels that overlap, as a WHILE body's on its side stream, counted
    once) over the host wall of the profiled window. The profiler may lose
    records inside a graph's WHILE bodies: `records_complete` says whether
    it kept one K1 and one K2 record for each launch the port's counters
    saw in the window (a captured step's WHILE bodies counted on the
    device); where it did not, the busy share is too low. `captured`: the
    steps are replays of the step captured from `carry` (captured before
    either window; the profiler then records the card only), else eager
    steps. `wall_ms`: the same n steps without the profiler; `profiled_ms`
    the n steps under it (its start and stop excluded). Both windows start
    from `carry`."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from robust_nonlinear_mpc_torch.sim.closed_loop import capture_mpc_step

    step = capture_mpc_step(wl.solver, carry) if captured else wl.mpc_step
    launched = step.launched if captured else lambda: Counter(launch_counts())

    def steps():
        c = carry
        for i in range(n):
            c, _ = step(c, w_seq[i])
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    activities = [ProfilerActivity.CUDA] + ([] if captured else [ProfilerActivity.CPU])
    before = launched()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        steps()
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    newton = ("factor_predictor", "resolve")
    window = launched() - before
    kernels = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    records = {k: sum(f"{k}_kernel" in ev.name for ev in kernels) for k in newton}
    busy_ms = union_ms([(ev.time_range.start, ev.time_range.end) for ev in kernels]) / 1e3
    # device rows only: an operator's row repeats the time of its kernels
    rows = sorted(
        ((ev.key, ev.self_device_time_total / 1e3, ev.count)
         for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    return {
        "steps": n, "captured": captured, "wall_ms": wall_ms, "profiled_ms": profiled_ms,
        "kernel_records": len(kernels), "device_kernel_ms": sum(r[1] for r in rows),
        "device_busy_ms": busy_ms, "device_busy_share": busy_ms / profiled_ms,
        "k1k2_launches": {k: window[k] for k in newton}, "k1k2_records": records,
        "records_complete": records == {k: window[k] for k in newton},
        "top_kernels": [{"name": k[:120], "ms": ms, "count": c} for k, ms, c in rows[:25]],
    }


def analytic_flops_per_solve(N, nx, nu, ni):
    """The reference bench's analytic estimate of one RTI step's operations
    (its fallback when XLA has no cost analysis): one tightened QP at about
    3 Mehrotra iterations with a block Riccati KKT solve, the per-column
    backward Riccati over the N(N+1)/2 column-stage triangle, and the
    streaming response over the same triangle; 2 operations a MAC."""
    nz = nx + nu
    qp = 3 * N * (10 * nx**3 + 4 * nx**2 * nu)
    bwd = (N * (N + 1) // 2) * (2 * ni * nz**2 + 10 * nx**3)
    resp = (N * (N + 1) // 2) * (4 * nx**2 * (nx + nu) + 2 * ni * nz * nx)
    return 2.0 * (qp + bwd + resp)


def device_step_slope(walls):
    """The on-device step time from the median walls {K: ms} of captured
    K-step programs, wall(K) = intercept + K * step, by the slope between
    the smallest and the largest K (the JAX bench's K = 1 against K = 8);
    None when it is not positive (the difference of two noisy medians)."""
    k_lo, k_hi = min(walls), max(walls)
    slope = (walls[k_hi] - walls[k_lo]) / (k_hi - k_lo)
    return slope if slope > 0 else None


def k_step_walls(solver, carry, w_fn, ks=(1, 8), reps=20):
    """Median host wall (ms) of one replay of a captured K-step program, for
    each K, synchronized: each program is captured from `carry` and
    replayed `reps` times, each replay from the carry the last one left,
    with w = w_fn(K). Returns ({K: ms}, the carry after the last program)."""
    from robust_nonlinear_mpc_torch.sim.closed_loop import capture_mpc_step

    walls = {}
    for K in ks:
        prog = capture_mpc_step(solver, carry, steps=K)
        samples = []
        for _ in range(reps):
            W = w_fn(K)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            carry, _ = prog(carry, W)
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - ts)
        walls[K] = 1e3 * float(np.median(samples))
    return walls, carry


def make_record(wl, *, solves_per_s, ok, qp_iters, finite, lats, launches, gpu,
                walls=None, launches_per_step=None, eager_check=None):
    """The JSON line's fields: every key of the reference bench's record
    (null where this path measures nothing) and the port's own. `ok` and
    `qp_iters` are the last timed step's per-lane tensors, `lats` the B = 1
    step times in seconds, `gpu` = (device name, nvidia-smi name, power
    limit in W), `walls` the K-step programs' median walls {K: ms},
    `launches` the timed window's kernel launches and `launches_per_step`
    their mean over its steps, `eager_check` the eager step against the
    last timed replay."""
    from robust_nonlinear_mpc_torch.utils.hardware import PEAK_BYTES, PEAK_FLOPS
    from robust_nonlinear_mpc_torch.utils.numerics import tube_prec

    device, name, limit_w = gpu
    m = wl.m
    flops = analytic_flops_per_solve(wl.solver.N, m.nx, m.nu, m.ni)
    achieved = flops * solves_per_s
    peak_bf16 = PEAK_FLOPS[torch.bfloat16]
    ms = lambda v: round(1e3 * float(v), 3)
    return {
        "metric": METRIC,
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / 20.0, 2),
        "batch": wl.B,
        "reps": wl.n_rep,
        "warmup_reps": wl.n_warm,
        "device": device,
        "dtype": str(wl.dtype).replace("torch.", ""),
        "success_fraction": round(float(ok.float().mean()), 4),
        "finite": finite,
        "mean_qp_iters": round(float(qp_iters.float().mean()), 2),
        "max_qp_iters": int(qp_iters.max()),
        "single_step_latency_ms": ms(np.median(lats)),
        "single_step_latency_p99_ms": ms(np.percentile(lats, 99)),
        "single_step_latency_max_ms": ms(np.max(lats)),
        "realtime_budget_ms": 50.0,
        "on_device_step_ms": None if walls is None else device_step_slope(walls),
        "on_device_fit_points_ms": walls,
        "latency_deployment_note": (
            "host wall clock around a synchronized replay of the B=1 step captured as "
            "one CUDA graph, on a locally attached GPU; on_device_step_ms is the slope "
            "of the median walls of captured K=1 and K=8 step programs at B=1 (20 "
            "replays each), null when not positive"
        ),
        "step_program": "cuda_graph",
        "step_program_note": (
            "the step runs as one captured CUDA graph (sim.closed_loop.capture_mpc_step): "
            "each IPM loop is a WHILE node that tests 'any lane active' on the device, so "
            "it runs the eager step's iterations and every lane ends where the eager "
            "step's early exit leaves it"
        ),
        "flops_per_solve": round(flops, 0),
        "bytes_per_solve": None,
        "achieved_tflops": round(achieved / 1e12, 4),
        "mfu_pct_vs_bf16_peak": round(100.0 * achieved / peak_bf16, 3),
        "arithmetic_intensity_flop_per_byte": None,
        "roofline_ridge_flop_per_byte": round(peak_bf16 / PEAK_BYTES, 0),
        "flop_source": "analytic_estimate",
        "bytes_note": (
            "bytes_per_solve is null: the analytic estimate counts operations "
            "only, and torch has no cost analysis of the step"
        ),
        "mfu_note": (
            "against the H100's dense bf16 tensor-core peak (989 TFLOP/s, 700 W); "
            "the solver runs float32 on the CUDA cores (67 TFLOP/s) with TF32 "
            "off, in 17 x 17 blocks, and the captured step is a graph of thousands "
            "of small kernels"
        ),
        "ipm_budget_mode": wl.budget_mode,
        "horizon_N": wl.solver.N,
        "variance_note": (
            "the captured step is device-bound, the eager step (the stage "
            "breakdown) host-bound on a shared host, whose stages move 10-50% "
            "between runs with no code change; compare configurations only "
            "within one run, in alternating pairs"
        ),
        "gpu_name": name,
        "power_limit_w": limit_w,
        "tube_precision": tube_prec(),
        "kkt": wl.solver.opts.ipm.kkt,
        "response": wl.response,
        "sls_block": wl.sls_block,
        "kernel_launches": launches,
        "kernel_launches_per_step": launches_per_step,
        "kernel_launches_note": (
            "launches in the timed window's replays: those outside the IPM loops once a "
            "replay (counted by the wrappers at capture), those of an IPM iteration once "
            "an iteration (the WHILE nodes' device counters)"
        ),
        "eager_check": eager_check,
        "soft_fallback_lanes": wl.n_soft_fallback,
        "single_step_latency_steps": len(lats),
    }


def run(wl: BenchWorkload | None = None, n_lat: int = 200):
    """Warm-in, the timed window and the B=1 rolling latency loop of n_lat
    steps (the reference's 200), all replays of the step captured as one
    CUDA graph (at B and at B = 1), then the captured K = 1 and K = 8 step
    programs at B = 1 for on_device_step_ms. The eager step is run once
    from the carry and w of the last timed replay and must give the same
    success and QP iterations on every lane. Returns the result record (the
    JSON line's fields) and the final batch carry."""
    from robust_nonlinear_mpc_torch.sim.closed_loop import capture_mpc_step

    require_cuda()
    if wl is None:
        wl = build_workload()
    step = capture_mpc_step(wl.solver, wl.carry)
    carry = wl.carry
    n_warm = max(1, wl.n_warm)
    for i in range(n_warm):
        carry, out = step(carry, wl.w_seq[i])
    torch.cuda.synchronize()
    launched = step.launched()

    t0 = time.perf_counter()
    for i in range(wl.n_rep):
        if i == wl.n_rep - 1:
            last_in = tree_map(torch.clone, carry)
        carry, out = step(carry, wl.w_seq[n_warm + i])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = dict(step.launched() - launched)
    finite = bool(torch.isfinite(carry[0]).all() and torch.isfinite(carry[3]).all())
    ok, qp_iters = out[6].clone(), out[7].clone()
    _, eager = wl.mpc_step(last_in, wl.w_seq[n_warm + wl.n_rep - 1])
    eager_check = {
        "success_equal": bool(torch.equal(eager[6], ok)),
        "qp_iters_equal": bool(torch.equal(eager[7], qp_iters)),
        "eager_mean_qp_iters": round(float(eager[7].float().mean()), 2),
        "max_abs_diff_X": float((eager[2] - out[2]).abs().max()),
    }
    del last_in, eager

    # single-instance rolling closed loop (B = 1) from the cold seed of lane 0
    rngl = np.random.default_rng(7)
    nw = wl.m.nw
    w_rand = lambda *s: torch.as_tensor(2 * rngl.random(s) - 1, dtype=wl.dtype, device=wl.device)
    c1 = _lane0(wl.carry)
    step1 = capture_mpc_step(wl.solver, c1)
    c1, _ = step1(c1, w_rand(1, nw))
    torch.cuda.synchronize()
    lats = []
    for _ in range(n_lat):
        w = w_rand(1, nw)
        ts = time.perf_counter()
        c1, _ = step1(c1, w)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - ts)

    # on-device step time: captured K = 1 and K = 8 step programs from the
    # latency loop's carry (the JAX bench's K-step scan regression)
    walls, _ = k_step_walls(wl.solver, c1, lambda K: w_rand(1, nw) if K == 1 else w_rand(K, 1, nw))

    name, limit_w, _ = gpu_identity()
    record = make_record(
        wl, solves_per_s=wl.B * wl.n_rep / (t1 - t0), ok=ok, qp_iters=qp_iters,
        finite=finite, lats=lats, launches=launches,
        gpu=(torch.cuda.get_device_name(wl.device), name, limit_w), walls=walls,
        launches_per_step={k: v / wl.n_rep for k, v in launches.items()},
        eager_check=eager_check,
    )
    return record, carry


KKTS = ("fused", "fused_iter", "riccati")


def parse_args(argv=None):
    """The JAX bench's configuration, as options: `--N` (its RNM_BENCH_N),
    `--batch` (RNM_BENCH_BATCH), `--kkt` (RNM_BENCH_KKT), `--response`
    (RNM_BENCH_STREAMING) and `--sls-block` (RNM_SLS_BLOCK), each passed
    to `build_workload`; the defaults are its benchmarked configuration."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--N", type=int, default=15, help="MPC horizon")
    p.add_argument("--batch", type=int, default=512, help="lanes stepped at once")
    p.add_argument("--kkt", default="fused", choices=KKTS, help="the IPM's Newton path")
    p.add_argument("--response", default="streaming", choices=RESPONSES)
    p.add_argument("--sls-block", type=int, default=0, dest="sls_block",
                   help="SLS kernels: 0 folded, > 0 column-blocked, -1 the backward kernel")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    require_cuda()
    wl = build_workload(N=args.N, B=args.batch, kkt=args.kkt, response=args.response,
                        sls_block=args.sls_block)
    record, _ = run(wl)
    print(json.dumps(record))


if __name__ == "__main__":
    main()

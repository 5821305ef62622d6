"""Standalone timing of the hand-written SLS backward kernel on the GPU
(the counterpart of `robust_nonlinear_mpc_tpu/tools/pallas_bwd_bench.py`).

Compares `ops/fused_backward.backward_K` with the column-blocked torch
backward (`backward_solve_blocked`, block 2) on the same inputs: B = 512,
N = 15, nx = 17, nu = 4, ni = 42, ni_f = 34, made with numpy from seed 0,
float32. Prints both times (CUDA events over 20 calls after a warm-up, the
kernel timed through its wrapper), the relative error of the gains and the
card's name and power limit. `--pieces` times the curvature prologue the
torch backward runs as GEMMs (C = G' diag(eta) G for every stage and
column), which the kernel builds inside instead.

`--pairs` decides between the torch SLS kernels' two segmentations,
folded (`sls_block` 0) and column-blocked (2), in alternating pairs,
folded, blocked, blocked, folded, ...: the backward and the streaming
response on the tool's inputs (per call: CUDA events over 20 calls, what
the step waits for, and the device time from torch.profiler), then the
bench twin (`robust_nonlinear_mpc_torch.bench`, B = 512, float32) from one
SQP seed (solves/s, its stage breakdown, device time per step). Writes
chiprun_out/sls_block_pairs.json.

Usage, on the card:
  python -m robust_nonlinear_mpc_torch.tools.fused_bwd_bench [--pieces | --pairs]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from robust_nonlinear_mpc_torch import bench
from robust_nonlinear_mpc_torch.bench import cuda_ms, gpu_identity, require_cuda
from robust_nonlinear_mpc_torch.ops.fused_backward import backward_K
from robust_nonlinear_mpc_torch.ops.sls_kernels import SLSRegs, backward_solve_blocked
from robust_nonlinear_mpc_torch.solvers.fast_sls import select_sls_kernels

SHAPE = dict(Bc=512, N=15, nx=17, nu=4, ni=42, ni_f=34)
REPS = 20


def inputs(Bc, N, nx, nu, ni, ni_f, device, dtype=torch.float32, seed=0):
    """The tool's inputs (those of the TPU tool): stable dynamics, random
    constraint blocks, eta zero above the stage (j > k)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    A = 0.95 * np.eye(nx) + 0.02 * rng.standard_normal((Bc, N, nx, nx))
    B = 0.1 * rng.standard_normal((Bc, N, nx, nu))
    G = rng.standard_normal((ni, nx + nu))
    Gf = rng.standard_normal((ni_f, nx))
    eta = np.abs(rng.standard_normal((Bc, N, N, ni)))
    for k in range(N):
        eta[:, k, k + 1:] = 0.0
    eta_f = np.abs(rng.standard_normal((Bc, N + 1, ni_f)))
    regs = SLSRegs(t(np.eye(nx) * 2.0), t(np.eye(nu) * 1.5), t(np.eye(nx) * 3.0))
    return t(A), t(B), t(G), t(Gf), t(eta), t(eta_f), regs


def main():
    """K3 against the blocked torch backward; prints one line and returns
    {"kernel_ms", "blocked_ms", "rel_err", "gpu"}."""
    require_cuda()
    args = inputs(**SHAPE, device="cuda")
    blocked = lambda: backward_solve_blocked(*args, block=2)[1]
    kernel = lambda: backward_K(*args)
    K_b, K_k = blocked(), kernel()
    torch.cuda.synchronize()
    err = float((K_b - K_k).abs().max() / K_b.abs().max())
    t_b1, t_k1, t_k2, t_b2 = (cuda_ms(f, REPS) for f in (blocked, kernel, kernel, blocked))
    t_b, t_k = min(t_b1, t_b2), min(t_k1, t_k2)
    gpu = gpu_identity()[2]
    print(f"torch blocked(2): {t_b:.3f} ms   CUDA backward_K: {t_k:.3f} ms   "
          f"speedup {t_b / t_k:.2f}x   rel err {err:.2e}   ({gpu})", flush=True)
    return {"kernel_ms": t_k, "blocked_ms": t_b, "rel_err": err, "gpu": gpu}


def profile_pieces():
    """Time the curvature prologue of the torch backward: Cxx, Cuu and the
    terminal matrices of every stage and column as three GEMMs."""
    require_cuda()
    Bc, N, nx, nu, ni, ni_f = (SHAPE[k] for k in ("Bc", "N", "nx", "nu", "ni", "ni_f"))
    A, B, G, Gf, eta, eta_f, _ = inputs(**SHAPE, device="cuda")
    Gx, Gu = G[:, :nx], G[:, nx:]
    GGx = (Gx[:, :, None] * Gx[:, None, :]).reshape(ni, nx * nx)
    GGu = (Gu[:, :, None] * Gu[:, None, :]).reshape(ni, nu * nu)
    GGf = (Gf[:, :, None] * Gf[:, None, :]).reshape(ni_f, nx * nx)
    eta_pad = torch.cat([eta, eta.new_zeros((Bc, N, 1, ni))], dim=2)
    prologue = lambda: (eta_pad @ GGx, eta_pad @ GGu, eta_f @ GGf)
    gemm = lambda: eta_pad @ GGx
    print(f"prologue (Cxx, Cuu, SN GEMMs): {cuda_ms(prologue, REPS):.3f} ms", flush=True)
    print(f"prologue (Cxx GEMM only):      {cuda_ms(gemm, REPS):.3f} ms", flush=True)


def device_ms(fn, n=REPS):
    """Device time (ms) of one call of `fn`: every CUDA kernel it launches,
    from torch.profiler over n calls after one call to warm up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3 / n


def pairs(n_stage=10, n_bench=4, out=Path("chiprun_out") / "sls_block_pairs.json"):
    """Folded (sls_block 0) against column-blocked (2) in alternating pairs:
    the stages on the tool's inputs, then the bench twin. Prints one line
    per run and returns the record it writes to `out`."""
    require_cuda()
    A, B, G, Gf, eta, eta_f, regs = inputs(**SHAPE, device="cuda")
    nx = SHAPE["nx"]
    E = torch.as_tensor(0.01 * np.random.default_rng(1).standard_normal((SHAPE["N"] + 1, nx, nx)),
                        dtype=A.dtype, device=A.device)
    K = backward_K(A, B, G, Gf, eta, eta_f, regs)
    calls = {}
    for block in (0, 2):
        bwd, resp = select_sls_kernels(block)
        calls[block] = {
            "backward": lambda bwd=bwd: bwd(A, B, G, Gf, eta, eta_f, regs),
            "response": lambda resp=resp: resp(A, B, E, K, G[:, :nx], G[:, nx:], Gf, regs, 1e-10),
        }
    order = [0, 2, 2, 0] * ((n_stage + 1) // 2)
    stages = {name: {0: [], 2: []} for name in ("backward", "response")}
    for name in stages:
        for block in order[: 2 * n_stage]:
            stages[name][block].append(cuda_ms(calls[block][name], REPS))
        dev = {block: device_ms(calls[block][name]) for block in (0, 2)}
        ratio = [b / f for f, b in zip(stages[name][0], stages[name][2])]
        stages[name] = {"folded_ms": stages[name][0], "blocked_ms": stages[name][2],
                        "blocked_over_folded": ratio, "median_ratio": float(np.median(ratio)),
                        "device_ms": {"folded": dev[0], "blocked": dev[2]}}
        print(f"{name}: folded {np.median(stages[name]['folded_ms']):.3f} ms, blocked(2) "
              f"{np.median(stages[name]['blocked_ms']):.3f} ms per call (median of {n_stage}; "
              f"blocked faster in {sum(r < 1 for r in ratio)}/{n_stage} pairs); device "
              f"{dev[0]:.3f} / {dev[2]:.3f} ms", flush=True)

    wls = {0: bench.build_workload(sls_block=0)}
    wls[2] = bench.build_workload(sls_block=2, seed_from=wls[0])
    runs = {0: [], 2: []}
    for block in ([0, 2, 2, 0] * ((n_bench + 1) // 2))[: 2 * n_bench]:
        wl = wls[block]
        record, carry = bench.run(wl, n_lat=5)
        if record["success_fraction"] != 1.0 or not record["finite"]:
            raise SystemExit(f"bench twin sls_block={block}: success_fraction "
                             f"{record['success_fraction']}, finite {record['finite']}")
        st = bench.stage_breakdown(wl, carry, wl.w_seq[0])
        prof = bench.profile_kernels(wl, carry, wl.w_seq)
        runs[block].append({"solves_per_s": record["value"], "stages": st,
                            "device_ms_per_step": prof["device_kernel_ms"] / prof["steps"],
                            "mean_qp_iters": record["mean_qp_iters"]})
        print(f"bench sls_block={block}: {record['value']} solves/s, step {st['step']:.1f} ms, "
              f"backward {st['backward_riccati']:.2f} ms, response {st['response']:.2f} ms, "
              f"device {prof['device_kernel_ms'] / prof['steps']:.2f} ms/step", flush=True)
    ratio = [b["solves_per_s"] / f["solves_per_s"] for f, b in zip(runs[0], runs[2])]
    result = {"gpu": gpu_identity()[2], "shape": SHAPE, "stages": stages,
              "bench": {"folded": runs[0], "blocked": runs[2],
                        "blocked_over_folded_solves": ratio,
                        "median_ratio": float(np.median(ratio))}}
    print(f"bench: blocked/folded solves/s median {np.median(ratio):.3f} over {n_bench} pairs "
          f"({result['gpu']})", flush=True)
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    if "--pieces" in sys.argv:
        profile_pieces()
    elif "--pairs" in sys.argv:
        pairs()
    else:
        main()

"""Standalone timing of the SLS kernel variants at the bench shapes (port of
`robust_nonlinear_mpc_tpu/tools/kernel_bench.py`).

The JAX tool times the GEMM-folded SLS stages against the triangular
column-blocked ones at the rocket's widths (N = 15, nx = 17, nu = 4, ni =
42, ni_f = 34, nw = 17), float32. This one times the port's variants of the
same two stages on the inputs of `tools/kernel_times.py`
(`backward_inputs`, `response_inputs`, made with numpy from a seed):

* the backward Riccati: `bwd_folded` (`sls_kernels.backward_solve_folded`,
  the bench default), `bwd_blocked<b>` for each `--blocks` b, and
  `bwd_kernel`, the hand-written K3 (`ops/fused_backward.backward_K`);
* the streaming response: `resp_folded`, `resp_blocked<b>`, and
  `resp_kernel`, the hand-written K4 (`ops/fused_response.fused_response`,
  which also writes Phi).

Each variant's time is per call: the mean over `--reps` calls between CUDA
events (`bench.cuda_ms`, host gaps included, as the JAX tool's wall clock)
and the device time of every kernel it launches from torch.profiler
(`fused_bwd_bench.device_ms`).

Usage (needs the card; raises without one):
  python -m robust_nonlinear_mpc_torch.tools.kernel_bench [--batch 256]
      [--reps 30] [--blocks 8 4] [--variants bwd_folded resp_kernel ...]
Prints one JSON line with the GPU's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from robust_nonlinear_mpc_torch import bench
from robust_nonlinear_mpc_torch.ops import fused_backward, fused_response
from robust_nonlinear_mpc_torch.ops.sls_kernels import (
    SLSRegs,
    backward_solve_blocked,
    backward_solve_folded,
    response_streaming_blocked,
    response_streaming_folded,
)
from robust_nonlinear_mpc_torch.tools import fused_bwd_bench
from robust_nonlinear_mpc_torch.tools.kernel_times import NU, NX, backward_inputs, response_inputs

HORIZON = 15
EPS = 1e-10


def variants(B, blocks):
    """{name: call} of every variant at batch B."""
    A, Bm, G, Gf, eta, eta_f, regs = backward_inputs(B, HORIZON, NX, NU, torch.float32, "cuda",
                                                     seed=0)
    rA, rB, E, K, Gx, Gu, rGf, Qr, Rr, Qfr = response_inputs(B, HORIZON, "cuda", seed=0)
    rregs = SLSRegs(Qr, Rr, Qfr)
    out = {
        "bwd_folded": lambda: backward_solve_folded(A, Bm, G, Gf, eta, eta_f, regs)[1],
        "bwd_kernel": lambda: fused_backward.backward_K(A, Bm, G, Gf, eta, eta_f, regs),
        "resp_folded": lambda: response_streaming_folded(rA, rB, E, K, Gx, Gu, rGf, rregs, EPS),
        "resp_kernel": lambda: fused_response.fused_response(rA, rB, E, K, Gx, Gu, rGf, Qr, Rr,
                                                             Qfr, eps=EPS),
    }
    for b in blocks:
        out[f"bwd_blocked{b}"] = functools.partial(
            lambda b: backward_solve_blocked(A, Bm, G, Gf, eta, eta_f, regs, block=b)[1], b)
        out[f"resp_blocked{b}"] = functools.partial(
            lambda b: response_streaming_blocked(rA, rB, E, K, Gx, Gu, rGf, rregs, EPS, block=b), b)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--blocks", type=int, nargs="+", default=[8, 4])
    ap.add_argument("--variants", nargs="+", default=None)
    a = ap.parse_args(argv)
    bench.require_cuda()
    vs = variants(a.batch, a.blocks)
    only = set(a.variants or vs)
    if only - set(vs):
        raise SystemExit(f"unknown variants {sorted(only - set(vs))}; available: {sorted(vs)}")
    times, device = {}, {}
    for name, fn in vs.items():
        if name in only:
            times[name] = bench.cuda_ms(fn, a.reps)
            device[name] = fused_bwd_bench.device_ms(fn, a.reps)
    print(json.dumps({
        "metric": "sls_kernel_variants_ms", "batch": a.batch, "horizon": HORIZON,
        "reps": a.reps, "device": torch.cuda.get_device_name(0), "gpu": bench.gpu_identity()[2],
        "dtype": "float32", "times_ms": times, "device_ms": device,
    }), flush=True)


if __name__ == "__main__":
    main()

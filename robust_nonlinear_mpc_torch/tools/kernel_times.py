"""Device time of the Newton kernels (K1 `factor_predictor`, K2 `resolve`),
the whole-iteration kernel (K6 `ipm_iteration`), the SLS backward kernel (K3
`backward_K`) and the response kernel (K4 `fused_response`, float32 only)
at one shape, on the GPU, with the inputs that `chip_smoke.py` checks them
on.

A kernel's time is its device time from torch.profiler (CUDA activity
only) over CALLS = 30 calls of its wrapper, at B = 512, N = 15. The profiler's count of the kernel's records must
equal the wrapper's own launch counter over the window; a window in which
the profiler recorded fewer launches is measured again (at most
`MAX_WINDOWS` times), so every reported time is the mean over a window in
which each launch was recorded. `--windows W` also runs W windows of each
kernel with CPU and CUDA activity traced and W with CUDA activity only (the
timing's mode), and reports the launches each window recorded and, for
launches that run back to back, where in the window the missing ones were.

The kernels timed are those of the package first on the import path: run
by path with PYTHONPATH set to another checkout's root, the tool times that
checkout's kernels on the same inputs.

Usage, on the card:
  python -m robust_nonlinear_mpc_torch.tools.kernel_times [--dtype f32 f64] [--windows W]
Prints one JSON line (the card's name and power limit included).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from robust_nonlinear_mpc_torch.bench import gpu_identity
from robust_nonlinear_mpc_torch.ops import fused_backward, fused_qp, fused_response
from robust_nonlinear_mpc_torch.ops.qp_ipm import QPData, QPStatics, _curvature, _residuals
from robust_nonlinear_mpc_torch.tools import fused_bwd_bench

# the rocket's widths, and the main path's batch and horizon
NX, NU, NI, NI_F = 17, 4, 42, 34
BATCH, HORIZON = 512, 15
# calls of a wrapper in one profiler window
CALLS = 30
MAX_WINDOWS = 5
DTYPES = {"f32": torch.float32, "f64": torch.float64}


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


def ipm_inputs(Bsz, N, dtype, device, seed, nx=NX, nu=NU, ni=NI, ni_f=NI_F):
    """Arguments of one whole IPM iteration (`fused_qp.ipm_iteration`): a
    random problem, an interior iterate and its residuals, made with numpy.
    Lane 1 is marked done; lane 2 has an infinite dynamics offset, so its
    step is reverted."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    stat = QPStatics(
        Hx=t(2 * np.eye(nx)), Hu=t(2 * np.eye(nu)), HxN=t(6 * np.eye(nx)),
        Gx=t(rng.standard_normal((ni, nx))), Gu=t(rng.standard_normal((ni, nu))),
        Gf=t(rng.standard_normal((ni_f, nx))),
    ).per_stage(N)
    c = 0.01 * rng.standard_normal((Bsz, N, nx))
    h = 4.0 + np.abs(rng.standard_normal((Bsz, N, ni)))
    hf = 4.0 + np.abs(rng.standard_normal((Bsz, ni_f)))
    scale_p = 1.0 + np.abs(np.concatenate([c.reshape(Bsz, -1), h.reshape(Bsz, -1), hf], 1)).max(1)
    data = QPData(
        A=t(0.9 * np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx))),
        B=t(0.2 * rng.standard_normal((Bsz, N, nx, nu))), c=t(c),
        qx=t(0.1 * rng.standard_normal((Bsz, N + 1, nx))),
        qu=t(0.1 * rng.standard_normal((Bsz, N, nu))), h=t(h), hf=t(hf), xinit=None,
    )
    it = [t(0.3 * rng.standard_normal((Bsz, N + 1, nx))), t(0.3 * rng.standard_normal((Bsz, N, nu))),
          t(0.5 + np.abs(rng.standard_normal((Bsz, N, ni)))),
          t(0.5 + np.abs(rng.standard_normal((Bsz, N, ni)))),
          t(0.5 + np.abs(rng.standard_normal((Bsz, ni_f)))),
          t(0.5 + np.abs(rng.standard_normal((Bsz, ni_f)))),
          t(0.1 * rng.standard_normal((Bsz, N, nx)))]
    req, rineq, rineq_f, rx, rxN, ru = _residuals(stat, data, *it)
    rx_pad = torch.cat([torch.zeros_like(rx[:, :1]), rx], dim=1)
    done = torch.zeros(Bsz, dtype=torch.bool, device=device)
    if Bsz >= 3:
        done[1] = True
        data.c[2, 0, 0] = float("inf")
    X, U, lam, s, lam_f, s_f, nu_dyn = it
    args = [data.A, data.B, data.c, data.qx, data.qu, data.h, data.hf, stat.Gx, stat.Gu,
            stat.Gf, stat.Hx, stat.Hu, stat.HxN, lam / s, lam_f / s_f, *it,
            req, rineq, rineq_f, rx_pad, rxN, ru, t(scale_p), done]
    return args, dict(tau=0.995, n_comp=N * ni + ni_f)


def backward_inputs(Bsz, N, nx, nu, dtype, device, seed):
    """Arguments of the SLS backward kernel (`fused_backward.backward_K`):
    `fused_bwd_bench.inputs` with ni = 2 (nx + nu), ni_f = 2 nx (the rocket's
    42 and 34)."""
    return fused_bwd_bench.inputs(Bsz, N, nx, nu, 2 * (nx + nu), 2 * nx, device, dtype,
                                  seed=seed)


def response_inputs(Bsz, N, device, seed, nx=NX, nu=NU, nw=None, ni=None, ni_f=None):
    """Arguments of the fused response (float32), made with numpy: random
    stable dynamics, gains with zero columns j > k, random constraint blocks
    (nw = nx, ni = 2 (nx + nu), ni_f = 2 nx unless given)."""
    nw = nx if nw is None else nw
    ni = 2 * (nx + nu) if ni is None else ni
    ni_f = 2 * nx if ni_f is None else ni_f
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    K = 0.05 * rng.standard_normal((Bsz, N, N + 1, nu, nx))
    K *= (np.arange(N + 1)[None, :] <= np.arange(N)[:, None])[None, :, :, None, None]
    return [t(0.9 * np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx))),
            t(0.2 * rng.standard_normal((Bsz, N, nx, nu))),
            t(0.01 * rng.standard_normal((N + 1, nx, nw))), t(K),
            t(rng.standard_normal((ni, nx))), t(rng.standard_normal((ni, nu))),
            t(rng.standard_normal((ni_f, nx))), t(1e2 * np.eye(nx)), t(1e2 * np.eye(nu)),
            t(1e2 * np.eye(nx))]


def profile_window(fn, symbol, n, cpu=False):
    """n calls of `fn` under torch.profiler. Returns (the kernel records'
    device time in ms, the records seen, their start times in us)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events()
           if ev.device_type == DeviceType.CUDA and symbol in ev.name]
    total = sum(ev.time_range.elapsed_us() for ev in evs) / 1e3
    return total, len(evs), sorted(ev.time_range.start for ev in evs)


def device_ms(fn, symbol, n, counter=None):
    """Mean device time (ms) of one launch of the kernel named `symbol`, over
    n calls of its wrapper `fn` in one profiler window in which every launch
    was recorded. `counter()` is the wrapper's launch count: the launches
    made in the window must equal n and the records seen. A window with
    fewer records is measured again; after MAX_WINDOWS such windows this
    raises."""
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(MAX_WINDOWS):
        before = counter() if counter else None
        total, count, _ = profile_window(fn, symbol, n)
        if counter and counter() - before != n:
            raise RuntimeError(f"{symbol}: the wrapper launched {counter() - before} times, "
                               f"expected {n}")
        seen.append(count)
        if count == n:
            return total / n, seen
        if count > n:
            break
    raise RuntimeError(f"the profiler recorded {seen} launches of {symbol} in "
                       f"{len(seen)} windows of {n}")


def missing_positions(starts, n):
    """Where in a window of n back-to-back launches the unrecorded ones were
    (0 = the first call), from the gaps between the recorded start times."""
    if len(starts) < 2 or len(starts) == n:
        return []
    gaps = np.diff(np.asarray(starts))
    step = float(gaps.min())
    pos, at = [], 0
    for g in gaps:
        k = int(round(g / step)) - 1 if step > 0 else 0
        pos.extend(range(at + 1, at + 1 + k))
        at += 1 + k
    return pos


def kernels(Bsz, N, dtype):
    """{name: (wrapper call, kernel symbol, launch counter)} at (Bsz, N)."""
    mats, rhs, rhs2 = newton_inputs(Bsz, N, NX, NU, dtype, "cuda", seed=1)
    A, B = mats[0], mats[1]
    fact = fused_qp.factor_predictor(*mats, *rhs)[3]
    args, kw = ipm_inputs(Bsz, N, dtype, "cuda", seed=2)
    bargs = backward_inputs(Bsz, N, NX, NU, dtype, "cuda", seed=2)
    out = {
        "factor_predictor": (lambda: fused_qp.factor_predictor(*mats, *rhs),
                             "factor_predictor_kernel", lambda: fused_qp.factor_predictor.launches),
        "resolve": (lambda: fused_qp.resolve(A, B, fact, *rhs2), "resolve_kernel",
                    lambda: fused_qp.resolve.launches),
        "ipm_iteration": (lambda: fused_qp.ipm_iteration(*args, **kw), "ipm_iter_kernel",
                          lambda: fused_qp.ipm_iteration.launches),
        "backward_K": (lambda: fused_backward.backward_K(*bargs), "backward_K_kernel",
                       lambda: fused_backward.backward_K.launches),
    }
    if dtype == torch.float32:   # the response kernel is float32 only
        rargs = response_inputs(Bsz, N, "cuda", seed=2)
        out["fused_response"] = (lambda: fused_response.fused_response(*rargs),
                                 "response_kernel", lambda: fused_response.fused_response.launches)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", nargs="+", default=["f32", "f64"], choices=sorted(DTYPES))
    ap.add_argument("--windows", type=int, default=0)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times needs an NVIDIA GPU")
    out = {"device": gpu_identity()[2], "batch": BATCH, "horizon": HORIZON, "calls": CALLS,
           "ms": {}, "windows_seen": {}}
    for name in a.dtype:
        ks = kernels(BATCH, HORIZON, DTYPES[name])
        out["ms"][name] = {}
        out["windows_seen"][name] = {}
        for k, (fn, symbol, counter) in ks.items():
            ms, seen = device_ms(fn, symbol, CALLS, counter)
            out["ms"][name][k] = ms
            out["windows_seen"][name][k] = seen
        if a.windows > 0:
            out.setdefault("windows", {})[name] = diag = {}
            for k, (fn, symbol, counter) in ks.items():
                for mode, cpu in (("cpu+cuda", True), ("cuda", False)):
                    rows = []
                    for _ in range(a.windows):
                        total, count, starts = profile_window(fn, symbol, CALLS, cpu)
                        rows.append({"seen": count, "ms": total / max(count, 1),
                                     "missing_at": missing_positions(starts, CALLS)})
                    diag[f"{k} {mode}"] = rows
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()

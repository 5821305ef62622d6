"""ctypes bindings to the native C++ QP solver (`rnm_qp.cpp`, a copy of the
JAX package's source): a Mehrotra interior point whose Newton step is a
Riccati factorization over the horizon, on the host CPU, for one QP at a
time. It is the front end's `backend="native"` and an independent oracle
for the torch IPM.

The shared library is built with g++ at first use into
`build/robust_nonlinear_mpc_torch/native/` next to the package (and again
when the source is newer). A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "rnm_qp.cpp"
BUILD_DIR = _SRC.parent.parent.parent / "build" / "robust_nonlinear_mpc_torch" / "native"
_LIB = BUILD_DIR / "librnm_qp.so"

_lib = None


def _build():
    """Compile into a temporary file and rename it into place, so that
    processes building at the same time never load a partial library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", tmp, str(_SRC)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building {_SRC.name} failed:\n{r.stderr}")
        os.replace(tmp, _LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load():
    """Load (building if needed) the native library. Returns the ctypes lib."""
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(_LIB))
    d = ctypes.POINTER(ctypes.c_double)
    lib.rnm_qp_solve.restype = ctypes.c_int
    lib.rnm_qp_solve.argtypes = (
        [ctypes.c_int] * 5
        + [d] * 14
        + [ctypes.c_int, ctypes.c_double]
        + [d] * 6
    )
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads here (for a test's skip)."""
    try:
        load()
        return True
    except Exception:
        return False


def _arr(a):
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def qp_solve_native(stat, data, max_iter=50, tol=1e-9):
    """Solve one QP (a `QPData` batch of one) with the native solver.

    `stat` must hold time-invariant (2-D) statics. Returns a dict of NumPy
    arrays and numbers: X, U, lam, lam_f, nu_dyn, cost, kkt_res, iters,
    success, status.
    """
    from robust_nonlinear_mpc_torch.ops.qp_export import one_qp

    lib = load()
    data = one_qp(data)
    Gx = stat.Gx
    if Gx.dim() != 2:
        raise ValueError("the native backend takes time-invariant (2-D) statics")
    N, nx = data.c.shape
    nu = data.B.shape[2]
    ni = Gx.shape[0]
    ni_f = stat.Gf.shape[0]

    ins = [
        _arr(data.A), _arr(data.B), _arr(data.c),
        _arr(stat.Hx), _arr(stat.Hu), _arr(stat.HxN),
        _arr(stat.Gx), _arr(stat.Gu), _arr(stat.Gf),
        _arr(data.qx), _arr(data.qu), _arr(data.h), _arr(data.hf),
        _arr(data.xinit),
    ]
    # the C function trusts these sizes: check every buffer before passing it
    shapes = [(N, nx, nx), (N, nx, nu), (N, nx), (nx, nx), (nu, nu), (nx, nx), (ni, nx),
              (ni, nu), (ni_f, nx), (N + 1, nx), (N, nu), (N, ni), (ni_f,), (nx,)]
    for (a, _), shape in zip(ins, shapes):
        if a.shape != shape:
            raise ValueError(f"native QP: an input of shape {a.shape} where {shape} is needed")
    outs = [_arr(np.zeros(s)) for s in
            ((N + 1, nx), (N, nu), (N, ni), (ni_f,), (N, nx), (3,))]
    status = lib.rnm_qp_solve(
        N, nx, nu, ni, ni_f,
        *[p for (_, p) in ins],
        int(max_iter), float(tol),
        *[p for (_, p) in outs],
    )
    X, U, lam, lam_f, nu_dyn, info = [a for (a, _) in outs]
    return {
        "X": X, "U": U, "lam": lam, "lam_f": lam_f, "nu_dyn": nu_dyn,
        "cost": float(info[2]), "kkt_res": float(info[0]),
        "iters": int(info[1]), "success": status == 0,
        "status": status,
    }

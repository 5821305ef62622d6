"""Fused IPM Newton solves: two hand-written CUDA kernels and their plain
torch twins. Counterpart of `robust_nonlinear_mpc_tpu/ops/pallas_qp.py`.

Per Mehrotra iteration the IPM (`ops/qp_ipm.py`, `IPMOptions(kkt="fused")`)
makes two Newton solves against one Riccati factorization:

  * `factor_predictor` replaces the Pallas `_factor_predictor_kernel`: the
    reverse stage loop computes the factors (K, Fxu', the symmetrized and
    trace-regularized Fuu, its closed-form blockwise-Schur inverse, the
    P_{k+1} sequence with per-stage symmetrization) together with the
    predictor's feedforward sweep, then the forward sweep gives
    (dX, dU, dnu).
  * `resolve` replaces the Pallas `_resolve_kernel`: the corrector's
    feedforward sweep against the cached factors, then the forward sweep.

Both wrappers are batch-leading and keep the JAX wrapper contract
(`_factor_predictor_batched`): outputs (dX, dU, dnu, fact) with
fact = (K (B,N,nu,nx), FxuT (B,N,nu,nx), Fuu_tri (B,N,nuu),
Fiv_tri (B,N,nuu), Pseq (B,N,nx,nx)), the triangles in `_tri(nu)` order.

Dispatch is by the tensors' device only: a CUDA tensor launches the kernel
(a failed build or launch raises), a CPU tensor runs the plain twin. The
kernels are built from `csrc/fused_qp.cu` with nvcc for sm_90a on first use,
into `build/robust_nonlinear_mpc_torch/` next to the package.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from robust_nonlinear_mpc_torch.ops.qp_ipm import _forward_sweep
from robust_nonlinear_mpc_torch.utils.numerics import mv, sym

MAX_NX = 32
MAX_NU = 4

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "fused_qp.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "robust_nonlinear_mpc_torch"


def _tri(nu):
    return [(u, v) for u in range(nu) for v in range(u, nu)]


# ----------------------------------------------------------------------
# plain torch twins (the CPU path, and the reference the kernels are held to)
# ----------------------------------------------------------------------
def _upper_sym(M):
    """Symmetric matrix from the upper triangle of M."""
    return torch.triu(M) + torch.triu(M, 1).transpose(-1, -2)


def _spd_inv_schur(H):
    """Inverse of a small SPD matrix by recursive 2-block Schur elimination,
    reading the upper triangle only (the Pallas `_spd_inv_slabs`)."""
    n = H.shape[-1]
    if n == 1:
        return 1.0 / H
    m = n // 2
    Ainv = _spd_inv_schur(H[..., :m, :m])
    H12 = H[..., :m, m:]
    W = Ainv @ H12
    Sinv = _spd_inv_schur(_upper_sym(H[..., m:, m:] - H12.transpose(-1, -2) @ W))
    WS = W @ Sinv
    top = torch.cat([Ainv + WS @ W.transpose(-1, -2), -WS], dim=-1)
    bottom = torch.cat([-WS.transpose(-1, -2), Sinv], dim=-1)
    return _upper_sym(torch.cat([top, bottom], dim=-2))


def _refined(Hc, Fiv, rhs):
    """x = Hc^{-1} rhs from the explicit inverse plus one refinement pass."""
    x0 = Fiv @ rhs
    return x0 + Fiv @ (rhs - Hc @ x0)


def _pack_tri(M, nu):
    iu, iv = zip(*_tri(nu))
    return M[..., list(iu), list(iv)]


def _unpack_tri(t, nu):
    M = t.new_zeros(t.shape[:-1] + (nu, nu))
    for i, (u, v) in enumerate(_tri(nu)):
        M[..., u, v] = t[..., i]
        M[..., v, u] = t[..., i]
    return M


def _plain_factor_predictor(A, B, Cxx, Cuu, Cxu, PN, rbx, rbxN, rbu, req):
    N, nx, nu = A.shape[1], A.shape[2], B.shape[3]
    eye = torch.eye(nu, dtype=A.dtype, device=A.device)
    P, p = PN, rbxN
    K, FxuT, Hc, Fiv, Pseq, kff, pn = ([None] * N for _ in range(7))
    for k in reversed(range(N)):
        Ak, Bk = A[:, k], B[:, k]
        At, Bt = Ak.transpose(-1, -2), Bk.transpose(-1, -2)
        Pseq[k], pn[k] = P, p
        PA = P @ Ak
        PB = P @ Bk
        Fxx = Cxx[:, k] + At @ PA
        FxuT[k] = Cxu[:, k].transpose(-1, -2) + Bt @ PA
        Fuu = Cuu[:, k] + Bt @ PB
        w = p + mv(P, req[:, k])
        f_u = rbu[:, k] + mv(Bt, w)
        tr = torch.diagonal(Fuu, dim1=-2, dim2=-1).sum(-1)
        Hc[k] = sym(Fuu) + (1e-14 * tr)[:, None, None] * eye
        Fiv[k] = _spd_inv_schur(Hc[k])
        sol = -_refined(Hc[k], Fiv[k], torch.cat([FxuT[k], f_u[..., None]], dim=-1))
        K[k], kff[k] = sol[..., :nx], sol[..., nx]
        Fxu = FxuT[k].transpose(-1, -2)
        P = sym(Fxx + Fxu @ K[k])
        p = rbx[:, k] + mv(At, w) + mv(Fxu, kff[k])
    K, FxuT, Hc, Fiv, Pseq, kff, pn = (
        torch.stack(t, dim=1) for t in (K, FxuT, Hc, Fiv, Pseq, kff, pn)
    )
    dX, dU, dnu = _forward_sweep(A, B, K, kff, req, Pseq, pn)
    fact = (K, FxuT, _pack_tri(Hc, nu), _pack_tri(Fiv, nu), Pseq)
    return dX, dU, dnu, fact


def _plain_resolve(A, B, fact, rbx, rbxN, rbu, req):
    K, FxuT, Fuu_tri, Fiv_tri, Pseq = fact
    N, nu = A.shape[1], B.shape[3]
    Hc, Fiv = _unpack_tri(Fuu_tri, nu), _unpack_tri(Fiv_tri, nu)
    p = rbxN
    kff, pn = [None] * N, [None] * N
    for k in reversed(range(N)):
        pn[k] = p
        w = p + mv(Pseq[:, k], req[:, k])
        f_u = rbu[:, k] + mv(B[:, k].transpose(-1, -2), w)
        kff[k] = -_refined(Hc[:, k], Fiv[:, k], f_u[..., None])[..., 0]
        p = rbx[:, k] + mv(A[:, k].transpose(-1, -2), w) + mv(
            FxuT[:, k].transpose(-1, -2), kff[k]
        )
    return _forward_sweep(
        A, B, K, torch.stack(kff, dim=1), req, Pseq, torch.stack(pn, dim=1)
    )


# ----------------------------------------------------------------------
# the CUDA library
# ----------------------------------------------------------------------
_LIB = None


def build_extension(verbose: bool = False):
    """Compile `csrc/fused_qp.cu` for sm_90a (once per process) and bind its
    plain C interface with ctypes. Raises if the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(
        name="rnm_fused_qp",
        sources=[str(SOURCE)],
        build_directory=str(BUILD_DIR),
        extra_cuda_cflags=[
            "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
            "-Xptxas=-v",
        ],
        is_python_module=False,
        verbose=verbose,
    )
    lib = ctypes.CDLL(path)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"rnm_factor_predictor_{suffix}")
        fn.argtypes = [ptr] * 20 + [i32] * 4 + [ptr]
        fn.restype = i32
        fn = getattr(lib, f"rnm_resolve_{suffix}")
        fn.argtypes = [ptr] * 16 + [i32] * 4 + [ptr]
        fn.restype = i32
    lib.rnm_error_string.argtypes = [i32]
    lib.rnm_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def _suffix(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"fused Newton kernels take float32 or float64, got {dtype}")


def _check(name, t, shape, like):
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(
            f"{name}: expected {like.dtype} on {like.device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.contiguous()


def _dims(A, B):
    if A.dim() != 4 or B.dim() != 4:
        raise ValueError("A and B must be batch-leading (B, N, nx, nx) / (B, N, nx, nu)")
    Bsz, N, nx, _ = A.shape
    nu = B.shape[3]
    if not (1 <= nx <= MAX_NX and 1 <= nu <= MAX_NU):
        raise ValueError(
            f"fused Newton kernels support nx <= {MAX_NX} and nu <= {MAX_NU}, "
            f"got nx={nx}, nu={nu}"
        )
    return Bsz, N, nx, nu


def _launch(fn_name, args, ints, device):
    lib = build_extension()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*[a.data_ptr() for a in args], *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: {lib.rnm_error_string(err).decode()}")


def factor_predictor(A, B, Cxx, Cuu, Cxu, PN, rbx, rbxN, rbu, req):
    """Riccati factorization + predictor Newton solve, batch-leading.
    Returns (dX (B,N+1,nx), dU (B,N,nu), dnu (B,N,nx), fact)."""
    if A.device.type == "cpu":
        return _plain_factor_predictor(A, B, Cxx, Cuu, Cxu, PN, rbx, rbxN, rbu, req)
    if A.device.type != "cuda":
        raise ValueError(f"factor_predictor: unsupported device {A.device}")
    Bsz, N, nx, nu = _dims(A, B)
    fn = f"rnm_factor_predictor_{_suffix(A.dtype)}"
    ins = [
        _check("A", A, (Bsz, N, nx, nx), A),
        _check("B", B, (Bsz, N, nx, nu), A),
        _check("Cxx", Cxx, (Bsz, N, nx, nx), A),
        _check("Cuu", Cuu, (Bsz, N, nu, nu), A),
        _check("Cxu", Cxu, (Bsz, N, nx, nu), A),
        _check("PN", PN, (Bsz, nx, nx), A),
        _check("rbx", rbx, (Bsz, N, nx), A),
        _check("rbxN", rbxN, (Bsz, nx), A),
        _check("rbu", rbu, (Bsz, N, nu), A),
        _check("req", req, (Bsz, N, nx), A),
    ]
    nuu = nu * (nu + 1) // 2
    new = lambda *s: torch.empty((Bsz,) + s, dtype=A.dtype, device=A.device)
    dX, dU, dnu = new(N + 1, nx), new(N, nu), new(N, nx)
    K, FxuT = new(N, nu, nx), new(N, nu, nx)
    Fuu_tri, Fiv_tri, Pseq = new(N, nuu), new(N, nuu), new(N, nx, nx)
    kff, pn = new(N, nu), new(N, nx)
    if Bsz > 0:
        _launch(fn, ins + [dX, dU, dnu, K, FxuT, Fuu_tri, Fiv_tri, Pseq, kff, pn],
                (Bsz, N, nx, nu), A.device)
        factor_predictor.launches += 1
    return dX, dU, dnu, (K, FxuT, Fuu_tri, Fiv_tri, Pseq)


factor_predictor.launches = 0


def resolve(A, B, fact, rbx, rbxN, rbu, req):
    """Corrector Newton solve against the cached factors of
    `factor_predictor`. Returns (dX, dU, dnu)."""
    if A.device.type == "cpu":
        return _plain_resolve(A, B, fact, rbx, rbxN, rbu, req)
    if A.device.type != "cuda":
        raise ValueError(f"resolve: unsupported device {A.device}")
    Bsz, N, nx, nu = _dims(A, B)
    nuu = nu * (nu + 1) // 2
    K, FxuT, Fuu_tri, Fiv_tri, Pseq = fact
    fn = f"rnm_resolve_{_suffix(A.dtype)}"
    ins = [
        _check("A", A, (Bsz, N, nx, nx), A),
        _check("B", B, (Bsz, N, nx, nu), A),
        _check("K", K, (Bsz, N, nu, nx), A),
        _check("FxuT", FxuT, (Bsz, N, nu, nx), A),
        _check("Fuu_tri", Fuu_tri, (Bsz, N, nuu), A),
        _check("Fiv_tri", Fiv_tri, (Bsz, N, nuu), A),
        _check("Pseq", Pseq, (Bsz, N, nx, nx), A),
        _check("rbx", rbx, (Bsz, N, nx), A),
        _check("rbxN", rbxN, (Bsz, nx), A),
        _check("rbu", rbu, (Bsz, N, nu), A),
        _check("req", req, (Bsz, N, nx), A),
    ]
    new = lambda *s: torch.empty((Bsz,) + s, dtype=A.dtype, device=A.device)
    dX, dU, dnu = new(N + 1, nx), new(N, nu), new(N, nx)
    kff, pn = new(N, nu), new(N, nx)
    if Bsz > 0:
        _launch(fn, ins + [dX, dU, dnu, kff, pn], (Bsz, N, nx, nu), A.device)
        resolve.launches += 1
    return dX, dU, dnu


resolve.launches = 0


def reset_launch_counts():
    factor_predictor.launches = 0
    resolve.launches = 0


def launch_counts():
    return {"factor_predictor": factor_predictor.launches, "resolve": resolve.launches}

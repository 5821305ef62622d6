"""Numerical helpers shared across the solver stack (PyTorch port of
`robust_nonlinear_mpc_tpu/utils/numerics.py`).

Every solver matmul runs at the tensor's full precision by default: float32
matmuls do not drop to TF32 on the GPU (PyTorch's default, which the bench
asserts). Two switches, the JAX package's, relax that for two groups of
GEMMs only, each under a context that sets TF32 for its own call sites and
restores the process's setting after them:

* `set_tube_precision("default")`: the tube synthesis, i.e. fast-SLS's torch
  backward Riccati and response (`solvers/fast_sls.py`, `tube_precision()`);
* `set_qp_direction_precision("default")`: the IPM's Newton direction, i.e.
  the curvature Gram products, the torch Riccati factorization and sweeps,
  and the rhs assembly and step recovery (`ops/qp_ipm.py`,
  `qp_direction_precision()`).

"highest" (the default of both) leaves every GEMM in full precision. TF32 acts
on float32 CUDA matmuls only, so on the CPU, and in float64, "default" gives
the same bits as "highest". The IPM's residuals and termination tests, the
condensed Newton solve, and the hand-written kernels (K1/K2 `fused_qp.cu`,
K6 `fused_ipm.cu`, K3 `fused_backward.cu`, K4 `fused_response.cu`, which
compute in plain float32/float64 FMA and call no cuBLAS) are never reached
by either switch. A switch takes effect at the next call; a CUDA graph keeps
the mode it was captured with.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

_MODES = {"highest": False, "default": True}   # mode -> TF32 on
_TUBE_TF32 = False
_QP_DIR_TF32 = False


def set_tube_precision(mode: str) -> None:
    """Set the matmul precision of the SLS tube synthesis (backward Riccati,
    Phi propagation, backoffs, tube cost): "highest" (default) or "default"
    (TF32 float32 GEMMs on the GPU)."""
    global _TUBE_TF32
    _TUBE_TF32 = _MODES[mode]


def set_qp_direction_precision(mode: str) -> None:
    """Set the matmul precision of the IPM Newton direction (curvature,
    Riccati factorization and sweeps, rhs assembly, step recovery):
    "highest" (default) or "default" (TF32 float32 GEMMs on the GPU). The
    residuals and the convergence test stay in full precision, so an inexact
    direction can cost iterations, never correctness."""
    global _QP_DIR_TF32
    _QP_DIR_TF32 = _MODES[mode]


def tube_prec() -> str:
    return "default" if _TUBE_TF32 else "highest"


def qp_dir_prec() -> str:
    return "default" if _QP_DIR_TF32 else "highest"


def tf32_enabled() -> bool:
    """Whether float32 CUDA matmuls may use TF32 now (read through the API
    that sets it: torch refuses a read of the legacy flag after a write of
    the new one)."""
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        return m.fp32_precision == "tf32" or (
            m.fp32_precision == "none" and torch.backends.fp32_precision == "tf32")
    return bool(m.allow_tf32)


@contextmanager
def _tf32(on: bool):
    if not on:
        yield
        return
    m = torch.backends.cuda.matmul
    name, value = ("fp32_precision", "tf32") if hasattr(m, "fp32_precision") else ("allow_tf32", True)
    old = getattr(m, name)
    setattr(m, name, value)
    try:
        yield
    finally:
        setattr(m, name, old)


def tube_precision():
    """Context for the tube synthesis's GEMMs (see `set_tube_precision`)."""
    return _tf32(_TUBE_TF32)


def qp_direction_precision():
    """Context for the Newton direction's GEMMs (see
    `set_qp_direction_precision`)."""
    return _tf32(_QP_DIR_TF32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix (or batched-matrix) product."""
    return torch.matmul(a, b)


def mv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix-vector product over the trailing axes (batched)."""
    return torch.matmul(a, b.unsqueeze(-1)).squeeze(-1)


def sym(a: torch.Tensor) -> torch.Tensor:
    """Symmetrize over the two trailing axes."""
    return 0.5 * (a + a.transpose(-1, -2))


def _inv2(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 2x2 inverse."""
    a, b = M[..., 0, 0], M[..., 0, 1]
    c, d = M[..., 1, 0], M[..., 1, 1]
    det = a * d - b * c
    row0 = torch.stack([d, -b], dim=-1)
    row1 = torch.stack([-c, a], dim=-1)
    return torch.stack([row0, row1], dim=-2) / det[..., None, None]


def spd_solve_small(H: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """Solve H X = F for small SPD H: closed-form blockwise-Schur inverse for
    n <= 4 (n = 3 is padded to 4 with an identity corner), Cholesky above
    (NaN for a lane whose H is not positive definite)."""
    n = H.shape[-1]
    if n == 1:
        return F / H[..., :1, :1]
    if n == 2:
        return _inv2(H) @ F
    if n == 3:
        pad_H = H.new_zeros(H.shape[:-2] + (4, 4))
        pad_H[..., :3, :3] = H
        pad_H[..., 3, 3] = 1.0
        pad_F = F.new_zeros(F.shape[:-2] + (4,) + F.shape[-1:])
        pad_F[..., :3, :] = F
        return spd_solve_small(pad_H, pad_F)[..., :3, :]
    if n == 4:
        H11, H12 = H[..., :2, :2], H[..., :2, 2:]
        H21, H22 = H[..., 2:, :2], H[..., 2:, 2:]
        iH11 = _inv2(H11)
        Sc = H22 - H21 @ (iH11 @ H12)
        iSc = _inv2(Sc)
        iH11_H12 = iH11 @ H12
        H21_iH11 = H21 @ iH11
        TL = iH11 + iH11_H12 @ (iSc @ H21_iH11)
        TR = -(iH11_H12 @ iSc)
        BL = -(iSc @ H21_iH11)
        Hi = torch.cat(
            [torch.cat([TL, TR], dim=-1), torch.cat([BL, iSc], dim=-1)], dim=-2
        )
        return Hi @ F
    # a matrix that is not positive definite (or not finite) gives NaN for
    # its lane, as jnp.linalg.cholesky does, instead of raising for the batch
    L, info = torch.linalg.cholesky_ex(H)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    if L.is_cuda:
        # the two triangular solves of cholesky_solve, by cuBLAS's batched
        # trsm: on the card a batched cholesky_solve runs MAGMA, whose queue
        # allocates device memory and so cannot be captured in a CUDA graph
        Y = torch.linalg.solve_triangular(L, F, upper=False)
        return torch.linalg.solve_triangular(L.mT, Y, upper=True)
    return torch.cholesky_solve(F, L)


def spd_solve_refined(H: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """`spd_solve_small` plus one iterative-refinement step."""
    x0 = spd_solve_small(H, F)
    r = F - H @ x0
    return x0 + spd_solve_small(H, r)


def spd_inverse(H: torch.Tensor) -> torch.Tensor:
    """Batched explicit inverse of symmetric positive-definite matrices, for
    the condensed-KKT interior point (`ops/qp_ipm.py`), which polishes it by
    Newton-Schulz steps and refines each application against the exact
    matvec. The JAX package inverts by recursive 2x2 block Schur
    complements, a form that suits the TPU's matrix unit; here one batched
    Cholesky factorization and its inverse give the same matrix to rounding.
    A lane whose matrix is not positive definite (or not finite) gives NaN,
    as `jnp.linalg.cholesky` does, instead of raising for the batch."""
    L, info = torch.linalg.cholesky_ex(H)
    ok = (info == 0)[..., None, None]
    # a failed lane's partial factor may hold a zero pivot: invert I there
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return torch.where(ok, torch.cholesky_inverse(torch.where(ok, L, eye)), torch.nan)

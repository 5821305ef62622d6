"""Numerical helpers shared across the solver stack (PyTorch port of
`robust_nonlinear_mpc_tpu/utils/numerics.py`).

Every solver matmul runs at the tensor's full precision: float32 matmuls
must not drop to TF32 on the GPU (`torch.backends.cuda.matmul.allow_tf32`
stays False, which is PyTorch's default and is asserted by the bench). The
JAX package's reduced-precision switches (`set_tube_precision("default")`,
`set_qp_direction_precision("default")`) are not ported: the port always
runs the "highest" mode.
"""

from __future__ import annotations

import torch


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
    n <= 4 (n = 3 is padded to 4 with an identity corner), Cholesky above."""
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
    L = torch.linalg.cholesky(H)
    return torch.cholesky_solve(F, L)


def spd_solve_refined(H: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
    """`spd_solve_small` plus one iterative-refinement step."""
    x0 = spd_solve_small(H, F)
    r = F - H @ x0
    return x0 + spd_solve_small(H, r)

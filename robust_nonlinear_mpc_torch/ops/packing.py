"""Stage-wise packing (port of `robust_nonlinear_mpc_tpu/ops/packing.py`):
(X, U) -> y = [x0; u0; ...; x_{N-1}; u_{N-1}; xN], batched over leading dims."""

from __future__ import annotations

import torch


def pack_primal(X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """X (..., N+1, nx), U (..., N, nu) -> y (..., (nx+nu)N + nx)."""
    N = U.shape[-2]
    lead = U.shape[:-2]
    stages = torch.cat([X[..., :N, :], U], dim=-1).reshape(lead + (-1,))
    return torch.cat([stages, X[..., N, :]], dim=-1)

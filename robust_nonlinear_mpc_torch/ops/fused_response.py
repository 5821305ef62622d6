"""Fused system-response synthesis: one hand-written CUDA kernel and its
plain torch twin. Counterpart of `robust_nonlinear_mpc_tpu/ops/pallas_response.py`.

`fused_response` replaces the Pallas `_response_kernel`: the propagation of
Phi_x / Phi_u through A + B K, the backoff row norms and the tube cost in one
pass that writes Phi once (`FastSLSOptions(use_pallas_response=True)`).
Everything is float32 whatever the caller's dtype, as in the JAX package;
the caller casts the results back.

Batch-leading: A (B,N,nx,nx), B (B,N,nx,nu), K (B,N,N+1,nu,nx); E
(N+1,nx,nw), the constraint blocks Gx (ni,nx), Gu (ni,nu), Gf (ni_f,nx) and
the regularizers are shared. Returns (Phi_x (B,N+1,N+1,nx,nw),
Phi_u (B,N,N+1,nu,nw), beta (B,N,N,ni), beta_f (B,N+1,ni_f),
backoff (B,N,ni), backoff_f (B,ni_f), tube cost (B,)).

Dispatch is by the tensors' device only: a CUDA tensor launches the kernel
(`csrc/fused_response.cu`, nx, nw <= 32, nu <= 4, any N; a failed build or
launch raises), a CPU tensor runs the plain twin.
"""

from __future__ import annotations

import torch

from robust_nonlinear_mpc_torch.ops.cuda_lib import check, launch
from robust_nonlinear_mpc_torch.ops.sls_kernels import (
    SLSRegs,
    backoff_from_phi,
    propagate,
    tube_cost,
)

MAX_NX = 32
MAX_NU = 4
MAX_SMEM_BYTES = 227 * 1024


def _plain_fused_response(A, B, E, K, Gx, Gu, Gf, Q_reg, R_reg, Q_reg_f, eps=1e-10):
    """propagate + backoff_from_phi + tube_cost in float32."""
    A, B, E, K, Gx, Gu, Gf, Q_reg, R_reg, Q_reg_f = (
        t.to(torch.float32) for t in (A, B, E, K, Gx, Gu, Gf, Q_reg, R_reg, Q_reg_f)
    )
    Phi_x, Phi_u = propagate(A, B, E, K)
    beta, beta_f, backoff, backoff_f = backoff_from_phi(Phi_x, Phi_u, Gx, Gu, Gf, eps)
    tube = tube_cost(Phi_x, Phi_u, SLSRegs(Q_reg, R_reg, Q_reg_f))
    return Phi_x, Phi_u, beta, beta_f, backoff, backoff_f, tube


def smem_bytes(nx, nu, nw, ni, ni_f, warps=1):
    """Dynamic shared memory of one block of `warps` warps (the kernel's
    `RspLayout`, in float32, rows padded to 16 bytes): the block's stacked
    row blocks [Gx Gu; Q_reg 0; 0 R_reg] and [Gf; Q_reg_f] (rows padded to
    a multiple of 32) and 32 partial sums, and per warp two slots of
    [A_k B_k], K[k, j] and the column's [Phi_x; Phi_u] by disturbance.
    Nothing depends on N."""
    nxp = -(-nx // 4) * 4
    ld = nxp + 4
    rows = -(-(ni + nx + nu) // 32) * 32 + -(-(ni_f + nx) // 32) * 32
    return 4 * (rows * ld + 32 + warps * (2 * nx * ld + nu * nxp + nw * ld))


def fused_response(A, B, E, K, Gx, Gu, Gf, Q_reg, R_reg, Q_reg_f, eps=1e-10):
    """Propagation, backoffs and tube cost in one pass (float32 results)."""
    if A.device.type == "cpu":
        return _plain_fused_response(A, B, E, K, Gx, Gu, Gf, Q_reg, R_reg, Q_reg_f, eps)
    if A.device.type != "cuda":
        raise ValueError(f"fused_response: unsupported device {A.device}")
    if A.dim() != 4 or B.dim() != 4 or K.dim() != 5:
        raise ValueError("A, B and K must be batch-leading (B,N,nx,nx) / (B,N,nx,nu) / (B,N,N+1,nu,nx)")
    Bsz, N, nx, _ = A.shape
    nu, nw, ni, ni_f = B.shape[3], E.shape[2], Gx.shape[0], Gf.shape[0]
    if nx > MAX_NX or nw > MAX_NX or nu > MAX_NU:
        raise ValueError(f"fused_response: the kernel takes nx, nw <= {MAX_NX}, nu <= {MAX_NU}, "
                         f"got nx={nx}, nw={nw}, nu={nu}")
    if smem_bytes(nx, nu, nw, ni, ni_f) > MAX_SMEM_BYTES:
        raise ValueError(f"fused_response: nx={nx}, ni={ni}, ni_f={ni_f} need more than "
                         f"{MAX_SMEM_BYTES} bytes of shared memory per block")
    f32 = torch.float32
    shapes = {
        "A": (A, (Bsz, N, nx, nx)), "B": (B, (Bsz, N, nx, nu)), "E": (E, (N + 1, nx, nw)),
        "K": (K, (Bsz, N, N + 1, nu, nx)), "Gx": (Gx, (ni, nx)), "Gu": (Gu, (ni, nu)),
        "Gf": (Gf, (ni_f, nx)), "Q_reg": (Q_reg, (nx, nx)), "R_reg": (R_reg, (nu, nu)),
        "Q_reg_f": (Q_reg_f, (nx, nx)),
    }
    ins = [check(k, t.to(f32), shape, A, dtype=f32) for k, (t, shape) in shapes.items()]
    new = lambda *s: torch.empty((Bsz,) + s, dtype=f32, device=A.device)
    outs = [new(N + 1, N + 1, nx, nw), new(N, N + 1, nu, nw), new(N, N, ni),
            new(N + 1, ni_f), new(N, ni), new(ni_f), new()]
    if Bsz > 0:
        launch("rnm_fused_response_f32", ins + outs, (Bsz, N, nx, nu, nw, ni, ni_f, float(eps)),
               A.device)
        fused_response.launches += 1
    return tuple(outs)


fused_response.launches = 0


def reset_launch_counts():
    fused_response.launches = 0


def launch_counts():
    return {"fused_response": fused_response.launches}

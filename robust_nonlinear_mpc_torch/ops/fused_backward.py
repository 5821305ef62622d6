"""The SLS column-wise backward Riccati, gains only: one hand-written CUDA
kernel and its plain torch twin. Counterpart of
`robust_nonlinear_mpc_tpu/ops/pallas_sls.py`.

`backward_K` replaces the Pallas `_backward_kernel` (wrapper
`_backward_K_batched`), with its contract: A (B,N,nx,nx), B (B,N,nx,nu),
eta (B,N,N,ni) with no terminal column, eta_f (B,N+1,ni_f); the constraint
blocks Gmat (ni,nx+nu), Gf (ni_f,nx) and the regularizers are shared.
Returns K (B,N,N+1,nu,nx), the maths of `backward_solve_folded` (S is not
returned). `FastSLSOptions(sls_block=-1)` runs it.

Dispatch is by the tensors' device only: a CUDA tensor launches the kernel
(`csrc/fused_backward.cu`, float32 or float64, nx <= 32, nu <= 4; one block
of up to 8 warps a lane, one warp a column pair; a failed build or launch
raises), a CPU tensor runs the plain twin.
"""

from __future__ import annotations

import torch

from robust_nonlinear_mpc_torch.ops.cuda_lib import check, launch, suffix
from robust_nonlinear_mpc_torch.ops.sls_kernels import SLSRegs, backward_solve_folded

MAX_NX = 32
MAX_NU = 4
MAX_SMEM_BYTES = 227 * 1024


def _plain_backward_K(A, B, Gmat, Gf, eta, eta_f, regs: SLSRegs):
    """The kernel's maths in plain torch: the folded backward Riccati (its
    curvature by GEMM, S symmetrized at every stage), K only."""
    return backward_solve_folded(A, B, Gmat, Gf, eta, eta_f, regs)[1]


def smem_bytes(nx, nu, ni, ni_f, itemsize, warps=1):
    """Dynamic shared memory of one block of `warps` warps (the kernel's
    `BwdLayout`): rows padded to 16 bytes; the block's [Gx Gu] (with a tail),
    Gf, Q_reg and R_reg, and per warp [A_k B_k], the two-slot eta ring, S and
    the stage's Hessian columns."""
    nxp = -(-nx // 4) * 4
    ld, nep = nxp + 4, -(-max(ni, ni_f) // 4) * 4
    block = ni * ld + nxp + ni_f * nxp + nx * nxp + 16
    warp = nx * ld + 2 * nep + nx * nxp + (nx + nu) * ld
    return itemsize * (block + warps * warp)


def backward_K(A, B, Gmat, Gf, eta, eta_f, regs: SLSRegs):
    """Tube gains K (B, N, N+1, nu, nx) of the column-wise backward Riccati."""
    if A.device.type == "cpu":
        return _plain_backward_K(A, B, Gmat, Gf, eta, eta_f, regs)
    if A.device.type != "cuda":
        raise ValueError(f"backward_K: unsupported device {A.device}")
    if A.dim() != 4 or B.dim() != 4 or eta.dim() != 4 or eta_f.dim() != 3:
        raise ValueError("A, B, eta and eta_f must be batch-leading (B,N,nx,nx) / (B,N,nx,nu) "
                         "/ (B,N,N,ni) / (B,N+1,ni_f)")
    Bsz, N, nx, _ = A.shape
    nu, ni, ni_f = B.shape[3], Gmat.shape[0], Gf.shape[0]
    suffix(A.dtype)
    if nx > MAX_NX or nu > MAX_NU:
        raise ValueError(f"backward_K: the kernel takes nx <= {MAX_NX}, nu <= {MAX_NU}, "
                         f"got nx={nx}, nu={nu}")
    if smem_bytes(nx, nu, ni, ni_f, A.element_size()) > MAX_SMEM_BYTES:
        raise ValueError(f"backward_K: nx={nx}, ni={ni} need more than {MAX_SMEM_BYTES} bytes "
                         "of shared memory per block")
    shapes = {
        "A": (A, (Bsz, N, nx, nx)), "B": (B, (Bsz, N, nx, nu)),
        "Gx": (Gmat[:, :nx], (ni, nx)), "Gu": (Gmat[:, nx:], (ni, nu)), "Gf": (Gf, (ni_f, nx)),
        "eta": (eta, (Bsz, N, N, ni)), "eta_f": (eta_f, (Bsz, N + 1, ni_f)),
        "Q_reg": (regs.Q_reg, (nx, nx)), "R_reg": (regs.R_reg, (nu, nu)),
        "Q_reg_f": (regs.Q_reg_f, (nx, nx)),
    }
    ins = [check(k, t, shape, A) for k, (t, shape) in shapes.items()]
    K = torch.empty((Bsz, N, N + 1, nu, nx), dtype=A.dtype, device=A.device)
    if Bsz > 0:
        launch(f"rnm_backward_K_{suffix(A.dtype)}", ins + [K], (Bsz, N, nx, nu, ni, ni_f),
               A.device)
        backward_K.launches += 1
    return K


backward_K.launches = 0


def reset_launch_counts():
    backward_K.launches = 0


def launch_counts():
    return {"backward_K": backward_K.launches}

"""fast-SLS tube synthesis: dual extraction, the column-wise backward
Riccati and the Phi-free streaming response (port of the GEMM-folded forms in
`robust_nonlinear_mpc_tpu/ops/sls_kernels.py`).

Everything here is plain torch: the JAX package computes these stages with
XLA outside any Pallas kernel. Every function is batch-leading: A (B, N, nx,
nx), B (B, N, nx, nu), eta (B, N, N, ni), K (B, N, N+1, nu, nx); the
constraint geometry, E and the regularizers are shared by all lanes.
Index conventions follow the JAX module (eta[k, j] defined for k >= j).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from robust_nonlinear_mpc_torch.utils.numerics import spd_solve_small, sym


class SLSRegs(NamedTuple):
    """Tube regularizers."""

    Q_reg: torch.Tensor    # (nx, nx)
    R_reg: torch.Tensor    # (nu, nu)
    Q_reg_f: torch.Tensor  # (nx, nx)


def evaluate_dual_eta(mu, mu_f, beta, beta_f, epsilon_backoff):
    """eta[k, j] = mu[k] / (2 sqrt(max(beta[k, j], eps))) for k >= j, else 0;
    eta_f[j] = mu_f / (2 sqrt(max(beta_f[j], eps))).

    mu (B, N, ni), mu_f (B, ni_f), beta (B, N, N, ni), beta_f (B, N+1, ni_f)."""
    N = mu.shape[1]
    b = torch.clamp(beta, min=epsilon_backoff)
    b_f = torch.clamp(beta_f, min=epsilon_backoff)
    eta = mu[:, :, None, :] / (2.0 * torch.sqrt(b))
    tril = torch.ones((N, N), dtype=torch.bool, device=mu.device).tril()
    eta = torch.where(tril[None, :, :, None], eta, torch.zeros_like(eta))
    eta_f = mu_f[:, None, :] / (2.0 * torch.sqrt(b_f))
    return eta, eta_f


def backward_solve_folded(A, B, Gmat, Gf, eta, eta_f, regs: SLSRegs):
    """Column-wise backward Riccati with the column axis folded into the GEMM
    row dimension. Returns S (B, N+1, N+1, nx, nx), K (B, N, N+1, nu, nx)."""
    Bsz, N, nx = A.shape[0], A.shape[1], A.shape[2]
    nu = B.shape[3]
    J = N + 1
    Gx = Gmat[:, :nx]
    Gu = Gmat[:, nx:]
    ni = Gx.shape[0]
    GGx = (Gx[:, :, None] * Gx[:, None, :]).reshape(ni, nx * nx)
    GGu = (Gu[:, :, None] * Gu[:, None, :]).reshape(ni, nu * nu)
    GGf = (Gf[:, :, None] * Gf[:, None, :]).reshape(Gf.shape[0], nx * nx)

    SN = sym((eta_f @ GGf).reshape(Bsz, J, nx, nx) + regs.Q_reg_f)
    eta_pad = torch.cat([eta, eta.new_zeros((Bsz, N, 1, ni))], dim=2)
    js = torch.arange(J, device=A.device)

    S_all = SN
    K_st, S_st = [None] * N, [None] * N
    for k in reversed(range(N)):
        A_k, B_k, eta_k = A[:, k], B[:, k], eta_pad[:, k]
        Cxx = (eta_k @ GGx).reshape(Bsz, J, nx, nx) + regs.Q_reg
        Cuu = (eta_k @ GGu).reshape(Bsz, J, nu, nu) + regs.R_reg
        S_flat = S_all.reshape(Bsz, J * nx, nx)
        SA = (S_flat @ A_k).reshape(Bsz, J, nx, nx)
        SB = (S_flat @ B_k).reshape(Bsz, J, nx, nu)
        SBt = SB.transpose(-1, -2).reshape(Bsz, J * nu, nx)
        H = Cuu + (SBt @ B_k).reshape(Bsz, J, nu, nu)
        F = (SBt @ A_k).reshape(Bsz, J, nu, nx)
        K = -spd_solve_small(sym(H), F)
        SAt = SA.transpose(-1, -2).reshape(Bsz, J * nx, nx)
        AtSA = (SAt @ A_k).reshape(Bsz, J, nx, nx)
        AtSBK = F.transpose(-1, -2) @ K
        S_new = sym(Cxx + AtSA + AtSBK)
        active = (k >= js)[None, :, None, None]
        S_all = torch.where(active, S_new, S_all)
        S_st[k] = torch.where(active, S_new, torch.zeros_like(S_new))
        K_st[k] = torch.where(active, K, torch.zeros_like(K))
    S = torch.stack(S_st + [SN], dim=1)
    return S, torch.stack(K_st, dim=1)


def response_streaming_folded(A, B, E, K, Gx, Gu, Gf, regs: SLSRegs, epsilon):
    """Fused propagate + backoffs + tube cost that never materializes Phi.

    The loop over stages carries the current stage's response rows
    transposed, P (B, nx, J, nw), so the shared-operand products are GEMMs.
    E (N+1, nx, nw) is shared by the lanes. Returns (beta (B, N, N, ni),
    beta_f (B, N+1, ni_f), backoff (B, N, ni), backoff_f (B, ni_f),
    cost_tube (B,))."""
    Bsz, N, nx = A.shape[0], A.shape[1], A.shape[2]
    nw = E.shape[2]
    J = N + 1
    cols = torch.arange(J, device=A.device)
    P = A.new_zeros((Bsz, nx, J, nw))
    cost_acc = A.new_zeros((Bsz,))
    beta, backoff = [], []
    for k in range(N):
        A_k, B_k, K_k = A[:, k], B[:, k], K[:, k]
        P = torch.where((cols == k)[None, None, :, None], E[k][None, :, None, :], P)
        phi_u = torch.einsum("bjui,bijw->bujw", K_k, P)
        P_flat = P.reshape(Bsz, nx, J * nw)
        pu_flat = phi_u.reshape(Bsz, -1, J * nw)
        Z = Gx @ P_flat + Gu @ pu_flat
        beta_all = (Z.reshape(Bsz, -1, J, nw) ** 2).sum(dim=-1)
        beta_row = beta_all.transpose(1, 2)[:, :N]
        tri = (cols[:N] <= k)[None, :, None]
        beta_row = torch.where(tri, torch.clamp(beta_row, min=epsilon),
                               torch.zeros_like(beta_row))
        beta.append(beta_row)
        backoff.append(torch.sqrt(beta_row).sum(dim=1))

        qx = regs.Q_reg @ P_flat
        ru = regs.R_reg @ pu_flat
        cost_acc = cost_acc + (qx * qx).sum(dim=(1, 2)) + (ru * ru).sum(dim=(1, 2))

        nxt = (A_k @ P_flat + B_k @ pu_flat).reshape(Bsz, nx, J, nw)
        P = torch.where((cols <= k)[None, None, :, None], nxt, torch.zeros_like(nxt))

    last = torch.where((cols == N)[None, None, :, None], E[N][None, :, None, :], P)
    last_flat = last.reshape(Bsz, nx, J * nw)
    Zf = Gf @ last_flat
    beta_f = torch.clamp(
        (Zf.reshape(Bsz, -1, J, nw) ** 2).sum(dim=-1), min=epsilon
    ).transpose(1, 2)
    backoff_f = torch.sqrt(beta_f).sum(dim=1)
    qf = regs.Q_reg_f @ last_flat
    cost_tube = torch.sqrt(cost_acc + (qf * qf).sum(dim=(1, 2)))
    return (torch.stack(beta, dim=1), beta_f, torch.stack(backoff, dim=1),
            backoff_f, cost_tube)

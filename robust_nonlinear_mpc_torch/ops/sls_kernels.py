"""fast-SLS tube synthesis: dual extraction, the column-wise backward
Riccati, the Phi-free streaming response and the Phi-materializing stages
(propagation, backoffs, tube cost). Port of the GEMM-folded and the
triangular column-blocked forms, of the per-column forms (`riccati_column`,
`response_column` and the dense `backward_solve` / `response_streaming`
built on them) and of `propagate` / `backoff_from_phi` /
`tube_cost` in `robust_nonlinear_mpc_tpu/ops/sls_kernels.py`. The JAX
package writes the folded and the blocked forms out twice; here each has one
body, the blocked one, and the folded form is its single-segment case.

The per-column forms take an explicit column-index tensor `js` (C,): any
subset of 0..N, or the sentinel N + 1 for a padded column, which
contributes exactly zero. They are batched over lanes and over the columns
(the JAX package vmaps one column); `parallel/columns.py` gives each rank a
slab of them.

Everything here is plain torch: the JAX package computes these stages with
XLA outside any Pallas kernel (the hand-written backward is
`ops/fused_backward.py`). Every function is batch-leading: A (B, N, nx,
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


def backward_solve_blocked(A, B, Gmat, Gf, eta, eta_f, regs: SLSRegs, block=8):
    """Column-wise backward Riccati with the column axis folded into the GEMM
    row dimension and triangular column blocking: the stages run in segments
    of `block`, high to low, and segment [lo, hi) carries only the `hi`
    columns that can be active there (column j is active at stages k >= j);
    K and S are padded back to J = N+1 columns. Returns S (B, N+1, N+1, nx,
    nx), K (B, N, N+1, nu, nx)."""
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

    S_all = SN
    K_st, S_st = [None] * N, [None] * N
    for s in reversed(range(-(-N // block))):
        lo, hi = s * block, min((s + 1) * block, N)
        W = hi
        js = torch.arange(W, device=A.device)
        S_all = S_all[:, :W]
        for k in reversed(range(lo, hi)):
            A_k, B_k, eta_k = A[:, k], B[:, k], eta_pad[:, k, :W]
            Cxx = (eta_k @ GGx).reshape(Bsz, W, nx, nx) + regs.Q_reg
            Cuu = (eta_k @ GGu).reshape(Bsz, W, nu, nu) + regs.R_reg
            S_flat = S_all.reshape(Bsz, W * nx, nx)
            SA = (S_flat @ A_k).reshape(Bsz, W, nx, nx)
            SB = (S_flat @ B_k).reshape(Bsz, W, nx, nu)
            SBt = SB.transpose(-1, -2).reshape(Bsz, W * nu, nx)
            H = Cuu + (SBt @ B_k).reshape(Bsz, W, nu, nu)
            F = (SBt @ A_k).reshape(Bsz, W, nu, nx)
            K = -spd_solve_small(sym(H), F)
            SAt = SA.transpose(-1, -2).reshape(Bsz, W * nx, nx)
            AtSA = (SAt @ A_k).reshape(Bsz, W, nx, nx)
            AtSBK = F.transpose(-1, -2) @ K
            S_new = sym(Cxx + AtSA + AtSBK)
            active = (k >= js)[None, :, None, None]
            S_all = torch.where(active, S_new, S_all)
            pad = (0, 0, 0, 0, 0, J - W)
            S_st[k] = torch.nn.functional.pad(
                torch.where(active, S_new, torch.zeros_like(S_new)), pad)
            K_st[k] = torch.nn.functional.pad(torch.where(active, K, torch.zeros_like(K)), pad)
    S = torch.stack(S_st + [SN], dim=1)
    return S, torch.stack(K_st, dim=1)


def backward_solve_folded(A, B, Gmat, Gf, eta, eta_f, regs: SLSRegs):
    """The GEMM-folded backward Riccati (the JAX `backward_solve_folded`):
    `backward_solve_blocked` in one segment, which carries the N columns that
    can be active (the terminal column never is)."""
    return backward_solve_blocked(A, B, Gmat, Gf, eta, eta_f, regs, block=A.shape[1])


def riccati_step(A, B, Cx, Cu, Sk):
    """One Riccati step over any leading batch axes:
    K = -(Cu + B'SB)^-1 B'SA and S = sym(Cx + A'S(A + BK))."""
    x = B.transpose(-1, -2) @ Sk
    y = A.transpose(-1, -2) @ Sk
    H = Cu + x @ B
    F = x @ A
    K = -spd_solve_small(sym(H), F)
    S = Cx + y @ (A + B @ K)
    return K, sym(S)


def riccati_column(js, eta_cols, eta_f_cols, A, B, Gmat, Gf, regs: SLSRegs):
    """Backward Riccati of the SLS columns `js` (C,), masked to the stages
    k >= j: eta_cols (B, C, N, ni) holds eta[:, j] and eta_f_cols (B, C,
    ni_f) eta_f[j] of each column. Returns S_col (B, C, N+1, nx, nx) and
    K_col (B, C, N, nu, nx). A padded column (j = N + 1) is never active:
    its K and its stage S are zero, its terminal S the regularizer."""
    N, nx = A.shape[1], A.shape[2]
    Gx, Gu = Gmat[:, :nx], Gmat[:, nx:]
    SN = Gf.T @ (eta_f_cols[..., :, None] * Gf) + regs.Q_reg_f
    S = SN
    K_st, S_st = [None] * N, [None] * N
    for k in reversed(range(N)):
        eta_k = eta_cols[:, :, k, :, None]
        Cxx = Gx.T @ (eta_k * Gx) + regs.Q_reg
        Cuu = Gu.T @ (eta_k * Gu) + regs.R_reg
        K_k, S_k = riccati_step(A[:, k, None], B[:, k, None], Cxx, Cuu, S)
        active = (k >= js)[None, :, None, None]
        S_st[k] = torch.where(active, S_k, torch.zeros_like(S_k))
        K_st[k] = torch.where(active, K_k, torch.zeros_like(K_k))
        S = torch.where(active, S_k, S)
    return torch.stack(S_st + [SN], dim=2), torch.stack(K_st, dim=2)


def eta_columns(eta):
    """(B, N, N, ni) stage-major eta -> (B, N+1, N, ni) column-major, with the
    empty terminal column appended (column N has no stage etas)."""
    return torch.cat([eta.transpose(1, 2), eta.new_zeros(eta[:, :1].shape)], dim=1)


def backward_solve(A, B, Gmat, Gf, eta, eta_f, regs: SLSRegs):
    """The per-column backward Riccati over all N + 1 columns, in the dense
    (stage, column) layout: S (B, N+1, N+1, nx, nx), K (B, N, N+1, nu, nx).
    Equals `backward_solve_folded` to rounding."""
    js = torch.arange(A.shape[1] + 1, device=A.device)
    S_all, K_all = riccati_column(js, eta_columns(eta), eta_f, A, B, Gmat, Gf, regs)
    return S_all.transpose(1, 2), K_all.transpose(1, 2)


def response_column(js, K_cols, A, B, E, Gx, Gu, Gf, regs: SLSRegs, epsilon):
    """Streaming response of the SLS columns `js` (C,): Phi_x[:, j] propagated
    through A_k + B_k K[k, j] with the column's row norms and tube-cost terms
    accumulated, Phi never stored. K_cols (B, C, N, nu, nx) holds K[:, j].
    Returns beta_cols (B, C, N, ni) (zero for stages k < j), beta_f (B, C,
    ni_f) and the squared tube-cost contribution cost_sq (B, C). A padded
    column (j = N + 1) propagates zeros and contributes exactly zero to every
    output (the epsilon floor is masked)."""
    N = A.shape[1]
    col = lambda m: m[None, :, None, None]
    phi = A.new_zeros(K_cols.shape[:2] + (A.shape[2], E.shape[2]))
    betas, costs = [], []
    for k in range(N):
        phi = torch.where(col(js == k), E[k], phi)
        K_k = K_cols[:, :, k]
        phi_u = K_k @ phi
        Z = Gx @ phi + Gu @ phi_u
        active = (k >= js)[None, :, None]
        betas.append(torch.where(active, torch.clamp((Z * Z).sum(dim=-1), min=epsilon),
                                 torch.zeros_like(Z[..., 0])))
        qx = regs.Q_reg @ phi
        ru = regs.R_reg @ phi_u
        costs.append((qx * qx).sum(dim=(-1, -2)) + (ru * ru).sum(dim=(-1, -2)))
        nxt = (A[:, k, None] + B[:, k, None] @ K_k) @ phi
        phi = torch.where(active[..., None], nxt, torch.zeros_like(nxt))
    last = torch.where(col(js == N), E[N], phi)
    Zf = Gf @ last
    live = (js <= N)[None, :, None]
    beta_f = torch.where(live, torch.clamp((Zf * Zf).sum(dim=-1), min=epsilon),
                         torch.zeros_like(Zf[..., 0]))
    qf = regs.Q_reg_f @ last
    cost_sq = torch.stack(costs, dim=-1).sum(dim=-1) + (qf * qf).sum(dim=(-1, -2))
    return torch.stack(betas, dim=2), beta_f, cost_sq


def response_streaming(A, B, E, K, Gx, Gu, Gf, regs: SLSRegs, epsilon):
    """The Phi-free streaming response in its per-column form (the JAX
    `response_streaming`): `response_column` over all N + 1 columns, then
    the three cross-column reductions (backoff, backoff_f, tube cost). Same
    outputs as `response_streaming_folded`."""
    N = A.shape[1]
    js = torch.arange(N + 1, device=A.device)
    beta_c, beta_f, cost_sq = response_column(js, K.transpose(1, 2), A, B, E, Gx, Gu, Gf,
                                              regs, epsilon)
    beta = beta_c[:, :N].transpose(1, 2)
    return (beta, beta_f, torch.sqrt(beta).sum(dim=2), torch.sqrt(beta_f).sum(dim=1),
            torch.sqrt(cost_sq.sum(dim=1)))


def response_streaming_blocked(A, B, E, K, Gx, Gu, Gf, regs: SLSRegs, epsilon, block=8):
    """Fused propagate + backoffs + tube cost that never materializes Phi,
    with triangular column blocking (the forward mirror of
    `backward_solve_blocked`).

    The loop over stages carries the current stage's response rows
    transposed, P (B, nx, W, nw), so the shared-operand products are GEMMs.
    The stages run in segments of `block`, low to high, and segment [lo, hi)
    carries only the W = hi columns that can be active there; the carry
    gains a zero column block at each segment boundary. E (N+1, nx, nw) is
    shared by the lanes. Returns (beta (B, N, N, ni), beta_f (B, N+1, ni_f),
    backoff (B, N, ni), backoff_f (B, ni_f), cost_tube (B,))."""
    Bsz, N, nx = A.shape[0], A.shape[1], A.shape[2]
    nw = E.shape[2]
    J = N + 1
    P = A.new_zeros((Bsz, nx, min(block, N), nw))
    cost_acc = A.new_zeros((Bsz,))
    beta, backoff = [], []
    for s in range(-(-N // block)):
        lo, hi = s * block, min((s + 1) * block, N)
        W = hi
        cols = torch.arange(W, device=A.device)
        P = torch.nn.functional.pad(P, (0, 0, 0, W - P.shape[2]))
        for k in range(lo, hi):
            A_k, B_k, K_k = A[:, k], B[:, k], K[:, k, :W]
            P = torch.where((cols == k)[None, None, :, None], E[k][None, :, None, :], P)
            phi_u = torch.einsum("bjui,bijw->bujw", K_k, P)
            P_flat = P.reshape(Bsz, nx, W * nw)
            pu_flat = phi_u.reshape(Bsz, -1, W * nw)
            Z = Gx @ P_flat + Gu @ pu_flat
            beta_all = (Z.reshape(Bsz, -1, W, nw) ** 2).sum(dim=-1)
            tri = (cols <= k)[None, :, None]
            beta_row = torch.where(tri, torch.clamp(beta_all.transpose(1, 2), min=epsilon),
                                   torch.zeros_like(beta_all.transpose(1, 2)))
            beta.append(torch.nn.functional.pad(beta_row, (0, 0, 0, N - W)))
            backoff.append(torch.sqrt(beta_row).sum(dim=1))

            qx = regs.Q_reg @ P_flat
            ru = regs.R_reg @ pu_flat
            cost_acc = cost_acc + (qx * qx).sum(dim=(1, 2)) + (ru * ru).sum(dim=(1, 2))

            nxt = (A_k @ P_flat + B_k @ pu_flat).reshape(Bsz, nx, W, nw)
            P = torch.where((cols <= k)[None, None, :, None], nxt, torch.zeros_like(nxt))

    cols = torch.arange(J, device=A.device)
    last = torch.nn.functional.pad(P, (0, 0, 0, J - P.shape[2]))
    last = torch.where((cols == N)[None, None, :, None], E[N][None, :, None, :], last)
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


def response_streaming_folded(A, B, E, K, Gx, Gu, Gf, regs: SLSRegs, epsilon):
    """The Phi-free streaming response (the JAX `response_streaming_folded`):
    `response_streaming_blocked` in one segment."""
    return response_streaming_blocked(A, B, E, K, Gx, Gu, Gf, regs, epsilon, block=A.shape[1])


def propagate(A, B, E, K):
    """Forward-propagate the system-response maps through A + B K[k, j].

    A (B, N, nx, nx), B (B, N, nx, nu), E (N+1, nx, nw) shared,
    K (B, N, N+1, nu, nx). Returns Phi_x (B, N+1, N+1, nx, nw) and
    Phi_u (B, N, N+1, nu, nw); columns j > k are zero."""
    N = A.shape[1]
    cols = torch.arange(N + 1, device=A.device)
    col = lambda m: m[None, :, None, None]
    row = A.new_zeros((A.shape[0], N + 1, A.shape[2], E.shape[2]))
    rows_x, rows_u = [], []
    for k in range(N):
        # inject this step's diagonal: Phi_x[k, k] = E[k]
        row = torch.where(col(cols == k), E[k], row)
        K_k = K[:, k]
        phi_u = torch.einsum("bjui,bjiw->bjuw", K_k, row)
        Acl = A[:, k, None] + torch.einsum("biu,bjuv->bjiv", B[:, k], K_k)
        nxt = torch.einsum("bjiv,bjvw->bjiw", Acl, row)
        active = col(cols <= k)
        rows_x.append(row)
        rows_u.append(torch.where(active, phi_u, torch.zeros_like(phi_u)))
        row = torch.where(active, nxt, torch.zeros_like(nxt))
    rows_x.append(torch.where(col(cols == N), E[N], row))
    return torch.stack(rows_x, dim=1), torch.stack(rows_u, dim=1)


def backoff_from_phi(Phi_x, Phi_u, Gx, Gu, Gf, epsilon):
    """Row-norm tube tightenings, batch-leading:
    beta[k, j, i] = max(||(Gx Phi_x[k,j] + Gu Phi_u[k,j])_i||^2, eps) for j <= k,
    beta_f[j, i] = max(||(Gf Phi_x[N,j])_i||^2, eps), backoff[k] = sum_j
    sqrt(beta[k, j]), backoff_f = sum_j sqrt(beta_f[j])."""
    N = Phi_u.shape[1]
    Z = torch.einsum("ri,bkjiw->bkjrw", Gx, Phi_x[:, :N]) + torch.einsum(
        "ru,bkjuw->bkjrw", Gu, Phi_u
    )
    beta = (Z * Z).sum(dim=-1)[:, :, :N]
    tri = torch.ones((N, N), dtype=torch.bool, device=Phi_x.device).tril()[None, :, :, None]
    beta = torch.where(tri, torch.clamp(beta, min=epsilon), torch.zeros_like(beta))
    Zf = torch.einsum("ri,bjiw->bjrw", Gf, Phi_x[:, N])
    beta_f = torch.clamp((Zf * Zf).sum(dim=-1), min=epsilon)
    backoff = torch.sqrt(beta).sum(dim=2)
    backoff_f = torch.sqrt(beta_f).sum(dim=1)
    return beta, beta_f, backoff, backoff_f


def tube_cost(Phi_x, Phi_u, regs: SLSRegs):
    """|| blkdiag(kron(I_N, Q_reg), Q_reg_f, kron(I_N, R_reg)) [Phi_x; Phi_u] ||_F
    per lane."""
    N = Phi_u.shape[1]
    qx = torch.einsum("ab,zkjbw->zkjaw", regs.Q_reg, Phi_x[:, :N])
    qf = torch.einsum("ab,zjbw->zjaw", regs.Q_reg_f, Phi_x[:, N])
    ru = torch.einsum("ab,zkjbw->zkjaw", regs.R_reg, Phi_u)
    sq = lambda t: (t * t).reshape(t.shape[0], -1).sum(dim=1)
    return torch.sqrt(sq(qx) + sq(qf) + sq(ru))


def tensor_to_matrix(t):
    """(..., P, M, n, m) block tensor -> (..., P n, M m) block matrix."""
    P, M, n, m = t.shape[-4:]
    return t.transpose(-3, -2).reshape(t.shape[:-4] + (P * n, M * m))


def matrix_to_tensor(mat, P, M, n, m):
    """(..., P n, M m) block matrix -> (..., P, M, n, m) block tensor."""
    return mat.reshape(mat.shape[:-2] + (P, n, M, m)).transpose(-3, -2)

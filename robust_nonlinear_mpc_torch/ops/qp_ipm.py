"""Batched horizon-structured QP solver: Riccati-KKT primal-dual interior
point (Mehrotra predictor-corrector). Port of
`robust_nonlinear_mpc_tpu/ops/qp_ipm.py`.

Problem (one per lane of the leading batch dimension):

    min_{X,U}  sum_k x_k' Q x_k + u_k' R u_k + x_N' Qf x_N + q' y
    s.t.       x_0 = xinit
               x_{k+1} = A_k x_k + B_k u_k + c_k          k = 0..N-1
               Gx x_k + Gu u_k <= h_k                     k = 0..N-1
               Gf x_N <= hf

`QPStatics` is shared by every lane (2-D time-invariant blocks or per-stage
3-D stacks); every `QPData` field carries the batch first. The JAX
`lax.while_loop` under `vmap` becomes a masked batch loop: a lane is active
while it is not done and under its own iteration cap, inactive lanes are
frozen with a select, and the loop ends when no lane is active (one host
sync per iteration). Inside `utils.host_sync.no_host_sync()` (a captured
CUDA graph) it runs the largest iteration cap instead, with no host read;
the freeze makes every lane end bit for bit where the early exit leaves it.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import torch

from robust_nonlinear_mpc_torch.utils.batch import (
    lane_max_abs,
    lane_min,
    lane_sum,
    lane_where,
    tree_where,
)
from robust_nonlinear_mpc_torch.utils.host_sync import host_sync_allowed
from robust_nonlinear_mpc_torch.utils.numerics import mv, spd_solve_refined, sym


class QPStatics(NamedTuple):
    """Hessian blocks Hx = 2Q, Hu = 2R, HxN = 2Qf and constraint geometry,
    shared by all lanes: 2-D (time-invariant) or 3-D per-stage stacks."""

    Hx: torch.Tensor   # (nx, nx) or (N, nx, nx)
    Hu: torch.Tensor   # (nu, nu) or (N, nu, nu)
    HxN: torch.Tensor  # (nx, nx)
    Gx: torch.Tensor   # (ni, nx) or (N, ni, nx)
    Gu: torch.Tensor   # (ni, nu) or (N, ni, nu)
    Gf: torch.Tensor   # (ni_f, nx)

    def per_stage(self, N: int) -> "QPStatics":
        b = lambda M: M if M.dim() == 3 else M.unsqueeze(0).expand((N,) + M.shape)
        return QPStatics(
            Hx=b(self.Hx), Hu=b(self.Hu), HxN=self.HxN,
            Gx=b(self.Gx), Gu=b(self.Gu), Gf=self.Gf,
        )


class QPData(NamedTuple):
    """Per-solve numeric data, batch-leading."""

    A: torch.Tensor      # (B, N, nx, nx)
    B: torch.Tensor      # (B, N, nx, nu)
    c: torch.Tensor      # (B, N, nx)
    qx: torch.Tensor     # (B, N+1, nx)
    qu: torch.Tensor     # (B, N, nu)
    h: torch.Tensor      # (B, N, ni)
    hf: torch.Tensor     # (B, ni_f)
    xinit: torch.Tensor  # (B, nx)


class QPSolution(NamedTuple):
    X: torch.Tensor        # (B, N+1, nx)
    U: torch.Tensor        # (B, N, nu)
    lam: torch.Tensor      # (B, N, ni)
    lam_f: torch.Tensor    # (B, ni_f)
    nu_dyn: torch.Tensor   # (B, N, nx)
    nu_init: torch.Tensor  # (B, nx)
    s: torch.Tensor        # (B, N, ni)
    s_f: torch.Tensor      # (B, ni_f)
    cost: torch.Tensor     # (B,)
    kkt_res: torch.Tensor  # (B,)
    iters: torch.Tensor    # (B,) int32
    success: torch.Tensor  # (B,) bool


class IPMOptions(NamedTuple):
    max_iter: int = 30
    tol: float = 1e-9
    tau: float = 0.995      # fraction-to-boundary
    init_slack: float = 1.0
    # Newton-step linear solver:
    #   "riccati"    - block-tridiagonal Riccati factorization, a torch loop
    #                  over the horizon (the plain path);
    #   "fused"      - the same factorization as two hand-written CUDA kernels
    #                  (ops/fused_qp.py, csrc/fused_qp.cu): the port's name for
    #                  the JAX package's "pallas";
    #   "fused_iter" - the whole Mehrotra iteration as one hand-written CUDA
    #                  kernel (ops/fused_qp.ipm_iteration, csrc/fused_ipm.cu):
    #                  the port's name for "pallas_iter". The kernel builds the
    #                  curvature Gram products from W = lam / s; W and the done
    #                  bookkeeping stay outside it.
    # On CPU tensors the kernels' plain torch twins run. The JAX option
    # "condensed" is not ported.
    kkt: str = "riccati"


KKT_SOLVERS = ("riccati", "fused", "fused_iter")
_NOT_PORTED_KKT = {
    "condensed": "ROADMAP.md Open items, queue 1 item 3 (research options)",
    "pallas": "use kkt='fused', the port's name for the fused Newton kernels",
    "pallas_iter": "use kkt='fused_iter', the port's name for the whole-iteration kernel",
}


# ----------------------------------------------------------------------
# Residuals
# ----------------------------------------------------------------------
def _residuals(stat: QPStatics, data: QPData, X, U, lam, s, lam_f, s_f, nu_dyn):
    N = data.A.shape[1]
    req = (
        mv(data.A, X[:, :N]) + mv(data.B, U) + data.c - X[:, 1 : N + 1]
    )
    GzX = torch.einsum("kri,bki->bkr", stat.Gx, X[:, :N])
    GzU = torch.einsum("kru,bku->bkr", stat.Gu, U)
    rineq = GzX + GzU + s - data.h
    rineq_f = X[:, N] @ stat.Gf.T + s_f - data.hf

    rx = (
        torch.einsum("kij,bkj->bki", stat.Hx[1:N], X[:, 1:N])
        + data.qx[:, 1:N]
        + torch.einsum("kri,bkr->bki", stat.Gx[1:N], lam[:, 1:N])
        + nu_dyn[:, : N - 1]
        - mv(data.A[:, 1:N].transpose(-1, -2), nu_dyn[:, 1:N])
    )
    rxN = X[:, N] @ stat.HxN.T + data.qx[:, N] + lam_f @ stat.Gf + nu_dyn[:, N - 1]
    ru = (
        torch.einsum("kij,bkj->bki", stat.Hu, U)
        + data.qu
        + torch.einsum("kru,bkr->bku", stat.Gu, lam)
        - mv(data.B.transpose(-1, -2), nu_dyn)
    )
    return req, rineq, rineq_f, rx, rxN, ru


# ----------------------------------------------------------------------
# Riccati factorization (once per IPM iteration)
# ----------------------------------------------------------------------
def _curvature(stat: QPStatics, W, W_f):
    """Cxx = Hx + Gx' W Gx, Cuu = Hu + Gu' W Gu, Cxu = Gx' W Gu,
    PN = HxN + Gf' W_f Gf, batched over W (B, N, ni), W_f (B, ni_f)."""
    Gx, Gu, Gf = stat.Gx, stat.Gu, stat.Gf
    WGx = W[..., None] * Gx
    WGu = W[..., None] * Gu
    Cxx = stat.Hx + torch.einsum("kri,bkrj->bkij", Gx, WGx)
    Cuu = stat.Hu + torch.einsum("kru,bkrv->bkuv", Gu, WGu)
    Cxu = torch.einsum("kri,bkrv->bkiv", Gx, WGu)
    PN = stat.HxN + Gf.T @ (W_f[..., None] * Gf)
    return Cxx, Cuu, Cxu, PN


def _factorize_with_presolve(stat: QPStatics, data: QPData, W, W_f,
                             rbx, rbxN, rbu, req):
    """Backward Riccati factorization of the reduced KKT system fused with
    the predictor's backward sweep (one reverse loop over the stages).

    Returns (fact, (kff, p_next_seq)) with fact = (K, Fuu_r, Fxu, P_next)."""
    Cxx, Cuu, Cxu, PN = _curvature(stat, W, W_f)
    N, nx = req.shape[1], req.shape[2]
    nu = data.B.shape[3]
    eye_u = torch.eye(nu, dtype=req.dtype, device=req.device)
    P, p = PN, rbxN
    out = [None] * N
    for k in reversed(range(N)):
        A, B = data.A[:, k], data.B[:, k]
        At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
        PA = P @ A
        PB = P @ B
        Fxx = Cxx[:, k] + At @ PA
        Fuu = Cuu[:, k] + Bt @ PB
        Fxu = Cxu[:, k] + At @ PB
        tr = torch.diagonal(Fuu, dim1=-2, dim2=-1).sum(-1)
        Fuu_r = sym(Fuu) + (tr * 1e-14)[:, None, None] * eye_u
        w = p + mv(P, req[:, k])
        f_u = rbu[:, k] + mv(Bt, w)
        sol = -spd_solve_refined(
            Fuu_r, torch.cat([Fxu.transpose(-1, -2), f_u[..., None]], dim=-1)
        )
        K = sol[..., :nx]
        kff = sol[..., nx]
        out[k] = (K, Fuu_r, Fxu, P, kff, p)
        P = sym(Fxx + Fxu @ K)
        p = rbx[:, k] + mv(At, w) + mv(Fxu, kff)
    K, Fuu_seq, Fxu_seq, P_next_seq, kff, p_next_seq = (
        torch.stack([o[i] for o in out], dim=1) for i in range(6)
    )
    return (K, Fuu_seq, Fxu_seq, P_next_seq), (kff, p_next_seq)


def _forward_sweep(A, B, K, kff, req, P_next_seq, p_next_seq):
    """Roll dx through du = K dx + kff and recover the dynamics multipliers."""
    N = req.shape[1]
    dx = torch.zeros_like(req[:, 0])
    dX, dU, dnu = [], [], []
    for k in range(N):
        du = mv(K[:, k], dx) + kff[:, k]
        dx_next = mv(A[:, k], dx) + mv(B[:, k], du) + req[:, k]
        dnu.append(-(mv(P_next_seq[:, k], dx_next) + p_next_seq[:, k]))
        dX.append(dx)
        dU.append(du)
        dx = dx_next
    dX.append(dx)
    return torch.stack(dX, dim=1), torch.stack(dU, dim=1), torch.stack(dnu, dim=1)


def _solve_newton(stat: QPStatics, data: QPData, fact, rbx, rbxN, rbu, req):
    """Solve the reduced KKT system for one rhs with the cached factors."""
    K, Fuu_seq, Fxu, P_next_seq = fact
    N = req.shape[1]
    p = rbxN
    kff = [None] * N
    pn = [None] * N
    for k in reversed(range(N)):
        At = data.A[:, k].transpose(-1, -2)
        Bt = data.B[:, k].transpose(-1, -2)
        w = p + mv(P_next_seq[:, k], req[:, k])
        f_u = rbu[:, k] + mv(Bt, w)
        kff[k] = -spd_solve_refined(Fuu_seq[:, k], f_u[..., None])[..., 0]
        pn[k] = p
        p = rbx[:, k] + mv(At, w) + mv(Fxu[:, k], kff[k])
    return _forward_sweep(
        data.A, data.B, K, torch.stack(kff, dim=1), req, P_next_seq, torch.stack(pn, dim=1)
    )


def _step_to_boundary(v, dv, tau):
    """Per lane: max alpha in (0, 1] with v + alpha dv >= (1 - tau) v."""
    neg = dv < 0
    ratio = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                        torch.full_like(v, float("inf")))
    return torch.clamp(tau * lane_min(ratio), max=1.0)


def _kkt_scalar(data: QPData, scale_p, n_comp, R, lam, lam_f, s, s_f):
    """Per-lane relative KKT residual: primal and dual max-norms over their
    scales, and the duality gap."""
    req, rineq, rineq_f, rx, rxN, ru = R
    gap = (lane_sum(lam * s) + lane_sum(lam_f * s_f)) / n_comp
    scale_d = 1.0 + lane_max_abs(data.qx, data.qu, lam, lam_f)
    res_p = lane_max_abs(req, rineq, rineq_f) / scale_p
    res_d = lane_max_abs(rx, rxN, ru) / scale_d
    return torch.maximum(torch.maximum(res_p, res_d), gap / scale_d)


def _riccati_newton(stat: QPStatics, data: QPData):
    """Newton solves by the torch Riccati loops (kkt="riccati"): the
    factorization fused with the predictor solve, then `nsolve` for the
    corrector against the cached factors."""
    def newton(W, W_f, rbx, rbxN, rbu, req):
        fact, (kff, pn) = _factorize_with_presolve(stat, data, W, W_f, rbx, rbxN, rbu, req)
        dX, dU, _ = _forward_sweep(data.A, data.B, fact[0], kff, req, fact[3], pn)
        return dX, dU, lambda *r: _solve_newton(stat, data, fact, *r, req)

    return newton


def _fused_newton(stat: QPStatics, data: QPData, factor_predictor, resolve):
    """Newton solves by the fused pair (`ops/fused_qp.factor_predictor` /
    `resolve`, or their plain twins) on the curvature of the weights."""
    def newton(W, W_f, rbx, rbxN, rbu, req):
        Cxx, Cuu, Cxu, PN = _curvature(stat, W, W_f)
        dX, dU, _, fact = factor_predictor(data.A, data.B, Cxx, Cuu, Cxu, PN, rbx, rbxN, rbu, req)
        return dX, dU, lambda *r: resolve(data.A, data.B, fact, *r, req)

    return newton


def _mehrotra_iteration(stat: QPStatics, data: QPData, state, newton, *, tau, n_comp,
                        scale_p, frozen=None):
    """One Mehrotra predictor-corrector iteration for every lane.

    `state` = (X, U, lam, s, lam_f, s_f, nu_dyn, R) with R the residuals at
    the iterate. `newton(W, W_f, rbx, rbxN, rbu, req)` factorizes and solves
    the predictor system, returning (dX, dU, nsolve) with nsolve(rbx, rbxN,
    rbu) -> (dX, dU, dnu) the corrector solve. Lanes in `frozen` keep their
    iterate; a lane whose new KKT scalar is not finite keeps its iterate and
    residuals and reports its old KKT scalar. Returns (state_n, res_n, bad).
    """
    X, U, lam, s, lam_f, s_f, nu_dyn, R = state
    req, rineq, rineq_f, rx, rxN, ru = R
    N = data.A.shape[1]
    mu = (lane_sum(lam * s) + lane_sum(lam_f * s_f)) / n_comp

    def reduced_rhs(rcomp, rcomp_f):
        t = (lam * rineq - rcomp) / s
        t_f = (lam_f * rineq_f - rcomp_f) / s_f
        rbx = rx + torch.einsum("kri,bkr->bki", stat.Gx[1:N], t[:, 1:N])
        rbx = torch.cat([torch.zeros_like(rbx[:, :1]), rbx], dim=1)
        rbxN = rxN + t_f @ stat.Gf
        rbu = ru + torch.einsum("kru,bkr->bku", stat.Gu, t)
        return rbx, rbxN, rbu

    def recover(dX, dU, rcomp, rcomp_f):
        dGz = torch.einsum("kri,bki->bkr", stat.Gx, dX[:, :N]) + torch.einsum(
            "kru,bku->bkr", stat.Gu, dU
        )
        ds = -rineq - dGz
        dlam = -(rcomp + lam * ds) / s
        ds_f = -rineq_f - dX[:, N] @ stat.Gf.T
        dlam_f = -(rcomp_f + lam_f * ds_f) / s_f
        return ds, dlam, ds_f, dlam_f

    # ---- affine (predictor) step ----
    rcomp_a = lam * s
    rcomp_af = lam_f * s_f
    dXa, dUa, nsolve = newton(lam / s, lam_f / s_f, *reduced_rhs(rcomp_a, rcomp_af), req)
    dsa, dlama, dsfa, dlamfa = recover(dXa, dUa, rcomp_a, rcomp_af)

    alpha_p_a = torch.minimum(
        _step_to_boundary(s, dsa, 1.0), _step_to_boundary(s_f, dsfa, 1.0)
    )
    alpha_d_a = torch.minimum(
        _step_to_boundary(lam, dlama, 1.0), _step_to_boundary(lam_f, dlamfa, 1.0)
    )
    ap3, ad3 = alpha_p_a[:, None, None], alpha_d_a[:, None, None]
    mu_aff = (
        lane_sum((s + ap3 * dsa) * (lam + ad3 * dlama))
        + lane_sum((s_f + alpha_p_a[:, None] * dsfa) * (lam_f + alpha_d_a[:, None] * dlamfa))
    ) / n_comp
    sigma = torch.clamp((mu_aff / torch.clamp(mu, min=1e-30)) ** 3, 0.0, 1.0)

    # ---- corrector step ----
    sm = (sigma * mu)
    rcomp_c = lam * s + dsa * dlama - sm[:, None, None]
    rcomp_cf = lam_f * s_f + dsfa * dlamfa - sm[:, None]
    dX, dU, dnu = nsolve(*reduced_rhs(rcomp_c, rcomp_cf))
    ds, dlam, ds_f, dlam_f = recover(dX, dU, rcomp_c, rcomp_cf)

    alpha_p = torch.minimum(
        _step_to_boundary(s, ds, tau), _step_to_boundary(s_f, ds_f, tau)
    )
    alpha_d = torch.minimum(
        _step_to_boundary(lam, dlam, tau), _step_to_boundary(lam_f, dlam_f, tau)
    )
    ap3, ad3 = alpha_p[:, None, None], alpha_d[:, None, None]
    ap2, ad2 = alpha_p[:, None], alpha_d[:, None]
    old = (X, U, lam, s, lam_f, s_f, nu_dyn)
    new = (X + ap3 * dX, U + ap3 * dU, lam + ad3 * dlam, s + ap3 * ds,
           lam_f + ad2 * dlam_f, s_f + ap2 * ds_f, nu_dyn + ad3 * dnu)
    if frozen is not None:
        new = tuple(lane_where(frozen, o, n) for n, o in zip(new, old))
    X_n, U_n, lam_n, s_n, lamf_n, sf_n, nu_n = new

    R_n = _residuals(stat, data, X_n, U_n, lam_n, s_n, lamf_n, sf_n, nu_n)
    res_n = _kkt_scalar(data, scale_p, n_comp, R_n, lam_n, lamf_n, s_n, sf_n)

    # non-finite step: revert to the previous iterate and stop the lane
    bad = ~torch.isfinite(res_n)
    keep = ~bad
    new = tuple(lane_where(keep, n, o) for n, o in zip(new, old))
    R_n = tree_where(keep, R_n, R)
    res_n = torch.where(bad, _kkt_scalar(data, scale_p, n_comp, R, lam, lam_f, s, s_f), res_n)
    return (*new, R_n), res_n, bad


# ----------------------------------------------------------------------
# Main solve
# ----------------------------------------------------------------------
def solve_qp(
    stat: QPStatics,
    data: QPData,
    opts: IPMOptions = IPMOptions(),
    init: QPSolution | None = None,
    max_iter_dyn=None,
    max_iter_bound: int | None = None,
) -> QPSolution:
    """Solve a batch of horizon-structured QPs.

    `max_iter_dyn`: optional per-lane (B,) iteration cap overriding
    opts.max_iter (the steady-state-aware budget of fast-SLS), and
    `max_iter_bound` the largest of those caps, known on the host: the loop
    count inside `no_host_sync()`, which needs it with `max_iter_dyn`.
    `init`: optional warm start; primal from init, slacks re-centered to the
    new bounds with a margin, duals floored, then Mehrotra's initial-point
    shift.
    """
    if opts.kkt in _NOT_PORTED_KKT:
        raise NotImplementedError(
            f"IPMOptions.kkt={opts.kkt!r} is not ported: {_NOT_PORTED_KKT[opts.kkt]}"
        )
    if opts.kkt not in KKT_SOLVERS:
        raise ValueError(f"IPMOptions.kkt must be one of {KKT_SOLVERS}, got {opts.kkt!r}")
    Bsz, N, nx = data.c.shape
    nu = data.B.shape[3]
    stat = stat.per_stage(N)
    ni = stat.Gx.shape[1]
    ni_f = stat.Gf.shape[0]
    dtype, device = data.A.dtype, data.A.device
    n_comp = N * ni + ni_f
    if max_iter_dyn is None:
        cap = torch.full((Bsz,), int(opts.max_iter), dtype=torch.int32, device=device)
        max_iter_bound = int(opts.max_iter)
    else:
        cap = torch.as_tensor(max_iter_dyn, device=device).to(torch.int32).expand(Bsz)
    sync = host_sync_allowed()
    if not sync and max_iter_bound is None:
        raise ValueError("solve_qp under no_host_sync() needs max_iter_bound with max_iter_dyn")

    if init is None:
        X0 = torch.zeros((Bsz, N + 1, nx), dtype=dtype, device=device)
        X0[:, 0] = data.xinit
        U0 = torch.zeros((Bsz, N, nu), dtype=dtype, device=device)
        slack0 = data.h - torch.einsum("kri,bki->bkr", stat.Gx, X0[:, :N])
        s0 = torch.clamp(slack0, min=opts.init_slack)
        sf0 = torch.clamp(data.hf - X0[:, N] @ stat.Gf.T, min=opts.init_slack)
        lam0 = torch.ones((Bsz, N, ni), dtype=dtype, device=device)
        lamf0 = torch.ones((Bsz, ni_f), dtype=dtype, device=device)
        nu0 = torch.zeros((Bsz, N, nx), dtype=dtype, device=device)
    else:
        margin = 0.01
        X0 = init.X.clone()
        X0[:, 0] = data.xinit
        U0 = init.U
        slack0 = data.h - (
            torch.einsum("kri,bki->bkr", stat.Gx, X0[:, :N])
            + torch.einsum("kru,bku->bkr", stat.Gu, U0)
        )
        s0 = torch.clamp(slack0, min=margin)
        sf0 = torch.clamp(data.hf - X0[:, N] @ stat.Gf.T, min=margin)
        lam0 = torch.clamp(init.lam, min=margin)
        lamf0 = torch.clamp(init.lam_f, min=margin)
        nu0 = init.nu_dyn
        # Mehrotra initial-point shift (see the JAX solve_qp for why)
        gap0 = (lane_sum(s0 * lam0) + lane_sum(sf0 * lamf0)) / n_comp
        shift = 0.5 * torch.sqrt(gap0)
        s0, sf0 = s0 + shift[:, None, None], sf0 + shift[:, None]
        lam0, lamf0 = lam0 + shift[:, None, None], lamf0 + shift[:, None]

    scale_p = 1.0 + lane_max_abs(data.c, data.h, data.hf, data.xinit)
    eps_mach = torch.finfo(dtype).eps

    if opts.kkt == "fused_iter":
        from robust_nonlinear_mpc_torch.ops.fused_qp import ipm_iteration

        zero_row = torch.zeros((Bsz, 1, nx), dtype=dtype, device=device)

        def iterate(state, frozen):
            X, U, lam, s, lam_f, s_f, nu_dyn, (req, rineq, rineq_f, rx, rxN, ru) = state
            *it_n, req_n, rineq_n, rineqf_n, rxpad_n, rxN_n, ru_n, res_n, bad = ipm_iteration(
                data.A, data.B, data.c, data.qx, data.qu, data.h, data.hf,
                stat.Gx, stat.Gu, stat.Gf, stat.Hx, stat.Hu, stat.HxN,
                lam / s, lam_f / s_f, X, U, lam, s, lam_f, s_f, nu_dyn,
                req, rineq, rineq_f, torch.cat([zero_row, rx], dim=1), rxN, ru,
                scale_p, frozen, tau=opts.tau, n_comp=n_comp,
            )
            R_n = (req_n, rineq_n, rineqf_n, rxpad_n[:, 1:], rxN_n, ru_n)
            return (*it_n, R_n), res_n, bad
    else:
        if opts.kkt == "fused":
            from robust_nonlinear_mpc_torch.ops.fused_qp import factor_predictor, resolve

            newton = _fused_newton(stat, data, factor_predictor, resolve)
        else:
            newton = _riccati_newton(stat, data)

        def iterate(state, frozen):
            # inactive lanes are frozen by the loop's select
            return _mehrotra_iteration(stat, data, state, newton, tau=opts.tau,
                                       n_comp=n_comp, scale_p=scale_p)

    R = _residuals(stat, data, X0, U0, lam0, s0, lamf0, sf0, nu0)
    state = (X0, U0, lam0, s0, lamf0, sf0, nu0, R)
    it = torch.zeros((Bsz,), dtype=torch.int32, device=device)
    done = torch.zeros((Bsz,), dtype=torch.bool, device=device)
    for _ in itertools.count() if sync else range(max_iter_bound):
        active = (~done) & (it < cap)
        if sync and not bool(active.any()):
            break
        new_state, res_n, bad = iterate(state, ~active)
        lam_n, s_n, lamf_n, sf_n = new_state[2:6]
        mu_n = (lane_sum(lam_n * s_n) + lane_sum(lamf_n * sf_n)) / n_comp
        scale_mu = 1.0 + lane_max_abs(data.qx, data.qu, lam_n, lamf_n)
        at_floor = mu_n < 10.0 * eps_mach * scale_mu
        done_n = (res_n < opts.tol) | bad | at_floor
        state = tree_where(active, new_state, state)
        done = torch.where(active, done_n, done)
        it = it + active.to(torch.int32)

    X, U, lam, s, lam_f, s_f, nu_dyn, R = state
    res = _kkt_scalar(data, scale_p, n_comp, R, lam, lam_f, s, s_f)
    return _finalize(stat, data, opts, N, res, X, U, lam, s, lam_f, s_f, nu_dyn, it)


def _finalize(stat, data, opts, N, res, X, U, lam, s, lam_f, s_f, nu_dyn, iters):
    nu_init = -(
        X[:, 0] @ stat.Hx[0].T
        + data.qx[:, 0]
        + lam[:, 0] @ stat.Gx[0]
        - mv(data.A[:, 0].transpose(-1, -2), nu_dyn[:, 0])
    )
    cost = (
        0.5
        * (
            lane_sum(torch.einsum("kij,bkj->bki", stat.Hx, X[:, :N]) * X[:, :N])
            + lane_sum(torch.einsum("kij,bkj->bki", stat.Hu, U) * U)
            + lane_sum(X[:, N] * (X[:, N] @ stat.HxN.T))
        )
        + lane_sum(data.qx * X)
        + lane_sum(data.qu * U)
    )
    return QPSolution(
        X=X, U=U, lam=lam, lam_f=lam_f, nu_dyn=nu_dyn, nu_init=nu_init,
        s=s, s_f=s_f, cost=cost, kkt_res=res, iters=iters,
        success=res < opts.tol * 100,
    )

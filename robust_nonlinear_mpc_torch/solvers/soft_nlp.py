"""Soft-constrained multiple-shooting NLP, the non-robust baseline and the
bench's cold-start fallback (port of
`robust_nonlinear_mpc_tpu/solvers/soft_nlp.py`): `soft_nlp_solve`, batched
over initial states, and the host API `NLPSoftSolver`.

    min  sum_k x'Qx + u'Ru + xN'Qf xN
         + rho_soft (||Gamma||^2 + ||gamma_f||^2) + rho_soft_l1 sum(Gamma)
    s.t. x_{k+1} = f(x_k, u_k), x_0 = x0,
         G [x_k; u_k] - g <= gamma_k, gamma_k >= 0,  Gf x_N - gf <= gamma_f

The slacks are decision variables of augmented inputs
u~ = [u, sqrt(rho) gamma, sqrt(rho) gamma_f] (nu + ni + ni_f wide), with one
extra terminal-slack stage, so the subproblems run on the same Riccati IPM
with per-stage statics (and its Cholesky branch for the wide input blocks).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from robust_nonlinear_mpc_torch.ops.qp_ipm import (
    IPMOptions,
    QPData,
    QPStatics,
    solve_qp,
)
from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions, line_search_index
from robust_nonlinear_mpc_torch.utils.batch import lane_all_finite, lane_max_abs, tree_where

SOFT_SQP_OPTS = SQPOptions(
    ipm=IPMOptions(max_iter=120, tol=3e-8), tol_step=1e-5, tol_feas=1e-8
)


def soft_fallback_chunk(N: int) -> int:
    """Lanes per soft-solve dispatch: the JAX package's chunking rule, kept
    so both packages run the fallback in the same chunks."""
    return max(16, min(128, 960 // max(int(N), 1)))


class SoftNLPSolution(NamedTuple):
    X: torch.Tensor          # (B, N+1, nx)
    U: torch.Tensor          # (B, N, nu)
    gamma: torch.Tensor      # (B, N, ni)
    gamma_f: torch.Tensor    # (B, ni_f)
    cost: torch.Tensor
    cost_nominal: torch.Tensor
    feas: torch.Tensor
    step_norm: torch.Tensor
    iters: torch.Tensor
    success: torch.Tensor


def soft_nlp_solve(model, N: int, Q, R, Qf, x0: torch.Tensor,
                   rho_soft: float = 1e6, rho_soft_l1: float | None = None,
                   X_init=None, U_init=None, opts: SQPOptions = SOFT_SQP_OPTS,
                   prox: float = 0.0) -> SoftNLPSolution:
    """Solve the soft-constrained NLP for a batch of initial states x0 (B, nx)."""
    nx, nu, ni, ni_f = model.nx, model.nu, model.ni, model.ni_f
    rho2 = float(rho_soft)
    rho1 = float(rho_soft if rho_soft_l1 is None else rho_soft_l1)
    dtype, device = x0.dtype, x0.device
    Bsz = x0.shape[0]
    as_t = lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device)

    host = lambda t: t.detach().cpu().numpy().astype(float) if torch.is_tensor(t) else np.asarray(t, float)
    Q_np, R_np, Qf_np = host(Q), host(R), host(Qf)
    Q, R, Qf = as_t(Q_np), as_t(R_np), as_t(Qf_np)
    G, g, Gf, gf = host(model.G), host(model.g), host(model.Gf), host(model.gf)

    sg = float(np.sqrt(rho2))
    nua = nu + ni + ni_f
    ni_aug = 2 * ni + ni_f
    Naug = N + 1
    if ni_f > ni:
        raise ValueError("terminal rows are padded into the stage row budget (ni_f <= ni)")

    Hx = np.stack([2 * Q_np] * N + [2 * Qf_np]) + 2 * prox * np.eye(nx)
    Hu_one = np.zeros((nua, nua))
    Hu_one[:nu, :nu] = 2 * R_np + 2 * prox * np.eye(nu)
    Hu_one[nu : nu + ni, nu : nu + ni] = 2 * np.eye(ni)
    Hu_one[nu + ni :, nu + ni :] = 2 * np.eye(ni_f)
    Hu = np.broadcast_to(Hu_one, (Naug, nua, nua))

    Gx_stage = np.zeros((ni_aug, nx))
    Gx_stage[:ni] = G[:, :nx]
    Gu_stage = np.zeros((ni_aug, nua))
    Gu_stage[:ni, :nu] = G[:, nx:]
    Gu_stage[:ni, nu : nu + ni] = -np.eye(ni) / sg
    Gu_stage[ni : 2 * ni, nu : nu + ni] = -np.eye(ni)
    Gu_stage[2 * ni :, nu + ni :] = -np.eye(ni_f)

    Gx_term = np.zeros((ni_aug, nx))
    Gx_term[:ni_f] = Gf
    Gu_term = np.zeros((ni_aug, nua))
    Gu_term[:ni_f, nu + ni :] = -np.eye(ni_f) / sg
    Gu_term[ni : 2 * ni, nu : nu + ni] = -np.eye(ni)
    Gu_term[2 * ni :, nu + ni :] = -np.eye(ni_f)

    Gx_all = as_t(np.stack([Gx_stage] * N + [Gx_term]))
    Gu_all = as_t(np.stack([Gu_stage] * N + [Gu_term]))
    Gf_dummy = torch.zeros((1, nx), dtype=dtype, device=device)
    hf_dummy = torch.ones((1,), dtype=dtype, device=device)
    stat = QPStatics(Hx=as_t(Hx), Hu=as_t(Hu), HxN=torch.zeros((nx, nx), dtype=dtype, device=device),
                     Gx=Gx_all, Gu=Gu_all, Gf=Gf_dummy)

    h_stage = np.concatenate([g, np.zeros(ni), np.zeros(ni_f)])
    h_term = np.concatenate([gf, np.ones(ni - ni_f), np.zeros(ni), np.zeros(ni_f)])
    h_abs = as_t(np.stack([h_stage] * N + [h_term]))
    q0_u = np.zeros((Naug, nua))
    q0_u[:N, nu : nu + ni] = rho1 / sg
    q0_u = as_t(q0_u)

    def split(Ut):
        return Ut[..., :nu], Ut[..., nu : nu + ni] / sg, Ut[..., N, nu + ni :] / sg

    def nominal_cost(X, Ut):
        u, _, _ = split(Ut)
        XN = X[..., :N, :]
        return (
            ((XN @ Q.T) * XN).sum(dim=(-1, -2))
            + ((u[..., :N, :] @ R.T) * u[..., :N, :]).sum(dim=(-1, -2))
            + ((X[..., N, :] @ Qf) * X[..., N, :]).sum(dim=-1)
        )

    def full_cost(X, Ut):
        _, gam, gam_f = split(Ut)
        pen = rho2 * ((gam[..., :N, :] ** 2).sum(dim=(-1, -2)) + (gam_f**2).sum(dim=-1)) \
            + rho1 * gam[..., :N, :].sum(dim=(-1, -2))
        return nominal_cost(X, Ut) + pen

    def defects(X, Ut):
        return model.ddyn(X[..., :Naug, :], Ut[..., :nu]) - X[..., 1 : Naug + 1, :]

    def merit(X, Ut, x0, rho):
        return full_cost(X, Ut) + rho * (
            defects(X, Ut).abs().sum(dim=(-1, -2)) + (X[..., 0, :] - x0).abs().sum(dim=-1)
        )

    alphas = 0.5 ** torch.arange(opts.n_alphas, dtype=dtype, device=device)

    def linearize(X, Ut):
        A, Bu, c = model.linearize_traj(X[:, : Naug + 1], Ut[..., :nu])
        Bfull = torch.cat([Bu, Bu.new_zeros(Bu.shape[:-1] + (nua - nu,))], dim=-1)
        return A, Bfull, c

    def body(X, Ut, rho, best_cost, stall):
        A, B, c = linearize(X, Ut)
        h = h_abs - (
            torch.einsum("kri,bki->bkr", Gx_all, X[:, :Naug])
            + torch.einsum("kru,bku->bkr", Gu_all, Ut)
        )
        hf = hf_dummy - X[:, Naug] @ Gf_dummy.T
        qx = torch.cat(
            [torch.einsum("kij,bkj->bki", stat.Hx, X[:, :Naug]), X.new_zeros((Bsz, 1, nx))],
            dim=1,
        )
        qu = torch.einsum("kij,bkj->bki", stat.Hu, Ut) + q0_u
        data = QPData(A=A, B=B, c=c, qx=qx, qu=qu, h=h, hf=hf, xinit=x0 - X[:, 0])
        sol = solve_qp(stat, data, opts.ipm)

        rho_n = torch.maximum(
            torch.clamp(rho, min=opts.merit_rho_min),
            2.0 * torch.maximum(lane_max_abs(sol.nu_dyn), lane_max_abs(sol.nu_init)),
        )
        m0 = merit(X, Ut, x0, rho_n)
        a4 = alphas[None, :, None, None]
        mvals = merit(X[:, None] + a4 * sol.X[:, None], Ut[:, None] + a4 * sol.U[:, None],
                      x0[:, None], rho_n[:, None])
        a = alphas[line_search_index(mvals, m0, alphas)][:, None, None]
        X_n = X + a * sol.X
        U_n = Ut + a * sol.U
        du_phys = torch.maximum(lane_max_abs(sol.U[..., :nu]), lane_max_abs(sol.U[..., nu:]) / sg)
        step_n = torch.maximum(lane_max_abs(sol.X), du_phys)
        d_n = defects(X_n, U_n)
        feas_n = lane_max_abs(d_n)
        conv = (step_n < opts.tol_step) & (feas_n < opts.tol_feas)
        cost_cmp = full_cost(X_n, U_n) + 1e6 * d_n.abs().sum(dim=(-1, -2))
        improved = cost_cmp < best_cost - 1e-9 * (1.0 + best_cost.abs())
        stall_n = torch.where(improved, torch.zeros_like(stall), stall + 1)
        best_n = torch.minimum(best_cost, cost_cmp)
        conv_stag = (stall_n >= 3) & (feas_n < 1e-4)
        fail = ~lane_all_finite(sol.X, sol.U)
        new = (X_n, U_n, rho_n, best_n, stall_n, step_n, feas_n)
        return new, conv | conv_stag, fail

    X = x0.new_zeros((Bsz, Naug + 1, nx))
    if X_init is not None:
        X[:, : N + 1] = torch.as_tensor(X_init, dtype=dtype, device=device)
    Ut = x0.new_zeros((Bsz, Naug, nua))
    if U_init is not None:
        Ut[:, :N, :nu] = torch.as_tensor(U_init, dtype=dtype, device=device)

    full = lambda v: torch.full((Bsz,), v, dtype=dtype, device=device)
    state = (X, Ut, full(opts.merit_rho_min), full(float("inf")),
             torch.zeros((Bsz,), dtype=torch.int32, device=device),
             full(float("inf")), full(float("inf")))
    it = torch.zeros((Bsz,), dtype=torch.int32, device=device)
    done = torch.zeros((Bsz,), dtype=torch.bool, device=device)
    success = torch.zeros_like(done)
    while True:
        active = (~done) & (it < opts.max_iter)
        if not bool(active.any()):
            break
        new_state, conv, fail = body(*state[:5])
        state = tree_where(active, new_state, state)
        success = torch.where(active, conv, success)
        done = done | (active & (conv | fail))
        it = it + active.to(torch.int32)

    X, Ut, _, _, _, step_norm, feas = state
    success = success | ((feas < 1e-4) & (step_norm < 1e-1))
    u, gam, gam_f = split(Ut)
    return SoftNLPSolution(
        X=X[:, : N + 1], U=u[:, :N], gamma=gam[:, :N], gamma_f=gam_f,
        cost=full_cost(X, Ut), cost_nominal=nominal_cost(X, Ut),
        feas=feas, step_norm=step_norm, iters=it, success=success,
    )


class NLPSoftSolver:
    """Host API with the reference constructor `NLPSoftConstraints(N, Q, R, m,
    Qf, rho_soft=1e6, rho_soft_l1=None)` and `.solve(x0, x_guess, u_guess)`,
    one problem at a time (B = 1), on the model's device and in its type.

    Escalation ladder: the undamped SQP is exact and fast on feasible
    problems; where slacks are strongly active at degenerate boundaries it
    can chatter, and a proximally damped retry converges (the damping
    vanishes at the fixpoint). `solve` runs the rungs in order and stops at
    the first success."""

    def __init__(self, N, Q, R, m, Qf, rho_soft=1e6, rho_soft_l1=None,
                 opts: SQPOptions = SOFT_SQP_OPTS, prox_ladder=(0.0, 1.0, 10.0)):
        self.N = int(N)
        self.m = m
        self.Q, self.R, self.Qf = Q, R, Qf
        self.rho_soft = float(rho_soft)
        self.rho_soft_l1 = float(rho_soft if rho_soft_l1 is None else rho_soft_l1)
        self.opts = opts
        self.prox_ladder = tuple(float(p) for p in prox_ladder)

    def solve(self, x0, x_guess=None, u_guess=None):
        """Returns the reference's dict: success, primal_x (nx, N+1),
        primal_u (nu, N), primal_gamma (the stage slacks stage by stage, then
        the terminal ones), cost, cost_nominal and iters (of the last rung)."""
        dtype, device = self.m.G.dtype, self.m.G.device
        t = lambda a: torch.as_tensor(np.array(a, float), dtype=dtype, device=device)
        X_init = None if x_guess is None else t(np.asarray(x_guess).T)[None]
        U_init = None if u_guess is None else t(np.asarray(u_guess).T)[None]
        x0 = t(x0).reshape(1, -1)
        sol = None
        for prox in self.prox_ladder:
            sol = soft_nlp_solve(self.m, self.N, self.Q, self.R, self.Qf, x0,
                                 rho_soft=self.rho_soft, rho_soft_l1=self.rho_soft_l1,
                                 X_init=X_init, U_init=U_init, opts=self.opts, prox=prox)
            if bool(sol.success[0]):
                break
        host = lambda a: a[0].detach().cpu().numpy()
        return {
            "success": bool(sol.success[0]),
            "primal_x": host(sol.X).T,
            "primal_u": host(sol.U).T,
            "primal_gamma": np.concatenate([host(sol.gamma).reshape(-1), host(sol.gamma_f)]),
            "cost": float(sol.cost[0]),
            "cost_nominal": float(sol.cost_nominal[0]),
            "iters": int(sol.iters[0]),
        }

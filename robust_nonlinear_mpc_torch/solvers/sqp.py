"""Multiple-shooting SQP for the nominal trajectory NLP (port of
`robust_nonlinear_mpc_tpu/solvers/sqp.py`), batched over initial states.

    min  sum_k x_k' Q x_k + u_k' R u_k + x_N' Qf x_N
    s.t. x_{k+1} = f(x_k, u_k),  x_0 = x0,  G [x_k; u_k] <= g,  Gf x_N <= gf

Gauss-Newton subproblems go to the Riccati-KKT IPM; globalization is an l1
merit function with a backtracking line search evaluated on the whole
step-size grid at once. The JAX `lax.while_loop` under `vmap` is a masked
batch loop: a lane iterates while it is not done and under max_iter, and a
lane that has stopped keeps its iterate (`masked_iteration`); the body reads
nothing from the host, so on the card it is a CUDA graph replayed while any
lane is active (`utils.graph_loop`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from robust_nonlinear_mpc_torch.ops.qp_ipm import (
    IPMOptions,
    QPData,
    QPStatics,
    solve_qp,
)
from robust_nonlinear_mpc_torch.utils.batch import lane_max_abs, tree_leaves, tree_where
from robust_nonlinear_mpc_torch.utils.graph_loop import GraphSet


class SQPOptions(NamedTuple):
    max_iter: int = 60
    tol_step: float = 1e-9
    tol_feas: float = 1e-9
    merit_rho_min: float = 1e2
    n_alphas: int = 14         # line-search grid 1, 1/2, ..., 2^-(n-1)
    ipm: IPMOptions = IPMOptions(max_iter=40, tol=1e-10)


class SQPSolution(NamedTuple):
    X: torch.Tensor        # (B, N+1, nx)
    U: torch.Tensor        # (B, N, nu)
    cost: torch.Tensor     # (B,)
    feas: torch.Tensor
    step_norm: torch.Tensor
    iters: torch.Tensor    # (B,) int32
    success: torch.Tensor  # (B,) bool
    lam: torch.Tensor
    lam_f: torch.Tensor
    dual_vec: torch.Tensor


def _traj_cost(X, U, Q, R, Qf):
    N = U.shape[-2]
    return (
        ((X[..., :N, :] @ Q.T) * X[..., :N, :]).sum(dim=(-1, -2))
        + ((U @ R.T) * U).sum(dim=(-1, -2))
        + (X[..., N, :] * (X[..., N, :] @ Qf.T)).sum(dim=-1)
    )


def line_search_index(mvals, m0, alphas):
    """Largest alpha with sufficient merit decrease, else the best merit.
    mvals (B, n_alphas) for alphas sorted descending; m0 (B,)."""
    dec = mvals < m0[:, None] - 1e-4 * alphas[None] * torch.clamp(
        m0 - mvals.amin(dim=1), min=0.0
    )[:, None]
    first_ok = torch.argmax(dec.to(torch.int32), dim=1)  # first True
    return torch.where(dec.any(dim=1), first_ok, torch.argmin(mvals, dim=1))


def sqp_solve(model, N: int, Q, R, Qf, x0: torch.Tensor,
              X_init=None, U_init=None, opts: SQPOptions = SQPOptions(),
              graphs: GraphSet | None = None, name: str = "sqp") -> SQPSolution:
    """Solve the nominal NLP for a batch of initial states x0 (B, nx). The
    iterations are a masked loop (`graphs.loop` `name`: eager, or a
    `utils.graph_loop.CapturedLoop` on the card, whose body runs its QP at
    the IPM's cap)."""
    nx, nu, ni = model.nx, model.nu, model.ni
    dtype, device = x0.dtype, x0.device
    Bsz = x0.shape[0]

    # dtype-aware tolerance floors (no-ops in float64)
    eps = torch.finfo(dtype).eps
    tol_step = max(float(opts.tol_step), 1e3 * eps)
    tol_feas = max(float(opts.tol_feas), 1e3 * eps)
    ipm_opts = opts.ipm
    if ipm_opts.tol < 30 * eps:
        ipm_opts = ipm_opts._replace(tol=30 * eps)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    Q, R, Qf = as_t(Q), as_t(R), as_t(Qf)
    G, g, Gf, gf = model.G, model.g, model.Gf, model.gf
    Gx, Gu = G[:, :nx], G[:, nx:]
    stat = QPStatics(Hx=2 * Q, Hu=2 * R, HxN=2 * Qf, Gx=Gx, Gu=Gu, Gf=Gf)

    X = x0.new_zeros((Bsz, N + 1, nx)) if X_init is None else as_t(X_init).clone()
    U = x0.new_zeros((Bsz, N, nu)) if U_init is None else as_t(U_init).clone()
    alphas = 0.5 ** torch.arange(opts.n_alphas, dtype=dtype, device=device)

    def defects(X, U):
        return model.ddyn(X[..., :N, :], U) - X[..., 1 : N + 1, :]

    def merit(X, U, x0, rho):
        d = defects(X, U)
        init_gap = (X[..., 0, :] - x0).abs().sum(dim=-1)
        return _traj_cost(X, U, Q, R, Qf) + rho * (d.abs().sum(dim=(-1, -2)) + init_gap)

    def iterate(X, U, rho, x0):
        A, B, c = model.linearize_traj(X, U)
        h = g - X[:, :N] @ Gx.T - U @ Gu.T
        hf = gf - X[:, N] @ Gf.T
        qx = torch.cat([2 * (X[:, :N] @ Q.T), (2 * (X[:, N] @ Qf.T))[:, None]], dim=1)
        qu = 2 * (U @ R.T)
        data = QPData(A=A, B=B, c=c, qx=qx, qu=qu, h=h, hf=hf, xinit=x0 - X[:, 0])
        sol = solve_qp(stat, data, ipm_opts)

        rho_n = torch.maximum(
            torch.clamp(rho, min=opts.merit_rho_min),
            2.0 * torch.maximum(lane_max_abs(sol.nu_dyn), lane_max_abs(sol.nu_init)),
        )
        m0 = merit(X, U, x0, rho_n)
        a4 = alphas[None, :, None, None]
        mvals = merit(X[:, None] + a4 * sol.X[:, None], U[:, None] + a4 * sol.U[:, None],
                      x0[:, None], rho_n[:, None])
        a = alphas[line_search_index(mvals, m0, alphas)][:, None, None]
        X_n = X + a * sol.X
        U_n = U + a * sol.U
        step_n = torch.maximum(lane_max_abs(sol.X), lane_max_abs(sol.U))
        feas_n = lane_max_abs(defects(X_n, U_n))
        conv = (step_n < tol_step) & (feas_n < tol_feas) & sol.success
        return (X_n, U_n, rho_n, step_n, feas_n, sol.lam, sol.lam_f, sol.nu_dyn), conv, ~sol.success

    def body(state, x0):
        return masked_iteration(state, iterate(*state[0][:3], x0), opts.max_iter)

    full = lambda v: torch.full((Bsz,), v, dtype=dtype, device=device)
    nlp = (X, U, full(opts.merit_rho_min), full(float("inf")), full(float("inf")),
           x0.new_zeros((Bsz, N, ni)), x0.new_zeros((Bsz, model.ni_f)),
           x0.new_zeros((Bsz, N, nx)))
    graphs = GraphSet() if graphs is None else graphs
    state = graphs.loop(name, functools.partial(any_active, max_iter=opts.max_iter), body,
                    loop_state0(nlp), x0, cap=opts.max_iter)
    (X, U, rho, step_norm, feas, lam, lam_f, nu_dyn), it, _, success = state
    success = success | ((feas < max(1e-6, tol_feas)) & (step_norm < max(1e-6, 10 * tol_step)))
    dual_vec = torch.cat([nu_dyn.reshape(Bsz, -1), lam.reshape(Bsz, -1), lam_f], dim=1)
    # clones: on the card the state is the loop's static buffers
    return SQPSolution(
        X=X.clone(), U=U.clone(), cost=_traj_cost(X, U, Q, R, Qf), feas=feas.clone(),
        step_norm=step_norm.clone(), iters=it.clone(), success=success, lam=lam.clone(),
        lam_f=lam_f.clone(), dual_vec=dual_vec,
    )


def loop_state0(nlp):
    """The masked loop's state: (the iterate's tensors, it, done, success)."""
    B = tree_leaves(nlp)[0].shape[0]
    device = tree_leaves(nlp)[0].device
    no = torch.zeros((B,), dtype=torch.bool, device=device)
    return nlp, torch.zeros((B,), dtype=torch.int32, device=device), no, no


def any_active(state, *_, max_iter):
    _, it, done, _ = state
    return ((~done) & (it < max_iter)).any()


def masked_iteration(state, stepped, max_iter):
    """One masked iteration of the SQP loop (the JAX `while_loop` body under
    `vmap`): the lanes not done and under `max_iter` take `stepped` = (new
    iterate, converged, failed); the others keep theirs."""
    nlp, it, done, success = state
    new, conv, fail = stepped
    active = (~done) & (it < max_iter)
    return (tree_where(active, new, nlp), it + active.to(torch.int32),
            done | (active & (conv | fail)), torch.where(active, conv, success))

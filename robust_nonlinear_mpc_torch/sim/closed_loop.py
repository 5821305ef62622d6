"""One true closed-loop MPC step for a batch of lanes (port of the RTI
branch of `make_mpc_step` in `robust_nonlinear_mpc_tpu/sim/closed_loop.py`).

Each call runs `rti` SCP iterations, applies u0, steps the plant
x+ = f(x, u0) + E w and warm-shifts the plan and the recycled SLS state.
The until-convergence branch (rti <= 0) and the host-loop drivers are not
ported (ROADMAP.md Open items 1.7 and 1.10).
"""

from __future__ import annotations

import torch

from robust_nonlinear_mpc_torch.solvers.fast_sls import (
    FastSLSPersist,
    warm_shift_persist,
)
from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver
from robust_nonlinear_mpc_torch.utils.batch import lane_all_finite, lane_where, tree_where


def _accept(X, U, persist, res):
    """Accept any finite iterate (per lane), even from a reported failure;
    a non-finite solve keeps the previous plan and SLS state."""
    finite = lane_all_finite(res.X, res.U)
    X = lane_where(finite, res.X, X)
    U = lane_where(finite, res.U, U)
    persist = tree_where(finite, res.persist, persist)
    return X, U, persist, finite


def make_mpc_step(solver: SCPSLSSolver):
    """(carry, w_t) -> (carry', out) with carry = (X, U, persist, x), all
    batch-leading, and w_t (B, nw). out = (x, u0, X, U, backoff_x,
    backoff_u, success, qp_iters, scp_iters, scp_failed)."""
    m = solver.m
    N = solver.N
    rti = int(solver.opts.rti)
    if rti <= 0:
        raise NotImplementedError(
            "the until-convergence closed-loop step (rti <= 0) is not ported: "
            "ROADMAP.md Open items 1.10"
        )
    fopts = solver._fast_sls_opts()

    def mpc_step(carry, w_t):
        X, U, persist, x = carry
        res = None
        qp_total = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
        for _ in range(rti):
            res = solver._iteration(X, U, x, persist)
            X, U, persist, _ = _accept(X, U, persist, res)
            qp_total = qp_total + res.sls.qp_iters
        bx, bu = res.sls.backoff_x, res.sls.backoff_u
        success = res.success
        scp_it = torch.full_like(qp_total, rti)
        u0 = U[:, 0]
        x_next = m.ddyn(x, u0) + w_t @ m.E.T
        Xs, Us = solver._warm_shift(X, U)
        persist_next = FastSLSPersist.init(
            N, m.nx, m.nu, m.ni, m.ni_f, m.nw,
            batch=x.shape[0], dtype=x.dtype, device=x.device,
            keep_prev=persist.prev_primal,
            store_phi=persist.Phi_x.shape[2] > 0,
        )._replace(have_prev=persist.have_prev)
        if fopts.recycle_eta:
            shifted = warm_shift_persist(persist)
            persist_next = persist_next._replace(eta=shifted.eta, eta_f=shifted.eta_f)
            if fopts.recycle_warm_qp:
                persist_next = persist_next._replace(qp_warm=shifted.qp_warm)
        out = (x, u0, X, U, bx, bu, success, qp_total, scp_it, ~res.success)
        return (Xs, Us, persist_next, x_next), out

    return mpc_step

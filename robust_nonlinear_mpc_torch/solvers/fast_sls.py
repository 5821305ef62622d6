"""fast-SLS tube synthesis in its dual-recycling RTI form (port of the
`recycle_eta` branch of `robust_nonlinear_mpc_tpu/solvers/fast_sls.py`).

One tightened QP per solve: the backward Riccati uses the eta weights kept
from the previous solve's QP duals, the streaming response computes the
backoffs of the current linearization and gains, and the QP is warm-started
from the previous solve's QP solution. All state is batch-leading.

Not ported (they raise NotImplementedError): the two-QP RTI and
until-convergence branches, the Phi-materializing response, the Pallas
response, the column-blocked and lane-packed SLS kernels and column sharding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from robust_nonlinear_mpc_torch.ops.packing import pack_primal
from robust_nonlinear_mpc_torch.ops.qp_ipm import (
    IPMOptions,
    QPData,
    QPSolution,
    QPStatics,
    solve_qp,
)
from robust_nonlinear_mpc_torch.ops.sls_kernels import (
    SLSRegs,
    backward_solve_folded,
    evaluate_dual_eta,
    response_streaming_folded,
)
from robust_nonlinear_mpc_torch.utils.batch import lane_max_abs, lane_where


class SLSProblem(NamedTuple):
    stat: QPStatics
    regs: SLSRegs
    E: torch.Tensor      # (N+1, nx, nw)


class FastSLSOptions(NamedTuple):
    rti_steps: int = 0
    verbose: bool = False
    max_iter: int = 30
    conv_tol: float = 1e-3
    epsilon_backoff: float = 1e-10
    use_pallas_response: bool = False
    streaming_response: bool = False
    recycle_eta: bool = False
    recycle_warm_qp: bool = False
    ipm: IPMOptions = IPMOptions()
    ipm_first: IPMOptions | None = None
    sls_block: int = 0
    adaptive_ipm_budget: tuple | None = None
    column_mesh: object = None


class QPWarm(NamedTuple):
    """Previous QP solution kept across solves (recycle_warm_qp)."""

    X: torch.Tensor        # (B, N+1, nx)
    U: torch.Tensor        # (B, N, nu)
    lam: torch.Tensor      # (B, N, ni)
    lam_f: torch.Tensor    # (B, ni_f)
    nu_dyn: torch.Tensor   # (B, N, nx)
    valid: torch.Tensor    # (B,) bool

    @staticmethod
    def init(N, nx, nu, ni, ni_f, *, batch, dtype, device):
        z = lambda *s: torch.zeros((batch,) + s, dtype=dtype, device=device)
        o = lambda *s: torch.ones((batch,) + s, dtype=dtype, device=device)
        return QPWarm(
            X=z(N + 1, nx), U=z(N, nu), lam=o(N, ni), lam_f=o(ni_f),
            nu_dyn=z(N, nx),
            valid=torch.zeros((batch,), dtype=torch.bool, device=device),
        )


class FastSLSPersist(NamedTuple):
    """State that survives across fast-SLS solves (see the JAX twin)."""

    prev_primal: torch.Tensor   # (B, (nx+nu)N + nx)
    have_prev: torch.Tensor     # (B,) bool
    eta: torch.Tensor           # (B, N, N, ni)
    eta_f: torch.Tensor         # (B, N+1, ni_f)
    K: torch.Tensor             # (B, N, N+1, nu, nx)
    Phi_x: torch.Tensor         # (B, N+1, N+1 or 0, nx, nw)
    Phi_u: torch.Tensor         # (B, N, N+1 or 0, nu, nw)
    cost_tube: torch.Tensor     # (B,)
    qp_warm: QPWarm
    qp_steady: torch.Tensor     # (B,) bool

    @staticmethod
    def init(N, nx, nu, ni, ni_f, nw, *, batch, dtype, device,
             keep_prev=None, store_phi=True):
        """store_phi=False allocates zero-size Phi buffers (streaming mode)."""
        z = lambda *s: torch.zeros((batch,) + s, dtype=dtype, device=device)
        flag = lambda v: torch.full((batch,), v, dtype=torch.bool, device=device)
        n_phi = (N + 1) if store_phi else 0
        return FastSLSPersist(
            prev_primal=z((nx + nu) * N + nx) if keep_prev is None else keep_prev,
            have_prev=flag(keep_prev is not None),
            eta=z(N, N, ni),
            eta_f=z(N + 1, ni_f),
            K=z(N, N + 1, nu, nx),
            Phi_x=z(N + 1, n_phi, nx, nw),
            Phi_u=z(N, n_phi, nu, nw),
            cost_tube=torch.full((batch,), float("nan"), dtype=dtype, device=device),
            qp_warm=QPWarm.init(N, nx, nu, ni, ni_f, batch=batch, dtype=dtype, device=device),
            qp_steady=flag(False),
        )


def _shift_repeat(a, axis):
    """out[k] = a[k+1] along `axis`, with the last entry repeated."""
    n = a.shape[axis]
    src = torch.clamp(torch.arange(n, device=a.device) + 1, max=n - 1)
    return torch.index_select(a, axis, src)


def warm_shift_persist(persist: FastSLSPersist) -> FastSLSPersist:
    """Stage-shift the recycled eta at an MPC warm shift (batch axis 0, so
    the JAX axes 0/1 of eta are axes 1/2 here); qp_warm is carried as is."""
    eta = _shift_repeat(_shift_repeat(persist.eta, 1), 2)
    eta_f = _shift_repeat(persist.eta_f, 1)
    return persist._replace(eta=eta, eta_f=eta_f)


class FastSLSSolution(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    y: torch.Tensor
    lam: torch.Tensor
    lam_f: torch.Tensor
    eta: torch.Tensor
    eta_f: torch.Tensor
    K: torch.Tensor
    Phi_x: torch.Tensor
    Phi_u: torch.Tensor
    beta: torch.Tensor
    beta_f: torch.Tensor
    backoff: torch.Tensor
    backoff_f: torch.Tensor
    backoff_x: torch.Tensor    # (B, N+1, nx)
    backoff_u: torch.Tensor    # (B, N, nu)
    cost_nominal: torch.Tensor
    cost_tube: torch.Tensor
    iteration_number: torch.Tensor
    success: torch.Tensor
    persist: FastSLSPersist
    qp_iters: torch.Tensor
    qp_kkt: torch.Tensor


def _check_options(opts: FastSLSOptions):
    missing = [
        (not opts.recycle_eta,
         "the two-QP RTI and until-convergence fast-SLS branches "
         "(recycle_eta=False) are not ported: ROADMAP.md Open items 1.5"),
        (not opts.streaming_response,
         "the Phi-materializing response (streaming_response=False) is not "
         "ported: ROADMAP.md Open items 1.4"),
        (opts.use_pallas_response,
         "use_pallas_response needs kernel K4: ROADMAP.md Open items 2"),
        (opts.sls_block != 0,
         "the column-blocked / lane-packed SLS kernels (sls_block != 0) are "
         "not ported: ROADMAP.md Open items 1.4"),
        (opts.column_mesh is not None,
         "column sharding is not ported: ROADMAP.md Open items 1.11"),
    ]
    for bad, msg in missing:
        if bad:
            raise NotImplementedError(msg)


def fast_sls_solve(
    prob: SLSProblem,
    A, B, c, qx, qu, g_res, gf_res, xinit_dev,
    persist: FastSLSPersist,
    opts: FastSLSOptions,
) -> FastSLSSolution:
    """One dual-recycling fast-SLS solve for a batch of deviation problems:
    A (B, N, nx, nx), B (B, N, nx, nu), c (B, N, nx), qx (B, N+1, nx),
    qu (B, N, nu), g_res (B, N, ni), gf_res (B, ni_f), xinit_dev (B, nx)."""
    _check_options(opts)
    N, nx = c.shape[1], c.shape[2]
    nu = B.shape[3]
    eps = opts.epsilon_backoff
    Gmat = torch.cat([prob.stat.Gx, prob.stat.Gu], dim=1)

    steady_cap = None
    budget = None
    if opts.adaptive_ipm_budget is not None:
        steady_cap, cold_cap = opts.adaptive_ipm_budget
        budget = torch.where(persist.qp_steady, steady_cap, cold_cap).to(torch.int32)

    def warm_init():
        w = persist.qp_warm
        v = w.valid
        fill = lambda t, val: lane_where(v, t, torch.full_like(t, val))
        return QPSolution(
            X=fill(w.X, 0.0), U=fill(w.U, 0.0), lam=fill(w.lam, 1.0),
            lam_f=fill(w.lam_f, 1.0), nu_dyn=fill(w.nu_dyn, 0.0),
            nu_init=None, s=None, s_f=None, cost=None, kkt_res=None,
            iters=None, success=v,
        )

    def update_warm(sol):
        w = persist.qp_warm
        keep = sol.success
        pick = lambda new, old: lane_where(keep, new, old)
        return QPWarm(
            X=pick(sol.X, w.X), U=pick(sol.U, w.U),
            lam=pick(sol.lam, w.lam), lam_f=pick(sol.lam_f, w.lam_f),
            nu_dyn=pick(sol.nu_dyn, w.nu_dyn),
            valid=keep | w.valid,
        )

    K_r = backward_solve_folded(
        A, B, Gmat, prob.stat.Gf, persist.eta, persist.eta_f, prob.regs
    )[1]
    nbeta, nbeta_f, nboff, nboff_f, ct = response_streaming_folded(
        A, B, prob.E, K_r, prob.stat.Gx, prob.stat.Gu, prob.stat.Gf, prob.regs, eps
    )
    Phi_x = torch.zeros_like(persist.Phi_x)
    Phi_u = torch.zeros_like(persist.Phi_u)

    data = QPData(A=A, B=B, c=c, qx=qx, qu=qu, h=g_res - nboff,
                  hf=gf_res - nboff_f, xinit=xinit_dev)
    sol = solve_qp(prob.stat, data, opts.ipm,
                   init=warm_init() if opts.recycle_warm_qp else None,
                   max_iter_dyn=budget)
    y = pack_primal(sol.X, sol.U)
    conv = persist.have_prev & (lane_max_abs(y - persist.prev_primal) <= opts.conv_tol)
    eta_n, eta_f_n = evaluate_dual_eta(sol.lam, sol.lam_f, nbeta, nbeta_f, eps)
    refresh = sol.success & ~conv
    eta_n = lane_where(refresh, eta_n, persist.eta)
    eta_f_n = lane_where(refresh, eta_f_n, persist.eta_f)
    qp_steady = (
        persist.qp_steady if steady_cap is None
        else sol.success & (sol.iters < steady_cap)
    )
    new_persist = FastSLSPersist(
        prev_primal=y, have_prev=torch.ones_like(persist.have_prev),
        eta=eta_n, eta_f=eta_f_n, K=K_r,
        Phi_x=Phi_x, Phi_u=Phi_u, cost_tube=ct,
        qp_warm=update_warm(sol), qp_steady=qp_steady,
    )
    return FastSLSSolution(
        X=sol.X, U=sol.U, y=y, lam=sol.lam, lam_f=sol.lam_f,
        eta=eta_n, eta_f=eta_f_n, K=K_r, Phi_x=Phi_x, Phi_u=Phi_u,
        beta=nbeta, beta_f=nbeta_f, backoff=nboff, backoff_f=nboff_f,
        backoff_x=torch.cat([nboff[:, :, :nx], nboff_f[:, None, :nx]], dim=1),
        backoff_u=nboff[:, :, nx : nx + nu],
        cost_nominal=sol.cost, cost_tube=ct,
        iteration_number=torch.where(conv, 0, 1).to(torch.int32),
        success=sol.success, persist=new_persist,
        qp_iters=sol.iters, qp_kkt=sol.kkt_res,
    )

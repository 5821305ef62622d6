"""fast-SLS tube synthesis (port of `robust_nonlinear_mpc_tpu/solvers/fast_sls.py`).

Two branches, as in the JAX package, all state batch-leading:
* the two-QP iteration of the reference (`recycle_eta=False`): an
  untightened entry QP (with `ipm_first`), then per iteration eta from the
  QP duals, the backward Riccati, the response, the retightened QP; RTI mode
  runs `rti_steps` iterations and a final QP, the until-convergence mode
  iterates to the primal criterion (at most `max_iter`) as a masked batch
  loop in which a lane that has stopped keeps its state: a head (the entry
  QP and the first iteration), a body (one masked iteration, its QP a WHILE
  node nested in the loop's own inside a CUDA graph) and a finish, run by a
  `utils.graph_loop.GraphSet` (eagerly, or as CUDA graphs on the card);
* the dual-recycling RTI (`recycle_eta=True`): one tightened QP per solve,
  the backward Riccati on the eta kept from the previous solve's QP duals,
  the QP warm-started from the previous solution (`recycle_warm_qp`).

`select_sls_kernels(sls_block)` picks the backward Riccati and the
streaming response: folded (0), column-blocked (> 0), or the hand-written
backward kernel with the blocked response (-1). The response is one of
three (`compute_response`): the Phi-free streaming form, the
Phi-materializing stages, or the fused CUDA kernel (`use_pallas_response`,
`ops/fused_response.py`). With `column_mesh` (a `parallel.mesh.Mesh`) the
backward Riccati and the streaming response run column-sharded over the
mesh (`parallel/columns.py`), as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from robust_nonlinear_mpc_torch.ops.packing import pack_primal
from robust_nonlinear_mpc_torch.ops.qp_ipm import (
    IPMOptions,
    QPData,
    QPSolution,
    QPStatics,
    condense,
    solve_qp,
)
from robust_nonlinear_mpc_torch.ops.fused_backward import backward_K
from robust_nonlinear_mpc_torch.ops.sls_kernels import (
    SLSRegs,
    backoff_from_phi,
    backward_solve_blocked,
    backward_solve_folded,
    evaluate_dual_eta,
    propagate,
    response_streaming_blocked,
    response_streaming_folded,
    tube_cost,
)
from robust_nonlinear_mpc_torch.utils.batch import lane_max_abs, lane_where, tree_where
from robust_nonlinear_mpc_torch.utils.graph_loop import GraphSet
from robust_nonlinear_mpc_torch.utils.numerics import tube_precision
from robust_nonlinear_mpc_torch.utils.stages import stage


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
    # warm-start each retightened QP of the two-QP iteration from the
    # previous one (off, as in the JAX package)
    warm_start_qp: bool = False
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


def select_sls_kernels(block: int):
    """(backward_solve, response_streaming) for a column-block size (the JAX
    `select_sls_kernels`). block = 0: the GEMM-folded kernels; block > 0: the
    triangular column-blocked ones with stage segments of `block`; block = -1:
    the hand-written backward kernel (`ops/fused_backward.backward_K`, the
    counterpart of the Pallas `_backward_kernel`; K only, S is None) with the
    column-blocked response at block 2; any other block, as in the JAX
    package, the folded ones. Each backward returns (S, K)."""
    if block == -1:
        def backward(A, B, Gmat, Gf, eta, eta_f, regs):
            return None, backward_K(A, B, Gmat, Gf, eta, eta_f, regs)

        return backward, functools.partial(response_streaming_blocked, block=2)
    if block > 0:
        return (functools.partial(backward_solve_blocked, block=block),
                functools.partial(response_streaming_blocked, block=block))
    return backward_solve_folded, response_streaming_folded


def compute_response(prob: SLSProblem, A, B, K, opts: FastSLSOptions, phi_like_x, phi_like_u):
    """Propagation + backoffs + tube cost by the configured path: the fused
    CUDA kernel (float32, cast back), the streaming form that
    `select_sls_kernels(opts.sls_block)` picks, or its column-sharded form
    whenever `opts.column_mesh` is set (zero Phi buffers shaped like
    `phi_like_*`), or the Phi-materializing stages. Returns
    (Phi_x, Phi_u, beta, beta_f, backoff, backoff_f, cost_tube)."""
    stat, eps = prob.stat, opts.epsilon_backoff
    if opts.use_pallas_response:
        from robust_nonlinear_mpc_torch.ops.fused_response import fused_response

        out = fused_response(A, B, prob.E, K, stat.Gx, stat.Gu, stat.Gf, *prob.regs, eps=eps)
        return tuple(t.to(A.dtype) for t in out)
    if opts.streaming_response or opts.column_mesh is not None:
        if opts.column_mesh is not None:
            from robust_nonlinear_mpc_torch.parallel.columns import column_sharded_response

            response_streaming = functools.partial(column_sharded_response, opts.column_mesh)
        else:
            response_streaming = select_sls_kernels(opts.sls_block)[1]
        nbeta, nbeta_f, nboff, nboff_f, ct = response_streaming(
            A, B, prob.E, K, stat.Gx, stat.Gu, stat.Gf, prob.regs, eps
        )
        return (torch.zeros_like(phi_like_x), torch.zeros_like(phi_like_u),
                nbeta, nbeta_f, nboff, nboff_f, ct)
    Phi_x, Phi_u = propagate(A, B, prob.E, K)
    ct = tube_cost(Phi_x, Phi_u, prob.regs)
    return (Phi_x, Phi_u, *backoff_from_phi(Phi_x, Phi_u, stat.Gx, stat.Gu, stat.Gf, eps), ct)


class _Carry(NamedTuple):
    """Per-lane state of the two-QP iteration (the JAX `Carry`)."""

    sol: QPSolution
    eta: torch.Tensor
    eta_f: torch.Tensor
    K: torch.Tensor
    Phi_x: torch.Tensor
    Phi_u: torch.Tensor
    beta: torch.Tensor
    beta_f: torch.Tensor
    backoff: torch.Tensor
    backoff_f: torch.Tensor
    backoff_x: torch.Tensor
    backoff_u: torch.Tensor
    applied: torch.Tensor
    applied_f: torch.Tensor
    cost_tube: torch.Tensor
    prev_primal: torch.Tensor
    have_prev: torch.Tensor
    converged: torch.Tensor
    infeasible: torch.Tensor
    iteration_number: torch.Tensor
    qp_iters: torch.Tensor
    qp_kkt: torch.Tensor
    delta: torch.Tensor       # (B,) the last iteration's primal change
    active: torch.Tensor      # (B,) bool: False, the lane entered stopped


def _backoff_xu(nboff, nboff_f, nx, nu):
    return (torch.cat([nboff[:, :, :nx], nboff_f[:, None, :nx]], dim=1),
            nboff[:, :, nx : nx + nu])


def _print_rows(carry: _Carry, lanes):
    """The per-iteration table of the reference fast-SLS (one row per lane
    that stepped), printed from the host."""
    lanes = lanes.nonzero().flatten().tolist()
    it = carry.iteration_number.tolist()
    if any(it[b] <= 1 for b in lanes):
        print("\t{:>4} {:>10} {:>11} {:>11} {:>11} {:>6}".format(
            "it", "Δ primal", "cost nom.", "cost tube", "cost total", "qp it"))
    cn, ct, dp = carry.sol.cost.tolist(), carry.cost_tube.tolist(), carry.delta.tolist()
    qi = carry.qp_iters.tolist()
    for b in lanes:
        print(f"\t{it[b]:>4} {dp[b]:>10.2e} {cn[b]:>11.4e} {ct[b]:>11.4e} "
              f"{cn[b] + ct[b]:>11.4e} {qi[b]:>6}")


class _Solve:
    """The pieces of one fast-SLS solve over its inputs: the deviation
    problem `dev` = (A, B, c, qx, qu, g_res, gf_res, xinit_dev), the state
    persisted from the last solve and the condensed-KKT precompute `pre`
    (built from (A, B) when None, for kkt="condensed"; one for every QP of
    the solve)."""

    def __init__(self, prob: SLSProblem, opts: FastSLSOptions, dev, persist: FastSLSPersist,
                 pre=None):
        self.prob, self.opts, self.dev, self.persist = prob, opts, dev, persist
        A, B = dev[0], dev[1]
        if opts.column_mesh is not None:
            from robust_nonlinear_mpc_torch.parallel.columns import column_sharded_backward_solve

            self.gains = functools.partial(column_sharded_backward_solve, opts.column_mesh)
        else:
            solve = select_sls_kernels(opts.sls_block)[0]
            self.gains = lambda *a: solve(*a)[1]
        self.Gmat = torch.cat([prob.stat.Gx, prob.stat.Gu], dim=1)
        self.steady_cap = self.budget = self.budget_bound = None
        if opts.adaptive_ipm_budget is not None:
            self.steady_cap, cold_cap = opts.adaptive_ipm_budget
            self.budget = torch.where(persist.qp_steady, self.steady_cap, cold_cap).to(torch.int32)
            self.budget_bound = max(int(self.steady_cap), int(cold_cap))
        if pre is None and "condensed" in (opts.ipm.kkt, getattr(opts.ipm_first, "kkt", None)):
            pre = condense(prob.stat.per_stage(A.shape[1]), A, B)
        self.pre = pre

    def forward(self, applied, applied_f, init=None, first=False):
        A, B, c, qx, qu, g_res, gf_res, xinit_dev = self.dev
        opts = self.opts
        data = QPData(A=A, B=B, c=c, qx=qx, qu=qu, h=g_res - applied,
                      hf=gf_res - applied_f, xinit=xinit_dev)
        with stage("sls.qp"):
            if first and opts.ipm_first is not None:
                return solve_qp(self.prob.stat, data, opts.ipm_first, init=init, pre=self.pre)
            return solve_qp(self.prob.stat, data, opts.ipm, init=init, max_iter_dyn=self.budget,
                            max_iter_bound=self.budget_bound, pre=self.pre)

    def warm_init(self):
        w = self.persist.qp_warm
        v = w.valid
        fill = lambda t, val: lane_where(v, t, torch.full_like(t, val))
        return QPSolution(
            X=fill(w.X, 0.0), U=fill(w.U, 0.0), lam=fill(w.lam, 1.0),
            lam_f=fill(w.lam_f, 1.0), nu_dyn=fill(w.nu_dyn, 0.0),
            nu_init=None, s=None, s_f=None, cost=None, kkt_res=None,
            iters=None, success=v,
        )

    def update_warm(self, sol):
        w = self.persist.qp_warm
        keep = sol.success
        pick = lambda new, old: lane_where(keep, new, old)
        return QPWarm(
            X=pick(sol.X, w.X), U=pick(sol.U, w.U),
            lam=pick(sol.lam, w.lam), lam_f=pick(sol.lam_f, w.lam_f),
            nu_dyn=pick(sol.nu_dyn, w.nu_dyn),
            valid=keep | w.valid,
        )

    def next_steady(self, sol):
        if self.steady_cap is None:
            return self.persist.qp_steady
        return sol.success & (sol.iters < self.steady_cap)

    def tube(self, eta, eta_f, phi_like_x, phi_like_u):
        """K from eta by the backward Riccati, then the response."""
        A, B = self.dev[0], self.dev[1]
        with stage("sls.backward"), tube_precision():
            K = self.gains(A, B, self.Gmat, self.prob.stat.Gf, eta, eta_f, self.prob.regs)
        with stage("sls.response"), tube_precision():
            return K, compute_response(self.prob, A, B, K, self.opts, phi_like_x, phi_like_u)

    def recycled(self) -> FastSLSSolution:
        """The dual-recycling RTI: K from the persisted eta, one tightened QP."""
        persist, opts = self.persist, self.opts
        nx, nu = self.dev[0].shape[2], self.dev[1].shape[3]
        eps = opts.epsilon_backoff
        K_r, (Phi_x, Phi_u, nbeta, nbeta_f, nboff, nboff_f, ct) = self.tube(
            persist.eta, persist.eta_f, persist.Phi_x, persist.Phi_u)
        sol = self.forward(nboff, nboff_f, init=self.warm_init() if opts.recycle_warm_qp else None)
        y = pack_primal(sol.X, sol.U)
        conv = persist.have_prev & (lane_max_abs(y - persist.prev_primal) <= opts.conv_tol)
        eta_n, eta_f_n = evaluate_dual_eta(sol.lam, sol.lam_f, nbeta, nbeta_f, eps)
        refresh = sol.success & ~conv
        eta_n = lane_where(refresh, eta_n, persist.eta)
        eta_f_n = lane_where(refresh, eta_f_n, persist.eta_f)
        new_persist = FastSLSPersist(
            prev_primal=y, have_prev=torch.ones_like(persist.have_prev),
            eta=eta_n, eta_f=eta_f_n, K=K_r,
            Phi_x=Phi_x, Phi_u=Phi_u, cost_tube=ct,
            qp_warm=self.update_warm(sol), qp_steady=self.next_steady(sol),
        )
        backoff_x, backoff_u = _backoff_xu(nboff, nboff_f, nx, nu)
        return FastSLSSolution(
            X=sol.X, U=sol.U, y=y, lam=sol.lam, lam_f=sol.lam_f,
            eta=eta_n, eta_f=eta_f_n, K=K_r, Phi_x=Phi_x, Phi_u=Phi_u,
            beta=nbeta, beta_f=nbeta_f, backoff=nboff, backoff_f=nboff_f,
            backoff_x=backoff_x, backoff_u=backoff_u,
            cost_nominal=sol.cost, cost_tube=ct,
            iteration_number=torch.where(conv, 0, 1).to(torch.int32),
            success=sol.success, persist=new_persist,
            qp_iters=sol.iters, qp_kkt=sol.kkt_res,
        )

    def sls_update(self, carry: _Carry) -> _Carry:
        """eta -> backward Riccati -> response -> retighten."""
        sol = carry.sol
        eps = self.opts.epsilon_backoff
        nx, nu = self.dev[0].shape[2], self.dev[1].shape[3]
        eta, eta_f = evaluate_dual_eta(sol.lam, sol.lam_f, carry.beta, carry.beta_f, eps)
        K, (Phi_x, Phi_u, nbeta, nbeta_f, nboff, nboff_f, ct) = self.tube(
            eta, eta_f, carry.Phi_x, carry.Phi_u)
        backoff_x, backoff_u = _backoff_xu(nboff, nboff_f, nx, nu)
        return carry._replace(
            eta=eta, eta_f=eta_f, K=K, Phi_x=Phi_x, Phi_u=Phi_u,
            beta=nbeta, beta_f=nbeta_f, backoff=nboff, backoff_f=nboff_f,
            backoff_x=backoff_x, backoff_u=backoff_u,
            applied=nboff, applied_f=nboff_f, cost_tube=ct,
            iteration_number=carry.iteration_number + 1,
        )

    def step(self, carry: _Carry, resolve_forward: bool) -> _Carry:
        """One iteration (the reference `_step`): a fresh QP on the current
        tightened bounds unless it is the first, the convergence check, and
        the tube update on the lanes neither converged nor infeasible."""
        if resolve_forward:
            sol = self.forward(carry.applied, carry.applied_f,
                               init=carry.sol if self.opts.warm_start_qp else None)
            carry = carry._replace(
                sol=sol, infeasible=carry.infeasible | ~sol.success,
                qp_iters=carry.qp_iters + sol.iters,
                qp_kkt=torch.maximum(carry.qp_kkt, sol.kkt_res),
            )
        y = pack_primal(carry.sol.X, carry.sol.U)
        delta = lane_max_abs(y - carry.prev_primal)
        conv = carry.have_prev & (delta <= self.opts.conv_tol)
        carry = carry._replace(prev_primal=y, have_prev=torch.ones_like(carry.have_prev),
                               delta=delta)
        carry = tree_where(~(conv | carry.infeasible), self.sls_update(carry), carry)
        return carry._replace(converged=carry.converged | conv)

    def head(self, active=None) -> _Carry:
        """The untightened entry QP and the first iteration. `active` (B,)
        bool: the lanes that take part; the others enter stopped and keep
        what this step gives them."""
        persist, eps = self.persist, self.opts.epsilon_backoff
        A, c, g_res, gf_res = self.dev[0], self.dev[2], self.dev[5], self.dev[6]
        Bsz, N, nx = c.shape
        nu = self.dev[1].shape[3]
        ni, ni_f = g_res.shape[2], gf_res.shape[1]
        dtype, device = A.dtype, A.device
        zeros = lambda *s: torch.zeros((Bsz,) + s, dtype=dtype, device=device)
        flag = lambda v: torch.full((Bsz,), v, dtype=torch.bool, device=device)
        # the tube at solve entry (reference initialize_backoff): beta = eps,
        # and the backoff sums sqrt(eps) over all N columns
        beta0 = torch.full((Bsz, N, N, ni), eps, dtype=dtype, device=device)
        beta_f0 = torch.full((Bsz, N + 1, ni_f), eps, dtype=dtype, device=device)
        entry = self.forward(zeros(N, ni), zeros(ni_f), first=True)
        carry = _Carry(
            sol=entry, eta=persist.eta, eta_f=persist.eta_f, K=persist.K,
            Phi_x=persist.Phi_x, Phi_u=persist.Phi_u, beta=beta0, beta_f=beta_f0,
            backoff=torch.sqrt(beta0).sum(dim=2), backoff_f=torch.sqrt(beta_f0).sum(dim=1),
            backoff_x=zeros(N + 1, nx), backoff_u=zeros(N, nu),
            applied=zeros(N, ni), applied_f=zeros(ni_f), cost_tube=persist.cost_tube,
            prev_primal=persist.prev_primal, have_prev=persist.have_prev,
            converged=flag(False), infeasible=~entry.success,
            iteration_number=torch.zeros((Bsz,), dtype=torch.int32, device=device),
            qp_iters=entry.iters, qp_kkt=entry.kkt_res, delta=zeros(),
            active=flag(True) if active is None else active,
        )
        return self.step(carry, resolve_forward=False)

    def body(self, carry: _Carry) -> _Carry:
        """One masked iteration of the until-convergence loop: a lane that
        has stopped (converged, infeasible, or entered stopped) keeps its
        carry."""
        return tree_where(_running(carry), self.step(carry, resolve_forward=True), carry)

    def finish(self, carry: _Carry, success) -> FastSLSSolution:
        sol = carry.sol
        new_persist = FastSLSPersist(
            prev_primal=carry.prev_primal, have_prev=carry.have_prev,
            eta=carry.eta, eta_f=carry.eta_f, K=carry.K,
            Phi_x=carry.Phi_x, Phi_u=carry.Phi_u, cost_tube=carry.cost_tube,
            qp_warm=self.update_warm(sol), qp_steady=self.next_steady(sol),
        )
        return FastSLSSolution(
            X=sol.X, U=sol.U, y=pack_primal(sol.X, sol.U), lam=sol.lam, lam_f=sol.lam_f,
            eta=carry.eta, eta_f=carry.eta_f, K=carry.K, Phi_x=carry.Phi_x, Phi_u=carry.Phi_u,
            beta=carry.beta, beta_f=carry.beta_f, backoff=carry.backoff,
            backoff_f=carry.backoff_f, backoff_x=carry.backoff_x, backoff_u=carry.backoff_u,
            cost_nominal=sol.cost, cost_tube=carry.cost_tube,
            iteration_number=carry.iteration_number, success=success,
            persist=new_persist, qp_iters=carry.qp_iters, qp_kkt=carry.qp_kkt,
        )


def _running(carry: _Carry, *_):
    return carry.active & ~carry.converged & ~carry.infeasible


# the until-convergence solve's pieces, each a function of its tensors only
# (a CUDA graph each on the card, `utils.graph_loop.GraphSet`)
def _any_running(carry, *_):
    return _running(carry).any()


def _head(prob, opts, dev, persist, active):
    s = _Solve(prob, opts, dev, persist)
    return s.head(active), s.pre


def _body(prob, opts, carry, dev, persist, pre):
    return _Solve(prob, opts, dev, persist, pre).body(carry)


def _printed(body):
    """`body` followed by the table row of every lane that stepped."""
    def run(carry, *args):
        out = body(carry, *args)
        _print_rows(out, _running(carry))
        return out

    return run


def _finish(prob, opts, carry, dev, persist, pre):
    s = _Solve(prob, opts, dev, persist, pre)
    return s.finish(carry, carry.converged & ~carry.infeasible)


def fast_sls_solve(
    prob: SLSProblem,
    A, B, c, qx, qu, g_res, gf_res, xinit_dev,
    persist: FastSLSPersist,
    opts: FastSLSOptions,
    active=None,
    graphs: GraphSet | None = None,
) -> FastSLSSolution:
    """One fast-SLS solve for a batch of deviation problems:
    A (B, N, nx, nx), B (B, N, nx, nu), c (B, N, nx), qx (B, N+1, nx),
    qu (B, N, nu), g_res (B, N, ni), gf_res (B, ni_f), xinit_dev (B, nx).
    `opts.recycle_eta` selects the one-QP dual-recycling branch, else the
    two-QP iteration runs (RTI when `opts.rti_steps` > 0).

    Until convergence (rti_steps = 0) the solve is a head (the entry QP and
    the first iteration), a masked inner loop of at most max_iter - 1
    iterations while any lane runs (the JAX `while_loop` under `vmap`), and
    a finish, run by `graphs` (`utils.graph_loop.GraphSet`: eagerly, or each
    piece a CUDA graph on the card). `active` (B,) bool: the lanes that
    take part; the others enter the loop stopped (their result is
    meaningless), so a decided lane cannot keep the loop running."""
    dev = (A, B, c, qx, qu, g_res, gf_res, xinit_dev)
    if opts.recycle_eta:
        return _Solve(prob, opts, dev, persist).recycled()
    if opts.rti_steps:
        # RTI: exactly max(rti_steps, 1) iterations, then the final QP
        s = _Solve(prob, opts, dev, persist)
        carry = s.head(active)
        if opts.verbose:
            _print_rows(carry, carry.active)
        for _ in range(1, max(int(opts.rti_steps), 1)):
            carry = s.step(carry, resolve_forward=True)
            if opts.verbose:
                _print_rows(carry, carry.active)
        final = s.forward(carry.applied, carry.applied_f,
                          init=carry.sol if opts.warm_start_qp else None)
        # keep the last feasible solution where the loop already failed
        use_final = ~carry.infeasible
        carry = carry._replace(
            sol=tree_where(use_final, final, carry.sol),
            infeasible=carry.infeasible | (use_final & ~final.success),
            qp_iters=carry.qp_iters + torch.where(use_final, final.iters, 0),
            qp_kkt=torch.maximum(carry.qp_kkt,
                                 torch.where(use_final, final.kkt_res, 0.0)),
        )
        return s.finish(carry, ~carry.infeasible)

    # until convergence; the verbose table is printed from the host, so it
    # runs eagerly
    g = GraphSet() if graphs is None or opts.verbose else graphs
    carry, pre = g.call("sls.head", functools.partial(_head, prob, opts), dev, persist, active)
    body = functools.partial(_body, prob, opts)
    if opts.verbose:
        _print_rows(carry, carry.active)
        body = _printed(body)
    carry = g.loop("sls.inner", _any_running, body, carry, dev, persist, pre,
                   cap=max(int(opts.max_iter) - 1, 0))
    return g.call("sls.finish", functools.partial(_finish, prob, opts), carry, dev, persist, pre)

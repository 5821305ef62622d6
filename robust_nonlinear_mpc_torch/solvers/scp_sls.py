"""SCP-SLS: sequential convex programming over System Level Synthesis (port
of `robust_nonlinear_mpc_tpu/solvers/scp_sls.py`, the parts the batched
closed-loop step runs).

`SCPSLSSolver` is an `nn.Module`: the model is a submodule and the problem
data (cost and regularizer matrices, constraint polytopes, the disturbance
maps E) are registered buffers, so `.to(device)` moves the whole problem.
`_iteration` is one SCP iteration for a batch of lanes: linearize, assemble
the deviation problem, run fast-SLS, update the nominal.

Not ported yet: the host-side `solve` / `reset_warm_start` driver and
feasibility restoration (ROADMAP.md Open items 1.7 and 1.10).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions, QPStatics
from robust_nonlinear_mpc_torch.ops.sls_kernels import SLSRegs
from robust_nonlinear_mpc_torch.solvers.fast_sls import (
    FastSLSOptions,
    FastSLSPersist,
    SLSProblem,
    fast_sls_solve,
)
from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions
from robust_nonlinear_mpc_torch.utils.batch import lane_max


class SCPSLSOptions(NamedTuple):
    rti: int = -1
    fast_sls_rti_steps: int = 0
    epsilon_convergence: float = 1e-10
    max_iter_scp: int = 100
    epsilon_backoff: float = 1e-10
    sls_conv_tol: float = 1e-3
    sls_max_iter: int = 30
    ipm: IPMOptions = IPMOptions()
    streaming_response: bool = False
    # the fused response kernel (ops/fused_response.py); the JAX package
    # reaches its Pallas twin only through FastSLSOptions
    use_pallas_response: bool = False
    recycle_eta: bool = False
    recycle_warm_qp: bool = False
    ipm_first: IPMOptions | None = None
    sls_block: int = 0
    column_mesh: object = None
    adaptive_ipm_budget: tuple | None = None
    sqp: SQPOptions = SQPOptions()
    nominal_soft_fallback: bool = False
    feasibility_restoration: bool = False
    restoration_rho: float = 1e5
    scp_stall_damping: float = 0.0
    stall_damping_after: int = 15
    refine_on_convergence: bool = False
    verbose: bool = False
    fast_sls_verbose: bool = False


class SCPIterResult(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    delta_vec: torch.Tensor
    persist: FastSLSPersist
    primal_infeasibility: torch.Tensor
    cost: torch.Tensor
    cost_QP: torch.Tensor
    sls: object   # FastSLSSolution
    success: torch.Tensor


class SCPSLSSolver(nn.Module):
    """Batched SCP-SLS iteration with the reference constructor signature
    `SCP_SLS(N, Q, R, m, Qf, Q_reg, R_reg, Q_reg_f, rti=..., fast_sls_rti_steps=...)`."""

    def __init__(self, N, Q, R, m, Qf, Q_reg=None, R_reg=None, Q_reg_f=None, *,
                 rti: int = -1, fast_sls_rti_steps: int | None = None,
                 options: SCPSLSOptions | None = None,
                 dtype=torch.float64, device=None, **kwargs):
        super().__init__()
        self.N = int(N)
        self.m = m
        self.dtype = dtype
        opts = options or SCPSLSOptions()
        opts = opts._replace(rti=int(rti))
        if fast_sls_rti_steps is not None:
            opts = opts._replace(fast_sls_rti_steps=int(fast_sls_rti_steps))
        if "verbose" in kwargs:
            opts = opts._replace(verbose=bool(kwargs["verbose"]))
        if kwargs.get("linearization_error", False):
            raise NotImplementedError(
                "linearization_error=True is not implemented (as in the reference)"
            )
        self.opts = opts

        self._build_problem(Q, R, Qf, Q_reg, R_reg, Q_reg_f, dtype, device)

    def _build_problem(self, Q, R, Qf, Q_reg, R_reg, Q_reg_f, dtype, device):
        """Register the problem data as buffers (moved by `.to(device)`)."""
        m = self.m
        nx, nu = m.nx, m.nu
        Q_reg = np.eye(nx) if Q_reg is None else Q_reg
        R_reg = np.eye(nu) if R_reg is None else R_reg
        Q_reg_f = np.eye(nx) if Q_reg_f is None else Q_reg_f
        buf = lambda name, a: self.register_buffer(
            name, torch.as_tensor(np.asarray(a, float), dtype=dtype, device=device)
        )
        for name, a in (("Q", Q), ("R", R), ("Qf", Qf), ("Q_reg", Q_reg),
                        ("R_reg", R_reg), ("Q_reg_f", Q_reg_f)):
            buf(name, a)
        G = np.asarray(m.G.cpu(), float)
        buf("Gx", G[:, :nx])
        buf("Gu", G[:, nx:])
        buf("Gf", np.asarray(m.Gf.cpu(), float))
        buf("g", np.asarray(m.g.cpu(), float))
        buf("gf", np.asarray(m.gf.cpu(), float))
        # identical E at every stage incl. the initial one
        E = np.asarray(m.E.cpu(), float)
        buf("E", np.broadcast_to(E[None], (self.N + 1,) + E.shape).copy())

    @property
    def prob(self) -> SLSProblem:
        stat = QPStatics(Hx=2 * self.Q, Hu=2 * self.R, HxN=2 * self.Qf,
                         Gx=self.Gx, Gu=self.Gu, Gf=self.Gf)
        return SLSProblem(stat=stat, regs=SLSRegs(self.Q_reg, self.R_reg, self.Q_reg_f),
                          E=self.E)

    def _fast_sls_opts(self) -> FastSLSOptions:
        return FastSLSOptions(
            rti_steps=self.opts.fast_sls_rti_steps,
            max_iter=self.opts.sls_max_iter,
            conv_tol=self.opts.sls_conv_tol,
            epsilon_backoff=self.opts.epsilon_backoff,
            streaming_response=self.opts.streaming_response,
            use_pallas_response=self.opts.use_pallas_response,
            recycle_eta=self.opts.recycle_eta,
            recycle_warm_qp=self.opts.recycle_warm_qp,
            ipm=self.opts.ipm,
            ipm_first=self.opts.ipm_first,
            sls_block=self.opts.sls_block,
            column_mesh=self.opts.column_mesh,
            adaptive_ipm_budget=self.opts.adaptive_ipm_budget,
            verbose=self.opts.fast_sls_verbose,
        )

    def assemble_deviation_problem(self, X, U, x0):
        """Jacobians, constraint residuals, linear cost and the deviation
        initial condition for a batch X (B, N+1, nx), U (B, N, nu), x0 (B, nx)."""
        N = self.N
        A, B, c = self.m.linearize_traj(X, U)
        g_res = self.g - X[:, :N] @ self.Gx.T - U @ self.Gu.T
        gf_res = self.gf - X[:, N] @ self.Gf.T
        qx = torch.cat([2 * (X[:, :N] @ self.Q.T), (2 * (X[:, N] @ self.Qf.T))[:, None]], dim=1)
        qu = 2 * (U @ self.R.T)
        return A, B, c, qx, qu, g_res, gf_res, x0 - X[:, 0]

    def _iteration(self, X, U, x0, persist) -> SCPIterResult:
        if self.opts.feasibility_restoration:
            raise NotImplementedError(
                "feasibility restoration is not ported: ROADMAP.md Open items 1.10"
            )
        N = self.N
        A, B, c, qx, qu, g_res, gf_res, xinit_dev = self.assemble_deviation_problem(X, U, x0)
        sls = fast_sls_solve(self.prob, A, B, c, qx, qu, g_res, gf_res, xinit_dev,
                             persist, self._fast_sls_opts())
        X_new = X + sls.X
        U_new = U + sls.U
        # signed max defect of the updated iterate (reference parity)
        f_new = self.m.ddyn(X_new[:, :N], U_new)
        primal_infeas = lane_max(f_new - X_new[:, 1 : N + 1])
        XN = X_new[:, :N]
        cost_nlp = (
            ((XN @ self.Q.T) * XN).sum(dim=(1, 2))
            + ((U_new @ self.R.T) * U_new).sum(dim=(1, 2))
            + (X_new[:, N] * (X_new[:, N] @ self.Qf.T)).sum(dim=1)
        )
        return SCPIterResult(
            X=X_new, U=U_new, delta_vec=sls.y, persist=sls.persist,
            primal_infeasibility=primal_infeas, cost=sls.cost_nominal + cost_nlp,
            cost_QP=sls.cost_nominal, sls=sls, success=sls.success,
        )

    def _warm_shift(self, X, U):
        """Shift trajectories one step (reference reset_warm_start)."""
        N = self.N
        X_new = torch.cat([X[:, 1:], self.m.ddyn(X[:, N], U[:, N - 1])[:, None]], dim=1)
        U_new = torch.cat([U[:, 1:], U[:, N - 1 :]], dim=1)
        return X_new, U_new

    def solve(self, x0):
        raise NotImplementedError(
            "the host-side SCPSLSSolver.solve driver is not ported: ROADMAP.md Open items 1.7"
        )

    def reset_warm_start(self):
        raise NotImplementedError(
            "the host-side reset_warm_start is not ported: ROADMAP.md Open items 1.7"
        )

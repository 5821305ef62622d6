"""SCP-SLS: sequential convex programming over System Level Synthesis (port
of `robust_nonlinear_mpc_tpu/solvers/scp_sls.py`).

`SCPSLSSolver` is an `nn.Module`: the model is a submodule and the problem
data (cost and regularizer matrices, constraint polytopes, the disturbance
maps E) are registered buffers, so `.to(device)` moves the whole problem.
`_iteration` is one SCP iteration for a batch of lanes: linearize, assemble
the deviation problem, run fast-SLS, update the nominal, and (with
`feasibility_restoration`) the soft-slacked restoration iterate of every lane
whose fast-SLS solve failed.

The host API of the reference (`solve`, `reset_warm_start`, `reset`,
`solve_nominal_trajectory`, `solve_profiled`, `generate_lqr_controller`,
`eval_deviation_mismatch`) keeps one problem's warm-start state and runs the
batched functions at B = 1.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from robust_nonlinear_mpc_torch.ops.packing import pack_primal
from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions, QPStatics
from robust_nonlinear_mpc_torch.ops.sls_kernels import SLSRegs
from robust_nonlinear_mpc_torch.solvers.fast_sls import (
    FastSLSOptions,
    FastSLSPersist,
    SLSProblem,
    fast_sls_solve,
    warm_shift_persist,
)
from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions, sqp_solve
from robust_nonlinear_mpc_torch.utils.batch import lane_all_finite, lane_max
from robust_nonlinear_mpc_torch.utils.stages import stage


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
    # the restoration iterate (feasibility_restoration only): solved on the
    # lanes whose iterate is rejected (failed or not finite), the only lanes
    # that use it; elsewhere X_rest/U_rest are the iterate and rest_ok False
    X_rest: torch.Tensor | None = None
    U_rest: torch.Tensor | None = None
    rest_ok: torch.Tensor | None = None


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
        self.save_it_data = bool(kwargs.get("save_it_data", True))

        self._build_problem(Q, R, Qf, Q_reg, R_reg, Q_reg_f, dtype, device)
        # the host API's warm-start state, one problem (B = 1)
        self.reset()
        self.K = None

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

    def _iteration(self, X, U, x0, persist, restore=None) -> SCPIterResult:
        """One SCP iteration. Its stages ("scp.linearize", "scp.fast_sls" with
        "sls.qp" / "sls.backward" / "sls.response" inside, "scp.restoration")
        are timed inside a `utils.stages.timed()` block and cost nothing
        outside one. `restore`: whether to solve the restoration iterate
        (default `feasibility_restoration`; the RTI step never reads it)."""
        N = self.N
        with stage("scp.linearize"):
            A, B, c, qx, qu, g_res, gf_res, xinit_dev = self.assemble_deviation_problem(X, U, x0)
        with stage("scp.fast_sls"):
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
        X_rest = U_rest = rest_ok = None
        if self.opts.feasibility_restoration if restore is None else restore:
            X_rest, U_rest, rest_ok = self._restore(
                X, U, X_new, U_new, sls, (A, B, c, qx, qu, g_res, gf_res, xinit_dev))
        return SCPIterResult(
            X=X_new, U=U_new, delta_vec=sls.y, persist=sls.persist,
            primal_infeasibility=primal_infeas, cost=sls.cost_nominal + cost_nlp,
            cost_QP=sls.cost_nominal, sls=sls, success=sls.success,
            X_rest=X_rest, U_rest=U_rest, rest_ok=rest_ok,
        )

    def _restore(self, X, U, X_new, U_new, sls, dev):
        """The soft-slacked solve of the same tightened deviation QP
        (`solvers/restoration.py`), with the JAX package's IPM options (30
        iterations, tolerance 3e-5 in float32 and 1e-8 in float64, the torch
        Riccati KKT). The JAX package solves it on every lane and its callers
        read it only where the iterate is rejected; here only those lanes are
        solved (none, no solve). Returns (X_rest, U_rest, rest_ok)."""
        from robust_nonlinear_mpc_torch.solvers.restoration import restoration_solve

        A, B, c, qx, qu, g_res, gf_res, xinit_dev = dev
        need = ~(sls.success & lane_all_finite(X_new, U_new))
        X_rest, U_rest = X_new.clone(), U_new.clone()
        rest_ok = torch.zeros_like(need)
        idx = need.nonzero().flatten()
        if idx.numel() == 0:
            return X_rest, U_rest, rest_ok
        ripm = IPMOptions(max_iter=30, tol=3e-5 if self.dtype == torch.float32 else 1e-8,
                          kkt="riccati")
        with stage("scp.restoration"):
            rsol = restoration_solve(
                self.prob.stat, A[idx], B[idx], c[idx], qx[idx], qu[idx],
                (g_res - sls.backoff)[idx], (gf_res - sls.backoff_f)[idx], xinit_dev[idx],
                rho=self.opts.restoration_rho, ipm=ripm,
            )
        Xr, Ur = X[idx] + rsol.X, U[idx] + rsol.U
        X_rest[idx], U_rest[idx] = Xr, Ur
        rest_ok[idx] = rsol.success & lane_all_finite(Xr, Ur)
        return X_rest, U_rest, rest_ok

    def _warm_shift(self, X, U):
        """Shift trajectories one step (reference reset_warm_start)."""
        N = self.N
        X_new = torch.cat([X[:, 1:], self.m.ddyn(X[:, N], U[:, N - 1])[:, None]], dim=1)
        U_new = torch.cat([U[:, 1:], U[:, N - 1 :]], dim=1)
        return X_new, U_new

    # ------------------------------------------------------------------
    # Host API (the reference SCP_SLS methods), one problem at B = 1
    # ------------------------------------------------------------------
    @property
    def _device(self):
        return self.Q.device

    def _t(self, a):
        if not torch.is_tensor(a):
            a = np.asarray(a, float)
        return torch.as_tensor(a, dtype=self.dtype, device=self._device)

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def solve_nominal_trajectory(self, x0):
        """Nominal initialization by the SQP; on failure the soft-slack SQP,
        then a hard polish from its point, then the soft point itself when
        its slacks are below 1e-3."""
        from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_nlp_solve

        x0 = self._t(x0).reshape(1, -1)
        sol = sqp_solve(self.m, self.N, self.Q, self.R, self.Qf, x0, opts=self.opts.sqp)
        if bool(sol.success[0]):
            self._X, self._U = sol.X, sol.U
            if self.opts.verbose:
                print(f"SCP-SLS: nominal init converged, cost {float(sol.cost[0]):.6e}")
            return True
        soft = soft_nlp_solve(self.m, self.N, self.Q, self.R, self.Qf, x0,
                              rho_soft=1e6, rho_soft_l1=1e6)
        max_slack = float(torch.maximum(soft.gamma.max(), soft.gamma_f.max()))
        if bool(soft.success[0]):
            hard = sqp_solve(self.m, self.N, self.Q, self.R, self.Qf, x0,
                             X_init=soft.X, U_init=soft.U, opts=self.opts.sqp)
            if bool(hard.success[0]):
                self._X, self._U = hard.X, hard.U
                if self.opts.verbose:
                    print(f"SCP-SLS: nominal init via soft+polish, cost {float(hard.cost[0]):.6e}")
                return True
            if max_slack < 1e-3:
                self._X, self._U = soft.X, soft.U
                if self.opts.verbose:
                    print(f"SCP-SLS: nominal init via soft fallback (residual slacks "
                          f"{max_slack:.2e}), cost {float(soft.cost_nominal[0]):.6e}")
                return True
        if self.opts.verbose:
            print("SCP-SLS: nominal trajectory initialization failed "
                  f"(soft slacks {max_slack:.2e})")
        return False

    def solve(self, x0):
        """One MPC solve from x0 (nx,): RTI (`rti` > 0 iterations) or until
        |delta|_inf < epsilon_convergence. Returns the reference's dict."""
        x0 = self._t(x0).reshape(1, -1)
        t_start = time.perf_counter()
        if self._X is None and not self.solve_nominal_trajectory(x0[0]):
            return {"success": False}

        rti = self.opts.rti
        until_conv = not (rti is not None and rti > 0)
        max_iters = self.opts.max_iter_scp if until_conv else int(rti)
        last_success, iterations, res = False, 0, None
        if self.opts.verbose:
            print(f"{'it (SCP)':>10} {'Δ primal':>10} {'cost nom.':>10} "
                  f"{'p. infeas.':>10} {'SOCP it':>8}")
        for ii in range(max_iters):
            iterations = ii
            res = self._iteration(self._X, self._U, x0, self._persist)
            last_success = bool(res.success[0])
            if not last_success:
                if self.opts.feasibility_restoration and bool(res.rest_ok[0]):
                    # continue SCP from the soft-slacked iterate instead of
                    # aborting; a restored step never converges by itself
                    self._X, self._U = res.X_rest, res.U_rest
                    if self.opts.verbose:
                        print(f"{ii:>10} feasibility restoration step")
                    continue
                break
            damp = float(self.opts.scp_stall_damping)
            if damp > 0.0 and ii >= int(self.opts.stall_damping_after):
                # stall damping, as the batched drivers' acceptance
                self._X = self._X + damp * (res.X - self._X)
                self._U = self._U + damp * (res.U - self._U)
            else:
                self._X, self._U = res.X, res.U
            self._persist = res.persist
            delta = float(res.delta_vec.abs().max())
            if self.save_it_data:
                self.it_data[ii] = {"cost": float(res.cost[0]), "delta": delta}
            if self.opts.verbose:
                print(f"{ii:>10} {delta:>10.2e} {float(res.cost[0]):>10.2e} "
                      f"{float(res.primal_infeasibility[0]):>10.2e} "
                      f"{int(res.sls.iteration_number[0]):>8}")
            if until_conv and delta < self.opts.epsilon_convergence:
                if self.opts.verbose:
                    print(f"SCP-SLS: converged in {ii} iterations")
                if self.opts.refine_on_convergence:
                    ref = sqp_solve(self.m, self.N, self.Q, self.R, self.Qf, x0,
                                    X_init=self._X, U_init=self._U, opts=self.opts.sqp)
                    # the reference prints and discards the refinement
                    print(f"Refinement SQP: success = {bool(ref.success[0])}, "
                          f"cost = {float(ref.cost[0]):.6e}")
                return self._package(res, iterations, True, t_start)

        success = last_success if not until_conv else False
        if until_conv and self.opts.verbose:
            print(f"SCP did not converge in {iterations} iterations")
        return self._package(res, iterations, success, t_start, failed_iterate=not last_success)

    def _package(self, res: SCPIterResult | None, iterations, success, t_start,
                 failed_iterate: bool = False):
        """The reference's result dict in its layouts. On a failed iterate the
        primal is the last accepted one and every floating SLS field is NaN:
        the tube belongs to the rejected iterate."""
        self._sync()
        t_ms = (time.perf_counter() - t_start) * 1e3
        if res is None:
            return {"success": False, "iterations": iterations, "t_solve_ms": t_ms}
        sls = res.sls
        host = lambda t: t[0].detach().cpu().numpy()
        X_out, U_out = (self._X, self._U) if failed_iterate else (res.X, res.U)

        def sls_field(t):
            a = host(t)
            if failed_iterate and np.issubdtype(a.dtype, np.floating):
                return np.full_like(a, np.nan)
            return a

        return {
            "success": bool(success),
            "iterations": int(iterations),
            "primal_x": host(X_out).T,             # (nx, N+1) reference layout
            "primal_u": host(U_out).T,             # (nu, N)
            "primal_vec": host(pack_primal(X_out, U_out)),
            "delta_vec": host(res.delta_vec),
            "dual_mu": sls_field(sls.lam).T,       # (ni, N)
            "dual_mu_f": sls_field(sls.lam_f),
            "dual_eta": sls_field(sls.eta),
            "dual_eta_f": sls_field(sls.eta_f),
            "K": sls_field(sls.K),
            "Phi_x": sls_field(sls.Phi_x),
            "Phi_u": sls_field(sls.Phi_u),
            "beta": sls_field(sls.beta),
            "beta_f": sls_field(sls.beta_f),
            "backoff": sls_field(sls.backoff),
            "backoff_f": sls_field(sls.backoff_f),
            "backoff_x": sls_field(sls.backoff_x),  # (N+1, nx)
            "backoff_u": sls_field(sls.backoff_u),  # (N, nu)
            "cost_QP": float(res.cost_QP[0]),
            "cost": float(res.cost[0]),
            "cost_tube": float(sls.cost_tube[0]),
            "primal_infeasibility": float(res.primal_infeasibility[0]),
            "SOCP_steps": int(sls.iteration_number[0]),
            "qp_iters": int(sls.qp_iters[0]),
            "qp_kkt": float(sls.qp_kkt[0]),
            "it_data": dict(self.it_data),
            # the iteration is not split into stages here (solve_profiled
            # does); the reference's keys report the whole solve under t_qp
            "t_solve_ms": t_ms,
            "t_jac_ms": 0.0,
            "t_qp_ms": t_ms,
            "t_backward_ms": 0.0,
        }

    def solve_profiled(self, x0):
        """Like `solve` for rti = 1 / fast_sls_rti_steps = 1, run stage by
        stage with a device barrier after each for per-stage times (t_jac_ms,
        t_qp_ms, t_backward_ms, t_tighten_ms); `solve` otherwise."""
        if not (self.opts.rti == 1 and self.opts.fast_sls_rti_steps == 1):
            return self.solve(x0)
        from robust_nonlinear_mpc_torch.ops.qp_ipm import QPData, solve_qp
        from robust_nonlinear_mpc_torch.ops.sls_kernels import (
            backoff_from_phi,
            evaluate_dual_eta,
            propagate,
        )
        from robust_nonlinear_mpc_torch.solvers.fast_sls import select_sls_kernels

        backward_solve = select_sls_kernels(self.opts.sls_block)[0]
        x0 = self._t(x0).reshape(1, -1)
        if self._X is None and not self.solve_nominal_trajectory(x0[0]):
            return {"success": False}
        m, N, stat = self.m, self.N, self.prob.stat
        X, U = self._X, self._U
        Gmat = torch.cat([stat.Gx, stat.Gu], dim=1)

        def timed(f, *a):
            self._sync()
            t0 = time.perf_counter()
            out = f(*a)
            self._sync()
            return out, (time.perf_counter() - t0) * 1e3

        def qp(A, B, c, qx, qu, h, hf, xinit):
            return solve_qp(stat, QPData(A=A, B=B, c=c, qx=qx, qu=qu, h=h, hf=hf, xinit=xinit),
                            self.opts.ipm)

        def bwd(A, B, lam, lam_f, beta, beta_f):
            eta, eta_f = evaluate_dual_eta(lam, lam_f, beta, beta_f, self.opts.epsilon_backoff)
            return eta, eta_f, backward_solve(A, B, Gmat, stat.Gf, eta, eta_f, self.prob.regs)[1]

        def tighten(A, B, K):
            Phi_x, Phi_u = propagate(A, B, self.prob.E, K)
            return backoff_from_phi(Phi_x, Phi_u, stat.Gx, stat.Gu, stat.Gf,
                                    self.opts.epsilon_backoff)

        (A, B, c, qx, qu, g_res, gf_res, xinit), t_jac = timed(
            self.assemble_deviation_problem, X, U, x0)
        sol1, t_qp1 = timed(qp, A, B, c, qx, qu, g_res, gf_res, xinit)
        eps = self.opts.epsilon_backoff
        beta0 = torch.full((1, N, N, m.ni), eps, dtype=self.dtype, device=self._device)
        betaf0 = torch.full((1, N + 1, m.ni_f), eps, dtype=self.dtype, device=self._device)
        (eta, eta_f, K), t_bwd = timed(bwd, A, B, sol1.lam, sol1.lam_f, beta0, betaf0)
        (beta, beta_f, backoff, backoff_f), t_tighten = timed(tighten, A, B, K)
        sol2, t_qp2 = timed(qp, A, B, c, qx, qu, g_res - backoff, gf_res - backoff_f, xinit)
        self._X, self._U = X + sol2.X, U + sol2.U
        host = lambda t: t[0].detach().cpu().numpy()
        bo, bof = host(backoff), host(backoff_f)
        return {
            "success": bool(sol1.success[0] & sol2.success[0]),
            "primal_x": host(self._X).T,
            "primal_u": host(self._U).T,
            "backoff": bo,
            "backoff_f": bof,
            "backoff_x": np.concatenate([bo[:, : m.nx], bof[None, : m.nx]]),
            "backoff_u": bo[:, m.nx : m.nx + m.nu],
            "t_jac_ms": t_jac,
            "t_qp_ms": t_qp1 + t_qp2,
            "t_backward_ms": t_bwd,
            "t_tighten_ms": t_tighten,
        }

    def set_rti_steps(self, steps):
        """None or <= 0 disables the inner cap (until-convergence mode)."""
        steps = 0 if steps is None or int(steps) <= 0 else int(steps)
        self.opts = self.opts._replace(fast_sls_rti_steps=steps)

    def set_fast_sls_rti_steps(self, steps):
        self.set_rti_steps(steps)

    def _fresh_persist(self, keep_prev=None):
        m = self.m
        return FastSLSPersist.init(self.N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=1,
                                   dtype=self.dtype, device=self._device, keep_prev=keep_prev)

    def reset_warm_start(self):
        """Shift x/u one step and wipe the SLS iteration state, keeping the
        convergence memory (prev_primal) and, with recycled eta, the
        stage-shifted eta (and QP warm start)."""
        if self._X is None:
            return
        self._X, self._U = self._warm_shift(self._X, self._U)
        old = self._persist
        self._persist = self._fresh_persist(keep_prev=old.prev_primal)._replace(
            have_prev=old.have_prev)
        if self.opts.recycle_eta:
            shifted = warm_shift_persist(old)
            self._persist = self._persist._replace(eta=shifted.eta, eta_f=shifted.eta_f)
            if self.opts.recycle_warm_qp:
                self._persist = self._persist._replace(qp_warm=shifted.qp_warm)
        self.it_data = {}

    def reset(self):
        self._X = None
        self._U = None
        self._persist = self._fresh_persist()
        self.it_data = {}

    def generate_lqr_controller(self):
        """Infinite-horizon LQR at the origin by scipy's DARE on the host.

        The reference also overwrites Qf with the DARE solution without
        rebuilding its problem; here Qf stays as it is, since the port's
        problem data are buffers read on every solve (an overwrite would
        change the SLS problem too). The solution is returned as "P"."""
        from scipy.linalg import solve_discrete_are

        nx, nu = self.m.nx, self.m.nu
        z = lambda n: torch.zeros(n, dtype=self.dtype, device=self._device)
        A, B = (t.detach().cpu().numpy() for t in self.m.linearize(z(nx), z(nu)))
        Qh, Rh = self.Q.cpu().numpy(), self.R.cpu().numpy()
        P = solve_discrete_are(A, B, Qh, Rh)
        K = np.linalg.solve(Rh + B.T @ P @ B, B.T @ P @ A)
        self.K = K
        return {"K": K, "P": P, "A": A, "B": B, "controller": lambda x: -K @ np.asarray(x)}

    def eval_deviation_mismatch(self, e, d):
        """Linearized against true deviation rollout; e (nx, N+1) state and
        d (nu, N) input deviations in the reference layouts."""
        if self._X is None:
            raise RuntimeError("no nominal trajectory available")
        N = self.N
        e = self._t(e).T[None]   # (1, N+1, nx)
        d = self._t(d).T[None]   # (1, N, nu)
        X, U = self._X, self._U
        A, B, _ = self.m.linearize_traj(X, U)
        r = self.m.ddyn(X[:, :N], U) - X[:, 1:]
        pred = (A @ e[:, :N, :, None])[..., 0] + (B @ d[..., None])[..., 0] + r
        roll = self.m.ddyn(X[:, :N] + e[:, :N], U + d) - X[:, 1:]
        mismatch = roll - pred
        host = lambda t: t[0].detach().cpu().numpy()
        return {
            "mismatch": host(mismatch).T,
            "pred": host(pred).T,
            "roll": host(roll).T,
            "r": host(r).T,
            "norms": host(torch.linalg.norm(mismatch, dim=-1)),
        }

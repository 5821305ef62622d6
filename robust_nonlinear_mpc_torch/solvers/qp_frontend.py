"""Stateful QP front end with interchangeable backends (port of
`robust_nonlinear_mpc_tpu/solvers/qp_frontend.py`, the reference's `QP`).

Build the horizon QP once from an LTI or LTV model, then per-iteration
numeric updates only (`update_dynamics`, `update_ubg` / `reset_ubg` /
`reset_lbg`, `offset_constraints`, `update_q_cost_lin` / `add_q_cost_lin` /
`reset_q_cost_lin`) and `solve(x0)`. Backends:

  * "torch"  - the port's batched Riccati-KKT IPM (`ops/qp_ipm.solve_qp`) at
               B = 1, on the model's device, with any `IPMOptions.kkt` the
               port has (`kkt="fused"` runs the Newton kernels K1/K2 on the
               card); the JAX package's "jax" backend;
  * "native" - the C++ Riccati IPM on the host (`native/rnm_qp.cpp` via
               ctypes); a failed build raises.

The reference's conventions hold: `solve(x0)` pins x(0) = -x0, and the
solution dict has its layouts (primal_x (nx, N+1), primal_u (nu, N), dual_mu
(ni, N), dual_mu_f), as NumPy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from robust_nonlinear_mpc_torch.models.linear import LTI, LTV
from robust_nonlinear_mpc_torch.ops.packing import unpack_primal
from robust_nonlinear_mpc_torch.ops.qp_ipm import (
    IPMOptions,
    QPData,
    QPStatics,
    solve_qp,
)

BACKENDS = ("torch", "native")


class QP:
    def __init__(self, N, Q, R, m, Qf, *, backend="torch", ipm: IPMOptions | None = None,
                 verbose=False, export_standard_QP: bool = False, export_dir=None):
        if backend == "jax":
            raise ValueError("backend='jax' is the JAX package's; the port's is 'torch' "
                             "(or 'native')")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.N = int(N)
        self.m = m
        self.backend = backend
        self.verbose = verbose
        self.ipm = ipm or IPMOptions()
        self.dtype, self.device = m.G.dtype, m.G.device
        # a MATLAB-quadprog dump of every successful solve, for external
        # validation
        self.export_standard_qp = bool(export_standard_QP)
        self.export_dir = export_dir if export_dir is not None else "build/quadprog_exports"
        self._export_counter = 0

        nx, nu = m.nx, m.nu
        t = self._t
        self.stat = QPStatics(Hx=2 * t(Q), Hu=2 * t(R), HxN=2 * t(Qf),
                              Gx=m.G[:, :nx].clone(), Gu=m.G[:, nx:].clone(), Gf=m.Gf.clone())
        if isinstance(m, LTI):
            A, B = m.A.expand(N, nx, nx), m.B.expand(N, nx, nu)
            g_stack, gf = m.g.expand(N, m.ni), m.gf
        elif isinstance(m, LTV):
            A, B = m.A_stack, m.B_stack
            g_stack, gf = m.g_stack, m.gf_vec
        else:
            raise ValueError("Model must be LTI or LTV")
        self._A, self._B = t(A).clone(), t(B).clone()
        self._c = self._zeros(N, nx)
        self._nominal_h = t(g_stack).clone()
        self._nominal_hf = t(gf).clone()
        self._h, self._hf = self._nominal_h, self._nominal_hf
        self.reset_q_cost_lin()

    def _t(self, a) -> torch.Tensor:
        if not torch.is_tensor(a):
            a = np.array(a, float)
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------------
    # Updates
    # ------------------------------------------------------------------
    def update_dynamics(self, A_stack, B_stack, E_stack=None, g_stack=None):
        """New per-stage dynamics (and bounds); like the reference, the
        bounds go back to nominal."""
        self._A, self._B = self._t(A_stack), self._t(B_stack)
        if g_stack is not None:
            g_stack = self._t(g_stack)
            self._nominal_h = g_stack[: self.N]
            if g_stack.shape[0] > self.N:
                self._nominal_hf = g_stack[self.N].reshape(-1)[: self.m.ni_f]
        self.reset_ubg()

    def offset_constraints(self, c_stack):
        """Set the dynamics affine term (equality rhs -c)."""
        self._c = self._t(c_stack).reshape(self.N, self.m.nx)

    def update_ubg(self, h, hf=None):
        self._h = self._t(h).reshape(self.N, -1)
        if hf is not None:
            self._hf = self._t(hf).reshape(-1)

    def reset_ubg(self):
        self._h, self._hf = self._nominal_h, self._nominal_hf

    def reset_lbg(self):
        """Reset the equality rows to nominal. The reference keeps the
        dynamics defect in the lower/upper bounds of its equality rows; here
        it is the affine term c, so this zeroes c."""
        self._c = self._zeros(self.N, self.m.nx)

    def update_q_cost_lin(self, qx, qu=None):
        """Linear cost: (qx (N+1, nx), qu (N, nu)), or one packed stage-wise
        vector y (the reference's layout) when qu is None."""
        if qu is None:
            self._qx, self._qu = unpack_primal(self._t(qx).reshape(-1), self.N, self.m.nx,
                                               self.m.nu)
        else:
            self._qx, self._qu = self._t(qx), self._t(qu)

    def add_q_cost_lin(self, qx, qu=None):
        old_qx, old_qu = self._qx, self._qu
        self.update_q_cost_lin(qx, qu)
        self._qx = self._qx + old_qx
        self._qu = self._qu + old_qu

    def reset_q_cost_lin(self):
        self._qx = self._zeros(self.N + 1, self.m.nx)
        self._qu = self._zeros(self.N, self.m.nu)

    # ------------------------------------------------------------------
    # Solve
    # ------------------------------------------------------------------
    def _data(self, x0) -> QPData:
        """The current QP as a batch of one, with x(0) pinned to -x0."""
        return QPData(A=self._A[None], B=self._B[None], c=self._c[None], qx=self._qx[None],
                      qu=self._qu[None], h=self._h[None], hf=self._hf[None],
                      xinit=-self._t(x0).reshape(1, -1))

    def solve(self, x0):
        """Solve with x(0) pinned to -x0 (the reference's sign convention).
        Returns {"success": False} on failure, else the solution dict."""
        x0 = np.asarray(x0.detach().cpu() if torch.is_tensor(x0) else x0, float).reshape(-1)
        data = self._data(x0)
        if self.backend == "native":
            from robust_nonlinear_mpc_torch.native import qp_solve_native

            r = qp_solve_native(self.stat, data, max_iter=self.ipm.max_iter, tol=self.ipm.tol)
            X, U, lam, lam_f = r["X"], r["U"], r["lam"], r["lam_f"]
            ok, cost, kkt = r["success"], r["cost"], r["kkt_res"]
        else:
            sol = solve_qp(self.stat, data, self.ipm)
            host = lambda a: a[0].detach().cpu().numpy()
            ok = bool(sol.success[0])
            X, U, lam, lam_f = host(sol.X), host(sol.U), host(sol.lam), host(sol.lam_f)
            cost, kkt = float(sol.cost[0]), float(sol.kkt_res[0])
        if not ok:
            if self.verbose:
                print(f"QP({self.backend}): kkt={kkt:.2e} (failed)")
            return {"success": False}
        N = self.N
        ret = {
            "success": True,
            "primal_vec": np.concatenate([np.concatenate([X[:N], U], axis=1).ravel(), X[N]]),
            "primal_x": X.T,          # (nx, N+1) reference layout
            "primal_u": U.T,          # (nu, N)
            "dual_mu": lam.T,         # (ni, N)
            "dual_mu_f": lam_f,
            "cost": cost,
        }
        if self.export_standard_qp:
            self._export_quadprog(x0, ret)
        return ret

    # ------------------------------------------------------------------
    # External-validation export
    # ------------------------------------------------------------------
    def densify(self, x0=None):
        """Dense standard form of the current QP over the stage-wise vector
        y = [x0; u0; ...; x_{N-1}; u_{N-1}; xN]: min 0.5 y'H y + f'y s.t.
        A y <= b, Aeq y = beq. The equality rows are the dynamics defects
        [A_k B_k -I] y = -c_k and, when x0 is given, the pin x(0) = -x0."""
        from robust_nonlinear_mpc_torch.ops.qp_export import densify

        d = densify(self.stat, self._data(np.zeros(self.m.nx) if x0 is None else x0))
        n_eq = self.N * self.m.nx + (self.m.nx if x0 is not None else 0)
        return d["H"], d["f"], d["A"], d["b"], d["Aeq"][:n_eq], d["beq"][:n_eq]

    def _export_quadprog(self, x0, solve_ret: dict):
        """Dump the current QP and its solution as a MATLAB quadprog problem."""
        import os

        from scipy.io import savemat

        os.makedirs(self.export_dir, exist_ok=True)
        H, f, A_in, b_in, Aeq, beq = self.densify(x0)
        nv = H.shape[0]
        k = self._export_counter
        self._export_counter += 1
        out_path = os.path.join(self.export_dir, f"qp_export_{k:06d}.mat")
        savemat(out_path, {
            "H": H, "f": f, "A": A_in, "b": b_in, "Aeq": Aeq, "beq": beq,
            "lb": np.full(nv, -np.inf),
            "ub": np.full(nv, np.inf),
            "x0": np.asarray(x0, float).ravel(),
            "x_sol": np.asarray(solve_ret["primal_vec"], float).ravel(),
            "x_traj": np.asarray(solve_ret["primal_x"], float),
            "u_traj": np.asarray(solve_ret["primal_u"], float),
            "cost": float(solve_ret["cost"]),
            "backend": np.array(self.backend),
            "dimensions": np.array([self.m.nx, self.m.nu, self.N], np.int32),
        })
        if self.verbose:
            print(f"Saved quadprog export to {out_path}")
        return out_path

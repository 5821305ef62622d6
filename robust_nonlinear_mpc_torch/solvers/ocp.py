"""OCP problem container: shared dimensions, costs, regularizers, and the
stage-wise packing and Riccati-step helpers (port of
`robust_nonlinear_mpc_tpu/solvers/ocp.py`, the reference's `OCP` class).

The port's solvers compose `QPStatics`/`SLSRegs` instead; this container is
kept for users of the reference API. Its data are tensors in the model's
dtype on the model's device (or on `device`); layouts are the reference's:
X (nx, N+1), U (nu, N).
"""

from __future__ import annotations

import numpy as np
import torch

from robust_nonlinear_mpc_torch.models.linear import LTI, LTV
from robust_nonlinear_mpc_torch.ops.packing import pack_primal, unpack_primal
from robust_nonlinear_mpc_torch.utils.device import checked_device


class OCP:
    def __init__(self, N, Q, R, m, Qf, Q_reg=None, R_reg=None, Q_reg_f=None, *, device=None):
        ref = getattr(m, "G", None)   # the model's data set the dtype and device
        self.dtype = ref.dtype if ref is not None else torch.float64
        self.device = checked_device(device if device is not None
                                     else (ref.device if ref is not None else "cuda"))
        self.N = int(N)
        self.m = m
        self.Q, self.R, self.Qf = self._t(Q), self._t(R), self._t(Qf)
        eye = lambda M: torch.eye(M.shape[0], dtype=self.dtype, device=self.device)
        self.Q_reg = eye(self.Q) if Q_reg is None else self._t(Q_reg)
        self.R_reg = eye(self.R) if R_reg is None else self._t(R_reg)
        self.Q_reg_f = eye(self.Qf) if Q_reg_f is None else self._t(Q_reg_f)
        self.xf = torch.zeros((m.nx, 1), dtype=self.dtype, device=self.device)
        self.CONV_EPS = 1e-6

        self.A_stack = None
        self.B_stack = None
        self.E_stack = None
        self.g_stack = None
        self.c_offset_stack = None

    def _t(self, a) -> torch.Tensor:
        if not torch.is_tensor(a):
            a = np.array(a, float)
        return torch.as_tensor(a, dtype=self.dtype, device=self.device)

    # stage-wise packing, reference layouts (nx, N+1) / (nu, N)
    def pack_primal_nominal(self, X, U) -> torch.Tensor:
        nx, nu, N = self.m.nx, self.m.nu, self.N
        X, U = self._t(X), self._t(U)
        assert X.shape == (nx, N + 1), f"X must be {(nx, N + 1)}, got {tuple(X.shape)}"
        assert U.shape == (nu, N), f"U must be {(nu, N)}, got {tuple(U.shape)}"
        return pack_primal(X.T, U.T)

    def unpack_primal_nominal(self, y):
        nx, nu, N = self.m.nx, self.m.nu, self.N
        y = self._t(y).reshape(-1)
        expected = (nx + nu) * N + nx
        assert y.numel() == expected, f"y must be size {expected}, got {y.numel()}"
        X, U = unpack_primal(y, N, nx, nu)
        return X.T, U.T

    def initialize_list_dynamics(self):
        """The per-stage dynamics stacks: an LTI's matrices at every stage,
        an LTV's own stacks."""
        m, N = self.m, self.N
        if isinstance(m, LTI):
            self.A_stack = m.A.expand(N, m.nx, m.nx).clone()
            self.B_stack = m.B.expand(N, m.nx, m.nu).clone()
            self.E_stack = m.E.expand(N + 1, m.nx, m.nw).clone()
            self.g_stack = m.g.expand(N, m.ni).clone()
            self.c_offset_stack = torch.zeros((N, m.nx), dtype=m.A.dtype, device=m.A.device)
        elif isinstance(m, LTV):
            self.A_stack = m.A_stack
            self.B_stack = m.B_stack
            self.E_stack = m.E_stack
            self.g_stack = m.g_stack
        else:
            raise ValueError("Model type not supported")

    # Riccati step helpers (K, S) of one stage, batched over leading dims
    @staticmethod
    def riccati_step(A, B, Cx, Cu, Sk):
        x = B.transpose(-1, -2) @ Sk
        y = A.transpose(-1, -2) @ Sk
        K = -torch.linalg.solve(Cu + x @ B, x @ A)
        S = Cx + y @ A + y @ B @ K
        return K, S

    @staticmethod
    def riccati_step_cholesky(A, B, Cx, Cu, Sk):
        x = B.transpose(-1, -2) @ Sk
        y = A.transpose(-1, -2) @ Sk
        L = torch.linalg.cholesky(Cu + x @ B)
        M = torch.linalg.solve_triangular(L, x @ A, upper=False)
        K = -torch.linalg.solve_triangular(L.transpose(-1, -2), M, upper=True)
        S = Cx + y @ A + y @ B @ K
        return K, S

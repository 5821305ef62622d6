"""Chain-of-integrators model (port of
`robust_nonlinear_mpc_tpu/models/integrator.py`): x^(n) = u, state [x, x',
..., x^(n-1)], one input, box constraints; the standard sanity model for
horizon solvers."""

from __future__ import annotations

import numpy as np
import torch

from robust_nonlinear_mpc_torch.models.base import (
    Model,
    box_polytope,
    terminal_box_polytope,
)
from robust_nonlinear_mpc_torch.utils.device import checked_device


class Integrator(Model):
    def __init__(self, order: int = 2, x_max: float = 10.0, u_max: float = 1.0,
                 dt: float = 0.1, *, dtype=torch.float64, device="cuda"):
        super().__init__()
        device = checked_device(device)
        self.order = int(order)
        self.nx = self.order
        self.nu = 1
        self.nw = self.nx
        self.dt = float(dt)
        x_ub = np.full(self.nx, float(x_max))
        u_ub = np.array([float(u_max)])
        G, g = box_polytope(x_ub, -x_ub, u_ub, -u_ub)
        Gf, gf = terminal_box_polytope(x_ub, -x_ub)
        self.ni = 2 * (self.nx + self.nu)
        self.ni_f = 2 * self.nx
        self._register_problem_data(G, g, Gf, gf, 0.05 * np.eye(self.nx), dtype, device)

    def ode(self, x, u):
        # xdot_i = x_{i+1}, xdot_{n-1} = u
        return torch.cat([x[..., 1:], u[..., :1]], dim=-1)

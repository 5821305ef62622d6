"""Cart-pole pendulum model (port of `robust_nonlinear_mpc_tpu/models/pendulum.py`).

State [cart position, cart velocity, pole angle, pole angular rate], one
force input; box constraints |x| <= 10, |u| <= 5 (ni = 10, ni_f = 8);
disturbance scaling E = 0.1 I (the experiments set 0.003 I).
"""

from __future__ import annotations

import numpy as np
import torch

from robust_nonlinear_mpc_torch.models.base import (
    Model,
    box_polytope,
    terminal_box_polytope,
)
from robust_nonlinear_mpc_torch.utils.device import checked_device


class Pendulum(Model):
    def __init__(self, *, dtype=torch.float64, device="cuda"):
        super().__init__()
        device = checked_device(device)
        self.nx = 4
        self.nu = 1
        self.nw = 4
        self.dt = 0.05
        x_max = np.full(4, 10.0)
        u_max = np.array([5.0])
        G, g = box_polytope(x_max, -x_max, u_max, -u_max)
        Gf, gf = terminal_box_polytope(x_max, -x_max)
        self.ni = 10
        self.ni_f = 8
        self._register_problem_data(G, g, Gf, gf, 0.1 * np.eye(4), dtype, device)
        # cart-pole constants
        self.m1 = 1.0   # cart mass
        self.m2 = 0.1   # pole mass
        self.l = 0.5    # pole length
        self.grav = 9.81

    def ode(self, X, u):
        x_dot = X[..., 1]
        theta = X[..., 2]
        theta_dot = X[..., 3]
        force = u[..., 0]
        m1, m2, l, g = self.m1, self.m2, self.l, self.grav
        s, c = torch.sin(theta), torch.cos(theta)
        denom = m1 + m2 * (1.0 - c**2)
        x_ddot = (force + m2 * l * theta_dot**2 * s - m2 * g * s * c) / denom
        theta_ddot = (-force * c - m2 * l * theta_dot**2 * s * c + (m1 + m2) * g * s) / (
            l * denom
        )
        return torch.stack([x_dot, x_ddot, theta_dot, theta_ddot], dim=-1)

    # per-model plotting (NumPy in; matplotlib imported by the helpers)
    def plot_nominal_trajectory(self, X, time=None, ax=None):
        from robust_nonlinear_mpc_torch.utils.plotting import plot_nominal_trajectory

        return plot_nominal_trajectory(X, dt=self.dt, time=time, ax=ax)

    def plot_input_nominal_trajectory(self, U, time=None, ax=None):
        from robust_nonlinear_mpc_torch.utils.plotting import plot_nominal_trajectory

        return plot_nominal_trajectory(np.asarray(U).reshape(1, -1), dt=self.dt, time=time, ax=ax)

    def plot_tube(self, backoff, center, time=None, ax=None):
        from robust_nonlinear_mpc_torch.utils.plotting import plot_tube

        return plot_tube(backoff, center, dt=self.dt, time=time, ax=ax)

    def plot_input_tube(self, backoff, center, time=None, ax=None):
        from robust_nonlinear_mpc_torch.utils.plotting import plot_tube

        return plot_tube(np.asarray(backoff).reshape(1, -1), np.asarray(center).reshape(1, -1),
                         dt=self.dt, time=time, ax=ax)

    def replace_constraints(self, x_max, x_min, u_max, u_min, x_max_f, x_min_f):
        """Asymmetric box override, as the reference: only g and gf change,
        G and Gf stay [I; -I]."""
        as_t = lambda a: torch.as_tensor(a, dtype=self.g.dtype, device=self.g.device)
        self.g = as_t(np.concatenate([np.asarray(x_max, float), np.asarray(u_max, float),
                                      -np.asarray(x_min, float), -np.asarray(u_min, float)]))
        self.gf = as_t(np.concatenate([np.asarray(x_max_f, float), -np.asarray(x_min_f, float)]))

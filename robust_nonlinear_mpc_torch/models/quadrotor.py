"""6-DOF quadrotor with quaternion attitude and 4 rotor-thrust inputs (port
of `robust_nonlinear_mpc_tpu/models/quadrotor.py`).

State (nx = 13) = [pos(3), vel(3), quat wxyz(4), omega(3)], inputs = 4 rotor
thrusts in X configuration; quaternion kinematics qdot = 0.5 Omega(w) q;
rigid-body Euler equation J wdot = tau - w x (J w); box polytope (ni = 34,
ni_f = 26) and diagonal disturbance scaling E.
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
from robust_nonlinear_mpc_torch.utils.quaternion import (
    quaternion_derivative,
    rotation_matrix_from_quaternion,
)


class Quadrotor(Model):
    state_names = (
        "x", "y", "z", "vx", "vy", "vz",
        "qw", "qx", "qy", "qz", "wx", "wy", "wz",
    )
    control_names = ("f1", "f2", "f3", "f4")

    def __init__(self, *, dtype=torch.float64, device="cuda"):
        super().__init__()
        device = checked_device(device)
        self.mass = 1.0
        self.grav = 9.81
        self.arm = 0.15
        self.Jx, self.Jy, self.Jz = 0.02, 0.02, 0.04
        self.kM = 0.01

        self.nx = 13
        self.nu = 4
        self.nw = 13
        self.dt = 0.05

        f_hover = self.mass * self.grav / 4.0
        self.neutral_state = np.concatenate([np.zeros(6), np.array([1.0, 0, 0, 0]), np.zeros(3)])
        self.neutral_input = np.full(4, f_hover)

        x_ub = np.array([20.0] * 3 + [10.0] * 3 + [1.5] * 4 + [20.0] * 3)
        u_ub = np.full(4, 20.0)
        G, g = box_polytope(x_ub, -x_ub, u_ub, np.zeros(4))
        Gf, gf = terminal_box_polytope(x_ub, -x_ub)
        self.ni = 2 * (self.nx + self.nu)
        self.ni_f = 2 * self.nx
        E = np.diag(
            [0.05, 0.05, 0.05,
             0.1, 0.1, 0.1,
             0.02, 0.02, 0.02, 0.01,
             0.2, 0.2, 0.2]
        )
        self._register_problem_data(G, g, Gf, gf, E, dtype, device)
        self._register_constants(dtype, device, gravity=[0.0, 0.0, self.grav],
                                 inertia=[self.Jx, self.Jy, self.Jz])

    def ode(self, X, u):
        v = X[..., 3:6]
        q = X[..., 6:10]          # [qw, qx, qy, qz]
        omega = X[..., 10:13]

        Fz = u[..., 0] + u[..., 1] + u[..., 2] + u[..., 3]
        R = rotation_matrix_from_quaternion(q)
        # body +Z thrust rotated to world, minus gravity on world z
        acc = (1.0 / self.mass) * (R[..., :, 2] * Fz[..., None])
        acc = acc - self.constant("gravity", X)

        q_dot = quaternion_derivative(q, omega)

        # X-configuration rotor mixing
        f1, f2, f3, f4 = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
        tau = torch.stack(
            [
                self.arm * (f2 - f4),
                self.arm * (f3 - f1),
                self.kM * (f1 - f2 + f3 - f4),
            ],
            dim=-1,
        )
        J = self.constant("inertia", X)
        omega_dot = (tau - torch.linalg.cross(omega, J * omega, dim=-1)) / J
        return torch.cat([v, acc, q_dot, omega_dot], dim=-1)

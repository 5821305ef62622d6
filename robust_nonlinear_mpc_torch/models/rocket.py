"""Thrust-vectored rocket ("rockETH") model (port of
`robust_nonlinear_mpc_tpu/models/rocket.py` without its plotting and
trajectory I/O).

State (nx=17) = [pos(3), vel(3), quat wxyz(4), omega(3), thrust_magnitude,
torque_x, servo_angle_1, servo_angle_2]; inputs (nu=4) = commanded
[thrust, torque, servo1, servo2]; hover-thrust offset +11.3796 on the thrust
state and input; closed-form gimbal linkage; first-order actuator lags; box
polytope (ni = 42, ni_f = 34).
"""

from __future__ import annotations

import math

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

HOVER_THRUST = 11.3796  # gravity-compensation offset


class Rocket(Model):
    def __init__(self, *, dtype=torch.float64, device="cuda"):
        super().__init__()
        device = checked_device(device)
        self.mass = 1.16
        self.grav = 9.81
        self.Jx, self.Jy, self.Jz = 0.00210, 0.10000, 0.10000
        self.thrust_cog_offset = 0.42
        self.tau_thrust = 0.06
        self.tau_servo = 0.10
        self.gimbal_a = 5.0
        self.gimbal_b = 35.2
        self.gimbal_c = 33.0
        self.gimbal_d = 28.0
        self.gimbal_e = 35.2

        self.nx = 17
        self.nu = 4
        self.nw = 17
        self.dt = 0.05

        x_ub = np.array(
            [10.0, 10.0, 10.0,
             1.0, 1.0, 1.0,
             1.5, 1.5, 1.5, 1.5,
             2.0, 2.0, 2.0,
             50.0, 2.0, 1.0, 1.0]
        )
        x_lb = -x_ub
        u_ub = np.array([50.0, 2.0, 1.0, 1.0])
        u_lb = -u_ub
        G, g = box_polytope(x_ub, x_lb, u_ub, u_lb)
        Gf, gf = terminal_box_polytope(x_ub, x_lb)
        self.ni = 2 * (self.nx + self.nu)
        self.ni_f = 2 * self.nx

        sigma_theta = np.deg2rad(2.0)
        q_vec_std = 0.5 * sigma_theta
        q_w_std = 0.1 * q_vec_std
        E = np.diag(
            [0.03, 0.03, 0.03,
             0.08, 0.08, 0.08,
             q_vec_std, q_vec_std, q_vec_std, q_w_std,
             0.10, 0.10, 0.10,
             0.8, 0.2, 0.04, 0.04]
        )
        self._register_problem_data(G, g, Gf, gf, E, dtype, device)
        self._register_constants(dtype, device, gravity=[0.0, 0.0, -self.grav],
                                 cog=[0.0, 0.0, -self.thrust_cog_offset],
                                 inertia=[self.Jx, self.Jy, self.Jz])

    def compute_gimbal_angle(self, servo_angle, tilt_axis_angle):
        """Closed-form four-bar gimbal linkage, elbow-down branch."""
        crank_x = self.gimbal_d + self.gimbal_a * torch.cos(servo_angle)
        crank_y = self.gimbal_e - self.gimbal_a * torch.sin(servo_angle)
        const = self.gimbal_b**2 - self.gimbal_c**2 - crank_x**2 - crank_y**2
        if isinstance(tilt_axis_angle, float):
            cos_tilt = math.cos(tilt_axis_angle)
        else:
            cos_tilt = torch.cos(tilt_axis_angle)
        num_s = 2.0 * self.gimbal_c * cos_tilt * crank_y
        num_c = -2.0 * self.gimbal_c * crank_x
        disc = num_c**2 + num_s**2 - const**2
        return 2.0 * torch.atan((num_s - torch.sqrt(disc)) / (const + num_c))

    def ode(self, X, u):
        v = X[..., 3:6]
        q = X[..., 6:10]          # [w, x, y, z]
        omega = X[..., 10:13]

        thrust_mag = X[..., 13] + HOVER_THRUST
        torque_x = X[..., 14]
        sa1 = X[..., 15]
        sa2 = X[..., 16]

        thrust_input = u[..., 0] + HOVER_THRUST
        torque_input = u[..., 1]
        sa1_input = u[..., 2]
        sa2_input = u[..., 3]

        gimbal1 = self.compute_gimbal_angle(sa1, 0.0)
        gimbal2 = self.compute_gimbal_angle(sa2, gimbal1)

        B_thrust = torch.stack(
            [
                -thrust_mag * torch.sin(gimbal1) * torch.cos(gimbal2),
                thrust_mag * torch.sin(gimbal2),
                thrust_mag * torch.cos(gimbal1) * torch.cos(gimbal2),
            ],
            dim=-1,
        )

        R = rotation_matrix_from_quaternion(q)
        acc = (1.0 / self.mass) * torch.einsum("...ij,...j->...i", R, B_thrust)
        acc = acc + self.constant("gravity", X)

        q_dot = quaternion_derivative(q, omega)

        cog = self.constant("cog", X)
        torque_vec = torch.linalg.cross(cog.expand(B_thrust.shape), B_thrust, dim=-1)
        J = self.constant("inertia", X)
        omega_dot = (torque_vec - torch.linalg.cross(omega, J * omega, dim=-1)) / J

        thrust_dot = (thrust_input - thrust_mag) / self.tau_thrust
        torque_dot = (torque_input - torque_x) / self.tau_thrust
        sa1_dot = (sa1_input - sa1) / self.tau_servo
        sa2_dot = (sa2_input - sa2) / self.tau_servo

        act_dot = torch.stack([thrust_dot, torque_dot, sa1_dot, sa2_dot], dim=-1)
        return torch.cat([v, acc, q_dot, omega_dot, act_dot], dim=-1)

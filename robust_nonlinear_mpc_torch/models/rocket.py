"""Thrust-vectored rocket ("rockETH") model (port of
`robust_nonlinear_mpc_tpu/models/rocket.py`).

State (nx=17) = [pos(3), vel(3), quat wxyz(4), omega(3), thrust_magnitude,
torque_x, servo_angle_1, servo_angle_2]; inputs (nu=4) = commanded
[thrust, torque, servo1, servo2]; hover-thrust offset +11.3796 on the thrust
state and input; closed-form gimbal linkage; first-order actuator lags; box
polytope (ni = 42, ni_f = 34). The grouped plots import matplotlib inside
their bodies (NumPy in, figures out) and the trajectory I/O is `sim/io.py`'s.
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


def split_box_bounds(g, nx, nu):
    """(lb_x, ub_x, lb_u, ub_u) from the box polytope's g layout
    [x_ub; u_ub; -x_lb; -u_lb], as NumPy arrays."""
    g = g.detach().cpu().numpy() if torch.is_tensor(g) else np.asarray(g, float)
    return (-g[nx + nu : 2 * nx + nu], g[:nx], -g[2 * nx + nu : 2 * (nx + nu)], g[nx : nx + nu])


def _as_rows(a, n):
    """A (n, T) NumPy view of a trajectory given as (n, T) or (T, n)."""
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    return a if a.shape[0] == n else a.T


class Rocket(Model):
    state_names = (
        "x", "y", "z",
        "v_x", "v_y", "v_z",
        "quat_w", "quat_x", "quat_y", "quat_z",
        "angular_vx", "angular_vy", "angular_vz",
        "thrust_magnitude", "torque_x", "servo_angle_1", "servo_angle_2",
    )
    control_names = ("thrust_magnitude_u", "torque_u", "servo_angle_1_u", "servo_angle_2_u")
    state_groups = {
        "pos": slice(0, 3),
        "vel": slice(3, 6),
        "quat": slice(6, 10),
        "omega": slice(10, 13),
        "act": slice(13, 17),
    }
    _GROUP_LABELS = [
        ["$x$", "$y$", "$z$"],
        ["$v_x$", "$v_y$", "$v_z$"],
        ["$q_x$", "$q_y$", "$q_z$", "$q_w$"],
        [r"$\omega_x$", r"$\omega_y$", r"$\omega_z$"],
        ["$T$", r"$\tau$", r"$\theta_1$", r"$\theta_2$"],
    ]
    _GROUP_YLABELS = ["Position [m]", "Velocity [m/s]", "Quaternion [-]",
                      "Angular vel. [rad/s]", "Actuators"]

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

        self.neutral_state = np.concatenate([np.zeros(6), np.array([1.0, 0, 0, 0]), np.zeros(7)])

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

        names = list(self.state_names) + list(self.control_names)
        self.constraint_names = [f"{n}_ub" for n in names] + [f"{n}_lb" for n in names]
        self.constraint_names_f = [f"{n}_ub" for n in self.state_names] + [
            f"{n}_lb" for n in self.state_names
        ]

        # coarse uncertainty scaling (read by no solver; kept as in the JAX model)
        self.E_crs = np.diag(
            [4.2, 3.5, 3.5,
             1.8, 1.6, 1.6,
             20.0, 20.0, 20.0, 20.0,
             0.01, 2.7, 2.7,
             0.1, 0.1, 0.1, 0.1]
        )
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

    # ------------------------------------------------------------------
    # Bounds, grouped state/input plots and trajectory save/load
    # ------------------------------------------------------------------
    def state_bounds(self):
        """(lb_x, ub_x, lb_u, ub_u) from the symmetric polytope g layout
        [x_ub; u_ub; -x_lb; -u_lb]."""
        return split_box_bounds(self.g, self.nx, self.nu)

    def plot_state_trajectory(self, X, U=None, time=None, axes=None):
        """Grouped subplots: pos / vel / quat / omega / actuators (+ inputs)."""
        import matplotlib.pyplot as plt

        X = _as_rows(X, self.nx)
        if time is None:
            time = np.arange(X.shape[1]) * self.dt
        groups = list(self.state_groups.items())
        n = len(groups) + (1 if U is not None else 0)
        if axes is None:
            _, axes = plt.subplots(n, 1, figsize=(10, 2.2 * n), sharex=True)
        for ax, (name, sl) in zip(axes, groups):
            for i in range(sl.start, sl.stop):
                ax.plot(time, X[i], label=self.state_names[i])
            ax.set_ylabel(name)
            ax.legend(fontsize=6, ncol=4)
        if U is not None:
            U = _as_rows(U, self.nu)
            ax = axes[-1]
            for j in range(self.nu):
                ax.plot(time[: U.shape[1]], U[j], label=self.control_names[j])
            ax.set_ylabel("inputs")
            ax.legend(fontsize=6, ncol=4)
        axes[-1].set_xlabel("time [s]")
        return axes

    def _group_axes(self, axes):
        import matplotlib.pyplot as plt

        if axes is None:
            _, axes = plt.subplots(5, 1, figsize=(12, 18), sharex=True)
        return axes

    def _group_iter(self, axes):
        import matplotlib.pyplot as plt

        for ax, (name, sl), lbls, ylab in zip(
            axes, self.state_groups.items(), self._GROUP_LABELS, self._GROUP_YLABELS,
        ):
            colors = plt.cm.viridis(np.linspace(0.3, 0.7, sl.stop - sl.start))
            yield ax, sl, lbls, colors, ylab

    def plot_state_tube(self, backoff, center, time=None, axes=None):
        """Grouped state tube, center +- backoff per panel."""
        backoff = _as_rows(backoff, self.nx)
        center = _as_rows(center, self.nx)
        if time is None:
            time = np.arange(center.shape[1]) * self.dt
        axes = self._group_axes(axes)
        for ax, sl, lbls, colors, ylab in self._group_iter(axes):
            for i, (idx, lbl) in enumerate(zip(range(sl.start, sl.stop), lbls)):
                ax.fill_between(
                    time, center[idx] - backoff[idx] + 1e-6,
                    center[idx] + backoff[idx] - 1e-6,
                    alpha=0.5, color=colors[i], label=lbl,
                )
            ax.set_ylabel(ylab)
            ax.legend(fontsize=10)
            ax.grid(True)
        axes[-1].set_xlabel("Time [s]")
        return axes

    def plot_normalized_state_tube_with_constraints(self, center, backoff, axes=None):
        """Grouped tubes in normalized constraint coordinates (0 = lower
        bound, 1 = upper bound) with the bound lines."""
        center = _as_rows(center, self.nx)
        backoff = _as_rows(backoff, self.nx)
        time = np.arange(center.shape[1]) * self.dt
        lb_x, ub_x, _, _ = self.state_bounds()
        axes = self._group_axes(axes)
        for ax, sl, lbls, colors, _ in self._group_iter(axes):
            for i, (idx, lbl) in enumerate(zip(range(sl.start, sl.stop), lbls)):
                denom = ub_x[idx] - lb_x[idx] or 1.0
                lo = (center[idx] - backoff[idx] - lb_x[idx]) / denom
                hi = (center[idx] + backoff[idx] - lb_x[idx]) / denom
                ax.fill_between(time, lo, hi, alpha=0.4, color=colors[i], label=lbl)
                ax.hlines([0, 1], time[0], time[-1], colors=colors[i], linestyles=["--", ":"])
            ax.set_ylabel("Normalized state")
            ax.legend(fontsize=10)
            ax.grid(True)
        axes[-1].set_xlabel("Time [s]")
        return axes

    def plot_states_constraints(self, N, axes=None):
        """Grouped constraint-bound lines over an N-step window."""
        time = np.arange(N) * self.dt
        lb_x, ub_x, _, _ = self.state_bounds()
        axes = self._group_axes(axes)
        for ax, sl, lbls, colors, _ in self._group_iter(axes):
            for i, (idx, lbl) in enumerate(zip(range(sl.start, sl.stop), lbls)):
                ax.hlines(lb_x[idx], time[0], time[-1], color=colors[i], linestyle="--",
                          label=f"{lbl} lower")
                ax.hlines(ub_x[idx], time[0], time[-1], color=colors[i], linestyle=":",
                          label=f"{lbl} upper")
            ax.legend(fontsize=10)
        return axes

    def save_trajectory(self, folder, X, U, **extra):
        from robust_nonlinear_mpc_torch.sim.io import save_trajectory

        host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else a
        return save_trajectory(folder, host(X), host(U), self.dt, prefix="rocket_trajectory",
                               **extra)

    def load_trajectory(self, path_or_folder):
        from robust_nonlinear_mpc_torch.sim.io import load_trajectory

        return load_trajectory(path_or_folder, prefix="rocket_trajectory")

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

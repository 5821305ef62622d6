"""Quaternion kinematics and Euler conversions, [w, x, y, z] convention
(port of `robust_nonlinear_mpc_tpu/utils/quaternion.py`). Every function
takes tensors of any leading shape."""

from __future__ import annotations

import torch


def euler_to_quaternion(roll, pitch, yaw) -> torch.Tensor:
    """ZYX Euler angles -> unit quaternion [w, x, y, z] (tensors, or numbers
    taken as float64)."""
    as_t = lambda a: a if torch.is_tensor(a) else torch.as_tensor(a, dtype=torch.float64)
    roll, pitch, yaw = torch.broadcast_tensors(as_t(roll), as_t(pitch), as_t(yaw))
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    w = cr * cp * cy + sr * sp * sy
    x = sr * cp * cy - cr * sp * sy
    y = cr * sp * cy + sr * cp * sy
    z = cr * cp * sy - sr * sp * cy
    return torch.stack([w, x, y, z], dim=-1)


def quaternion_to_euler(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w, x, y, z] -> ZYX Euler angles (roll, pitch, yaw)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def rotation_matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """Body->world rotation matrix from quaternion [w, x, y, z]."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * qy**2 - 2 * qz**2
    r01 = 2 * qx * qy - 2 * qz * qw
    r02 = 2 * qx * qz + 2 * qy * qw
    r10 = 2 * qx * qy + 2 * qz * qw
    r11 = 1 - 2 * qx**2 - 2 * qz**2
    r12 = 2 * qy * qz - 2 * qx * qw
    r20 = 2 * qx * qz - 2 * qy * qw
    r21 = 2 * qy * qz + 2 * qx * qw
    r22 = 1 - 2 * qx**2 - 2 * qy**2
    row0 = torch.stack([r00, r01, r02], dim=-1)
    row1 = torch.stack([r10, r11, r12], dim=-1)
    row2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quaternion_derivative(q: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """q_dot = 0.5 * Omega(omega) * q, q = [w, x, y, z]."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    dw = 0.5 * (-wx * qx - wy * qy - wz * qz)
    dx = 0.5 * (wx * qw + wz * qy - wy * qz)
    dy = 0.5 * (wy * qw - wz * qx + wx * qz)
    dz = 0.5 * (wz * qw + wy * qx - wx * qy)
    return torch.stack([dw, dx, dy, dz], dim=-1)

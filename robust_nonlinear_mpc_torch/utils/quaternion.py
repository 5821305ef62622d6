"""Quaternion kinematics, [w, x, y, z] convention (port of
`robust_nonlinear_mpc_tpu/utils/quaternion.py`, the parts the rocket uses)."""

from __future__ import annotations

import torch


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

"""Feasibility restoration for the tightened deviation QP (port of
`robust_nonlinear_mpc_tpu/solvers/restoration.py`), batched over lanes.

On the reference's abort event (a tightened forward QP that comes back
infeasible), solve the same tightened deviation QP with soft slacks on the
stage and terminal inequalities,

    min   dy' P dy + q' dy + rho ||gamma||^2 + rho_l1 1' gamma
    s.t.  dx_{k+1} = A_k dx_k + B_k du_k + c_k,  dx_0 = xinit
          Gx dx_k + Gu du_k - gamma_k <= h_k,    gamma_k >= 0
          Gf dx_N - gamma_f <= hf,               gamma_f >= 0

which is always feasible, so SCP can continue from the restored iterate. A
restored iterate never counts as a converged success by itself.

The slacks are extra inputs gamma~ = sqrt(rho) gamma (nua = nu + ni), the
terminal inequality moves to one extra stage with a free successor state,
and every stage has 2 ni rows, so the problem runs on the Riccati IPM with
per-stage statics (`ops/qp_ipm.solve_qp`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions, QPData, QPStatics, solve_qp
from robust_nonlinear_mpc_torch.utils.batch import lane_all_finite, lane_max


class RestorationSolution(NamedTuple):
    X: torch.Tensor          # (B, N+1, nx) deviation states
    U: torch.Tensor          # (B, N, nu)   deviation inputs
    gamma: torch.Tensor      # (B, N, ni)   stage slacks (physical units)
    gamma_f: torch.Tensor    # (B, ni_f)    terminal slacks
    max_slack: torch.Tensor  # (B,)
    iters: torch.Tensor      # (B,) int32
    success: torch.Tensor    # (B,) bool: finite


def _augmented_statics(stat: QPStatics, N: int, sg: float) -> QPStatics:
    """Per-stage statics of the slack-augmented problem (N + 1 stages)."""
    nx = stat.Hx.shape[-1]
    nu = stat.Hu.shape[-1]
    ni = stat.Gx.shape[-2]
    ni_f = stat.Gf.shape[0]
    dtype, device = stat.Gf.dtype, stat.Gf.device
    stp = stat.per_stage(N)
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    eye_ni = torch.eye(ni, dtype=dtype, device=device)
    nua, ni_aug = nu + ni, 2 * ni

    Hx = torch.cat([stp.Hx, stat.HxN[None]], dim=0)
    Hu_one = z(nua, nua)
    Hu_one[:nu, :nu] = stp.Hu[0]
    # rho gamma^2 = gamma~^2 in scaled coordinates: Hessian block 2 I
    Hu_one[nu:, nu:] = 2 * eye_ni
    Hu = Hu_one.expand(N + 1, nua, nua)

    # stage k < N rows: [Gx x + Gu u - gamma <= h_k ; -gamma~ <= 0]
    Gx_all = z(N + 1, ni_aug, nx)
    Gx_all[:N, :ni] = stp.Gx
    Gu_all = z(N + 1, ni_aug, nua)
    Gu_all[:N, :ni, :nu] = stp.Gu
    Gu_all[:N, :ni, nu:] = -eye_ni / sg
    Gu_all[:N, ni:, nu:] = -eye_ni
    # stage N rows: [Gf x - gamma_f <= hf (padded to ni); -gamma~ <= 0]
    Gx_all[N, :ni_f] = stat.Gf
    Gu_all[N, :ni_f, nu : nu + ni_f] = -torch.eye(ni_f, dtype=dtype, device=device) / sg
    Gu_all[N, ni:, nu:] = -eye_ni
    # the terminal-slack stage's successor state is free: one trivial row
    return QPStatics(Hx=Hx, Hu=Hu, HxN=z(nx, nx), Gx=Gx_all, Gu=Gu_all, Gf=z(1, nx))


def restoration_solve(
    stat: QPStatics,
    A, B, c, qx, qu,
    h,            # (B, N, ni)  tightened stage rhs (g_res - backoff)
    hf,           # (B, ni_f)   tightened terminal rhs
    xinit,        # (B, nx)     pinned deviation initial state
    rho: float = 1e5,
    rho_l1: float | None = None,
    ipm: IPMOptions = IPMOptions(max_iter=30, tol=1e-6),
) -> RestorationSolution:
    """One soft-slacked tightened deviation QP per lane. `stat` is the
    original (time-invariant) deviation-QP statics."""
    Bsz, N, nx = c.shape
    nu = B.shape[3]
    ni = stat.Gx.shape[-2]
    ni_f = stat.Gf.shape[0]
    if ni_f > ni:
        raise ValueError("terminal rows are padded into the stage row budget (ni_f <= ni)")
    dtype, device = A.dtype, A.device
    rho1 = float(rho if rho_l1 is None else rho_l1)
    sg = math.sqrt(float(rho))
    nua = nu + ni
    z = lambda *s: torch.zeros((Bsz,) + s, dtype=dtype, device=device)

    stat_aug = _augmented_statics(stat, N, sg)
    eye_x = torch.eye(nx, dtype=dtype, device=device).expand(Bsz, 1, nx, nx)
    A_aug = torch.cat([A, eye_x], dim=1)
    B_aug = z(N + 1, nx, nua)
    B_aug[:, :N, :, :nu] = B
    c_aug = torch.cat([c, z(1, nx)], dim=1)
    h_aug = z(N + 1, 2 * ni)
    h_aug[:, :N, :ni] = h
    h_aug[:, N, :ni_f] = hf
    h_aug[:, N, ni_f:ni] = 1.0
    qx_aug = torch.cat([qx, z(1, nx)], dim=1)
    # the L1 exact-penalty term on all slacks: rho1 gamma = (rho1 / sg) gamma~
    qu_aug = z(N + 1, nua)
    qu_aug[:, :N, :nu] = qu
    qu_aug[:, :, nu:] = rho1 / sg

    data = QPData(A=A_aug, B=B_aug, c=c_aug, qx=qx_aug, qu=qu_aug, h=h_aug,
                  hf=torch.ones((Bsz, 1), dtype=dtype, device=device), xinit=xinit)
    sol = solve_qp(stat_aug, data, ipm)

    gamma = sol.U[:, :N, nu:] / sg
    gamma_f = sol.U[:, N, nu : nu + ni_f] / sg
    return RestorationSolution(
        X=sol.X[:, : N + 1],
        U=sol.U[:, :N, :nu],
        gamma=gamma,
        gamma_f=gamma_f,
        max_slack=torch.maximum(lane_max(gamma), lane_max(gamma_f)),
        iters=sol.iters,
        # the slacked QP is always strictly feasible: any finite iterate the
        # IPM produced is a usable direction (the SCP criterion vets it)
        success=lane_all_finite(sol.X, sol.U),
    )

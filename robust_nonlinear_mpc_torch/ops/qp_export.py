"""QP export for external validation (port of
`robust_nonlinear_mpc_tpu/ops/qp_export.py`, NumPy and SciPy): one structured
QP (the port's `QPStatics` and a `QPData` batch of one) densified
and saved as a .mat file with quadprog-convention fields (H, f, A, b, Aeq,
beq, lb, ub) plus the solution, so solutions can be cross-checked offline in
MATLAB or any other environment.
"""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy().astype(float) if torch.is_tensor(a) else np.asarray(a, float)


def one_qp(data):
    """The single QP of a batch-leading `QPData` batch of one."""
    if data.c.shape[0] != 1:
        raise ValueError(f"one QP is taken at a time: a batch of {data.c.shape[0]} was given")
    return type(data)(*(t[0] for t in data))


def densify(stat, data):
    """(QPStatics, QPData of one QP) -> dense quadprog-style matrices.

    Returns dict with H (quadprog convention: min 1/2 y'Hy + f'y), f, Aeq,
    beq (dynamics + x0 pin), A, b (inequalities), lb, ub over the stage-wise
    variable y = [x0; u0; ...; xN].
    """
    data = one_qp(data)
    A_d, B_d, c = _np(data.A), _np(data.B), _np(data.c)
    qx, qu = _np(data.qx), _np(data.qu)
    h, hf, xinit = _np(data.h), _np(data.hf), _np(data.xinit)
    Hx, Hu, HxN = _np(stat.Hx), _np(stat.Hu), _np(stat.HxN)
    Gx, Gu, Gf = _np(stat.Gx), _np(stat.Gu), _np(stat.Gf)

    N, nx = c.shape
    nu = B_d.shape[2]
    stage = lambda M, k: M[k] if M.ndim == 3 else M
    ni = Gx.shape[-2]
    ni_f = Gf.shape[0]
    nv = (nx + nu) * N + nx
    xi = lambda k: slice(k * (nx + nu), k * (nx + nu) + nx)
    ui = lambda k: slice(k * (nx + nu) + nx, (k + 1) * (nx + nu))

    H = np.zeros((nv, nv))
    f = np.zeros(nv)
    for k in range(N):
        H[xi(k), xi(k)] = stage(Hx, k)
        H[ui(k), ui(k)] = stage(Hu, k)
        f[xi(k)] = qx[k]
        f[ui(k)] = qu[k]
    H[xi(N), xi(N)] = HxN
    f[xi(N)] = qx[N]

    Aeq = np.zeros((N * nx + nx, nv))
    beq = np.zeros(N * nx + nx)
    for k in range(N):
        r = slice(k * nx, (k + 1) * nx)
        Aeq[r, xi(k)] = A_d[k]
        Aeq[r, ui(k)] = B_d[k]
        Aeq[r, xi(k + 1)] = -np.eye(nx)
        beq[r] = -c[k]
    Aeq[N * nx :, xi(0)] = np.eye(nx)
    beq[N * nx :] = xinit

    Ain = np.zeros((N * ni + ni_f, nv))
    b = np.zeros(N * ni + ni_f)
    for k in range(N):
        r = slice(k * ni, (k + 1) * ni)
        Ain[r, xi(k)] = stage(Gx, k)
        Ain[r, ui(k)] = stage(Gu, k)
        b[r] = h[k]
    Ain[N * ni :, xi(N)] = Gf
    b[N * ni :] = hf

    return {
        "H": H, "f": f, "Aeq": Aeq, "beq": beq, "A": Ain, "b": b,
        "lb": -np.inf * np.ones(nv), "ub": np.inf * np.ones(nv),
        "dimensions": np.array([nx, nu, N], dtype=np.int32),
    }


def export_quadprog(stat, data, solution=None, out_dir="build/quadprog_exports", tag=""):
    """Save a quadprog-style .mat of one QP (+ optional solution, its
    `QPSolution`). Returns the path."""
    from scipy.io import savemat

    os.makedirs(out_dir, exist_ok=True)
    payload = densify(stat, data)
    if solution is not None:
        payload["x_traj"] = _np(solution.X[0])
        payload["u_traj"] = _np(solution.U[0])
        payload["cost"] = float(solution.cost[0])
    stamp = datetime.now().strftime("%Y%m%d_%H%M%S_%f")
    path = os.path.join(out_dir, f"qp_export_{tag}{stamp}.mat")
    savemat(path, payload)
    return path

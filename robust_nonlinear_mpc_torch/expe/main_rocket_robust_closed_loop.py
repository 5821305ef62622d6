"""Rocket ("rockETH") robust closed loop, the headline RTI configuration
(port of `robust_nonlinear_mpc_tpu/expe/main_rocket_robust_closed_loop.py`,
`--run` only).

N = 15, Q = diag(10,10,10, 1x3, 1x4, 1,5,5, 1x4), R = I4, Qf = 10 Q,
regularizers 1e4 I, rti = 1, fast_sls_rti_steps = 1, E = dt * diag(...),
the hardcoded 17-dim x0, 30 steps with uniform noise x+ = f(x, u) + E w,
w ~ U[-1, 1]^nx from RandomState(0), float64.

Usage:  python -m robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop --run
            [--N 15] [--steps 30] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from robust_nonlinear_mpc_torch.utils.device import checked_device

FOLDER = "rockETH_robust_closed_loop"

X0 = [
    1.75729, 4.15951, 4.72757,
    -0.18913, -0.38367, -0.08697,
    -0.79487, 0.00768, -0.21110, -0.56883,
    -0.12752, -0.58026, -0.76542,
    0.20555, 0.54610, -0.40116, -0.35401,
]


def make_rocket_problem(N=15, device="cuda", dtype=torch.float64):
    """Model + solver with the reference rocket experiment settings, on the
    card unless `device` says otherwise."""
    from robust_nonlinear_mpc_torch.models.rocket import Rocket
    from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver

    device = checked_device(device)
    m = Rocket(dtype=dtype, device=device)
    Q = np.diag(
        [10.0, 10.0, 10.0,
         1.0, 1.0, 1.0,
         1.0, 1.0, 1.0, 1.0,
         1.0, 5.0, 5.0,
         1.0, 1.0, 1.0, 1.0]
    )
    R = np.diag([1.0, 1.0, 1.0, 1.0])
    Qf = 10 * Q
    m.dt = 0.05
    sigma_theta = np.deg2rad(2.0)
    q_vec_std = 0.5 * sigma_theta
    q_w_std = 0.1 * q_vec_std
    E = m.dt * np.diag(
        [0.20, 0.20, 0.20,
         0.2, 0.20, 0.20,
         q_vec_std, q_vec_std, q_vec_std, q_w_std,
         0.2, 0.2, 0.2,
         0.8, 0.2, 0.04, 0.04]
    )
    m.E = torch.as_tensor(E, dtype=dtype, device=device)
    solver = SCPSLSSolver(
        N, Q, R, m, Qf,
        Q_reg=1e4 * np.eye(m.nx), R_reg=1e4 * np.eye(m.nu),
        Q_reg_f=1e4 * np.eye(m.nx),
        rti=1, fast_sls_rti_steps=1, verbose=True,
        dtype=dtype, device=device,
    )
    return m, solver


def generate(N: int | None = None, sim_steps: int = 30, device="cuda"):
    from robust_nonlinear_mpc_torch.expe._common import save_results
    from robust_nonlinear_mpc_torch.sim.closed_loop import run_closed_loop

    np.random.seed(0)
    m, solver = make_rocket_problem(int(N) if N is not None else 15, device=device)
    results = run_closed_loop(m, solver, np.array(X0), sim_steps, noise="uniform",
                              rng=np.random.RandomState(0), verbose=True)
    return save_results(FOLDER, "rockETH_robust_closed_loop", results)


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--run", action="store_true", required=True,
                   help="generate and save a run (plotting is not ported)")
    p.add_argument("--N", type=int, default=None)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args()
    generate(args.N, args.steps, device=args.device)

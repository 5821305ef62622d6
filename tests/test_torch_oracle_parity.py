"""The port against the NumPy oracle of the reference pipeline
(`tests/reference_port/`), with the settings of tests/test_reference_parity.py
at short horizons, float64 on the CPU: the pendulum's applied inputs over 10
steps within 1e-8 and the quadrotor's over 2 steps within 1e-4 (the rocket
is in test_torch_oracle_rocket.py)."""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

from reference_port.closed_loop import run_pendulum, run_quadrotor
from robust_nonlinear_mpc_torch.expe.main_pendulum_robust_closed_loop import (
    make_pendulum_problem,
)
from robust_nonlinear_mpc_torch.expe.main_quadrotor_robust_closed_loop import (
    make_quadrotor_problem,
)
from robust_nonlinear_mpc_torch.sim.closed_loop import run_closed_loop

QUAD_X0 = np.array([2.0, -1.5, 1.0] + [0.0] * 3 + [1.0] + [0.0] * 6)


@pytest.fixture(autouse=True)
def _one_thread():
    """One BLAS and one torch thread a test: the suite runs several workers
    on a few cores, where OpenBLAS's spinning threads slow these small dense
    solves several times over (the quadrotor oracle's 3 steps: 31.5 s with
    8 threads, 7.7 s with one, alone on an 8-core host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


def test_pendulum_u_sequence_matches_oracle():
    steps = 10
    _, Uo = run_pendulum(steps=steps)
    m, solver = make_pendulum_problem(15, device="cpu", verbose=False)
    Uf = run_closed_loop(m, solver, np.array([0.5, 0.5, 0.0, 0.0]), steps,
                         noise="none")["input_trajectory"]
    err = np.abs(Uo - Uf).max()
    assert err <= 1e-8, f"pendulum u-sequence mismatch {err:.3e}"


def test_quadrotor_u_sequence_matches_oracle():
    steps = 2
    _, Uo = run_quadrotor(steps=steps, x0=QUAD_X0.copy())
    m, solver = make_quadrotor_problem(15, device="cpu", verbose=False)
    Uf = run_closed_loop(m, solver, QUAD_X0.copy(), steps, noise="none")["input_trajectory"]
    err = np.abs(Uo - Uf).max()
    assert err <= 1e-4, f"quadrotor u-sequence mismatch {err:.3e}"

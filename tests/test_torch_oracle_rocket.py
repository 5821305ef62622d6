"""The port's rocket against the NumPy oracle of the reference pipeline
(`tests/reference_port/`) by the matched-state criterion (a) of
tests/test_reference_parity.py::test_rocket_u_sequence_parity: fed the
oracle's visited states (its noisy rollout from the reference experiment's
x0, N = 15, RTI 1/1), the port's first input agrees within 2e-4 at each of 2
solves (the cold first and a warm-shifted one), float64 on the CPU."""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

from reference_port.closed_loop import ROCKET_X0, make_rocket_oracle
from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import make_rocket_problem


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


def test_rocket_matched_state_matches_oracle():
    m_o, oracle = make_rocket_oracle(15)
    _, solver = make_rocket_problem(15, device="cpu")
    solver.opts = solver.opts._replace(verbose=False)
    rng = np.random.RandomState(0)
    x = ROCKET_X0.copy()
    errs = []
    for i in range(2):
        if i > 0:
            oracle.reset_warm_start()
            solver.reset_warm_start()
        u_o = np.asarray(oracle.solve(x)["primal_u"][:, 0]).ravel()
        sol = solver.solve(x)
        assert sol["success"], f"step {i}"
        errs.append(np.abs(sol["primal_u"][:, 0] - u_o).max())
        # the oracle's noisy rollout, as `reference_port.closed_loop._run`
        x = np.asarray(m_o.ddyn(x, u_o, m_o.dt), float).ravel()
        x = x + np.asarray(m_o.E, float) @ (2.0 * rng.rand(m_o.nx) - 1.0)
    assert max(errs) <= 2e-4, f"rocket matched-state mismatch per solve {errs}"

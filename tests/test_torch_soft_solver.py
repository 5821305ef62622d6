"""The port's `NLPSoftSolver` (the host API with the prox ladder) against
the JAX package's, float64 on the CPU.

Tolerances: X/U within 1e-6, as for the other nominal solvers of the port
(the SQP's stopping tests sit near the rounding noise of its merit in
float64, ROADMAP.md section 3); the iteration counts must be equal.
"""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
    make_rocket_problem as make_rocket_t,
)
from robust_nonlinear_mpc_torch.models.pendulum import Pendulum as PendulumT
from robust_nonlinear_mpc_torch.solvers.soft_nlp import SOFT_SQP_OPTS as SOFT_OPTS_T
from robust_nonlinear_mpc_torch.solvers.soft_nlp import NLPSoftSolver as SolverT
from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_nlp_solve as soft_t
from robust_nonlinear_mpc_tpu.expe.main_rocket_robust_closed_loop import (
    X0,
    make_rocket_problem as make_rocket_j,
)
from robust_nonlinear_mpc_tpu.models import Pendulum as PendulumJ
from robust_nonlinear_mpc_tpu.solvers.soft_nlp import SOFT_SQP_OPTS as SOFT_OPTS_J
from robust_nonlinear_mpc_tpu.solvers.soft_nlp import NLPSoftSolver as SolverJ

TOL = 1e-6


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


def _same(got, ref):
    assert got["success"] == ref["success"]
    assert got["iters"] == ref["iters"]
    for k in ("primal_x", "primal_u", "primal_gamma"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0, err_msg=k)
    for k in ("cost", "cost_nominal"):
        np.testing.assert_allclose(got[k], ref[k], rtol=TOL, err_msg=k)


def _rocket_pair(N=6, opts_t=SOFT_OPTS_T, opts_j=SOFT_OPTS_J):
    m_t, s_t = make_rocket_t(N, device="cpu")
    m_j, s_j = make_rocket_j(N)
    Q, R, Qf = (np.asarray(s_j.Q), np.asarray(s_j.R), np.asarray(s_j.Qf))
    port = SolverT(N, Q, R, m_t, Qf, rho_soft=1e6, rho_soft_l1=1e6, opts=opts_t)
    ref = SolverJ(N, Q, R, m_j, Qf, rho_soft=1e6, rho_soft_l1=1e6, opts=opts_j)
    return port, ref


def test_soft_solver_pendulum_matches_jax():
    N, Q, R, Qf = 6, np.eye(4), np.eye(1), 10 * np.eye(4)
    port = SolverT(N, Q, R, PendulumT(device="cpu"), Qf)
    ref = SolverJ(N, Q, R, PendulumJ(), Qf)
    x0 = np.array([0.5, 0.5, 0.0, 0.0])
    got, want = port.solve(x0), ref.solve(x0)
    assert want["success"]
    _same(got, want)
    # a warm start from the solution, in the reference layouts
    _same(port.solve(x0, want["primal_x"], want["primal_u"]),
          ref.solve(x0, want["primal_x"], want["primal_u"]))


def test_soft_solver_rocket_matches_jax():
    port, ref = _rocket_pair()
    x0 = np.array(X0)
    got, want = port.solve(x0), ref.solve(x0)
    assert want["success"]
    _same(got, want)


def test_soft_solver_escalates_past_rung_zero(monkeypatch):
    """With the SQP cut to 4 iterations the undamped rung 0 ends short of
    the success test (step 0.13 > 0.1 on the rocket at N = 6) and the
    proximally damped rung 1 (prox = 1) succeeds: on both sides."""
    import robust_nonlinear_mpc_torch.solvers.soft_nlp as soft_mod

    crippled_t = SOFT_OPTS_T._replace(max_iter=4)
    crippled_j = SOFT_OPTS_J._replace(max_iter=4)
    port, ref = _rocket_pair(opts_t=crippled_t, opts_j=crippled_j)
    # the port's rungs, as its solve runs them
    rungs = {}

    def recording(*a, prox, **k):
        rungs[prox] = out = soft_t(*a, prox=prox, **k)
        return out

    monkeypatch.setattr(soft_mod, "soft_nlp_solve", recording)
    x0 = np.array(X0)
    got, want = port.solve(x0), ref.solve(x0)
    assert want["success"]
    _same(got, want)
    # rung 0 fails on both sides (the JAX rung from its compiled function)
    r0_j = ref._fns[0](np.asarray(x0), ref._zeroX, ref._zeroU)
    assert not bool(r0_j.success)
    assert sorted(rungs) == [0.0, 1.0]
    assert not bool(rungs[0.0].success[0])
    # and the result is rung 1's
    assert bool(rungs[1.0].success[0])
    np.testing.assert_array_equal(got["primal_x"], rungs[1.0].X[0].numpy().T)

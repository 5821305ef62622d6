"""PyTorch port: the host solver API and the experiment-parity driver
against the JAX package (float64, CPU), on the reference pendulum
experiment (`make_pendulum_problem`) at N = 8, 3 steps:

* `run_closed_loop` in the experiment's RTI mode (rti = 3, 2 inner
  iterations) and until convergence (rti = -1, criterion 1e-7, at most 12
  SCP iterations): the npz keys equal, every trajectory within 1e-8;
* `SCPSLSSolver.solve` from a fresh solver: the result dict's keys equal,
  success and iteration counts equal, every array within 1e-8;
* `generate_lqr_controller` (K, P, A, B) and `eval_deviation_mismatch`
  within 1e-8; `solve_profiled` (RTI 1/1, the only mode it splits into
  stages) against JAX's within 1e-8;
* the rocket until convergence at N = 4, B = 3, 2 steps, through `interop`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_nonlinear_mpc_torch.interop as interop
from robust_nonlinear_mpc_torch.expe import main_pendulum_robust_closed_loop as tpend
from robust_nonlinear_mpc_torch.sim.closed_loop import build_batched_closed_loop as t_batched
from robust_nonlinear_mpc_torch.sim.closed_loop import run_closed_loop as t_run
from robust_nonlinear_mpc_tpu.expe.main_rocket_robust_closed_loop import X0, make_rocket_problem
from robust_nonlinear_mpc_tpu.models import Pendulum
from robust_nonlinear_mpc_tpu.sim.closed_loop import build_batched_closed_loop, run_closed_loop
from robust_nonlinear_mpc_tpu.solvers.scp_sls import SCPSLSSolver

torch.set_num_threads(1)
N, TOL = 8, 1e-8
X0_PEND = np.array([0.5, 0.5, 0.0, 0.0])
CONVERGED = dict(rti=-1, fast_sls_rti_steps=0, epsilon_convergence=1e-7, max_iter_scp=12)


def _pendulum(**opts):
    """The JAX pendulum of the reference experiment and the port's twin from
    `make_pendulum_problem`."""
    m = Pendulum()
    m.E = 0.003 * np.eye(4)
    x_max, u_max = 10 * np.ones(4), 5 * np.ones(1)
    m.replace_constraints(x_max, -x_max, u_max, -u_max, x_max, -x_max)
    solver = SCPSLSSolver(
        N, np.eye(4), np.eye(1), m, 10 * np.eye(4),
        Q_reg=1e3 * np.eye(4), R_reg=1e3 * np.eye(1), Q_reg_f=1e4 * np.eye(4),
        rti=3, fast_sls_rti_steps=2,
    )
    solver.opts = solver.opts._replace(verbose=False, **opts)
    tm, tsolver = tpend.make_pendulum_problem(N, device="cpu", verbose=False)
    tsolver.opts = tsolver.opts._replace(verbose=False, **opts)
    return m, solver, tm, tsolver


def _close(a, b, name):
    a, b = np.asarray(a, float), np.asarray(b, float)
    assert a.shape == b.shape, name
    assert np.array_equal(np.isnan(a), np.isnan(b)), f"{name}: NaN pattern"
    if np.isfinite(a).any():
        err = np.nanmax(np.abs(a - b))
        assert err <= TOL, f"{name}: {err:.3e}"


@pytest.fixture(scope="module")
def converged_pair():
    """The until-convergence pair, built once: the JAX solver's jitted
    iteration compiles once for the tests that reset and reuse it."""
    return _pendulum(**CONVERGED)


@pytest.mark.parametrize("mode", ["rti", "converged"])
def test_run_closed_loop_matches_jax(mode, converged_pair):
    m, solver, tm, tsolver = converged_pair if mode == "converged" else _pendulum()
    solver.reset()
    tsolver.reset()
    ref = run_closed_loop(m, solver, X0_PEND, 3, noise="none")
    got = t_run(tm, tsolver, X0_PEND, 3, noise="none")
    assert sorted(got) == sorted(ref)
    for k in ref:
        if k.startswith("t_"):
            assert np.shape(got[k]) == np.shape(ref[k]), k
        else:
            _close(got[k], ref[k], k)


def test_solve_matches_jax(converged_pair):
    m, solver, tm, tsolver = converged_pair
    solver.reset()
    tsolver.reset()
    ref = solver.solve(X0_PEND)
    got = tsolver.solve(X0_PEND)
    assert sorted(got) == sorted(ref)
    assert got["success"] == ref["success"] is True
    for k in ("iterations", "SOCP_steps", "qp_iters"):
        assert got[k] == ref[k], k
    assert sorted(got["it_data"]) == sorted(ref["it_data"])
    for k, v in ref.items():
        if k.startswith("t_") or k in ("success", "it_data"):
            continue
        _close(got[k], v, k)
    # reset_warm_start shifts the plan and keeps the convergence memory
    solver.reset_warm_start()
    tsolver.reset_warm_start()
    _close(tsolver._X[0].numpy(), solver._X, "shifted X")
    _close(tsolver._persist.prev_primal[0].numpy(), solver._persist.prev_primal, "prev_primal")
    assert tsolver.it_data == {}
    tsolver.reset()
    assert tsolver._X is None


def test_lqr_and_deviation_mismatch_match_jax():
    m, solver, tm, tsolver = _pendulum()
    ref, got = solver.generate_lqr_controller(), tsolver.generate_lqr_controller()
    for k in ("K", "P", "A", "B"):
        _close(got[k], ref[k], k)
    _close(got["controller"](X0_PEND), ref["controller"](X0_PEND), "controller")
    # JAX's generate_lqr_controller also overwrites Qf for its nominal SQP
    # (the port keeps Qf): the mismatch check starts from fresh solvers
    m, solver, tm, tsolver = _pendulum()
    assert solver.solve_nominal_trajectory(X0_PEND)
    assert tsolver.solve_nominal_trajectory(X0_PEND)
    rng = np.random.default_rng(4)
    e, d = 0.01 * rng.standard_normal((4, N + 1)), 0.01 * rng.standard_normal((1, N))
    ref, got = solver.eval_deviation_mismatch(e, d), tsolver.eval_deviation_mismatch(e, d)
    for k in ref:
        _close(got[k], ref[k], k)


def _rocket(N_r, **opts):
    m, solver = make_rocket_problem(N=N_r)
    solver.opts = solver.opts._replace(verbose=False, **opts)
    d = dict(N=N_r, Q=solver.Q, R=solver.R, Qf=solver.Qf, Q_reg=solver.Q_reg,
             R_reg=solver.R_reg, Q_reg_f=solver.Q_reg_f, E=m.E, dt=m.dt,
             options=interop.options_to_plain(solver.opts))
    return m, solver, interop.solver_from_numpy(d, device="cpu")


def test_solve_profiled_matches_jax():
    m, solver, tm, tsolver = _pendulum(rti=1, fast_sls_rti_steps=1)
    ref, got = solver.solve_profiled(X0_PEND), tsolver.solve_profiled(X0_PEND)
    assert sorted(got) == sorted(ref)
    assert got["success"] == ref["success"]
    for k in ("primal_x", "primal_u", "backoff", "backoff_f", "backoff_x", "backoff_u"):
        _close(got[k], ref[k], k)


def test_rocket_until_convergence_matches_jax():
    Nr, Bsz, T = 4, 3, 2
    m, solver, tsolver = _rocket(Nr, rti=-1, fast_sls_rti_steps=0, epsilon_convergence=1e-6,
                                 max_iter_scp=10)
    rng = np.random.default_rng(2)
    x0s = np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, m.nx))
    Ws = 2 * rng.random((Bsz, T, m.nw)) - 1
    ref = jax.jit(jax.vmap(build_batched_closed_loop(solver, T)))(jnp.asarray(x0s),
                                                                   jnp.asarray(Ws))
    got = t_batched(tsolver, T)(x0s, Ws)
    for f in ("success", "scp_iters", "scp_failed", "qp_iters"):
        assert getattr(got, f).tolist() == np.asarray(getattr(ref, f)).tolist(), f
    assert int(got.scp_iters.max()) > 1
    for f in ("state_trajectory", "input_trajectory", "nominal_x", "nominal_u",
              "backoff_x", "backoff_u"):
        _close(getattr(got, f).numpy(), getattr(ref, f), f)

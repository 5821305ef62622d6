"""PyTorch port: the until-convergence closed loop (rti = -1) against the
JAX package (float64, CPU), on the pendulum of the reference experiment at
N = 8, B = 4 lanes, 3 steps, SCP criterion 1e-7, at most 12 SCP iterations.

* `build_batched_closed_loop`: per step and lane, success, SCP iterations,
  scp_failed and QP iterations identical; X, U, u0 and the backoffs within
  1e-8 (NaN where JAX has NaN).
* The same with feasibility restoration and stall damping on, where both
  are taken: the constraints are tightened until the tube makes fast-SLS
  infeasible on some SCP iterations.
* The crippled-IPM failure (one Mehrotra iteration at tolerance 1e-12):
  every step fails, the plan stays the last accepted one (the SQP seed at
  step 0) and the backoffs are the NaN sentinel, as in JAX; the host
  `solve` returns the same plan.
* `build_chunked_converged_loop` equals the port's batched loop exactly at
  `scp_per_dispatch` 1 and 5, and its host-chunked soft fallback is a no-op
  when every hard SQP succeeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_nonlinear_mpc_torch.interop as interop
from robust_nonlinear_mpc_torch.sim import closed_loop as tcl
from robust_nonlinear_mpc_tpu.models import Pendulum
from robust_nonlinear_mpc_tpu.ops.qp_ipm import IPMOptions
from robust_nonlinear_mpc_tpu.sim.closed_loop import build_batched_closed_loop
from robust_nonlinear_mpc_tpu.solvers.scp_sls import SCPSLSSolver

torch.set_num_threads(1)
N, B, T, TOL = 8, 4, 3, 1e-8


def _pendulum(tight=False, **opts):
    m = Pendulum()
    m.E = 0.003 * np.eye(4)
    if tight:
        # a tube that fills the corridor: larger disturbances, a narrow box
        m.E = 0.01 * np.eye(4)
        x_max = np.array([10.0, 1.0, 0.25, 2.0])
        m.replace_constraints(x_max, -x_max, [5.0], [-5.0], x_max, -x_max)
    solver = SCPSLSSolver(
        N, np.eye(4), np.eye(1), m, 10 * np.eye(4),
        Q_reg=1e3 * np.eye(4), R_reg=1e3 * np.eye(1), Q_reg_f=1e4 * np.eye(4),
        rti=-1, fast_sls_rti_steps=0,
    )
    solver.opts = solver.opts._replace(
        **{"epsilon_convergence": 1e-7, "max_iter_scp": 12, "verbose": False, **opts})
    d = dict(model="pendulum", N=N, Q=solver.Q, R=solver.R, Qf=solver.Qf,
             Q_reg=solver.Q_reg, R_reg=solver.R_reg, Q_reg_f=solver.Q_reg_f,
             E=m.E, dt=m.dt, g=m.g, gf=m.gf, options=interop.options_to_plain(solver.opts))
    return m, solver, interop.solver_from_numpy(d, device="cpu")


def _draws(seed, center=(0.5, 0.5, 0.0, 0.0), spread=0.1):
    rng = np.random.default_rng(seed)
    x0s = np.array(center)[None] + spread * rng.standard_normal((B, 4))
    Ws = 2 * rng.random((B, T, 4)) - 1
    return x0s, Ws


def _compare(ref, got):
    for f in ("success", "scp_iters", "scp_failed", "qp_iters"):
        assert getattr(got, f).tolist() == np.asarray(getattr(ref, f)).tolist(), f
    for f in ("state_trajectory", "input_trajectory", "nominal_x", "nominal_u",
              "backoff_x", "backoff_u"):
        r, g = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        assert np.array_equal(np.isnan(r), np.isnan(g)), f"{f}: NaN pattern"
        err = np.nanmax(np.abs(g - r)) if np.isfinite(r).any() else 0.0
        assert err <= TOL, f"{f}: {err:.3e}"


def _jax_run(solver, x0s, Ws):
    return jax.jit(jax.vmap(build_batched_closed_loop(solver, T)))(
        jnp.asarray(x0s), jnp.asarray(Ws))


def test_until_convergence_matches_jax():
    m, solver, tsolver = _pendulum()
    x0s, Ws = _draws(7)
    ref = _jax_run(solver, x0s, Ws)
    got = tcl.build_batched_closed_loop(tsolver, T)(x0s, Ws)
    assert bool(np.asarray(ref.success).all())
    assert int(np.asarray(ref.scp_iters).max()) > 1
    _compare(ref, got)
    # the chunked driver: the same per-lane iterations, bit for bit
    for kpd in (1, 5):
        ch = tcl.build_chunked_converged_loop(tsolver, T, scp_per_dispatch=kpd)(x0s, Ws)
        for f, a in got._asdict().items():
            b = getattr(ch, f)
            assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), (kpd, f)


def test_restoration_and_stall_damping_match_jax():
    m, solver, tsolver = _pendulum(tight=True, feasibility_restoration=True,
                                   scp_stall_damping=0.5, stall_damping_after=2)
    x0s, Ws = _draws(3, center=(0.3, 0.5, 0.1, 0.0), spread=0.05)
    ref = _jax_run(solver, x0s, Ws)
    restored = []
    restore = tsolver._restore

    def counting(*a):
        out = restore(*a)
        restored.append(int(out[2].sum()))
        return out

    tsolver._restore = counting
    got = tcl.build_batched_closed_loop(tsolver, T)(x0s, Ws)
    # both mitigations are taken: a restored iterate on some SCP iteration,
    # and lanes past the damping threshold
    assert sum(restored) > 0
    assert int(got.scp_iters.max()) > 2
    _compare(ref, got)


def test_crippled_ipm_keeps_the_last_accepted_plan():
    crippled = dict(ipm=IPMOptions(max_iter=1, tol=1e-12), epsilon_convergence=1e-9,
                    max_iter_scp=6)
    m, solver, tsolver = _pendulum(**crippled)
    x0s, Ws = _draws(7)
    ref = _jax_run(solver, x0s, Ws)
    got = tcl.build_batched_closed_loop(tsolver, T)(x0s, Ws)
    assert not bool(got.success[:, 0].any())
    assert bool(got.scp_failed[:, 0].all())
    assert torch.isnan(got.backoff_x[:, 0]).all()
    _compare(ref, got)
    # step 0's plan is the SQP seed
    X0, U0, _ = tcl._nominal(tsolver, torch.as_tensor(x0s))
    assert torch.equal(got.nominal_u[:, 0], U0)
    # the host solve rejects the failed iterate the same way
    tsolver.reset()
    assert tsolver.solve_nominal_trajectory(x0s[0])
    U_nom = tsolver._U[0].numpy().copy()
    sol = tsolver.solve(x0s[0])
    assert not sol["success"]
    np.testing.assert_array_equal(sol["primal_u"], U_nom.T)
    assert np.isnan(sol["backoff_x"]).all() and np.isnan(sol["K"]).all()


def test_chunked_soft_fallback_is_a_noop_on_success():
    _, _, tsolver = _pendulum()
    x0s, Ws = _draws(3)
    base = tcl.build_chunked_converged_loop(tsolver, 2)(x0s, Ws[:, :2])
    tsolver.opts = tsolver.opts._replace(nominal_soft_fallback=True)
    fb = tcl.build_chunked_converged_loop(tsolver, 2)(x0s, Ws[:, :2])
    assert bool(fb.success.all())
    assert torch.equal(fb.state_trajectory, base.state_trajectory)
    assert torch.equal(fb.input_trajectory, base.input_trajectory)


def test_soft_fallback_reseeds_failed_lanes():
    # a crippled hard SQP fails every lane; the fallback re-seeds them all
    from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions

    _, _, tsolver = _pendulum()
    x0s = torch.as_tensor(_draws(5)[0])
    tsolver.opts = tsolver.opts._replace(sqp=SQPOptions(max_iter=1))
    X, U, ok = tcl._nominal(tsolver, x0s)
    assert not bool(ok.any())
    Xf, Uf = tcl._soft_fallback(tsolver, x0s, X, U, ok, chunk=3)
    Xa, Ua = tcl._soft_fallback(tsolver, x0s, X, U, ok)
    assert torch.allclose(Xf, Xa, atol=1e-9) and torch.allclose(Uf, Ua, atol=1e-9)
    assert torch.allclose(Xf[:, 0], x0s, atol=1e-6)
    assert not torch.equal(Uf, U)


def test_mesh_and_rti_are_refused():
    _, _, tsolver = _pendulum()
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tcl.build_chunked_converged_loop(tsolver, 2, mesh=object())
    tsolver.opts = tsolver.opts._replace(rti=1)
    with pytest.raises(ValueError, match="until-convergence"):
        tcl.build_chunked_converged_loop(tsolver, 2)

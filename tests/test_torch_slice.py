"""PyTorch port: the whole slice against the JAX package (float64, CPU).

`make_rocket_problem(N=6)`, B = 3 lanes, the bench's options (recycled eta,
cross-step QP warm start, streaming response, adaptive (6, 15) IPM budget,
QP tolerance 3e-5, fused Newton solves: JAX "pallas" in interpret mode,
the port's "fused" on its plain twins). The problem and the state cross
over through `robust_nonlinear_mpc_torch.interop`.

* SQP seed: per-lane iteration counts equal and X/U within 1e-7. The seed
  runs at step/feasibility tolerance 1e-6: at the default 1e-9 the line
  search ends up comparing merit values that differ in their last digits,
  so the iteration count depends on rounding order (measured: the same
  solution to 5e-9, counts [42, 50, 36] in JAX against [60, 47, 53] here).
* Soft-slack fallback solve (N = 2, B = 2): iteration counts, success and
  X/U within 1e-7.
* 3 closed-loop MPC steps from the same seed: per step and lane, success
  and QP iterations identical, u0, X, U and the backoffs within 1e-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_nonlinear_mpc_torch.interop as interop
from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step as t_make_mpc_step
from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_nlp_solve as t_soft
from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions as TSQPOptions
from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve as t_sqp
from robust_nonlinear_mpc_tpu.expe.main_rocket_robust_closed_loop import X0, make_rocket_problem
from robust_nonlinear_mpc_tpu.ops.qp_ipm import IPMOptions
from robust_nonlinear_mpc_tpu.sim.closed_loop import make_mpc_step
from robust_nonlinear_mpc_tpu.solvers.fast_sls import FastSLSPersist
from robust_nonlinear_mpc_tpu.solvers.soft_nlp import soft_nlp_solve
from robust_nonlinear_mpc_tpu.solvers.sqp import SQPOptions, sqp_solve

torch.set_num_threads(1)
N, Bsz, TOL = 6, 3, 1e-7
SEED_TOL = 1e-6


def _problem(N):
    m, solver = make_rocket_problem(N=N)
    kkt = "pallas"
    solver.opts = solver.opts._replace(
        verbose=False,
        ipm=IPMOptions(max_iter=15, tol=3e-5, kkt=kkt),
        adaptive_ipm_budget=(6, 15),
        ipm_first=IPMOptions(max_iter=8, tol=1e-3, kkt=kkt),
        streaming_response=True, recycle_eta=True, recycle_warm_qp=True, sls_block=0,
    )
    d = dict(N=N, Q=solver.Q, R=solver.R, Qf=solver.Qf, Q_reg=solver.Q_reg,
             R_reg=solver.R_reg, Q_reg_f=solver.Q_reg_f, E=m.E, dt=m.dt,
             options=interop.options_to_plain(solver.opts))
    return m, solver, interop.solver_from_numpy(d, device="cpu")


@pytest.fixture(scope="module")
def slice_setup():
    m, solver, tsolver = _problem(N)
    assert tsolver.opts.ipm.kkt == "fused"
    rng = np.random.default_rng(0)
    x0s = np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, m.nx))
    w = rng.uniform(-1.0, 1.0, (3, Bsz, m.nw))
    jopts = SQPOptions(tol_step=SEED_TOL, tol_feas=SEED_TOL)
    nom = jax.jit(jax.vmap(
        lambda x: sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x, opts=jopts)
    ))(jnp.asarray(x0s))
    return m, solver, tsolver, x0s, w, nom


def test_sqp_seed_matches_jax(slice_setup):
    m, solver, tsolver, x0s, w, nom = slice_setup
    tnom = t_sqp(tsolver.m, N, tsolver.Q, tsolver.R, tsolver.Qf, torch.as_tensor(x0s),
                 opts=TSQPOptions(tol_step=SEED_TOL, tol_feas=SEED_TOL))
    assert tnom.iters.tolist() == np.asarray(nom.iters).tolist()
    assert tnom.success.tolist() == np.asarray(nom.success).tolist() == [True] * Bsz
    assert np.abs(tnom.X.numpy() - np.asarray(nom.X)).max() <= TOL
    assert np.abs(tnom.U.numpy() - np.asarray(nom.U)).max() <= TOL


def test_soft_fallback_matches_jax():
    N2, B2 = 2, 2
    m, solver, tsolver = _problem(N2)
    rng = np.random.default_rng(5)
    x0s = np.array(X0)[None] + 0.02 * rng.standard_normal((B2, m.nx))
    ref = jax.jit(jax.vmap(lambda x: soft_nlp_solve(
        m, N2, solver.Q, solver.R, solver.Qf, x, rho_soft=1e6, rho_soft_l1=1e6
    )))(jnp.asarray(x0s))
    got = t_soft(tsolver.m, N2, tsolver.Q, tsolver.R, tsolver.Qf, torch.as_tensor(x0s),
                 rho_soft=1e6, rho_soft_l1=1e6)
    assert got.iters.tolist() == np.asarray(ref.iters).tolist()
    assert got.success.tolist() == np.asarray(ref.success).tolist()
    for f in ("X", "U", "gamma", "gamma_f"):
        assert np.abs(getattr(got, f).numpy() - np.asarray(getattr(ref, f))).max() <= TOL, f


def test_closed_loop_steps_match_jax(slice_setup):
    m, solver, tsolver, x0s, w, nom = slice_setup
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, jnp.float64,
                                  store_phi=False)
    persists = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (Bsz,) + a.shape), persist)
    carry = (nom.X, nom.U, persists, jnp.asarray(x0s))
    tcarry = interop.carry_from_numpy({
        "X": np.asarray(nom.X), "U": np.asarray(nom.U),
        "persist": interop.tree_to_numpy(persists), "x": x0s,
    }, device="cpu")
    step = jax.jit(jax.vmap(make_mpc_step(solver)))
    tstep = t_make_mpc_step(tsolver)
    names = {1: "u0", 2: "X", 3: "U", 4: "backoff_x", 5: "backoff_u"}
    for i in range(3):
        carry, out = step(carry, jnp.asarray(w[i]))
        tcarry, tout = tstep(tcarry, torch.as_tensor(w[i]))
        assert tout[6].tolist() == np.asarray(out[6]).tolist(), f"success, step {i}"
        assert tout[7].tolist() == np.asarray(out[7]).tolist(), f"qp_iters, step {i}"
        for j, name in names.items():
            err = np.abs(tout[j].numpy() - np.asarray(out[j])).max()
            assert err <= TOL, f"{name}, step {i}: {err:.3e}"
    # the carried state agrees too, field by field
    got = interop.carry_to_numpy(tcarry)
    ref = {"X": np.asarray(carry[0]), "U": np.asarray(carry[1]),
           "persist": interop.tree_to_numpy(carry[2]), "x": np.asarray(carry[3])}
    for k in ("X", "U", "x"):
        assert np.abs(got[k] - ref[k]).max() <= TOL, k
    for k in ("eta", "eta_f", "prev_primal"):
        scale = max(np.abs(ref["persist"][k]).max(), 1.0)
        assert np.abs(got["persist"][k] - ref["persist"][k]).max() <= TOL * scale, k
    for k in ("have_prev", "qp_steady"):
        assert np.array_equal(got["persist"][k], ref["persist"][k]), k
    assert np.array_equal(got["persist"]["qp_warm"]["valid"], ref["persist"]["qp_warm"]["valid"])


TINY = dict(device="cpu", dtype=torch.float64, B=2, N=4, n_warm=1, n_rep=1)


@pytest.fixture(scope="module")
def tiny_workload():
    """The bench twin's default workload at a tiny size on the CPU, seeded
    once for the tests that step it or seed other configurations from it."""
    from robust_nonlinear_mpc_torch import bench

    return bench.build_workload(**TINY)


def test_bench_workload_builds_and_steps_on_cpu(tiny_workload):
    """The bench twin's workload at a tiny size on the CPU (plain Newton
    solves): seeds every lane, and one step keeps the state finite."""
    wl = tiny_workload
    assert wl.solver.opts.ipm.kkt == "fused" and wl.budget_mode == "adaptive(6,15)"
    assert wl.sls_block == wl.solver._fast_sls_opts().sls_block == 0
    assert wl.w_seq.shape == (2, 2, wl.m.nw)
    carry, out = wl.mpc_step(wl.carry, wl.w_seq[0])
    assert out[6].all() and torch.isfinite(carry[0]).all() and torch.isfinite(carry[3]).all()


def test_bench_refuses_to_run_without_a_gpu(monkeypatch):
    from robust_nonlinear_mpc_torch import bench

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()


def test_make_rocket_problem_matches_jax():
    """The port's own experiment setup (used by the bench twin) builds the
    JAX experiment's problem."""
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import X0 as TX0
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        make_rocket_problem as t_make,
    )

    m, solver = make_rocket_problem(N=5)
    tm, ts = t_make(N=5, device="cpu")
    assert TX0 == X0 and ts.N == solver.N and tm.dt == m.dt
    assert (ts.opts.rti, ts.opts.fast_sls_rti_steps) == (solver.opts.rti, solver.opts.fast_sls_rti_steps)
    assert np.array_equal(tm.E.numpy(), np.asarray(m.E))
    for name in ("Q", "R", "Qf", "Q_reg", "R_reg", "Q_reg_f"):
        assert np.array_equal(getattr(ts, name).numpy(), np.asarray(getattr(solver, name))), name
    assert np.array_equal(ts.E.numpy(), np.asarray(solver.prob.E))


def test_bench_fused_kernel_configuration_on_cpu(tiny_workload):
    """The fused-kernel configuration of the bench twin (whole-iteration
    kernel, fused response) at a tiny size on the CPU (plain twins), seeded
    from the default configuration's workload: the same lanes, real Phi
    buffers carried, and one step keeps the state finite."""
    from robust_nonlinear_mpc_torch import bench

    size, base = TINY, tiny_workload
    wl = bench.build_workload(**size, kkt="fused_iter", response="fused", seed_from=base)
    assert all(torch.equal(a, b) for a, b in zip(wl.carry[:2], base.carry[:2]))
    assert torch.equal(wl.w_seq, base.w_seq)
    fopts = wl.solver._fast_sls_opts()
    assert wl.solver.opts.ipm.kkt == "fused_iter" and wl.response == "fused"
    assert fopts.use_pallas_response and not fopts.streaming_response
    assert wl.carry[2].Phi_x.shape == (2, 5, 5, wl.m.nx, wl.m.nw)
    carry, out = wl.mpc_step(wl.carry, wl.w_seq[0])
    assert out[6].all() and torch.isfinite(carry[0]).all() and torch.isfinite(carry[3]).all()
    assert carry[2].Phi_x.shape == (2, 5, 5, wl.m.nx, wl.m.nw)
    # the hand-written backward's configuration (its plain twin here)
    wl = bench.build_workload(**size, sls_block=-1, seed_from=base)
    assert wl.solver._fast_sls_opts().sls_block == -1 and wl.sls_block == -1
    carry, out = wl.mpc_step(wl.carry, wl.w_seq[0])
    assert out[6].all() and torch.isfinite(carry[0]).all()
    with pytest.raises(ValueError, match="response must be one of"):
        bench.build_workload(device="cpu", B=2, N=4, response="blocked")
    with pytest.raises(ValueError, match="other initial states"):
        bench.build_workload(**{**size, "B": 3}, seed_from=base)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card the entry points raise instead of falling back to the
    CPU; device="cpu" runs there."""
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        make_rocket_problem as t_make,
    )
    from robust_nonlinear_mpc_torch.models.rocket import Rocket

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (Rocket, t_make, lambda: interop.solver_from_numpy({}),
                  lambda: interop.carry_from_numpy({})):
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            build()
    assert Rocket(device="cpu").G.device.type == "cpu"

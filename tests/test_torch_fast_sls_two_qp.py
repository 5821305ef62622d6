"""PyTorch port: the two-QP fast-SLS iteration (`recycle_eta=False`) against
the JAX package (float64, CPU).

* The double integrator of tests/test_fast_sls.py at N = 8, three lanes
  (one from an infeasible start), with `ipm_first`: the JAX
  `fast_sls_solve` (vmapped, sls_block = 0) in RTI mode (rti_steps = 2,
  streaming response; also with `warm_start_qp`) and until-convergence mode
  (Phi-materializing response, primal tolerance 1e-6, so that the lanes
  stop at different iterations: one converges after 17, one reaches the
  cap of 30, the infeasible one stops at once); the port at sls_block in
  {0, 3, -1} against that one JAX run. Per lane iteration_number and
  success identical; on the lanes whose entry QP is feasible qp_iters
  identical and X, U and the backoffs within 1e-8.
* The infeasible lane's entry QP fails in both packages, and where its
  Mehrotra run stops is set by rounding: its duals grow by about 1e24 per
  iteration until a step overflows, and a single step from one iterate
  already differs between the packages by 0.5 % from iteration 6 on
  (condition number past 1e16). The JAX run itself stops after 7 or after
  17 iterations when x0 moves by one to three ulps. So the port's entry QP
  at each of those x0 must stop at one of the points JAX reaches there,
  and that set must hold more than one; in until-convergence mode, where
  the lane runs only its entry QP, its qp_iters in both packages too.
* The rocket closed loop with `make_rocket_problem`'s own options (two-QP
  RTI 1/1, riccati QP at tolerance 1e-9), N = 4, B = 2, 2 steps from one
  nominal: success and QP iterations identical, u0, X, U and the backoffs
  within 1e-7 (the tolerances of tests/test_torch_slice.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_nonlinear_mpc_torch.interop as interop
from robust_nonlinear_mpc_torch.ops import qp_ipm as tq
from robust_nonlinear_mpc_torch.ops import sls_kernels as ts
from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step as t_make_mpc_step
from robust_nonlinear_mpc_torch.solvers import fast_sls as tf
from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions as TSQPOptions
from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve as t_sqp
from robust_nonlinear_mpc_tpu.expe.main_rocket_robust_closed_loop import X0, make_rocket_problem
from robust_nonlinear_mpc_tpu.ops.qp_ipm import IPMOptions, QPData, QPStatics, solve_qp
from robust_nonlinear_mpc_tpu.ops.sls_kernels import SLSRegs
from robust_nonlinear_mpc_tpu.sim.closed_loop import make_mpc_step
from robust_nonlinear_mpc_tpu.solvers.fast_sls import (
    FastSLSOptions,
    FastSLSPersist,
    SLSProblem,
    fast_sls_solve,
)

torch.set_num_threads(1)
N, NI, NI_F = 8, 6, 4
X0S = np.array([[3.0, 0.5], [-1.0, 1.5], [5.0, 0.0]])
TOL = 1e-8
IPM = dict(max_iter=50, tol=1e-10)
IPM_FIRST = dict(max_iter=50, tol=1e-6)


def _double_integrator():
    """tests/test_fast_sls.py's problem as numpy arrays."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])
    G = np.vstack([np.eye(3), -np.eye(3)])
    return dict(
        A=np.broadcast_to(A, (N, 2, 2)), B=np.broadcast_to(B, (N, 2, 1)),
        Hx=2 * np.eye(2), Hu=0.2 * np.eye(1), HxN=10 * np.eye(2), Gx=G[:, :2], Gu=G[:, 2:],
        Gf=np.vstack([np.eye(2), -np.eye(2)]), regs=(10 * np.eye(2), 10 * np.eye(1), 50 * np.eye(2)),
        E=np.broadcast_to(0.02 * np.eye(2), (N + 1, 2, 2)),
        g=np.broadcast_to(np.array([4.0, 4.0, 2.0, 4.0, 4.0, 2.0]), (N, NI)), gf=np.full(NI_F, 4.0),
    )


def _jax_stat(p):
    J = jnp.asarray
    return QPStatics(Hx=J(p["Hx"]), Hu=J(p["Hu"]), HxN=J(p["HxN"]), Gx=J(p["Gx"]),
                     Gu=J(p["Gu"]), Gf=J(p["Gf"]))


def _jax_run(rti_steps, streaming, warm):
    p = _double_integrator()
    J = lambda a: jnp.asarray(a)
    prob = SLSProblem(stat=_jax_stat(p), regs=SLSRegs(*map(J, p["regs"])), E=J(p["E"]))
    persist = FastSLSPersist.init(N, 2, 1, NI, NI_F, 2, jnp.float64)
    opts = FastSLSOptions(rti_steps=rti_steps, max_iter=30, streaming_response=streaming,
                          conv_tol=1e-3 if rti_steps else 1e-6, warm_start_qp=warm,
                          ipm=IPMOptions(**IPM), ipm_first=IPMOptions(**IPM_FIRST), sls_block=0)
    solve = jax.jit(jax.vmap(lambda x0: fast_sls_solve(
        prob, J(p["A"]), J(p["B"]), jnp.zeros((N, 2)), jnp.zeros((N + 1, 2)), jnp.zeros((N, 1)),
        J(p["g"]), J(p["gf"]), x0, persist, opts)))
    return solve(J(X0S))


def _port_run(rti_steps, streaming, sls_block, verbose=False, warm=False):
    p = _double_integrator()
    Bsz = X0S.shape[0]
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    lanes = lambda a: T(np.broadcast_to(a, (Bsz,) + a.shape))
    stat = tq.QPStatics(Hx=T(p["Hx"]), Hu=T(p["Hu"]), HxN=T(p["HxN"]), Gx=T(p["Gx"]),
                        Gu=T(p["Gu"]), Gf=T(p["Gf"]))
    prob = tf.SLSProblem(stat=stat, regs=ts.SLSRegs(*map(T, p["regs"])), E=T(p["E"]))
    persist = tf.FastSLSPersist.init(N, 2, 1, NI, NI_F, 2, batch=Bsz, dtype=torch.float64,
                                     device="cpu", store_phi=not streaming)
    opts = tf.FastSLSOptions(rti_steps=rti_steps, max_iter=30, streaming_response=streaming,
                             conv_tol=1e-3 if rti_steps else 1e-6, warm_start_qp=warm,
                             ipm=tq.IPMOptions(**IPM), ipm_first=tq.IPMOptions(**IPM_FIRST),
                             sls_block=sls_block, verbose=verbose)
    z = lambda *s: torch.zeros((Bsz,) + s, dtype=torch.float64)
    return tf.fast_sls_solve(prob, lanes(p["A"]), lanes(p["B"]), z(N, 2), z(N + 1, 2), z(N, 1),
                             lanes(p["g"]), lanes(p["gf"]), T(X0S), persist, opts)


@pytest.fixture(scope="module", params=[(2, True, False), (2, True, True), (0, False, False)],
                ids=["rti2", "rti2_warm", "until_conv"])
def jax_run(request):
    rti_steps, streaming, warm = request.param
    return rti_steps, streaming, warm, _jax_run(rti_steps, streaming, warm)


def _near_infeasible_x0():
    """The infeasible lane's x0 with x0[0] moved by -3 .. 3 ulps."""
    x0 = X0S[2]
    return np.array([[x0[0] + u * np.spacing(x0[0]), x0[1]] for u in range(-3, 4)])


@pytest.fixture(scope="module")
def infeasible_stops():
    """Iteration counts at which the JAX entry QP of the infeasible lane
    stops, for x0[0] within three ulps of its value."""
    p = _double_integrator()
    J = jnp.asarray
    solve = jax.jit(jax.vmap(lambda xi: solve_qp(_jax_stat(p), QPData(
        A=J(p["A"]), B=J(p["B"]), c=jnp.zeros((N, 2)), qx=jnp.zeros((N + 1, 2)),
        qu=jnp.zeros((N, 1)), h=J(p["g"]), hf=J(p["gf"]), xinit=xi), IPMOptions(**IPM_FIRST))))
    out = solve(J(_near_infeasible_x0()))
    assert not np.asarray(out.success).any()
    return set(np.asarray(out.iters).tolist())


def test_infeasible_entry_qp_stop_is_set_by_rounding(infeasible_stops):
    p = _double_integrator()
    x0s = torch.as_tensor(_near_infeasible_x0())
    Bsz = x0s.shape[0]
    lanes = lambda a: torch.as_tensor(np.ascontiguousarray(np.broadcast_to(a, (Bsz,) + a.shape)))
    z = lambda *s: torch.zeros((Bsz,) + s, dtype=torch.float64)
    T = lambda a: torch.as_tensor(np.ascontiguousarray(a))
    stat = tq.QPStatics(Hx=T(p["Hx"]), Hu=T(p["Hu"]), HxN=T(p["HxN"]), Gx=T(p["Gx"]),
                        Gu=T(p["Gu"]), Gf=T(p["Gf"]))
    data = tq.QPData(A=lanes(p["A"]), B=lanes(p["B"]), c=z(N, 2), qx=z(N + 1, 2), qu=z(N, 1),
                     h=lanes(p["g"]), hf=lanes(p["gf"]), xinit=x0s)
    got = tq.solve_qp(stat, data, tq.IPMOptions(**IPM_FIRST))
    assert len(infeasible_stops) > 1
    assert not got.success.any()
    assert set(got.iters.tolist()) <= infeasible_stops


@pytest.mark.parametrize("sls_block", [0, 3, -1])
def test_two_qp_fast_sls_matches_jax(jax_run, infeasible_stops, sls_block):
    rti_steps, streaming, warm, ref = jax_run
    got = _port_run(rti_steps, streaming, sls_block, warm=warm)
    for f in ("iteration_number", "success"):
        assert getattr(got, f).tolist() == np.asarray(getattr(ref, f)).tolist(), f
    assert np.asarray(ref.success).tolist() == [True, bool(rti_steps), False]
    ok = np.array([True, True, False])
    assert got.qp_iters.numpy()[ok].tolist() == np.asarray(ref.qp_iters)[ok].tolist()
    if not rti_steps:
        assert int(got.qp_iters[2]) in infeasible_stops
        assert int(np.asarray(ref.qp_iters)[2]) in infeasible_stops
    for f in ("X", "U", "backoff", "backoff_f", "backoff_x", "backoff_u", "cost_tube"):
        err = np.abs(getattr(got, f).numpy()[ok] - np.asarray(getattr(ref, f))[ok]).max()
        assert err <= TOL, f"{f}: {err:.3e}"
    if rti_steps:
        assert int(got.iteration_number.max()) <= rti_steps
    else:
        assert got.iteration_number.tolist() == [17, 30, 0]
        assert got.persist.Phi_x.shape == (3, N + 1, N + 1, 2, 2)


def test_two_qp_verbose_table(capsys):
    """opts.verbose prints the reference's per-iteration table from the
    host, one row per lane and iteration, and changes nothing else."""
    quiet = _port_run(2, True, 0)
    capsys.readouterr()
    loud = _port_run(2, True, 0, verbose=True)
    out = capsys.readouterr().out
    assert "cost tube" in out
    rows = [line for line in out.splitlines() if line.strip() and "cost tube" not in line]
    assert len(rows) == 2 * X0S.shape[0] and all(r.startswith("\t") for r in rows)
    assert torch.equal(loud.X, quiet.X) and torch.equal(loud.qp_iters, quiet.qp_iters)


def test_rocket_two_qp_closed_loop_matches_jax():
    """make_rocket_problem's own options (recycle_eta False, RTI 1/1) step
    the rocket closed loop in the port as in the JAX package."""
    Nr, Bsz, tol = 4, 2, 1e-7
    m, solver = make_rocket_problem(N=Nr)
    solver.opts = solver.opts._replace(verbose=False)
    assert not solver.opts.recycle_eta and solver.opts.sls_block == 0
    d = dict(N=Nr, Q=solver.Q, R=solver.R, Qf=solver.Qf, Q_reg=solver.Q_reg,
             R_reg=solver.R_reg, Q_reg_f=solver.Q_reg_f, E=m.E, dt=m.dt,
             options=interop.options_to_plain(solver.opts))
    tsolver = interop.solver_from_numpy(d, device="cpu")
    rng = np.random.default_rng(3)
    x0s = np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, m.nx))
    w = rng.uniform(-1.0, 1.0, (2, Bsz, m.nw))
    nom = t_sqp(tsolver.m, Nr, tsolver.Q, tsolver.R, tsolver.Qf, torch.as_tensor(x0s),
                opts=TSQPOptions(tol_step=1e-6, tol_feas=1e-6))
    assert nom.success.all()
    persist = FastSLSPersist.init(Nr, m.nx, m.nu, m.ni, m.ni_f, m.nw, jnp.float64)
    persists = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (Bsz,) + a.shape), persist)
    carry = (jnp.asarray(nom.X.numpy()), jnp.asarray(nom.U.numpy()), persists, jnp.asarray(x0s))
    tcarry = interop.carry_from_numpy({
        "X": nom.X.numpy(), "U": nom.U.numpy(), "persist": interop.tree_to_numpy(persists),
        "x": x0s,
    }, device="cpu")
    step = jax.jit(jax.vmap(make_mpc_step(solver)))
    tstep = t_make_mpc_step(tsolver)
    names = {1: "u0", 2: "X", 3: "U", 4: "backoff_x", 5: "backoff_u"}
    for i in range(2):
        carry, out = step(carry, jnp.asarray(w[i]))
        tcarry, tout = tstep(tcarry, torch.as_tensor(w[i]))
        assert tout[6].tolist() == np.asarray(out[6]).tolist() == [True] * Bsz, f"success, step {i}"
        assert tout[7].tolist() == np.asarray(out[7]).tolist(), f"qp_iters, step {i}"
        for j, name in names.items():
            err = np.abs(tout[j].numpy() - np.asarray(out[j])).max()
            assert err <= tol, f"{name}, step {i}: {err:.3e}"

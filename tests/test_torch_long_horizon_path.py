"""PyTorch port: the long-horizon path against the JAX package (float64, CPU).

`make_rocket_problem(N=60)` at the rocket's full widths (nx = nw = 17,
nu = 4, ni = 42, ni_f = 34), B = 2 lanes, the bench's options (as
tests/test_torch_slice.py), problem and state crossing over through
`robust_nonlinear_mpc_torch.interop`. Above N = 30 the JAX package's
kkt="pallas" runs its windowed Newton kernels (`_factor_bwd_win_kernel`,
`_newton_fwd_win_kernel`, `_resolve_bwd_win_kernel`), here in interpret
mode; the port's kkt="fused" runs the plain twins of its Newton kernels,
which take any N in one stage loop.

* 2 closed-loop MPC steps from one SQP seed: per step and lane, success
  and QP iterations identical; u0, X, U and the backoffs within 1e-7.
* The QP probe (`tools/fused_n60_qp_probe.py`) at N = 60 on the same
  lanes (its lanes and SQP options those of the JAX probe), around the
  seed's nominals: each lane's deviation QP solved by the port's "fused"
  and "riccati" against JAX's "pallas" and "riccati", iterations and
  success identical, U within 1e-7.

`generate_lqr_controller` followed by the nominal plan on the same
solvers is held against JAX in tests/test_torch_host_solver.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_nonlinear_mpc_torch.interop as interop
from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step as t_make_mpc_step
from robust_nonlinear_mpc_torch.tools import fused_n60_qp_probe as tprobe
from robust_nonlinear_mpc_tpu.expe.main_rocket_robust_closed_loop import X0, make_rocket_problem
from robust_nonlinear_mpc_tpu.ops.pallas_qp import _pick_window
from robust_nonlinear_mpc_tpu.ops.qp_ipm import IPMOptions, QPData, solve_qp
from robust_nonlinear_mpc_tpu.sim.closed_loop import make_mpc_step
from robust_nonlinear_mpc_tpu.solvers.fast_sls import FastSLSPersist
from robust_nonlinear_mpc_tpu.solvers.sqp import SQPOptions, sqp_solve

torch.set_num_threads(1)
N, Bsz, TOL = 60, 2, 1e-7
# the JAX probe's SQP options
PROBE_SQP = SQPOptions(ipm=IPMOptions(max_iter=15, tol=3e-5), tol_step=1e-4, tol_feas=1e-4,
                       max_iter=25)


def _rocket(kkt="pallas"):
    m, solver = make_rocket_problem(N=N)
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


def _lanes(nx):
    rng = np.random.default_rng(0)
    return np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, nx))


def _err(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max()


@pytest.fixture(scope="module")
def seeded():
    """The problem in both packages and JAX's SQP seed of the lanes, with
    the probe's SQP options but up to 60 iterations (at N = 60 the default
    options' 1e-10 QPs fail in float64, and 25 iterations leave both lanes
    short of the probe's tolerance)."""
    m, solver, tsolver = _rocket()
    x0s = _lanes(m.nx)
    sopts = PROBE_SQP._replace(max_iter=60)
    nom = jax.jit(jax.vmap(
        lambda x: sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x, opts=sopts)
    ))(jnp.asarray(x0s))
    assert np.asarray(nom.success).all()
    return m, solver, tsolver, x0s, nom


def test_closed_loop_steps_match_windowed_jax_at_n60(seeded):
    m, solver, tsolver, x0s, nom = seeded
    assert _pick_window(N) == 30 < N and tsolver.opts.ipm.kkt == "fused"
    w = np.random.default_rng(1).uniform(-1.0, 1.0, (2, Bsz, m.nw))
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, jnp.float64,
                                  store_phi=False)
    persists = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (Bsz,) + a.shape),
                                      persist)
    carry = (nom.X, nom.U, persists, jnp.asarray(x0s))
    tcarry = interop.carry_from_numpy({
        "X": np.asarray(nom.X), "U": np.asarray(nom.U),
        "persist": interop.tree_to_numpy(persists), "x": x0s,
    }, device="cpu")
    step = jax.jit(jax.vmap(make_mpc_step(solver)))
    tstep = t_make_mpc_step(tsolver)
    names = {1: "u0", 2: "X", 3: "U", 4: "backoff_x", 5: "backoff_u"}
    for i in range(2):
        carry, out = step(carry, jnp.asarray(w[i]))
        tcarry, tout = tstep(tcarry, torch.as_tensor(w[i]))
        assert tout[6].tolist() == np.asarray(out[6]).tolist() == [True] * Bsz, f"step {i}"
        assert tout[7].tolist() == np.asarray(out[7]).tolist(), f"qp_iters, step {i}"
        for j, name in names.items():
            err = _err(tout[j].numpy(), out[j])
            assert err <= TOL, f"{name}, step {i}: {err:.3e}"


def test_qp_probe_matches_jax_at_n60(seeded):
    """The probe's rows at N = 60 on the seeded lanes: the port's tool
    (its lanes, options, deviation QPs and both Newton paths) against the
    JAX probe's steps (`tools/pallas_n60_qp_probe.py`)."""
    m, solver, _, x0s, nom = seeded
    tm, tsolver, tx0s = tprobe.seeded_lanes(N, Bsz, "cpu", torch.float64)
    assert _err(tx0s.numpy(), x0s) == 0.0
    assert tsolver.opts.sqp == interop._scp_options(
        interop.options_to_plain(solver.opts._replace(sqp=PROBE_SQP))).sqp
    tdata = tprobe.deviation_qps(tsolver, torch.as_tensor(np.array(nom.X)),
                                 torch.as_tensor(np.array(nom.U)), tx0s)
    # the same QPs on the JAX side (the assembly is held against JAX's by
    # the closed-loop steps)
    data = QPData(**{k: jnp.asarray(v.numpy()) for k, v in tdata._asdict().items()})
    tsols, row = tprobe.solve_both(tsolver, tdata, qp_iters=15)
    for kkt, tkkt in (("pallas", "fused"), ("riccati", "riccati")):
        opts = IPMOptions(max_iter=15, tol=3e-5, kkt=kkt)
        ref = jax.jit(jax.vmap(lambda d: solve_qp(solver.prob.stat, d, opts)))(data)
        got = tsols[tkkt]
        assert got.iters.tolist() == np.asarray(ref.iters).tolist() == row[tkkt]["iters"], kkt
        assert got.success.tolist() == np.asarray(ref.success).tolist() == [True] * Bsz, kkt
        assert _err(got.U.numpy(), ref.U) <= TOL, kkt
    assert row["lanes_iters_differ"] == row["lanes_success_differ"] == 0
    assert row["max_U_gap"] <= TOL


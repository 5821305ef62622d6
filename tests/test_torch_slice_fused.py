"""PyTorch port: the fused-kernel configuration of the closed-loop step
against the JAX package (float64, CPU).

`make_rocket_problem(N=6)`, B = 3 lanes, the bench's options with the whole
IPM iteration as one kernel (JAX kkt="pallas_iter", the port's "fused_iter")
and the Phi-materializing fused response (`use_pallas_response=True`,
`streaming_response=False`); the JAX side runs its Pallas kernels in
interpret mode (its fused response is called with `interpret=True`, as
tests/test_pallas_response.py calls it), the port its plain twins. The JAX
package reaches the fused response only through `FastSLSOptions`, so its
solver's options are extended the same way for this test.

3 closed-loop MPC steps from the same SQP seed: per step and lane, success
and QP iterations identical, u0, X and U within 1e-6, the backoffs and the
carried Phi maps within 1e-5 relative. The bounds are set by the response,
which both packages compute in float32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_nonlinear_mpc_torch.interop as interop
from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step as t_make_mpc_step
from robust_nonlinear_mpc_tpu.expe.main_rocket_robust_closed_loop import X0, make_rocket_problem
from robust_nonlinear_mpc_tpu.ops import pallas_response
from robust_nonlinear_mpc_tpu.ops.qp_ipm import IPMOptions
from robust_nonlinear_mpc_tpu.sim.closed_loop import make_mpc_step
from robust_nonlinear_mpc_tpu.solvers.fast_sls import FastSLSPersist
from robust_nonlinear_mpc_tpu.solvers.sqp import SQPOptions, sqp_solve

torch.set_num_threads(1)
N, Bsz = 6, 3


@pytest.fixture(scope="module")
def fused_setup():
    m, solver = make_rocket_problem(N=N)
    solver.opts = solver.opts._replace(
        verbose=False,
        ipm=IPMOptions(max_iter=15, tol=3e-5, kkt="pallas_iter"),
        adaptive_ipm_budget=(6, 15),
        ipm_first=IPMOptions(max_iter=8, tol=1e-3, kkt="pallas_iter"),
        streaming_response=False, recycle_eta=True, recycle_warm_qp=True, sls_block=0,
    )
    base = solver._fast_sls_opts
    solver._fast_sls_opts = lambda: base()._replace(use_pallas_response=True)
    d = dict(N=N, Q=solver.Q, R=solver.R, Qf=solver.Qf, Q_reg=solver.Q_reg,
             R_reg=solver.R_reg, Q_reg_f=solver.Q_reg_f, E=m.E, dt=m.dt,
             options=interop.options_to_plain(solver.opts))
    tsolver = interop.solver_from_numpy(d, device="cpu")
    tsolver.opts = tsolver.opts._replace(use_pallas_response=True)
    rng = np.random.default_rng(0)
    x0s = np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, m.nx))
    w = rng.uniform(-1.0, 1.0, (3, Bsz, m.nw))
    nom = jax.jit(jax.vmap(lambda x: sqp_solve(
        m, N, solver.Q, solver.R, solver.Qf, x, opts=SQPOptions(tol_step=1e-6, tol_feas=1e-6)
    )))(jnp.asarray(x0s))
    return m, solver, tsolver, x0s, w, nom


def test_fused_kernel_steps_match_jax(fused_setup, monkeypatch):
    m, solver, tsolver, x0s, w, nom = fused_setup
    monkeypatch.setattr(pallas_response, "fused_response",
                        functools.partial(pallas_response.fused_response, interpret=True))
    assert tsolver.opts.ipm.kkt == "fused_iter"
    fopts = tsolver._fast_sls_opts()
    assert fopts.use_pallas_response and not fopts.streaming_response
    persist = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, jnp.float64,
                                  store_phi=True)
    persists = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (Bsz,) + a.shape), persist)
    carry = (nom.X, nom.U, persists, jnp.asarray(x0s))
    tcarry = interop.carry_from_numpy({
        "X": np.asarray(nom.X), "U": np.asarray(nom.U),
        "persist": interop.tree_to_numpy(persists), "x": x0s,
    }, device="cpu")
    assert tcarry[2].Phi_x.shape == (Bsz, N + 1, N + 1, m.nx, m.nw)
    step = jax.jit(jax.vmap(make_mpc_step(solver)))
    tstep = t_make_mpc_step(tsolver)
    for i in range(3):
        carry, out = step(carry, jnp.asarray(w[i]))
        tcarry, tout = tstep(tcarry, torch.as_tensor(w[i]))
        assert tout[6].tolist() == np.asarray(out[6]).tolist() == [True] * Bsz, f"success, step {i}"
        assert tout[7].tolist() == np.asarray(out[7]).tolist(), f"qp_iters, step {i}"
        for j, name in ((1, "u0"), (2, "X"), (3, "U")):
            err = np.abs(tout[j].numpy() - np.asarray(out[j])).max()
            assert err <= 1e-6, f"{name}, step {i}: {err:.3e}"
        for j, name in ((4, "backoff_x"), (5, "backoff_u")):
            ref = np.asarray(out[j])
            err = np.abs(tout[j].numpy() - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, f"{name}, step {i}: {err:.3e}"

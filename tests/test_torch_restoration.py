"""PyTorch port: feasibility restoration (`solvers/restoration.py`) against
the JAX package (float64, CPU), at the rocket's widths (nx = 17, nu = 4,
ni = 42, ni_f = 34), N = 4, the cases of tests/test_restoration.py:

* a feasible tightening: slacks below 1e-5, the restored solution the hard
  QP's within 1e-4 (as the JAX test; 2e-3 at seed 3, where the IPM stops
  at its complementarity floor), and the port's X, U, slacks and iteration
  counts the JAX package's within 1e-8;
* an over-tightening with no feasible point: the hard QP fails, the
  restoration returns a finite iterate whose slacks cover the violated
  rows, within 1e-8 of JAX;
* the restoration branch of `SCPSLSSolver._iteration` solves only the
  rejected lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_qp
from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions as TIPMOptions
from robust_nonlinear_mpc_torch.ops.qp_ipm import QPData as TQPData
from robust_nonlinear_mpc_torch.ops.qp_ipm import QPStatics as TQPStatics
from robust_nonlinear_mpc_torch.ops.qp_ipm import solve_qp as t_solve_qp
from robust_nonlinear_mpc_torch.solvers.restoration import restoration_solve as t_restore
from robust_nonlinear_mpc_tpu.ops.qp_ipm import IPMOptions, solve_qp
from robust_nonlinear_mpc_tpu.solvers.restoration import restoration_solve

torch.set_num_threads(1)
WIDTHS = dict(N=4, nx=17, nu=4, ni=42, ni_f=34)
IPM = IPMOptions(max_iter=60, tol=1e-9)
TIPM = TIPMOptions(max_iter=60, tol=1e-9)
TOL = 1e-8


def _torch(stat, data):
    t = lambda a: torch.as_tensor(np.asarray(a))
    tstat = TQPStatics(*(t(a) for a in stat))
    tdata = TQPData(*(t(a)[None] for a in data))
    return tstat, tdata


def _both(stat, data, h):
    ref = jax.jit(lambda *a: restoration_solve(stat, *a, rho=1e6, ipm=IPM))(
        data.A, data.B, data.c, data.qx, data.qu, h, data.hf, data.xinit)
    tstat, tdata = _torch(stat, data)
    got = t_restore(tstat, tdata.A, tdata.B, tdata.c, tdata.qx, tdata.qu,
                    torch.as_tensor(np.asarray(h))[None], tdata.hf, tdata.xinit,
                    rho=1e6, ipm=TIPM)
    assert int(got.iters[0]) == int(ref.iters)
    assert bool(got.success[0]) == bool(ref.success)
    for f in ("X", "U", "gamma", "gamma_f", "max_slack"):
        err = np.abs(getattr(got, f)[0].numpy() - np.asarray(getattr(ref, f))).max()
        assert err <= TOL, f"{f}: {err:.3e}"
    return ref, got, tstat, tdata


# seed 3: the IPM (JAX's and the port's alike) stops the slacked solve at its
# complementarity floor with a KKT residual of 2.8e-5, so its X is the hard
# QP's to 1.8e-3
@pytest.mark.parametrize("seed,xtol", [(0, 1e-4), (3, 2e-3)])
def test_restoration_matches_jax_when_feasible(seed, xtol):
    stat, data = random_qp(seed=seed, **WIDTHS)
    ref, got, tstat, tdata = _both(stat, data, data.h)
    assert bool(got.success[0])
    assert float(got.max_slack[0]) < 1e-5
    hard = t_solve_qp(tstat, tdata, TIPM)
    assert bool(hard.success[0])
    assert float((got.X - hard.X).abs().max()) < xtol
    assert float((got.U - hard.U).abs().max()) < xtol


def test_restoration_matches_jax_when_infeasible():
    stat, data = random_qp(seed=1, **WIDTHS)
    hard0 = jax.jit(lambda d: solve_qp(stat, d, IPM))(data)
    assert bool(hard0.success)
    margin = np.asarray(data.h - (hard0.X[:-1] @ stat.Gx.T + hard0.U @ stat.Gu.T))
    h_bad = jnp.asarray(np.asarray(data.h) - (margin + 1.0))
    tstat, tdata = _torch(stat, data)
    hard = t_solve_qp(tstat, tdata._replace(h=torch.as_tensor(np.asarray(h_bad))[None]), TIPM)
    assert not bool(hard.success[0])
    ref, got, _, _ = _both(stat, data, h_bad)
    assert bool(got.success[0])
    X, U = got.X[0], got.U[0]
    Gx, Gu = tstat.Gx, tstat.Gu
    slacked = torch.as_tensor(np.asarray(h_bad)) - (X[:-1] @ Gx.T + U @ Gu.T) + got.gamma[0]
    assert float(slacked.min()) > -1e-5
    assert float(got.max_slack[0]) > 0.1


def test_iteration_restores_only_rejected_lanes():
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist

    m, solver = make_rocket_problem(N=4, device="cpu")
    solver.opts = solver.opts._replace(verbose=False, feasibility_restoration=True)
    rng = np.random.default_rng(0)
    Bsz = 3
    x0 = torch.as_tensor(np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, m.nx)))
    X = x0[:, None].repeat(1, 5, 1)
    U = torch.zeros((Bsz, 4, m.nu), dtype=torch.float64)
    X[1, 2, 3] = float("nan")       # lane 1's iterate cannot be finite
    persist = FastSLSPersist.init(4, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=Bsz,
                                  dtype=torch.float64, device="cpu")
    res = solver._iteration(X, U, x0, persist)
    rejected = ~(res.success & torch.isfinite(res.X).flatten(1).all(1))
    assert bool(rejected[1])
    assert torch.equal(res.rest_ok & ~rejected, torch.zeros_like(rejected))
    keep = ~rejected
    assert torch.equal(res.X_rest[keep], res.X[keep])

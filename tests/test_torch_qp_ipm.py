"""PyTorch port: the batched interior-point QP (ops/qp_ipm.py) against the
JAX `vmap(solve_qp)` (float64, CPU).

The port's Newton-solve paths, "riccati" (the torch Riccati loop), "fused"
and "fused_iter" (the CUDA kernels' plain twins on CPU tensors), must reproduce the
JAX iteration count of every lane exactly, and X / U / lam to 1e-8 (the
IPM stops at tol = 1e-9 relative, so solutions agree far below that). The
masked batch loop must give each lane what it gets when solved alone, also
with a warm start and a per-lane iteration cap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.ops import qp_ipm as tq
from robust_nonlinear_mpc_tpu.ops import qp_ipm as jq

torch.set_num_threads(1)
Bsz, N, nx, nu, ni, ni_f = 4, 6, 5, 2, 8, 6
TOL = 1e-8


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    stat = dict(
        Hx=2 * np.eye(nx), Hu=2 * np.eye(nu), HxN=10 * np.eye(nx),
        Gx=rng.standard_normal((ni, nx)), Gu=rng.standard_normal((ni, nu)),
        Gf=rng.standard_normal((ni_f, nx)),
    )
    data = dict(
        A=0.95 * np.eye(nx) + 0.1 * rng.standard_normal((Bsz, N, nx, nx)),
        B=0.3 * rng.standard_normal((Bsz, N, nx, nu)),
        c=0.05 * rng.standard_normal((Bsz, N, nx)),
        qx=rng.standard_normal((Bsz, N + 1, nx)),
        qu=rng.standard_normal((Bsz, N, nu)),
        h=1.0 + np.abs(rng.standard_normal((Bsz, N, ni))),
        hf=1.0 + np.abs(rng.standard_normal((Bsz, ni_f))),
        xinit=0.2 * rng.standard_normal((Bsz, nx)),
    )
    return stat, data


def _torch(stat, data):
    T = lambda a: torch.as_tensor(a)
    return (tq.QPStatics(**{k: T(v) for k, v in stat.items()}),
            tq.QPData(**{k: T(v) for k, v in data.items()}))


def _jax_solve(stat, data, opts, init=None, cap=None):
    js = jq.QPStatics(**{k: jnp.asarray(v) for k, v in stat.items()})
    jd = jq.QPData(**{k: jnp.asarray(v) for k, v in data.items()})
    if init is None and cap is None:
        return jax.jit(jax.vmap(lambda d: jq.solve_qp(js, d, opts)))(jd)
    return jax.jit(jax.vmap(lambda d, i, c: jq.solve_qp(js, d, opts, init=i, max_iter_dyn=c)))(
        jd, init, cap)


def _assert_same(got, ref):
    assert got.iters.tolist() == np.asarray(ref.iters).tolist()
    assert got.success.tolist() == np.asarray(ref.success).tolist()
    for f in ("X", "U", "lam", "lam_f", "nu_dyn"):
        assert np.abs(getattr(got, f).numpy() - np.asarray(getattr(ref, f))).max() <= TOL, f


@pytest.fixture(scope="module")
def cold_ref():
    """The JAX reference of the cold solves, once for every kkt case."""
    stat, data = _problem(0)
    return stat, data, _jax_solve(stat, data, jq.IPMOptions())


@pytest.mark.parametrize("kkt", ["riccati", "fused", "fused_iter"])
def test_solve_qp_matches_jax(kkt, cold_ref):
    stat, data, ref = cold_ref
    got = tq.solve_qp(*_torch(stat, data), tq.IPMOptions(kkt=kkt))
    _assert_same(got, ref)
    assert got.success.all()
    assert np.abs(got.cost.numpy() - np.asarray(ref.cost)).max() <= 1e-8 * np.abs(np.asarray(ref.cost)).max()
    assert np.abs(got.nu_init.numpy() - np.asarray(ref.nu_init)).max() <= TOL


def test_batched_equals_per_lane():
    stat, data = _problem(1)
    tstat, tdata = _torch(stat, data)
    full = tq.solve_qp(tstat, tdata, tq.IPMOptions(kkt="fused"))
    for b in range(Bsz):
        lane = tq.QPData(*[t[b : b + 1] for t in tdata])
        one = tq.solve_qp(tstat, lane, tq.IPMOptions(kkt="fused"))
        assert int(one.iters[0]) == int(full.iters[b])
        assert torch.allclose(one.X[0], full.X[b], rtol=0, atol=1e-12)
        assert torch.allclose(one.lam[0], full.lam[b], rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def warm_ref():
    """A solved problem, a perturbed copy of it, per-lane caps and the JAX
    reference of the warm-started, capped solve: once for every kkt case."""
    stat, data = _problem(2)
    opts = jq.IPMOptions(tol=1e-9)
    cold = _jax_solve(stat, data, opts)
    rng = np.random.default_rng(3)
    data2 = dict(data)
    data2["c"] = data["c"] + 0.01 * rng.standard_normal(data["c"].shape)
    data2["xinit"] = data["xinit"] + 0.01 * rng.standard_normal(data["xinit"].shape)
    cap = np.array([2, 30, 4, 30], dtype=np.int32)
    ref = _jax_solve(stat, data2, opts, init=cold, cap=jnp.asarray(cap))
    return stat, data2, cold, cap, ref


@pytest.mark.parametrize("kkt", ["riccati", "fused", "fused_iter"])
def test_warm_start_and_lane_caps_match_jax(kkt, warm_ref):
    """Warm-start initial point (with the Mehrotra shift) and a per-lane
    iteration cap, on a perturbed copy of a solved problem."""
    stat, data2, cold, cap, ref = warm_ref
    tstat, tdata2 = _torch(stat, data2)
    T = lambda a: torch.as_tensor(np.array(a))
    init = tq.QPSolution(
        X=T(cold.X), U=T(cold.U), lam=T(cold.lam), lam_f=T(cold.lam_f),
        nu_dyn=T(cold.nu_dyn), nu_init=None, s=None, s_f=None, cost=None,
        kkt_res=None, iters=None, success=None,
    )
    got = tq.solve_qp(tstat, tdata2, tq.IPMOptions(tol=1e-9, kkt=kkt), init=init,
                      max_iter_dyn=torch.as_tensor(cap))
    _assert_same(got, ref)
    assert got.iters.tolist()[0] == 2 and got.iters.tolist()[2] <= 4


def test_unported_newton_solvers_raise():
    stat, data = _problem(0)
    for kkt in ("condensed", "pallas_iter", "pallas"):
        with pytest.raises(NotImplementedError):
            tq.solve_qp(*_torch(stat, data), tq.IPMOptions(kkt=kkt))

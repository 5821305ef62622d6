"""PyTorch port: one whole Mehrotra iteration (`ops/fused_qp.ipm_iteration`,
the CUDA kernel K6 on the card, its plain twin on CPU tensors) against the
JAX Pallas `_ipm_iter_batched` run in interpret mode (float64, CPU).

* One iteration at B = 3, N = 6, nx = 5, ni = 8, ni_f = 6, nu in {1, 2, 4}:
  lane 0 takes a normal step, lane 1 is marked done (keeps its iterate),
  lane 2 has an infinite dynamics offset, so its new KKT scalar is not
  finite and the iteration reverts it. All 15 outputs must agree to 1e-10
  relative to each output's largest entry (the Schur inverse and the
  reductions in another summation order).
* The whole solve, `solve_qp(kkt="fused_iter")` against the JAX vmapped
  `solve_qp(kkt="pallas_iter")` on the inputs of
  tests/test_pallas_qp.py::test_solve_qp_kkt_pallas_iter_full_ipm:
  identical iteration counts and success, X / U within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.ops import fused_qp
from robust_nonlinear_mpc_torch.ops import qp_ipm as tq
from robust_nonlinear_mpc_tpu.ops import qp_ipm as jq
from robust_nonlinear_mpc_tpu.ops.pallas_qp import _ipm_iter_batched
from tests.test_pallas_qp import _mk

torch.set_num_threads(1)
Bsz, N, nx, ni, ni_f = 3, 6, 5, 8, 6
TOL = 1e-10
NAMES = ("X", "U", "lam", "s", "lam_f", "s_f", "nu_dyn", "req", "rineq", "rineq_f",
         "rx_pad", "rxN", "ru", "res", "bad")


def _iteration_inputs(nu, seed):
    """A problem, an interior iterate and its residuals, made with numpy."""
    rng = np.random.default_rng(seed)
    stat = dict(
        Gx=np.broadcast_to(rng.standard_normal((ni, nx)), (N, ni, nx)).copy(),
        Gu=np.broadcast_to(rng.standard_normal((ni, nu)), (N, ni, nu)).copy(),
        Gf=rng.standard_normal((ni_f, nx)),
        Hx=np.broadcast_to(2 * np.eye(nx), (N, nx, nx)).copy(),
        Hu=np.broadcast_to(2 * np.eye(nu), (N, nu, nu)).copy(),
        HxN=6 * np.eye(nx),
    )
    data = dict(
        A=0.9 * np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx)),
        B=0.2 * rng.standard_normal((Bsz, N, nx, nu)),
        c=0.01 * rng.standard_normal((Bsz, N, nx)),
        qx=0.1 * rng.standard_normal((Bsz, N + 1, nx)),
        qu=0.1 * rng.standard_normal((Bsz, N, nu)),
        h=4.0 + np.abs(rng.standard_normal((Bsz, N, ni))),
        hf=4.0 + np.abs(rng.standard_normal((Bsz, ni_f))),
    )
    it = dict(
        X=0.3 * rng.standard_normal((Bsz, N + 1, nx)),
        U=0.3 * rng.standard_normal((Bsz, N, nu)),
        lam=0.5 + np.abs(rng.standard_normal((Bsz, N, ni))),
        s=0.5 + np.abs(rng.standard_normal((Bsz, N, ni))),
        lam_f=0.5 + np.abs(rng.standard_normal((Bsz, ni_f))),
        s_f=0.5 + np.abs(rng.standard_normal((Bsz, ni_f))),
        nu_dyn=0.1 * rng.standard_normal((Bsz, N, nx)),
    )
    T = lambda a: torch.as_tensor(a)
    tstat = tq.QPStatics(**{k: T(v) for k, v in stat.items()})
    tdata = tq.QPData(**{k: T(v) for k, v in data.items()}, xinit=None)
    R = tq._residuals(tstat, tdata, *(T(it[k]) for k in ("X", "U", "lam", "s", "lam_f",
                                                          "s_f", "nu_dyn")))
    req, rineq, rineq_f, rx, rxN, ru = (r.numpy() for r in R)
    rx_pad = np.concatenate([np.zeros((Bsz, 1, nx)), rx], axis=1)
    scale_p = 1.0 + np.max(np.abs(np.concatenate(
        [data["c"].reshape(Bsz, -1), data["h"].reshape(Bsz, -1), data["hf"]], axis=1)), axis=1)
    data["c"][2, 0, 0] = np.inf   # lane 2: the new dynamics residual is not finite
    done = np.array([False, True, False])
    W, W_f = it["lam"] / it["s"], it["lam_f"] / it["s_f"]
    args = [data[k] for k in ("A", "B", "c", "qx", "qu", "h", "hf")]
    args += [stat[k] for k in ("Gx", "Gu", "Gf", "Hx", "Hu", "HxN")]
    args += [W, W_f] + [it[k] for k in ("X", "U", "lam", "s", "lam_f", "s_f", "nu_dyn")]
    args += [req, rineq, rineq_f, rx_pad, rxN, ru, scale_p, done]
    return args, N * ni + ni_f


@pytest.mark.parametrize("nu", [1, 2, 4])
def test_plain_ipm_iteration_matches_pallas_interpret(nu):
    args, n_comp = _iteration_inputs(nu, seed=50 + nu)
    ref = jax.jit(lambda *a: _ipm_iter_batched(*a, tau=0.995, n_comp=n_comp, interpret=True))(
        *[jnp.asarray(a) for a in args])
    fused_qp.reset_launch_counts()
    got = fused_qp.ipm_iteration(*[torch.as_tensor(a) for a in args], tau=0.995,
                                 n_comp=n_comp)
    assert fused_qp.launch_counts()["ipm_iteration"] == 0   # CPU: the plain twin
    assert len(got) == len(NAMES)
    for name, g, r in zip(NAMES, got, ref):
        g, r = g.numpy(), np.asarray(r)
        assert g.shape == r.shape, name
        if name == "bad":
            assert g.tolist() == r.tolist() == [False, False, True]
            continue
        assert np.isfinite(g).all(), name
        assert np.abs(g - r).max() <= TOL * max(np.abs(r).max(), 1e-300), name
    # the done lane kept its iterate; the reverted lane got its inputs back
    for i, name in enumerate(NAMES[:7]):
        assert np.array_equal(got[i][1].numpy(), args[15 + i][1]), name
        assert np.array_equal(got[i][2].numpy(), args[15 + i][2]), name
    assert not np.array_equal(got[0][0].numpy(), args[15][0])


def test_solve_qp_fused_iter_matches_pallas_iter():
    nu = 2
    jdatas = []   # the draws of tests/test_pallas_qp.py, in the same order
    for b in range(3):
        rng = np.random.default_rng(300 + b)
        _, data, _, _, _ = _mk(nu, 300 + b)
        jdatas.append(data._replace(
            qx=jnp.asarray(0.1 * rng.standard_normal((N + 1, nx))),
            qu=jnp.asarray(0.1 * rng.standard_normal((N, nu))),
            c=jnp.asarray(0.01 * rng.standard_normal((N, nx))),
            h=jnp.asarray(4.0 + np.abs(rng.standard_normal((N, ni)))),
            hf=jnp.asarray(4.0 + np.abs(rng.standard_normal(ni_f))),
            xinit=jnp.asarray(0.3 * rng.standard_normal(nx)),
        ))
    stat = _mk(nu, 300)[0]
    datab = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jdatas)
    o_i = jq.IPMOptions(max_iter=40, tol=1e-10, kkt="pallas_iter")
    ref = jax.jit(jax.vmap(lambda d: jq.solve_qp(stat, d, o_i)))(datab)

    T = lambda a: torch.as_tensor(np.array(a))
    got = tq.solve_qp(tq.QPStatics(*(T(a) for a in stat)), tq.QPData(*(T(a) for a in datab)),
                      tq.IPMOptions(max_iter=40, tol=1e-10, kkt="fused_iter"))
    assert got.iters.tolist() == np.asarray(ref.iters).tolist()
    assert got.success.tolist() == np.asarray(ref.success).tolist() == [True] * 3
    assert np.abs(got.X.numpy() - np.asarray(ref.X)).max() <= 1e-8
    assert np.abs(got.U.numpy() - np.asarray(ref.U)).max() <= 1e-8

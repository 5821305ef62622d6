"""PyTorch port at a long horizon: the Newton kernels' plain twins
(`_plain_factor_predictor`, `_plain_resolve`) against the JAX package's
windowed Pallas kernels (`_factor_bwd_win_kernel`, `_newton_fwd_win_kernel`,
`_resolve_bwd_win_kernel`, interpret mode) at N = 60, where the JAX package
splits the stage axis into windows of `_pick_window(60)` = 30 stages.

The CUDA kernels run any N in one stage loop and are held against these
twins at N = 60 on the card (chip_smoke.py phase 3), so this closes the
chain to the JAX windowed path. float64, 1e-10 relative to each output's
largest entry; every output, the cached factors included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.ops import fused_qp
from robust_nonlinear_mpc_torch.ops.qp_ipm import QPStatics, _curvature
from robust_nonlinear_mpc_tpu.ops.pallas_qp import (
    _factor_predictor_batched_win,
    _pick_window,
    _resolve_batched_win,
)

torch.set_num_threads(1)
Bsz, N, nx, ni, ni_f = 3, 60, 5, 8, 6
TOL = 1e-10


def _inputs(nu, seed):
    rng = np.random.default_rng(seed)
    A = 0.9 * np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx))
    B = 0.2 * rng.standard_normal((Bsz, N, nx, nu))
    stat = QPStatics(
        torch.as_tensor(2 * np.eye(nx)), torch.as_tensor(2 * np.eye(nu)),
        torch.as_tensor(6 * np.eye(nx)), torch.as_tensor(rng.standard_normal((ni, nx))),
        torch.as_tensor(rng.standard_normal((ni, nu))),
        torch.as_tensor(rng.standard_normal((ni_f, nx))),
    ).per_stage(N)
    W = torch.as_tensor(np.abs(rng.standard_normal((Bsz, N, ni))) + 0.1)
    Wf = torch.as_tensor(np.abs(rng.standard_normal((Bsz, ni_f))) + 0.1)
    C = [c.numpy() for c in _curvature(stat, W, Wf)]
    rbx = rng.standard_normal((Bsz, N, nx))
    rbx[:, 0] = 0.0
    rhs = [rbx, rng.standard_normal((Bsz, nx)), rng.standard_normal((Bsz, N, nu)),
           rng.standard_normal((Bsz, N, nx))]
    rhs2 = [rng.standard_normal(r.shape) for r in rhs]
    return [A, B] + C, rhs, rhs2


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max(), what


@pytest.mark.parametrize("nu", [2, 4])
def test_plain_twins_match_windowed_pallas_at_n60(nu):
    window = _pick_window(N)
    assert window == 30 < N
    mats, rhs, rhs2 = _inputs(nu, seed=60 + nu)
    J = lambda xs: [jnp.asarray(x) for x in xs]
    T = lambda xs: [torch.as_tensor(x) for x in xs]

    jout = jax.jit(lambda *a: _factor_predictor_batched_win(*a, window, interpret=True))(
        *J(mats), *J(rhs))
    tout = fused_qp._plain_factor_predictor(*T(mats), *T(rhs))
    names = ["dX", "dU", "dnu", "K", "FxuT", "Fuu_tri", "Fiv_tri", "Pseq"]
    for name, g, r in zip(names, list(tout[:3]) + list(tout[3]), list(jout[:3]) + list(jout[3])):
        _close(g, r, f"factor_predictor {name}")

    jrs = jax.jit(lambda *a: _resolve_batched_win(*a, window, interpret=True))(
        jnp.asarray(mats[0]), jnp.asarray(mats[1]), jout[3], *J(rhs2))
    trs = fused_qp._plain_resolve(torch.as_tensor(mats[0]), torch.as_tensor(mats[1]), tout[3],
                                  *T(rhs2))
    for name, g, r in zip(names[:3], trs, jrs):
        _close(g, r, f"resolve {name}")

"""PyTorch port: the inputs on which the GPU checks and times its kernels
(robust_nonlinear_mpc_torch/tools/kernel_times.py, used by chip_smoke.py),
and how the tool locates launches the profiler did not record (CPU,
float64).

The SLS backward (K3) and response (K4) inputs the tool times the kernels
on go through the plain twins and the JAX Pallas kernels (interpret mode)
at a small size: K3 in float64 to 1e-10, K4 in float32 to 1e-5 relative
(the tolerances of tests/test_torch_backward.py and
tests/test_torch_response.py).

The Newton inputs at the widths of the other models (the pendulum's nx = 4,
nu = 1 and the quadrotor's nx = 13, nu = 4, which the card's kernels run in
their own width buckets) go through the plain torch twins and the JAX
Pallas kernels in interpret mode and must agree to 1e-10 relative to each
output's largest entry. The whole-iteration inputs must freeze lane 1 and
revert exactly lane 2, which the card's comparison relies on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.ops import fused_backward, fused_qp, fused_response
from robust_nonlinear_mpc_torch.tools import kernel_times
from robust_nonlinear_mpc_tpu.ops import sls_kernels as js
from robust_nonlinear_mpc_tpu.ops.pallas_qp import _factor_predictor_batched, _resolve_batched
from robust_nonlinear_mpc_tpu.ops.pallas_response import fused_response as j_fused_response
from robust_nonlinear_mpc_tpu.ops.pallas_sls import _backward_K_batched

torch.set_num_threads(1)
TOL = 1e-10


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1e-300), what


@pytest.mark.parametrize("nx,nu", [(4, 1), (13, 4)], ids=["pendulum", "quadrotor"])
def test_newton_inputs_match_pallas_interpret_at_other_widths(nx, nu):
    mats, rhs, rhs2 = kernel_times.newton_inputs(3, 6, nx, nu, torch.float64, "cpu", seed=nx)
    J = lambda xs: [jnp.asarray(x.numpy()) for x in xs]
    jdX, jdU, jdnu, jfact = jax.jit(lambda *a: _factor_predictor_batched(*a, interpret=True))(
        *J(mats), *J(rhs))
    tdX, tdU, tdnu, tfact = fused_qp.factor_predictor(*mats, *rhs)
    names = ["dX", "dU", "dnu", "K", "FxuT", "Fuu_tri", "Fiv_tri", "Pseq"]
    for name, g, r in zip(names, [tdX, tdU, tdnu, *tfact], [jdX, jdU, jdnu, *jfact]):
        _close(g, r, f"factor_predictor {name}")
    rs_j = jax.jit(lambda *a: _resolve_batched(*a, interpret=True))(*J(mats[:2]), jfact, *J(rhs2))
    rs_t = fused_qp.resolve(mats[0], mats[1], tfact, *rhs2)
    for name, g, r in zip(names[:3], rs_t, rs_j):
        _close(g, r, f"resolve {name}")


@pytest.mark.parametrize("nx,nu", [(17, 4), (7, 3)])
def test_ipm_inputs_freeze_lane_1_and_revert_lane_2(nx, nu):
    args, kw = kernel_times.ipm_inputs(8, 6, torch.float64, "cpu", seed=3, nx=nx, nu=nu)
    out = fused_qp.ipm_iteration(*args, **kw)
    bad = out[-1]
    assert bad.tolist() == [False, False, True] + [False] * 5
    # X, U, lam, s, lam_f, s_f, nu_dyn follow the weights W, W_f in the args
    for got, old in zip(out[:7], args[15:22]):
        assert torch.equal(got[1], old[1]) and torch.equal(got[2], old[2])
        assert torch.isfinite(got).all()
        assert not torch.equal(got[0], old[0])


@pytest.mark.parametrize("starts,n,missing", [
    ([0.0, 10.0, 20.0, 30.0], 4, []),
    ([0.0, 10.0, 30.0, 40.0], 5, [2]),
    ([0.0, 30.0, 40.0, 60.0, 70.0], 8, [1, 2, 5]),
])
def test_missing_positions(starts, n, missing):
    assert kernel_times.missing_positions(starts, n) == missing


def test_backward_and_response_inputs_take_the_pallas_contract():
    bargs = kernel_times.backward_inputs(3, 4, 5, 2, torch.float64, "cpu", seed=5)
    A, B, G, Gf, eta, eta_f, regs = bargs
    assert G.shape == (14, 7) and Gf.shape == (10, 5) and eta.shape == (3, 4, 4, 14)
    J = lambda xs: [jnp.asarray(x.numpy()) for x in xs]
    ref = jax.jit(lambda *a: _backward_K_batched(*a, b_tile=4, interpret=True))(
        *J((A, B, G, Gf, eta, eta_f)), js.SLSRegs(*J(regs)))
    got = fused_backward.backward_K(*bargs)
    assert got.shape == (3, 4, 5, 2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-10)

    rargs = kernel_times.response_inputs(2, 3, "cpu", seed=6, nx=5, nu=2)
    assert all(a.dtype == torch.float32 for a in rargs)
    got = fused_response.fused_response(*rargs)
    A, B, E, K, *rest = (a.numpy() for a in rargs)
    j_response = jax.jit(lambda *a: j_fused_response(*a, interpret=True))
    for b in range(2):
        ref = j_response(A[b], B[b], E, K[b], *rest)
        for g, r in zip(got, ref):
            r = np.asarray(r).reshape(g[b].shape)
            assert np.abs(g[b].numpy() - r).max() <= 1e-5 * np.abs(r).max()

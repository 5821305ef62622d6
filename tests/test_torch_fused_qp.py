"""PyTorch port: the fused Newton solves (ops/fused_qp.py) against the JAX
Pallas kernels run in interpret mode (float64, CPU).

On CPU tensors `factor_predictor` / `resolve` run their plain torch twins,
which compute what the CUDA kernels compute. The inputs are those of
tests/test_pallas_qp.py (B=3, N=6, nx=5), made with numpy; every output,
the cached factors included, must agree to 1e-10 relative to its largest
entry (the kernel's closed-form blockwise-Schur inverse against the same
formulas in another summation order). A CPU call must not count as a
kernel launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.ops import fused_qp
from robust_nonlinear_mpc_torch.ops.qp_ipm import QPStatics as TStat
from robust_nonlinear_mpc_torch.ops.qp_ipm import _curvature as t_curvature
from robust_nonlinear_mpc_tpu.ops.pallas_qp import (
    _factor_predictor_batched,
    _resolve_batched,
    _tri,
)

torch.set_num_threads(1)
N, nx, ni, ni_f = 6, 5, 8, 6
TOL = 1e-10


def _inputs(Bsz, nu, seed):
    rng = np.random.default_rng(seed)
    A = 0.9 * np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx))
    B = 0.2 * rng.standard_normal((Bsz, N, nx, nu))
    stat = TStat(
        torch.as_tensor(2 * np.eye(nx)), torch.as_tensor(2 * np.eye(nu)),
        torch.as_tensor(6 * np.eye(nx)),
        torch.as_tensor(rng.standard_normal((ni, nx))),
        torch.as_tensor(rng.standard_normal((ni, nu))),
        torch.as_tensor(rng.standard_normal((ni_f, nx))),
    ).per_stage(N)
    W = np.abs(rng.standard_normal((Bsz, N, ni))) + 0.1
    Wf = np.abs(rng.standard_normal((Bsz, ni_f))) + 0.1
    C = [c.numpy() for c in t_curvature(stat, torch.as_tensor(W), torch.as_tensor(Wf))]
    rbx = rng.standard_normal((Bsz, N, nx))
    rbx[:, 0] = 0.0
    rhs = [rbx, rng.standard_normal((Bsz, nx)), rng.standard_normal((Bsz, N, nu)),
           rng.standard_normal((Bsz, N, nx))]
    rhs2 = [rng.standard_normal(r.shape) for r in rhs]
    return [A, B] + C, rhs, rhs2


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1e-300), what


@pytest.mark.parametrize("Bsz,nu", [(3, 1), (3, 2), (3, 4), (37, 2)])
def test_fused_newton_matches_pallas_interpret(Bsz, nu):
    mats, rhs, rhs2 = _inputs(Bsz, nu, seed=20 + nu + Bsz)
    T = lambda xs: [torch.as_tensor(x) for x in xs]
    J = lambda xs: [jnp.asarray(x) for x in xs]
    fused_qp.reset_launch_counts()

    jdX, jdU, jdnu, jfact = _factor_predictor_batched(*J(mats), *J(rhs), interpret=True)
    tdX, tdU, tdnu, tfact = fused_qp.factor_predictor(*T(mats), *T(rhs))
    names = ["K", "FxuT", "Fuu_tri", "Fiv_tri", "Pseq"]
    for name, g, r in zip(["dX", "dU", "dnu"] + names,
                          [tdX, tdU, tdnu, *tfact], [jdX, jdU, jdnu, *jfact]):
        _close(g, r, f"factor_predictor {name}")

    rs_j = _resolve_batched(jnp.asarray(mats[0]), jnp.asarray(mats[1]), jfact,
                            *J(rhs2), interpret=True)
    rs_t = fused_qp.resolve(torch.as_tensor(mats[0]), torch.as_tensor(mats[1]), tfact,
                            *T(rhs2))
    for name, g, r in zip(["dX", "dU", "dnu"], rs_t, rs_j):
        _close(g, r, f"resolve {name}")

    # CPU tensors take the plain path: no kernel launch is counted
    assert fused_qp.launch_counts() == {"factor_predictor": 0, "resolve": 0}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_schur_inverse_is_the_inverse(n):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((4, n, n))
    H = torch.as_tensor(M @ np.swapaxes(M, 1, 2) + n * np.eye(n))
    inv = fused_qp._spd_inv_schur(H)
    eye = torch.eye(n, dtype=H.dtype)
    assert float((H @ inv - eye).abs().max()) <= 1e-12
    assert torch.equal(inv, inv.transpose(-1, -2))
    packed = fused_qp._pack_tri(H, n)
    assert packed.shape[-1] == len(_tri(n))
    assert torch.equal(fused_qp._unpack_tri(packed, n), fused_qp._upper_sym(H))


def test_kernel_limits_are_checked():
    A = torch.zeros((2, 3, 33, 33))
    with pytest.raises(ValueError, match="nx <= 32"):
        fused_qp._dims(A, torch.zeros((2, 3, 33, 4)))
    with pytest.raises(ValueError, match="nu <= 4"):
        fused_qp._dims(torch.zeros((2, 3, 5, 5)), torch.zeros((2, 3, 5, 5)))
    assert fused_qp._dims(torch.zeros((2, 3, 17, 17)), torch.zeros((2, 3, 17, 4))) == (2, 3, 17, 4)
    with pytest.raises(TypeError):
        fused_qp._suffix(torch.float16)

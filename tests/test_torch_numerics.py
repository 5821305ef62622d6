"""PyTorch port: small SPD solves against the JAX package (float64, CPU).

The same numpy-seeded SPD blocks go through `utils/numerics.spd_solve_small`
/ `spd_solve_refined` of both packages; tolerance 1e-12 relative to the
largest entry of the JAX solution (same closed-form Schur formulas for
n <= 4, Cholesky above; only the summation order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.utils import numerics as tnum
from robust_nonlinear_mpc_tpu.utils import numerics as jnum

torch.set_num_threads(1)


def _spd_blocks(n, seed, batch=5, rhs=3):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((batch, n, n))
    H = M @ np.swapaxes(M, 1, 2) + n * np.eye(n)
    F = rng.standard_normal((batch, n, rhs))
    return H, F


@pytest.mark.parametrize("name", ["spd_solve_small", "spd_solve_refined"])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6])
def test_spd_solves_match_jax(name, n):
    H, F = _spd_blocks(n, seed=100 + n)
    ref = np.asarray(getattr(jnum, name)(jnp.asarray(H), jnp.asarray(F)))
    got = getattr(tnum, name)(torch.as_tensor(H), torch.as_tensor(F)).numpy()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    # and it is a solve: H X = F
    assert np.abs(H @ got - F).max() <= 1e-10 * np.abs(F).max()


def test_mm_mv_sym_match_jax():
    rng = np.random.default_rng(7)
    a = rng.standard_normal((4, 3, 5))
    b = rng.standard_normal((4, 5, 2))
    v = rng.standard_normal((4, 5))
    s = rng.standard_normal((4, 3, 3))
    T = lambda x: torch.as_tensor(x)
    assert np.allclose(tnum.mm(T(a), T(b)).numpy(), np.asarray(jnum.mm(jnp.asarray(a), jnp.asarray(b))),
                       rtol=0, atol=1e-13)
    assert np.allclose(tnum.mv(T(a), T(v)).numpy(), np.asarray(jnum.mv(jnp.asarray(a), jnp.asarray(v))),
                       rtol=0, atol=1e-13)
    assert np.array_equal(tnum.sym(T(s)).numpy(), np.asarray(jnum.sym(jnp.asarray(s))))

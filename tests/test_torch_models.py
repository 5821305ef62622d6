"""PyTorch port: the rocket model against the JAX package (float64, CPU).

Random states and inputs near the experiment's X0, made with numpy, go
through `ode`, `ddyn` (RK4 and Euler) and `linearize_traj` of both packages.
Tolerance 1e-11 absolute: the arithmetic is the same, only the summation
order of the rotation and the forward-mode tangents may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.models.base import box_polytope as t_box
from robust_nonlinear_mpc_torch.models.rocket import HOVER_THRUST as T_HOVER
from robust_nonlinear_mpc_torch.models.rocket import Rocket as TRocket
from robust_nonlinear_mpc_tpu.expe.main_rocket_robust_closed_loop import X0
from robust_nonlinear_mpc_tpu.models.base import box_polytope as j_box
from robust_nonlinear_mpc_tpu.models.rocket import HOVER_THRUST as J_HOVER
from robust_nonlinear_mpc_tpu.models.rocket import Rocket as JRocket

torch.set_num_threads(1)
TOL = 1e-11


def _states(n, seed):
    rng = np.random.default_rng(seed)
    X = np.array(X0)[None] + 0.1 * rng.standard_normal((n, 17))
    U = 0.5 * rng.standard_normal((n, 4))
    return X, U


def test_constants_and_constraints_match():
    jr, tr = JRocket(), TRocket(device="cpu")
    assert T_HOVER == J_HOVER
    for name in ("G", "g", "Gf", "gf", "E"):
        assert np.array_equal(getattr(tr, name).numpy(), np.asarray(getattr(jr, name))), name
    assert (tr.nx, tr.nu, tr.nw, tr.ni, tr.ni_f, tr.dt) == (jr.nx, jr.nu, jr.nw, jr.ni, jr.ni_f, jr.dt)
    args = ([1.0, 2.0], [-1.0, -3.0], [0.5], [-0.5])
    for a, b in zip(t_box(*args), j_box(*args)):
        assert np.array_equal(a, b)


def test_buffers_follow_to():
    tr = TRocket(device="cpu").to(torch.float32)
    assert tr.G.dtype == torch.float32 and tr.E.dtype == torch.float32


def test_ode_matches_jax():
    X, U = _states(16, 1)
    jr, tr = JRocket(), TRocket(device="cpu")
    ref = np.asarray(jax.jit(jax.vmap(jr.ode))(jnp.asarray(X), jnp.asarray(U)))
    got = tr.ode(torch.as_tensor(X), torch.as_tensor(U)).numpy()
    assert np.abs(got - ref).max() <= TOL


@pytest.mark.parametrize("method", ["rk4", "euler"])
def test_ddyn_matches_jax(method):
    X, U = _states(16, 2)
    jr, tr = JRocket(), TRocket(device="cpu")
    jr.discretization_method = tr.discretization_method = method
    ref = np.asarray(jax.jit(jax.vmap(jr.ddyn))(jnp.asarray(X), jnp.asarray(U)))
    got = tr.ddyn(torch.as_tensor(X), torch.as_tensor(U)).numpy()
    assert np.abs(got - ref).max() <= TOL


def test_linearize_traj_matches_jax():
    N, Bsz = 5, 3
    jr, tr = JRocket(), TRocket(device="cpu")
    Xs, Us = [], []
    for b in range(Bsz):
        X, U = _states(N + 1, 10 + b)
        Xs.append(X)
        Us.append(U[:N])
    Xs, Us = np.stack(Xs), np.stack(Us)
    A, B, c = tr.linearize_traj(torch.as_tensor(Xs), torch.as_tensor(Us))
    # one compiled JAX reference for every lane (the eager one dispatches
    # its thousands of ops one by one)
    j_linearize = jax.jit(jr.linearize_traj)
    for b in range(Bsz):
        Aj, Bj, cj = j_linearize(jnp.asarray(Xs[b]), jnp.asarray(Us[b]))
        assert np.abs(A[b].numpy() - np.asarray(Aj)).max() <= TOL
        assert np.abs(B[b].numpy() - np.asarray(Bj)).max() <= TOL
        assert np.abs(c[b].numpy() - np.asarray(cj)).max() <= TOL

"""PyTorch port: the pendulum and the quadrotor against the JAX package
(float64, CPU) at seeded states and inputs: `ode`, `ddyn`, `linearize_traj`
and `linearize` within 1e-12, the constraint data and E exactly; also the
rocket's `linearize`, `remove_constraints`, the pendulum's
`replace_constraints`, and `interop.solver_from_numpy` for every model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import robust_nonlinear_mpc_torch.interop as interop
from robust_nonlinear_mpc_tpu.models import Pendulum, Quadrotor, Rocket

TOL = 1e-12
MODELS = {"pendulum": Pendulum, "quadrotor": Quadrotor, "rocket": Rocket}


def _states(name, m, rng, n):
    X = 0.3 * rng.standard_normal((n, m.nx))
    if name != "pendulum":
        q = rng.standard_normal((n, 4))
        X[:, 6:10] = q / np.linalg.norm(q, axis=1, keepdims=True)
    U = 0.5 * rng.standard_normal((n, m.nu))
    if name == "quadrotor":
        U += m.mass * m.grav / 4
    return X, U


@pytest.mark.parametrize("name", ["pendulum", "quadrotor"])
def test_model_matches_jax(name):
    m = MODELS[name]()
    tm = interop.model_from_name(name, device="cpu")
    for k in ("G", "g", "Gf", "gf", "E"):
        assert np.array_equal(getattr(tm, k).numpy(), np.asarray(getattr(m, k))), k
    assert (tm.nx, tm.nu, tm.nw, tm.ni, tm.ni_f, tm.dt) == (m.nx, m.nu, m.nw, m.ni, m.ni_f, m.dt)
    rng = np.random.default_rng(11)
    X, U = _states(name, m, rng, 6)
    tX, tU = torch.as_tensor(X), torch.as_tensor(U)
    close = lambda a, b, what: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                                          atol=TOL, err_msg=what)
    close(tm.ode(tX, tU), jax.jit(jax.vmap(m.ode))(X, U), "ode")
    close(tm.ddyn(tX, tU), jax.jit(jax.vmap(m.ddyn))(X, U), "ddyn")
    A, B = tm.linearize(tX[0], tU[0])
    jA, jB = jax.jit(m.linearize)(jnp.asarray(X[0]), jnp.asarray(U[0]))
    close(A, jA, "linearize A")
    close(B, jB, "linearize B")
    # a batch of 2 trajectories with N = 2
    Xt, Ut = X.reshape(2, 3, m.nx), U.reshape(2, 3, m.nu)[:, :2]
    got = tm.linearize_traj(torch.as_tensor(Xt), torch.as_tensor(Ut))
    refs = jax.jit(jax.vmap(m.linearize_traj))(jnp.asarray(Xt), jnp.asarray(Ut))
    for b in range(2):
        ref = [r[b] for r in refs]
        for what, g, r in zip("ABc", got, ref):
            close(g[b], r, f"linearize_traj {what}, lane {b}")


def test_rocket_linearize_and_remove_constraints():
    m = Rocket()
    tm = interop.model_from_name("rocket", device="cpu")
    rng = np.random.default_rng(5)
    X, U = _states("rocket", m, rng, 1)
    A, B = tm.linearize(torch.as_tensor(X[0]), torch.as_tensor(U[0]))
    jA, jB = jax.jit(m.linearize)(jnp.asarray(X[0]), jnp.asarray(U[0]))
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=0, atol=TOL)
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=0, atol=TOL)
    tm.remove_constraints()
    m.remove_constraints()
    for k in ("G", "g", "Gf", "gf"):
        assert tuple(getattr(tm, k).shape) == np.asarray(getattr(m, k)).shape, k
    assert (tm.ni, tm.ni_f) == (0, 0)


def test_replace_constraints_and_interop_for_every_model():
    m = Pendulum()
    tm = interop.model_from_name("pendulum", device="cpu")
    args = ([9.0, 2.0, 1.0, 3.0], [-8.0, -2.0, -1.0, -3.0], [4.0], [-3.0],
            [7.0, 1.0, 0.5, 2.0], [-7.0, -1.0, -0.5, -2.0])
    m.replace_constraints(*args)
    tm.replace_constraints(*args)
    for k in ("G", "g", "Gf", "gf"):
        assert np.array_equal(getattr(tm, k).numpy(), np.asarray(getattr(m, k))), k
    for name in ("rocket", "pendulum", "quadrotor"):
        mm = MODELS[name]()
        nx, nu = mm.nx, mm.nu
        d = dict(model=name, N=4, Q=np.eye(nx), R=np.eye(nu), Qf=np.eye(nx),
                 Q_reg=np.eye(nx), R_reg=np.eye(nu), Q_reg_f=np.eye(nx),
                 E=0.01 * np.eye(nx), dt=0.05, options={"rti": 1, "ipm": {}, "sqp": {"ipm": {}}})
        if name == "pendulum":
            d.update(g=m.g, gf=m.gf)
        solver = interop.solver_from_numpy(d, device="cpu")
        assert type(solver.m).__name__ == MODELS[name].__name__
        assert solver.E.shape == (5, nx, nx) and float(solver.E[0, 0, 0]) == 0.01
        if name == "pendulum":
            assert np.array_equal(solver.g.numpy(), np.asarray(m.g))
    with pytest.raises(ValueError, match="model must be one of"):
        interop.model_from_name("linear", device="cpu")

"""PyTorch port: the fast-SLS tube stages (ops/sls_kernels.py) against the
JAX package (float64, CPU), at the rocket's widths (nx = nw = 17, nu = 4,
ni = 42, ni_f = 34) and N = 4. Tolerance 1e-10 relative to each output's
largest entry (same GEMM formulation, other summation order).
"""

import jax.numpy as jnp
import numpy as np
import torch

from robust_nonlinear_mpc_torch.ops import sls_kernels as ts
from robust_nonlinear_mpc_torch.models.rocket import Rocket
from robust_nonlinear_mpc_tpu.ops import sls_kernels as js

torch.set_num_threads(1)
Bsz, N = 2, 4
TOL = 1e-10


def _setup(seed):
    m = Rocket(device="cpu")
    nx, nu, ni, ni_f = m.nx, m.nu, m.ni, m.ni_f
    rng = np.random.default_rng(seed)
    A = np.eye(nx) + 0.05 * rng.standard_normal((Bsz, N, nx, nx))
    B = 0.05 * rng.standard_normal((Bsz, N, nx, nu))
    eta = np.abs(rng.standard_normal((Bsz, N, N, ni)))
    eta *= np.tril(np.ones((N, N)))[None, :, :, None]
    eta_f = np.abs(rng.standard_normal((Bsz, N + 1, ni_f)))
    regs = (1e2 * np.eye(nx), 1e2 * np.eye(nu), 1e2 * np.eye(nx))
    E = np.broadcast_to(m.E.numpy()[None], (N + 1, nx, m.nw)).copy()
    return m, A, B, eta, eta_f, regs, E


def _close(got, ref, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max() <= TOL * max(np.abs(ref).max(), 1e-300), what


def test_evaluate_dual_eta_matches_jax():
    rng = np.random.default_rng(0)
    ni, ni_f = 42, 34
    mu = np.abs(rng.standard_normal((Bsz, N, ni)))
    mu_f = np.abs(rng.standard_normal((Bsz, ni_f)))
    beta = np.abs(rng.standard_normal((Bsz, N, N, ni))) * 1e-3
    beta[0, 0, 0, :3] = 0.0  # the epsilon floor
    beta_f = np.abs(rng.standard_normal((Bsz, N + 1, ni_f)))
    eta, eta_f = ts.evaluate_dual_eta(*(torch.as_tensor(a) for a in (mu, mu_f, beta, beta_f)), 1e-10)
    for b in range(Bsz):
        rj = js.evaluate_dual_eta(jnp.asarray(mu[b]), jnp.asarray(mu_f[b]), jnp.asarray(beta[b]),
                                  jnp.asarray(beta_f[b]), 1e-10)
        _close(eta[b], rj[0], "eta")
        _close(eta_f[b], rj[1], "eta_f")


def test_backward_solve_folded_matches_jax():
    m, A, B, eta, eta_f, regs, _ = _setup(1)
    T = lambda a: torch.as_tensor(a)
    _, K = ts.backward_solve_folded(T(A), T(B), m.G, m.Gf, T(eta), T(eta_f),
                                    ts.SLSRegs(*(T(r) for r in regs)))
    assert K.shape == (Bsz, N, N + 1, m.nu, m.nx)
    jregs = js.SLSRegs(*(jnp.asarray(r) for r in regs))
    for b in range(Bsz):
        _, Kj = js.backward_solve_folded(jnp.asarray(A[b]), jnp.asarray(B[b]), jnp.asarray(m.G.numpy()),
                                         jnp.asarray(m.Gf.numpy()), jnp.asarray(eta[b]),
                                         jnp.asarray(eta_f[b]), jregs)
        _close(K[b], Kj, "K")


def test_response_streaming_folded_matches_jax():
    m, A, B, eta, eta_f, regs, E = _setup(2)
    T = lambda a: torch.as_tensor(a)
    tregs = ts.SLSRegs(*(T(r) for r in regs))
    _, K = ts.backward_solve_folded(T(A), T(B), m.G, m.Gf, T(eta), T(eta_f), tregs)
    Gx, Gu = m.G[:, : m.nx], m.G[:, m.nx :]
    got = ts.response_streaming_folded(T(A), T(B), T(E), K, Gx, Gu, m.Gf, tregs, 1e-10)
    jregs = js.SLSRegs(*(jnp.asarray(r) for r in regs))
    names = ("beta", "beta_f", "backoff", "backoff_f", "cost_tube")
    for b in range(Bsz):
        ref = js.response_streaming_folded(
            jnp.asarray(A[b]), jnp.asarray(B[b]), jnp.asarray(E), jnp.asarray(K[b].numpy()),
            jnp.asarray(Gx.numpy()), jnp.asarray(Gu.numpy()), jnp.asarray(m.Gf.numpy()), jregs, 1e-10,
        )
        for name, g, r in zip(names, got, ref):
            _close(g[b], r, name)

"""PyTorch port: the SLS backward Riccati kernel's plain twin and the
column-blocked SLS kernels against the JAX package (float64, CPU).

* `fused_backward._plain_backward_K` against the Pallas `_backward_K_batched`
  in interpret mode (b_tile = 4: batch padding and several tiles) at the
  shapes of tests/test_pallas_sls.py, atol 1e-10.
* `backward_solve_blocked` / `response_streaming_blocked` against the JAX
  twins (jitted standalone) and against the port's folded forms (their
  single-segment case) for block in {1, 2, 3} at N = 5 (3 leaves a ragged
  last segment), atol 1e-12: the segments skip only exact-zero columns.
* `select_sls_kernels` for block 0, 2 and -1, and the wrapper's dispatch: a
  CPU tensor takes the plain twin and launches nothing.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.ops import fused_backward as tb
from robust_nonlinear_mpc_torch.ops import sls_kernels as ts
from robust_nonlinear_mpc_torch.solvers.fast_sls import select_sls_kernels
from robust_nonlinear_mpc_tpu.ops import sls_kernels as js
from robust_nonlinear_mpc_tpu.ops.pallas_sls import _backward_K_batched

torch.set_num_threads(1)


def _problem(Bc, N, nx, nu, ni, ni_f, seed=0, nw=3):
    """tests/test_pallas_sls.py's inputs, plus E for the response."""
    rng = np.random.default_rng(seed)
    A = 0.9 * np.eye(nx) + 0.05 * rng.standard_normal((Bc, N, nx, nx))
    B = 0.2 * rng.standard_normal((Bc, N, nx, nu))
    G = rng.standard_normal((ni, nx + nu))
    Gf = rng.standard_normal((ni_f, nx))
    eta = np.abs(rng.standard_normal((Bc, N, N, ni)))
    for k in range(N):
        eta[:, k, k + 1:] = 0.0
    eta_f = np.abs(rng.standard_normal((Bc, N + 1, ni_f)))
    regs = (np.eye(nx) * 2.0, np.eye(nu) * 1.5, np.eye(nx) * 3.0)
    E = 0.1 * rng.standard_normal((N + 1, nx, nw))
    return A, B, G, Gf, eta, eta_f, regs, E


def _torch(args):
    A, B, G, Gf, eta, eta_f, regs, E = args
    T = torch.as_tensor
    return T(A), T(B), T(G), T(Gf), T(eta), T(eta_f), ts.SLSRegs(*map(T, regs)), T(E)


def _close(got, ref, atol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max()
    assert err <= atol, f"{what}: {err:.3e}"


@pytest.mark.parametrize("Bc,N,nx,nu,ni,ni_f", [(3, 5, 4, 2, 6, 4), (2, 4, 5, 1, 7, 5),
                                                (5, 7, 6, 4, 9, 6),
                                                # the pendulum's and the quadrotor's widths
                                                (2, 4, 4, 1, 10, 8), (2, 3, 13, 4, 34, 26)])
def test_plain_backward_K_matches_pallas(Bc, N, nx, nu, ni, ni_f):
    args = _problem(Bc, N, nx, nu, ni, ni_f)
    A, B, G, Gf, eta, eta_f, regs, _ = args
    ref = jax.jit(lambda *a: _backward_K_batched(*a, b_tile=4, interpret=True))(
        *map(jnp.asarray, (A, B, G, Gf, eta, eta_f)), js.SLSRegs(*map(jnp.asarray, regs)))
    tA, tB, tG, tGf, teta, teta_f, tregs, _ = _torch(args)
    got = tb._plain_backward_K(tA, tB, tG, tGf, teta, teta_f, tregs)
    assert got.shape == (Bc, N, N + 1, nu, nx)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-10)


@pytest.mark.parametrize("block", [1, 2, 3])
def test_blocked_kernels_match_jax_and_folded(block):
    args = _problem(2, 5, 4, 2, 6, 4, seed=block)
    A, B, G, Gf, eta, eta_f, regs, E = args
    nx = A.shape[2]
    tA, tB, tG, tGf, teta, teta_f, tregs, tE = _torch(args)
    S, K = ts.backward_solve_blocked(tA, tB, tG, tGf, teta, teta_f, tregs, block=block)
    S0, K0 = ts.backward_solve_folded(tA, tB, tG, tGf, teta, teta_f, tregs)
    rargs = (tA, tB, tE, K0, tG[:, :nx], tG[:, nx:], tGf, tregs, 1e-10)
    resp = ts.response_streaming_blocked(*rargs, block=block)
    resp0 = ts.response_streaming_folded(*rargs)
    names = ("S", "K", "beta", "beta_f", "backoff", "backoff_f", "cost_tube")
    for name, g, r in zip(names, (S, K) + resp, (S0, K0) + resp0):
        _close(g, r, 1e-12, f"{name} vs folded")

    jregs = js.SLSRegs(*map(jnp.asarray, regs))
    jbwd = jax.jit(functools.partial(js.backward_solve_blocked, block=block))
    jresp = jax.jit(functools.partial(js.response_streaming_blocked, block=block))
    for b in range(A.shape[0]):
        ref = jbwd(A[b], B[b], G, Gf, eta[b], eta_f[b], jregs)
        ref += jresp(A[b], B[b], E, K0[b].numpy(), G[:, :nx], G[:, nx:], Gf, jregs, 1e-10)
        for name, g, r in zip(names, (S, K) + resp, ref):
            _close(g[b], r, 1e-12, f"{name} vs JAX, lane {b}")


def test_select_sls_kernels():
    args = _problem(2, 4, 4, 2, 6, 4)
    tA, tB, tG, tGf, teta, teta_f, tregs, tE = _torch(args)
    bargs = (tA, tB, tG, tGf, teta, teta_f, tregs)
    assert select_sls_kernels(0) == (ts.backward_solve_folded, ts.response_streaming_folded)
    bwd, resp = select_sls_kernels(2)
    assert (bwd.func, bwd.keywords) == (ts.backward_solve_blocked, {"block": 2})
    assert (resp.func, resp.keywords) == (ts.response_streaming_blocked, {"block": 2})
    bwd, resp = select_sls_kernels(-1)
    S, K = bwd(*bargs)
    assert S is None
    assert torch.equal(K, tb._plain_backward_K(*bargs))
    assert (resp.func, resp.keywords) == (ts.response_streaming_blocked, {"block": 2})
    # below -1 the JAX package falls through to the folded kernels
    assert select_sls_kernels(-2) == (ts.backward_solve_folded, ts.response_streaming_folded)


def test_backward_K_on_cpu_runs_the_plain_twin():
    args = _problem(3, 5, 4, 2, 6, 4, seed=4)
    bargs = _torch(args)[:7]
    tb.reset_launch_counts()
    K = tb.backward_K(*bargs)
    assert tb.launch_counts() == {"backward_K": 0}
    assert torch.equal(K, ts.backward_solve_folded(*bargs)[1])
    from robust_nonlinear_mpc_torch import bench

    assert bench.launch_counts()["backward_K"] == 0


def test_backward_K_refuses_what_the_kernel_cannot_hold():
    # eight warps (one per column pair at N = 15) fit at the rocket's widths
    # in both types, and one warp at the widest general path; a layout that
    # does not fit a single warp is refused
    assert tb.smem_bytes(17, 4, 42, 34, 4, warps=8) == 51136
    assert tb.smem_bytes(17, 4, 42, 34, 8, warps=8) == 102272
    assert tb.smem_bytes(32, 4, 72, 64, 8) <= tb.MAX_SMEM_BYTES
    assert tb.smem_bytes(17, 4, 2500, 34, 4) > tb.MAX_SMEM_BYTES
    A = torch.zeros((1, 5, 17, 17), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tb.backward_K(A, *([None] * 6))

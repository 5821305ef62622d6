"""PyTorch port: the Phi-materializing response stages and the fused
response (`ops/fused_response.fused_response`, the CUDA kernel K4 on the
card, its plain twin on CPU tensors) against the JAX package (CPU).

* `propagate`, `backoff_from_phi` and `tube_cost` against the JAX functions
  lane by lane, float64, to 1e-12 relative to each output's largest entry.
* The fused response against the JAX Pallas `fused_response` in interpret
  mode on the inputs of tests/test_pallas_response.py; both compute in
  float32, so 1e-5 relative.
* `fast_sls.compute_response`: the streaming, materialized and fused paths
  give the same backoffs and tube cost.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.ops import fused_response as tfr
from robust_nonlinear_mpc_torch.ops import sls_kernels as ts
from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSOptions, SLSProblem, compute_response
from robust_nonlinear_mpc_tpu.ops import sls_kernels as js
from robust_nonlinear_mpc_tpu.ops.pallas_response import fused_response as j_fused_response
from tests import oracles

torch.set_num_threads(1)
NAMES = ("Phi_x", "Phi_u", "beta", "beta_f", "backoff", "backoff_f", "tube")


def _inputs(seed, Bsz=1):
    """The problem of tests/test_pallas_response.py (K from the numpy oracle's
    backward Riccati), with Bsz lanes of dynamics sharing E."""
    rng = np.random.default_rng(seed)
    N, nx, nu, nw, ni, nif = 6, 5, 2, 5, 8, 6
    A = rng.standard_normal((N, nx, nx)) * 0.3
    B = rng.standard_normal((N, nx, nu))
    E = 0.2 * rng.standard_normal((N + 1, nx, nw))
    G = rng.standard_normal((ni, nx + nu))
    Gf = rng.standard_normal((nif, nx))
    mu = np.abs(rng.standard_normal((N, ni)))
    muf = np.abs(rng.standard_normal(nif))
    beta = np.abs(rng.standard_normal((N, N, ni)))
    betaf = np.abs(rng.standard_normal((N + 1, nif)))
    Qr, Rr, Qrf = 2 * np.eye(nx), 3 * np.eye(nu), 5 * np.eye(nx)
    eta, etaf = oracles.eta_np(mu, muf, beta, betaf, 1e-10)
    As, Bs, Ks = [A], [B], []
    for b in range(1, Bsz):
        As.append(A + 0.05 * rng.standard_normal(A.shape))
        Bs.append(B + 0.05 * rng.standard_normal(B.shape))
    for A_b, B_b in zip(As, Bs):
        Ks.append(oracles.backward_np(A_b, B_b, G, Gf, eta, etaf, Qr, Rr, Qrf)[1])
    return (np.stack(As), np.stack(Bs), E, np.stack(Ks), G[:, :nx], G[:, nx:], Gf,
            Qr, Rr, Qrf)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_materialized_stages_match_jax():
    A, B, E, K, Gx, Gu, Gf, Qr, Rr, Qrf = _inputs(3, Bsz=2)
    T = lambda a: torch.as_tensor(a)
    Phi_x, Phi_u = ts.propagate(T(A), T(B), T(E), T(K))
    beta, beta_f, bo, bo_f = ts.backoff_from_phi(Phi_x, Phi_u, T(Gx), T(Gu), T(Gf), 1e-10)
    tube = ts.tube_cost(Phi_x, Phi_u, ts.SLSRegs(T(Qr), T(Rr), T(Qrf)))
    jregs = js.SLSRegs(*(jnp.asarray(r) for r in (Qr, Rr, Qrf)))
    for b in range(2):
        jPx, jPu = js.propagate(*(jnp.asarray(a) for a in (A[b], B[b], E, K[b])))
        ref = (jPx, jPu) + tuple(js.backoff_from_phi(jPx, jPu, jnp.asarray(Gx), jnp.asarray(Gu),
                                                      jnp.asarray(Gf), 1e-10))
        ref += (js.tube_cost(jPx, jPu, jregs),)
        for name, g, r in zip(NAMES, (Phi_x, Phi_u, beta, beta_f, bo, bo_f, tube), ref):
            assert _rel(g[b], r) <= 1e-12, name


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_fused_response_matches_pallas_interpret(seed):
    A, B, E, K, Gx, Gu, Gf, Qr, Rr, Qrf = _inputs(seed)
    ref = j_fused_response(A[0], B[0], E, K[0], Gx, Gu, Gf, Qr, Rr, Qrf, interpret=True)
    tfr.reset_launch_counts()
    got = tfr.fused_response(*(torch.as_tensor(a) for a in (A, B, E, K, Gx, Gu, Gf, Qr, Rr, Qrf)))
    assert tfr.launch_counts() == {"fused_response": 0}   # CPU: the plain twin
    for name, g, r in zip(NAMES, got, ref):
        assert g.dtype == torch.float32, name
        assert _rel(g[0].numpy(), r) <= 1e-5, name


def test_response_paths_agree():
    """The three response paths of fast-SLS: materialized (float64) and
    streaming agree to 1e-10, the fused one (float32, cast back) to 1e-5."""
    A, B, E, K, Gx, Gu, Gf, Qr, Rr, Qrf = (torch.as_tensor(a) for a in _inputs(4, Bsz=2))
    from robust_nonlinear_mpc_torch.ops.qp_ipm import QPStatics

    stat = QPStatics(Hx=None, Hu=None, HxN=None, Gx=Gx, Gu=Gu, Gf=Gf)
    prob = SLSProblem(stat=stat, regs=ts.SLSRegs(Qr, Rr, Qrf), E=E)
    Bsz, N = A.shape[0], A.shape[1]
    phi_x = torch.zeros((Bsz, N + 1, N + 1) + E.shape[1:], dtype=A.dtype)
    phi_u = torch.zeros((Bsz, N, N + 1, B.shape[3], E.shape[2]), dtype=A.dtype)
    outs = {
        name: compute_response(prob, A, B, K, FastSLSOptions(**kw), phi_x, phi_u)
        for name, kw in (("materialized", {}), ("streaming", {"streaming_response": True}),
                         ("fused", {"use_pallas_response": True}))
    }
    mat = outs["materialized"]
    assert float(outs["streaming"][0].abs().max()) == 0.0   # streaming keeps no Phi
    for i in range(2, 7):
        assert _rel(outs["streaming"][i], mat[i]) <= 1e-10, NAMES[i]
    for i in range(7):
        assert outs["fused"][i].dtype == torch.float64, NAMES[i]
        assert _rel(outs["fused"][i], mat[i]) <= 1e-5, NAMES[i]


def test_fused_response_refuses_what_the_kernel_cannot_hold():
    # the layout holds no stage: eight warps at the rocket's widths (54,144
    # bytes), at any N; only constraint blocks past the card's 227 KB are
    # refused (and widths past 32 by the wrapper)
    A = torch.zeros((1, 80, 17, 17), device="meta")
    assert tfr.smem_bytes(17, 4, 17, 42, 34, warps=8) == 54144
    assert tfr.smem_bytes(32, 4, 32, 2 * 36, 64, warps=8) <= tfr.MAX_SMEM_BYTES
    assert tfr.smem_bytes(17, 4, 17, 2500, 34) > tfr.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="unsupported device"):
        tfr.fused_response(A, *([None] * 9))


@pytest.mark.parametrize("nx,nu", [(4, 1), (13, 4)], ids=["pendulum", "quadrotor"])
def test_plain_fused_response_matches_pallas_at_model_widths(nx, nu):
    """The twin against the Pallas kernel (interpret mode) at the widths of
    the card's pendulum and quadrotor instantiations (nw = nx, ni = 2 (nx +
    nu), ni_f = 2 nx), two lanes, N = 3; both float32, so 1e-5 relative."""
    from robust_nonlinear_mpc_torch.tools.kernel_times import response_inputs

    args = response_inputs(2, 3, "cpu", seed=nx, nx=nx, nu=nu)
    got = tfr.fused_response(*args)
    A, B, E, K, *rest = (a.numpy() for a in args)
    for b in range(2):
        ref = j_fused_response(A[b], B[b], E, K[b], *rest, interpret=True)
        for name, g, r in zip(NAMES, got, ref):
            assert _rel(g[b].numpy(), np.asarray(r).reshape(g[b].shape)) <= 1e-5, name

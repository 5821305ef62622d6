"""PyTorch port: the per-column SLS forms (`ops/sls_kernels.riccati_step`,
`riccati_column`, `eta_columns`, `backward_solve`, `response_column`,
`response_streaming`, `tensor_to_matrix`, `matrix_to_tensor`) against the
JAX package's (float64, CPU) at N in {12, 15}, B = 2 lanes: rtol 1e-10.
The JAX forms take one lane and one column, so the reference vmaps them
over both; the port's take a column-index tensor and every lane at once.

Against the port's folded forms (`backward_solve_folded`,
`response_streaming_folded`): rtol 1e-12. A padded column (j = N + 1)
gives exact zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.ops import sls_kernels as tk
from robust_nonlinear_mpc_tpu.ops import sls_kernels as jk

torch.set_num_threads(1)
EPS = 1e-10
BSZ = 2


def _close(got, ref, rtol, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * 1e-2 * scale, err_msg=what)


def _problem(N, nx=3, nu=2, ni=5, ni_f=4, nw=3, seed=0):
    """B lanes of (A, B, mu, beta) and the shared geometry, E and regularizers
    (the shapes of tests/test_columns.py)."""
    rng = np.random.default_rng(seed + N)
    p = dict(
        A=0.9 * rng.standard_normal((BSZ, N, nx, nx)) / np.sqrt(nx),
        B=rng.standard_normal((BSZ, N, nx, nu)) / np.sqrt(nu),
        E=0.1 * rng.standard_normal((N + 1, nx, nw)),
        Gmat=rng.standard_normal((ni, nx + nu)),
        Gf=rng.standard_normal((ni_f, nx)),
        mu=np.abs(rng.standard_normal((BSZ, N, ni))),
        mu_f=np.abs(rng.standard_normal((BSZ, ni_f))),
        beta=np.abs(rng.standard_normal((BSZ, N, N, ni))) * np.tril(np.ones((N, N)))[..., None],
        beta_f=np.abs(rng.standard_normal((BSZ, N + 1, ni_f))),
        regs=(2.0 * np.eye(nx), 3.0 * np.eye(nu), 5.0 * np.eye(nx)),
    )
    return p


def _torch(p):
    t = {k: torch.as_tensor(v) for k, v in p.items() if k != "regs"}
    t["regs"] = tk.SLSRegs(*(torch.as_tensor(r) for r in p["regs"]))
    return t


@pytest.fixture(scope="module", params=[12, 15])
def case(request):
    """The problem, the port's eta and the JAX references, once per N."""
    N = request.param
    p = _problem(N)
    regs = jk.SLSRegs(*(jnp.asarray(r) for r in p["regs"]))
    A, B, E = jnp.asarray(p["A"]), jnp.asarray(p["B"]), jnp.asarray(p["E"])
    Gmat, Gf = jnp.asarray(p["Gmat"]), jnp.asarray(p["Gf"])
    nx = A.shape[2]
    Gx, Gu = Gmat[:, :nx], Gmat[:, nx:]
    js = np.array([0, 2, N - 1, N, N + 1])      # a subset, the terminal column and a pad

    @jax.jit
    def ref(mu, mu_f, beta, beta_f):
        def lane(A, B, mu, mu_f, beta, beta_f):
            eta, eta_f = jk.evaluate_dual_eta(mu, mu_f, beta, beta_f, EPS)
            S, K = jk.backward_solve(A, B, Gmat, Gf, eta, eta_f, regs)
            eta_cols = jk.eta_columns(eta)
            eta_cols_p = jnp.concatenate([eta_cols, jnp.zeros_like(eta_cols[:1])])
            eta_f_p = jnp.concatenate([eta_f, jnp.zeros_like(eta_f[:1])])
            Sc, Kc = jax.vmap(lambda j: jk.riccati_column(
                j, eta_cols_p[j], eta_f_p[j], A, B, Gmat, Gf, regs))(js)
            Kt = jnp.swapaxes(K, 0, 1)
            K_cols = jnp.concatenate([Kt, jnp.zeros_like(Kt[:1])])
            bc, bfc, csq = jax.vmap(lambda j: jk.response_column(
                j, K_cols[j], A, B, E, Gx, Gu, Gf, regs, EPS))(js)
            stream = jk.response_streaming(A, B, E, K, Gx, Gu, Gf, regs, EPS)
            return dict(eta=eta, eta_f=eta_f, eta_cols=eta_cols, S=S, K=K, S_col=Sc, K_col=Kc,
                        beta_col=bc, beta_f_col=bfc, cost_sq=csq, stream=stream,
                        K_mat=jk.tensor_to_matrix(K))

        return jax.vmap(lane)(A, B, mu, mu_f, beta, beta_f)

    out = ref(*(jnp.asarray(p[k]) for k in ("mu", "mu_f", "beta", "beta_f")))
    out = jax.tree_util.tree_map(np.array, out)
    return N, p, js, out


def _eta(t, ref):
    return torch.as_tensor(ref["eta"]), torch.as_tensor(ref["eta_f"])


@pytest.mark.parametrize("form", ["eta_columns", "riccati_column", "backward_solve",
                                  "response_column", "response_streaming", "block_matrix"])
def test_per_column_forms_match_jax(case, form):
    N, p, js_np, ref = case
    t = _torch(p)
    nx = t["A"].shape[2]
    Gx, Gu = t["Gmat"][:, :nx], t["Gmat"][:, nx:]
    eta, eta_f = _eta(t, ref)
    js = torch.as_tensor(js_np)
    if form == "eta_columns":
        _close(tk.eta_columns(eta), ref["eta_cols"], 1e-10, form)
    elif form == "riccati_column":
        eta_cols = tk.eta_columns(eta)
        eta_cols_p = torch.cat([eta_cols, torch.zeros_like(eta_cols[:, :1])], dim=1)
        eta_f_p = torch.cat([eta_f, torch.zeros_like(eta_f[:, :1])], dim=1)
        S_col, K_col = tk.riccati_column(js, eta_cols_p[:, js], eta_f_p[:, js],
                                         t["A"], t["B"], t["Gmat"], t["Gf"], t["regs"])
        _close(S_col, ref["S_col"], 1e-10, "S_col")
        _close(K_col, ref["K_col"], 1e-10, "K_col")
    elif form == "backward_solve":
        S, K = tk.backward_solve(t["A"], t["B"], t["Gmat"], t["Gf"], eta, eta_f, t["regs"])
        _close(S, ref["S"], 1e-10, "S")
        _close(K, ref["K"], 1e-10, "K")
    elif form == "response_column":
        K = torch.as_tensor(ref["K"])
        K_cols = torch.cat([K.transpose(1, 2), torch.zeros_like(K[:, :, :1]).transpose(1, 2)],
                           dim=1)
        bc, bfc, csq = tk.response_column(js, K_cols[:, js], t["A"], t["B"],
                                          t["E"], Gx, Gu, t["Gf"], t["regs"], EPS)
        _close(bc, ref["beta_col"], 1e-10, "beta_col")
        _close(bfc, ref["beta_f_col"], 1e-10, "beta_f_col")
        _close(csq, ref["cost_sq"], 1e-10, "cost_sq")
    elif form == "response_streaming":
        got = tk.response_streaming(t["A"], t["B"], t["E"], torch.as_tensor(ref["K"]), Gx, Gu,
                                    t["Gf"], t["regs"], EPS)
        for name, g, r in zip(("beta", "beta_f", "backoff", "backoff_f", "cost"), got,
                              ref["stream"]):
            _close(g, r, 1e-10, name)
    else:
        K = torch.as_tensor(ref["K"])
        mat = tk.tensor_to_matrix(K)
        _close(mat, ref["K_mat"], 0.0, "tensor_to_matrix")
        assert torch.equal(tk.matrix_to_tensor(mat, *K.shape[1:]), K)


def test_per_column_forms_match_folded(case):
    """The dense per-column forms against the GEMM-folded ones, and
    response_column over every column reduced as the folded backoffs are."""
    N, p, _, ref = case
    t = _torch(p)
    nx = t["A"].shape[2]
    Gx, Gu = t["Gmat"][:, :nx], t["Gmat"][:, nx:]
    eta, eta_f = _eta(t, ref)
    args = (t["A"], t["B"], t["Gmat"], t["Gf"], eta, eta_f, t["regs"])
    S, K = tk.backward_solve(*args)
    S_f, K_f = tk.backward_solve_folded(*args)
    _close(S, S_f, 1e-12, "S")
    _close(K, K_f, 1e-12, "K")
    resp = (t["A"], t["B"], t["E"], K, Gx, Gu, t["Gf"], t["regs"], EPS)
    folded = tk.response_streaming_folded(*resp)
    for name, g, r in zip(("beta", "beta_f", "backoff", "backoff_f", "cost"),
                          tk.response_streaming(*resp), folded):
        _close(g, r, 1e-12, name)
    js = torch.arange(N + 1)
    bc, bfc, csq = tk.response_column(js, K.transpose(1, 2), t["A"], t["B"], t["E"], Gx, Gu,
                                      t["Gf"], t["regs"], EPS)
    _close(bc[:, :N].transpose(1, 2), folded[0], 1e-12, "beta")
    _close(bfc, folded[1], 1e-12, "beta_f")
    _close(torch.sqrt(bc).sum(dim=1), folded[2], 1e-12, "backoff")
    _close(torch.sqrt(csq.sum(dim=1)), folded[4], 1e-12, "cost")


def test_padded_column_is_exactly_zero(case):
    N, p, _, ref = case
    t = _torch(p)
    nx = t["A"].shape[2]
    js = torch.tensor([N + 1])
    rng = np.random.default_rng(1)
    eta_c = torch.as_tensor(np.abs(rng.standard_normal((BSZ, 1, N, t["mu"].shape[2]))))
    eta_f_c = torch.as_tensor(np.abs(rng.standard_normal((BSZ, 1, t["Gf"].shape[0]))))
    S_col, K_col = tk.riccati_column(js, eta_c, eta_f_c, t["A"], t["B"], t["Gmat"], t["Gf"],
                                     t["regs"])
    assert torch.count_nonzero(K_col) == 0 and torch.count_nonzero(S_col[:, :, :N]) == 0
    K_rand = torch.as_tensor(rng.standard_normal(K_col.shape))
    outs = tk.response_column(js, K_rand, t["A"], t["B"], t["E"], t["Gmat"][:, :nx],
                              t["Gmat"][:, nx:], t["Gf"], t["regs"], EPS)
    assert all(torch.count_nonzero(o) == 0 for o in outs)

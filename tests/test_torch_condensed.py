"""PyTorch port: the condensed-KKT interior point, `spd_inverse`, the two
precision switches and the front end's IPM at tolerance 1e-10, against the
JAX package (float64, CPU).

* `IPMOptions(kkt="condensed")`: the JAX test's random QPs (tests/helpers
  `random_qp`), three lanes at N = 6 (one with active constraints) and one
  at N = 60, where the per-stage symmetrization trap of the Riccati forms
  lives; the same iteration count as JAX's kkt="condensed" on every lane,
  X/U within 1e-9 and the duals within 1e-8, relative to each output's
  largest entry (at least 1).
* `spd_inverse` against JAX's at n in {1, 2, 3, 5, 17, 60}, 1e-10 relative;
  a lane whose matrix is not positive definite, or not finite, gives NaN
  there and leaves the other lanes as they are.
* the switches keep the JAX names and values; "highest" leaves the TF32
  setting untouched (so every result is bit for bit the port's without the
  switch); "default" turns TF32 on exactly around the tube's backward
  Riccati and response and the IPM's direction GEMMs, never around the
  residuals, and restores the setting after each call; on the CPU, where
  TF32 does not exist, a closed-loop step is bit for bit the same in both
  modes.
* the front end's IPM at tolerance 1e-10 on the rocket's QP along an SQP
  iterate: the port stops where JAX stops, at the same iteration, both at
  the complementarity floor short of 1e-10 (a property of the reference's
  stopping test), X/U within 1e-8 and the duals within 1e-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from robust_nonlinear_mpc_torch.ops import qp_ipm as tq
from robust_nonlinear_mpc_torch.utils import numerics as tn
from robust_nonlinear_mpc_tpu.ops import qp_ipm as jq
from robust_nonlinear_mpc_tpu.utils import numerics as jn

from tests.helpers import random_qp

X_TOL, DUAL_TOL = 1e-9, 1e-8


@pytest.fixture(autouse=True)
def _one_thread():
    """One BLAS and one torch thread a test (the suite's workers share a few
    cores), and the switches back at "highest" after each test."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)
        tn.set_tube_precision("highest")
        tn.set_qp_direction_precision("highest")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))


def _batch(seeds, N):
    """(JAX statics, stacked JAX data) of random_qp lanes sharing the first
    seed's statics; seed 7's bounds are pulled in to make constraints active."""
    stat = random_qp(seed=seeds[0], N=N)[0]
    datas = []
    for s in seeds:
        d = random_qp(seed=s, N=N)[1]
        if s == 7:
            d = d._replace(h=jnp.maximum(d.h, 0.05), hf=jnp.maximum(d.hf, 0.05))
        datas.append(d)
    return stat, jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *datas)


def _to_torch(stat, data):
    T = lambda a: torch.as_tensor(np.asarray(a))
    return tq.QPStatics(*(T(v) for v in stat)), tq.QPData(*(T(v) for v in data))


@pytest.mark.parametrize("seeds,N", [((0, 1, 7), 6), ((3,), 60)], ids=["N6", "N60"])
def test_condensed_matches_jax(seeds, N):
    stat, data = _batch(seeds, N)
    opts = jq.IPMOptions(max_iter=40, tol=1e-10, kkt="condensed")
    ref = jax.jit(jax.vmap(lambda d: jq.solve_qp(stat, d, opts)))(data)
    ts, td = _to_torch(stat, data)
    got = tq.solve_qp(ts, td, tq.IPMOptions(max_iter=40, tol=1e-10, kkt="condensed"))
    assert got.iters.tolist() == np.asarray(ref.iters).tolist()
    assert got.success.all() and bool(np.all(ref.success))
    for f, tol in (("X", X_TOL), ("U", X_TOL), ("lam", DUAL_TOL), ("lam_f", DUAL_TOL),
                   ("nu_dyn", DUAL_TOL), ("nu_init", DUAL_TOL)):
        assert _rel(getattr(got, f).numpy(), getattr(ref, f)) <= tol, f
    # the precompute passed in (as fast-SLS shares it) gives the same bits
    pre = tq.condense(ts.per_stage(N), td.A, td.B)
    again = tq.solve_qp(ts, td, tq.IPMOptions(max_iter=40, tol=1e-10, kkt="condensed"), pre=pre)
    assert torch.equal(again.X, got.X) and torch.equal(again.nu_dyn, got.nu_dyn)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 17, 60])
def test_spd_inverse_matches_jax(n):
    rng = np.random.default_rng(n)
    M = rng.standard_normal((4, n, n + 3))
    H = np.einsum("bij,bkj->bik", M, M) + 0.1 * np.eye(n)
    ref = np.asarray(jax.jit(jax.vmap(jn.spd_inverse))(jnp.asarray(H)))
    got = tn.spd_inverse(torch.as_tensor(H)).numpy()
    assert _rel(got, ref) <= 1e-10
    assert np.abs(got @ H - np.eye(n)).max() <= 1e-8


def test_spd_inverse_nan_lane():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((4, 6, 9))
    H = np.einsum("bij,bkj->bik", M, M) + 0.1 * np.eye(6)
    good = tn.spd_inverse(torch.as_tensor(H)).numpy()
    H[1] = -H[1]                     # negative definite
    H[2, 3, 3] = np.nan              # not finite
    got = tn.spd_inverse(torch.as_tensor(H)).numpy()
    assert np.isnan(got[1]).all() and np.isnan(got[2]).all()
    assert np.array_equal(got[[0, 3]], good[[0, 3]])


def test_switch_names_and_modes():
    try:
        for name in ("set_tube_precision", "set_qp_direction_precision"):
            for mode in ("highest", "default"):
                getattr(tn, name)(mode)
                getattr(jn, name)(mode)
            for mod in (tn, jn):
                with pytest.raises(KeyError):
                    getattr(mod, name)("fastest")
    finally:
        jn.set_tube_precision("highest")
        jn.set_qp_direction_precision("highest")
    tn.set_qp_direction_precision("highest")
    tn.set_tube_precision("default")
    assert (tn.tube_prec(), tn.qp_dir_prec()) == ("default", "highest")


@pytest.mark.parametrize("mode", ["highest", "default"])
def test_switch_contexts_restore(mode):
    tn.set_tube_precision(mode)
    tn.set_qp_direction_precision(mode)
    before = tn.tf32_enabled()
    for ctx in (tn.tube_precision, tn.qp_direction_precision):
        with ctx():
            assert tn.tf32_enabled() == (mode == "default")
        assert tn.tf32_enabled() == before
        with pytest.raises(RuntimeError), ctx():
            raise RuntimeError
        assert tn.tf32_enabled() == before


def _pendulum_step():
    """One RTI closed-loop step of the pendulum (3 SCP iterations, 2 fast-SLS
    iterations each: both QPs, the backward Riccati and the response) at
    N = 5, float64; returns its outputs."""
    from robust_nonlinear_mpc_torch.expe.main_pendulum_robust_closed_loop import (
        make_pendulum_problem,
    )
    from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step
    from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist
    from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve

    m, solver = make_pendulum_problem(N=5, device="cpu", verbose=False)
    x0 = torch.tensor([[0.5, 0.5, 0.0, 0.0], [0.3, -0.2, 0.1, 0.0]], dtype=torch.float64)
    nom = sqp_solve(m, 5, solver.Q, solver.R, solver.Qf, x0, opts=solver.opts.sqp)
    persist = FastSLSPersist.init(5, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=2,
                                  dtype=torch.float64, device="cpu")
    w = torch.full((2, m.nw), 0.5, dtype=torch.float64)
    return make_mpc_step(solver)((nom.X, nom.U, persist, x0), w)[1]


def test_switches_reach_only_their_gemms(monkeypatch):
    """Under "default" TF32 is on in the tube's backward Riccati and
    response and in the IPM's factorization, off in its residuals; under
    "highest" it is never on; the step's outputs are bit for bit equal."""
    from robust_nonlinear_mpc_torch.solvers import fast_sls

    seen = {}

    def spy(name, fn):
        def wrapped(*a, **k):
            seen.setdefault(name, set()).add(tn.tf32_enabled())
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(fast_sls, "backward_solve_folded",
                        spy("backward", fast_sls.backward_solve_folded))
    monkeypatch.setattr(fast_sls, "propagate", spy("response", fast_sls.propagate))
    monkeypatch.setattr(tq, "_factorize_with_presolve",
                        spy("factorize", tq._factorize_with_presolve))
    monkeypatch.setattr(tq, "_residuals", spy("residuals", tq._residuals))
    outs = {}
    for mode in ("highest", "default"):
        seen.clear()
        tn.set_tube_precision(mode)
        tn.set_qp_direction_precision(mode)
        outs[mode] = _pendulum_step()
        on = mode == "default"
        assert seen == {"backward": {on}, "response": {on}, "factorize": {on},
                        "residuals": {False}}, (mode, seen)
        assert not tn.tf32_enabled()
    for a, b in zip(outs["highest"], outs["default"]):
        assert torch.equal(a, b)


def _rocket_frontend_qp():
    """The rocket's front-end QP (N = 15) along the SQP iterate after 6
    iterations from X0 + 0.02 N(0, 1) (seed 0), with x(0) 0.01 off it (seed
    11): the deviation QP whose nominal sits on its bounds."""
    from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
        X0,
        make_rocket_problem,
    )
    from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve

    N = 15
    m, solver = make_rocket_problem(N=N, device="cpu")
    x0 = torch.as_tensor(np.array(X0)[None] + 0.02 * np.random.default_rng(0).standard_normal((1, 17)))
    nom = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0,
                    opts=solver.opts.sqp._replace(max_iter=6))
    X, U = nom.X[0].numpy(), nom.U[0].numpy()
    A, B, c = (v.numpy() for v in m.linearize_traj(torch.as_tensor(X), torch.as_tensor(U)))
    Q, R, Qf = (v.numpy() for v in (solver.Q, solver.R, solver.Qf))
    G, g, Gf, gf = (v.numpy() for v in (m.G, m.g, m.Gf, m.gf))
    return dict(N=N, Q=Q, R=R, Qf=Qf, A=A, B=B, c=c,
                h=g[None] - np.concatenate([X[:N], U], axis=1) @ G.T, hf=gf - Gf @ X[N],
                qx=np.concatenate([2 * X[:N] @ Q.T, (2 * Qf @ X[N])[None]]), qu=2 * U @ R.T,
                x0=-0.01 * np.random.default_rng(11).standard_normal(17))


def test_frontend_ipm_at_1e10_stops_where_jax_stops():
    from robust_nonlinear_mpc_torch.models.linear import LTV as LTVT
    from robust_nonlinear_mpc_torch.models.rocket import Rocket as RocketT
    from robust_nonlinear_mpc_torch.solvers.qp_frontend import QP as QPT
    from robust_nonlinear_mpc_tpu.models.linear import LTV
    from robust_nonlinear_mpc_tpu.models.rocket import Rocket
    from robust_nonlinear_mpc_tpu.solvers.qp_frontend import QP

    p = _rocket_frontend_qp()
    N, E0 = p["N"], np.zeros((p["N"] + 1, 17, 17))
    qps = []
    for LTV_, model, QP_, ipm in ((LTVT, RocketT(device="cpu"), QPT, tq.IPMOptions(tol=1e-10)),
                                  (LTV, Rocket(), QP, jq.IPMOptions(tol=1e-10))):
        m = LTV_(model, N)
        m.update_model(p["A"], p["B"], E0, p["h"], p["hf"])
        qp = QP_(N, p["Q"], p["R"], m, p["Qf"], ipm=ipm)
        qp.offset_constraints(p["c"])
        qp.update_q_cost_lin(p["qx"], p["qu"])
        qps.append(qp)
    data = qps[0]._data(p["x0"])
    got = tq.solve_qp(qps[0].stat, data, qps[0].ipm)
    jdata = jq.QPData(*(jnp.asarray(v[0].numpy()) for v in data))
    ref = jax.jit(lambda d: jq.solve_qp(qps[1].stat, d, qps[1].ipm))(jdata)
    assert int(got.iters[0]) == int(ref.iters) < qps[0].ipm.max_iter
    # neither reaches 1e-10: both stop at the complementarity floor
    n_comp = data.h.shape[1] * data.h.shape[2] + data.hf.shape[1]
    for res, lam, s, lam_f, s_f in ((float(got.kkt_res[0]), got.lam[0].numpy(), got.s[0].numpy(),
                                     got.lam_f[0].numpy(), got.s_f[0].numpy()),
                                    (float(ref.kkt_res), ref.lam, ref.s, ref.lam_f, ref.s_f)):
        assert 1e-10 < res < 1e-8
        mu = (np.sum(lam * s) + np.sum(lam_f * s_f)) / n_comp
        scale = 1.0 + max(np.abs(p["qx"]).max(), np.abs(p["qu"]).max(), np.abs(lam).max(),
                          np.abs(lam_f).max())
        assert mu < 10.0 * np.finfo(np.float64).eps * scale
    # each stops with a KKT residual near 5e-10, so their points agree to
    # that accuracy (the duals, up to 1e2, a decade less), not to the last bits
    for f, tol in (("X", 1e-8), ("U", 1e-8), ("lam", 1e-7), ("lam_f", 1e-7)):
        assert _rel(getattr(got, f)[0].numpy(), getattr(ref, f)) <= tol, f
    a, b = qps[0].solve(p["x0"]), qps[1].solve(p["x0"])
    assert a["success"] and b["success"]
    assert _rel(a["dual_mu"], b["dual_mu"]) <= 1e-7

"""The port's QP front end and its small parts against the JAX package,
float64 on the CPU: `solvers/qp_frontend.QP` (LTI/LTV, the updates,
`reset_lbg`, the quadprog export), `solvers/ocp.OCP` (packing, dynamics
stacks, Riccati steps), `models/linear` (LTI, LTV, the output-feedback
stubs), `models/integrator`, `ops/qp_export.densify`, `ops/packing.unpack_primal`
and the native C++ backend (`native/`).

Port against JAX within 1e-8. The native backend against the port's torch
IPM within the tolerances of tests/test_native_qp.py (X/U 1e-7, duals 1e-6,
cost 1e-9 relative).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

from reference_port.scp_sls import pack_primal as oracle_pack
from robust_nonlinear_mpc_torch import native as native_t
from robust_nonlinear_mpc_torch.models.integrator import Integrator as IntegratorT
from robust_nonlinear_mpc_torch.models.linear import LTI as LTIT
from robust_nonlinear_mpc_torch.models.linear import LTI_OF as LTI_OFT
from robust_nonlinear_mpc_torch.models.linear import LTV as LTVT
from robust_nonlinear_mpc_torch.models.linear import LTV_OF as LTV_OFT
from robust_nonlinear_mpc_torch.models.pendulum import Pendulum as PendulumT
from robust_nonlinear_mpc_torch.ops import qp_export as export_t
from robust_nonlinear_mpc_torch.ops.packing import pack_primal as pack_t
from robust_nonlinear_mpc_torch.ops.packing import unpack_primal as unpack_t
from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions as IPMOptionsT
from robust_nonlinear_mpc_torch.ops.qp_ipm import QPData as QPDataT
from robust_nonlinear_mpc_torch.ops.qp_ipm import QPStatics as QPStaticsT
from robust_nonlinear_mpc_torch.ops.qp_ipm import solve_qp as solve_qp_t
from robust_nonlinear_mpc_torch.solvers.ocp import OCP as OCPT
from robust_nonlinear_mpc_torch.solvers.qp_frontend import QP as QPT
from robust_nonlinear_mpc_tpu.models import LTI, LTI_OF, LTV, LTV_OF, Integrator, Pendulum
from robust_nonlinear_mpc_tpu.native import qp_solve_native as native_j
from robust_nonlinear_mpc_tpu.ops import qp_export as export_j
from robust_nonlinear_mpc_tpu.ops.packing import unpack_primal as unpack_j
from robust_nonlinear_mpc_tpu.solvers.ocp import OCP
from robust_nonlinear_mpc_tpu.solvers.qp_frontend import QP

from tests.helpers import random_qp

TOL = 1e-8
X0 = np.array([-3.0, -0.5])


@pytest.fixture
def gpp():
    """The native cases skip only where there is no g++; a failed build fails."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the native QP")


@pytest.fixture(autouse=True)
def _one_thread():
    """One BLAS and one torch thread a test: the suite runs several workers
    on a few cores, where OpenBLAS's spinning threads slow these small dense
    solves several times over (the quadrotor oracle's 3 steps: 31.5 s with
    8 threads, 7.7 s with one, alone on an 8-core host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


def _lti_arrays():
    """The double integrator of tests/test_qp_frontend.py."""
    A = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.005], [0.1]])
    E = 0.1 * np.eye(2)
    G = np.vstack([np.eye(3), -np.eye(3)])
    g = np.array([4.0, 4.0, 2.0, 4.0, 4.0, 2.0])
    Gf = np.vstack([np.eye(2), -np.eye(2)])
    gf = np.array([4.0, 4.0, 4.0, 4.0])
    return A, B, E, dict(G=G, g=g, Gf=Gf, gf=gf)


def _lti_pair():
    A, B, E, kw = _lti_arrays()
    return LTIT(A, B, E, **kw, device="cpu"), LTI(A, B, E, **kw)


def _qp_pair(backend_t="torch", backend_j="jax", ipm_t=None, **kw):
    m_t, m_j = _lti_pair()
    args = (6, np.eye(2), 0.1 * np.eye(1))
    return (QPT(*args, m_t, 5 * np.eye(2), backend=backend_t, ipm=ipm_t, **kw),
            QP(*args, m_j, 5 * np.eye(2), backend=backend_j, **kw))


def _same_solution(got, ref, tol=TOL):
    assert got["success"] == ref["success"]
    if not ref["success"]:
        return
    for k in ("primal_vec", "primal_x", "primal_u", "dual_mu", "dual_mu_f"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), atol=tol, rtol=0, err_msg=k)
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# QP front end (tests/test_qp_frontend.py)
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kkt", ["riccati", "fused", "fused_iter"])
def test_frontend_lti_solve_matches_jax(kkt):
    qp_t, qp_j = _qp_pair(ipm_t=IPMOptionsT(kkt=kkt))
    got, ref = qp_t.solve(X0), qp_j.solve(X0)
    assert got["success"]
    _same_solution(got, ref)
    # x(0) is pinned to -x0 and the dynamics hold
    np.testing.assert_allclose(got["primal_x"][:, 0], [3.0, 0.5], atol=1e-7)
    A, B = qp_j.m.A, qp_j.m.B
    X, U = got["primal_x"], got["primal_u"]
    for k in range(6):
        np.testing.assert_allclose(X[:, k + 1], A @ X[:, k] + B @ U[:, k], atol=1e-7)


def test_frontend_native_backend(gpp):
    """Native in the port against native in JAX (the same C++ source:
    identical) and against the port's torch backend (test_native_qp.py's
    tolerances)."""
    qp_t, qp_j = _qp_pair("native", "native")
    got = qp_t.solve(X0)
    assert got["success"]
    _same_solution(got, qp_j.solve(X0), tol=0.0)
    torch_sol = _qp_pair()[0].solve(X0)
    np.testing.assert_allclose(got["primal_x"], torch_sol["primal_x"], atol=1e-7)
    np.testing.assert_allclose(got["primal_u"], torch_sol["primal_u"], atol=1e-7)
    np.testing.assert_allclose(got["dual_mu"], torch_sol["dual_mu"], atol=1e-6)
    np.testing.assert_allclose(got["cost"], torch_sol["cost"], rtol=1e-9)


def test_frontend_refuses_the_jax_backend():
    m_t, _ = _lti_pair()
    with pytest.raises(ValueError, match="'torch'"):
        QPT(6, np.eye(2), 0.1 * np.eye(1), m_t, 5 * np.eye(2), backend="jax")
    with pytest.raises(ValueError, match="backend"):
        QPT(6, np.eye(2), 0.1 * np.eye(1), m_t, 5 * np.eye(2), backend="osqp")


def test_frontend_updates_match_jax():
    """The update sequence of test_frontend_updates_change_solution, applied
    to both front ends: every solve agrees, the infeasible tightening fails
    on both."""
    qp_t, qp_j = _qp_pair()
    s1 = qp_t.solve(X0)
    _same_solution(s1, qp_j.solve(X0))
    h = np.asarray(qp_j._nominal_h).copy()
    np.testing.assert_array_equal(qp_t._nominal_h.numpy(), h)
    h[:, 2] = 1.5
    h[:, 5] = 1.5
    for qp in (qp_t, qp_j):
        qp.update_ubg(h)
    s2 = qp_t.solve(X0)
    _same_solution(s2, qp_j.solve(X0))
    assert np.max(np.abs(s2["primal_u"])) <= 1.5 + 1e-6
    assert not np.allclose(s1["primal_u"], s2["primal_u"])

    for qp in (qp_t, qp_j):
        qp.update_ubg(0.5 * np.asarray(qp_j._nominal_h), 0.5 * np.asarray(qp_j._nominal_hf))
    s_inf = qp_t.solve(X0)
    assert not s_inf["success"]
    _same_solution(s_inf, qp_j.solve(X0))
    for qp in (qp_t, qp_j):
        qp.reset_ubg()
    _same_solution(qp_t.solve(X0), qp_j.solve(X0))
    # linear cost: per-stage arrays, then the packed vector, then added
    for qp in (qp_t, qp_j):
        qp.update_q_cost_lin(np.ones((7, 2)), np.ones((6, 1)))
    s4 = qp_t.solve(X0)
    _same_solution(s4, qp_j.solve(X0))
    assert not np.allclose(s4["primal_u"], s1["primal_u"])
    y = np.linspace(-1.0, 1.0, 3 * 6 + 2)
    for qp in (qp_t, qp_j):
        qp.update_q_cost_lin(y)
        qp.add_q_cost_lin(np.ones((7, 2)), np.ones((6, 1)))
    _same_solution(qp_t.solve(X0), qp_j.solve(X0))
    # new dynamics (with bounds of N + 1 rows) reset the bounds to nominal
    A, B, _, _ = _lti_arrays()
    g_stack = np.tile(np.array([3.0, 3.0, 1.8, 3.0, 3.0, 1.8]), (7, 1))
    for qp in (qp_t, qp_j):
        qp.reset_q_cost_lin()
        qp.update_dynamics(np.tile(0.99 * A, (6, 1, 1)), np.tile(B, (6, 1, 1)), g_stack=g_stack)
    np.testing.assert_array_equal(qp_t._nominal_hf.numpy(), np.asarray(qp_j._nominal_hf))
    _same_solution(qp_t.solve(X0), qp_j.solve(X0))


def test_frontend_ltv_from_model_matches_jax():
    m_t, m_j = PendulumT(device="cpu"), Pendulum()
    ltv_t, ltv_j = LTVT(m_t, 5), LTV(m_j, 5)
    A, B, c = jax.jit(m_j.linearize_traj)(jnp.zeros((6, 4)), jnp.zeros((5, 1)))
    At, Bt, ct = m_t.linearize_traj(torch.zeros((6, 4), dtype=torch.float64),
                                    torch.zeros((5, 1), dtype=torch.float64))
    np.testing.assert_allclose(At.numpy(), np.asarray(A), atol=1e-12)
    args = (np.asarray(A), np.asarray(B), np.zeros((6, 4, 4)), np.broadcast_to(m_j.g, (5, 10)),
            m_j.gf)
    ltv_t.update_model(*args)
    ltv_j.update_model(*args)
    qp_t = QPT(5, np.eye(4), np.eye(1), ltv_t, 10 * np.eye(4))
    qp_j = QP(5, np.eye(4), np.eye(1), ltv_j, 10 * np.eye(4))
    qp_t.offset_constraints(ct.numpy())
    qp_j.offset_constraints(np.asarray(c))
    x0 = np.array([-0.5, -0.5, 0.0, 0.0])
    got = qp_t.solve(x0)
    assert got["success"]
    _same_solution(got, qp_j.solve(x0))
    np.testing.assert_allclose(got["primal_x"][:, 0], [0.5, 0.5, 0, 0], atol=1e-7)


def test_frontend_reset_lbg_matches_jax():
    qp_t, qp_j = _qp_pair()
    ref = qp_t.solve(X0)
    for qp in (qp_t, qp_j):
        qp.offset_constraints(0.02 * np.ones((6, 2)))
    shifted = qp_t.solve(X0)
    _same_solution(shifted, qp_j.solve(X0))
    assert np.max(np.abs(shifted["primal_x"] - ref["primal_x"])) > 1e-3
    for qp in (qp_t, qp_j):
        qp.reset_lbg()
        qp.reset_ubg()
    back = qp_t.solve(X0)
    _same_solution(back, qp_j.solve(X0))
    np.testing.assert_allclose(back["primal_x"], ref["primal_x"], atol=1e-9)


def test_frontend_quadprog_export_matches_jax(tmp_path):
    from scipy.io import loadmat

    qp_t, qp_j = _qp_pair(export_standard_QP=True)
    qp_t.export_dir = str(tmp_path / "torch")
    qp_j.export_dir = str(tmp_path / "jax")
    for x0 in (X0, np.array([-2.0, 0.5])):
        assert qp_t.solve(x0)["success"] and qp_j.solve(x0)["success"]
    names = sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == ["qp_export_000000.mat", "qp_export_000001.mat"]
    for name in names:
        got, ref = loadmat(tmp_path / "torch" / name), loadmat(tmp_path / "jax" / name)
        keys = {k for k in ref if not k.startswith("__")}
        assert {k for k in got if not k.startswith("__")} == keys
        assert str(got["backend"][0]) == "torch"
        for k in keys - {"backend"}:
            np.testing.assert_allclose(got[k], ref[k], atol=TOL, rtol=0, err_msg=k)
    # the densified view without the x0 pin
    for a, b in zip(qp_t.densify(), qp_j.densify()):
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# OCP container and linear models (tests/test_ocp.py)
# ----------------------------------------------------------------------
def _random_lti(nx=3, nu=2, seed=0):
    rng = np.random.default_rng(seed)
    A = 0.8 * rng.standard_normal((nx, nx)) / np.sqrt(nx)
    B = rng.standard_normal((nx, nu))
    kw = dict(G=np.vstack([np.eye(nx + nu), -np.eye(nx + nu)]), g=np.ones(2 * (nx + nu)),
              Gf=np.vstack([np.eye(nx), -np.eye(nx)]), gf=np.ones(2 * nx))
    return LTIT(A, B, 0.1 * np.eye(nx), **kw, device="cpu"), LTI(A, B, 0.1 * np.eye(nx), **kw)


def test_ocp_pack_unpack_matches_jax_and_oracle():
    m_t, m_j = _random_lti()
    N = 5
    ocp_t = OCPT(N, np.eye(3), np.eye(2), m_t, 2 * np.eye(3))
    ocp_j = OCP(N, np.eye(3), np.eye(2), m_j, 2 * np.eye(3))
    rng = np.random.default_rng(1)
    X = rng.standard_normal((3, N + 1))
    U = rng.standard_normal((2, N))
    y = ocp_t.pack_primal_nominal(X, U)
    np.testing.assert_array_equal(y.numpy(), ocp_j.pack_primal_nominal(X, U))
    np.testing.assert_array_equal(y.numpy(), oracle_pack(X, U))
    X2, U2 = ocp_t.unpack_primal_nominal(y)
    np.testing.assert_array_equal(X2.numpy(), X)
    np.testing.assert_array_equal(U2.numpy(), U)
    with pytest.raises(AssertionError):
        ocp_t.unpack_primal_nominal(y[:-1])
    for Q in (ocp_t.Q_reg, ocp_t.R_reg, ocp_t.Q_reg_f):
        assert Q.dtype == torch.float64 and Q.device.type == "cpu"


def test_ocp_initialize_list_dynamics_matches_jax():
    m_t, m_j = _random_lti()
    N = 4
    ocp_t = OCPT(N, np.eye(3), np.eye(2), m_t, np.eye(3))
    ocp_j = OCP(N, np.eye(3), np.eye(2), m_j, np.eye(3))
    for ocp in (ocp_t, ocp_j):
        ocp.initialize_list_dynamics()
    for k in ("A_stack", "B_stack", "E_stack", "g_stack", "c_offset_stack"):
        np.testing.assert_array_equal(getattr(ocp_t, k).numpy(), getattr(ocp_j, k), err_msg=k)
    p_t, p_j = PendulumT(device="cpu"), Pendulum()
    ocp2_t = OCPT(N, np.eye(4), np.eye(1), LTVT(p_t, N), np.eye(4))
    ocp2_j = OCP(N, np.eye(4), np.eye(1), LTV(p_j, N), np.eye(4))
    for ocp in (ocp2_t, ocp2_j):
        ocp.initialize_list_dynamics()
    for k in ("A_stack", "B_stack", "E_stack", "g_stack"):
        np.testing.assert_array_equal(getattr(ocp2_t, k).numpy(), getattr(ocp2_j, k), err_msg=k)

    class Bogus:
        nx = nu = nw = ni = ni_f = 1

    with pytest.raises(ValueError):
        OCPT(2, np.eye(1), np.eye(1), Bogus(), np.eye(1), device="cpu").initialize_list_dynamics()


def test_ocp_riccati_steps_match_jax():
    rng = np.random.default_rng(2)
    nx, nu = 4, 2
    psd = lambda n: (lambda M: M @ M.T / n)(rng.standard_normal((n, n)))
    A = rng.standard_normal((nx, nx)) * 0.5
    B = rng.standard_normal((nx, nu))
    Cx = np.eye(nx) + 0.1 * psd(nx)
    Cu = np.eye(nu) + 0.1 * psd(nu)
    Sk = np.eye(nx) + psd(nx)
    t = lambda a: torch.as_tensor(a)
    for step_t, step_j in ((OCPT.riccati_step, OCP.riccati_step),
                           (OCPT.riccati_step_cholesky, OCP.riccati_step_cholesky)):
        K, S = step_t(t(A), t(B), t(Cx), t(Cu), t(Sk))
        Kj, Sj = step_j(A, B, Cx, Cu, Sk)
        np.testing.assert_allclose(K.numpy(), Kj, atol=1e-12)
        np.testing.assert_allclose(S.numpy(), Sj, atol=1e-12)


def test_linear_models_match_jax():
    m_t, m_j = _random_lti()
    rng = np.random.default_rng(3)
    x, u = rng.standard_normal((5, 3)), rng.standard_normal((5, 2))
    np.testing.assert_allclose(m_t.ddyn(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
                               np.asarray(m_j.ddyn(jnp.asarray(x), jnp.asarray(u))), atol=1e-12)
    for k in ("nx", "nu", "nw", "ni", "ni_f", "dt"):
        assert getattr(m_t, k) == getattr(m_j, k), k
    p_t, p_j = PendulumT(device="cpu"), Pendulum()
    ltv_t, ltv_j = LTVT(p_t, 3), LTV(p_j, 3)
    A = rng.standard_normal((3, 4, 4))
    B = rng.standard_normal((3, 4, 1))
    for ltv in (ltv_t, ltv_j):
        ltv.update_model(A, B, np.zeros((4, 4, 4)), np.ones((3, 10)), 2 * np.ones(8))
    xv, uv = rng.standard_normal(4), rng.standard_normal(1)
    np.testing.assert_allclose(ltv_t.ddyn(torch.as_tensor(xv), torch.as_tensor(uv), 2).numpy(),
                               np.asarray(ltv_j.ddyn(jnp.asarray(xv), jnp.asarray(uv), 2)),
                               atol=1e-12)
    np.testing.assert_array_equal(ltv_t.gf_vec.numpy(), ltv_j.gf_vec)
    # output-feedback stubs
    C, F = np.eye(2, 3), 0.1 * np.eye(2)
    of_t = LTI_OFT(m_j.A, m_j.B, m_j.E, C, F, device="cpu")
    of_j = LTI_OF(m_j.A, m_j.B, m_j.E, C, F)
    assert (of_t.ny, of_t.nv) == (of_j.ny, of_j.nv) == (2, 2)
    np.testing.assert_array_equal(of_t.C.numpy(), of_j.C)
    ofv_t, ofv_j = LTV_OFT(p_t, 6), LTV_OF(p_j, 6)
    assert ofv_t.C_stack.shape == ofv_j.C_stack.shape == (7, 4, 4)
    assert ofv_t.F_stack.shape == ofv_j.F_stack.shape == (7, 4, 4)


def test_integrator_matches_jax():
    m_t, m_j = IntegratorT(order=3, device="cpu"), Integrator(order=3)
    for k in ("nx", "nu", "nw", "ni", "ni_f", "dt"):
        assert getattr(m_t, k) == getattr(m_j, k), k
    for k in ("G", "g", "Gf", "gf", "E"):
        np.testing.assert_array_equal(getattr(m_t, k).numpy(), np.asarray(getattr(m_j, k)), k)
    rng = np.random.default_rng(4)
    x, u = rng.standard_normal((4, 3)), rng.standard_normal((4, 1))
    xt, ut = torch.as_tensor(x), torch.as_tensor(u)
    np.testing.assert_allclose(m_t.ode(xt, ut).numpy(),
                               np.asarray(m_j.ode(jnp.asarray(x), jnp.asarray(u))), atol=1e-14)
    np.testing.assert_allclose(m_t.ddyn(xt, ut).numpy(),
                               np.asarray(m_j.ddyn(jnp.asarray(x), jnp.asarray(u))), atol=1e-14)
    A_t, B_t = m_t.linearize(xt[0], ut[0])
    A_j, B_j = m_j.linearize(jnp.asarray(x[0]), jnp.asarray(u[0]))
    np.testing.assert_allclose(A_t.numpy(), np.asarray(A_j), atol=1e-14)
    np.testing.assert_allclose(B_t.numpy(), np.asarray(B_j), atol=1e-14)


# ----------------------------------------------------------------------
# densify, unpack_primal, native backend (test_qp_export.py, test_native_qp.py)
# ----------------------------------------------------------------------
def _to_port(stat, data):
    """A JAX (QPStatics, QPData) of one QP -> the port's, batch of one."""
    t = lambda a: torch.as_tensor(np.asarray(a))
    return (QPStaticsT(*(t(a) for a in stat)), QPDataT(*(t(a)[None] for a in data)))


def test_densify_and_export_match_jax(tmp_path):
    from scipy.io import loadmat

    stat, data = random_qp(seed=3)
    stat_t, data_t = _to_port(stat, data)
    sol = solve_qp_t(stat_t, data_t, IPMOptionsT(max_iter=50, tol=1e-10))
    assert bool(sol.success[0])
    d = export_t.densify(stat_t, data_t)
    ref = export_j.densify(stat, data)
    assert d.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(d[k], ref[k], err_msg=k)
    y = pack_t(sol.X, sol.U)[0].numpy()
    assert np.max(np.abs(d["Aeq"] @ y - d["beq"])) < 1e-7
    assert np.max(d["A"] @ y - d["b"]) < 1e-7
    np.testing.assert_allclose(0.5 * y @ d["H"] @ y + d["f"] @ y, float(sol.cost[0]),
                               rtol=1e-9, atol=1e-9)
    back = loadmat(export_t.export_quadprog(stat_t, data_t, sol, out_dir=str(tmp_path)))
    np.testing.assert_array_equal(back["H"], d["H"])
    np.testing.assert_allclose(back["x_traj"], sol.X[0].numpy())
    # one QP at a time: a batch of two is refused, here and by the native solver
    two = QPDataT(*(torch.cat([t, t]) for t in data_t))
    with pytest.raises(ValueError, match="batch of 2"):
        export_t.densify(stat_t, two)
    with pytest.raises(ValueError, match="batch of 2"):
        native_t.qp_solve_native(stat_t, two)


def test_unpack_primal_matches_jax():
    rng = np.random.default_rng(5)
    N, nx, nu = 4, 3, 2
    y = rng.standard_normal((2, (nx + nu) * N + nx))
    X, U = unpack_t(torch.as_tensor(y), N, nx, nu)
    for b in range(2):
        Xj, Uj = unpack_j(jnp.asarray(y[b]), N, nx, nu)
        np.testing.assert_array_equal(X[b].numpy(), np.asarray(Xj))
        np.testing.assert_array_equal(U[b].numpy(), np.asarray(Uj))
    np.testing.assert_array_equal(pack_t(X, U).numpy(), y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_matches_torch_and_jax_native(seed, gpp):
    stat, data = random_qp(seed=seed)
    stat_t, data_t = _to_port(stat, data)
    tsol = solve_qp_t(stat_t, data_t, IPMOptionsT(max_iter=50, tol=1e-10))
    nsol = native_t.qp_solve_native(stat_t, data_t, max_iter=50, tol=1e-10)
    assert bool(tsol.success[0]) and nsol["success"]
    np.testing.assert_allclose(nsol["X"], tsol.X[0].numpy(), atol=1e-7)
    np.testing.assert_allclose(nsol["U"], tsol.U[0].numpy(), atol=1e-7)
    np.testing.assert_allclose(nsol["lam"], tsol.lam[0].numpy(), atol=1e-6)
    np.testing.assert_allclose(nsol["cost"], float(tsol.cost[0]), rtol=1e-9)
    jsol = native_j(stat, data, max_iter=50, tol=1e-10)
    for k in ("X", "U", "lam", "lam_f", "nu_dyn"):
        np.testing.assert_array_equal(nsol[k], jsol[k], err_msg=k)


def test_native_tight_constraints(gpp):
    stat, data = random_qp(seed=7, feasible_margin=-0.05)
    data = data._replace(h=jnp.maximum(data.h, 0.05), hf=jnp.maximum(data.hf, 0.05))
    stat_t, data_t = _to_port(stat, data)
    tsol = solve_qp_t(stat_t, data_t, IPMOptionsT(max_iter=50, tol=1e-10))
    nsol = native_t.qp_solve_native(stat_t, data_t)
    assert nsol["success"]
    np.testing.assert_allclose(nsol["U"], tsol.U[0].numpy(), atol=1e-6)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build raises; nothing falls back to another backend."""
    bad = tmp_path / "rnm_qp.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native_t, "_SRC", bad)
    monkeypatch.setattr(native_t, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_t, "_LIB", tmp_path / "build" / "librnm_qp.so")
    monkeypatch.setattr(native_t, "_lib", None)
    with pytest.raises((RuntimeError, OSError)):
        native_t.load()
    m_t, _ = _lti_pair()
    qp = QPT(6, np.eye(2), 0.1 * np.eye(1), m_t, 5 * np.eye(2), backend="native")
    with pytest.raises((RuntimeError, OSError)):
        qp.solve(X0)

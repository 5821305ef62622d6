"""The port's figures against the JAX package's, under Agg, on the same
synthetic npz: the number of axes, the lines and collections of each axis,
and the labels, legends and titles. Also the plot helpers, the Euler
conversions (1e-12), the rocket's bounds and its trajectory I/O (an npz
written by one package reads back identically in the other), and the timing
helpers."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from threadpoolctl import threadpool_limits  # noqa: E402
import torch  # noqa: E402

from robust_nonlinear_mpc_torch.expe import _common as common_t  # noqa: E402
from robust_nonlinear_mpc_torch.expe import main_pendulum_robust_closed_loop as pend_t  # noqa: E402
from robust_nonlinear_mpc_torch.expe import main_quadrotor_robust_closed_loop as quad_t  # noqa: E402
from robust_nonlinear_mpc_torch.expe import main_rocket_compare_closed_loop as cmp_t  # noqa: E402
from robust_nonlinear_mpc_torch.expe import main_rocket_robust_closed_loop as rocket_t  # noqa: E402
from robust_nonlinear_mpc_torch.models.pendulum import Pendulum as PendulumT  # noqa: E402
from robust_nonlinear_mpc_torch.models.rocket import Rocket as RocketT  # noqa: E402
from robust_nonlinear_mpc_torch.utils import plotting as plot_t  # noqa: E402
from robust_nonlinear_mpc_torch.utils import quaternion as quat_t  # noqa: E402
from robust_nonlinear_mpc_torch.utils import timing as timing_t  # noqa: E402
from robust_nonlinear_mpc_tpu.expe import main_pendulum_robust_closed_loop as pend_j  # noqa: E402
from robust_nonlinear_mpc_tpu.expe import main_quadrotor_robust_closed_loop as quad_j  # noqa: E402
from robust_nonlinear_mpc_tpu.expe import main_rocket_compare_closed_loop as cmp_j  # noqa: E402
from robust_nonlinear_mpc_tpu.expe import main_rocket_robust_closed_loop as rocket_j  # noqa: E402
from robust_nonlinear_mpc_tpu.models import Pendulum as PendulumJ  # noqa: E402
from robust_nonlinear_mpc_tpu.models import Rocket as RocketJ  # noqa: E402
from robust_nonlinear_mpc_tpu.utils import plotting as plot_j  # noqa: E402
from robust_nonlinear_mpc_tpu.utils import quaternion as quat_j  # noqa: E402


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


@pytest.fixture(autouse=True)
def _close_all():
    yield
    plt.close("all")


def _axis(ax):
    """What a figure's axis shows: its lines (style, data), collections,
    labels, title and legend texts."""
    legend = ax.get_legend()
    return {
        "lines": [(l.get_linestyle(), l.get_label(), np.asarray(l.get_xydata()).round(12).tolist())
                  for l in ax.get_lines()],
        "collections": len(ax.collections),
        "labels": (ax.get_xlabel(), ax.get_ylabel(), ax.get_title()),
        "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        "legends": len(ax.findobj(matplotlib.legend.Legend)),
    }


def _same_figure(got, ref):
    """Two figures (or sequences of axes) show the same things."""
    axes = lambda f: list(f.get_axes()) if hasattr(f, "get_axes") else list(np.ravel(f))
    a, b = axes(got), axes(ref)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert _axis(x) == _axis(y), f"axis {i}"
    if hasattr(got, "_suptitle") and got._suptitle is not None:
        assert got._suptitle.get_text() == ref._suptitle.get_text()


def test_plot_helpers_match_jax():
    x = np.linspace(-1.0, 5.0, 7)
    np.testing.assert_array_equal(plot_t.affine_to_unit(x, 0.0, 4.0),
                                  plot_j.affine_to_unit(x, 0.0, 4.0))
    np.testing.assert_array_equal(plot_t.halfwidth_to_unit(x, 0.0, 4.0),
                                  plot_j.halfwidth_to_unit(x, 0.0, 4.0))
    assert np.isfinite(plot_t.affine_to_unit(np.array([1.0]), 2.0, 2.0)).all()
    np.testing.assert_array_equal(plot_t.rectangle_coordinates((1.0, 2.0), 3.0, 4.0),
                                  plot_j.rectangle_coordinates((1.0, 2.0), 3.0, 4.0))
    t = np.linspace(0, 1, 6)
    figs = []
    for mod in (plot_t, plot_j):
        fig, ax = plt.subplots()
        mod.draw_alpha_gradient_tube(ax, t, -np.ones_like(t), np.ones_like(t), "C0",
                                     a_start=0.4, a_end=0.1)
        ax.plot([0, 1], [0, 1], label="a (robust)")
        ax.plot([0, 1], [1, 0], "--", label="a (soft)")
        mod.compact_dual_legend(ax)
        mod.plot_nominal_trajectory(np.vstack([t, t ** 2]), dt=0.1, labels=["p", "q"])
        mod.plot_tube(0.1 * np.ones((2, 6)), np.vstack([t, t ** 2]), dt=0.1)
        figs.append(fig)
    _same_figure(*figs)
    alphas = [[p.get_alpha() for p in f.get_axes()[0].collections] for f in figs]
    assert alphas[0] == alphas[1] and alphas[0][0] > alphas[0][-1] > 0


def test_rocket_grouped_plots_match_jax():
    m_t, m_j = RocketT(device="cpu"), RocketJ()
    for lb_t, lb_j in zip(m_t.state_bounds(), m_j.state_bounds()):
        np.testing.assert_array_equal(lb_t, lb_j)
    T = 8
    rng = np.random.default_rng(0)
    X = 0.1 * rng.standard_normal((m_j.nx, T))
    Bo = np.abs(0.05 * rng.standard_normal((m_j.nx, T)))
    U = 0.1 * rng.standard_normal((m_j.nu, T - 1))
    _same_figure(m_t.plot_state_tube(Bo, X), m_j.plot_state_tube(Bo, X))
    _same_figure(m_t.plot_normalized_state_tube_with_constraints(X, Bo),
                 m_j.plot_normalized_state_tube_with_constraints(X, Bo))
    _same_figure(m_t.plot_states_constraints(10), m_j.plot_states_constraints(10))
    # a (T, nx) tensor is taken as well as an (nx, T) array
    _same_figure(m_t.plot_state_trajectory(torch.as_tensor(X.T), U),
                 m_j.plot_state_trajectory(X, U))


def test_pendulum_plots_match_jax():
    p_t, p_j = PendulumT(device="cpu"), PendulumJ()
    rng = np.random.default_rng(1)
    X, U = rng.standard_normal((4, 9)), rng.standard_normal(8)
    for name, args in (("plot_nominal_trajectory", (X,)), ("plot_input_nominal_trajectory", (U,)),
                       ("plot_tube", (0.1 * np.abs(X), X)),
                       ("plot_input_tube", (0.1 * np.abs(U), U))):
        _same_figure(getattr(p_t, name)(*args), getattr(p_j, name)(*args))


def _closed_loop_npz(nx, nu, N=5, T=7, seed=1):
    """A synthetic closed-loop run with the reference's npz keys."""
    rng = np.random.default_rng(seed)
    return {
        "state_trajectory": 0.1 * rng.standard_normal((nx, T)),
        "input_trajectory": 0.1 * rng.standard_normal((nu, T - 1)),
        "nominal_trajectory_x": 0.1 * rng.standard_normal((nx, N + 1, T)),
        "nominal_trajectory_u": 0.1 * rng.standard_normal((nu, N, T)),
        "backoff_trajectory_x": np.abs(0.02 * rng.standard_normal((nx, N + 1, T))),
        "backoff_trajectory_u": np.abs(0.02 * rng.standard_normal((nu, N, T))),
        "dt": 0.05, "nx": nx, "nu": nu, "simulation_time_steps": T, "N": N,
    }


def test_rocket_closed_loop_figure_matches_jax(tmp_path, monkeypatch):
    res = _closed_loop_npz(17, 4, T=4)
    res["g"] = np.asarray(RocketJ().g)
    folder = str(tmp_path / "rocket_run")
    common_t.save_results(folder, "rockETH_robust_closed_loop", res)
    monkeypatch.setattr(rocket_t, "FOLDER", folder)
    monkeypatch.setattr(rocket_j, "FOLDER", folder)
    got = rocket_t.plot(tube_frequency=3, show=False)
    ref = rocket_j.plot(tube_frequency=3, show=False)
    assert len(got.get_axes()) == 6
    _same_figure(got, ref)
    import os

    for ext in ("pdf", "png"):
        assert os.path.exists(os.path.join(folder, f"trajectory_plot_closed_loop.{ext}"))


@pytest.mark.parametrize("system", ["pendulum", "quadrotor"])
def test_closed_loop_cli_figures_match_jax(system, tmp_path, monkeypatch):
    """The pendulum and quadrotor CLIs without --run: `plot_closed_loop`."""
    nx, nu = (4, 1) if system == "pendulum" else (13, 4)
    folder = str(tmp_path / system)
    common_t.save_results(folder, "run", _closed_loop_npz(nx, nu))
    mod_t, mod_j = (pend_t, pend_j) if system == "pendulum" else (quad_t, quad_j)
    monkeypatch.setattr(mod_t, "FOLDER", folder)
    monkeypatch.setattr(mod_j, "FOLDER", folder)
    import robust_nonlinear_mpc_tpu.expe._common as common_j

    got = mod_t.plot(show=False)
    ref = common_j.plot_closed_loop(folder, show=False)
    _same_figure(got, ref)
    assert common_t.plot_closed_loop(str(tmp_path / "empty"), show=False) is None


def test_compare_figures_match_jax(tmp_path, monkeypatch):
    T = 7
    rng = np.random.default_rng(2)
    res = {}
    for tag in ("r", "s"):
        res[f"{tag}_state_trajectory"] = 0.1 * rng.standard_normal((17, T))
        res[f"{tag}_input_trajectory"] = 0.1 * rng.standard_normal((4, T - 1))
    res.update({"dt": 0.05, "g": np.asarray(RocketJ().g), "nx": 17, "nu": 4,
                "simulation_time_steps": T, "N": 5, "Jr_total": 1.0, "Js_total": 2.0})
    folder = str(tmp_path / "cmp_run")
    common_t.save_results(folder, "rockETH_compare_closed_loop", res)
    monkeypatch.setattr(cmp_t, "FOLDER", folder)
    monkeypatch.setattr(cmp_j, "FOLDER", folder)
    _same_figure(cmp_t.plot(show=False), cmp_j.plot(show=False))
    got, ref = cmp_t.plot_vel_omega_inputs(show=False), cmp_j.plot_vel_omega_inputs(show=False)
    _same_figure(got, ref)
    for ax in got.get_axes():
        assert len(ax.findobj(matplotlib.legend.Legend)) == 2


def test_euler_conversions_match_jax():
    rng = np.random.default_rng(3)
    rpy = rng.uniform(-1.5, 1.5, (5, 3))
    q_t = quat_t.euler_to_quaternion(*(torch.as_tensor(rpy[:, i]) for i in range(3)))
    q_j = np.asarray(quat_j.euler_to_quaternion(rpy[:, 0], rpy[:, 1], rpy[:, 2]))
    np.testing.assert_allclose(q_t.numpy(), q_j, atol=1e-12)
    np.testing.assert_allclose(quat_t.quaternion_to_euler(q_t).numpy(),
                               np.asarray(quat_j.quaternion_to_euler(q_j)), atol=1e-12)
    np.testing.assert_allclose(quat_t.quaternion_to_euler(q_t).numpy(), rpy, atol=1e-12)
    # numbers are taken as float64, and a leading shape is kept
    q1 = quat_t.euler_to_quaternion(0.1, 0.2, 0.3)
    assert q1.dtype == torch.float64 and q1.shape == (4,)
    np.testing.assert_allclose(q1.numpy(), np.asarray(quat_j.euler_to_quaternion(0.1, 0.2, 0.3)),
                               atol=1e-12)
    q2 = torch.as_tensor(np.array(q_j).reshape(5, 1, 4))
    assert quat_t.quaternion_to_euler(q2).shape == (5, 1, 3)


def test_rocket_trajectory_round_trip(tmp_path):
    m_t, m_j = RocketT(device="cpu"), RocketJ()
    rng = np.random.default_rng(4)
    X, U = rng.standard_normal((17, 6)), rng.standard_normal((4, 5))
    p_t = m_t.save_trajectory(str(tmp_path / "torch"), torch.as_tensor(X), U, tag=np.array(3))
    p_j = m_j.save_trajectory(str(tmp_path / "jax"), X, U, tag=np.array(3))
    for path in (p_t, p_j):
        assert path.split("/")[-1].startswith("rocket_trajectory_")
        for m in (m_t, m_j):
            back = m.load_trajectory(path)
            assert sorted(back) == ["U", "X", "dt", "tag"]
            np.testing.assert_array_equal(back["X"], X)
            np.testing.assert_array_equal(back["U"], U)
            assert float(back["dt"]) == m_j.dt
    # a folder reads its newest file
    np.testing.assert_array_equal(m_j.load_trajectory(str(tmp_path / "torch"))["X"], X)
    np.testing.assert_array_equal(m_t.load_trajectory(str(tmp_path / "jax"))["U"], U)


def test_timing_helpers(tmp_path):
    calls = []
    out, sec = timing_t.timed(lambda a: calls.append(a) or a + 1, 1, reps=3, warmup=2)
    assert out == 2 and len(calls) == 5 and sec >= 0.0
    with timing_t.trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert (tmp_path / "trace" / "trace.json").is_file()

"""PyTorch port: the RTI step in the form a CUDA graph captures (float64,
CPU), the rocket at N = 4, B = 3.

* A dispatch mode that raises on every op which reads the device from the
  host or copies host data to it (`_local_scalar_dense`, `is_nonzero`,
  `nonzero`, `masked_select`, boolean-mask indexing, `lift_fresh`) stops
  the eager step in `solve_qp`'s early exit, and lets the step run inside
  `no_host_sync()` in each bench configuration (default, fused-kernel,
  sls_block = -1): the step holds no host read a graph could not replay.
* `solve_qp` inside `no_host_sync()` against the eager loop, bit for bit,
  and against the JAX `vmap(solve_qp)` (identical iterations, X/U within
  1e-10), with per-lane caps: lanes that stop early and a lane that runs to
  its cap.
* `make_mpc_scan` inside `no_host_sync()` against K eager steps, exactly,
  and against the JAX `lax.scan` of the vmapped `make_mpc_step` at
  tests/test_torch_slice.py's tolerances (1e-7).
* `capture_mpc_step` and `tools/latency_probe` raise without a card; the
  bench's slope helper gives None for a slope that is not positive.
"""

import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import robust_nonlinear_mpc_torch.interop as interop
from robust_nonlinear_mpc_torch import bench
from robust_nonlinear_mpc_torch.ops import qp_ipm as tq
from robust_nonlinear_mpc_torch.sim.closed_loop import (
    capture_mpc_step,
    make_mpc_scan,
)
from robust_nonlinear_mpc_torch.sim.closed_loop import make_mpc_step as t_make_mpc_step
from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist as TPersist
from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve as t_sqp
from robust_nonlinear_mpc_torch.utils.batch import tree_leaves
from robust_nonlinear_mpc_torch.utils.host_sync import no_host_sync
from robust_nonlinear_mpc_torch.utils.stages import timed
from robust_nonlinear_mpc_tpu.expe.main_rocket_robust_closed_loop import X0, make_rocket_problem
from robust_nonlinear_mpc_tpu.ops import qp_ipm as jq
from robust_nonlinear_mpc_tpu.ops.qp_ipm import IPMOptions
from robust_nonlinear_mpc_tpu.sim.closed_loop import make_mpc_step
from robust_nonlinear_mpc_tpu.solvers.fast_sls import FastSLSPersist

torch.set_num_threads(1)
N, Bsz, K, TOL = 4, 3, 3, 1e-7
aten = torch.ops.aten


def assert_same(a, b):
    """Equal bit for bit, NaN where the other has NaN, over two trees."""
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


class HostRead(RuntimeError):
    pass


class HostReadProbe(TorchDispatchMode):
    """Raises on an op that reads a tensor's value on the host or makes a
    tensor from host data (on the card: a synchronization or a copy from
    host memory, which a captured graph cannot replay)."""

    OPS = {aten._local_scalar_dense.default, aten.is_nonzero.default, aten.nonzero.default,
           aten.masked_select.default, aten.lift_fresh.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            raise HostRead(str(func))
        if func is aten.index.Tensor and any(
                t is not None and t.dtype == torch.bool for t in args[1]):
            raise HostRead(f"{func} with a boolean mask")
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def workloads():
    size = dict(device="cpu", dtype=torch.float64, B=Bsz, N=N, n_warm=1, n_rep=1)
    base = bench.build_workload(**size)
    return {
        "default": base,
        "fused-kernel": bench.build_workload(**size, kkt="fused_iter", response="fused",
                                             seed_from=base),
        "K3": bench.build_workload(**size, sls_block=-1, seed_from=base),
    }


def test_probe_stops_the_eager_step_in_solve_qp(workloads):
    wl = workloads["default"]
    with pytest.raises(HostRead) as exc, HostReadProbe():
        wl.mpc_step(wl.carry, wl.w_seq[0])
    frames = traceback.extract_tb(exc.value.__traceback__)
    assert any(f.filename.endswith("ops/qp_ipm.py") and f.name == "solve_qp" for f in frames)


@pytest.mark.parametrize("config", ["default", "fused-kernel", "K3"])
def test_no_sync_step_makes_no_host_read(workloads, config):
    """The step inside no_host_sync() under the probe, inside a timed()
    block (stages neither sync nor record there), equals the eager step."""
    wl = workloads[config]
    with no_host_sync(), timed() as rec, HostReadProbe():
        carry, out = wl.mpc_step(wl.carry, wl.w_seq[0])
    assert not rec
    assert_same((carry, out), wl.mpc_step(wl.carry, wl.w_seq[0]))
    assert out[6].all()


CAP = [15, 2, 15]


@pytest.fixture(scope="module")
def rocket_qps(workloads):
    """The default workload's deviation QPs at its seed, and the JAX
    `vmap(solve_qp)` of them with the per-lane caps CAP."""
    wl = workloads["default"]
    X, U, _, x0 = wl.carry
    A, B, c, qx, qu, g_res, gf_res, xd = wl.solver.assemble_deviation_problem(X, U, x0)
    data = tq.QPData(A=A, B=B, c=c, qx=qx, qu=qu, h=g_res, hf=gf_res, xinit=xd)
    stat = wl.solver.prob.stat
    js = jq.QPStatics(**{k: jnp.asarray(v.numpy()) for k, v in stat._asdict().items()})
    jd = jq.QPData(**{k: jnp.asarray(v.numpy()) for k, v in data._asdict().items()})
    jopts = jq.IPMOptions(max_iter=15, tol=1e-9)
    ref = jax.jit(jax.vmap(lambda d, c: jq.solve_qp(js, d, jopts, max_iter_dyn=c)))(
        jd, jnp.asarray(CAP, jnp.int32))
    return stat, data, ref


@pytest.mark.parametrize("kkt", ["riccati", "fused", "fused_iter"])
def test_no_sync_solve_qp_matches_eager_and_jax(rocket_qps, kkt):
    stat, data, ref = rocket_qps
    opts = tq.IPMOptions(max_iter=15, tol=1e-9, kkt=kkt)
    cap = torch.tensor(CAP, dtype=torch.int32)
    eager = tq.solve_qp(stat, data, opts, max_iter_dyn=cap)
    with no_host_sync(), HostReadProbe():
        got = tq.solve_qp(stat, data, opts, max_iter_dyn=cap, max_iter_bound=15)
        with pytest.raises(ValueError, match="max_iter_bound"):
            tq.solve_qp(stat, data, opts, max_iter_dyn=cap)
    assert_same(got, eager)
    # lanes 0 and 2 stop early, lane 1 runs to its cap
    assert got.iters[1] == 2 and not got.success[1]
    assert 2 < got.iters[0] < 15 and 2 < got.iters[2] < 15 and got.success[[0, 2]].all()
    assert got.iters.tolist() == np.asarray(ref.iters).tolist()
    assert got.success.tolist() == np.asarray(ref.success).tolist()
    for f in ("X", "U"):
        assert np.abs(getattr(got, f).numpy() - np.asarray(getattr(ref, f))).max() <= 1e-10, f


@pytest.fixture(scope="module")
def scan_setup():
    """The JAX problem in the bench's configuration (the fused Newton solves:
    JAX "pallas", the port's "fused" on its plain twins) and the port's
    solver built from it; the SQP seed is the port's."""
    m, solver = make_rocket_problem(N=N)
    solver.opts = solver.opts._replace(
        verbose=False,
        ipm=IPMOptions(max_iter=15, tol=3e-5, kkt="pallas"),
        adaptive_ipm_budget=(6, 15),
        ipm_first=IPMOptions(max_iter=8, tol=1e-3, kkt="pallas"),
        streaming_response=True, recycle_eta=True, recycle_warm_qp=True, sls_block=0,
    )
    d = dict(N=N, Q=solver.Q, R=solver.R, Qf=solver.Qf, Q_reg=solver.Q_reg,
             R_reg=solver.R_reg, Q_reg_f=solver.Q_reg_f, E=m.E, dt=m.dt,
             options=interop.options_to_plain(solver.opts))
    tsolver = interop.solver_from_numpy(d, device="cpu")
    rng = np.random.default_rng(3)
    x0s = torch.as_tensor(np.array(X0)[None] + 0.02 * rng.standard_normal((Bsz, m.nx)))
    nom = t_sqp(tsolver.m, N, tsolver.Q, tsolver.R, tsolver.Qf, x0s)
    assert nom.success.all()
    W = rng.uniform(-1.0, 1.0, (K, Bsz, m.nw))
    return m, solver, tsolver, nom, x0s, W


def test_no_sync_scan_matches_eager_steps_and_jax_scan(scan_setup):
    m, solver, tsolver, nom, x0s, W = scan_setup
    tm = tsolver.m
    persist = TPersist.init(N, tm.nx, tm.nu, tm.ni, tm.ni_f, tm.nw, batch=Bsz,
                            dtype=torch.float64, device="cpu", store_phi=False)
    carry0, tW = (nom.X, nom.U, persist, x0s), torch.as_tensor(W)
    with no_host_sync(), HostReadProbe():
        carry, outs = make_mpc_scan(tsolver)(carry0, tW)
    assert outs[0].shape == (K, Bsz, tm.nx)

    # K eager steps give the same carry and outs, bit for bit
    tstep, c = t_make_mpc_step(tsolver), carry0
    for k in range(K):
        c, out = tstep(c, tW[k])
        assert_same(out, tuple(o[k] for o in outs))
    assert_same(c, carry)

    # the JAX lax.scan of the vmapped step, from the same seed
    jp = FastSLSPersist.init(N, m.nx, m.nu, m.ni, m.ni_f, m.nw, jnp.float64, store_phi=False)
    jp = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a[None], (Bsz,) + a.shape), jp)
    jcarry = (jnp.asarray(nom.X.numpy()), jnp.asarray(nom.U.numpy()), jp,
              jnp.asarray(x0s.numpy()))
    step = jax.vmap(make_mpc_step(solver))
    _, ref = jax.jit(lambda c, W: jax.lax.scan(step, c, W))(jcarry, jnp.asarray(W))
    assert outs[6].tolist() == np.asarray(ref[6]).tolist()
    assert outs[7].tolist() == np.asarray(ref[7]).tolist()
    for j, name in {1: "u0", 2: "X", 3: "U", 4: "backoff_x", 5: "backoff_u"}.items():
        err = np.abs(outs[j].numpy() - np.asarray(ref[j])).max()
        assert err <= TOL, f"{name}: {err:.3e}"


def test_capture_and_latency_probe_need_a_card(workloads, monkeypatch):
    from robust_nonlinear_mpc_torch.tools import latency_probe

    wl = workloads["default"]
    with pytest.raises(RuntimeError, match="captures a CUDA graph"):
        capture_mpc_step(wl.solver, wl.carry)
    rti = wl.solver.opts.rti
    try:
        wl.solver.opts = wl.solver.opts._replace(rti=-1)
        with pytest.raises(ValueError, match="RTI step"):
            capture_mpc_step(wl.solver, wl.carry)
    finally:
        wl.solver.opts = wl.solver.opts._replace(rti=rti)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        latency_probe.main(n_steps=1)


def test_device_step_slope():
    assert bench.device_step_slope({1: 10.0, 8: 17.0}) == pytest.approx(1.0)
    assert bench.device_step_slope({1: 10.0, 8: 10.0}) is None
    assert bench.device_step_slope({1: 10.0, 8: 9.0}) is None

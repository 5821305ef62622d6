"""PyTorch port: the Monte-Carlo validation driver and the bench twin's
record, against the JAX package (float64, CPU).

* `main_monte_carlo_validation.generate` on the pendulum, converged, B = 4
  lanes, 2 steps, from the same seed: the artifact has the JAX artifact's
  keys and tag, the per-(lane, step) masks (success, scp_failed, tube
  misses, violations on success) and the SCP iteration counts are equal,
  and the statistics agree within 1e-8. The JAX driver runs on a one-device
  mesh, as the port runs on one card.
* `lane_reductions` masks a NaN-poisoned lane out of every aggregate.
* The bench twin's record, built from a stub workload (no card), has every
  key of the record of the repository's `bench.py`.
* The port's copies of `sim/io` and `expe/_common` read back what they
  write.
"""

import ast
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from robust_nonlinear_mpc_torch.expe import main_monte_carlo_validation as tmc
from robust_nonlinear_mpc_torch.parallel.mc import lane_reductions
from robust_nonlinear_mpc_torch.sim.closed_loop import ClosedLoopLog

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def test_mc_driver_matches_jax(tmp_path, monkeypatch):
    import robust_nonlinear_mpc_tpu.expe.main_monte_carlo_validation as jmc
    import robust_nonlinear_mpc_tpu.parallel.mesh as jmesh

    one = jmesh.scenario_mesh(1)
    monkeypatch.setattr(jmesh, "scenario_mesh", lambda *a, **k: one)
    monkeypatch.setattr(jmc, "FOLDER", str(tmp_path / "jax"))
    monkeypatch.setattr(tmc, "FOLDER", str(tmp_path / "torch"))
    kw = dict(scenarios=4, steps=2, seed=0, converged=True)
    ref_path = jmc.generate("pendulum", device="cpu", host_devices=1, **kw)
    got_path = tmc.generate("pendulum", device="cpu", **kw)
    assert Path(ref_path).name.split("_20")[0] == Path(got_path).name.split("_20")[0]
    ref, got = np.load(ref_path, allow_pickle=True), np.load(got_path, allow_pickle=True)
    assert sorted(got.files) == sorted(ref.files)
    assert float(got["success_rate"]) == 1.0
    for k in ref.files:
        r, g = ref[k], got[k]
        if r.dtype.kind in "bOUi" or k.endswith("_mask"):
            assert np.array_equal(g, r), k
        else:
            np.testing.assert_allclose(g, r, rtol=1e-8, atol=1e-8, err_msg=k)


def test_lane_reductions_mask_failed_lanes():
    B, T, nx, nu = 3, 4, 2, 1
    xs = torch.zeros((B, T, nx), dtype=torch.float64)
    us = torch.zeros((B, T - 1, nu), dtype=torch.float64)
    xs[1, 2] = float("nan")                 # lane 1's trajectory is lost
    xs[2, 1, 0] = 2.0                       # lane 2 violates x0 <= 1
    succ = torch.ones((B, T), dtype=torch.bool)
    logs = ClosedLoopLog(xs, us, None, None, None, None, succ, None)
    G = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)
    g = torch.tensor([1.0], dtype=torch.float64)
    ok, worst, cost = lane_reductions(logs, G, g, torch.eye(nx, dtype=torch.float64),
                                      torch.eye(nu, dtype=torch.float64))
    assert ok.tolist() == [True, False, True]
    assert worst.tolist() == [-1.0, -1.0, 1.0]
    assert float(cost[2]) == 4.0


def _reference_record_keys():
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no `result = {...}` record")


def test_bench_record_has_every_reference_key():
    from robust_nonlinear_mpc_torch import bench

    ref_keys = _reference_record_keys()
    assert {"vs_baseline", "flops_per_solve", "variance_note"} <= ref_keys
    wl = SimpleNamespace(
        B=512, n_rep=10, n_warm=30, dtype=torch.float32, budget_mode="adaptive(6,15)",
        response="streaming", sls_block=0, n_soft_fallback=0,
        m=SimpleNamespace(nx=17, nu=4, ni=42),
        solver=SimpleNamespace(N=15, opts=SimpleNamespace(ipm=SimpleNamespace(kkt="fused"))),
    )
    lats = [0.05 + 1e-4 * i for i in range(200)]
    rec = bench.make_record(
        wl, solves_per_s=2000.0, ok=torch.ones(512, dtype=torch.bool),
        qp_iters=torch.full((512,), 3), finite=True, lats=lats,
        launches={"factor_predictor": 7}, gpu=("stub", "stub", 700.0),
    )
    assert ref_keys <= set(rec), sorted(ref_keys - set(rec))
    assert rec["vs_baseline"] == 100.0
    assert rec["flop_source"] == "analytic_estimate"
    assert rec["single_step_latency_steps"] == 200
    assert rec["single_step_latency_max_ms"] == round(1e3 * lats[-1], 3)
    # the H100's ridge: 989 TFLOP/s bf16 over 3.35 TB/s
    assert rec["roofline_ridge_flop_per_byte"] == 295.0


def test_io_and_common_round_trip(tmp_path):
    from robust_nonlinear_mpc_torch.expe._common import load_latest, save_results
    from robust_nonlinear_mpc_torch.sim.io import load_trajectory, save_trajectory

    X, U = np.arange(6.0).reshape(2, 3), np.ones((1, 2))
    path = save_trajectory(str(tmp_path / "traj"), X, U, 0.05, prefix="rocket", note=np.int32(3))
    got = load_trajectory(str(tmp_path / "traj"), prefix="rocket")
    assert np.array_equal(got["X"], X) and np.array_equal(got["U"], U)
    assert float(got["dt"]) == 0.05 and int(got["note"]) == 3
    assert load_trajectory(path)["X"].shape == (2, 3)
    folder = str(tmp_path / "runs")
    assert load_latest(folder) is None
    path = save_results(folder, "mc_validation_pendulum", {"v": np.array([1.0])})
    assert Path(path).name.startswith("mc_validation_pendulum_20")
    assert float(load_latest(folder)["v"][0]) == 1.0


def test_driver_refuses_a_single_step(tmp_path, monkeypatch):
    """The statistics check (x_t, u_t) for t < T - 1: a one-step run has
    nothing to check, and the driver says so before it runs (JAX's driver
    fails on an empty reduction after the run)."""
    import pytest

    monkeypatch.setattr(tmc, "FOLDER", str(tmp_path))
    with pytest.raises(ValueError, match="at least 2 steps"):
        tmc.generate("pendulum", scenarios=2, steps=1, device="cpu", converged=True)

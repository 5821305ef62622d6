"""PyTorch port: the premise of holding the published guarantee rows lane by
lane (`expe/published_rows.py`). For the rocket, the quadrotor and the
pendulum, the port's `make_problem` and `draws` at B = 1024, seed 0
reproduce the published artifact's initial states
(`state_trajectories[:, 0]`, float32, 64 lanes) within 1e-6, and the
driver's command line of each row, parsed by the driver, runs with the
artifact's settings (`restoration`, `soft_fallback`, `qp_tol`,
`stall_damping`, `max_iter_scp_override`, `scenarios`, `steps`)."""

import numpy as np
import pytest
import torch

from robust_nonlinear_mpc_torch.expe import main_monte_carlo_validation as mc
from robust_nonlinear_mpc_torch.expe import published_rows as pr

torch.set_num_threads(1)
SETTINGS = ("restoration", "soft_fallback", "qp_tol", "stall_damping",
            "max_iter_scp_override", "scenarios", "steps", "converged")


@pytest.mark.parametrize("system", sorted(pr.ROWS))
def test_draws_reproduce_the_published_initial_states(system):
    pub = pr.published(system)
    m, _, x_center, x_spread = mc.make_problem(system, torch.device("cpu"), torch.float64)
    x0s, Ws = mc.draws(m, x_center, x_spread, pr.SCENARIOS, pr.STEPS, 0)
    stored = pub["state_trajectories"][:, 0]
    assert x0s.shape == (pr.SCENARIOS, m.nx) and Ws.shape == (pr.SCENARIOS, pr.STEPS, m.nw)
    assert np.abs(x0s[: len(stored)] - stored).max() <= 1e-6


@pytest.mark.parametrize("system", sorted(pr.ROWS))
def test_row_command_line_runs_the_published_settings(system, monkeypatch):
    pub = pr.published(system)
    seen = {}
    monkeypatch.setattr(mc, "generate", lambda *a, **kw: seen.update(pos=a, kw=kw))
    mc.main(pr.argv(system))
    (sys_, scenarios, steps, device, seed), kw = seen["pos"], seen["kw"]
    settings = mc.run_settings(scenarios=scenarios, steps=steps, **kw)
    assert (sys_, device, seed, kw["kkt"]) == (system, "cuda", 0, "fused")
    assert kw["draw_steps"] == steps == int(pub["steps"])
    for k in SETTINGS:
        assert settings[k] == pub[k].item(), k
    # the row's published figures, as ROWS states them
    row = pr.ROWS[system]
    assert row.success_rate == float(pub["success_rate"])
    assert row.violations_on_success == int(pub["n_violation_steps_on_success"])
    assert row.containment == float(pub["tube_containment_rate"])


def test_compare_holds_a_cut_run_lane_by_lane(tmp_path, monkeypatch):
    """Lanes 0 and 5 of the pendulum's row, the first 2 of its 10 steps, on
    the CPU (float64): `compare` finds the published success flags and
    stored states (within 1e-6 of the float32 copy), and nothing to settle."""
    monkeypatch.setattr(mc, "FOLDER", str(tmp_path))
    path = mc.main(pr.argv("pendulum", steps=2, device="cpu", extra=["--lanes", "0,5"]))
    got = np.load(path)
    assert got["lanes"].tolist() == [0, 5] and int(got["scenarios"]) == 2
    c = pr.compare(path)
    assert (c["B"], c["T"], c["success_flags_differing"]) == (2, 2, 0)
    assert c["states_compared"] == 4 and c["states_max_abs_diff"] <= 1e-6
    assert c["violations"] == c["tube_misses"] == [] and pr.settle_lanes(c) == []

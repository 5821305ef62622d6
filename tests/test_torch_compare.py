"""The robust-vs-soft rocket comparison CLI
(`expe/main_rocket_compare_closed_loop.py`) against the JAX package's,
float64 on the CPU: X/U within 1e-6, as for the port's other nominal solvers
(ROADMAP.md section 3)."""

import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

from robust_nonlinear_mpc_torch.expe import main_rocket_compare_closed_loop as cmp_t
from robust_nonlinear_mpc_tpu.expe import main_rocket_compare_closed_loop as cmp_j

TOL = 1e-6


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


def test_compare_generate_matches_jax(tmp_path, monkeypatch):
    """The comparison CLI's `generate` at N = 4, T = 3 (float64, CPU): the
    same npz keys, trajectories within 1e-6, closed-loop costs within 1e-6
    relative."""
    monkeypatch.setattr(cmp_j, "FOLDER", str(tmp_path / "jax"))
    monkeypatch.setattr(cmp_t, "FOLDER", str(tmp_path / "torch"))
    ref = np.load(cmp_j.generate(4, 3))
    got = np.load(cmp_t.generate(4, 3, device="cpu"))
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, k
        if k.startswith("J"):
            np.testing.assert_allclose(a, b, rtol=TOL, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=k)
    assert np.all(np.isfinite(got["r_input_trajectory"]))


def test_compare_generate_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cmp_t.generate(6, 3)

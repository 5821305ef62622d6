"""PyTorch port on the GPU: the CUDA kernels against their plain torch
versions on the same card inputs (float64 to 1e-10, float32 to 1e-4,
relative to each output's largest entry): the fused Newton kernels and the
whole-iteration kernel at the main path's shape, a ragged batch and a long
horizon (the Newton kernels also at narrow inputs), the response kernel
(float32 only) at the main path's shape and a ragged batch, the SLS
backward kernel at the Newton kernels' cases.

Needs an NVIDIA GPU with nvcc (sm_90a); skipped elsewhere. On the card,
from the repository root:
    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def smoke():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import chip_smoke
    from robust_nonlinear_mpc_torch.ops import cuda_lib

    cuda_lib.build_extension()
    return chip_smoke


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Bsz,N,nu", [(512, 15, 4), (37, 15, 4), (8, 60, 4), (8, 15, 1), (8, 15, 2)])
def test_kernels_match_plain(smoke, Bsz, N, nu, dtype):
    for (kernel, output), (rel, _) in smoke.compare_kernels(Bsz, N, nu, dtype).items():
        assert rel <= smoke.TOL[dtype], f"{kernel} {output}: {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Bsz,N", [(512, 15), (37, 15), (8, 60)])
def test_ipm_iteration_matches_plain(smoke, Bsz, N, dtype):
    for (kernel, output), (rel, _) in smoke.compare_ipm(Bsz, N, dtype).items():
        assert rel <= smoke.TOL[dtype], f"{kernel} {output}: {rel:.3e}"


@pytest.mark.parametrize("Bsz", [512, 37])
def test_fused_response_matches_plain(smoke, Bsz):
    for (kernel, output), (rel, _) in smoke.compare_response(Bsz).items():
        assert rel <= smoke.TOL[torch.float32], f"{kernel} {output}: {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Bsz,N,nu", [(512, 15, 4), (37, 15, 4), (8, 60, 4), (8, 15, 1), (8, 15, 2)])
def test_backward_K_matches_plain(smoke, Bsz, N, nu, dtype):
    for (kernel, output), (rel, _) in smoke.compare_backward(Bsz, N, nu, dtype).items():
        assert rel <= smoke.TOL[dtype], f"{kernel} {output}: {rel:.3e}"


def test_cuda_launches_are_counted(smoke):
    from robust_nonlinear_mpc_torch import bench

    bench.reset_launch_counts()
    smoke.compare_kernels(4, 5, 2, torch.float64, nx=5)
    smoke.compare_ipm(4, 5, torch.float64)
    smoke.compare_response(3)
    smoke.compare_backward(3, 5, 2, torch.float64)
    assert bench.launch_counts() == {"factor_predictor": 1, "resolve": 1, "ipm_iteration": 1,
                                     "fused_response": 1, "backward_K": 1}

"""PyTorch port on the GPU: the fused Newton CUDA kernels against their plain
torch versions on the same card inputs (float64 to 1e-10, float32 to 1e-4,
relative to each output's largest entry), at the main path's shape, a
ragged batch, a long horizon and narrow inputs.

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
    from robust_nonlinear_mpc_torch.ops import fused_qp

    fused_qp.build_extension()
    return chip_smoke


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Bsz,N,nu", [(512, 15, 4), (37, 15, 4), (8, 60, 4), (8, 15, 1), (8, 15, 2)])
def test_kernels_match_plain(smoke, Bsz, N, nu, dtype):
    for (kernel, output), (rel, _) in smoke.compare_kernels(Bsz, N, nu, dtype).items():
        assert rel <= smoke.TOL[dtype], f"{kernel} {output}: {rel:.3e}"


def test_cuda_launches_are_counted(smoke):
    from robust_nonlinear_mpc_torch.ops import fused_qp

    fused_qp.reset_launch_counts()
    smoke.compare_kernels(4, 5, 2, torch.float64, nx=5)
    assert fused_qp.launch_counts() == {"factor_predictor": 1, "resolve": 1}

"""PyTorch port on the GPU: the CUDA kernels against their plain torch
versions on the same card inputs (float64 to 1e-10, float32 to 1e-4,
relative to each output's largest entry): the fused Newton kernels and the
whole-iteration kernel at the main path's shape, a ragged batch and a long
horizon (the Newton kernels also at narrow inputs), at a batch that leaves
the last wave part-filled and at the other models' widths and the general
(runtime-width) path; the response kernel (float32 only) and the SLS
backward kernel at the main path's shape, a ragged batch, a long horizon,
the same edges (K3 also at narrow inputs); the until-convergence closed
loop with every mitigation (chip_smoke phase 9a) on the card at B = 529 for
one step against the CPU on its first 16 lanes; the RTI step captured as
one CUDA graph against the eager step at B = 529 over 3 steps.

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


# (B, N, nx, nu): 529 lanes leave the last wave of one block per lane
# part-filled; the pendulum's (4, 1) and the quadrotor's (13, 4) widths are
# instantiated like the rocket's; nx = 7 and 32 take the general path
EDGES = [(529, 15, 17, 4), (8, 15, 4, 1), (8, 15, 7, 3), (8, 60, 7, 4), (8, 15, 13, 4),
         (8, 15, 32, 2)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Bsz,N,nx,nu", EDGES)
def test_kernels_match_plain_at_edges(smoke, Bsz, N, nx, nu, dtype):
    for (kernel, output), (rel, _) in smoke.compare_kernels(Bsz, N, nu, dtype, nx=nx).items():
        assert rel <= smoke.TOL[dtype], f"{kernel} {output}: {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Bsz,N,nx,nu", EDGES)
def test_ipm_iteration_matches_plain_at_edges(smoke, Bsz, N, nx, nu, dtype):
    # compare_ipm marks lane 1 done and makes lane 2's step non-finite, and
    # fails unless exactly lane 2 is reverted
    for (kernel, output), (rel, _) in smoke.compare_ipm(Bsz, N, dtype, nx=nx, nu=nu).items():
        assert rel <= smoke.TOL[dtype], f"{kernel} {output}: {rel:.3e}"


def test_one_wave_at_the_main_shape(smoke):
    # the redesign's occupancy budget: K1 and K6 keep B = 512 float32 in one wave
    from robust_nonlinear_mpc_torch.ops import cuda_lib

    for name in ("factor_predictor", "ipm_iteration"):
        info = cuda_lib.kernel_info(name, torch.float32, 512, 15, 17, 4, 42, 34)
        assert info["waves"] == 1, (name, info)


@pytest.mark.parametrize("Bsz", [512, 37])
def test_fused_response_matches_plain(smoke, Bsz):
    for (kernel, output), (rel, _) in smoke.compare_response(Bsz).items():
        assert rel <= smoke.TOL[torch.float32], f"{kernel} {output}: {rel:.3e}"


@pytest.mark.parametrize("Bsz,N,nx,nu", [(8, 60, 17, 4)] + EDGES)
def test_fused_response_matches_plain_at_edges(smoke, Bsz, N, nx, nu):
    for (kernel, output), (rel, _) in smoke.compare_response(Bsz, N, nx=nx, nu=nu).items():
        assert rel <= smoke.TOL[torch.float32], f"{kernel} {output}: {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Bsz,N,nu", [(512, 15, 4), (37, 15, 4), (8, 60, 4), (8, 15, 1), (8, 15, 2)])
def test_backward_K_matches_plain(smoke, Bsz, N, nu, dtype):
    for (kernel, output), (rel, _) in smoke.compare_backward(Bsz, N, nu, dtype).items():
        assert rel <= smoke.TOL[dtype], f"{kernel} {output}: {rel:.3e}"


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("Bsz,N,nx,nu", EDGES)
def test_backward_K_matches_plain_at_edges(smoke, Bsz, N, nx, nu, dtype):
    for (kernel, output), (rel, _) in smoke.compare_backward(Bsz, N, nu, dtype, nx=nx).items():
        assert rel <= smoke.TOL[dtype], f"{kernel} {output}: {rel:.3e}"


def test_redesigned_sls_kernels_fill_one_wave(smoke):
    # K3 and K4 run one block per lane, four lanes an SM in float32
    from robust_nonlinear_mpc_torch.ops import cuda_lib

    for name in ("backward_K", "fused_response"):
        info = cuda_lib.kernel_info(name, torch.float32, 512, 15, 17, 4, 42, 34)
        assert info["waves"] == 1, (name, info)


def test_cuda_launches_are_counted(smoke):
    from robust_nonlinear_mpc_torch import bench

    bench.reset_launch_counts()
    smoke.compare_kernels(4, 5, 2, torch.float64, nx=5)
    smoke.compare_ipm(4, 5, torch.float64)
    smoke.compare_response(3)
    smoke.compare_backward(3, 5, 2, torch.float64)
    assert bench.launch_counts() == {"factor_predictor": 1, "resolve": 1, "ipm_iteration": 1,
                                     "fused_response": 1, "backward_K": 1}


def test_converged_closed_loop_card_matches_cpu(smoke):
    # identical success, SCP, QP iterations and scp_failed; X/U and the
    # finite backoffs within 1e-8 (check_converged fails otherwise)
    smoke.check_converged(Bsz=529, steps=1, chunked=(), ref_lanes=16)


def test_captured_step_matches_eager_at_529(smoke):
    # the default configuration's step captured as one CUDA graph against
    # the eager step over 3 steps from the bench seed at B = 529 (the last
    # wave part-filled): identical counts, X/U/backoffs bit for bit or
    # within 1e-6 relative (captured_vs_eager fails otherwise)
    from robust_nonlinear_mpc_torch import bench

    wl = bench.build_workload(B=529, n_warm=0, n_rep=3)
    in_graph = smoke.captured_vs_eager("529", wl, wl.carry, wl.w_seq)
    assert {"factor_predictor", "resolve"} <= set(in_graph)

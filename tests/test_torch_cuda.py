"""PyTorch port on the GPU: the CUDA kernels against their plain torch
versions on the same card inputs (float64 to 1e-10, float32 to 1e-4,
relative to each output's largest entry): the fused Newton kernels and the
whole-iteration kernel at the main path's shape, a ragged batch and a long
horizon (the Newton kernels also at the long horizon's full batch, B = 512,
N = 60, and at narrow inputs), at a batch that leaves
the last wave part-filled and at the other models' widths and the general
(runtime-width) path; the response kernel (float32 only) and the SLS
backward kernel at the main path's shape, a ragged batch, a long horizon,
the same edges (K3 also at narrow inputs); the until-convergence closed
loop with every mitigation (chip_smoke phase 9a) on the card at B = 529 for
one step against the CPU on its first 16 lanes; the RTI step captured as
one CUDA graph against the eager step at B = 529 over 3 steps, with the
eager step's kernel launches; the condensed IPM (torch ops) on the card
against the CPU; the TF32 precision switches restoring the process's
setting; the WHILE nodes of captured loops (chip_smoke phase 2b), and a
dropped captured loop (alone and in a GraphSet) freed without the cyclic
collector.

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
@pytest.mark.parametrize("Bsz,N,nu", [(512, 15, 4), (37, 15, 4), (8, 60, 4), (512, 60, 4),
                                      (8, 15, 1), (8, 15, 2)])
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
    launched = smoke.captured_vs_eager("529", wl, wl.carry, wl.w_seq)
    assert all({"factor_predictor", "resolve"} <= set(step) for step in launched)


def test_condensed_card_matches_cpu(smoke):
    # kkt="condensed" (torch ops only) on the card against the CPU, float64,
    # well-conditioned random QPs at the rocket's widths, B = 529: the same
    # iterations on every lane, X/U within 1e-9 relative
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions, solve_qp

    stat, data = smoke.random_qps(529, 15, smoke.NX, smoke.NU, torch.float64, "cuda", seed=4)
    opts = IPMOptions(max_iter=30, tol=1e-9, kkt="condensed")
    card = solve_qp(stat, data, opts)
    cpu = solve_qp(type(stat)(*(t.cpu() for t in stat)), type(data)(*(t.cpu() for t in data)),
                   opts)
    assert torch.equal(card.iters.cpu(), cpu.iters) and bool(card.success.all())
    assert smoke.rel_err(card.X.cpu(), cpu.X)[0] <= 1e-9
    assert smoke.rel_err(card.U.cpu(), cpu.U)[0] <= 1e-9


def test_tf32_switch_restores_the_global_flag(smoke):
    # "default" turns TF32 on only inside its contexts; a float32 solve and a
    # bench step leave the process's setting as it was
    from robust_nonlinear_mpc_torch import bench
    from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions, solve_qp
    from robust_nonlinear_mpc_torch.utils import numerics

    before = numerics.tf32_enabled()
    stat, data = smoke.rocket_qps(64, 15, torch.float32, "cuda", seed=3)
    wl = bench.build_workload(B=16, n_warm=0, n_rep=1)
    try:
        numerics.set_tube_precision("default")
        numerics.set_qp_direction_precision("default")
        for ctx in (numerics.tube_precision, numerics.qp_direction_precision):
            with ctx():
                assert numerics.tf32_enabled()
            assert numerics.tf32_enabled() == before
        solve_qp(stat, data, IPMOptions(max_iter=15, tol=3e-5, kkt="fused"))
        wl.mpc_step(wl.carry, wl.w_seq[0])
        torch.cuda.synchronize()
        assert numerics.tf32_enabled() == before
    finally:
        numerics.set_tube_precision("highest")
        numerics.set_qp_direction_precision("highest")


def test_device_while_exits_on_the_device(smoke):
    # chip_smoke phase 2b: WHILE nodes exit at their device-given counts
    # (nested too, with a GEMM and K1 in a body, in a shared pool), and
    # solve_qp as one graph equals the eager solve with its launches
    record = smoke.check_device_while()
    assert record["a_runs"] == record["d_runs"] == [7, 23, 0, 100]
    assert all(r["bit_for_bit"] and r["launches"] == r["eager_launches"] for r in record["e"])


@pytest.mark.parametrize("holder", ["loop", "graph_set"])
def test_dropped_captured_loop_needs_no_cyclic_collector(smoke, holder):
    # a captured loop, and a GraphSet holding one and a captured call, free
    # their WHILE body's memory pool as soon as they are dropped: left to
    # the cyclic collector, the pool could be destroyed inside a later
    # capture, which the allocator refuses (a long-horizon bench seed's
    # graphs, dropped before the step's capture)
    import gc
    import weakref

    from robust_nonlinear_mpc_torch.utils.graph_loop import CapturedLoop, GraphSet

    x = torch.zeros(4, device="cuda")
    body, cond = lambda st: st + (st < 3), lambda st: (st < 3).any()
    if holder == "loop":
        held = CapturedLoop(body, x, 10, cond=cond)
        out = held(x)
    else:
        held = GraphSet(x.device)
        out = held.call("shift", lambda st: st - 1, held.loop("count", cond, body, x, cap=10))
    assert out.tolist() == ([3.0] if holder == "loop" else [2.0]) * 4
    ref = weakref.ref(held)
    gc.disable()
    try:
        del held
        assert ref() is None
    finally:
        gc.enable()

"""robust_nonlinear_mpc_torch: the PyTorch / CUDA port of
`robust_nonlinear_mpc_tpu` (robust nonlinear MPC by SCP over System Level
Synthesis), for NVIDIA Hopper GPUs.

Each module mirrors its counterpart in the JAX package and is held against
it by the tests under `tests/test_torch_*.py`. The fused IPM Newton solves
are hand-written CUDA kernels (`csrc/fused_qp.cu`, bound by `ops/fused_qp.py`);
everything else is PyTorch. A leading batch dimension takes the place of
`jax.vmap`.
"""

__version__ = "0.1.0"

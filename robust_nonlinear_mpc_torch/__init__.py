"""robust_nonlinear_mpc_torch: the PyTorch / CUDA port of
`robust_nonlinear_mpc_tpu` (robust nonlinear MPC by SCP over System Level
Synthesis), for NVIDIA Hopper GPUs.

Each module mirrors its counterpart in the JAX package and is held against
it by the tests under `tests/test_torch_*.py`. Each Pallas kernel of the JAX
package has a hand-written CUDA counterpart in `csrc/` (the IPM Newton solves
and the whole Mehrotra iteration, `ops/fused_qp.py`; the fused response,
`ops/fused_response.py`; the SLS backward Riccati, `ops/fused_backward.py`);
everything else is PyTorch. A leading batch dimension takes the place of
`jax.vmap`.
"""

__version__ = "0.1.0"

"""Build and bind the port's hand-written CUDA kernels.

The sources in `csrc/` (`fused_qp.cu`: the Newton kernels, `fused_ipm.cu`:
the whole-iteration kernel, `fused_response.cu`: the response kernel,
`fused_backward.cu`: the SLS backward Riccati kernel) are
compiled with nvcc for sm_90a on first use, by `torch.utils.cpp_extension.load`
(ninja builds the sources in parallel), into one shared library under
`build/robust_nonlinear_mpc_torch/` next to the package. The library has a
plain C interface, bound here with ctypes; no source includes PyTorch's
headers. A failed build raises, and so does a launch whose C function
returns a CUDA error.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = _PKG_DIR / "csrc"
SOURCES = [CSRC / "fused_qp.cu", CSRC / "fused_ipm.cu", CSRC / "fused_response.cu",
           CSRC / "fused_backward.cu"]
BUILD_DIR = _PKG_DIR.parent / "build" / "robust_nonlinear_mpc_torch"

_LIB = None
# kernels with an occupancy query, and the types each is built for
INFO_KERNELS = {"factor_predictor": ("f32", "f64"), "resolve": ("f32", "f64"),
                "ipm_iteration": ("f32", "f64"), "backward_K": ("f32", "f64"),
                "fused_response": ("f32",)}


def build_extension(verbose: bool = False):
    """Compile every kernel source for sm_90a (once per process) and bind the
    plain C interface with ctypes. Raises if the build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = load(
        name="rnm_kernels",
        sources=[str(s) for s in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cuda_cflags=[
            "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
            "-Xptxas=-v",
        ],
        extra_include_paths=[str(CSRC)],
        is_python_module=False,
        verbose=verbose,
    )
    lib = ctypes.CDLL(path)
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    signatures = {
        "rnm_factor_predictor": [ptr] * 20 + [i32] * 4 + [ptr],
        "rnm_resolve": [ptr] * 16 + [i32] * 4 + [ptr],
        "rnm_ipm_iter": [ptr, i32] + [i32] * 6 + [f64, f64, ptr],
        "rnm_backward_K": [ptr] * 11 + [i32] * 6 + [ptr],
    }
    for name, argtypes in signatures.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = i32
    lib.rnm_fused_response_f32.argtypes = [ptr] * 17 + [i32] * 7 + [f64, ptr]
    lib.rnm_fused_response_f32.restype = i32
    for name, suffixes in INFO_KERNELS.items():
        for sfx in suffixes:
            fn = getattr(lib, f"rnm_{name}_info_{sfx}")
            fn.argtypes = [ptr, ptr]
            fn.restype = i32
    lib.rnm_error_string.argtypes = [i32]
    lib.rnm_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def kernel_info(name, dtype, Bsz, N, nx, nu, ni, ni_f, nw=None):
    """What one launch of kernel `name` at these widths costs the SM, from
    the CUDA runtime (`cudaFuncGetAttributes`, `cudaOccupancyMaxActive
    BlocksPerMultiprocessor`): registers per thread, static and dynamic
    shared bytes per block, local (spill) bytes per thread, resident blocks
    per SM, and the waves a grid of one block per lane (`Bsz`) takes on the
    current card."""
    lib = build_extension()
    dims = (ctypes.c_int * 6)(N, nx, nu, ni, ni_f, nx if nw is None else nw)
    out = (ctypes.c_int * 5)()
    err = getattr(lib, f"rnm_{name}_info_{suffix(dtype)}")(dims, out)
    if err != 0:
        raise RuntimeError(f"{name} info failed: {lib.rnm_error_string(err).decode()}")
    regs, static, dynamic, local, blocks = list(out)
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    waves = -(-Bsz // (sms * blocks)) if blocks > 0 else None
    return {"registers": regs, "static_smem": static, "dynamic_smem": dynamic,
            "local_bytes": local, "blocks_per_sm": blocks, "sms": sms, "waves": waves}


def suffix(dtype):
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the CUDA kernels take float32 or float64, got {dtype}")


def check(name, t, shape, like, dtype=None):
    """`t` on `like`'s device with `like`'s dtype (or `dtype`) and the given
    shape; returns it contiguous."""
    dtype = like.dtype if dtype is None else dtype
    if t.device != like.device or t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} on {like.device}, got {t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    return t.contiguous()


def launch(fn_name, tensors, scalars, device, pointer_array=False):
    """Call `fn_name` with the tensors' device pointers (one argument each,
    or one array of them), the scalars and the current stream; raise on a
    CUDA error."""
    lib = build_extension()
    ptrs = [t.data_ptr() for t in tensors]
    if pointer_array:
        ptrs = [(ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs)]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*ptrs, *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: {lib.rnm_error_string(err).decode()}")


def launch_counts():
    """Launches of every CUDA kernel of the port since the last reset, by
    the wrappers' counters (a wrapper counts a launch where it makes one: a
    launch recorded into a CUDA graph counts once, at capture)."""
    from robust_nonlinear_mpc_torch.ops import fused_backward, fused_qp, fused_response

    return {**fused_qp.launch_counts(), **fused_response.launch_counts(),
            **fused_backward.launch_counts()}


def reset_launch_counts():
    from robust_nonlinear_mpc_torch.ops import fused_backward, fused_qp, fused_response

    fused_qp.reset_launch_counts()
    fused_response.reset_launch_counts()
    fused_backward.reset_launch_counts()

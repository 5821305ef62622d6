"""WHILE nodes of a CUDA graph under capture (`csrc/graph_while.cu`): the
device side of `utils.graph_loop.device_while`, the port's counterpart of
`lax.while_loop` inside a jitted program.

`begin` is called while the current stream captures a graph: it captures
the test of a device bool before the first body, adds a conditional node of
type `cudaGraphCondTypeWhile` and starts capturing the node's body on a
stream of its own (`body_stream`, one a nesting depth); `end` captures the
test after the body and ends the body's capture. The test,
`set_while_condition`, is the only kernel: it sets the node's handle to
`flag and runs < cap`, where `runs` counts the bodies of the node's current
launch, and adds one to the node's total of body runs. Each node takes a
slot of a counter slab allocated by `prepare` outside any capture;
`run_totals` reads the totals. A refused node (driver, runtime or a node
type in the body) raises; nothing falls back to a loop at its cap.
"""

from __future__ import annotations

import ctypes

import torch

from robust_nonlinear_mpc_torch.ops.cuda_lib import build_extension

# counter slots a device holds: one a WHILE node captured in this process
SLOTS = 1 << 16
# body streams created by `prepare`, one a nesting depth
DEPTHS = 4

_slabs: dict[int, torch.Tensor] = {}
_used: dict[int, int] = {}
_streams: dict[int, list[torch.cuda.ExternalStream]] = {}


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} failed: {build_extension().rnm_error_string(err).decode()}")


def _new_stream(idx):
    out = ctypes.c_void_p()
    with torch.cuda.device(idx):
        _check(build_extension().rnm_while_stream(ctypes.byref(out)), "rnm_while_stream")
    return torch.cuda.ExternalStream(out.value, device=torch.device("cuda", idx))


def prepare(device):
    """Outside any capture: build the library, allocate the device's counter
    slab and create its body streams (once a process)."""
    idx = _index(device)
    if idx in _slabs:
        return
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("graph_while.prepare must run before the capture begins")
    build_extension()
    _streams[idx] = [_new_stream(idx) for _ in range(DEPTHS)]
    _slabs[idx] = torch.zeros((SLOTS, 2), dtype=torch.int64, device=torch.device("cuda", idx))
    _used[idx] = 0


def counter(device) -> tuple[torch.Tensor, int]:
    """A fresh counter (runs in this launch, runs since the slab was
    allocated) for one node, and its slot."""
    idx = _index(device)
    if idx not in _slabs:
        raise RuntimeError("a WHILE node needs graph_while.prepare(device) before the capture "
                           "(utils.graph_loop.capturing does it)")
    slot = _used[idx]
    if slot >= SLOTS:
        raise RuntimeError(f"more than {SLOTS} WHILE nodes captured on cuda:{idx}")
    _used[idx] = slot + 1
    return _slabs[idx][slot], slot


def run_totals(device) -> list[int]:
    """The body runs of every node captured on the device, by slot (one
    host read)."""
    idx = _index(device)
    return _slabs[idx][: _used[idx], 1].tolist() if idx in _slabs else []


def body_stream(device, depth: int) -> torch.cuda.ExternalStream:
    """The stream that captures bodies at nesting `depth` (0: a node in the
    outer graph)."""
    streams = _streams[_index(device)]
    while len(streams) <= depth:
        streams.append(_new_stream(_index(device)))
    return streams[depth]


def _flag(flag):
    if flag.dtype != torch.bool or flag.numel() != 1 or flag.device.type != "cuda":
        raise ValueError(f"a WHILE condition is one bool on the card, got {flag.dtype} "
                         f"{tuple(flag.shape)} on {flag.device}")
    return flag


def begin(flag, runs, cap: int, stream, body) -> int:
    """Capture the test of `flag` and a WHILE node into the graph that
    `stream` captures, and start capturing its body on `body`; returns the
    node's handle."""
    handle = ctypes.c_ulonglong()
    with torch.cuda.device(runs.device):
        err = build_extension().rnm_while_begin(
            _flag(flag).data_ptr(), runs.data_ptr(), int(cap), stream.cuda_stream,
            body.cuda_stream, ctypes.byref(handle))
    _check(err, "rnm_while_begin (a WHILE node in the capturing graph)")
    begin.launches += 1
    return handle.value


def end(handle: int, flag, runs, cap: int, body):
    """Capture the test of `flag` at the end of the body and end the body's
    capture on `body`."""
    with torch.cuda.device(runs.device):
        err = build_extension().rnm_while_end(handle, _flag(flag).data_ptr(), runs.data_ptr(),
                                              int(cap), body.cuda_stream)
    _check(err, "rnm_while_end (the end of a WHILE node's body)")
    end.launches += 1


begin.launches = end.launches = 0


def reset_launch_counts():
    begin.launches = end.launches = 0


def launch_counts():
    """`set_while_condition` launches captured: before a first body
    ("while_begin") and after a body ("while_end"), one each a node."""
    return {"while_begin": begin.launches, "while_end": end.launches}


def plain_condition(flag, runs, cap: int, after_body: bool):
    """The plain twin of `set_while_condition`: updates `runs` as the kernel
    does and returns the handle's value as a 0-dim bool."""
    if after_body:
        runs[0] += 1
        runs[1] += 1
    else:
        runs[0] = 0
    return flag.reshape(()) & (runs[0] < cap)

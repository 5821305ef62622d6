"""Whether the solver may read the device from the host.

The eager loops of the port end early: the IPM's masked batch loop stops
when no lane is active, which costs one host read of the device per
iteration. A CUDA graph cannot hold such a read: there each loop is a WHILE
node that tests the same condition on the device
(`utils.graph_loop.device_while`). Inside `no_host_sync()` but outside a
capture, a loop cannot read either, so it runs a count of iterations that
the host knows without asking the device (its cap), with the finished lanes
frozen by a select: that is the form the CPU tests hold the masked bodies
with, and every lane ends where the early-exit loop leaves it, as a vmapped
`lax.while_loop` of the JAX package does. The warm-up before a capture
(`utils.graph_loop.warm_up`) runs inside it too, with each loop's body once.
`utils.graph_loop.capturing` enters it around a capture.
"""

from __future__ import annotations

from contextlib import contextmanager

_depth = 0


@contextmanager
def no_host_sync():
    """No host read of the device: a loop outside a capture runs its cap."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def host_sync_allowed() -> bool:
    """False inside `no_host_sync()`."""
    return _depth == 0

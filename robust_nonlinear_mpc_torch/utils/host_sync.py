"""Whether the solver may read the device from the host.

The eager loops of the port end early: the IPM's masked batch loop stops
when no lane is active, which costs one host read of the device per
iteration. A CUDA graph cannot hold such a read, so inside `no_host_sync()`
the loops run a count of iterations that the host knows without asking the
device (the iteration caps), with the finished lanes frozen by a select.
Every lane then ends where the early-exit loop leaves it, as a vmapped
`lax.while_loop` of the JAX package does. `sim.closed_loop.capture_mpc_step`
enters it around the warm-up and the capture; the CPU tests enter it to
hold the two forms against each other.
"""

from __future__ import annotations

from contextlib import contextmanager

_depth = 0


@contextmanager
def no_host_sync():
    """Run the solver's loops to their host-known iteration bounds."""
    global _depth
    _depth += 1
    try:
        yield
    finally:
        _depth -= 1


def host_sync_allowed() -> bool:
    """False inside `no_host_sync()`."""
    return _depth == 0

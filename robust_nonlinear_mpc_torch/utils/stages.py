"""Host-clock stage times of the solver, for measurement runs.

`stage(name)` marks a stage of a closed loop ("seed", "step"), of its seed
("seed.sqp", "seed.soft_nlp", "seed.polish"), of the SCP iteration
("scp.linearize", "scp.fast_sls", "scp.restoration"), of fast-SLS
("sls.qp", "sls.backward", "sls.response") or of the comparison CLI
("compare.robust", "compare.soft"). It does nothing unless a
`timed()` block is open; inside one, each recorded stage synchronizes the
device at its start and end and appends its seconds to the block's record
(nested stages count in their parent too). Inside `host_sync.no_host_sync()`
(a CUDA graph's warm-up and capture) no stage syncs or records.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from robust_nonlinear_mpc_torch.utils.host_sync import host_sync_allowed

_record = None
_only = None


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def stage(name: str):
    if _record is None or (_only is not None and name not in _only) or not host_sync_allowed():
        yield
        return
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        _record[name].append(time.perf_counter() - t0)


@contextmanager
def timed(only=None):
    """Record stage times: yields {name: [seconds of each call]}. `only`: the
    names to record (the others neither sync nor record), all when None."""
    global _record, _only
    outer = _record, _only
    _record, _only = defaultdict(list), (None if only is None else frozenset(only))
    try:
        yield _record
    finally:
        _record, _only = outer

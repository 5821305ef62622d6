"""CUDA graphs of the solver's pieces: the port's counterpart of
`lax.while_loop` and of the compiled loop bodies around it.

A JAX `while_loop` under `vmap` runs its body on every lane while any lane's
condition holds and keeps a stopped lane's state by a select, and inside a
jitted program it tests the condition on the device. The port's bodies are
written the same way (masked, fixed shapes, no host read), and:

* `device_while(cond, body, state, *args, cap=...)`: the loop. While a
  graph captures on the card it is one WHILE node (`ops/graph_while.py`):
  the node replays the body on the device while `cond` (a 0-dim bool) holds,
  at most `cap` bodies a launch, and the host reads nothing. On the CPU, or
  outside a capture, it is `while_loop`: a host read before every body, or,
  inside `no_host_sync()`, `cap` bodies.
* `capturing(graph, pool)`: a capture (`torch.cuda.graph` inside
  `no_host_sync()`) that records its WHILE nodes, their body pools and its
  kernel launches in a `Recording`, which counts a replay's launches: those
  outside every loop once a replay, those of a loop's body once a body run,
  from the node's device counter.
* `CapturedLoop(body, state, cap, cond=...)`: a loop on its own, one graph
  of `cond` and the WHILE node over `body`; a call copies the state into
  its static buffers and replays once. On the CPU (or with
  `capture=False`) the same body runs eagerly (`while_loop`).
* `CapturedCall(fn, args)`: a piece, one graph (its loops WHILE nodes).
* `GraphSet`: the graphs of one run, captured lazily by name on their first
  call and sharing one memory pool, and the static buffers of the state
  they carry (`static`). A call copies its inputs into the graph's own
  static input buffers and returns the graph's static outputs, which the
  next replay of that graph overwrites. On the CPU (or with
  `capture=False`) every call runs eagerly. It counts the host reads, the
  runs of each piece and the kernel launches.

A captured function may close over tensors whose values do not change from
one call to the next (model and problem constants): the graph keeps the
first call's. Everything else is an argument. Every static output lives
outside the shared pool (a graph copies its results into buffers allocated
before its capture), so a graph's temporaries, which other graphs of the
pool may reuse, never hold a value that outlives its replay; a WHILE body's
temporaries live in a pool of their own, kept by the capture's `Recording`
(which `capturing` hangs on the graph).
The warm-up before a capture (`warm_up`) runs each loop's body once. A
failed capture or replay raises; nothing falls back to eager execution.
"""

from __future__ import annotations

import itertools
from collections import Counter
from contextlib import contextmanager

import torch

from robust_nonlinear_mpc_torch.utils.batch import tree_leaves, tree_map
from robust_nonlinear_mpc_torch.utils.host_sync import host_sync_allowed, no_host_sync
from robust_nonlinear_mpc_torch.utils.stages import stage


def copy_into(dst, src):
    """dst.copy_(src) into a static buffer of the same shape and type."""
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"the captured graph takes {dst.dtype} {tuple(dst.shape)}, "
                         f"got {src.dtype} {tuple(src.shape)}")
    dst.copy_(src)


def copy_tree_into(dst, src):
    """Copy every leaf of `src` into the same leaf of `dst` unless it is that
    very tensor."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if s is not d:
            copy_into(d, s)


def _storage(t):
    return t.untyped_storage().data_ptr()


def unaliased(tree, avoid=()):
    """`tree` with every leaf that shares memory with a leaf of `avoid` or
    with an earlier leaf of `tree` cloned, so that copying the tree into
    `avoid` (or into buffers of its own) reads no value already overwritten."""
    seen = {_storage(t) for t in tree_leaves(avoid) if t.numel()}

    def fresh(t):
        if t.numel() == 0:
            return t
        if _storage(t) in seen:
            t = t.clone()
        seen.add(_storage(t))
        return t

    return tree_map(fresh, tree)


_warming = 0


def warm_up(fn, device):
    """Run fn() once on a side stream inside `no_host_sync()`, as a capture
    will (builds the kernel library, creates the cuBLAS handles, sets the
    kernels' shared-memory attributes), each `device_while` running its body
    once; returns its result."""
    global _warming
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    _warming += 1
    try:
        with torch.cuda.stream(side), no_host_sync():
            out = fn()
    finally:
        _warming -= 1
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    return out


def while_loop(cond, body, state, args=(), *, cap=None, read=None):
    """Eagerly: state = body(state, *args) while read(cond(state, *args)),
    tested before every body, at most `cap` bodies (None: no cap). `read`
    turns the device flag into a host bool (default bool); inside
    `no_host_sync()` the loop runs `cap` bodies and reads nothing."""
    read = read or bool
    if not host_sync_allowed():
        if cap is None:
            raise ValueError("a loop inside no_host_sync() needs its host-known cap")
        for _ in range(int(cap)):
            state = body(state, *args)
        return state
    for _ in itertools.count() if cap is None else range(int(cap)):
        if not read(cond(state, *args)):
            break
        state = body(state, *args)
    return state


class _WhileNode:
    """One captured WHILE node: its body's memory pool, its counter slot and
    the port's kernel launches of one body run (nested loops' excluded)."""

    def __init__(self, pool, slot, device):
        self.pool, self.slot, self.device = pool, slot, device
        self.launches = Counter()


class Recording:
    """What one capture recorded: its WHILE nodes (in the order they were
    begun, nested ones after their parent) and `straight`, the port's kernel
    launches of one replay outside every loop. Keeps the bodies' pools."""

    def __init__(self):
        self.loops: list[_WhileNode] = []
        self.straight = Counter()

    def runs(self) -> list[int]:
        """Each node's body runs since its capture (one host read a device)."""
        from robust_nonlinear_mpc_torch.ops.graph_while import run_totals

        totals = {}
        for n in self.loops:
            if n.device not in totals:
                totals[n.device] = run_totals(n.device)
        return [totals[n.device][n.slot] for n in self.loops]

    def launches(self, replays: int) -> Counter:
        """The port's kernel launches of `replays` replays and every body run
        of its nodes since the capture."""
        out = Counter({k: v * replays for k, v in self.straight.items()})
        for node, n in zip(self.loops, self.runs()):
            for k, v in node.launches.items():
                out[k] += v * n
        return out


# the recordings of the captures under way (innermost last); a node
# captured under none (a plain `torch.cuda.graph` of a caller) keeps its
# pool in `_UNOWNED` for the life of the process
_recordings: list[Recording] = []
_UNOWNED = Recording()
_body_depth = 0


def _launch_counts():
    from robust_nonlinear_mpc_torch.ops.cuda_lib import launch_counts

    return Counter(launch_counts())


@contextmanager
def recording():
    """Record the WHILE nodes and the kernel launches of the capture(s) run
    inside: yields a `Recording`, complete when the block ends. It holds the
    nodes' body pools: keep it as long as the graph (`capturing` does)."""
    rec = Recording()
    before = _launch_counts()
    _recordings.append(rec)
    try:
        yield rec
    finally:
        _recordings.pop()
    total = _launch_counts() - before
    for node in rec.loops:
        total -= node.launches
    rec.straight = total


@contextmanager
def capturing(graph, pool=None):
    """Capture into `graph` (`torch.cuda.graph`, sharing `pool`) inside
    `no_host_sync()`: yields the capture's `Recording`, which the graph
    keeps (`graph.recording`), so its WHILE bodies' pools live as long as
    the graph."""
    from robust_nonlinear_mpc_torch.ops import graph_while

    graph_while.prepare(torch.cuda.current_device())
    with recording() as rec:
        graph.recording = rec
        with torch.cuda.graph(graph, pool=pool), no_host_sync():
            yield rec


def _capturing(state) -> bool:
    leaves = tree_leaves(state)
    return (bool(leaves) and leaves[0].device.type == "cuda"
            and torch.cuda.is_current_stream_capturing())


def device_while(cond, body, state, *args, cap: int):
    """`lax.while_loop(cond, body, state)` with `args` passed to both:
    `body(state, *args) -> state` (masked: a stopped lane keeps its state)
    and `cond(state, *args)` -> a 0-dim bool ("any lane running"). At most
    `cap` bodies (host-known). Returns the final state; the caller's `state`
    is not changed.

    While a graph captures on the current stream of the card: one WHILE
    node. The state lives in static buffers (clones of `state`, in the
    capture's pool) that each body run overwrites in place; the test before
    the first body and after each body is `cond` on those buffers, and the
    node counts its body runs on the device. Otherwise `while_loop` (in a
    `warm_up`, one body)."""
    if _capturing(state):
        return _captured_while(cond, body, state, args, int(cap))
    # the loop's own buffers, as in a capture: a body may write them in place
    state = tree_map(torch.clone, state)
    if _warming:
        return body(state, *args)
    return while_loop(cond, body, state, args, cap=cap)


def _captured_while(cond, body, state, args, cap):
    global _body_depth
    from robust_nonlinear_mpc_torch.ops import graph_while

    device = tree_leaves(state)[0].device
    rec = _recordings[-1] if _recordings else _UNOWNED
    runs, slot = graph_while.counter(device)
    node = _WhileNode(torch.cuda.MemPool(), slot, device)
    rec.loops.append(node)
    first_nested = len(rec.loops)
    buf = tree_map(torch.clone, state)
    outer = torch.cuda.current_stream(device)
    side = graph_while.body_stream(device, _body_depth)
    handle = graph_while.begin(cond(buf, *args), runs, cap, outer, side)
    before = _launch_counts()
    _body_depth += 1
    try:
        with torch.cuda.stream(side), torch.cuda.use_mem_pool(node.pool, device):
            copy_tree_into(buf, unaliased(body(buf, *args), avoid=buf))
            graph_while.end(handle, cond(buf, *args), runs, cap, side)
    finally:
        _body_depth -= 1
    own = _launch_counts() - before
    for nested in rec.loops[first_nested:]:
        own -= nested.launches
    node.launches = own
    return buf


class CapturedCall:
    """fn(*args) captured as one CUDA graph over static input buffers
    (clones of the first call's `args`). Calling it copies the arguments
    into them, replays, and returns the static outputs, which the next replay
    overwrites; with `into` (a tree of static tensors) the graph writes its
    result there instead, and the call returns `into`. `recording`: the
    capture's `Recording`; `calls`: the replays."""

    def __init__(self, fn, args, *, pool=None, into=None):
        device = tree_leaves(args)[0].device
        # keeps alive the constants fn closes over: the graph reads them
        self.fn = fn
        self.args = tree_map(torch.clone, args)
        run = lambda: fn(*self.args)
        warm = warm_up(run, device)
        self.out = tree_map(torch.empty_like, warm) if into is None else into
        self.graph = torch.cuda.CUDAGraph()
        with capturing(self.graph, pool) as self.recording:
            copy_tree_into(self.out, unaliased(run(), avoid=self.out))
        torch.cuda.synchronize(device)
        self.calls = 0

    def launched(self) -> Counter:
        """The port's kernel launches of every replay so far."""
        return self.recording.launches(self.calls)

    def __call__(self, *args):
        copy_tree_into(self.args, args)
        self.graph.replay()
        self.calls += 1
        return self.out


class CapturedLoop:
    """`lax.while_loop(cond, body, state)` on the card: `body(state, *args)
    -> state`, masked so that an extra body leaves a stopped lane as it is,
    and `cond(state, *args)` -> a 0-dim bool ("any lane running"), captured
    once as one graph: `cond`, then a WHILE node over `body`
    (`device_while`, at most `cap` bodies a call). A call copies the state
    in, replays once and returns the static state (overwritten by the next
    call); the host reads nothing. On the CPU (or with `capture=False`), the
    same body runs eagerly (`while_loop`). `replays`: the bodies run (on the
    card, the node's device counter, read when asked); `reads`: the flags
    read by the host."""

    def __init__(self, body, state, cap, *, cond, args=(), pool=None, capture=None):
        self.body, self.cond, self.cap = body, cond, int(cap)
        self.reads = self._replays = 0
        device = tree_leaves(state)[0].device
        self.captured = device.type == "cuda" if capture is None else capture
        self.graph = None
        if self.captured:
            loop = lambda st, *a: device_while(cond, body, st, *a, cap=self.cap)
            self.graph = CapturedCall(loop, (state, *args), pool=pool)

    @property
    def replays(self) -> int:
        if self.graph is None:
            return self._replays
        return self.graph.recording.runs()[0]

    def _read(self, flag):
        self.reads += 1
        return bool(flag)

    def __call__(self, state, *args):
        if self.graph is not None:
            return self.graph(state, *args)

        def counted(st, *a):
            self._replays += 1
            return self.body(st, *a)

        return while_loop(self.cond, counted, state, args, cap=self.cap, read=self._read)


class GraphSet:
    """The captured pieces of one run (see the module docstring). `device`
    None or a CPU device, or `capture=False`: every piece runs eagerly.
    `counts`: runs of each piece by name ("<name>" for a call, the body runs
    of a loop), and "host_reads", the reads of a device flag, of which
    `loop_reads` were a loop's (none on the card); `kernel_launches()`: the
    port's kernel launches so far."""

    def __init__(self, device=None, capture=None):
        on_card = device is not None and torch.device(device).type == "cuda"
        self.capture = on_card if capture is None else bool(capture)
        if self.capture and not on_card:
            raise RuntimeError(f"CUDA graphs need a CUDA device, got {device}")
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self._counts = Counter()
        self.loop_reads = 0
        self._graphs = {}
        self._loops = {}

    @property
    def counts(self) -> Counter:
        """The runs of each piece and the host reads (a captured loop's body
        runs read from the device)."""
        out = self._counts.copy()
        for name, g in self._loops.items():
            if g.captured:
                out[name] += g.replays
        return out

    def kernel_launches(self) -> Counter:
        """The port's kernel launches so far: on the card those of every
        replay of the set's graphs, counted by their `Recording`s; eagerly
        the wrappers' counters (all the process's launches)."""
        if not self.capture:
            return _launch_counts()
        out = Counter()
        for g in self._graphs.values():
            if isinstance(g, CapturedCall):
                out += g.launched()
        for g in self._loops.values():
            out += g.graph.launched()
        return out

    def any(self, flag) -> bool:
        """Whether any entry of the device tensor `flag` is set, by one host
        read; True, without a read, inside `no_host_sync()`."""
        if not host_sync_allowed():
            return True
        self._counts["host_reads"] += 1
        return bool(flag.any())

    def static(self, name, tree):
        """The static buffers `name` holding `tree` (allocated at the first
        call, copied into at the later ones); `tree` itself when eager."""
        if not self.capture:
            return tree
        buf = self._graphs.get(name)
        if buf is None:
            buf = self._graphs[name] = tree_map(torch.clone, tree)
        else:
            copy_tree_into(buf, tree)
        return buf

    def call(self, name, fn, *args, into=None):
        """fn(*args): eagerly, or the replay of its graph `name` (captured
        at the first call; `into`: static buffers the graph writes its
        result to)."""
        self._counts[name] += 1
        with stage(name):
            if not self.capture:
                return fn(*args)
            g = self._graphs.get(name)
            if g is None:
                g = self._graphs[name] = CapturedCall(fn, args, pool=self.pool, into=into)
            return g(*args)

    def loop(self, name, cond, body, state, *args, cap):
        """`while_loop` of `body` under `cond` (a `CapturedLoop` `name` on
        the card, captured at the first call)."""
        with stage(name):
            g = self._loops.get(name)
            if g is None:
                g = CapturedLoop(body, state, cap, cond=cond, args=args, pool=self.pool,
                                 capture=self.capture)
                if self.capture:
                    self._loops[name] = g
            if self.capture:
                return g(state, *args)
            replays, reads = g.replays, g.reads
            out = g(state, *args)
            self._counts[name] += g.replays - replays
            self._counts["host_reads"] += g.reads - reads
            self.loop_reads += g.reads - reads
            return out

"""CUDA graphs of the solver's pieces: the port's counterpart of
`lax.while_loop` and of the compiled loop bodies around it.

A JAX `while_loop` under `vmap` runs its body on every lane while any lane's
condition holds and keeps a stopped lane's state by a select. The port's
bodies are written the same way (masked, fixed shapes, no host read), so a
body can be captured once as a CUDA graph and replayed; the host only
decides whether to replay again, by reading one device bool ("any lane
running"), which is the counterpart of the `while_loop` condition.

* `CapturedLoop(body, state, cap, reads_every=1, cond=...)`: the loop.
  Called with a state, it copies the state into its static buffers and
  replays the body while `cond` says so, reading the flag once every
  `reads_every` replays and at most `cap` replays in all; extra replays
  leave stopped lanes as they are. On the CPU the same body runs eagerly
  with the same exit test (`while_loop`).
* `CapturedCall(fn, args)`: a straight-line piece, one graph.
* `GraphSet`: the graphs of one run, captured lazily by name on their first
  call and sharing one memory pool, and the static buffers of the state
  they carry (`static`). A call copies its inputs into the graph's own
  static input buffers and returns the graph's static outputs, which the
  next replay of that graph overwrites. On the CPU (or with
  `capture=False`) every call runs eagerly. It counts the host reads and
  the runs of each piece.

Capture runs under `host_sync.no_host_sync()`: the IPM and the other loops
inside a piece run their host-known caps with finished lanes frozen. A
captured function may close over tensors whose values do not change from
one call to the next (model and problem constants): the graph keeps the
first call's. Everything else is an argument. Every static output lives
outside the shared pool (a graph copies its results into buffers allocated
before its capture), so a graph's temporaries, which other graphs of the
pool may reuse, never hold a value that outlives its replay. A failed
capture or replay raises; nothing falls back to eager execution.
"""

from __future__ import annotations

from collections import Counter

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


def warm_up(fn, device):
    """Run fn() once on a side stream inside `no_host_sync()`, as a capture
    will (builds the kernel library, creates the cuBLAS handles, sets the
    kernels' shared-memory attributes); returns its result."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side), no_host_sync():
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    return out


def _capture(graph, pool, fn, out, device):
    """Capture fn() into `graph`, copying its result into the static buffers
    `out` (a tree matching fn's result). Returns the port's kernel launches
    that one replay makes (the wrappers count them once, at capture)."""
    from robust_nonlinear_mpc_torch.ops.cuda_lib import launch_counts

    before = launch_counts()
    with torch.cuda.graph(graph, pool=pool), no_host_sync():
        copy_tree_into(out, unaliased(fn(), avoid=out))
    torch.cuda.synchronize(device)
    return Counter({k: v - before[k] for k, v in launch_counts().items() if v > before[k]})


def while_loop(cond, body, state, args=(), *, cap, reads_every=1, read=None):
    """Eagerly: state = body(state, *args) while read(cond(state, *args)),
    testing before the first body and then once every `reads_every` bodies,
    at most `cap` bodies. `read` turns the device flag into a host bool
    (default bool); inside `no_host_sync()` the loop runs `cap` bodies and
    reads nothing."""
    read = read or bool
    for n in range(int(cap)):
        if n % reads_every == 0 and host_sync_allowed() and not read(cond(state, *args)):
            break
        state = body(state, *args)
    return state


class CapturedCall:
    """fn(*args) captured as one CUDA graph over static input buffers
    (clones of the first call's `args`). Calling it copies the arguments
    into them, replays, and returns the static outputs, which the next replay
    overwrites; with `into` (a tree of static tensors) the graph writes its
    result there instead, and the call returns `into`. `launches`: the
    port's kernel launches of one replay."""

    def __init__(self, fn, args, *, pool=None, into=None):
        device = tree_leaves(args)[0].device
        # keeps alive the constants fn closes over: the graph reads them
        self.fn = fn
        self.args = tree_map(torch.clone, args)
        run = lambda: fn(*self.args)
        warm = warm_up(run, device)
        self.out = tree_map(torch.empty_like, warm) if into is None else into
        self.graph = torch.cuda.CUDAGraph()
        self.launches = _capture(self.graph, pool, run, self.out, device)

    def __call__(self, *args):
        copy_tree_into(self.args, args)
        self.graph.replay()
        return self.out


class CapturedLoop:
    """`lax.while_loop(cond, body, state)` on the card: `body(state, *args)
    -> state`, masked so that an extra replay leaves a stopped lane as it
    is, captured once over static state buffers, and `cond(state, *args)`
    -> a 0-dim bool ("any lane running") captured after it. A call copies
    the state in, then replays the body while one host read of the flag
    says so, once every `reads_every` replays, up to the host-known `cap`,
    and returns the static state (overwritten by the next call). On the
    CPU (or with `capture=False`), the same body runs eagerly
    (`while_loop`). `replays` and `reads` count the bodies run and the
    flags read; `launches`, the port's kernel launches of one body replay."""

    def __init__(self, body, state, cap, reads_every=1, *, cond, args=(), pool=None,
                 capture=None):
        self.body, self.cond = body, cond
        self.cap, self.reads_every = int(cap), max(1, int(reads_every))
        self.replays = self.reads = 0
        self.launches = Counter()
        device = tree_leaves(state)[0].device
        self.captured = device.type == "cuda" if capture is None else capture
        if not self.captured:
            return
        self.state = tree_map(torch.clone, state)
        self.args = tree_map(torch.clone, args)
        run_cond = lambda: cond(self.state, *self.args)
        self.flag = torch.empty_like(warm_up(run_cond, device))
        warm_up(lambda: body(self.state, *self.args), device)
        self.cond_graph = torch.cuda.CUDAGraph()
        _capture(self.cond_graph, pool, run_cond, self.flag, device)

        def step():
            copy_tree_into(self.state, unaliased(body(self.state, *self.args), avoid=self.state))
            return run_cond()

        self.body_graph = torch.cuda.CUDAGraph()
        self.launches = _capture(self.body_graph, pool, step, self.flag, device)

    def _read(self, flag):
        self.reads += 1
        return bool(flag)

    def __call__(self, state, *args):
        if not self.captured:
            def counted(st, *a):
                self.replays += 1
                return self.body(st, *a)

            return while_loop(self.cond, counted, state, args, cap=self.cap,
                              reads_every=self.reads_every, read=self._read)
        copy_tree_into(self.state, state)
        copy_tree_into(self.args, args)
        for n in range(self.cap):
            if n % self.reads_every == 0:
                if n == 0:
                    self.cond_graph.replay()
                if not self._read(self.flag):
                    break
            self.body_graph.replay()
            self.replays += 1
        return self.state


class GraphSet:
    """The captured pieces of one run (see the module docstring). `device`
    None or a CPU device, or `capture=False`: every piece runs eagerly.
    `counts`: runs of each piece by name ("<name>" for a call, the body
    replays of a loop), and "host_reads", the reads of a device flag.
    `launches`: each captured piece's kernel launches a replay."""

    def __init__(self, device=None, capture=None):
        on_card = device is not None and torch.device(device).type == "cuda"
        self.capture = on_card if capture is None else bool(capture)
        if self.capture and not on_card:
            raise RuntimeError(f"CUDA graphs need a CUDA device, got {device}")
        self.pool = torch.cuda.graph_pool_handle() if self.capture else None
        self.counts = Counter()
        self.launches = {}
        self._graphs = {}

    def any(self, flag) -> bool:
        """Whether any entry of the device tensor `flag` is set, by one host
        read; True, without a read, inside `no_host_sync()`."""
        if not host_sync_allowed():
            return True
        self.counts["host_reads"] += 1
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
        self.counts[name] += 1
        with stage(name):
            if not self.capture:
                return fn(*args)
            g = self._graphs.get(name)
            if g is None:
                g = self._graphs[name] = CapturedCall(fn, args, pool=self.pool, into=into)
                self.launches[name] = g.launches
            return g(*args)

    def loop(self, name, cond, body, state, *args, cap, reads_every=1):
        """`while_loop` of `body` under `cond` (a `CapturedLoop` `name` on
        the card, captured at the first call)."""
        with stage(name):
            g = self._graphs.get(name)
            if g is None:
                g = CapturedLoop(body, state, cap, reads_every, cond=cond, args=args,
                                 pool=self.pool, capture=self.capture)
                if self.capture:
                    self._graphs[name] = g
                    self.launches[name] = g.launches
            replays, reads = g.replays, g.reads
            out = g(state, *args)
            self.counts[name] += g.replays - replays
            self.counts["host_reads"] += g.reads - reads
            return out

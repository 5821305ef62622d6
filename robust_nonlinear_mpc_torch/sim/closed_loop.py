"""Closed-loop MPC simulation (port of
`robust_nonlinear_mpc_tpu/sim/closed_loop.py`), batch-leading.

* `make_mpc_step`: one true closed-loop MPC step for a batch of lanes. In
  RTI mode (rti > 0) it runs `rti` SCP iterations; until convergence
  (rti <= 0, the reference default) it iterates SCP per lane until
  |delta|_inf < epsilon_convergence, an inner solve fails, or max_iter_scp,
  with the JAX package's stall damping and feasibility restoration. Then it
  applies u0, steps the plant x+ = f(x, u0) + E w and warm-shifts the plan
  and the recycled SLS state.
* `capture_mpc_step`: the RTI step (or K of them) captured on the card as
  one CUDA graph, the port's counterpart of `jax.jit(make_mpc_step(...))`
  and of a `lax.scan` over K steps; same contract as `make_mpc_step`.
* `build_batched_closed_loop`: SQP seed (with the soft-slack fallback on the
  lanes whose SQP failed), then T steps of `make_mpc_step`; in RTI mode on
  the card, T replays of the captured step (JAX's `lax.scan` over time).
* `build_chunked_converged_loop`: the until-convergence closed loop with the
  soft fallback in `soft_fallback_chunk(N)` chunks (padded to the chunk by
  repeating the last lane, as in JAX), reading whether every lane is
  decided once every `scp_per_dispatch` SCP iterations (the JAX driver's
  bounded dispatches); with a scenario mesh each rank runs its block of the
  lanes and the log is gathered.
* `run_closed_loop`: the experiment-parity host loop around the stateful
  `SCPSLSSolver`, with the reference npz keys.

The until-convergence loop is the JAX form: every SCP round runs on every
lane with fixed shapes, a decided lane keeps its state by a select, and no
piece reads the device from the host. On the card the seed's loops and each
piece of an SCP round (linearize, fast-SLS's head, inner loop and finish,
the update, the restoration, the acceptance) and of a step (`_advance`) are
CUDA graphs (`utils.graph_loop.GraphSet`), their loops WHILE nodes that
exit on the device; the host reads one device flag to decide whether any
lane needs the restoration, and, once every `scp_per_dispatch` rounds,
whether every lane is decided. On the CPU the same pieces run eagerly.
Both converged drivers run the same loop (`_scp_until_converged`), so they
cannot drift apart.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from robust_nonlinear_mpc_torch.solvers.fast_sls import (
    FastSLSPersist,
    warm_shift_persist,
)
from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver
from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve
from robust_nonlinear_mpc_torch.utils.batch import (
    lane_all_finite,
    lane_max,
    lane_where,
    tree_map,
    tree_where,
)
from robust_nonlinear_mpc_torch.utils.graph_loop import (
    GraphSet,
    capturing,
    copy_tree_into,
    unaliased,
    warm_up,
)
from robust_nonlinear_mpc_torch.utils.stages import stage


class ClosedLoopLog(NamedTuple):
    """Batch-leading logs of a closed loop of T steps."""

    state_trajectory: torch.Tensor    # (B, T, nx)
    input_trajectory: torch.Tensor    # (B, T-1, nu)
    nominal_x: torch.Tensor           # (B, T, N+1, nx)
    nominal_u: torch.Tensor           # (B, T, N, nu)
    backoff_x: torch.Tensor           # (B, T, N+1, nx); NaN: no accepted tube
    backoff_u: torch.Tensor           # (B, T, N, nu)
    success: torch.Tensor             # (B, T)
    qp_iters: torch.Tensor            # (B, T) IPM iterations summed over the step
    scp_iters: torch.Tensor = None    # (B, T) SCP iterations of the step
    scp_failed: torch.Tensor = None   # (B, T) an inner solve failed


def run_closed_loop(model, solver: SCPSLSSolver, x0, sim_steps: int, *,
                    noise: str = "none", rng: np.random.RandomState | None = None,
                    verbose: bool = False):
    """Experiment-parity closed loop (host loop, stateful solver).

    noise="uniform": x+ = f(x, u0) + E w with w ~ U[-1, 1]^nx from `rng`
    (default RandomState(0)), as the reference rocket experiment draws it.
    """
    m = model
    N = solver.N
    x0 = np.asarray(x0, float).reshape(-1)
    if rng is None:
        rng = np.random.RandomState(0)
    E = m.E.detach().cpu().numpy()

    T = sim_steps
    state_traj = np.zeros((m.nx, T))
    input_traj = np.zeros((m.nu, T - 1))
    nom_x = np.zeros((m.nx, N + 1, T))
    nom_u = np.zeros((m.nu, N, T))
    bo_x = np.zeros((m.nx, N + 1, T))
    bo_u = np.zeros((m.nu, N, T))
    t_solve = np.zeros((T, 1))

    state_traj[:, 0] = x0
    for i in range(T):
        if i > 0:
            solver.reset_warm_start()
        sol = solver.solve(x0)
        if "primal_x" not in sol:
            # unrecoverable failure (the nominal init failed): stop here
            print(f"[closed_loop] step {i}: solver failed hard; truncating run")
            break
        if not sol.get("success", False) and verbose:
            print(f"[closed_loop] step {i}: solver reported failure")
        t_solve[i] = sol.get("t_solve_ms", np.nan)
        bo_x[:, :, i] = sol["backoff_x"].T
        bo_u[:, :, i] = sol["backoff_u"].T
        nom_x[:, :, i] = sol["primal_x"]
        nom_u[:, :, i] = sol["primal_u"]
        state_traj[:, i] = sol["primal_x"][:, 0]

        u0 = sol["primal_u"][:, 0]
        if i < T - 1:
            input_traj[:, i] = u0
        as_t = lambda a: torch.as_tensor(a, dtype=solver.dtype, device=solver.Q.device)
        x_next = m.ddyn(as_t(x0), as_t(u0)).detach().cpu().numpy()
        if noise == "uniform":
            w = 2.0 * rng.rand(m.nx) - 1.0
            x_next = x_next + E @ w
        x0 = x_next

    return {
        "state_trajectory": state_traj,
        "input_trajectory": input_traj,
        "nominal_trajectory_x": nom_x,
        "nominal_trajectory_u": nom_u,
        "backoff_trajectory_x": bo_x,
        "backoff_trajectory_u": bo_u,
        "dt": m.dt,
        "g": m.g.detach().cpu().numpy(),
        "nx": m.nx,
        "nu": m.nu,
        "simulation_time_steps": T,
        "N": N,
        # timings (ms): the reference npz keys, all the whole per-step solve
        "t_jac": np.zeros((T, 1)),
        "t_qp": t_solve,
        "t_riccati": np.zeros((T, 1)),
        "t_solve": t_solve,
    }


def _accept_rti(X, U, persist, res):
    """RTI acceptance: any finite iterate (per lane), even from a reported
    failure; a non-finite solve keeps the previous plan and SLS state."""
    finite = lane_all_finite(res.X, res.U)
    X = lane_where(finite, res.X, X)
    U = lane_where(finite, res.U, U)
    persist = tree_where(finite, res.persist, persist)
    return X, U, persist, finite


def _accept_until_conv(X, U, res, it, restore, damp, damp_after):
    """Until-convergence acceptance: the finite gate, stall damping and
    feasibility restoration. Returns (X, U, ok, fail_now)."""
    ok = res.success & lane_all_finite(res.X, res.U)
    if damp > 0.0:
        # damped acceptance after the stall threshold contracts the
        # boundary-riding limit cycle toward its center
        alpha = torch.where(it >= damp_after, damp, 1.0).to(X.dtype)
        X_acc = X + alpha[:, None, None] * (res.X - X)
        U_acc = U + alpha[:, None, None] * (res.U - U)
    else:
        X_acc, U_acc = res.X, res.U
    if restore:
        # on an inner failure accept the soft-slacked iterate and keep
        # iterating; a restored iterate never passes the convergence test
        rest = ~ok & res.rest_ok
        X = lane_where(ok, X_acc, lane_where(rest, res.X_rest, X))
        U = lane_where(ok, U_acc, lane_where(rest, res.U_rest, U))
        fail_now = ~(ok | rest)
    else:
        X = lane_where(ok, X_acc, X)
        U = lane_where(ok, U_acc, U)
        fail_now = ~ok
    return X, U, ok, fail_now


class _ConvState(NamedTuple):
    """Per-lane state of one step's until-convergence SCP loop."""

    X: torch.Tensor
    U: torch.Tensor
    persist: FastSLSPersist
    bx: torch.Tensor
    bu: torch.Tensor
    qp_iters: torch.Tensor
    scp_iters: torch.Tensor
    done: torch.Tensor
    failed: torch.Tensor


def _conv_state0(solver, X, U, persist) -> _ConvState:
    """The loop's entry state. The backoffs start as NaN: a step whose first
    SCP iteration fails has no accepted tube, and a zero would fake a
    zero-width one."""
    B, N, m = X.shape[0], solver.N, solver.m
    nan = lambda *s: torch.full((B,) + s, float("nan"), dtype=X.dtype, device=X.device)
    zi = torch.zeros((B,), dtype=torch.int32, device=X.device)
    no = torch.zeros((B,), dtype=torch.bool, device=X.device)
    return _ConvState(X=X, U=U, persist=persist, bx=nan(N + 1, m.nx), bu=nan(N, m.nu),
                      qp_iters=zi, scp_iters=zi, done=no, failed=no)


class _RoundResult(NamedTuple):
    """What the acceptance of one SCP round reads of `SCPIterResult`."""

    X: torch.Tensor
    U: torch.Tensor
    success: torch.Tensor
    delta_vec: torch.Tensor
    persist: FastSLSPersist
    backoff_x: torch.Tensor
    backoff_u: torch.Tensor
    qp_iters: torch.Tensor
    X_rest: torch.Tensor | None
    U_rest: torch.Tensor | None
    rest_ok: torch.Tensor | None


def _undecided(st: _ConvState, max_scp: int):
    return ~st.done & ~st.failed & (st.scp_iters < max_scp)


def _accept_round(opts, st: _ConvState, res: _RoundResult, run) -> _ConvState:
    """The tail of one masked SCP round (the JAX `scp_chunk` body): the
    acceptance with stall damping and restoration, the convergence test; a
    lane not in `run` keeps its state."""
    X, U, ok, fail_now = _accept_until_conv(
        st.X, st.U, res, st.scp_iters, bool(opts.feasibility_restoration),
        float(opts.scp_stall_damping), int(opts.stall_damping_after))
    delta = lane_max(res.delta_vec.abs())
    new = _ConvState(
        X=X, U=U, persist=tree_where(ok, res.persist, st.persist),
        bx=lane_where(ok, res.backoff_x, st.bx), bu=lane_where(ok, res.backoff_u, st.bu),
        qp_iters=st.qp_iters + res.qp_iters, scp_iters=st.scp_iters + 1,
        done=ok & (delta < opts.epsilon_convergence), failed=fail_now,
    )
    return tree_where(run, new, st)


def _scp_round(solver, st: _ConvState, x, run, graphs: GraphSet) -> _ConvState:
    """One masked SCP iteration of every lane, `run` the undecided ones."""
    res = solver._iteration(st.X, st.U, x, st.persist, active=run, graphs=graphs)
    res = _RoundResult(X=res.X, U=res.U, success=res.success, delta_vec=res.delta_vec,
                       persist=res.persist, backoff_x=res.sls.backoff_x,
                       backoff_u=res.sls.backoff_u, qp_iters=res.sls.qp_iters,
                       X_rest=res.X_rest, U_rest=res.U_rest, rest_ok=res.rest_ok)
    return graphs.call("scp.accept", functools.partial(_accept_round, solver.opts),
                       st, res, run, into=st)


def _scp_until_converged(solver, st: _ConvState, x, per_read: int = 1,
                         graphs: GraphSet | None = None) -> _ConvState:
    """SCP rounds until every lane is decided (converged, failed, or at
    max_iter_scp): every round runs every lane, the decided ones frozen
    (`_scp_round`), and whether every lane is decided is read from the
    device once every `per_read` rounds (JAX's `scp_per_dispatch`; inside
    `no_host_sync()` never, so max_iter_scp rounds run). On the card
    (`graphs` capturing) the state lives in static buffers that the rounds'
    graphs update."""
    g = GraphSet() if graphs is None else graphs
    st, x = g.static("scp.state", st), g.static("scp.x", x)
    max_scp = int(solver.opts.max_iter_scp)
    per_read = max(1, int(per_read))
    for r in range(max_scp):
        run = _undecided(st, max_scp)
        if r and r % per_read == 0 and not g.any(run):
            break
        st = _scp_round(solver, st, x, run, g)
    return st


def _step_out(st: _ConvState, x):
    return (x, st.U[:, 0], st.X, st.U, st.bx, st.bu, st.done, st.qp_iters, st.scp_iters,
            st.failed)


def _advance(solver, X, U, persist, x, w_t):
    """Apply u0, step the plant and warm-shift the plan and the SLS state
    (the reference reset_warm_start; `SCPSLSSolver.reset_warm_start` is its
    stateful twin)."""
    m, N = solver.m, solver.N
    x_next = m.ddyn(x, U[:, 0]) + w_t @ m.E.T
    Xs, Us = solver._warm_shift(X, U)
    persist_next = FastSLSPersist.init(
        N, m.nx, m.nu, m.ni, m.ni_f, m.nw,
        batch=x.shape[0], dtype=x.dtype, device=x.device,
        keep_prev=persist.prev_primal,
        store_phi=persist.Phi_x.shape[2] > 0,
    )._replace(have_prev=persist.have_prev)
    if solver.opts.recycle_eta:
        shifted = warm_shift_persist(persist)
        persist_next = persist_next._replace(eta=shifted.eta, eta_f=shifted.eta_f)
        if solver.opts.recycle_warm_qp:
            persist_next = persist_next._replace(qp_warm=shifted.qp_warm)
    return Xs, Us, persist_next, x_next


def _advance_entry(solver, st: _ConvState, x, w_t):
    """`_advance` from the decided state, and the next step's entry state."""
    Xs, Us, persist, x_next = _advance(solver, st.X, st.U, st.persist, x, w_t)
    return _conv_state0(solver, Xs, Us, persist), x_next


def make_mpc_step(solver: SCPSLSSolver):
    """(carry, w_t) -> (carry', out) with carry = (X, U, persist, x), all
    batch-leading, and w_t (B, nw). out = (x, u0, X, U, backoff_x,
    backoff_u, success, qp_iters, scp_iters, scp_failed); qp_iters is the
    step's IPM iterations summed over its SCP iterations."""
    rti = int(solver.opts.rti)

    def mpc_step(carry, w_t):
        X, U, persist, x = carry
        if rti > 0:
            res = None
            qp_total = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
            for _ in range(rti):
                res = solver._iteration(X, U, x, persist, restore=False)
                X, U, persist, _ = _accept_rti(X, U, persist, res)
                qp_total = qp_total + res.sls.qp_iters
            bx, bu = res.sls.backoff_x, res.sls.backoff_u
            success, scp_failed = res.success, ~res.success
            scp_it = torch.full_like(qp_total, rti)
            out = (x, U[:, 0], X, U, bx, bu, success, qp_total, scp_it, scp_failed)
            return _advance(solver, X, U, persist, x, w_t), out
        # until convergence; step success = the SCP delta criterion met
        st = _scp_until_converged(solver, _conv_state0(solver, X, U, persist), x)
        return _advance(solver, st.X, st.U, st.persist, x, w_t), _step_out(st, x)

    return mpc_step


def make_mpc_scan(solver: SCPSLSSolver):
    """(carry, W (K, B, nw)) -> (carry after K steps, the K outs stacked K
    first): K steps of `make_mpc_step` in a row, the JAX `lax.scan` of
    `make_mpc_step`, and what `capture_mpc_step` records for K > 1."""
    step = make_mpc_step(solver)

    def scan(carry, W):
        outs = []
        for w_t in W:
            carry, out = step(carry, w_t)
            outs.append(out)
        return carry, tree_map(lambda *o: torch.stack(o), *outs)

    return scan


class CapturedMPCStep:
    """K RTI steps captured as one CUDA graph (`capture_mpc_step`).

    Calling it with (carry, w) copies the carry and w into the graph's static
    input buffers (the carry is not copied when it is the one the last replay
    returned), replays the graph and returns (carry', out). Both live in
    static buffers that the next replay overwrites: keep them with `clone`.
    `recording`: the capture's `utils.graph_loop.Recording` (its WHILE
    nodes, one a QP); `launched()`: each kernel's launches in every replay
    so far, those of the QPs' iterations from the nodes' device counters."""

    def __init__(self, solver, carry, steps):
        x = carry[3]
        device = x.device
        body = make_mpc_step(solver) if steps == 1 else make_mpc_scan(solver)
        self._w_shape = (x.shape[0], solver.m.nw) if steps == 1 else (steps, x.shape[0], solver.m.nw)
        self._w = torch.zeros((steps, x.shape[0], solver.m.nw), dtype=x.dtype, device=device)
        # the static input buffers: every tensor of the carry, persist's
        # tensors included (a zero-size Phi where store_phi is False)
        self._carry = tree_map(torch.clone, carry)

        run_steps = lambda: body(self._carry, self._w[0] if steps == 1 else self._w)
        # from the static copy: the caller's carry does not move
        warm_up(run_steps, device)

        self.graph = torch.cuda.CUDAGraph()
        with capturing(self.graph) as self.recording:
            c, out = run_steps()
            # an out that is an input buffer (the plant state x) is copied
            # before the carry goes back into the input buffers
            self._out = unaliased(out, avoid=self._carry)
            # the new carry goes back into the input buffers, as a scan's
            copy_tree_into(self._carry, c)
        self.replays = 0

    def launched(self):
        """The port's kernel launches of every replay so far (one host read)."""
        return self.recording.launches(self.replays)

    def __call__(self, carry, w):
        if tuple(w.shape) != self._w_shape:
            raise ValueError(f"the captured step takes w of shape {self._w_shape}, "
                             f"got {tuple(w.shape)}")
        copy_tree_into(self._carry, carry)
        self._w.copy_(w.reshape(self._w.shape))
        self.graph.replay()
        self.replays += 1
        return self._carry, self._out


def capture_mpc_step(solver: SCPSLSSolver, carry, steps: int = 1) -> CapturedMPCStep:
    """The RTI closed-loop step of `make_mpc_step`, `steps` of them in a row,
    captured on the card as one CUDA graph with its own memory pool: the
    `rti` SCP iterations of `_accept_rti` and `_advance`, each IPM loop a
    WHILE node that exits on the device where the eager loop exits
    (`utils.graph_loop.device_while`), so every lane ends bit for bit where
    the eager step leaves it, after as many IPM iterations.

    `carry` = (X, U, persist, x) gives the shapes (and the warm-up's state).
    Returns a callable with `make_mpc_step`'s contract, (carry, w) ->
    (carry', out); with steps = K > 1 it takes w (K, B, nw) and returns the
    carry after K steps and the K steps' outs stacked (K first), as a
    `lax.scan` does. Its outputs live in static buffers, which the next
    replay overwrites. Raises for the until-convergence step (rti <= 0: its
    SCP rounds run as graphs of their own, with host reads between them,
    in the converged drivers) and for a carry off the card; a failed capture
    or replay raises too."""
    if int(solver.opts.rti) <= 0:
        raise ValueError("capture_mpc_step captures the RTI step (rti > 0): the until-convergence "
                         "step decides on the host, between its graphs, whether to run another "
                         "round (build_chunked_converged_loop)")
    if carry[3].device.type != "cuda":
        raise RuntimeError(f"capture_mpc_step captures a CUDA graph: the carry is on "
                           f"{carry[3].device}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    return CapturedMPCStep(solver, carry, int(steps))


def _nominal(solver, x0s, graphs: GraphSet | None = None):
    """Hard SQP seed per lane: (X, U, success)."""
    with stage("seed.sqp"):
        nom = sqp_solve(solver.m, solver.N, solver.Q, solver.R, solver.Qf, x0s,
                        opts=solver.opts.sqp, graphs=graphs, name="seed.sqp.loop")
    return nom.X, nom.U, nom.success


def _soft_fallback(solver, x0s, X, U, hard_ok, chunk=None, graphs: GraphSet | None = None):
    """Re-seed the lanes whose hard SQP failed: the soft-slack SQP, then a
    hard polish from its point (kept where it succeeds), used where the soft
    solve succeeds. Only those lanes are solved (gathered on the host, as
    JAX's chunked driver does), `chunk` at a time (all at once when None);
    a last chunk that is short is padded to `chunk` by repeating its last
    lane, as in JAX, so one capture of the solvers' loops serves every
    chunk."""
    from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_nlp_solve

    m, N = solver.m, solver.N
    idx = (~hard_ok).nonzero().flatten()
    if idx.numel() == 0:
        return X, U
    X, U = X.clone(), U.clone()
    step = idx.numel() if chunk is None else int(chunk)
    for c0 in range(0, idx.numel(), step):
        ii = idx[c0 : c0 + step]
        n = ii.numel()
        ii_p = torch.cat([ii, ii[-1:].expand(step - n)]) if n < step else ii
        with stage("seed.soft_nlp"):
            soft = soft_nlp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s[ii_p],
                                  rho_soft=1e6, rho_soft_l1=1e6, graphs=graphs,
                                  name="seed.soft_nlp.loop")
        with stage("seed.polish"):
            hard = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s[ii_p],
                             X_init=soft.X, U_init=soft.U, opts=solver.opts.sqp,
                             graphs=graphs, name="seed.polish.loop")
        fb_X = lane_where(hard.success, hard.X, soft.X)[:n]
        fb_U = lane_where(hard.success, hard.U, soft.U)[:n]
        use = soft.success[:n]
        X[ii] = lane_where(use, fb_X, X[ii])
        U[ii] = lane_where(use, fb_U, U[ii])
    return X, U


def _stack_log(outs, sim_steps) -> ClosedLoopLog:
    stk = [torch.stack(v, dim=1) for v in zip(*outs)]
    xs, u0s, Xs, Us, bx, bu, succ, qpi, scpi, scpf = stk
    return ClosedLoopLog(
        state_trajectory=xs, input_trajectory=u0s[:, : sim_steps - 1],
        nominal_x=Xs, nominal_u=Us, backoff_x=bx, backoff_u=bu,
        success=succ, qp_iters=qpi, scp_iters=scpi, scp_failed=scpf,
    )


def _as_inputs(solver, x0s, Ws):
    dev = solver.Q.device
    return (torch.as_tensor(x0s, dtype=solver.dtype, device=dev),
            torch.as_tensor(Ws, dtype=solver.dtype, device=dev))


def _persist0(solver, B):
    m = solver.m
    return FastSLSPersist.init(
        solver.N, m.nx, m.nu, m.ni, m.ni_f, m.nw, batch=B, dtype=solver.dtype,
        device=solver.Q.device,
        # streaming mode never fills Phi: zero-size buffers
        store_phi=not solver._fast_sls_opts().streaming_response,
    )


def _converged_steps(solver, carry, Ws, per_read, graphs: GraphSet, record):
    """The until-convergence steps from the seed's carry: per step the SCP
    rounds (`_scp_until_converged`), the step's out, and `_advance` with the
    next step's entry state ("advance"), each piece run by `graphs`.
    Appends each step's host reads and piece runs to `record["steps"]` and
    its kernel launches to `record["step_launches"]` (Counters)."""
    X, U, persist, x = carry
    st = graphs.static("scp.state", _conv_state0(solver, X, U, persist))
    x = graphs.static("scp.x", x)
    advance = functools.partial(_advance_entry, solver)
    outs = []
    for t in range(Ws.shape[1]):
        before, launched = graphs.counts, graphs.kernel_launches()
        with stage("step"):
            st = _scp_until_converged(solver, st, x, per_read, graphs)
            # the static buffers are the next step's
            outs.append(tree_map(torch.clone, _step_out(st, x)))
            st, x = graphs.call("advance", advance, st, x, Ws[:, t], into=(st, x))
        record["steps"].append(graphs.counts - before)
        record["step_launches"].append(graphs.kernel_launches() - launched)
    return outs


def _closed_loop(solver: SCPSLSSolver, sim_steps: int, fallback_chunk=None, per_read=1,
                 capture=None):
    """run(x0s (B, nx), Ws (B, T, nw)) -> ClosedLoopLog: the SQP seed ("seed"
    stage; the soft fallback, `fallback_chunk` lanes at a time, with
    `nominal_soft_fallback`), then `sim_steps` MPC steps ("step" stages): in
    RTI mode on the card, replays of the step captured from the seed's
    carry (`capture_mpc_step`), else `make_mpc_step`'s; until convergence,
    `_converged_steps`, reading whether every lane is decided once every
    `per_read` SCP rounds. On the card (unless `capture` is False) the seed's
    loops and the converged step's pieces are CUDA graphs of one
    `GraphSet` a run. After a run, `run.record` holds whether it captured,
    the seed's and each converged step's host reads and piece runs, each
    converged step's kernel launches (Counters; `GraphSet.counts` and
    `kernel_launches`) and the host reads the loops made
    (`loop_host_reads`: none on the card, where each is a WHILE node)."""

    def run(x0s, Ws):
        x0s, Ws = _as_inputs(solver, x0s, Ws)
        graphs = GraphSet(x0s.device, capture)
        record = {"captured": graphs.capture, "steps": [], "step_launches": []}
        with stage("seed"):
            X, U, ok = _nominal(solver, x0s, graphs)
            if solver.opts.nominal_soft_fallback:
                X, U = _soft_fallback(solver, x0s, X, U, ok, chunk=fallback_chunk, graphs=graphs)
        record["seed"] = graphs.counts.copy()
        carry = (X, U, _persist0(solver, x0s.shape[0]), x0s)
        if int(solver.opts.rti) <= 0:
            outs = _converged_steps(solver, carry, Ws, per_read, graphs, record)
        else:
            captured = graphs.capture
            step = capture_mpc_step(solver, carry) if captured else make_mpc_step(solver)
            outs = []
            for t in range(sim_steps):
                with stage("step"):
                    carry, out = step(carry, Ws[:, t])
                # a replay overwrites the last one's outputs
                outs.append(tree_map(torch.clone, out) if captured else out)
        record["loop_host_reads"] = graphs.loop_reads
        run.record = record
        return _stack_log(outs, sim_steps)

    return run


def build_batched_closed_loop(solver: SCPSLSSolver, sim_steps: int, capture=None):
    """run(x0s (B, nx), Ws (B, T, nw)) -> ClosedLoopLog (batch-leading): the
    SQP seed of every lane (with `nominal_soft_fallback`, the soft-slack
    fallback on the lanes whose SQP failed), then `sim_steps` MPC steps
    under the disturbances Ws in [-1, 1] (scaled by E); until convergence,
    one read of whether every lane is decided after every SCP round. On
    the card its loops and pieces run as CUDA graphs (`capture=False`:
    eagerly)."""
    return _closed_loop(solver, sim_steps, capture=capture)


def build_chunked_converged_loop(solver: SCPSLSSolver, sim_steps: int,
                                 scp_per_dispatch: int = 2, mesh=None, capture=None):
    """The until-convergence closed loop whose soft fallback (with
    `nominal_soft_fallback`) solves the lanes whose hard SQP failed
    `soft_fallback_chunk(N)` lanes at a time, and which reads whether every
    lane is decided once every `scp_per_dispatch` SCP rounds: the JAX
    driver's bounded dispatches, after which it reads `decided`. Every
    round is masked, so `scp_per_dispatch` changes the host reads and no
    lane's result. On the card its loops and pieces run as CUDA graphs
    (`capture=False`: eagerly).

    Returns run(x0s (B, nx), Ws (B, T, nw)) -> ClosedLoopLog, with
    `run.record` (see `_closed_loop`) after a run. With a scenario `mesh`
    (`parallel.mesh.Mesh`) every rank calls run with the same global inputs
    (B divisible by the mesh size), runs the loop on its own block and
    returns the log gathered into the global layout."""
    from robust_nonlinear_mpc_torch.parallel.mesh import Mesh, sharded
    from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_fallback_chunk

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if int(solver.opts.rti) > 0:
        raise ValueError("the chunked driver is for the until-convergence mode (rti <= 0)")
    if int(scp_per_dispatch) < 1:
        raise ValueError(f"scp_per_dispatch must be >= 1, got {scp_per_dispatch}")
    run = _closed_loop(solver, sim_steps, fallback_chunk=soft_fallback_chunk(solver.N),
                       per_read=int(scp_per_dispatch), capture=capture)
    return run if mesh is None else sharded(mesh, run)

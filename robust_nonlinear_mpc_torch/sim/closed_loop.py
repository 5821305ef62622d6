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
  soft fallback in `soft_fallback_chunk(N)` chunks; otherwise
  `build_batched_closed_loop` (the JAX driver's bounded dispatches have no
  counterpart here, so `scp_per_dispatch` changes nothing); with a scenario
  mesh each rank runs its block of the lanes and the log is gathered.
* `run_closed_loop`: the experiment-parity host loop around the stateful
  `SCPSLSSolver`, with the reference npz keys.

The until-convergence loop is a masked batch loop: each SCP iteration runs
on the lanes still undecided (gathered, then scattered back), so a stopped
lane keeps its carry and costs nothing. Both converged drivers run the same
loop (`_scp_until_converged`), so they cannot drift apart.
"""

from __future__ import annotations

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
    tree_leaves,
    tree_map,
    tree_where,
)
from robust_nonlinear_mpc_torch.utils.host_sync import no_host_sync
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


def _scp_until_converged(solver, st: _ConvState, x) -> _ConvState:
    """SCP iterations on the undecided lanes (not converged, not failed,
    under max_iter_scp) until every lane is decided. Each iteration runs on
    those lanes only, gathered and scattered back."""
    opts = solver.opts
    eps = opts.epsilon_convergence
    max_scp = int(opts.max_iter_scp)
    restore = bool(opts.feasibility_restoration)
    damp = float(opts.scp_stall_damping)
    damp_after = int(opts.stall_damping_after)
    while True:
        run = ~st.done & ~st.failed & (st.scp_iters < max_scp)
        idx = run.nonzero().flatten()
        if idx.numel() == 0:
            break
        whole = idx.numel() == run.numel()
        take = (lambda t: t) if whole else (lambda t: t[idx])
        sub = tree_map(take, st)
        res = solver._iteration(sub.X, sub.U, take(x), sub.persist)
        X, U, ok, fail_now = _accept_until_conv(sub.X, sub.U, res, sub.scp_iters,
                                                restore, damp, damp_after)
        delta = lane_max(res.delta_vec.abs())
        new = _ConvState(
            X=X, U=U, persist=tree_where(ok, res.persist, sub.persist),
            bx=lane_where(ok, res.sls.backoff_x, sub.bx),
            bu=lane_where(ok, res.sls.backoff_u, sub.bu),
            qp_iters=sub.qp_iters + res.sls.qp_iters, scp_iters=sub.scp_iters + 1,
            done=ok & (delta < eps), failed=fail_now,
        )
        st = new if whole else tree_map(lambda old, nw: old.index_copy(0, idx, nw), st, new)
    return st


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
        else:
            # until convergence; step success = the SCP delta criterion met
            st = _scp_until_converged(solver, _conv_state0(solver, X, U, persist), x)
            X, U, persist = st.X, st.U, st.persist
            bx, bu, qp_total = st.bx, st.bu, st.qp_iters
            success, scp_it, scp_failed = st.done, st.scp_iters, st.failed
        out = (x, U[:, 0], X, U, bx, bu, success, qp_total, scp_it, scp_failed)
        return _advance(solver, X, U, persist, x, w_t), out

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


def _copy_into(dst, src):
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(f"the captured step takes {dst.dtype} {tuple(dst.shape)}, "
                         f"got {src.dtype} {tuple(src.shape)}")
    dst.copy_(src)


class CapturedMPCStep:
    """K RTI steps captured as one CUDA graph (`capture_mpc_step`).

    Calling it with (carry, w) copies the carry and w into the graph's static
    input buffers (the carry is not copied when it is the one the last replay
    returned), replays the graph and returns (carry', out). Both live in
    static buffers that the next replay overwrites: keep them with `clone`.
    `launches`: each kernel's launches in one replay, counted by the
    wrappers at capture (a replay launches without them)."""

    def __init__(self, solver, carry, steps):
        from robust_nonlinear_mpc_torch.ops.cuda_lib import launch_counts

        x = carry[3]
        device = x.device
        body = make_mpc_step(solver) if steps == 1 else make_mpc_scan(solver)
        self._w_shape = (x.shape[0], solver.m.nw) if steps == 1 else (steps, x.shape[0], solver.m.nw)
        self._w = torch.zeros((steps, x.shape[0], solver.m.nw), dtype=x.dtype, device=device)
        # the static input buffers: every tensor of the carry, persist's
        # tensors included (a zero-size Phi where store_phi is False)
        self._carry = tree_map(torch.clone, carry)

        run_steps = lambda: body(self._carry, self._w[0] if steps == 1 else self._w)

        # warm-up on a side stream, from the static copy (the caller's carry
        # does not move): builds the kernel library, creates the cuBLAS
        # handles and sets the kernels' shared-memory attributes
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side), no_host_sync():
            run_steps()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)

        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph), no_host_sync():
            c, out = run_steps()
            # an out that is an input buffer (the plant state x) is copied
            # before the carry goes back into the input buffers
            inputs = {t.data_ptr() for t in tree_leaves(self._carry) if t.numel()}
            self._out = tree_map(lambda t: t.clone() if t.data_ptr() in inputs else t, out)
            # the new carry goes back into the input buffers, as a scan's
            tree_map(_copy_into, self._carry, c)
        self.launches = {k: v - before[k] for k, v in launch_counts().items()}

    def __call__(self, carry, w):
        if tuple(w.shape) != self._w_shape:
            raise ValueError(f"the captured step takes w of shape {self._w_shape}, "
                             f"got {tuple(w.shape)}")
        if carry is not self._carry:
            tree_map(_copy_into, self._carry, carry)
        self._w.copy_(w.reshape(self._w.shape))
        self.graph.replay()
        return self._carry, self._out


def capture_mpc_step(solver: SCPSLSSolver, carry, steps: int = 1) -> CapturedMPCStep:
    """The RTI closed-loop step of `make_mpc_step`, `steps` of them in a row,
    captured on the card as one CUDA graph with its own memory pool: the
    `rti` SCP iterations of `_accept_rti` and `_advance`, with the IPM loops
    at their host-known iteration bounds (`utils.host_sync.no_host_sync`),
    so every lane ends bit for bit where the eager step leaves it.

    `carry` = (X, U, persist, x) gives the shapes (and the warm-up's state).
    Returns a callable with `make_mpc_step`'s contract, (carry, w) ->
    (carry', out); with steps = K > 1 it takes w (K, B, nw) and returns the
    carry after K steps and the K steps' outs stacked (K first), as a
    `lax.scan` does. Its outputs live in static buffers, which the next
    replay overwrites. Raises for the until-convergence step (rti <= 0,
    whose SCP rounds gather lanes on the host) and for a carry off the
    card; a failed capture or replay raises too."""
    if int(solver.opts.rti) <= 0:
        raise ValueError("capture_mpc_step captures the RTI step (rti > 0): the until-convergence "
                         "step gathers the undecided lanes on the host")
    if carry[3].device.type != "cuda":
        raise RuntimeError(f"capture_mpc_step captures a CUDA graph: the carry is on "
                           f"{carry[3].device}")
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    return CapturedMPCStep(solver, carry, int(steps))


def _nominal(solver, x0s):
    """Hard SQP seed per lane: (X, U, success)."""
    with stage("seed.sqp"):
        nom = sqp_solve(solver.m, solver.N, solver.Q, solver.R, solver.Qf, x0s,
                        opts=solver.opts.sqp)
    return nom.X, nom.U, nom.success


def _soft_fallback(solver, x0s, X, U, hard_ok, chunk=None):
    """Re-seed the lanes whose hard SQP failed: the soft-slack SQP, then a
    hard polish from its point (kept where it succeeds), used where the soft
    solve succeeds. Only those lanes are solved, `chunk` at a time (all at
    once when None)."""
    from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_nlp_solve

    m, N = solver.m, solver.N
    idx = (~hard_ok).nonzero().flatten()
    if idx.numel() == 0:
        return X, U
    X, U = X.clone(), U.clone()
    step = idx.numel() if chunk is None else int(chunk)
    for c0 in range(0, idx.numel(), step):
        ii = idx[c0 : c0 + step]
        with stage("seed.soft_nlp"):
            soft = soft_nlp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s[ii],
                                  rho_soft=1e6, rho_soft_l1=1e6)
        with stage("seed.polish"):
            hard = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0s[ii],
                             X_init=soft.X, U_init=soft.U, opts=solver.opts.sqp)
        X[ii] = lane_where(soft.success, lane_where(hard.success, hard.X, soft.X), X[ii])
        U[ii] = lane_where(soft.success, lane_where(hard.success, hard.U, soft.U), U[ii])
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


def _closed_loop(solver: SCPSLSSolver, sim_steps: int, fallback_chunk=None):
    """run(x0s (B, nx), Ws (B, T, nw)) -> ClosedLoopLog: the SQP seed ("seed"
    stage; the soft fallback, `fallback_chunk` lanes at a time, with
    `nominal_soft_fallback`), then `sim_steps` MPC steps ("step" stages): in
    RTI mode on the card, replays of the step captured from the seed's
    carry (`capture_mpc_step`), else `make_mpc_step`."""

    def run(x0s, Ws):
        x0s, Ws = _as_inputs(solver, x0s, Ws)
        with stage("seed"):
            X, U, ok = _nominal(solver, x0s)
            if solver.opts.nominal_soft_fallback:
                X, U = _soft_fallback(solver, x0s, X, U, ok, chunk=fallback_chunk)
        carry = (X, U, _persist0(solver, x0s.shape[0]), x0s)
        captured = int(solver.opts.rti) > 0 and x0s.device.type == "cuda"
        step = capture_mpc_step(solver, carry) if captured else make_mpc_step(solver)
        outs = []
        for t in range(sim_steps):
            with stage("step"):
                carry, out = step(carry, Ws[:, t])
            # a replay overwrites the last one's outputs
            outs.append(tree_map(torch.clone, out) if captured else out)
        return _stack_log(outs, sim_steps)

    return run


def build_batched_closed_loop(solver: SCPSLSSolver, sim_steps: int):
    """run(x0s (B, nx), Ws (B, T, nw)) -> ClosedLoopLog (batch-leading): the
    SQP seed of every lane (with `nominal_soft_fallback`, the soft-slack
    fallback on the lanes whose SQP failed), then `sim_steps` MPC steps
    under the disturbances Ws in [-1, 1] (scaled by E)."""
    return _closed_loop(solver, sim_steps)


def build_chunked_converged_loop(solver: SCPSLSSolver, sim_steps: int,
                                 scp_per_dispatch: int = 2, mesh=None):
    """The until-convergence closed loop whose soft fallback (with
    `nominal_soft_fallback`) solves the lanes whose hard SQP failed
    `soft_fallback_chunk(N)` lanes at a time; otherwise
    `build_batched_closed_loop`, so the results are equal. The JAX driver
    advances the undecided lanes `scp_per_dispatch` SCP iterations per
    device dispatch; here every SCP iteration already returns to the host
    and runs only the undecided lanes, so `scp_per_dispatch` is accepted for
    parity and changes nothing.

    Returns run(x0s (B, nx), Ws (B, T, nw)) -> ClosedLoopLog. With a scenario
    `mesh` (`parallel.mesh.Mesh`) every rank calls run with the same global
    inputs (B divisible by the mesh size), runs the undecided-lane loop on
    its own block and returns the log gathered into the global layout."""
    from robust_nonlinear_mpc_torch.parallel.mesh import Mesh, sharded
    from robust_nonlinear_mpc_torch.solvers.soft_nlp import soft_fallback_chunk

    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if int(solver.opts.rti) > 0:
        raise ValueError("the chunked driver is for the until-convergence mode (rti <= 0)")
    run = _closed_loop(solver, sim_steps, fallback_chunk=soft_fallback_chunk(solver.N))
    return run if mesh is None else sharded(mesh, run)

"""PyTorch port: guarantee mode in the JAX form (float64, CPU), on the
pendulum of tests/test_torch_converged.py (N = 8, B = 4 lanes, 3 steps),
with feasibility restoration and stall damping both taken.

* One masked SCP round (`sim.closed_loop._scp_round`: every lane, the
  decided ones frozen) and one body of fast-SLS's inner loop, each inside
  `no_host_sync()` (the form a CUDA graph captures) under a dispatch mode
  that raises on every host read: no host read, and bit for bit the eager
  run; the inner loop as a `utils.graph_loop.CapturedLoop` (eager on the
  CPU: a host read before every body, where the card's WHILE node tests on
  the device) ends where `device_while` and the loop at its cap inside
  `no_host_sync()` end.
* `build_chunked_converged_loop` at scp_per_dispatch 1 and 2 against JAX's
  `build_chunked_converged_loop`: per lane and step success, SCP
  iterations, scp_failed and QP iterations identical; X, U, u0 and the
  backoffs within 1e-8 (NaN where JAX has NaN); scp_per_dispatch changes
  the host reads of a step and no lane's result.
* The SQP's and the soft NLP's masked loops run to their caps inside
  `no_host_sync()` (their bodies under the probe: no host read) equal the
  early-exit loops.
"""

import jax.numpy as jnp
import pytest
import torch
from threadpoolctl import threadpool_limits

from robust_nonlinear_mpc_torch.sim import closed_loop as tcl
from robust_nonlinear_mpc_torch.solvers import fast_sls as tfs
from robust_nonlinear_mpc_torch.solvers.soft_nlp import SOFT_SQP_OPTS, soft_nlp_solve
from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve
from robust_nonlinear_mpc_torch.utils.graph_loop import CapturedLoop, GraphSet, device_while
from robust_nonlinear_mpc_torch.utils.host_sync import no_host_sync
from robust_nonlinear_mpc_tpu.sim.closed_loop import build_chunked_converged_loop

from test_torch_capture import HostReadProbe, assert_same
from test_torch_converged import T, _compare, _draws, _pendulum

MITIGATIONS = dict(tight=True, feasibility_restoration=True, scp_stall_damping=0.5,
                   stall_damping_after=2)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    m, solver, tsolver = _pendulum(**MITIGATIONS)
    x0s, Ws = _draws(3, center=(0.3, 0.5, 0.1, 0.0), spread=0.05)
    return m, solver, tsolver, x0s, Ws


def test_masked_round_and_loop_body_make_no_host_read(problem):
    _, _, tsolver, x0s, _ = problem
    x = torch.as_tensor(x0s)
    X, U, _ = tcl._nominal(tsolver, x)
    st = tcl._conv_state0(tsolver, X, U, tcl._persist0(tsolver, x.shape[0]))
    max_scp = int(tsolver.opts.max_iter_scp)
    # the first round, lane 1 already decided; the inner loop cut to 6
    # iterations (the masked form runs it to its cap)
    st = st._replace(done=torch.tensor([False, True, False, False]))
    run = tcl._undecided(st, max_scp)
    opts = tsolver.opts
    tsolver.opts = opts._replace(sls_max_iter=6)
    try:
        eager = tcl._scp_round(tsolver, st, x, run, GraphSet())
        with no_host_sync(), HostReadProbe():
            masked = tcl._scp_round(tsolver, st, x, run, GraphSet())
    finally:
        tsolver.opts = opts
    assert_same(masked, eager)
    assert torch.equal(eager.X[1], st.X[1]) and int(eager.scp_iters[1]) == 0
    assert eager.scp_iters.tolist() == [1, 0, 1, 1]

    # fast-SLS's inner loop on this round's deviation problem, lane 1 entering stopped
    prob, opts = tsolver.prob, tsolver._fast_sls_opts()
    dev = tsolver.assemble_deviation_problem(st.X, st.U, x)
    carry, pre = tfs._head(prob, opts, dev, st.persist, run)
    body = lambda c, *a: tfs._body(prob, opts, c, *a)
    one = body(carry, dev, st.persist, pre)
    with no_host_sync(), HostReadProbe():
        masked = body(carry, dev, st.persist, pre)
    assert_same(masked, one)
    cap = int(opts.max_iter) - 1
    loop = CapturedLoop(body, carry, cap, cond=tfs._any_running)
    args = (dev, st.persist, pre)
    end = loop(carry, *args)
    n = loop.replays
    assert 1 < n < cap and loop.reads == n + 1
    assert_same(device_while(tfs._any_running, body, carry, *args, cap=cap), end)
    with no_host_sync(), HostReadProbe():
        capped = device_while(tfs._any_running, body, carry, *args, cap=cap)
    assert_same(capped, end)
    assert int(end.iteration_number[1]) == int(carry.iteration_number[1])


def test_masked_loop_matches_jax_chunked(problem):
    _, solver, tsolver, x0s, Ws = problem
    ref = build_chunked_converged_loop(solver, T, scp_per_dispatch=2)(
        jnp.asarray(x0s), jnp.asarray(Ws))
    restored = []
    restore = tsolver._restore

    def counting(*a):
        out = restore(*a)
        restored.append(int(out[2].sum()))
        return out

    tsolver._restore = counting
    runs, logs = {}, {}
    try:
        for kpd in (1, 2):
            runs[kpd] = tcl.build_chunked_converged_loop(tsolver, T, scp_per_dispatch=kpd)
            logs[kpd] = runs[kpd](x0s, Ws)
            _compare(ref, logs[kpd])
    finally:
        del tsolver._restore
    # both mitigations are taken: a restored iterate on some SCP iteration,
    # and lanes past the damping threshold
    assert sum(restored) > 0
    assert int(logs[1].scp_iters.max()) > 2
    for f, a in logs[1]._asdict().items():
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(getattr(logs[2], f))), f
    reads = {k: [c["host_reads"] for c in r.record["steps"]] for k, r in runs.items()}
    assert not runs[1].record["captured"]
    assert all(a > b for a, b in zip(reads[1], reads[2])), reads


class ProbedLoops(GraphSet):
    """Eager loops whose bodies run under the host-read probe: what a
    `CapturedLoop` captures."""

    def loop(self, name, cond, body, state, *args, **kw):
        def probed(st, *a):
            with HostReadProbe():
                return body(st, *a)

        return super().loop(name, cond, probed, state, *args, **kw)


def test_seed_loops_at_their_caps_equal_the_early_exit(problem):
    _, _, tsolver, x0s, _ = problem
    x = torch.as_tensor(x0s)
    nlp = tsolver.m, tsolver.N, tsolver.Q, tsolver.R, tsolver.Qf, x
    # caps cut to 7 SQP iterations and 3 soft ones (of 40 IPM iterations):
    # lanes stop before them
    sqp_opts = tsolver.opts.sqp._replace(max_iter=7)
    soft_opts = SOFT_SQP_OPTS._replace(max_iter=3, ipm=SOFT_SQP_OPTS.ipm._replace(max_iter=40))
    eager = sqp_solve(*nlp, opts=sqp_opts), soft_nlp_solve(*nlp, opts=soft_opts)
    with no_host_sync():
        masked = (sqp_solve(*nlp, opts=sqp_opts),
                  soft_nlp_solve(*nlp, opts=soft_opts, graphs=ProbedLoops()))
    assert_same(masked, eager)
    assert bool(eager[0].success.all())
    assert int(eager[0].iters.max()) < 7 and int(eager[1].iters.min()) < 3

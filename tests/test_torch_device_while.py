"""PyTorch port: the IPM loop as one (cond, body) pair and the loop that
runs it, `utils.graph_loop.device_while` (float64, CPU), on rocket QPs (the
deviation QPs of `make_rocket_problem` around one SQP iteration's plans
from perturbed X0 states) at B = 7 lanes (not a multiple of any tile)
with per-lane iteration caps, at N = 6 and at N = 60 (the Riccati
recursion symmetrizes P at every stage).

* `solve_qp` in its three forms on the CPU, bit for bit: eagerly (a host
  read of "any lane active" before every iteration), the pair of
  `qp_ipm.ipm_loop` run by `graph_loop.while_loop`, and the cap form inside
  `no_host_sync()` (no host read: the dispatch probe of
  tests/test_torch_capture.py); and the pair under the plain twin of the
  WHILE node's test (`ops.graph_while.plain_condition`), which runs exactly
  as many bodies as the slowest lane's iterations. The card's form, a WHILE
  node in a captured graph, is held against the eager solve by
  `chip_smoke.py` phase 2b and tests/test_torch_cuda.py.
* The three forms against the JAX `vmap(solve_qp)` with the same caps:
  identical iterations and success, X / U within 1e-8.
* `device_while`'s contract: a body that writes its state in place gives
  the functional body's result and leaves the caller's state as it was,
  eagerly and at the cap; the node's twin stops at the host-known cap when
  the condition never turns false, and runs no body when it is false at
  once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from robust_nonlinear_mpc_torch.expe.main_rocket_robust_closed_loop import (
    X0,
    make_rocket_problem,
)
from robust_nonlinear_mpc_torch.ops import graph_while
from robust_nonlinear_mpc_torch.ops import qp_ipm as tq
from robust_nonlinear_mpc_torch.solvers.sqp import sqp_solve
from robust_nonlinear_mpc_torch.utils.graph_loop import device_while, while_loop
from robust_nonlinear_mpc_torch.utils.host_sync import no_host_sync
from robust_nonlinear_mpc_tpu.ops import qp_ipm as jq

from test_torch_capture import HostReadProbe, assert_same

BSZ, TOL = 7, 1e-8
# per-lane caps: lanes 1 and 4 stop at theirs, the others converge first
CASES = {6: (20, [20, 3, 20, 20, 5, 20, 20]), 60: (30, [30, 3, 30, 30, 5, 30, 30])}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


def _rocket_qps(N, seed=3):
    """The deviation QPs around the plans of one SQP iteration from
    perturbed X0 states (random plans make most QPs at N = 60 stall)."""
    m, solver = make_rocket_problem(N=N, device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(np.array(X0)[None] + 0.02 * rng.standard_normal((BSZ, 17)))
    plan = sqp_solve(m, N, solver.Q, solver.R, solver.Qf, x0,
                     opts=solver.opts.sqp._replace(max_iter=1))
    A, B, c, qx, qu, g_res, gf_res, xd = solver.assemble_deviation_problem(plan.X, plan.U, x0)
    data = tq.QPData(A=A, B=B, c=c, qx=qx, qu=qu, h=g_res, hf=gf_res, xinit=xd)
    return solver.prob.stat, data


@pytest.fixture(scope="module", params=sorted(CASES), ids=lambda n: f"N{n}")
def case(request):
    """The QPs of one horizon, their caps, and the JAX reference."""
    N = request.param
    bound, caps = CASES[N]
    with threadpool_limits(limits=1):
        stat, data = _rocket_qps(N)
        js = jq.QPStatics(**{k: jnp.asarray(v.numpy()) for k, v in stat._asdict().items()})
        jd = jq.QPData(**{k: jnp.asarray(v.numpy()) for k, v in data._asdict().items()})
        jopts = jq.IPMOptions(max_iter=bound, tol=1e-9)
        ref = jax.jit(jax.vmap(lambda d, c: jq.solve_qp(js, d, jopts, max_iter_dyn=c)))(
            jd, jnp.asarray(caps, jnp.int32))
    opts = tq.IPMOptions(max_iter=bound, tol=1e-9, kkt="riccati")
    return stat, data, opts, bound, torch.tensor(caps, dtype=torch.int32), ref


def _forms(stat, data, opts, bound, caps):
    """solve_qp eagerly, the (cond, body) pair by while_loop, and the cap
    form inside no_host_sync() under the host-read probe."""
    eager = tq.solve_qp(stat, data, opts, max_iter_dyn=caps)
    cond, body, carry, finish = tq.ipm_loop(stat, data, opts, max_iter_dyn=caps)
    pair = finish(while_loop(cond, body, carry, cap=bound))
    with no_host_sync(), HostReadProbe():
        capped = tq.solve_qp(stat, data, opts, max_iter_dyn=caps, max_iter_bound=bound)
    return eager, pair, capped


@pytest.fixture(scope="module")
def forms(case):
    """`_forms` of one horizon's QPs, solved once for both tests."""
    stat, data, opts, bound, caps, _ = case
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(limits=1):
            return _forms(stat, data, opts, bound, caps)
    finally:
        torch.set_num_threads(threads)


def test_solve_qp_forms_are_bit_for_bit(case, forms):
    stat, data, opts, bound, caps, _ = case
    eager, pair, capped = forms
    assert_same(pair, eager)
    assert_same(capped, eager)
    # the node's twin: the test before the first body and after each one
    cond, body, carry, finish = tq.ipm_loop(stat, data, opts, max_iter_dyn=caps)
    runs = torch.zeros(2, dtype=torch.int64)
    go = graph_while.plain_condition(cond(carry), runs, bound, after_body=False)
    while bool(go):
        carry = body(carry)
        go = graph_while.plain_condition(cond(carry), runs, bound, after_body=True)
    assert_same(finish(carry), eager)
    assert int(runs[1]) == int(eager.iters.max()) < bound
    # lanes 1 and 4 run to their caps, the others converge before them
    assert eager.iters[1] == 3 and eager.iters[4] == 5
    others = [0, 2, 3, 5, 6]
    assert eager.success[others].all() and (eager.iters[others] > 5).all()


def test_solve_qp_forms_match_jax(case, forms):
    ref = case[-1]
    for got in forms:
        assert got.iters.tolist() == np.asarray(ref.iters).tolist()
        assert got.success.tolist() == np.asarray(ref.success).tolist()
        for f in ("X", "U", "lam"):
            err = np.abs(getattr(got, f).numpy() - np.asarray(getattr(ref, f))).max()
            assert err <= TOL, (f, err)


def _count(state, target):
    x, acc = state
    run = x < target
    return x + run.to(x.dtype), acc + run.to(acc.dtype)[:, None] * torch.tanh(acc + 1.0)


def _count_in_place(state, target):
    x, acc = state
    run = x < target
    acc.add_(run.to(acc.dtype)[:, None] * torch.tanh(acc + 1.0))
    x.add_(run.to(x.dtype))
    return state


def _any_below(state, target):
    return (state[0] < target).any()


@pytest.mark.parametrize("form", ["eager", "cap"])
def test_device_while_in_place_body_gives_the_functional_result(form):
    rng = np.random.default_rng(0)
    target = torch.as_tensor(rng.integers(0, 9, BSZ), dtype=torch.int32)
    state = (torch.zeros(BSZ, dtype=torch.int32),
             torch.as_tensor(rng.standard_normal((BSZ, 3))))
    kept = tuple(t.clone() for t in state)
    with no_host_sync() if form == "cap" else torch.no_grad():
        functional = device_while(_any_below, _count, state, target, cap=12)
        in_place = device_while(_any_below, _count_in_place, state, target, cap=12)
    assert_same(in_place, functional)
    assert_same(state, kept)
    assert torch.equal(functional[0], target)


def test_node_twin_stops_at_the_cap_and_before_a_false_condition():
    runs = torch.zeros(2, dtype=torch.int64)
    yes, no = torch.tensor(True), torch.tensor(False)
    assert not bool(graph_while.plain_condition(no, runs, 5, after_body=False))
    bodies, go = 0, graph_while.plain_condition(yes, runs, 5, after_body=False)
    while bool(go):
        bodies += 1
        go = graph_while.plain_condition(yes, runs, 5, after_body=True)
    assert bodies == 5 and runs.tolist() == [5, 5]
    # a new launch starts its count afresh; the total keeps counting
    assert bool(graph_while.plain_condition(yes, runs, 5, after_body=False))
    assert runs.tolist() == [0, 5]

"""PyTorch port: the multi-device layer (`parallel/mesh.py`,
`parallel/distributed.py`, `parallel/columns.py`, `parallel/mc.py`, the
column mesh of `fast_sls_solve` and the mesh of
`build_chunked_converged_loop`) against the JAX package (float64, CPU).

One module-scoped world of W = 3 gloo ranks (`parallel.distributed.launch`,
in a subprocess, over a file store in the test's temporary directory): with
three ranks the 13 columns of N = 12 need 2 pad columns, and B = 6 lanes
split evenly. Every rank writes its results to an npz file; the tests read
them, while the JAX references are computed beside the ranks:

* the column-sharded backward Riccati, response and tube iteration against
  the JAX dense forms: rtol 1e-10;
* the sharded Monte-Carlo on the pendulum of
  tests/test_distributed_multiprocess.py (N = 4, B = 6, 2 steps) against
  JAX `run_monte_carlo` on a 3-device mesh: counts and flags exact,
  trajectories and the cost 1e-9 relative;
* the chunked converged driver with the mesh (one step at the dry-run
  budget) against the one-process port run: identical iteration counts,
  X/U 1e-9;
* `init_distributed` and `multihost_throughput`'s keys;
* `SCPSLSSolver.solve` (and so `fast_sls_solve`) with a column mesh against
  the unsharded solve, pendulum widths at N = 12: 1e-9.

In this process, a world of one rank: every sharded function equals its
unsharded path exactly, the tube forms to rounding.
"""

import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from robust_nonlinear_mpc_torch.ops import sls_kernels as tk
from robust_nonlinear_mpc_torch.parallel import columns as tcol
from robust_nonlinear_mpc_torch.parallel.distributed import init_distributed
from robust_nonlinear_mpc_torch.parallel.mc import run_monte_carlo as t_run_mc
from robust_nonlinear_mpc_torch.parallel.mesh import scenario_mesh
from robust_nonlinear_mpc_torch.sim.closed_loop import build_chunked_converged_loop
from robust_nonlinear_mpc_tpu.models import Pendulum as JPendulum
from robust_nonlinear_mpc_tpu.ops import sls_kernels as jk
from robust_nonlinear_mpc_tpu.parallel.mc import run_monte_carlo as j_run_mc
from robust_nonlinear_mpc_tpu.parallel.mesh import scenario_mesh as j_scenario_mesh
from robust_nonlinear_mpc_tpu.solvers.scp_sls import SCPSLSSolver as JSolver

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
WORLD, N_COL, EPS = 3, 12, 1e-10
B_MC, T_MC = 6, 2
DRYRUN = dict(rti=-1, fast_sls_rti_steps=0, epsilon_convergence=1e-4, max_iter_scp=12,
              sls_max_iter=20)


def port_pendulum(N, **opts):
    """The pendulum solver of tests/test_distributed_multiprocess.py in the
    port (CPU, float64); `opts` edit its options."""
    import numpy as np
    import torch

    from robust_nonlinear_mpc_torch.models.pendulum import Pendulum
    from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSSolver

    m = Pendulum(device="cpu")
    m.E = torch.as_tensor(0.003 * np.eye(4), dtype=torch.float64)
    solver = SCPSLSSolver(N, np.eye(4), np.eye(1), m, 10 * np.eye(4), Q_reg=1e3 * np.eye(4),
                          R_reg=1e3 * np.eye(1), Q_reg_f=1e4 * np.eye(4), rti=1,
                          fast_sls_rti_steps=1, device="cpu")
    solver.opts = solver.opts._replace(verbose=False, **opts)
    return solver


# Each rank's work: the inputs come from in.npz, the results go to
# rank<r>.npz. The script imports only torch and the port.
_WORKER = '''
import json
import sys

import numpy as np
import torch

DRYRUN = {dryrun!r}

{port_pendulum}

def work(out_dir):
    from robust_nonlinear_mpc_torch.ops.sls_kernels import SLSRegs, evaluate_dual_eta
    from robust_nonlinear_mpc_torch.parallel import columns as col
    from robust_nonlinear_mpc_torch.parallel.distributed import (
        global_scenario_mesh, init_distributed, multihost_throughput)
    from robust_nonlinear_mpc_torch.parallel.mc import run_monte_carlo
    from robust_nonlinear_mpc_torch.sim.closed_loop import build_chunked_converged_loop

    torch.set_num_threads(1)
    world = init_distributed()      # the group launch started is kept
    mesh = global_scenario_mesh()
    inp = {{k: torch.as_tensor(v) for k, v in np.load(out_dir + "/in.npz").items()}}
    out = {{"world": world, "rank": mesh.rank, "size": mesh.size}}

    regs = SLSRegs(inp["Q_reg"], inp["R_reg"], inp["Q_reg_f"])
    A, B, E, Gmat, Gf = (inp[k] for k in ("A", "B", "E", "Gmat", "Gf"))
    nx = A.shape[2]
    eta, eta_f = evaluate_dual_eta(inp["mu"], inp["mu_f"], inp["beta"], inp["beta_f"], 1e-10)
    out["bwd_K"] = col.column_sharded_backward_solve(mesh, A, B, Gmat, Gf, eta, eta_f, regs)
    for name, t in zip(("beta", "beta_f", "backoff", "backoff_f", "cost"),
                       col.column_sharded_response(mesh, A, B, E, inp["K_ref"], Gmat[:, :nx],
                                                   Gmat[:, nx:], Gf, regs, 1e-10)):
        out["resp_" + name] = t
    for name, t in zip(("K", "beta", "beta_f", "backoff", "backoff_f", "cost"),
                       col.sharded_tube_iteration(mesh, A, B, E, Gmat, Gf, inp["mu"],
                                                  inp["mu_f"], inp["beta"], inp["beta_f"], regs,
                                                  1e-10)):
        out["tube_" + name] = t

    solver = port_pendulum(4)
    logs, stats = run_monte_carlo(solver, 2, inp["x0s"], inp["Ws"], mesh=mesh)
    for k, v in logs._asdict().items():
        out["mc_" + k] = v
    out["mc_stats"] = np.array(list(stats), dtype=float)

    conv = port_pendulum(4, **DRYRUN)
    logs_c = build_chunked_converged_loop(conv, 1, mesh=mesh)(inp["x0s"], inp["Ws"][:, :1])
    for k, v in logs_c._asdict().items():
        out["conv_" + k] = v

    thr = multihost_throughput(solver, 2, scenarios_per_device=2, reps=1)
    out["thr"] = json.dumps(thr)

    x0 = np.array([0.5, 0.5, 0.0, 0.0])
    for name, cm in (("sharded", col.column_mesh()), ("dense", None)):
        s = port_pendulum(12, streaming_response=True, column_mesh=cm)
        sols = [s.solve(x0)]
        s.reset_warm_start()
        sols.append(s.solve(0.9 * x0))
        for i, sol in enumerate(sols):
            for k in ("primal_u", "backoff_x", "success"):
                out[f"sls_{{name}}{{i}}_{{k}}"] = np.asarray(sol[k])
    np.savez(f"{{out_dir}}/rank{{mesh.rank}}.npz",
             **{{k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in out.items()}})
    return mesh.rank


if __name__ == "__main__":
    from robust_nonlinear_mpc_torch.parallel.distributed import launch

    print("RESULT", launch(work, int(sys.argv[2]), sys.argv[1], backend="gloo", timeout=600))
'''


def _column_problem(N=N_COL, Bsz=2, nx=3, nu=2, ni=5, ni_f=4, nw=3, seed=0):
    """The shapes of tests/test_columns.py, two lanes."""
    rng = np.random.default_rng(seed)
    return dict(
        A=0.9 * rng.standard_normal((Bsz, N, nx, nx)) / np.sqrt(nx),
        B=rng.standard_normal((Bsz, N, nx, nu)) / np.sqrt(nu),
        E=0.1 * rng.standard_normal((N + 1, nx, nw)),
        Gmat=rng.standard_normal((ni, nx + nu)),
        Gf=rng.standard_normal((ni_f, nx)),
        mu=np.abs(rng.standard_normal((Bsz, N, ni))),
        mu_f=np.abs(rng.standard_normal((Bsz, ni_f))),
        beta=np.abs(rng.standard_normal((Bsz, N, N, ni))) * np.tril(np.ones((N, N)))[..., None],
        beta_f=np.abs(rng.standard_normal((Bsz, N + 1, ni_f))),
        Q_reg=2.0 * np.eye(nx), R_reg=3.0 * np.eye(nu), Q_reg_f=5.0 * np.eye(nx),
    )


def _mc_draws():
    """tests/test_distributed_multiprocess.py's draws at B = 6."""
    rng = np.random.default_rng(0)
    x0s = np.array([0.4, 0.3, 0.0, 0.0])[None] + 0.05 * rng.standard_normal((B_MC, 4))
    Ws = 2 * rng.random((B_MC, T_MC, 4)) - 1
    return x0s, Ws


def _jax_columns(p):
    """The JAX dense forms on each lane: backward_solve's K, then the response
    of its K by propagate / backoff_from_phi / tube_cost, and the tube
    iteration's dense pipeline (eta -> backward -> response_streaming)."""
    regs = jk.SLSRegs(*(jnp.asarray(p[k]) for k in ("Q_reg", "R_reg", "Q_reg_f")))
    E, Gmat, Gf = (jnp.asarray(p[k]) for k in ("E", "Gmat", "Gf"))
    nx = p["A"].shape[2]
    Gx, Gu = Gmat[:, :nx], Gmat[:, nx:]

    @jax.jit
    @jax.vmap
    def lane(A, B, mu, mu_f, beta, beta_f):
        eta, eta_f = jk.evaluate_dual_eta(mu, mu_f, beta, beta_f, EPS)
        K = jk.backward_solve(A, B, Gmat, Gf, eta, eta_f, regs)[1]
        Phi_x, Phi_u = jk.propagate(A, B, E, K)
        resp = jk.backoff_from_phi(Phi_x, Phi_u, Gx, Gu, Gf, EPS) + (
            jk.tube_cost(Phi_x, Phi_u, regs),)
        tube = (K,) + jk.response_streaming(A, B, E, K, Gx, Gu, Gf, regs, EPS)
        return K, resp, tube

    out = lane(*(jnp.asarray(p[k]) for k in ("A", "B", "mu", "mu_f", "beta", "beta_f")))
    return jax.tree_util.tree_map(np.array, out)


def _jax_mc(x0s, Ws):
    m = JPendulum()
    m.E = 0.003 * np.eye(4)
    solver = JSolver(4, np.eye(4), np.eye(1), m, 10 * np.eye(4), Q_reg=1e3 * np.eye(4),
                     R_reg=1e3 * np.eye(1), Q_reg_f=1e4 * np.eye(4), rti=1,
                     fast_sls_rti_steps=1)
    logs, stats = j_run_mc(solver, T_MC, jnp.asarray(x0s), jnp.asarray(Ws),
                           j_scenario_mesh(n_devices=WORLD))
    return jax.tree_util.tree_map(np.array, (logs._asdict(), stats._asdict()))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Start the 3-rank world, compute the JAX references meanwhile, and
    return (rank results, references)."""
    out = tmp_path_factory.mktemp("ranks")
    p = _column_problem()
    x0s, Ws = _mc_draws()
    # the response is held on the JAX K, so both sides start from one K
    ref_cols = _jax_columns(p)
    np.savez(out / "in.npz", **p, K_ref=ref_cols[0], x0s=x0s, Ws=Ws)
    script = out / "worker.py"
    script.write_text(_WORKER.format(
        dryrun=DRYRUN, port_pendulum=textwrap.dedent(inspect.getsource(port_pendulum))))
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, str(script), str(out), str(WORLD)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=str(out), env=env)
    try:
        ref_mc = _jax_mc(x0s, Ws)
    finally:
        log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0 and "RESULT 0" in log, log[-4000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]
    return ranks, ref_cols, ref_mc, (x0s, Ws)


def _close(got, ref, rtol, what):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.nanmax(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * 1e-2 * scale, err_msg=what)


def test_every_rank_holds_the_same_global_result(world):
    ranks = world[0]
    assert [int(r["rank"]) for r in ranks] == list(range(WORLD))
    for r in ranks:
        assert int(r["world"]) == int(r["size"]) == WORLD
        for k in ranks[0]:
            if k not in ("rank", "thr"):
                assert np.array_equal(r[k], ranks[0][k], equal_nan=r[k].dtype.kind == "f"), k


@pytest.mark.parametrize("form", ["backward", "response", "tube_iteration"])
def test_column_sharding_matches_jax_dense(world, form):
    got = world[0][0]
    K, resp, tube = world[1]
    if form == "backward":
        _close(got["bwd_K"], K, 1e-10, "K")
    elif form == "response":
        for name, r in zip(("beta", "beta_f", "backoff", "backoff_f", "cost"), resp):
            _close(got["resp_" + name], r, 1e-10, name)
    else:
        for name, r in zip(("K", "beta", "beta_f", "backoff", "backoff_f", "cost"), tube):
            _close(got["tube_" + name], r, 1e-10, name)


def test_sharded_mc_matches_jax(world):
    got = world[0][0]
    ref_logs, ref_stats = world[2]
    for k in ("success", "qp_iters", "scp_iters", "scp_failed"):
        assert np.array_equal(got["mc_" + k], ref_logs[k]), k
    for k in ("state_trajectory", "input_trajectory", "nominal_x", "nominal_u", "backoff_x",
              "backoff_u"):
        _close(got["mc_" + k], ref_logs[k], 1e-9, k)
    n_scen, n_viol, worst, mean_cost, n_failed = got["mc_stats"]
    assert (n_scen, n_viol, n_failed) == (B_MC, int(ref_stats["n_violations"]),
                                         int(ref_stats["n_failed_lanes"]))
    assert n_failed == 0
    np.testing.assert_allclose(worst, ref_stats["worst_margin"], rtol=1e-9)
    np.testing.assert_allclose(mean_cost, ref_stats["mean_cost"], rtol=1e-9)


def test_sharded_converged_driver_matches_one_process(world):
    got = world[0][0]
    x0s, Ws = world[3]
    ref = build_chunked_converged_loop(port_pendulum(4, **DRYRUN), 1)(x0s, Ws[:, :1])
    for k in ("success", "qp_iters", "scp_iters", "scp_failed"):
        assert np.array_equal(got["conv_" + k], getattr(ref, k).numpy()), k
    assert bool(ref.success.all())
    for k in ("state_trajectory", "nominal_x", "nominal_u"):
        _close(got["conv_" + k], getattr(ref, k).numpy(), 1e-9, k)


def test_init_distributed_and_throughput_keys(world):
    thr = json.loads(str(world[0][0]["thr"]))
    assert set(thr) == {"processes", "devices", "scenarios", "mpc_steps_per_s", "violations",
                        "violations_note"}
    assert (thr["processes"], thr["devices"], thr["scenarios"]) == (WORLD, WORLD, 2 * WORLD)
    assert thr["mpc_steps_per_s"] > 0 and "ORIGIN" in thr["violations_note"]


def test_fast_sls_column_mesh_matches_unsharded(world):
    got = world[0][0]
    for i in (0, 1):
        assert bool(got[f"sls_sharded{i}_success"]) and bool(got[f"sls_dense{i}_success"])
        for k in ("primal_u", "backoff_x"):
            _close(got[f"sls_sharded{i}_{k}"], got[f"sls_dense{i}_{k}"], 1e-9, k)


def test_no_group_is_refused_not_replaced():
    """Without a process group the mesh raises, and a world of several
    processes needs an address: nothing falls back to one rank."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        scenario_mesh()
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=2, backend="gloo")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A world of one gloo rank in this process, over a file store."""
    if dist.is_initialized():
        pytest.fail("a process group is already initialized in this process")
    store = tmp_path_factory.mktemp("store") / "store"
    assert init_distributed(f"file://{store}", 1, 0, backend="gloo") == 1
    try:
        yield scenario_mesh()
    finally:
        dist.destroy_process_group()


def test_one_rank_is_the_unsharded_path(one_rank):
    mesh = one_rank
    assert (mesh.rank, mesh.size, mesh.device.type) == (0, 1, "cpu")
    assert init_distributed() == 1          # an initialized group is kept
    p = {k: torch.as_tensor(v) for k, v in _column_problem().items()}
    regs = tk.SLSRegs(p["Q_reg"], p["R_reg"], p["Q_reg_f"])
    nx = p["A"].shape[2]
    Gx, Gu = p["Gmat"][:, :nx], p["Gmat"][:, nx:]
    eta, eta_f = tk.evaluate_dual_eta(p["mu"], p["mu_f"], p["beta"], p["beta_f"], EPS)
    bargs = (p["A"], p["B"], p["Gmat"], p["Gf"], eta, eta_f, regs)
    K = tk.backward_solve(*bargs)[1]
    assert torch.equal(tcol.column_sharded_backward_solve(mesh, *bargs), K)
    rargs = (p["A"], p["B"], p["E"], K, Gx, Gu, p["Gf"], regs, EPS)
    for name, a, b in zip(("beta", "beta_f", "backoff", "backoff_f", "cost"),
                          tcol.column_sharded_response(mesh, *rargs),
                          tk.response_streaming_folded(*rargs)):
        _close(a, b, 1e-12, name)
    tube = tcol.sharded_tube_iteration(mesh, p["A"], p["B"], p["E"], p["Gmat"], p["Gf"], p["mu"],
                                       p["mu_f"], p["beta"], p["beta_f"], regs, EPS)
    assert torch.equal(tube[0], K)
    from robust_nonlinear_mpc_torch.tools.column_scaling import tube_iteration_ms

    assert tube_iteration_ms(6, mesh, reps=1) > 0

    x0s, Ws = _mc_draws()
    solver = port_pendulum(4)
    logs1, stats1 = t_run_mc(solver, T_MC, x0s, Ws, mesh=mesh)
    logs0, stats0 = t_run_mc(solver, T_MC, x0s, Ws)
    assert stats1 == stats0
    for k, v in logs0._asdict().items():
        assert torch.equal(getattr(logs1, k), v), k
    conv = port_pendulum(4, **DRYRUN)
    a = build_chunked_converged_loop(conv, 1, mesh=mesh)(x0s[:2], Ws[:2, :1])
    b = build_chunked_converged_loop(conv, 1)(x0s[:2], Ws[:2, :1])
    for k, v in b._asdict().items():
        assert torch.equal(getattr(a, k), v), k


def test_mesh_refuses_what_it_cannot_do(one_rank):
    from robust_nonlinear_mpc_torch.parallel.mesh import shard_batch

    with pytest.raises(ValueError, match="one process per device"):
        scenario_mesh(n_devices=2)
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(one_rank._replace(size=2), torch.zeros(3))

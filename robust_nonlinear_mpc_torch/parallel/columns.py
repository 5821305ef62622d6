"""The SLS column axis sharded over a mesh (port of
`robust_nonlinear_mpc_tpu/parallel/columns.py`).

The N + 1 SLS columns (disturbance-injection times) are independent: the
backward Riccati and the response propagation are column-local, and the
only cross-column reductions of a fast-SLS iteration are

    backoff[k] = sum_j sqrt(beta[k, j])     -> all_reduce(SUM)
    backoff_f  = sum_j sqrt(beta_f[j])      -> all_reduce(SUM)
    tube cost  = sqrt(sum_j cost_sq_j)      -> all_reduce(SUM)

so each rank runs `riccati_column` / `response_column` on its slab of the
columns, for every lane at once, and the reductions plus an all-gather of K
and beta into the dense (stage, column) layout are all that crosses ranks.
The next iteration's eta[k, j] = mu[k] / (2 sqrt(beta[k, j])) needs only the
rank's own beta columns and the replicated QP duals (`sharded_tube_iteration`).

The column count N + 1 is padded to a multiple of the mesh size; a padded
column has j = N + 1 and contributes exactly zero. The sums come out in
another order than the one-process sums, so they agree with the unsharded
forms to rounding.
"""

from __future__ import annotations

import torch

from robust_nonlinear_mpc_torch.ops.sls_kernels import (
    SLSRegs,
    eta_columns,
    response_column,
    riccati_column,
)
from robust_nonlinear_mpc_torch.parallel.mesh import Mesh, all_gather, all_reduce, scenario_mesh


def column_mesh(n_devices: int | None = None, group=None, device=None) -> Mesh:
    """1-D mesh over the SLS column axis (the ranks of `group`)."""
    return scenario_mesh(n_devices, group, device)


def _pad_cols(n_cols: int, n_shards: int) -> int:
    return (-n_cols) % n_shards


def _column_ids(N: int, n_shards: int, device) -> torch.Tensor:
    """0..N, then the sentinel N + 1 for each padded column."""
    pad = _pad_cols(N + 1, n_shards)
    return torch.cat([torch.arange(N + 1), torch.full((pad,), N + 1)]).to(device)


def _slab(mesh: Mesh, n_cols: int) -> slice:
    per = n_cols // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def _pad_axis1(t: torch.Tensor, n: int) -> torch.Tensor:
    """Append n zero entries along axis 1."""
    return torch.cat([t, t.new_zeros(t.shape[:1] + (n,) + t.shape[2:])], dim=1)


def _padded_columns(N: int, eta, eta_f, n_shards: int):
    """Column-major eta (B, C, N, ni), eta_f (B, C, ni_f) and js (C,) padded
    to C columns, a multiple of the shard count; the padded columns have
    j = N + 1 and zero eta."""
    js = _column_ids(N, n_shards, eta.device)
    pad = js.numel() - (N + 1)
    return js, _pad_axis1(eta_columns(eta), pad), _pad_axis1(eta_f, pad)


def _reduce_response(mesh, beta_c, beta_f_c, cost_sq):
    """The three cross-column reductions of a slab's response."""
    backoff = all_reduce(mesh, torch.sqrt(beta_c).sum(dim=1))      # (B, N, ni)
    backoff_f = all_reduce(mesh, torch.sqrt(beta_f_c).sum(dim=1))  # (B, ni_f)
    cost_tube = torch.sqrt(all_reduce(mesh, cost_sq.sum(dim=1)))   # (B,)
    return backoff, backoff_f, cost_tube


def _dense(mesh, cols, n_keep):
    """A slab's (B, C/W, stages, ...) columns gathered and put into the dense
    (B, stages, columns, ...) layout, trimmed to `n_keep` columns."""
    return all_gather(mesh, cols, dim=1)[:, :n_keep].transpose(1, 2).contiguous()


def column_sharded_backward_solve(mesh: Mesh, A, B, Gmat, Gf, eta, eta_f, regs: SLSRegs):
    """The gains of `ops.sls_kernels.backward_solve` with the column axis
    sharded: K (B, N, N+1, nu, nx) in the dense (stage, column) layout on
    every rank. The cost-to-go S stays on its rank (the fast-SLS iteration
    reads K only), so K is the one tensor gathered."""
    N = A.shape[1]
    js, eta_cols, eta_f_p = _padded_columns(N, eta, eta_f, mesh.size)
    sl = _slab(mesh, js.numel())
    _, K_l = riccati_column(js[sl], eta_cols[:, sl], eta_f_p[:, sl], A, B, Gmat, Gf, regs)
    return _dense(mesh, K_l, N + 1)


def column_sharded_response(mesh: Mesh, A, B, E, K, Gx, Gu, Gf, regs: SLSRegs, epsilon):
    """`ops.sls_kernels.response_streaming` with the column axis sharded. K
    (B, N, N+1, nu, nx) in the dense layout, the same on every rank. Returns
    (beta (B, N, N, ni), beta_f (B, N+1, ni_f), backoff (B, N, ni),
    backoff_f (B, ni_f), cost_tube (B,)) on every rank."""
    N = A.shape[1]
    js = _column_ids(N, mesh.size, A.device)
    sl = _slab(mesh, js.numel())
    K_cols = _pad_axis1(K.transpose(1, 2), js.numel() - (N + 1))
    beta_c, beta_f_c, cost_sq = response_column(js[sl], K_cols[:, sl], A, B, E, Gx, Gu, Gf,
                                                regs, epsilon)
    backoff, backoff_f, cost_tube = _reduce_response(mesh, beta_c, beta_f_c, cost_sq)
    beta_f = all_gather(mesh, beta_f_c, dim=1)[:, : N + 1]
    return _dense(mesh, beta_c, N), beta_f, backoff, backoff_f, cost_tube


def sharded_tube_iteration(mesh: Mesh, A, B, E, Gmat, Gf, mu, mu_f, beta_prev, beta_f_prev,
                           regs: SLSRegs, epsilon):
    """One column-local fast-SLS tube iteration on the mesh: eta from the
    replicated duals mu (B, N, ni), mu_f (B, ni_f) and the rank's own columns
    of the previous beta (B, N, N, ni) / beta_f (B, N+1, ni_f) (zeros on the
    first iteration: eta then sits at the epsilon floor, as in the dense
    path), the backward Riccati and the streaming response, with only the
    reductions and the gathers crossing ranks. Returns (K, beta, beta_f,
    backoff, backoff_f, cost_tube) in the dense layouts."""
    N, nx = A.shape[1], A.shape[2]
    js = _column_ids(N, mesh.size, A.device)
    sl = _slab(mesh, js.numel())
    pad = js.numel() - (N + 1)
    beta_cols = _pad_axis1(beta_prev.transpose(1, 2), 1 + pad)[:, sl]     # (B, C/W, N, ni)
    beta_f_c = _pad_axis1(beta_f_prev, pad)[:, sl]
    j = js[sl]
    # eta[k, j] = mu[k] / (2 sqrt(max(beta[k, j], eps))) for k >= j
    eta_c = mu[:, None] / (2.0 * torch.sqrt(torch.clamp(beta_cols, min=epsilon)))
    below = torch.arange(N, device=A.device)[None, :] >= j[:, None]
    eta_c = torch.where(below[None, :, :, None], eta_c, torch.zeros_like(eta_c))
    eta_f_c = mu_f[:, None] / (2.0 * torch.sqrt(torch.clamp(beta_f_c, min=epsilon)))
    _, K_c = riccati_column(j, eta_c, eta_f_c, A, B, Gmat, Gf, regs)
    beta_c, beta_f_o, cost_sq = response_column(j, K_c, A, B, E, Gmat[:, :nx], Gmat[:, nx:], Gf,
                                                regs, epsilon)
    backoff, backoff_f, cost_tube = _reduce_response(mesh, beta_c, beta_f_o, cost_sq)
    beta_f = all_gather(mesh, beta_f_o, dim=1)[:, : N + 1]
    return (_dense(mesh, K_c, N + 1), _dense(mesh, beta_c, N), beta_f, backoff, backoff_f,
            cost_tube)

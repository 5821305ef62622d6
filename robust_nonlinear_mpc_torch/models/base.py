"""Model base class: continuous-time ODE + discretization + constraint data
(port of `robust_nonlinear_mpc_tpu/models/base.py`).

A model is an `nn.Module` whose constant problem data (G, g, Gf, gf, E) are
registered buffers, so `.to(device)` moves them. `ode`/`ddyn` take states and
inputs with any leading batch shape; the Jacobians come from forward-mode
`torch.func.jvp`, vmapped over the input directions and batched over the
flattened (batch x stage) axis.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.func import jacfwd, jvp, vmap


class Model(nn.Module):
    """Nonlinear model with polytopic constraints G [x;u] <= g, Gf x <= gf.

    Subclasses set nx, nu, nw, ni, ni_f, dt, call `_register_problem_data`
    and implement `ode(x, u) -> xdot`.
    """

    nx: int
    nu: int
    nw: int
    ni: int
    ni_f: int
    dt: float
    discretization_method: str = "rk4"

    def _register_problem_data(self, G, g, Gf, gf, E, dtype, device):
        for name, value in (("G", G), ("g", g), ("Gf", Gf), ("gf", gf), ("E", E)):
            self.register_buffer(
                name, torch.as_tensor(np.asarray(value, float), dtype=dtype, device=device)
            )

    def _register_constants(self, dtype, device, **vectors):
        """Constant vectors of `ode`, made once on the device as buffers
        outside the state dict: a tensor made from host data inside `ode`
        would be a host-to-device copy in every call, which a captured CUDA
        graph cannot hold."""
        for name, value in vectors.items():
            self.register_buffer(f"_const_{name}", torch.tensor(value, dtype=dtype, device=device),
                                 persistent=False)

    def constant(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The constant vector `name` in `like`'s type, on its device."""
        return getattr(self, f"_const_{name}").to(dtype=like.dtype, device=like.device)

    def ode(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def ddyn(self, x: torch.Tensor, u: torch.Tensor, h: float | None = None) -> torch.Tensor:
        """Discrete-time dynamics x+ = f(x, u): RK4 (default) or Euler."""
        if h is None:
            h = self.dt
        if self.discretization_method == "euler":
            return x + h * self.ode(x, u)
        k1 = self.ode(x, u)
        k2 = self.ode(x + 0.5 * h * k1, u)
        k3 = self.ode(x + 0.5 * h * k2, u)
        k4 = self.ode(x + h * k3, u)
        return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def linearize(self, x: torch.Tensor, u: torch.Tensor):
        """(A, B) = (df/dx, df/du) of the discrete dynamics at one point
        x (nx,), u (nu,)."""
        return jacfwd(self.ddyn, argnums=(0, 1))(x, u)

    def linearize_traj(self, X: torch.Tensor, U: torch.Tensor):
        """Linearization along trajectories.

        X (..., N+1, nx), U (..., N, nu). Returns A (..., N, nx, nx),
        B (..., N, nx, nu) and c (..., N, nx) with c_k = f(x_k, u_k) - x_{k+1}.
        """
        N, nx, nu = U.shape[-2], X.shape[-1], U.shape[-1]
        lead = U.shape[:-2]
        xk = X[..., :N, :].reshape(-1, nx)
        uk = U.reshape(-1, nu)
        M = xk.shape[0]
        # one forward-mode pass per input direction over the whole batch
        # (vmap over the nx + nu tangents, not over the samples)
        eye = torch.eye(nx + nu, dtype=X.dtype, device=X.device)
        tx = eye[:, None, :nx].expand(nx + nu, M, nx)
        tu = eye[:, None, nx:].expand(nx + nu, M, nu)
        f, J = vmap(lambda a, b: jvp(self.ddyn, (xk, uk), (a, b)), out_dims=(None, 0))(tx, tu)
        J = J.permute(1, 2, 0)                     # (M, nx, nx + nu)
        A, B = J[..., :nx], J[..., nx:]
        c = f.reshape(lead + (N, nx)) - X[..., 1 : N + 1, :]
        return A.reshape(lead + (N, nx, nx)), B.reshape(lead + (N, nx, nu)), c

    def remove_constraints(self) -> None:
        """Drop every stage and terminal constraint (ni = ni_f = 0)."""
        z = lambda *s: torch.zeros(s, dtype=self.G.dtype, device=self.G.device)
        self.G = z(0, self.nx + self.nu)
        self.g = z(0)
        self.Gf = z(0, self.nx)
        self.gf = z(0)
        self.ni = 0
        self.ni_f = 0


def box_polytope(x_ub, x_lb, u_ub, u_lb):
    """Stage polytope G [x;u] <= g from box bounds, rows [upper; -lower]."""
    x_ub = np.asarray(x_ub, dtype=float)
    x_lb = np.asarray(x_lb, dtype=float)
    u_ub = np.asarray(u_ub, dtype=float)
    u_lb = np.asarray(u_lb, dtype=float)
    n = x_ub.size + u_ub.size
    G = np.vstack([np.eye(n), -np.eye(n)])
    g = np.concatenate([x_ub, u_ub, -x_lb, -u_lb])
    return G, g


def terminal_box_polytope(x_ub, x_lb):
    """Terminal polytope Gf x <= gf from box bounds."""
    x_ub = np.asarray(x_ub, dtype=float)
    x_lb = np.asarray(x_lb, dtype=float)
    n = x_ub.size
    Gf = np.vstack([np.eye(n), -np.eye(n)])
    gf = np.concatenate([x_ub, -x_lb])
    return Gf, gf

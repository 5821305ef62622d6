"""Linear model containers: LTI, LTV and their output-feedback variants
(port of `robust_nonlinear_mpc_tpu/models/linear.py`).

The data are tensors of an explicit dtype on an explicit device (the card
unless `device="cpu"`); per-stage data are stacked (N, ...) as in the JAX
package. An LTV wraps a model's dimensions and constraint data and, like the
reference, carries placeholder all-ones stacks until `update_model`.
"""

from __future__ import annotations

import numpy as np
import torch

from robust_nonlinear_mpc_torch.models.base import Model
from robust_nonlinear_mpc_torch.utils.device import checked_device
from robust_nonlinear_mpc_torch.utils.numerics import mv


def _as(a, like: torch.Tensor) -> torch.Tensor:
    """`a` (array or tensor) as a tensor of `like`'s dtype and device."""
    if not torch.is_tensor(a):
        a = np.array(a, float)
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


class LTI(Model):
    """x+ = A x + B u + E w."""

    def __init__(self, A, B, E, G=None, g=None, Gf=None, gf=None, *,
                 dtype=torch.float64, device="cuda"):
        super().__init__()
        device = checked_device(device)
        host = lambda a: a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a, float)
        A, B, E = host(A), host(B), host(E)
        self.nx = A.shape[0]
        self.nu = B.shape[1]
        self.nw = E.shape[1]
        self.dt = 1.0
        G = np.zeros((0, self.nx + self.nu)) if G is None else host(G)
        g = np.zeros((0,)) if g is None else host(g).reshape(-1)
        Gf = np.zeros((0, self.nx)) if Gf is None else host(Gf)
        gf = np.zeros((0,)) if gf is None else host(gf).reshape(-1)
        self.ni = G.shape[0]
        self.ni_f = Gf.shape[0]
        self._register_problem_data(G, g, Gf, gf, E, dtype, device)
        self.register_buffer("A", torch.as_tensor(A, dtype=dtype, device=device))
        self.register_buffer("B", torch.as_tensor(B, dtype=dtype, device=device))

    def ddyn(self, x, u, h=None):
        return mv(self.A, x) + mv(self.B, u)


class LTV(Model):
    """Per-stage linear dynamics wrapping a (nonlinear) model's dimensions
    and constraints, in its dtype on its device; placeholder ones until
    `update_model`."""

    def __init__(self, m: Model, N: int):
        super().__init__()
        self.N = int(N)
        self.nx, self.nu, self.nw = m.nx, m.nu, m.nw
        self.ni, self.ni_f = m.ni, m.ni_f
        self.dt = m.dt
        self.register_buffer("G", m.G.clone())
        self.register_buffer("Gf", m.Gf.clone())
        self.register_buffer("gf", m.gf.clone())
        ones = lambda *s: torch.ones(s, dtype=m.G.dtype, device=m.G.device)
        self.register_buffer("A_stack", ones(N, self.nx, self.nx))
        self.register_buffer("B_stack", ones(N, self.nx, self.nu))
        self.register_buffer("E_stack", ones(N + 1, self.nx, self.nw))
        self.register_buffer("g_stack", ones(N, self.ni))
        self.register_buffer("gf_vec", ones(self.ni_f))

    def ddyn(self, x, u, k: int = 0):
        return mv(self.A_stack[k], x) + mv(self.B_stack[k], u)

    def update_model(self, A_stack, B_stack, E_stack, g_stack, gf_vec=None):
        self.A_stack = _as(A_stack, self.G)
        self.B_stack = _as(B_stack, self.G)
        self.E_stack = _as(E_stack, self.G)
        self.g_stack = _as(g_stack, self.G)
        if gf_vec is not None:
            self.gf_vec = _as(gf_vec, self.G)


class LTI_OF(LTI):
    """Output-feedback LTI: adds the measurement C and its noise F (kept for
    the reference API; no solver reads them)."""

    def __init__(self, A, B, E, C, F, **kw):
        super().__init__(A, B, E, **kw)
        self.register_buffer("C", _as(C, self.A))
        self.register_buffer("F", _as(F, self.A))
        self.ny = self.C.shape[0]
        self.nv = self.F.shape[1]


class LTV_OF(LTV):
    """Output-feedback LTV with per-stage C/F stacks (placeholder ones)."""

    def __init__(self, m: Model, N: int, ny: int | None = None, nv: int | None = None):
        super().__init__(m, N)
        self.ny = ny if ny is not None else m.nx
        self.nv = nv if nv is not None else m.nx
        ones = lambda *s: torch.ones(s, dtype=m.G.dtype, device=m.G.device)
        self.register_buffer("C_stack", ones(N + 1, self.ny, self.nx))
        self.register_buffer("F_stack", ones(N + 1, self.ny, self.nv))

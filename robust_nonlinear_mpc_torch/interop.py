"""Carry problems and solver state between the JAX package and the port.

Only numpy arrays and plain Python values cross the boundary, so this module
never imports jax: a caller turns the JAX side's NamedTuples into plain
dicts with `tree_to_numpy` / `options_to_plain`, and the functions below
rebuild the port's objects from them.
"""

from __future__ import annotations

import numpy as np
import torch

from robust_nonlinear_mpc_torch.ops.qp_ipm import IPMOptions
from robust_nonlinear_mpc_torch.solvers.fast_sls import FastSLSPersist, QPWarm
from robust_nonlinear_mpc_torch.solvers.scp_sls import SCPSLSOptions, SCPSLSSolver
from robust_nonlinear_mpc_torch.solvers.sqp import SQPOptions
from robust_nonlinear_mpc_torch.utils.device import checked_device

# the JAX package's names for the fused kernels -> the port's names
_KKT_NAMES = {"pallas": "fused", "pallas_iter": "fused_iter"}


def tree_to_numpy(tree):
    """NamedTuple (nested) of arrays -> dict of numpy arrays, by field name."""
    if hasattr(tree, "_asdict"):
        return {k: tree_to_numpy(v) for k, v in tree._asdict().items()}
    return np.asarray(tree)


def options_to_plain(opts):
    """NamedTuple options (nested) -> dict of plain Python values."""
    if hasattr(opts, "_asdict"):
        return {k: options_to_plain(v) for k, v in opts._asdict().items()}
    if isinstance(opts, tuple):
        return tuple(opts)
    return opts


def _ipm_options(d):
    if d is None:
        return None
    d = dict(d)
    d["kkt"] = _KKT_NAMES.get(d.get("kkt", "riccati"), d.get("kkt", "riccati"))
    return IPMOptions(**d)


def _scp_options(d) -> SCPSLSOptions:
    d = dict(d)
    d["ipm"] = _ipm_options(d["ipm"])
    d["ipm_first"] = _ipm_options(d.get("ipm_first"))
    sqp = dict(d["sqp"])
    sqp["ipm"] = _ipm_options(sqp["ipm"])
    d["sqp"] = SQPOptions(**sqp)
    if d.get("adaptive_ipm_budget") is not None:
        d["adaptive_ipm_budget"] = tuple(int(v) for v in d["adaptive_ipm_budget"])
    return SCPSLSOptions(**d)


MODELS = ("rocket", "pendulum", "quadrotor")


def model_from_name(name, *, device="cuda", dtype=torch.float64):
    """The port's model of that name, on the card unless `device` says
    otherwise."""
    if name == "rocket":
        from robust_nonlinear_mpc_torch.models.rocket import Rocket as cls
    elif name == "pendulum":
        from robust_nonlinear_mpc_torch.models.pendulum import Pendulum as cls
    elif name == "quadrotor":
        from robust_nonlinear_mpc_torch.models.quadrotor import Quadrotor as cls
    else:
        raise ValueError(f"model must be one of {MODELS}, got {name!r}")
    return cls(dtype=dtype, device=device)


def solver_from_numpy(d, *, device="cuda", dtype=torch.float64) -> SCPSLSSolver:
    """Build the port's solver from the values of a JAX `SCPSLSSolver`.

    `d` holds "N", "Q", "R", "Qf", "Q_reg", "R_reg", "Q_reg_f", the model's
    "E" and "dt", optionally its "g" and "gf" (a replaced box), "model" (one
    of `MODELS`, the rocket by default) and "options"
    (`options_to_plain(solver.opts)`). On the card unless `device` says
    otherwise.
    """
    device = checked_device(device)
    m = model_from_name(d.get("model", "rocket"), device=device, dtype=dtype)
    m.dt = float(d["dt"])
    as_t = lambda a: torch.as_tensor(np.asarray(a, float), dtype=dtype, device=device)
    m.E = as_t(d["E"])
    for name in ("g", "gf"):
        if name in d:
            setattr(m, name, as_t(d[name]))
    opts = _scp_options(d["options"])
    return SCPSLSSolver(
        int(d["N"]), d["Q"], d["R"], m, d["Qf"],
        Q_reg=d["Q_reg"], R_reg=d["R_reg"], Q_reg_f=d["Q_reg_f"],
        rti=opts.rti, fast_sls_rti_steps=opts.fast_sls_rti_steps,
        options=opts, dtype=dtype, device=device,
    )


def _tensor(a, dtype, device):
    a = np.array(a)
    if a.dtype == np.bool_:
        return torch.as_tensor(a, device=device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.as_tensor(a, dtype=torch.int32, device=device)
    return torch.as_tensor(a, dtype=dtype, device=device)


def carry_from_numpy(d, *, device="cuda", dtype=torch.float64):
    """dict {"X", "U", "persist", "x"} (batch-leading numpy arrays, persist
    and its "qp_warm" by field name) -> the port's carry (X, U, persist, x),
    on the card unless `device` says otherwise."""
    device = checked_device(device)
    p = dict(d["persist"])
    qw = QPWarm(**{k: _tensor(v, dtype, device) for k, v in p.pop("qp_warm").items()})
    persist = FastSLSPersist(
        **{k: _tensor(v, dtype, device) for k, v in p.items()}, qp_warm=qw
    )
    return (_tensor(d["X"], dtype, device), _tensor(d["U"], dtype, device),
            persist, _tensor(d["x"], dtype, device))


def carry_to_numpy(carry):
    """The port's carry (X, U, persist, x) -> dict of numpy arrays."""
    X, U, persist, x = carry
    host = lambda t: t.detach().cpu().numpy()
    p = {k: host(v) for k, v in persist._asdict().items() if k != "qp_warm"}
    p["qp_warm"] = {k: host(v) for k, v in persist.qp_warm._asdict().items()}
    return {"X": host(X), "U": host(U), "persist": p, "x": host(x)}

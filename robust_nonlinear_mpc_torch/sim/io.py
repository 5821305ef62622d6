"""Results-level checkpointing: npz trajectory save/load (the port's copy
of `robust_nonlinear_mpc_tpu/sim/io.py`, plain NumPy)."""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np


def save_trajectory(folder, X, U, dt, prefix="trajectory", **extra):
    """Save a (state, input) trajectory pair; returns the file path.

    X: (nx, T) and U: (nu, T-1) in the reference layout (or transposed:
    both are stored as given).
    """
    os.makedirs(folder, exist_ok=True)
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(folder, f"{prefix}_{stamp}.npz")
    np.savez(path, X=np.asarray(X), U=np.asarray(U), dt=float(dt), **extra)
    return path


def load_trajectory(path_or_folder, prefix=None):
    """Load a trajectory npz; given a folder, the newest file."""
    p = path_or_folder
    if os.path.isdir(p):
        files = [
            f for f in os.listdir(p)
            if f.endswith(".npz") and (prefix is None or f.startswith(prefix))
        ]
        if not files:
            raise FileNotFoundError(f"no npz files in {p}")
        p = os.path.join(p, max(files, key=lambda f: os.path.getctime(os.path.join(p, f))))
    data = np.load(p, allow_pickle=False)
    return {k: data[k] for k in data.files}

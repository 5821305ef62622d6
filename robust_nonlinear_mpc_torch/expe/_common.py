"""Shared experiment plumbing: save a run as a timestamped npz with the
reference field names, load the newest (the port's copy of
`save_results` and `load_latest` from `robust_nonlinear_mpc_tpu/expe/_common.py`;
plotting is not ported)."""

from __future__ import annotations

import os
from datetime import datetime

import numpy as np


def save_results(folder: str, prefix: str, results: dict) -> str:
    os.makedirs(folder, exist_ok=True)
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    path = os.path.join(folder, f"{prefix}_{stamp}.npz")
    np.savez(path, **results)
    print(f"Results saved to {path}")
    return path


def load_latest(folder: str):
    """Newest npz in `folder` by ctime, or None."""
    if not os.path.isdir(folder):
        return None
    files = [f for f in os.listdir(folder) if f.endswith(".npz")]
    if not files:
        return None
    latest = max(files, key=lambda f: os.path.getctime(os.path.join(folder, f)))
    return np.load(os.path.join(folder, latest))

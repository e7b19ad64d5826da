"""JSON output helpers (the part of `dart_tpu.io.logging` the CLI needs)."""

from __future__ import annotations

import numpy as np


def to_jsonable(x):
    """NumPy -> JSON sanitiser, NaN and inf -> null (`rob_ctrl.py:52-68`)."""
    if isinstance(x, dict):
        return {k: to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return to_jsonable(x.tolist())
    if isinstance(x, (bool, np.bool_)):
        return bool(x)
    if isinstance(x, (np.floating, float)):
        xf = float(x)
        return None if np.isnan(xf) or np.isinf(xf) else xf
    if isinstance(x, (np.integer, int)):
        return int(x)
    return x

"""Domain randomisation of the LMPC plant (port of the sampling part of
`dart_tpu.adapt.lmpc_trainer`; the PPO trainer is not ported yet).

The plant's true 34-vector spans the mass {1, 2, 3} x friction
{0.05, 0.1, 0.2} envelope of the reference's world grid (`run.py:64-65,
219-223`) in the learned model's parameter space. Every draw comes from an
explicit `torch.Generator` and lands on its device. The numbers differ from
`jax.random`'s for the same seed; the support and structure are the same.
"""

from __future__ import annotations

import torch

from dart_tpu_torch.models import dynamics as dyn

N_PARAMS = dyn.LMPC_N_PARAMS


def _shape(batch) -> tuple:
    return (batch,) if isinstance(batch, int) else tuple(batch)


def _choice(gen: torch.Generator, values, shape: tuple,
            dtype: torch.dtype) -> torch.Tensor:
    table = torch.tensor(values, dtype=dtype, device=gen.device)
    idx = torch.randint(len(values), shape, generator=gen, device=gen.device)
    return table[idx]


def sample_true_params(gen: torch.Generator, batch=(),
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plant parameters (*batch, 34): mass m in {1, 2, 3} on m_x and m_y,
    friction mu in {0.05, 0.1, 0.2} as F_s = mu m g and F_c = 0.8 mu m g on
    both slides, v_s = 0.05, eps = 0.01, k = 0.01, every other entry
    U(0.05, 0.3)."""
    shape = _shape(batch)
    mass = _choice(gen, (1.0, 2.0, 3.0), shape, dtype)
    fric = _choice(gen, (0.05, 0.1, 0.2), shape, dtype)
    p = torch.rand((*shape, N_PARAMS), generator=gen, device=gen.device,
                   dtype=dtype) * (0.3 - 0.05) + 0.05
    p[..., 0] = mass                                  # m_x
    p[..., 1] = mass                                  # m_y
    p[..., 6] = fric * mass * 9.81                    # F_s_x
    p[..., 7] = 0.8 * fric * mass * 9.81              # F_c_x
    p[..., 11] = fric * mass * 9.81                   # F_s_y
    p[..., 12] = 0.8 * fric * mass * 9.81             # F_c_y
    p[..., 9] = 0.05                                  # v_s
    p[..., 14] = 0.05
    p[..., 10] = 0.01                                 # eps (smooth)
    p[..., 15] = 0.01
    p[..., 4] = 0.01                                  # tiny k spring
    p[..., 5] = 0.01
    return p


def sample_target(gen: torch.Generator, batch=(),
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Targets (*batch, 8): px, py ~ U(-0.1, 0.1), every other entry 0."""
    shape = _shape(batch)
    xy = torch.rand((*shape, 2), generator=gen, device=gen.device,
                    dtype=dtype) * 0.2 - 0.1
    t = torch.zeros((*shape, 8), dtype=dtype, device=gen.device)
    t[..., 0] = xy[..., 0]
    t[..., 2] = xy[..., 1]
    return t

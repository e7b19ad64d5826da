"""Learned neural transition models for MPC, differentiated through the
network (port of `dart_tpu.models.neural`).

- `DynamicsMLP`: a tanh MLP xdot-predictor, flax's layer order (Dense_0 ..
  Dense_{n-1} with tanh, then a linear Dense_n to nx), with an optional
  analytic prior (residual learning: xdot = prior(x, u) + MLP(x, u)).
- `make_neural_ocp`: an `OCPDef` whose dynamics are the network; the
  OCP's `params` are the network's weights, a dict of tensors
  (`weights(module)`), so `ilqr.solve` linearises through the network
  with `torch.func` and a new fit is a new argument, not a new OCP.
- `fit_dynamics`: supervised regression on (x, u, xdot) transitions with
  optax's Adam.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.solver.ilqr import OCPDef
from dart_tpu_torch.utils.device import resolve

# Flax's lecun_normal: a normal truncated at 2 std, rescaled so that the
# truncated distribution has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


class DynamicsMLP(nn.Module):
    """xdot = MLP([x, u]) on the last axis; `nu` controls. The weights
    live on `device`, the card unless the caller asks for the CPU."""

    def __init__(self, nx: int, hidden: Sequence[int] = (64, 64),
                 nu: int = 2, device: torch.device | str = "cuda"):
        super().__init__()
        dev = resolve(device)
        self.nx, self.hidden = nx, tuple(hidden)
        widths = (nx + nu, *self.hidden, nx)
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"Dense_{i}", nn.Linear(a, b, device=dev))

    def layers(self) -> list[nn.Linear]:
        return [getattr(self, f"Dense_{i}")
                for i in range(len(self.hidden) + 1)]

    def reset_parameters(self, gen: torch.Generator) -> "DynamicsMLP":
        """Flax Dense's initialisation from `gen` (a CPU generator, so a
        seed draws the same weights on every device): lecun_normal
        kernels, zero biases."""
        with torch.no_grad():
            for layer in self.layers():
                std = math.sqrt(1.0 / layer.in_features) / _TRUNC_STD
                w = torch.empty(layer.weight.shape, dtype=layer.weight.dtype)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                      generator=gen)
                layer.weight.copy_(w)
                layer.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x, u], dim=-1)
        layers = self.layers()
        for layer in layers[:-1]:
            h = torch.tanh(layer(h))
        return layers[-1](h)


class NeuralModel(NamedTuple):
    module: DynamicsMLP
    prior: Optional[Callable] = None      # (x, u) -> xdot analytic part


def weights(module: nn.Module) -> dict[str, torch.Tensor]:
    """The module's parameters as a dict of detached tensors: the `params`
    of `neural_xdot` and the neural OCP."""
    return {k: v.detach() for k, v in module.named_parameters()}


def neural_xdot(nm: NeuralModel, params: dict, x: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    out = functional_call(nm.module, params, (x, u))
    if nm.prior is not None:
        out = out + nm.prior(x, u)
    return out


class NeuralAux(NamedTuple):
    """Cost data of the neural OCP, each leaf per lane (B, ...) or shared;
    a plain tuple (target, Q, R, Qt) of shared leaves does as well."""

    target: torch.Tensor   # (nx,) state target
    Q: torch.Tensor        # (nx,) stage state weights
    R: torch.Tensor        # (4,) weights on [u, du]
    Qt: torch.Tensor       # (nx,) terminal state weights


def make_neural_ocp(nm: NeuralModel, dt: float, nx: int,
                    u_bound: float = 0.4, Q=None, R=None, Qt=None) -> OCPDef:
    """OCP over the learned dynamics, z = [x (nx), u_prev (2)], per-solve
    `params` the network weights. The cost mirrors the LMPC stage cost:
    diag Q on the state error plus diag R on [u, du], aux = (target, Q, R,
    Qt). (Q, R and Qt are taken from aux, as in JAX.)"""

    def xdot(x, u, params):
        return neural_xdot(nm, params, x, u)

    step_x = dyn.discretize(xdot, dt)

    def step(z, v, params):
        return torch.cat([step_x(z[..., :nx], v, params), v], dim=-1)

    def stage_cost(z, v, k, aux):
        target, Qd, Rd, _ = aux
        e = z[..., :nx] - target
        ctrl = torch.cat([v, v - z[..., nx:nx + 2]], dim=-1)
        return torch.sum(Qd * e * e, dim=-1) + torch.sum(Rd * ctrl * ctrl,
                                                         dim=-1)

    def term_cost(z, aux):
        target, _, _, Qtd = aux
        e = z[..., :nx] - target
        return torch.sum(Qtd * e * e, dim=-1)

    return OCPDef(step=step, stage_cost=stage_cost, term_cost=term_cost,
                  u_lo=(-u_bound, -u_bound), u_hi=(u_bound, u_bound))


def fit_dynamics(nm: NeuralModel, params: dict, X: torch.Tensor,
                 U: torch.Tensor, Xdot: torch.Tensor,
                 gen: torch.Generator | None = None, steps: int = 2000,
                 lr: float = 1e-3, batch: int = 256,
                 indices: torch.Tensor | None = None):
    """Adam regression of the xdot targets, optax's `adam(lr)` (b1 0.9, b2
    0.999, eps 1e-8 outside the square root, bias-corrected) on the mean
    squared error of a minibatch per step, on the data's device. The
    minibatch indices are `indices` (steps, batch) when given, else drawn
    uniformly from `gen` (on any device). Returns (params, the loss of the
    last step, taken before its update), as JAX does."""
    if indices is None and gen is None:
        raise ValueError("fit_dynamics draws its minibatches from `gen`: "
                         "pass a torch.Generator, or the indices")
    b1, b2, eps = 0.9, 0.999, 1e-8
    n = X.shape[0]
    p = {k: v.detach().clone() for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    loss = None
    for t in range(1, steps + 1):
        idx = (indices[t - 1] if indices is not None else torch.randint(
            0, n, (batch,), generator=gen, device=gen.device).to(X.device))
        leaves = {k: v.requires_grad_(True) for k, v in p.items()}
        with torch.enable_grad():
            pred = neural_xdot(nm, leaves, X[idx], U[idx])
            loss = torch.mean((pred - Xdot[idx]) ** 2)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (k, v), g in zip(leaves.items(), grads):
                mu[k] = (1 - b1) * g + b1 * mu[k]
                nu[k] = (1 - b2) * (g * g) + b2 * nu[k]
                m_hat = mu[k] / torch.tensor(1 - b1 ** t, dtype=v.dtype)
                v_hat = nu[k] / torch.tensor(1 - b2 ** t, dtype=v.dtype)
                p[k] = v.detach() + (m_hat / (torch.sqrt(v_hat) + eps)) * (
                    -lr)
    return p, loss.detach()


def collect_transitions(plant_xdot: Callable, rng: np.random.Generator,
                        n: int, nx: int, x_scale=0.2, u_scale=0.4,
                        device: torch.device | str = "cuda"):
    """Random-state transition dataset from any batched analytic plant
    `plant_xdot(X (n, nx), U (n, 2)) -> (n, nx)`, float32 on `device` (the
    card unless the caller asks for the CPU), the states and controls
    drawn from `rng` as JAX draws them."""
    dev = resolve(device)
    X = torch.tensor(np.asarray(rng.normal(size=(n, nx)) * x_scale,
                                np.float32), device=dev)
    U = torch.tensor(np.asarray(rng.uniform(-u_scale, u_scale, size=(n, 2)),
                                np.float32), device=dev)
    return X, U, plant_xdot(X, U)

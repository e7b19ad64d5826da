"""PPO in PyTorch (port of `dart_tpu.adapt.ppo`, the replacement for the
reference's torch RL worker, `LMPC/src/controller/rlmpc2.py:33-107,
536-943`).

- actor-critic MLPs with tanh activations and orthogonal init (gain
  sqrt(2)), a learned state-independent log_std clamped to
  [log(std_min), log(std_max)] (`Policy`, rlmpc2.py:33-80);
- GAE(gamma, lambda) (`compute_gae`, rlmpc2.py:592-599);
- clipped surrogate + value MSE + entropy bonus, global-norm clip 0.5,
  Adam with decoupled weight decay (rlmpc2.py:775-821);
- Welford online observation normalisation (rlmpc2.py:552-665);
- a logit-space action on the 34 MPC model parameters with EMA smoothing
  and smooth clipping (rlmpc2.py:606-616, 746-759);
- the global replay buffer of the reference's second PPO pass
  (rlmpc2.py:823-874).

The network keeps its parameters in float32, as flax does, and computes
in the promoted type of its input and its parameters, so a float64 input
gives a float64 forward pass (std included) on float32 weights, as JAX's
float64 runs do. The optimizer is written
as optax's `chain(clip_by_global_norm, adamw)` orders its arithmetic.
Functions take a leading lane axis where JAX vmaps; every random draw
comes from an explicit `torch.Generator` or is passed in.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn

from dart_tpu_torch.utils.device import resolve

_LOG_2PI = math.log(2 * math.pi)


# --------------------------------------------------------------------------
# Policy network
# --------------------------------------------------------------------------

class ActorCritic(nn.Module):
    """Tanh MLP actor + critic with a learned state-independent log_std.

    Submodules carry the flax names (`actor_0`, ..., `actor_out`,
    `critic_0`, ..., `critic_out`, `log_std`), so a flax parameter tree
    maps onto `state_dict()` one to one. `forward(obs (..., obs_dim))`
    returns (mean (..., act_dim), std (act_dim,), value (...)). Built on
    the CPU in float32 from `generator` (a CPU one); move it with
    `.to(device)`."""

    def __init__(self, act_dim: int, obs_dim: int, hidden_size: int = 64,
                 hidden_layers: int = 2, std_init: float = 0.1,
                 std_min: float = 1e-2, std_max: float = 2.0,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.hidden_layers = hidden_layers
        self.log_std_lo, self.log_std_hi = math.log(std_min), math.log(std_max)

        def dense(fan_in, fan_out):
            lin = nn.Linear(fan_in, fan_out)
            with torch.no_grad():
                nn.init.orthogonal_(lin.weight, gain=math.sqrt(2),
                                    generator=generator)
                nn.init.zeros_(lin.bias)
            return lin

        for head, out in (("actor", act_dim), ("critic", 1)):
            fan_in = obs_dim
            for i in range(hidden_layers):
                self.add_module(f"{head}_{i}", dense(fan_in, hidden_size))
                fan_in = hidden_size
            self.add_module(f"{head}_out", dense(fan_in, out))
        self.log_std = nn.Parameter(torch.full((act_dim,),
                                               math.log(std_init)))

    def _mlp(self, head: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.hidden_layers):
            x = torch.tanh(_dense(getattr(self, f"{head}_{i}"), x))
        return _dense(getattr(self, f"{head}_out"), x)

    def forward(self, obs: torch.Tensor):
        mean = self._mlp("actor", obs)
        value = self._mlp("critic", obs)[..., 0]
        # flax clips with float64 bounds: the std takes the run's float type.
        log_std = self.log_std.to(torch.promote_types(obs.dtype,
                                                      self.log_std.dtype))
        log_std = torch.clamp(log_std, self.log_std_lo, self.log_std_hi)
        return mean, torch.exp(log_std), value


def _dense(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax Dense: input and parameters promoted to their common type,
    x @ kernel + bias."""
    dt = torch.promote_types(x.dtype, lin.weight.dtype)
    return x.to(dt) @ lin.weight.to(dt).T + lin.bias.to(dt)


def normal_logp(x, mean, std):
    z = (x - mean) / std
    return torch.sum(-0.5 * z * z - torch.log(std) - 0.5 * _LOG_2PI, dim=-1)


def normal_entropy(std):
    return torch.sum(0.5 * (1.0 + _LOG_2PI) + torch.log(std), dim=-1)


# --------------------------------------------------------------------------
# Welford online normalisation (leaves with any leading lane axes)
# --------------------------------------------------------------------------

class WelfordState(NamedTuple):
    mean: torch.Tensor     # (..., dim)
    m2: torch.Tensor       # (..., dim)
    count: torch.Tensor    # (...)


def welford_init(dim: int, dtype=torch.float32, device="cuda",
                 batch: tuple = ()) -> WelfordState:
    device = resolve(device)
    z = torch.zeros((*batch, dim), dtype=dtype, device=device)
    return WelfordState(z, z.clone(),
                        torch.zeros(batch, dtype=dtype, device=device))


def welford_update(s: WelfordState, x: torch.Tensor) -> WelfordState:
    count = s.count + 1.0
    delta = x - s.mean
    mean = s.mean + delta / count[..., None]
    m2 = s.m2 + delta * (x - mean)
    return WelfordState(mean, m2, count)


def welford_normalize(s: WelfordState, x: torch.Tensor) -> torch.Tensor:
    c = s.count[..., None]
    var = torch.where(c > 1.0, s.m2 / torch.clamp_min(c - 1.0, 1.0),
                      torch.ones_like(s.m2) * 1e-6)
    std = torch.sqrt(torch.clamp_min(var, 1e-12))
    return (x - s.mean) / (std + 1e-8)


# --------------------------------------------------------------------------
# GAE
# --------------------------------------------------------------------------

def compute_gae(rewards, values, dones, last_value, gamma=0.99, lam=0.95):
    """rewards/values/dones (..., T), last_value (...); returns the
    advantages (..., T): the reverse scan of `rlmpc2.py:592-599` per
    lane."""
    values_ext = torch.cat([values, last_value[..., None]], -1)
    gae = torch.zeros(rewards.shape[:-1], dtype=rewards.dtype,
                      device=rewards.device)
    adv = [None] * rewards.shape[-1]
    for t in reversed(range(rewards.shape[-1])):
        r, v, v_next, d = (rewards[..., t], values_ext[..., t],
                           values_ext[..., t + 1], dones[..., t])
        delta = r + gamma * v_next * (1.0 - d) - v
        gae = delta + gamma * lam * (1.0 - d) * gae
        adv[t] = gae
    return torch.stack(adv, -1)


# --------------------------------------------------------------------------
# Logit-space parameter action (the 34 MPC model params are the action)
# --------------------------------------------------------------------------

class ParamActionConfig(NamedTuple):
    k_max: float = 2.0            # max_param_abs (`run.py:139`)
    max_delta: float = 0.02       # max_delta_abs (`run.py:140`)
    action_scale: float = 1.0
    min_k: float = 1e-2
    ceiling_margin: float = 0.1   # max(1e-3, 0.05*k_max)
    ema_alpha: float = 0.5        # shm_smooth_alpha
    max_per_dim_rms: float = 0.5


def smooth_clip(x, min_v, max_v, margin=1e-3):
    center = (max_v + min_v) / 2.0
    scale = (max_v - min_v) / 2.0 - margin
    return center + scale * torch.tanh((x - center) / scale)


def apply_param_action(current_k: torch.Tensor, raw_action: torch.Tensor,
                       cfg: ParamActionConfig) -> torch.Tensor:
    """z_new = logit(k/k_max) + raw*max_delta*scale; k = k_max sigmoid(z_new);
    then EMA + smooth clip (`rlmpc2.py:606-616, 746-759`), per lane over
    the last axis."""
    delta_z = raw_action * (cfg.max_delta * cfg.action_scale)
    # auto-damp overlarge steps (`rlmpc2.py:691-696`)
    per_dim_rms = torch.linalg.vector_norm(delta_z, dim=-1, keepdim=True) \
        / math.sqrt(delta_z.shape[-1])
    damp = torch.where(per_dim_rms > cfg.max_per_dim_rms,
                       cfg.max_per_dim_rms / (per_dim_rms + 1e-12), 1.0)
    delta_z = delta_z * damp
    min_frac = cfg.min_k / cfg.k_max
    frac = torch.clamp(current_k / cfg.k_max, min_frac, 1.0 - 1e-6)
    z_new = torch.logit(frac) + delta_z
    k_new = cfg.k_max * torch.sigmoid(z_new)
    smoothed = cfg.ema_alpha * k_new + (1.0 - cfg.ema_alpha) * current_k
    return smooth_clip(smoothed, cfg.min_k, cfg.k_max - cfg.ceiling_margin)


# --------------------------------------------------------------------------
# Reward shaping
# --------------------------------------------------------------------------

class RewardConfig(NamedTuple):
    sigma_pos: float = 0.02
    sigma_vel: float = 0.02
    w_pos: float = 60.0
    w_vel: float = 30.0
    w_change: float = 1e-3
    w_d_ctrl: float = 5.0
    success_bonus: float = 20.0
    oob_penalty: float = 20.0
    contact_penalty: float = 10.0
    tray_limit_x: float = 0.2
    tray_limit_y: float = 0.15
    time_penalty_rate: float = 1e-4


def prox_reward(pos_err, vel_err, cfg: RewardConfig):
    """Gaussian proximity; the vel term multiplies the pos term
    (`rlmpc2.py:601-604`)."""
    pos_term = torch.exp(-(pos_err**2) / (2 * cfg.sigma_pos**2))
    vel_term = torch.exp(-(vel_err**2) / (2 * cfg.sigma_vel**2))
    return cfg.w_pos * pos_term + cfg.w_vel * pos_term * vel_term


def shaped_reward(state, target, control, prev_control, delta_z_norm,
                  time_penalty, in_contact, cfg: RewardConfig):
    """The reward of `rlmpc2.py:703-740` per lane: state and target
    (..., 8), controls (..., 2), the rest (...). Returns (reward, oob)."""
    pos = torch.stack([state[..., 0], state[..., 2]], -1)
    vel = torch.stack([state[..., 1], state[..., 3]], -1)
    tpos = torch.stack([target[..., 0], target[..., 2]], -1)
    pos_err = torch.linalg.vector_norm(tpos - pos, dim=-1)
    vel_err = torch.linalg.vector_norm(vel, dim=-1)
    r = prox_reward(pos_err, vel_err, cfg)
    r = r - cfg.w_change * delta_z_norm
    r = r - cfg.w_d_ctrl * torch.sum(torch.abs(control - prev_control), -1)
    r = r - time_penalty
    r = r + torch.where((pos_err < 0.01) & (vel_err < 0.01),
                        cfg.success_bonus, 0.0)
    oob = (torch.abs(state[..., 0]) > cfg.tray_limit_x) | \
          (torch.abs(state[..., 2]) > cfg.tray_limit_y)
    r = r - torch.where(oob, cfg.oob_penalty, 0.0)
    r = r - torch.where(in_contact == 0.0, cfg.contact_penalty, 0.0)
    return r, oob


# --------------------------------------------------------------------------
# Optimizer: optax.chain(clip_by_global_norm, adamw)
# --------------------------------------------------------------------------

class PPOConfig(NamedTuple):
    lr: float = 3e-4
    weight_decay: float = 1e-5
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    epochs: int = 8
    minibatch_size: int = 64
    max_grad_norm: float = 0.5
    gamma: float = 0.99
    gae_lambda: float = 0.95


class AdamW(torch.optim.Optimizer):
    """`optax.adamw` (b1 0.9, b2 0.999, eps 1e-8) in optax's order of
    operations, per parameter:

        mu = (1-b1) g + b1 mu;  nu = (1-b2) g^2 + b2 nu
        u = (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)
        p = p + (u + wd p) * (-lr)

    with the bias corrections taken in float64 and cast to each
    parameter's type, after the global-norm clip of the gradients
    (`clip_by_global_norm`). `torch.optim.AdamW` decays first as
    p (1 - lr wd), which rounds to p itself for float32 parameters at
    PPO's lr and wd. The state holds `step`, `exp_avg` and `exp_avg_sq`,
    AdamW's names."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float, weight_decay: float,
                 max_grad_norm: float):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      max_grad_norm=max_grad_norm))

    @torch.no_grad()
    def step(self):
        b1, b2 = self.B1, self.B2
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            grads = clip_by_global_norm([p.grad for p in ps],
                                        group["max_grad_norm"])
            for p, g in zip(ps, grads):
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = int(st["step"])
                mu = (1 - b1) * g + b1 * st["exp_avg"]
                nu = (1 - b2) * (g * g) + b2 * st["exp_avg_sq"]
                mu_hat = mu / torch.tensor(1 - b1**t, dtype=p.dtype)
                nu_hat = nu / torch.tensor(1 - b2**t, dtype=p.dtype)
                u = mu_hat / (torch.sqrt(nu_hat + 0.0) + self.EPS)
                u = u + group["weight_decay"] * p
                p.add_(u * (-group["lr"]))
                st["exp_avg"], st["exp_avg_sq"] = mu, nu


def clip_by_global_norm(grads: list, max_norm: float) -> list:
    """optax's clip: unchanged below `max_norm`, else t / ||g|| * max_norm
    with ||g|| the square root of the sum of each leaf's sum of squares
    (each in its own type, summed in the promoted one), cast to the
    leaf's type."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    scale = g_norm < max_norm
    return [torch.where(scale, g, (g / g_norm.to(g.dtype)) * max_norm)
            for g in grads]


def make_optimizer(model: nn.Module, cfg: PPOConfig) -> AdamW:
    return AdamW(model.parameters(), lr=cfg.lr,
                 weight_decay=cfg.weight_decay,
                 max_grad_norm=cfg.max_grad_norm)


# --------------------------------------------------------------------------
# PPO update
# --------------------------------------------------------------------------

class Batch(NamedTuple):
    obs: torch.Tensor         # (T, obs_dim)
    actions: torch.Tensor     # (T, act_dim)
    logps: torch.Tensor       # (T,)
    advantages: torch.Tensor  # (T,)
    returns: torch.Tensor     # (T,)


def ppo_loss(model: ActorCritic, batch: Batch, cfg: PPOConfig):
    mean, std, value = model(batch.obs)
    logp = normal_logp(batch.actions, mean, std)
    ratio = torch.exp(logp - batch.logps)
    surr1 = ratio * batch.advantages
    surr2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) \
        * batch.advantages
    policy_loss = -torch.mean(torch.minimum(surr1, surr2))
    value_loss = torch.mean((value - batch.returns) ** 2)
    entropy = torch.mean(normal_entropy(std))
    loss = policy_loss + cfg.vf_coef * value_loss - cfg.ent_coef * entropy
    return loss, (policy_loss, value_loss, entropy)


def draw_perms(gen: torch.Generator, epochs: int, T: int) -> torch.Tensor:
    """(epochs, T) minibatch orders, one permutation an epoch."""
    return torch.stack([torch.randperm(T, generator=gen, device=gen.device)
                        for _ in range(epochs)])


def ppo_update(model: ActorCritic, opt: AdamW, batch: Batch,
               cfg: PPOConfig, perms: torch.Tensor | None = None,
               gen: torch.Generator | None = None):
    """Minibatched multi-epoch PPO pass, in place on `model` and `opt`.

    Advantages and returns are normalised over the whole batch with the
    population std (rlmpc2.py:783,790). `perms` (epochs, T) orders each
    epoch's samples (drawn from `gen` when not given); the minibatches
    are consecutive `minibatch_size` slices of it, a remainder dropped.
    Returns the means of (policy_loss, value_loss, entropy) over the
    minibatches, each taken before its step."""
    T = batch.obs.shape[0]
    adv = batch.advantages
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    ret = batch.returns
    ret = (ret - ret.mean()) / (ret.std(correction=0) + 1e-8)
    batch = batch._replace(advantages=adv, returns=ret)
    mb = min(cfg.minibatch_size, T)
    n_mb = max(T // mb, 1)
    if perms is None:
        perms = draw_perms(gen, cfg.epochs, T)
    perms = perms.to(batch.obs.device)
    aux = []
    for e in range(cfg.epochs):
        for i in range(n_mb):
            take = perms[e, i * mb:(i + 1) * mb]
            mb_batch = Batch(*(x[take] for x in batch))
            opt.zero_grad(set_to_none=True)
            loss, stats = ppo_loss(model, mb_batch, cfg)
            loss.backward()
            opt.step()
            aux.append(torch.stack([s.detach().to(loss.dtype)
                                    for s in stats]))
    return tuple(torch.stack(aux).mean(0))


# --------------------------------------------------------------------------
# Global replay buffer (the reference's SECOND PPO pass, rlmpc2.py:823-874:
# after each local update, 25% of the rollout is subsampled into a global
# buffer; when it holds >= rollout_len transitions, a full PPO pass runs over
# it -- GAE over insertion order, bootstrapped from the last entry -- and the
# buffer clears)
# --------------------------------------------------------------------------

class ReplayBuffer(NamedTuple):
    """Fixed-capacity insertion-ordered buffer."""

    obs: torch.Tensor        # (C, obs_dim)
    actions: torch.Tensor    # (C, act_dim)
    logps: torch.Tensor      # (C,)
    rewards: torch.Tensor    # (C,)
    values: torch.Tensor     # (C,)
    dones: torch.Tensor      # (C,)
    size: torch.Tensor       # () int32, valid prefix length


def replay_init(capacity: int, obs_dim: int, act_dim: int,
                dtype=torch.float32, device="cuda") -> ReplayBuffer:
    device = resolve(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return ReplayBuffer(obs=z(capacity, obs_dim), actions=z(capacity, act_dim),
                        logps=z(capacity), rewards=z(capacity),
                        values=z(capacity), dones=z(capacity),
                        size=torch.zeros((), dtype=torch.int32,
                                         device=device))


def replay_take(T: int, frac: float = 0.25) -> int:
    return max(1, int(T * frac))


def replay_add_subsample(buf: ReplayBuffer, obs, actions, logps, rewards,
                         values, dones, idx: torch.Tensor | None = None,
                         gen: torch.Generator | None = None,
                         frac: float = 0.25) -> ReplayBuffer:
    """Append `frac` of a flattened rollout, subsampled without replacement
    (`rlmpc2.py:822-827`; `idx` the rows, else drawn from `gen`), at the
    buffer's write position. The write offset is clamped so a full buffer
    is never overrun: size the capacity as a multiple of the per-call take
    (the trainers use capacity = rollout samples, take = 1/4 of them =>
    flush every 4 steps)."""
    T = obs.shape[0]
    C = buf.obs.shape[0]
    n_take = replay_take(T, frac)
    if C % n_take != 0:
        raise ValueError(
            f"replay capacity {C} must be a multiple of the per-call take "
            f"{n_take} (= max(1, int({T} * {frac}))); a non-multiple "
            f"silently overwrites the buffer tail")
    if idx is None:
        idx = torch.randperm(T, generator=gen, device=gen.device)[:n_take]
    idx = idx.to(obs.device)
    off = torch.clamp_max(buf.size, C - n_take)
    rows = off.long() + torch.arange(n_take, device=obs.device)

    def wr(dst, src):
        return dst.index_copy(0, rows, src[idx].to(dst.dtype))

    return ReplayBuffer(
        obs=wr(buf.obs, obs), actions=wr(buf.actions, actions),
        logps=wr(buf.logps, logps), rewards=wr(buf.rewards, rewards),
        values=wr(buf.values, values), dones=wr(buf.dones, dones),
        size=torch.clamp_max(buf.size + n_take, C).to(torch.int32))


def replay_maybe_update(model: ActorCritic, opt: AdamW, buf: ReplayBuffer,
                        cfg: PPOConfig, perms: torch.Tensor | None = None,
                        gen: torch.Generator | None = None):
    """Run the global PPO pass iff the buffer is full, then clear it
    (`rlmpc2.py:828-874`); one host read of the fill. `perms` (epochs, C)
    orders the pass (drawn from `gen` when not given). Returns (buf,
    did_update)."""
    C = buf.obs.shape[0]
    if not bool(buf.size >= C):
        return buf, False
    with torch.no_grad():
        _, _, last_val = model(buf.obs[-1])
    adv = compute_gae(buf.rewards, buf.values, buf.dones, last_val,
                      cfg.gamma, cfg.gae_lambda)
    batch = Batch(obs=buf.obs, actions=buf.actions, logps=buf.logps,
                  advantages=adv, returns=adv + buf.values)
    ppo_update(model, opt, batch, cfg, perms, gen)
    return buf._replace(size=torch.zeros_like(buf.size)), True

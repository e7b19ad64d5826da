"""LMPC PPO training on the CALIBRATED tray-lag plant (port of
`dart_tpu.adapt.lmpc_lagplant`, the trainer that produced
`artifacts/lmpc/lagplant_r5`).

It trains the 34-parameter tuner on `physics.tray_object`'s calibrated
lag plant, the plant the LMPC evaluator measures on
(`rollout.evaluate.make_lmpc_evaluator`), small-signal backlash included:
a policy must experience the deployment plant's small-signal regime to
stabilise it, as the reference's policy is trained in the MuJoCo world it
is evaluated in (`run.py:160-311`).

One env step = one MPC control period = `substeps` x 2 ms plant steps,
for B envs at once. The PPO machinery and the observation, action and
update steps are `adapt.lmpc_trainer`'s; the reset draws a target and
object parameters.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dart_tpu_torch.adapt import lmpc_trainer as trainer
from dart_tpu_torch.adapt import ppo as ppo_mod
from dart_tpu_torch.control import mpc as mpc_mod
from dart_tpu_torch.physics import tray_object as to_mod
from dart_tpu_torch.utils.device import resolve
from dart_tpu_torch.utils.tree import lane_where


class LagEnvConfig(NamedTuple):
    dt: float = 0.002               # plant step (2 ms)
    substeps: int = 5               # plant steps per control period
    max_episode_steps: int = 768    # control periods (hold curriculum)
    param_update_every: int = 8
    act_cfg: ppo_mod.ParamActionConfig = ppo_mod.ParamActionConfig()
    rew_cfg: ppo_mod.RewardConfig = ppo_mod.RewardConfig()


class LagEnvState(NamedTuple):
    plant: to_mod.TrayObjectState
    ctrl_carry: Any
    current_k: torch.Tensor
    welford: ppo_mod.WelfordState
    history: torch.Tensor
    prev_control: torch.Tensor
    time_penalty: torch.Tensor
    episode_step: torch.Tensor
    target: torch.Tensor                # (B, 8)
    obj_params: to_mod.TrayObjectParams


def sample_obj_params(gen: torch.Generator, B: int, dtype=torch.float32,
                      device="cuda") -> to_mod.TrayObjectParams:
    """Shape, mass and friction drawn over the 18-config envelope on the
    FULLY CALIBRATED plant (mass-resolved lag, per-shape dissipation,
    mu-resolved damping, small-signal backlash): what
    `physics.tray_object.scenario_params` builds for the sweeps."""
    device = resolve(device)
    kappa_table = torch.tensor([[0.0, 0.0], [2.0, 0.0], [2.5, 2.5]],
                               dtype=dtype)
    shape = torch.randint(0, 3, (B,), generator=gen, device=gen.device)
    mass = trainer._choice(gen, (1.0, 2.0, 3.0), (B,), dtype)
    mu = trainer._choice(gen, (0.05, 0.1, 0.2), (B,), dtype)
    return to_mod.scenario_params(kappa_table[shape.cpu()].to(device), mass.to(device),
                        mu.to(device), dtype)


def draw_step(gen: torch.Generator, B: int, dtype=torch.float32,
              device="cuda") -> trainer.StepDraws:
    device = resolve(device)
    noise = torch.randn((B, trainer.N_PARAMS), generator=gen,
                        device=gen.device, dtype=dtype)
    target = trainer.sample_target(gen, B, dtype)
    return trainer.StepDraws(noise=noise.to(device), target=target.to(device),
                             plant=sample_obj_params(gen, B, dtype, device))


def observe8(plant: to_mod.TrayObjectState,
             obj_params: to_mod.TrayObjectParams) -> torch.Tensor:
    """World-frame LMPC 8-state (B, 8), the evaluator's layout and signs."""
    pos, vel = to_mod.observe_world(plant, obj_params)
    th, thd = plant.theta, plant.theta_dot
    return torch.stack([pos[:, 0], vel[:, 0], pos[:, 1], vel[:, 1],
                        th[:, 1], thd[:, 1], -th[:, 0], -thd[:, 0]], -1)


def _fresh(ctlr, B, dtype, dev) -> dict:
    return dict(plant=to_mod.init_state(dtype=dtype, device=dev, batch=B),
                **trainer._fresh(ctlr, B, dtype, dev))


def env_init(ctlr: mpc_mod.LMPC, cfg: LagEnvConfig, B: int,
             dtype=torch.float32, device="cuda",
             gen: torch.Generator | None = None,
             draws: trainer.InitDraws | None = None) -> LagEnvState:
    device = resolve(device)
    if draws is None:
        target = trainer.sample_target(gen, B, dtype).to(device)
        obj = sample_obj_params(gen, B, dtype, device)
        init_k = trainer.sample_init_k(gen, B, cfg.act_cfg, dtype)
        draws = trainer.InitDraws(target, obj, init_k.to(device))
    return LagEnvState(
        current_k=draws.init_k,
        welford=ppo_mod.welford_init(trainer.BASE_OBS_DIM, dtype, device,
                                     (B,)),
        target=draws.target, obj_params=draws.plant,
        **_fresh(ctlr, B, dtype, device))


def _base(s: LagEnvState) -> torch.Tensor:
    return torch.cat([observe8(s.plant, s.obj_params), s.target,
                      s.prev_control, s.current_k], -1)


@torch.no_grad()
def env_step(model: ppo_mod.ActorCritic, ctlr: mpc_mod.LMPC,
             s: LagEnvState, cfg: LagEnvConfig,
             draws: trainer.StepDraws | None = None,
             gen: torch.Generator | None = None):
    """One control period of every lane on the contact plant; the plant
    gets -u (the model's +g against the tray's -g, `run.py:257`) while the
    reward and the next observation carry u. Returns (state',
    Transition)."""
    B, dtype, dev = s.target.shape[0], s.target.dtype, s.target.device
    if draws is None:
        draws = draw_step(gen, B, dtype, dev)
    x = observe8(s.plant, s.obj_params)
    base = torch.cat([x, s.target, s.prev_control, s.current_k], -1)
    welford, history, obs = trainer.observe(s.welford, s.history, base)
    raw_action, logp, value, delta_z, current_k = trainer.act(
        model, obs, draws.noise, s.current_k, s.episode_step, cfg)

    carry, u, _ = ctlr.solve(s.ctrl_carry, x, s.target, current_k)
    u_applied = -u
    plant = s.plant
    for _ in range(cfg.substeps):
        plant = to_mod.step(plant, u_applied, s.obj_params, cfg.dt)

    x_next = observe8(plant, s.obj_params)
    in_contact = torch.where(to_mod.contact_lost(plant), 0.0, 1.0).to(dtype)
    reward, oob = ppo_mod.shaped_reward(
        x_next, s.target, u, s.prev_control,
        torch.linalg.vector_norm(delta_z, dim=-1), s.time_penalty,
        in_contact, cfg.rew_cfg)
    episode_step = s.episode_step + 1
    done = oob | (episode_step >= cfg.max_episode_steps)

    reset = LagEnvState(current_k=current_k, welford=welford,
                        target=draws.target, obj_params=draws.plant,
                        **_fresh(ctlr, B, dtype, dev))
    cont = LagEnvState(
        plant=plant, ctrl_carry=carry, current_k=current_k, welford=welford,
        history=history, prev_control=u,
        time_penalty=s.time_penalty + cfg.rew_cfg.time_penalty_rate,
        episode_step=episode_step, target=s.target,
        obj_params=s.obj_params)
    s_next = lane_where(done, reset, cont)
    return s_next, trainer.Transition(obs=obs, action=raw_action, logp=logp,
                                      value=value, reward=reward,
                                      done=done.to(torch.float32))


def make_train_step(ctlr: mpc_mod.LMPC, env_cfg: LagEnvConfig,
                    ppo_cfg: ppo_mod.PPOConfig, rollout_len: int,
                    replay: bool = False):
    """`lmpc_trainer.make_train_step` with the lag-plant env (dual-buffer
    replay supported)."""
    def collect(model, s, draws, gen):
        def step(s, d, gen):
            return env_step(model, ctlr, s, env_cfg, d, gen)

        return trainer._rollout(step, _base, model, s, rollout_len, draws,
                                gen)

    return trainer._make_train_step(collect, ppo_cfg, replay)

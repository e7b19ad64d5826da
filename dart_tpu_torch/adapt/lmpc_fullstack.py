"""LMPC PPO training against the FULL physics stack (port of
`dart_tpu.adapt.lmpc_fullstack`).

The environment plant is the complete dual-arm world of
`rollout.full_stack` (impedance QPs, chain dynamics, rigid-grasp tray,
contact object), with domain randomisation over the physical scene
(shape, mass, friction: the MjSpec-recompile analog, `run.py:204-241`)
instead of the 34-vector. One env step = one MPC control period =
`substeps` x 2 ms world steps, for B envs at once: the envs are the lanes
of one `LMPC.solve` (each backward pass one `riccati_backward` launch on
the card) and the world's arms batch over them.

The observation, the action, the train step and the PPO update are
`adapt.lmpc_trainer`'s and `adapt.ppo`'s. Every random draw comes from a
CPU `torch.Generator` behind an argument a caller can fill instead: the
action noise, the reset's target and object (`sample_obj_params`'s shape,
mass and mu), `env_init`'s start.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from dart_tpu_torch.adapt import lmpc_trainer as trainer
from dart_tpu_torch.adapt import ppo as ppo_mod
from dart_tpu_torch.control import mpc as mpc_mod
from dart_tpu_torch.physics import tray_object as to_mod
from dart_tpu_torch.rollout import full_stack as fs
from dart_tpu_torch.utils.device import constant, resolve
from dart_tpu_torch.utils.tree import lane_where

N_PARAMS = trainer.N_PARAMS


class FSEnvConfig(NamedTuple):
    dt: float = 0.002               # world step (2 ms)
    substeps: int = 5               # world steps per control period
    qp_iters: int = 20              # arm ADMM iterations per world step
    max_episode_steps: int = 256    # control periods per episode
    param_update_every: int = 8
    act_cfg: ppo_mod.ParamActionConfig = ppo_mod.ParamActionConfig()
    rew_cfg: ppo_mod.RewardConfig = ppo_mod.RewardConfig()
    # Domain-randomisation shape distribution (cube, cylinder, sphere); the
    # r5 hold curriculum oversamples spheres, e.g. (0.25, 0.25, 0.5).
    shape_probs: tuple = (1 / 3, 1 / 3, 1 / 3)


class FSEnvState(NamedTuple):
    """B envs, every leaf with a leading lane axis."""

    world: fs.FullState
    ctrl_carry: Any                 # LMPCCarry
    current_k: torch.Tensor         # (B, 34)
    welford: ppo_mod.WelfordState
    history: torch.Tensor           # (B, H, BASE_OBS_DIM)
    prev_control: torch.Tensor      # (B, 2)
    time_penalty: torch.Tensor      # (B,)
    episode_step: torch.Tensor      # (B,) int32
    target: torch.Tensor            # (B, 8)
    obj_params: to_mod.TrayObjectParams


def object_params(shape: torch.Tensor, mass: torch.Tensor, mu: torch.Tensor,
                  dtype=torch.float32) -> to_mod.TrayObjectParams:
    """The scene of `sample_obj_params`'s choices: shape ids (B,) (0 cube,
    1 cylinder, 2 sphere), mass and mu (B,), on the MuJoCo-calibrated
    per-shape contact dissipation, every leaf shaped as the JAX module's
    under `vmap`. The lag fields (`omega_n`, `zeta`, `lag_fast`, `back_w`,
    `back_gss`) are inert: the full stack realises the tray tilt through
    the simulated arms and steps the object with `step_object`."""
    B, dev = mass.shape[0], mass.device

    def tab(rows):
        return constant(rows, dtype, dev)

    def lanes(v, n=None):
        return torch.full((B,) if n is None else (B, n), v, dtype=dtype,
                          device=dev)

    shape = shape.to(dev).long()
    mass, mu = mass.to(dev, dtype), mu.to(dev, dtype)
    kappa = tab(((0.0, 0.0), (2.0, 0.0), (2.5, 2.5)))[shape]
    rr = tab(tuple(to_mod.CALIBRATED_ROLL_RESIST[s] for s in to_mod.SHAPES))
    sd = tab(tuple(to_mod.CALIBRATED_SLIDE_DAMP[s] for s in to_mod.SHAPES))
    return to_mod.TrayObjectParams(
        mass=mass, mu=mu, kappa_inv=kappa, slip_eps=lanes(2e-3),
        omega_n=lanes(40.0), zeta=lanes(1.0),
        tray_pos=tab((0.0, 0.0, 0.4)).expand(B, 3),
        half_w=lanes(0.025, 2), h_com=lanes(0.025),
        topple_on=tab(((1.0, 1.0), (0.0, 1.0), (0.0, 0.0)))[shape],
        roll_resist=rr[shape],
        slide_damp=to_mod.calibrated_slide_damp(sd[shape], mu, dtype),
        roll_stick=to_mod.calibrated_roll_stick(kappa, mu, dtype),
        stick_vel=lanes(5e-3), lag_fast=lanes(0.0), back_w=lanes(0.0),
        back_gss=lanes(1.0))


def sample_obj_params(gen: torch.Generator, B: int, dtype=torch.float32,
                      device="cuda", shape_probs=(1 / 3, 1 / 3, 1 / 3)
                      ) -> to_mod.TrayObjectParams:
    """Shape (drawn with `shape_probs`), mass in {1, 2, 3} and mu in {0.05,
    0.1, 0.2} over the 18-config envelope."""
    device = resolve(device)
    shape = torch.multinomial(torch.tensor(shape_probs, dtype=torch.float64),
                              B, replacement=True, generator=gen)
    mass = trainer._choice(gen, (1.0, 2.0, 3.0), (B,), dtype)
    mu = trainer._choice(gen, (0.05, 0.1, 0.2), (B,), dtype)
    return object_params(shape.to(device), mass.to(device), mu.to(device),
                         dtype)


def draw_step(gen: torch.Generator, B: int, cfg: FSEnvConfig,
              dtype=torch.float32, device="cuda") -> trainer.StepDraws:
    device = resolve(device)
    noise = torch.randn((B, N_PARAMS), generator=gen, device=gen.device,
                        dtype=dtype)
    target = trainer.sample_target(gen, B, dtype)
    return trainer.StepDraws(
        noise=noise.to(device), target=target.to(device),
        plant=sample_obj_params(gen, B, dtype, device, cfg.shape_probs))


def _fresh(ctlr: mpc_mod.LMPC, B: int, dtype, dev) -> dict:
    return dict(world=fs.init_full_state(dtype, device=dev, batch=B),
                **trainer._fresh(ctlr, B, dtype, dev))


def env_init(ctlr: mpc_mod.LMPC, cfg: FSEnvConfig, B: int,
             dtype=torch.float32, device="cuda",
             gen: torch.Generator | None = None,
             draws: trainer.InitDraws | None = None) -> FSEnvState:
    device = resolve(device)
    if draws is None:
        target = trainer.sample_target(gen, B, dtype).to(device)
        obj = sample_obj_params(gen, B, dtype, device, cfg.shape_probs)
        init_k = trainer.sample_init_k(gen, B, cfg.act_cfg, dtype)
        draws = trainer.InitDraws(target, obj, init_k.to(device))
    return FSEnvState(
        current_k=draws.init_k,
        welford=ppo_mod.welford_init(trainer.BASE_OBS_DIM, dtype, device,
                                     (B,)),
        target=draws.target, obj_params=draws.plant,
        **_fresh(ctlr, B, dtype, device))


def _base(s: FSEnvState) -> torch.Tensor:
    return torch.cat([fs.observe_object_8(s.world, s.obj_params), s.target,
                      s.prev_control, s.current_k], -1)


@torch.no_grad()
def env_step(model: ppo_mod.ActorCritic, ctlr: mpc_mod.LMPC,
             scene: fs.DualArmScene, s: FSEnvState, cfg: FSEnvConfig,
             draws: trainer.StepDraws | None = None,
             gen: torch.Generator | None = None):
    """One control period of every env on the full world: observe -> act
    (param tune) -> MPC solve -> `substeps` world steps with -u (the
    model's +g against the tray's -g, `run.py:257`) -> reward -> per-lane
    reset. Returns (state', Transition)."""
    B, dtype, dev = s.target.shape[0], s.target.dtype, s.target.device
    if draws is None:
        draws = draw_step(gen, B, cfg, dtype, dev)
    x = fs.observe_object_8(s.world, s.obj_params)
    base = torch.cat([x, s.target, s.prev_control, s.current_k], -1)
    welford, history, obs = trainer.observe(s.welford, s.history, base)
    raw_action, logp, value, delta_z, current_k = trainer.act(
        model, obs, draws.noise, s.current_k, s.episode_step, cfg)

    carry, u, _ = ctlr.solve(s.ctrl_carry, x, s.target, current_k)
    u_applied = -u
    arms = fs._arms(scene)
    world = s.world
    for _ in range(cfg.substeps):
        world = fs._full_step(arms, scene.arm_params, world, u_applied,
                              s.obj_params, cfg.dt, cfg.qp_iters)

    x_next = fs.observe_object_8(world, s.obj_params)
    in_contact = torch.where(to_mod.contact_lost(world.obj), 0.0,
                             1.0).to(dtype)
    reward, oob = ppo_mod.shaped_reward(
        x_next, s.target, u, s.prev_control,
        torch.linalg.vector_norm(delta_z, dim=-1), s.time_penalty,
        in_contact, cfg.rew_cfg)
    episode_step = s.episode_step + 1
    done = oob | (episode_step >= cfg.max_episode_steps)

    reset = FSEnvState(current_k=current_k, welford=welford,
                       target=draws.target, obj_params=draws.plant,
                       **_fresh(ctlr, B, dtype, dev))
    cont = FSEnvState(
        world=world, ctrl_carry=carry, current_k=current_k, welford=welford,
        history=history, prev_control=u,
        time_penalty=s.time_penalty + cfg.rew_cfg.time_penalty_rate,
        episode_step=episode_step, target=s.target,
        obj_params=s.obj_params)
    s_next = lane_where(done, reset, cont)
    return s_next, trainer.Transition(obs=obs, action=raw_action, logp=logp,
                                      value=value, reward=reward,
                                      done=done.to(torch.float32))


def make_train_step(ctlr: mpc_mod.LMPC, scene: fs.DualArmScene,
                    env_cfg: FSEnvConfig, ppo_cfg: ppo_mod.PPOConfig,
                    rollout_len: int, replay: bool = False,
                    group: dist.ProcessGroup | None = None):
    """`lmpc_trainer.make_train_step` with the full-stack env; with
    ``replay=True`` the reference's dual-buffer update (`rlmpc2.py:
    822-874`), the buffer sized by `lmpc_trainer.init_replay`. `group`
    makes it data parallel over its ranks, as `lmpc_trainer.make_train_step`'s
    does."""
    def collect(model, s, draws, gen):
        def step(s, d, gen):
            return env_step(model, ctlr, scene, s, env_cfg, d, gen)

        return trainer._rollout(step, _base, model, s, rollout_len, draws,
                                gen)

    return trainer._make_train_step(collect, ppo_cfg, replay, group)

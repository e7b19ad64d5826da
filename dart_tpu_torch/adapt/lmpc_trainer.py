"""LMPC online-RL training: MPC-in-the-loop PPO (port of
`dart_tpu.adapt.lmpc_trainer`).

The reference runs three asynchronous processes (main sim / CasADi solver
/ torch PPO) glued with shared memory (`LMPC/src/controller/rlmpc2.py:
110-164`). Here one host loop does the whole of it: observe with Welford
normalisation and a stacked history, act in logit space on the 34 model
parameters, one `LMPC.solve` for every env at once (the envs are its
lanes, each backward pass one `riccati_backward` launch on the card), the
RK4 plant with the env's true parameters, the shaped reward and a per-lane
reset; then GAE and the minibatched PPO update. Domain randomisation over
the plant's true parameters replaces the MjSpec recompile loop of
`LMPC/src/run.py:204-241`.

Every random draw comes from an explicit `torch.Generator` (a CPU one;
draws are moved to the state's device) in one visible place, behind an
argument that can be supplied instead: `draw_step`'s action noise and
reset values, `env_init`'s start, the PPO permutations and the replay
subsample. The numbers differ from `jax.random`'s for the same seed; the
support and structure are the same.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from dart_tpu_torch.adapt import ppo as ppo_mod
from dart_tpu_torch.control import mpc as mpc_mod
from dart_tpu_torch.models import dynamics as dyn
from dart_tpu_torch.utils.device import resolve
from dart_tpu_torch.utils.tree import lane_where, tree_to

HISTORY_LEN = 10          # rlmpc2.py:546
N_PARAMS = dyn.LMPC_N_PARAMS
BASE_OBS_DIM = 8 + 8 + 2 + N_PARAMS   # state + target + control + current_k
OBS_DIM = HISTORY_LEN * BASE_OBS_DIM


class EnvConfig(NamedTuple):
    dt: float = 0.002
    max_episode_steps: int = 512
    param_update_every: int = 8         # rlmpc2.py:742
    act_cfg: ppo_mod.ParamActionConfig = ppo_mod.ParamActionConfig()
    rew_cfg: ppo_mod.RewardConfig = ppo_mod.RewardConfig()


class LMPCEnvState(NamedTuple):
    """B envs, every leaf with a leading lane axis."""

    x: torch.Tensor                 # (B, 8) plant state
    ctrl_carry: Any                 # LMPCCarry
    current_k: torch.Tensor         # (B, 34) policy-tuned model params
    welford: ppo_mod.WelfordState
    history: torch.Tensor           # (B, H, BASE_OBS_DIM) normalised history
    prev_control: torch.Tensor      # (B, 2)
    time_penalty: torch.Tensor      # (B,)
    episode_step: torch.Tensor      # (B,) int32
    target: torch.Tensor            # (B, 8)
    pvec_true: torch.Tensor         # (B, 34) plant ground-truth params


def _shape(batch) -> tuple:
    return (batch,) if isinstance(batch, int) else tuple(batch)


def _choice(gen: torch.Generator, values, shape: tuple,
            dtype: torch.dtype) -> torch.Tensor:
    table = torch.tensor(values, dtype=dtype, device=gen.device)
    idx = torch.randint(len(values), shape, generator=gen, device=gen.device)
    return table[idx]


def _uniform(gen: torch.Generator, shape: tuple, lo: float, hi: float,
             dtype: torch.dtype) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=dtype) * (hi - lo) + lo


def sample_true_params(gen: torch.Generator, batch=(),
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plant parameters (*batch, 34): mass m in {1, 2, 3} on m_x and m_y,
    friction mu in {0.05, 0.1, 0.2} as F_s = mu m g and F_c = 0.8 mu m g on
    both slides, v_s = 0.05, eps = 0.01, k = 0.01, every other entry
    U(0.05, 0.3); the mass {1,2,3} x friction {0.05,0.1,0.2} envelope of
    `run.py:64-65, 219-223` in the learned model's parameter space."""
    shape = _shape(batch)
    mass = _choice(gen, (1.0, 2.0, 3.0), shape, dtype)
    fric = _choice(gen, (0.05, 0.1, 0.2), shape, dtype)
    p = _uniform(gen, (*shape, N_PARAMS), 0.05, 0.3, dtype)
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
    xy = _uniform(gen, (*shape, 2), -0.1, 0.1, dtype)
    t = torch.zeros((*shape, 8), dtype=dtype, device=gen.device)
    t[..., 0] = xy[..., 0]
    t[..., 2] = xy[..., 1]
    return t


def sample_init_k(gen: torch.Generator, batch, cfg: ppo_mod.ParamActionConfig,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The mid-range jittered start of the 34-vector (*batch, 34):
    U(min_k, k_max / 2) (`rlmpc2.py:618-623`)."""
    return _uniform(gen, (*_shape(batch), N_PARAMS), cfg.min_k,
                    cfg.k_max / 2, dtype)


class StepDraws(NamedTuple):
    """One env step's random inputs for B envs: the policy's action noise
    (B, 34) and the values a lane takes if it resets, its target (B, 8)
    and plant parameters (B, 34; the lag plant's TrayObjectParams)."""

    noise: torch.Tensor
    target: torch.Tensor
    plant: Any


class InitDraws(NamedTuple):
    """`env_init`'s random start: targets (B, 8), plant parameters and the
    34-vector (B, 34)."""

    target: torch.Tensor
    plant: Any
    init_k: torch.Tensor


def draw_step(gen: torch.Generator, B: int, dtype=torch.float32,
              device="cuda") -> StepDraws:
    device = resolve(device)
    return tree_to(StepDraws(
        noise=torch.randn((B, N_PARAMS), generator=gen, device=gen.device,
                          dtype=dtype),
        target=sample_target(gen, B, dtype),
        plant=sample_true_params(gen, B, dtype)), device, dtype)


def draw_init(gen: torch.Generator, B: int, cfg: EnvConfig,
              dtype=torch.float32, device="cuda") -> InitDraws:
    device = resolve(device)
    return tree_to(InitDraws(target=sample_target(gen, B, dtype),
                             plant=sample_true_params(gen, B, dtype),
                             init_k=sample_init_k(gen, B, cfg.act_cfg, dtype)),
                   device, dtype)


def _fresh(ctlr: mpc_mod.LMPC, B: int, dtype, dev) -> dict:
    """The fields every episode starts from."""
    return dict(
        ctrl_carry=ctlr.init_carry(B, dtype, dev),
        history=torch.zeros((B, HISTORY_LEN, BASE_OBS_DIM), dtype=dtype,
                            device=dev),
        prev_control=torch.zeros((B, 2), dtype=dtype, device=dev),
        time_penalty=torch.zeros((B,), dtype=dtype, device=dev),
        episode_step=torch.zeros((B,), dtype=torch.int32, device=dev))


def env_init(ctlr: mpc_mod.LMPC, cfg: EnvConfig, B: int,
             dtype=torch.float32, device="cuda",
             gen: torch.Generator | None = None,
             draws: InitDraws | None = None) -> LMPCEnvState:
    device = resolve(device)
    if draws is None:
        draws = draw_init(gen, B, cfg, dtype, device)
    return LMPCEnvState(
        x=torch.zeros((B, 8), dtype=dtype, device=device),
        current_k=draws.init_k,
        welford=ppo_mod.welford_init(BASE_OBS_DIM, dtype, device, (B,)),
        target=draws.target, pvec_true=draws.plant,
        **_fresh(ctlr, B, dtype, device))


class Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor


def _base(s: LMPCEnvState) -> torch.Tensor:
    """The observation's base row: state, target, control, current_k."""
    return torch.cat([s.x, s.target, s.prev_control, s.current_k], -1)


def observe(welford: ppo_mod.WelfordState, history: torch.Tensor,
            base: torch.Tensor, update: bool = True):
    """Welford-normalised, history-stacked observation (rlmpc2.py:641-668)
    of base (B, BASE_OBS_DIM). Returns (welford, history, obs (B,
    OBS_DIM)); with `update=False` the statistics stay as they are."""
    if update:
        welford = ppo_mod.welford_update(welford, base)
    norm = ppo_mod.welford_normalize(welford, base)
    history = torch.cat([history[:, 1:], norm[:, None]], 1)
    return welford, history, history.reshape(history.shape[0], -1)


def act(model: ppo_mod.ActorCritic, obs, noise, current_k, episode_step,
        cfg: EnvConfig):
    """The policy's action in z-space and the tuned 34-vector (updated every
    `param_update_every` steps of the lane's episode). Returns (raw_action,
    logp, value, delta_z, current_k)."""
    mean, std, value = model(obs)
    raw_action = mean + std * noise
    logp = ppo_mod.normal_logp(raw_action, mean, std)
    delta_z = raw_action * (cfg.act_cfg.max_delta * cfg.act_cfg.action_scale)
    do_update = (episode_step % cfg.param_update_every) == 0
    k_new = ppo_mod.apply_param_action(current_k, raw_action, cfg.act_cfg)
    current_k = torch.where(do_update[:, None], k_new, current_k)
    return raw_action, logp, value, delta_z, current_k


@torch.no_grad()
def env_step(model: ppo_mod.ActorCritic, ctlr: mpc_mod.LMPC,
             s: LMPCEnvState, cfg: EnvConfig, draws: StepDraws | None = None,
             gen: torch.Generator | None = None):
    """One environment step of every lane: observe -> act (param tune) ->
    MPC solve -> plant step -> reward -> (per-lane reset). `draws` holds
    the step's random inputs (drawn from `gen` when not given). Returns
    (state', Transition)."""
    B, dtype, dev = s.x.shape[0], s.x.dtype, s.x.device
    if draws is None:
        draws = draw_step(gen, B, dtype, dev)
    welford, history, obs = observe(s.welford, s.history, _base(s))
    raw_action, logp, value, delta_z, current_k = act(
        model, obs, draws.noise, s.current_k, s.episode_step, cfg)

    # --- MPC solve with the tuned model parameters
    carry, u, _ = ctlr.solve(s.ctrl_carry, s.x, s.target, current_k)

    # --- plant step with ground-truth params
    x_next = dyn.rk4_step(dyn.lmpc_dynamics, s.x, u, s.pvec_true, cfg.dt)

    # --- reward (analytic plant: always in contact)
    reward, oob = ppo_mod.shaped_reward(
        x_next, s.target, u, s.prev_control,
        torch.linalg.vector_norm(delta_z, dim=-1), s.time_penalty,
        torch.ones((B,), dtype=dtype, device=dev), cfg.rew_cfg)
    episode_step = s.episode_step + 1
    done = oob | (episode_step >= cfg.max_episode_steps)

    # --- per-lane auto-reset on done (replaces the reset-event barrier,
    # run.py:204-254); the tuned vector and the statistics carry over.
    reset = LMPCEnvState(
        x=torch.zeros_like(s.x), current_k=current_k, welford=welford,
        target=draws.target, pvec_true=draws.plant,
        **_fresh(ctlr, B, dtype, dev))
    cont = LMPCEnvState(
        x=x_next, ctrl_carry=carry, current_k=current_k, welford=welford,
        history=history, prev_control=u,
        time_penalty=s.time_penalty + cfg.rew_cfg.time_penalty_rate,
        episode_step=episode_step, target=s.target, pvec_true=s.pvec_true)
    s_next = lane_where(done, reset, cont)
    return s_next, Transition(obs=obs, action=raw_action, logp=logp,
                              value=value, reward=reward,
                              done=done.to(torch.float32))


def _stack(trs: list) -> Transition:
    """Per-step Transitions -> one with (B, T, ...) leaves."""
    return Transition(*(torch.stack(leaves, 1) for leaves in zip(*trs)))


def _rollout(step: Callable, bootstrap_base: Callable, model, s, T: int,
             draws, gen):
    """T steps of `step(s, draws, gen)`, then the bootstrap value of the
    state reached. Returns (state, Transition (B, T, ...), last_value
    (B,))."""
    trs = []
    with torch.no_grad():
        for t in range(T):
            s, tr = step(s, None if draws is None else draws[t], gen)
            trs.append(tr)
        _, _, obs = observe(s.welford, s.history, bootstrap_base(s),
                            update=False)
        _, _, last_value = model(obs)
    return s, _stack(trs), last_value


def collect_rollout(model: ppo_mod.ActorCritic, ctlr: mpc_mod.LMPC,
                    s: LMPCEnvState, cfg: EnvConfig, T: int,
                    draws: list | None = None,
                    gen: torch.Generator | None = None):
    """T env steps of every lane (`draws`: T StepDraws, else drawn from
    `gen`). Returns (state, Transition with (B, T, ...) leaves, bootstrap
    value (B,) for GAE)."""
    def step(s, d, gen):
        return env_step(model, ctlr, s, cfg, d, gen)

    return _rollout(step, _base, model, s, T, draws, gen)


def eval_rollout(model: ppo_mod.ActorCritic, ctlr: mpc_mod.LMPC,
                 s: LMPCEnvState, cfg: EnvConfig, T: int):
    """Deterministic-policy evaluation rollout that records the channels the
    reference evaluation logs (`run.py:281-287`): pos_error, u_cmd,
    state. No resets. Returns (final env state, dict of (B, T, ...)
    trajectories)."""
    logs = {"pos_error": [], "u_cmd": [], "state": []}
    with torch.no_grad():
        for _ in range(T):
            welford, history, obs = observe(s.welford, s.history, _base(s))
            # The deterministic action: the mean, with zero noise.
            current_k = act(model, obs, torch.zeros_like(s.current_k),
                            s.current_k, s.episode_step, cfg)[-1]
            carry, u, _ = ctlr.solve(s.ctrl_carry, s.x, s.target, current_k)
            x_next = dyn.rk4_step(dyn.lmpc_dynamics, s.x, u, s.pvec_true,
                                  cfg.dt)
            pos_err = torch.linalg.vector_norm(torch.stack(
                [s.target[:, 0] - x_next[:, 0],
                 s.target[:, 2] - x_next[:, 2]], -1), dim=-1)
            s = s._replace(x=x_next, ctrl_carry=carry, current_k=current_k,
                           welford=welford, history=history, prev_control=u,
                           episode_step=s.episode_step + 1)
            for k, v in (("pos_error", pos_err), ("u_cmd", u),
                         ("state", x_next)):
                logs[k].append(v)
    return s, {k: torch.stack(v, 1) for k, v in logs.items()}


class TrainState(NamedTuple):
    model: ppo_mod.ActorCritic
    opt: ppo_mod.AdamW
    gen: torch.Generator | None


class TrainDraws(NamedTuple):
    """One train step's random inputs: the rollout's StepDraws (one a
    step), the local pass's permutations (epochs, B*T), the replay
    subsample's rows and the global pass's permutations (epochs, C).
    None draws that one from the TrainState's generator."""

    rollout: list | None = None
    perms: torch.Tensor | None = None
    subsample: torch.Tensor | None = None
    replay_perms: torch.Tensor | None = None


def _make_train_step(collect: Callable, ppo_cfg: ppo_mod.PPOConfig,
                     replay: bool):
    """The training step around `collect(model, env_states, draws, gen) ->
    (env_states, Transition (B, T, ...), last_values (B,))`."""

    def train_core(ts: TrainState, env_states, buf, draws):
        d = draws if draws is not None else TrainDraws()
        env_states, traj, last_values = collect(ts.model, env_states,
                                                d.rollout, ts.gen)
        adv = ppo_mod.compute_gae(traj.reward, traj.value, traj.done,
                                  last_values, ppo_cfg.gamma,
                                  ppo_cfg.gae_lambda)
        returns = adv + traj.value

        def flat(x):
            return x.reshape((-1,) + x.shape[2:])

        batch = ppo_mod.Batch(obs=flat(traj.obs), actions=flat(traj.action),
                              logps=flat(traj.logp), advantages=flat(adv),
                              returns=flat(returns))
        stats = ppo_mod.ppo_update(ts.model, ts.opt, batch, ppo_cfg,
                                   d.perms, ts.gen)
        stats = {"mean_reward": traj.reward.mean(), **dict(zip(
            ("policy_loss", "value_loss", "entropy"), stats))}
        if buf is not None:
            buf = ppo_mod.replay_add_subsample(
                buf, flat(traj.obs), flat(traj.action), flat(traj.logp),
                flat(traj.reward), flat(traj.value), flat(traj.done),
                d.subsample, ts.gen)
            buf, did = ppo_mod.replay_maybe_update(
                ts.model, ts.opt, buf, ppo_cfg, d.replay_perms, ts.gen)
            stats["global_update"] = float(did)
        return ts, env_states, buf, stats

    if replay:
        def train_step(ts, env_states, buf, draws=None):
            return train_core(ts, env_states, buf, draws)
    else:
        def train_step(ts, env_states, draws=None):
            ts, env_states, _, stats = train_core(ts, env_states, None, draws)
            return ts, env_states, stats

    return train_step


def make_train_step(ctlr: mpc_mod.LMPC, env_cfg: EnvConfig,
                    ppo_cfg: ppo_mod.PPOConfig, rollout_len: int,
                    replay: bool = False):
    """The full training step, in place on the TrainState's model and
    optimizer: (TrainState, LMPCEnvState[, draws]) -> (TrainState, env
    states, stats): a rollout of every env, GAE, the local PPO pass.

    With ``replay=True`` it is the reference's dual-buffer update
    (`rlmpc2.py:822-874`): (ts, env_states, ReplayBuffer[, draws]) -> (ts,
    env_states, buf, stats); after the local pass, 25% of the rollout is
    subsampled into the buffer and a second, global PPO pass runs whenever
    it fills (every 4 steps). Size the buffer with `init_replay(n_envs,
    rollout_len)`."""
    def collect(model, s, draws, gen):
        return collect_rollout(model, ctlr, s, env_cfg, rollout_len, draws,
                               gen)

    return _make_train_step(collect, ppo_cfg, replay)


def init_replay(n_envs: int, rollout_len: int, dtype=torch.float32,
                device="cuda") -> ppo_mod.ReplayBuffer:
    """Global buffer sized to one rollout's samples: 25% subsampling fills
    it in 4 train steps, matching the reference's >= rollout_len trigger."""
    return ppo_mod.replay_init(n_envs * rollout_len, OBS_DIM, N_PARAMS,
                               dtype, device)


def init_train_state(gen: torch.Generator, ppo_cfg: ppo_mod.PPOConfig,
                     device="cuda", **model_kw) -> TrainState:
    """A fresh policy (orthogonal init from `gen`, a CPU generator) on
    `device`, its optimizer, and `gen` for the later draws."""
    device = resolve(device)
    model = ppo_mod.ActorCritic(act_dim=N_PARAMS, obs_dim=OBS_DIM,
                                generator=gen, **model_kw).to(device)
    return TrainState(model, ppo_mod.make_optimizer(model, ppo_cfg), gen)

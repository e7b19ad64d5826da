"""Port parity: the LMPC trainers (`adapt.lmpc_trainer`'s `env_step`,
`collect_rollout` and `make_train_step` with the replay buffer, and
`adapt.lmpc_lagplant`'s `env_step` on the contact plant) against
`dart_tpu`'s, vmapped over the envs, in float64.

JAX threads a key through every env state and the train state; the port
draws from a `torch.Generator` behind arguments a caller can fill. These
tests walk JAX's key chain (the same `split`s in the same order) to make
JAX's draws and hand them to the port, so both sides step the same envs.
The sizes are cut (N=4, two iterations, three envs, a one-layer policy
16 wide on the full 520-wide observation) so the port's host-looped
solves take seconds; most of each test is JAX's compile.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dart_tpu.adapt import lmpc_lagplant as jlag
from dart_tpu.adapt import lmpc_trainer as jtr
from dart_tpu.adapt import ppo as jppo
from dart_tpu.control import mpc as jmpc
from dart_tpu_torch.adapt import lmpc_lagplant as tlag
from dart_tpu_torch.adapt import lmpc_trainer as ttr
from dart_tpu_torch.adapt import ppo as tppo
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.utils.convert import (actor_critic_state_dict,
                                          adam_state_dict, from_jax,
                                          to_numpy)

B, N, DT = 3, 4, 0.02
ILQR = dict(max_iters=2, al_iters=1)
HIDDEN = dict(hidden_size=16, hidden_layers=1)
# float64, the same operations in the same order on both sides: one step
# agrees to ~1e-15; the tolerance leaves room for the LMPC model's stiff
# friction (tests/test_torch_closed_loop.py).
ATOL = 1e-9


def _flat(tree, prefix=""):
    for name, x in zip(tree._fields, tree):
        if isinstance(x, tuple):
            yield from _flat(x, f"{prefix}{name}.")
        elif x is not None and name != "rng":
            yield prefix + name, np.asarray(x)


def _close(got, want, atol=ATOL):
    got = dict(_flat(to_numpy(got)))
    for name, w in _flat(want):
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                   err_msg=name)


def _models(cast=False):
    """JAX's policy params (float32, as flax makes them; float64 with
    `cast`) and the port's ActorCritic holding the same values."""
    jm = jppo.ActorCritic(act_dim=jtr.N_PARAMS, **HIDDEN)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros(jtr.OBS_DIM))
    if cast:
        params = jax.tree.map(lambda x: x.astype(jnp.float64), params)
    tm = tppo.ActorCritic(ttr.N_PARAMS, ttr.OBS_DIM, **HIDDEN)
    if cast:
        tm = tm.double()
    tm.load_state_dict(actor_critic_state_dict(jax.device_get(params)))
    return jm, params, tm


def _split4(keys):
    """JAX's `rng, k_a, k_b, k_c = split(rng, 4)` per env."""
    s = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    return s[:, 0], s[:, 1], s[:, 2], s[:, 3]


def _analytic_draws(keys):
    """One env_step's draws from each env's key, as `env_step` makes them.
    Returns (next keys, the port's StepDraws)."""
    keys, k_act, k_tgt, k_par = _split4(keys)
    noise = jax.vmap(lambda k: jax.random.normal(k, (jtr.N_PARAMS,)))(k_act)
    d = ttr.StepDraws(*(torch.from_numpy(np.asarray(x)) for x in (
        noise, jax.vmap(jtr.sample_target)(k_tgt),
        jax.vmap(jtr.sample_true_params)(k_par))))
    return keys, d


def _lag_draws(keys):
    keys, k_act, k_tgt, k_obj = _split4(keys)
    noise = jax.vmap(lambda k: jax.random.normal(k, (jtr.N_PARAMS,)))(k_act)
    obj = jax.vmap(lambda k: jlag.sample_obj_params(k, jnp.float64))(k_obj)
    return keys, ttr.StepDraws(
        torch.from_numpy(np.asarray(noise)),
        torch.from_numpy(np.asarray(jax.vmap(jtr.sample_target)(k_tgt))),
        from_jax(jax.device_get(obj), "cpu"))


def _staggered(states):
    """Envs 1 and 2 one and two steps into their episodes, so with
    max_episode_steps=3 they reset at the second and first step, env 0
    not at all, and only env 0 updates its 34-vector on the first step."""
    return states._replace(episode_step=jnp.asarray([0, 1, 2], jnp.int32))


@functools.lru_cache(maxsize=None)
def _analytic():
    """The analytic-plant env on both sides and JAX's jitted, vmapped
    env_step, compiled once for the two tests that step it."""
    jm, params, tm = _models()
    cfg_j = jtr.EnvConfig(dt=DT, max_episode_steps=3)
    ctlr_j = jmpc.LMPC(N=N, dt=DT, cfg=jmpc.ilqr.ILQRConfig(**ILQR))
    step_j = jax.jit(jax.vmap(
        lambda s: jtr.env_step(params, jm, ctlr_j, s, cfg_j)))
    return dict(
        jm=jm, params=params, tm=tm, step_j=step_j,
        init_j=lambda seed: _staggered(jax.vmap(
            lambda r: jtr.env_init(r, ctlr_j, cfg_j))(
                jax.random.split(jax.random.PRNGKey(seed), B))),
        ctlr_t=tmpc.LMPC(N=N, dt=DT, cfg=tmpc.ilqr.ILQRConfig(**ILQR)),
        cfg_t=ttr.EnvConfig(dt=DT, max_episode_steps=3))


def test_env_step_across_a_reset_matches_jax():
    """Two steps, each from JAX's state: every field of the next state
    (the reset lanes' fresh start with the kept 34-vector and Welford
    statistics included) and of the Transition."""
    a = _analytic()
    s = a["init_j"](1)
    for t in range(2):
        _, draws = _analytic_draws(s.rng)
        s_t, tr_t = ttr.env_step(a["tm"], a["ctlr_t"],
                                 from_jax(jax.device_get(s), "cpu"),
                                 a["cfg_t"], draws)
        s, tr_j = a["step_j"](s)
        _close(tr_t, tr_j)
        _close(s_t, s)
        assert tr_t.done.dtype == torch.float32
        np.testing.assert_array_equal(tr_t.done.numpy(),
                                      [0.0, float(t == 1), float(t == 0)])
    # The reset lanes started afresh, the Welford count kept going.
    assert s_t.episode_step.tolist() == [2, 0, 1]
    assert (s_t.welford.count == 2).all()


def test_collect_rollout_matches_jax():
    """Four free-running steps of three envs from the same start, with
    JAX's draws, against JAX's env_step iterated as `collect_rollout`'s
    scan iterates it and its bootstrap value: the trajectory, the value
    and the final state. Free-running, the stiff friction lets round-off
    grow, so the tolerance is 1e-7 (the step-by-step test holds 1e-9)."""
    a = _analytic()
    T = 4
    s0 = a["init_j"](2)
    sj, trs, draws = s0, [], []
    for _ in range(T):
        _, d = _analytic_draws(sj.rng)
        draws.append(d)
        sj, tr = a["step_j"](sj)
        trs.append(tr)
    traj_j = jtr.Transition(*(np.stack(x, 1) for x in zip(*trs)))
    base = jnp.concatenate([sj.x, sj.target, sj.prev_control, sj.current_k],
                           -1)
    norm = jax.vmap(jppo.welford_normalize)(sj.welford, base)
    hist = jnp.concatenate([sj.history[:, 1:], norm[:, None]], 1)
    _, _, lv_j = a["jm"].apply(a["params"], hist.reshape(B, -1))
    st, traj_t, lv_t = ttr.collect_rollout(
        a["tm"], a["ctlr_t"], from_jax(jax.device_get(s0), "cpu"),
        a["cfg_t"], T, draws)
    assert traj_t.obs.shape == (B, T, ttr.OBS_DIM)
    _close(traj_t, traj_j, atol=1e-7)
    _close(st, sj, atol=1e-7)
    np.testing.assert_allclose(lv_t.numpy(), np.asarray(lv_j), rtol=0,
                               atol=1e-7)
    assert traj_t.done.sum() >= 2          # two envs reset on the way


def test_train_step_with_replay_matches_jax():
    """One whole train step with the replay buffer, from a buffer one take
    short of full, so the local PPO pass, the subsample and the global
    pass all run: the policy's parameters (cast to float64 on both sides:
    flax keeps them in float32, where the global-norm clip's float32 sums
    differ by an ulp between XLA and torch, tests/test_torch_ppo.py), the
    Adam moments, the buffer, the env states and the stats. The
    parameters agree within 1e-9."""
    jm, params, tm = _models(cast=True)
    T = 2
    cfg_j = jtr.EnvConfig(dt=DT, max_episode_steps=3)
    cfg_t = ttr.EnvConfig(dt=DT, max_episode_steps=3)
    ctlr_j = jmpc.LMPC(N=N, dt=DT, cfg=jmpc.ilqr.ILQRConfig(**ILQR))
    ctlr_t = tmpc.LMPC(N=N, dt=DT, cfg=tmpc.ilqr.ILQRConfig(**ILQR))
    pcfg_j = jppo.PPOConfig(epochs=2, minibatch_size=4)
    pcfg_t = tppo.PPOConfig(epochs=2, minibatch_size=4)
    train_j, tx = jtr.make_train_step(jm, ctlr_j, cfg_j, pcfg_j, T,
                                      replay=True)
    ts_j = jtr.TrainState(params, tx.init(params), jax.random.PRNGKey(4))
    s0 = _staggered(jax.vmap(lambda r: jtr.env_init(r, ctlr_j, cfg_j))(
        jax.random.split(jax.random.PRNGKey(3), B)))
    C = B * T
    n_take = tppo.replay_take(C)
    rng = np.random.default_rng(0)
    buf_np = jppo.ReplayBuffer(
        obs=rng.normal(size=(C, jtr.OBS_DIM)),
        actions=rng.normal(size=(C, jtr.N_PARAMS)) * 0.1,
        logps=rng.normal(size=C), rewards=rng.normal(size=C),
        values=rng.normal(size=C),
        dones=(rng.uniform(size=C) < 0.3).astype(np.float64),
        size=np.asarray(C - n_take, np.int32))
    ts_j2, sj, buf_j, stats_j = jax.jit(train_j)(
        ts_j, s0, jax.tree.map(jnp.asarray, buf_np))

    # JAX's draws: the rollout from each env's key, then the train
    # state's split into the local pass, the subsample and the global pass.
    keys, rollout = s0.rng, []
    for _ in range(T):
        keys, d = _analytic_draws(keys)
        rollout.append(d)
    _, k_up, k_sub, k_glob = jax.random.split(ts_j.rng, 4)

    def perms(k, n):
        return torch.from_numpy(np.stack([np.asarray(
            jax.random.permutation(ke, n)) for ke in jax.random.split(
                k, pcfg_j.epochs)]))

    draws = ttr.TrainDraws(
        rollout=rollout, perms=perms(k_up, B * T),
        subsample=torch.from_numpy(np.asarray(jax.random.choice(
            k_sub, B * T, (n_take,), replace=False))),
        replay_perms=perms(k_glob, C))
    opt = tppo.make_optimizer(tm, pcfg_t)
    opt.load_state_dict(adam_state_dict(jax.device_get(ts_j.opt_state), tm,
                                        opt))
    ts_t = ttr.TrainState(tm, opt, None)
    train_t = ttr.make_train_step(ctlr_t, cfg_t, pcfg_t, T, replay=True)
    ts_t2, st, buf_t, stats_t = train_t(
        ts_t, from_jax(jax.device_get(s0), "cpu"),
        from_jax(buf_np, "cpu"), draws)

    assert stats_t["global_update"] == 1.0 == float(stats_j["global_update"])
    want = actor_critic_state_dict(jax.device_get(ts_j2.params))
    got = ts_t2.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=ATOL, err_msg=k)
    moments = adam_state_dict(jax.device_get(ts_j2.opt_state), tm, opt)
    for i, m in moments["state"].items():
        mine = ts_t2.opt.state_dict()["state"][i]
        # two epochs of one minibatch, in the local and the global pass
        assert int(mine["step"]) == int(m["step"]) == 4
        for k in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(mine[k].numpy(), m[k].numpy(),
                                       rtol=0, atol=ATOL)
    _close(buf_t, buf_j)
    assert int(buf_t.size) == 0
    _close(st, sj)
    for k in ("mean_reward", "policy_loss", "value_loss", "entropy"):
        np.testing.assert_allclose(float(stats_t[k]), float(stats_j[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


def test_lag_plant_env_step_matches_jax():
    """The contact-plant trainer's env_step, two steps each from JAX's
    state, across resets that draw new object parameters: the plant gets
    -u, the reward and the next observation u."""
    jm, params, tm = _models()
    cfg_j = jlag.LagEnvConfig(max_episode_steps=3)
    cfg_t = tlag.LagEnvConfig(max_episode_steps=3)
    ctlr_j = jmpc.LMPC(N=N, dt=0.01, cfg=jmpc.ilqr.ILQRConfig(**ILQR))
    ctlr_t = tmpc.LMPC(N=N, dt=0.01, cfg=tmpc.ilqr.ILQRConfig(**ILQR))
    s = _staggered(jax.vmap(lambda r: jlag.env_init(r, ctlr_j, cfg_j))(
        jax.random.split(jax.random.PRNGKey(5), B)))
    step_j = jax.jit(jax.vmap(
        lambda s: jlag.env_step(params, jm, ctlr_j, s, cfg_j)))
    for _ in range(2):
        _, draws = _lag_draws(s.rng)
        s_t, tr_t = tlag.env_step(tm, ctlr_t, from_jax(jax.device_get(s),
                                                       "cpu"), cfg_t, draws)
        s, tr_j = step_j(s)
        _close(tr_t, tr_j)
        _close(s_t, s)
    assert s_t.episode_step.tolist() == [2, 0, 1]
    assert float(torch.abs(s_t.prev_control[0]).sum()) > 0


def test_generator_draws_run_a_train_step():
    """Without supplied draws every draw comes from the TrainState's
    generator: two train steps with the replay buffer on the lag plant
    run, stay finite, move the policy and fill the buffer by a take each
    step; the same seed gives the same step."""
    pcfg = tppo.PPOConfig(epochs=1, minibatch_size=4)

    def run():
        gen = torch.Generator().manual_seed(7)
        ts = ttr.init_train_state(gen, pcfg, "cpu", **HIDDEN)
        ctlr = tmpc.LMPC(N=N, dt=0.01, cfg=tmpc.ilqr.ILQRConfig(**ILQR))
        cfg = tlag.LagEnvConfig()
        s = tlag.env_init(ctlr, cfg, 2, torch.float64, "cpu", gen=gen)
        step = tlag.make_train_step(ctlr, cfg, pcfg, 2, replay=True)
        buf = ttr.init_replay(2, 2, torch.float64, "cpu")
        before = [p.detach().clone() for p in ts.model.parameters()]
        sizes = []
        for _ in range(2):
            ts, s, buf, stats = step(ts, s, buf)
            sizes.append(int(buf.size))
        moved = sum(float((p - q).abs().sum()) for p, q in
                    zip(ts.model.parameters(), before))
        return stats, s, sizes, moved

    stats, s, sizes, moved = run()
    assert sizes == [1, 2] and moved > 0
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert torch.isfinite(s.plant.p).all()
    stats2, s2, _, _ = run()
    assert torch.equal(s.plant.p, s2.plant.p)
    assert stats == stats2

"""Port parity: the full-stack LMPC trainer (`adapt.lmpc_fullstack`)
against `dart_tpu`'s, vmapped over the envs, in float64, at
tests/test_lmpc_fullstack.py's small configuration (N=4, 2 iterations, 2
envs, `substeps=2`, `qp_iters=8`, a one-layer policy 16 wide on the full
520-wide observation); and the port's train step with and without the
replay buffer.

JAX threads a key through every env state; the port draws from a
`torch.Generator` behind arguments a caller can fill. The tests walk JAX's
key chain (the same `split`s in the same order) to make JAX's draws, the
action noise, the reset's target and `sample_obj_params`'s shape, mass and
mu, and hand them to the port. Most of the time is JAX's compile of its
`env_step` (the LMPC solve and the dual-arm world).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dart_tpu.adapt import lmpc_fullstack as jfst
from dart_tpu.adapt import lmpc_trainer as jtr
from dart_tpu.adapt import ppo as jppo
from dart_tpu.control import mpc as jmpc
from dart_tpu.rollout import full_stack as jfs
from dart_tpu_torch.adapt import lmpc_fullstack as tfst
from dart_tpu_torch.adapt import lmpc_trainer as ttr
from dart_tpu_torch.adapt import ppo as tppo
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.rollout import full_stack as tfs
from dart_tpu_torch.utils.convert import (actor_critic_state_dict, from_jax,
                                          to_numpy)

B, N = 2, 4
ILQR = dict(max_iters=2, n_alphas=4)
HIDDEN = dict(hidden_size=16, hidden_layers=1)
ENV = dict(substeps=2, qp_iters=8, max_episode_steps=3)
# float64, the same operations in another order (the world's solves by
# Cholesky where JAX takes LU) over one control period.
ATOL = 1e-9


def _flat(tree, prefix=""):
    for name, x in zip(tree._fields, tree):
        if isinstance(x, tuple):
            yield from _flat(x, f"{prefix}{name}.")
        elif x is not None and name != "rng" and not isinstance(
                x, (bool, int, float)):
            yield prefix + name, np.asarray(x)


def _close(got, want, atol=ATOL):
    got = dict(_flat(to_numpy(got)))
    for name, w in _flat(want):
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol,
                                   err_msg=name)


def _obj_choices(k_obj, shape_probs):
    """`sample_obj_params`'s choices from its key, as it makes them."""
    k1, k2, k3 = jax.random.split(k_obj, 3)
    shape = jax.random.choice(k1, 3, p=jnp.asarray(shape_probs, jnp.float32))
    mass = jax.random.choice(k2, jnp.asarray([1.0, 2.0, 3.0], jnp.float64))
    mu = jax.random.choice(k3, jnp.asarray([0.05, 0.1, 0.2], jnp.float64))
    return shape, mass, mu


def _draws(keys, cfg):
    """One env_step's draws from each env's key, as `env_step` makes them:
    (next keys, the port's StepDraws, JAX's own object params)."""
    s = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
    keys, k_act, k_tgt, k_obj = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    noise = jax.vmap(lambda k: jax.random.normal(k, (jtr.N_PARAMS,)))(k_act)
    shape, mass, mu = jax.vmap(lambda k: _obj_choices(k, cfg.shape_probs))(
        k_obj)
    T = lambda x: torch.from_numpy(np.asarray(x))       # noqa: E731
    plant = tfst.object_params(T(shape), T(mass), T(mu), torch.float64)
    want = jax.vmap(lambda k: jfst.sample_obj_params(
        k, jnp.float64, cfg.shape_probs))(k_obj)
    return keys, ttr.StepDraws(T(noise), T(jax.vmap(jtr.sample_target)(
        k_tgt)), plant), want


@functools.lru_cache(maxsize=None)
def _setup():
    jm = jppo.ActorCritic(act_dim=jtr.N_PARAMS, **HIDDEN)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros(jtr.OBS_DIM))
    tm = tppo.ActorCritic(ttr.N_PARAMS, ttr.OBS_DIM, **HIDDEN)
    tm.load_state_dict(actor_critic_state_dict(jax.device_get(params)))
    # The r5 hold curriculum's shape draw, so every shape can come up.
    cfg_j = jfst.FSEnvConfig(shape_probs=(0.25, 0.25, 0.5), **ENV)
    cfg_t = tfst.FSEnvConfig(shape_probs=(0.25, 0.25, 0.5), **ENV)
    ctlr_j = jmpc.LMPC(N=N, dt=0.01, cfg=jmpc.ilqr.ILQRConfig(**ILQR),
                       fast=True)
    ctlr_t = tmpc.LMPC(N=N, dt=0.01, cfg=tmpc.ilqr.ILQRConfig(**ILQR),
                       fast=True)
    scene = jfs.make_scene(dtype=jnp.float64)
    step_j = jax.jit(jax.vmap(lambda s: jfst.env_step(
        params, jm, ctlr_j, scene, s, cfg_j)))
    return dict(tm=tm, cfg_j=cfg_j, cfg_t=cfg_t, ctlr_j=ctlr_j,
                ctlr_t=ctlr_t, scene_t=from_jax(jax.device_get(scene),
                                                "cpu"), step_j=step_j)


def test_object_params_match_jax_draws():
    """`object_params` of JAX's choices equals `sample_obj_params` of the
    same keys, leaf for leaf, over 24 keys (every shape, mass and mu)."""
    a = _setup()
    keys = jax.random.split(jax.random.PRNGKey(11), 24)
    _, draws, want = _draws(keys, a["cfg_j"])
    _close(draws.plant, jax.device_get(want), atol=0)
    assert set(np.asarray(draws.plant.kappa_inv[:, 0]).tolist()) == {
        0.0, 2.0, 2.5}


def test_env_step_across_a_reset_matches_jax():
    """Two control periods of two envs, each from JAX's state, env 1 at
    its episode's end so it resets (and draws a new scene) at the first:
    every field of the next state (the world, the LMPC carry, the tuned
    34-vector, the Welford statistics, the scene) and of the Transition."""
    a = _setup()
    s = jax.vmap(lambda r: jfst.env_init(r, a["ctlr_j"], a["cfg_j"]))(
        jax.random.split(jax.random.PRNGKey(1), B))
    s = s._replace(episode_step=jnp.asarray([0, 2], jnp.int32))
    for t in range(2):
        _, draws, _ = _draws(s.rng, a["cfg_j"])
        s_t, tr_t = tfst.env_step(a["tm"], a["ctlr_t"], a["scene_t"],
                                  from_jax(jax.device_get(s), "cpu"),
                                  a["cfg_t"], draws)
        s, tr_j = a["step_j"](s)
        _close(tr_t, jax.device_get(tr_j))
        _close(s_t, jax.device_get(s))
        np.testing.assert_array_equal(tr_t.done.numpy(),
                                      [0.0, float(t == 0)])
    assert s_t.episode_step.tolist() == [2, 1]
    assert float(np.abs(s_t.world.qdL.numpy()).max()) > 0


def test_generator_draws_run_train_steps():
    """Without supplied draws every draw comes from the TrainState's
    generator: a train step without the replay buffer and two with it run,
    stay finite, move the policy, keep the arms finite and fill the buffer
    by a take each step; the same seed gives the same step."""
    a = _setup()
    pcfg = tppo.PPOConfig(epochs=1, minibatch_size=4)

    def run(replay):
        gen = torch.Generator().manual_seed(7)
        ts = ttr.init_train_state(gen, pcfg, "cpu", **HIDDEN)
        cfg = tfst.FSEnvConfig(**ENV)
        s = tfst.env_init(a["ctlr_t"], cfg, B, torch.float64, "cpu", gen=gen)
        step = tfst.make_train_step(a["ctlr_t"], a["scene_t"], cfg, pcfg, 2,
                                    replay=replay)
        before = [p.detach().clone() for p in ts.model.parameters()]
        sizes = []
        if replay:
            buf = ttr.init_replay(B, 2, torch.float64, "cpu")
            for _ in range(2):
                ts, s, buf, stats = step(ts, s, buf)
                sizes.append(int(buf.size))
        else:
            ts, s, stats = step(ts, s)
        moved = sum(float((p - q).abs().sum()) for p, q in
                    zip(ts.model.parameters(), before))
        return stats, s, sizes, moved

    stats, s, _, moved = run(False)
    assert moved > 0 and "global_update" not in stats
    assert all(np.isfinite(float(v)) for v in stats.values())
    stats, s, sizes, moved = run(True)
    assert sizes == [1, 2] and moved > 0
    assert all(np.isfinite(float(v)) for v in stats.values())
    assert torch.isfinite(s.world.qL).all() and torch.isfinite(
        s.world.obj.p).all()
    stats2, s2, _, _ = run(True)
    assert torch.equal(s.world.qL, s2.world.qL)
    assert stats == stats2


def test_fresh_world_is_jax_init_full_state():
    """The reset's world: the home keyframe, the object at rest, cold arm
    carries, on every lane."""
    want = jax.device_get(jfs.init_full_state(jnp.float64))
    got = tfs.init_full_state(torch.float64, device="cpu", batch=3)
    for name, w in _flat(want):
        g = dict(_flat(to_numpy(got)))[name]
        np.testing.assert_array_equal(g, np.broadcast_to(w, g.shape),
                                      err_msg=name)

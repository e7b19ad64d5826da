"""Port parity: PPO (`adapt.ppo`), the policy checkpoints (`io.checkpoint`)
and the converted committed tuners, against `dart_tpu`'s in float64.

flax keeps the policy's parameters in float32 (under x64 too) and computes
in float64 on float64 inputs; the port does the same. Where a PPO step
runs, the global-norm clip sums each gradient's squares in float32, in
another order in XLA than in torch: the norm moves by an ulp, and so does
about a third of the parameters after a few Adam steps. The update is
therefore held to JAX's at 1e-9 with the parameters cast to float64 on
both sides, and within two float32 ulps in flax's own float32.

Script mode converts the committed Orbax tuners (`artifacts/lmpc/{general,
lagplant_r5,fullstack_r5}/best_agent/`, restored with the `lmpc`
command's template) to `best_agent.pt` beside each, the files the port
loads:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_ppo.py
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.adapt import lmpc_trainer as jtr
from dart_tpu.adapt import ppo as jppo
from dart_tpu_torch.adapt import lmpc_trainer as ttr
from dart_tpu_torch.adapt import ppo as tppo
from dart_tpu_torch.io import checkpoint as tckpt
from dart_tpu_torch.utils.convert import (actor_critic_state_dict,
                                          adam_state_dict, from_jax,
                                          to_numpy)

REPO = Path(__file__).resolve().parents[1]
TUNERS = ("general", "lagplant_r5", "fullstack_r5")
ATOL = 1e-9
F32_ULP = float(np.finfo(np.float32).eps)   # at 1.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=atol, err_msg=msg)


def test_helpers_match_jax():
    """logp, entropy, Welford (on a lane axis, over 40 updates), GAE (on a
    lane axis, dones float32 as the trainer stores them), the logit-space
    action (both sides of the damping threshold) and the shaped reward,
    float64, at 1e-12."""
    rng = np.random.default_rng(0)
    x, mean = rng.normal(size=(5, 34)), rng.normal(size=(5, 34))
    std = rng.uniform(0.05, 0.5, 34)
    _close(tppo.normal_logp(_t(x), _t(mean), _t(std)),
           jppo.normal_logp(x, mean, std))
    _close(tppo.normal_entropy(_t(std)), jppo.normal_entropy(std))

    xs = rng.normal(size=(40, 3, 6)) * np.array([1, 10, 0.1, 5, 2, 1])
    sj = jax.vmap(lambda _: jppo.welford_init(6, jnp.float64))(jnp.zeros(3))
    st = tppo.welford_init(6, torch.float64, "cpu", (3,))
    for xi in xs:
        sj = jax.vmap(jppo.welford_update)(sj, xi)
        st = tppo.welford_update(st, _t(xi))
    for a, b in zip(st, sj):
        _close(a, b)
    _close(tppo.welford_normalize(st, _t(xs[0])),
           jax.vmap(jppo.welford_normalize)(sj, xs[0]))
    fresh = tppo.welford_update(
        tppo.welford_init(6, torch.float64, "cpu", (3,)), _t(xs[0]))
    _close(tppo.welford_normalize(fresh, _t(xs[1])),
           jax.vmap(jppo.welford_normalize)(
               jax.tree.map(np.asarray, to_numpy(fresh)), xs[1]))

    r, v = rng.normal(size=(3, 20)), rng.normal(size=(3, 20))
    d = (rng.uniform(size=(3, 20)) < 0.2).astype(np.float32)
    lv = rng.normal(size=3)
    _close(tppo.compute_gae(_t(r), _t(v), _t(d), _t(lv)),
           jax.vmap(jppo.compute_gae)(r, v, d, lv))

    cfg = jppo.ParamActionConfig()
    k = rng.uniform(0.05, 1.5, (4, 34))
    raw = rng.normal(size=(4, 34)) * np.array([[0.1], [1.0], [30.0],
                                               [100.0]])
    got = tppo.apply_param_action(_t(k), _t(raw), tppo.ParamActionConfig())
    _close(got, jax.vmap(lambda a, b: jppo.apply_param_action(a, b, cfg))(
        k, raw))

    s8, t8 = rng.normal(size=(6, 8)) * 0.1, rng.normal(size=(6, 8)) * 0.05
    s8[0, 0], s8[1, [0, 2]], t8[1, [0, 2]] = 0.3, 0.0, 0.005
    u, up = rng.normal(size=(6, 2)) * 0.1, rng.normal(size=(6, 2)) * 0.1
    dz, tp = rng.uniform(0, 1, 6), rng.uniform(0, 1e-3, 6)
    contact = np.asarray([1.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    rc = jppo.RewardConfig()
    rj, oj = jax.vmap(lambda *a: jppo.shaped_reward(*a, rc))(
        s8, t8, u, up, dz, tp, contact)
    rt, ot = tppo.shaped_reward(*map(_t, (s8, t8, u, up, dz, tp, contact)),
                                tppo.RewardConfig())
    _close(rt, rj)
    assert ot.tolist() == np.asarray(oj).tolist() and bool(ot[0])


def _policy(hidden=dict(hidden_size=32, hidden_layers=2), cast=False,
            obs_dim=24, act_dim=5):
    jm = jppo.ActorCritic(act_dim=act_dim, **hidden)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros(obs_dim))
    if cast:
        params = jax.tree.map(lambda x: x.astype(jnp.float64), params)
    tm = tppo.ActorCritic(act_dim, obs_dim, **hidden)
    if cast:
        tm = tm.double()
    tm.load_state_dict(actor_critic_state_dict(jax.device_get(params)))
    return jm, params, tm


def test_actor_critic_matches_flax():
    """flax's names and shapes one to one; float32 parameters; the forward
    pass on float64 inputs (std included) in float64 at 1e-12, on float32
    inputs in float32; the init orthogonal with gain sqrt(2), zero biases
    and std_init, from the generator."""
    jm, params, tm = _policy()
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(actor_critic_state_dict(params))
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    obs = np.random.default_rng(2).normal(size=(7, 24))
    for dtype, atol in ((np.float64, 1e-12), (np.float32, 1e-6)):
        mj, sj, vj = jm.apply(params, jnp.asarray(obs, dtype))
        mt, st, vt = tm(_t(obs.astype(dtype)))
        assert mt.dtype == vt.dtype == torch.from_numpy(
            np.zeros(1, dtype)).dtype
        for a, b in ((mt, mj), (st, sj), (vt, vj)):
            _close(a.detach(), b.astype(a.numpy(force=True).dtype), atol)
    g = torch.Generator().manual_seed(0)
    fresh = tppo.ActorCritic(5, 24, hidden_size=32, generator=g)
    w = fresh.actor_0.weight.detach().double()
    np.testing.assert_allclose((w.T @ w).numpy(), 2 * np.eye(24), atol=1e-5)
    assert float(fresh.actor_0.bias.abs().sum()) == 0
    np.testing.assert_allclose(fresh(torch.zeros(24))[1].detach().numpy(),
                               0.1, rtol=1e-6)
    again = tppo.ActorCritic(5, 24, hidden_size=32,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.critic_out.weight, fresh.critic_out.weight)


def _batch(jm, params, T=96, obs_dim=24, act_dim=5, seed=3):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, obs_dim))
    acts = rng.normal(size=(T, act_dim)) * 0.1
    m0, s0, _ = jm.apply(params, jnp.asarray(obs))
    logps = np.asarray(jppo.normal_logp(acts, m0, s0)) \
        + rng.normal(size=T) * 0.05
    return [obs, acts, logps, rng.normal(size=T), rng.normal(size=T)]


def test_ppo_loss_and_gradient_match_jax():
    """The loss and its three parts at 1e-12 in float64 on flax's float32
    parameters; the gradients, taken in float64 and rounded to the
    parameters' float32, within an ulp of JAX's."""
    jm, params, tm = _policy()
    b = _batch(jm, params)
    cfg = jppo.PPOConfig()
    (lj, auxj), gj = jax.value_and_grad(jppo.ppo_loss, has_aux=True)(
        params, jm, jppo.Batch(*map(jnp.asarray, b)), cfg)
    lt, auxt = tppo.ppo_loss(tm, tppo.Batch(*map(_t, b)), tppo.PPOConfig())
    lt.backward()
    _close(lt.detach(), lj)
    for a, c in zip(auxt, auxj):
        _close(a.detach(), c)
    want = actor_critic_state_dict(jax.device_get(gj))
    for n, p in tm.named_parameters():
        assert p.grad.dtype == torch.float32
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   rtol=F32_ULP, atol=1e-12, err_msg=n)


def test_adamw_matches_optax_step():
    """Three steps of the port's AdamW with its clip on given gradients
    (one under the clip norm, two over it) against optax's
    chain(clip_by_global_norm, adamw), in float64 at 1e-15 and in float32
    bit for bit. torch.optim.AdamW decays float32 parameters by a factor
    1 - lr * wd that rounds to 1 at PPO's settings, so it is not used."""
    rng = np.random.default_rng(4)
    cfg = jppo.PPOConfig()
    tx = jppo.make_optimizer(cfg)
    for dtype in (np.float64, np.float32):
        p0 = {"a": rng.normal(size=(6, 4)).astype(dtype),
              "b": rng.normal(size=4).astype(dtype)}
        grads = [{k: (v * s).astype(dtype) for k, v in
                  {"a": rng.normal(size=(6, 4)),
                   "b": rng.normal(size=4)}.items()} for s in (0.01, 1, 3)]
        pj, sj = p0, tx.init(p0)
        pt = [torch.nn.Parameter(_t(p0["a"])), torch.nn.Parameter(
            _t(p0["b"]))]
        opt = tppo.AdamW(pt, lr=cfg.lr, weight_decay=cfg.weight_decay,
                         max_grad_norm=cfg.max_grad_norm)
        for g in grads:
            upd, sj = tx.update(g, sj, pj)
            pj = jax.tree.map(lambda p, u: p + u, pj, upd)
            pt[0].grad, pt[1].grad = _t(g["a"]), _t(g["b"])
            opt.step()
        for p, k in zip(pt, ("a", "b")):
            if dtype == np.float32:
                np.testing.assert_array_equal(p.detach().numpy(),
                                              np.asarray(pj[k]))
            else:
                _close(p.detach(), pj[k], 1e-15)


@pytest.mark.parametrize("cast", [True, False], ids=["float64", "float32"])
def test_ppo_update_matches_jax(cast):
    """One `ppo_update` (2 epochs of 3 minibatches, JAX's permutations
    passed in) from optax's initial state: parameters, Adam moments and
    the mean stats. float64 parameters: 1e-9. flax's float32 parameters:
    within two float32 ulps of each parameter's magnitude (the clip's
    norm, see the module docstring); the stats then move by ~1e-5."""
    jm, params, tm = _policy(cast=cast)
    b = _batch(jm, params)
    cfg = jppo.PPOConfig(epochs=2, minibatch_size=32)
    tx = jppo.make_optimizer(cfg)
    key = jax.random.PRNGKey(9)
    p2, o2, stats = jppo.ppo_update(params, tx.init(params), jm, tx,
                                    jppo.Batch(*map(jnp.asarray, b)), cfg,
                                    key)
    perms = np.stack([np.asarray(jax.random.permutation(k, 96))
                      for k in jax.random.split(key, 2)])
    tcfg = tppo.PPOConfig(epochs=2, minibatch_size=32)
    opt = tppo.make_optimizer(tm, tcfg)
    opt.load_state_dict(adam_state_dict(tx.init(params), tm, opt))
    st = tppo.ppo_update(tm, opt, tppo.Batch(*map(_t, b)), tcfg, _t(perms))
    want = actor_critic_state_dict(jax.device_get(p2))
    moments = adam_state_dict(jax.device_get(o2), tm, opt)["state"]
    for i, (n, p) in enumerate(tm.named_parameters()):
        w = want[n].numpy()
        tol = ATOL if cast else 2 * F32_ULP * np.maximum(np.abs(w), 1.0)
        np.testing.assert_array_less(np.abs(p.detach().numpy() - w),
                                     tol + 1e-30, err_msg=n)
        mine = opt.state_dict()["state"][i]
        assert int(mine["step"]) == int(moments[i]["step"]) == 6
        if cast:
            _close(mine["exp_avg"], moments[i]["exp_avg"], ATOL)
            _close(mine["exp_avg_sq"], moments[i]["exp_avg_sq"], ATOL)
    for a, c in zip(st, stats):
        _close(a, c, ATOL if cast else 1e-4)


def test_replay_fill_and_flush_matches_jax():
    """The dual-buffer semantics (`rlmpc2.py:822-874`) with JAX's subsample
    rows: each add writes a quarter of the rollout at the write position;
    the global pass runs only when the buffer is full (parameters
    untouched before, JAX's after, float64 at 1e-9) and clears it; a
    capacity that is not a multiple of the take is refused."""
    C, T = 16, 16
    rng = np.random.default_rng(5)
    jm, params, tm = _policy(dict(hidden_size=8, hidden_layers=1), cast=True,
                             obs_dim=3, act_dim=2)
    bj = jppo.replay_init(C, 3, 2, jnp.float64)
    bt = tppo.replay_init(C, 3, 2, torch.float64, "cpu")
    cfg = jppo.PPOConfig(epochs=1, minibatch_size=8)
    tcfg = tppo.PPOConfig(epochs=1, minibatch_size=8)
    tx = jppo.make_optimizer(cfg)
    opt = tppo.make_optimizer(tm, tcfg)
    oj = tx.init(params)
    opt.load_state_dict(adam_state_dict(oj, tm, opt))
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    for i in range(4):
        data = [rng.normal(size=(T, 3)), rng.normal(size=(T, 2)),
                *rng.normal(size=(3, T)),
                (rng.uniform(size=T) < 0.2).astype(np.float64)]
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        bj = jppo.replay_add_subsample(bj, *map(jnp.asarray, data), key)
        idx = jax.random.choice(key, T, (4,), replace=False)
        bt = tppo.replay_add_subsample(bt, *map(_t, data), idx=_t(idx))
        for a, c in zip(bt, bj):
            _close(a, c, 0)
        gkey = jax.random.PRNGKey(10 + i)
        params, oj, bj, did_j = jppo.replay_maybe_update(
            params, oj, jm, tx, bj, cfg, gkey)
        perms = _t(np.asarray(jax.random.permutation(
            jax.random.split(gkey, 1)[0], C)))[None]
        bt, did_t = tppo.replay_maybe_update(tm, opt, bt, tcfg, perms)
        assert did_t == bool(did_j) == (i == 3)
        assert int(bt.size) == int(bj.size) == (0 if i == 3 else 4 * (i + 1))
        if i < 3:
            assert all(torch.equal(p, before[n])
                       for n, p in tm.named_parameters())
    want = actor_critic_state_dict(jax.device_get(params))
    for n, p in tm.named_parameters():
        _close(p.detach(), want[n], ATOL, n)
        assert not torch.equal(p, before[n])
    with pytest.raises(ValueError, match="multiple of the per-call take"):
        tppo.replay_add_subsample(tppo.replay_init(10, 3, 2, device="cpu"), *map(
            _t, data), gen=torch.Generator())


def test_from_jax_carries_the_trainer_tuples():
    """The trainers' NamedTuples cross by field name, nested ones too; the
    env states' `rng` key stays behind (the port draws from a generator)
    and integer leaves keep their type."""
    from dart_tpu.control import mpc as jmpc

    rng = np.random.default_rng(6)
    B, T = 3, 4
    wel = jppo.WelfordState(rng.normal(size=(B, 52)),
                            rng.uniform(size=(B, 52)), np.full(B, 5.0))
    env = jtr.LMPCEnvState(
        x=rng.normal(size=(B, 8)),
        ctrl_carry=jmpc.LMPCCarry(
            rng.normal(size=(B, 6, 2)), rng.normal(size=(B, 6, 2)),
            np.ones(B, np.int32), rng.normal(size=(B, 2))),
        current_k=rng.uniform(size=(B, 34)), welford=wel,
        history=rng.normal(size=(B, 10, 52)), prev_control=np.zeros((B, 2)),
        time_penalty=np.zeros(B), episode_step=np.arange(B, dtype=np.int32),
        target=rng.normal(size=(B, 8)), pvec_true=rng.uniform(size=(B, 34)),
        rng=np.zeros((B, 2), np.uint32))
    trees = [wel, env,
             jtr.Transition(*(rng.normal(size=(B, T)) for _ in range(5)),
                            np.zeros((B, T), np.float32)),
             jppo.Batch(*(rng.normal(size=(T,)) for _ in range(5))),
             jppo.replay_init(8, 3, 2, jnp.float64)]
    for jt in trees:
        tt = from_jax(jax.device_get(jt), "cpu")
        assert type(tt).__module__.startswith("dart_tpu_torch.")
        assert set(jt._fields) - set(tt._fields) <= {"rng"}
        back = to_numpy(tt)
        for name in tt._fields:
            a, b = getattr(back, name), getattr(jt, name)
            for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
                np.testing.assert_array_equal(x, np.asarray(y))
                assert x.dtype == np.asarray(y).dtype
    assert "rng" not in from_jax(env, "cpu")._fields


def test_checkpoint_round_trip(tmp_path):
    """best on improvement, latest always, `.pt` files that load with
    weights_only=True into an equal model and optimizer; None when
    absent."""
    gen = torch.Generator().manual_seed(0)
    ts = ttr.init_train_state(gen, tppo.PPOConfig(), "cpu", hidden_size=8,
                              hidden_layers=1)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    assert tckpt.load_agent(str(tmp_path)) is None
    for ep, ret in enumerate((1.0, 3.0, 2.0)):
        with torch.no_grad():
            ts.model.log_std.add_(0.1)
        mgr.on_episode_end(ts.model, ts.opt, ep, ret)
    best = tckpt.load_agent(str(tmp_path), "best_agent")
    latest = tckpt.load_agent(str(tmp_path), "latest_agent")
    assert (best["episode"], best["return"]) == (1, 3.0)
    assert (latest["episode"], latest["return"]) == (2, 2.0)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "best_agent.pt", "latest_agent.pt"]
    for k, v in ts.model.state_dict().items():
        assert torch.equal(latest["model"][k], v)
    assert not torch.equal(best["model"]["log_std"],
                           ts.model.log_std.detach())
    m2 = tppo.ActorCritic(ttr.N_PARAMS, ttr.OBS_DIM, hidden_size=8,
                          hidden_layers=1)
    m2.load_state_dict(latest["model"])
    opt2 = tppo.make_optimizer(m2, tppo.PPOConfig())
    opt2.load_state_dict(latest["optimizer"])


def _orbax_tuner(name: str) -> dict:
    """A committed Orbax tuner, restored with the `lmpc` command's
    template (`dart_tpu/cli/lmpc.py:50-57, 90-94`)."""
    from dart_tpu.io import checkpoint as jckpt

    model = jppo.ActorCritic(act_dim=jtr.N_PARAMS)
    tx = jppo.make_optimizer(jppo.PPOConfig(epochs=4, minibatch_size=64))
    ts = jtr.init_train_state(jax.random.PRNGKey(0), model, tx)
    return jax.device_get(jckpt.load_agent(
        str(REPO / "artifacts" / "lmpc" / name), "best_agent",
        template={"params": ts.params, "opt_state": ts.opt_state,
                  "episode": np.asarray(0), "return": np.asarray(0.0)}))


def _port_tuner(restored: dict):
    """The restored tuner as the port's ActorCritic and AdamW."""
    model = tppo.ActorCritic(ttr.N_PARAMS, ttr.OBS_DIM)
    model.load_state_dict(actor_critic_state_dict(restored["params"]))
    opt = tppo.make_optimizer(model, tppo.PPOConfig())
    opt.load_state_dict(adam_state_dict(restored["opt_state"], model, opt))
    return model, opt


@pytest.mark.parametrize("name", TUNERS)
def test_committed_tuner_equals_orbax_bit_for_bit(name):
    """`artifacts/lmpc/<name>/best_agent.pt`, loaded with weights_only=True,
    holds the Orbax checkpoint beside it bit for bit: the 77,317 float32
    parameters, the Adam moments and count, the episode and the return."""
    restored = _orbax_tuner(name)
    got = tckpt.load_agent(str(REPO / "artifacts" / "lmpc" / name))
    model, opt = _port_tuner(restored)
    assert sum(p.numel() for p in model.parameters()) == 77317
    want = actor_critic_state_dict(restored["params"])
    assert sorted(got["model"]) == sorted(want)
    for k, w in want.items():
        assert got["model"][k].dtype == w.dtype == torch.float32
        assert torch.equal(got["model"][k], w), k
    moments = adam_state_dict(restored["opt_state"], model, opt)
    for i, m in moments["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got["optimizer"]["state"][i][k], m[k]), k
    assert got["episode"] == int(restored["episode"])
    assert got["return"] == float(restored["return"])


def convert_committed_tuners():
    for name in TUNERS:
        restored = _orbax_tuner(name)
        model, opt = _port_tuner(restored)
        tckpt.save_agent(str(REPO / "artifacts" / "lmpc" / name),
                         "best_agent", model, opt, int(restored["episode"]),
                         float(restored["return"]))
        print(f"artifacts/lmpc/{name}/best_agent.pt: episode "
              f"{int(restored['episode'])}, return "
              f"{float(restored['return'])}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    convert_committed_tuners()

"""Port parity: the dual-arm world (`rollout.full_stack`) against
`dart_tpu`'s, on the same numpy inputs, in float64: `full_step` from
JAX's own states, the stale-torque branch (`qp_every=3`) and
`record_joints` of `run_full_stack`, `run_full_stack` with the `pmpc
--full_stack` command's PMPC `solve_fn` past a warm-up, the tray pose
fit and tilt, the observations, the `utils.convert` round trips of the
world's NamedTuples, and the command's JSON and npz log.

JAX's `full_step` is `compute_arm_torques` then `advance_world`
(dart_tpu/rollout/full_stack.py:191-198); the JAX side here jits those two
(vmapped over two lanes, a cube and a sphere) and calls them in a host
loop as `full_step` and `run_full_stack`'s branches call them: jitting
`full_step` or the whole `run_full_stack` as well would double JAX's
compile, most of this file's time.

Free-running, the world is sensitive to round-off: the arms' joint
friction, frictionloss * tanh(qd / 1e-3), is explicit Euler on a stiff
tanh, so a joint at rest chatters and an ulp picks another phase of the
chatter, which grows over the command's 250 warm-up steps at rest (JAX's
own world parts from itself, `test_jax_world_chatters_at_rest`). So the
episode here has a 40-step warm-up, short enough to hold it to 1e-9.

Script mode prints JAX's own `pmpc --full_stack` commands on the CPU at
`chip_smoke.py`'s FULL_STACK_RUNTIME (float32, float64, float64
`--no_tune`) and, for each float64 configuration, how far a 1-ulp change
of one of the 14 initial joint angles moves JAX's own steady-state error
and control effort: the source of `chip_smoke.py`'s JAX_FULL_STACK.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_full_stack.py
"""

import functools
import io
import json
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.control import mpc as jmpc
from dart_tpu.models import dynamics as jdyn
from dart_tpu.physics import tray_object as jto
from dart_tpu.rollout import full_stack as jfs
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.models import dynamics as tdyn
from dart_tpu_torch.rollout import full_stack as tfs
from dart_tpu_torch.utils.convert import from_jax, to_numpy

DT = 0.002
QP_ITERS = 40               # the `pmpc --full_stack` command's
# float64, one world step from the same state: the runs agree to ~1e-13
# (the QP's and the dynamics' solves in another order than JAX's).
ATOL = 1e-9
# Two lanes: the command's default scenario (cube, 1 kg, mu 0.1) and a
# sphere (2 kg, mu 0.2), with their targets.
SCENES = (("cube", 1.0, 0.1, (0.05, -0.04)), ("sphere", 2.0, 0.2,
                                                (-0.03, 0.05)))
F64 = jnp.float64


def _flat(tree, prefix=""):
    for name, x in zip(tree._fields, tree):
        if isinstance(x, tuple):
            yield from _flat(x, f"{prefix}{name}.")
        elif x is not None:
            yield prefix + name, np.asarray(x)


def _close(got, want, atol=ATOL, scaled=False):
    """Every leaf within `atol`; with `scaled`, within `atol` times the
    leaf's largest magnitude (at least 1)."""
    got = dict(_flat(to_numpy(got)))
    for name, w in _flat(jax.device_get(want)):
        tol = atol * max(1.0, float(np.abs(w).max())) if scaled else atol
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol,
                                   err_msg=name)


def _stack(trees):
    return jax.tree.map(lambda *x: jnp.stack(x), *trees)


@functools.lru_cache(maxsize=None)
def _world():
    """JAX's scene and the two lanes' object params, the port's from them
    through `utils.convert`, JAX's vmapped and jitted `compute_arm_torques`
    and `advance_world`."""
    scene = jfs.make_scene(dt=DT, dtype=F64)
    op = _stack([jto.make_params(s, m, mu, dtype=F64)
                 for s, m, mu, _ in SCENES])

    def torques(s, u, p):
        return jfs.compute_arm_torques(scene, s, u, p, QP_ITERS)

    def advance(s, aL, aR, tL, tR, p):
        return jfs.advance_world(scene, s, aL, aR, tL, tR, p, DT)

    return dict(scene=scene, op=op,
                scene_t=from_jax(jax.device_get(scene), "cpu"),
                op_t=from_jax(jax.device_get(op), "cpu"),
                torques=jax.jit(jax.vmap(torques)),
                advance=jax.jit(jax.vmap(advance)),
                observe=jax.jit(jax.vmap(jfs.observe_object)))


def _jax_full_step(w, s, u):
    """JAX's `full_step`: its two calls."""
    aL, aR, tL, tR = w["torques"](s, u, w["op"])
    return w["advance"](s, aL, aR, tL, tR, w["op"])


def _state0():
    return _stack([jfs.init_full_state(F64)] * len(SCENES))


def test_full_step_matches_jax():
    """Four world steps under a held tilt command, each from JAX's own
    state: every leaf of the next state (arms, their QP carries, the
    object), 1e-9."""
    w = _world()
    u = jnp.asarray([[0.1, -0.05], [-0.2, 0.15]], F64)
    s = _state0()
    for _ in range(20):             # off rest: the arms moving
        s = _jax_full_step(w, s, u)
    for _ in range(4):
        got = tfs.full_step(w["scene_t"], from_jax(jax.device_get(s), "cpu"),
                            torch.from_numpy(np.asarray(u)), w["op_t"], DT,
                            qp_iters=QP_ITERS)
        s = _jax_full_step(w, s, u)
        _close(got, s)
    assert float(np.abs(np.asarray(s.qdL)).max()) > 1e-3


def test_qp_every_replays_stale_torques():
    """`run_full_stack(qp_every=3, record_joints=True)` over 8 steps with a
    fixed command against JAX's branches (QPs at every third step, the
    held torques and carries between): the joints every step, the object,
    the tilts and the final state, 1e-9."""
    w = _world()
    u = jnp.asarray([[0.1, -0.05], [-0.2, 0.15]], F64)
    s, n = _state0(), 8
    qLs, qRs, ps = [], [], []
    for k in range(n):
        if k % 3 == 0:
            aL, aR, tL, tR = w["torques"](s, u, w["op"])
            s = s._replace(armL=aL, armR=aR)
        s = w["advance"](s, s.armL, s.armR, tL, tR, w["op"])
        qLs.append(s.qL)
        qRs.append(s.qR)
        ps.append(s.obj.p)
    ut = torch.from_numpy(np.asarray(u))

    def solve_fn(c, obs, t):
        return c, ut, None

    got = tfs.run_full_stack(
        w["scene_t"], solve_fn, None, from_jax(jax.device_get(_state0()),
                                               "cpu"),
        None, w["op_t"], n, dt=DT, qp_iters=QP_ITERS, qp_every=3,
        record_joints=True)
    assert len(got) == 6
    for g, want in zip((got[0], got[3], got[4]), (ps, qLs, qRs)):
        np.testing.assert_allclose(g.numpy(), np.stack(want, 1), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(got[2].numpy(), np.broadcast_to(
        np.asarray(u)[:, None], (2, n, 2)), rtol=0, atol=0)
    _close(got[5], s)


@functools.lru_cache(maxsize=None)
def _pmpc():
    """The command's controller on both lanes: PMPC(N=15, dt, u_bound
    0.6, 10 iterations), per-object weights through the high-friction
    schedule, the model's friction the lane's. JAX's vmapped solve; the
    port's inputs."""
    ctlr = jmpc.PMPC(N=15, dt=DT, u_bound=0.6,
                     cfg=jmpc.ilqr.ILQRConfig(max_iters=10))
    wts = _stack([jax.tree.map(jnp.asarray, jmpc.pmpc_schedule_weights(
        jmpc.PMPC_WEIGHTS[s], mu, s != "sphere")) for s, _, mu, _ in SCENES])
    mus = jnp.asarray([mu for _, _, mu, _ in SCENES], F64)
    t6 = jnp.asarray([[tx, 0, ty, 0, 0.43, 0] for *_, (tx, ty) in SCENES],
                     F64)
    solve = jax.jit(jax.vmap(lambda c, o, t, mu, wt: ctlr.solve(
        c, o, t, jdyn.PMPCParams(mu=mu, dt=DT), wt)))
    tctlr = tmpc.PMPC(N=15, dt=DT, u_bound=0.6,
                      cfg=tmpc.ilqr.ILQRConfig(max_iters=10))
    twts = tmpc.PMPCWeights(*(torch.from_numpy(np.asarray(x)) for x in wts))
    tparams = tdyn.PMPCParams(mu=torch.from_numpy(np.asarray(mus)), dt=DT)
    return dict(ctlr=ctlr, solve=lambda c, o: solve(c, o, t6, mus, wts),
                carry0=_stack([ctlr.init_carry(F64)] * len(SCENES)),
                tctlr=tctlr, t6=torch.from_numpy(np.asarray(t6)),
                tsolve=lambda c, o, t: tctlr.solve(c, o, t, tparams, twts))


def _jax_episode(state0, n: int, warmup: int = 250, every: int = 5):
    """`run_full_stack`'s loop in JAX's calls: (positions, tilts, controls)
    (B, n, 2) each, and the final state."""
    w, p = _world(), _pmpc()
    s, c = state0, p["carry0"]
    u = jnp.zeros((len(SCENES), 2), F64)
    out = []
    for k in range(n):
        if k >= warmup and (k - warmup) % every == 0:
            c, u, _ = p["solve"](c, w["observe"](s, w["op"]))
        ua = u if k >= warmup else jnp.zeros_like(u)
        s = _jax_full_step(w, s, ua)
        out.append((s.obj.p, s.obj.theta, ua))
    return [np.stack([np.asarray(o[i]) for o in out], 1) for i in range(3)], s


# The episode: two solves after a 40-step warm-up, short enough that the
# joints' friction chatter has not grown round-off past 1e-9 (the heavier
# sphere lane's tilt gap reaches 3e-10 by step 49).
EPISODE_STEPS, EPISODE_WARMUP = 50, 40


def test_pmpc_episode_matches_jax():
    """`run_full_stack` with the command's PMPC `solve_fn` (a solve every 5
    steps after the warm-up, QP_ITERS) on both lanes, the port's per-lane
    weights and friction, against JAX's calls: positions, tilts and
    controls every step, 1e-9; the final state 1e-8 of each leaf's scale
    (the QP's accelerations and duals reach ~30 and carry the round-off
    the chatter has grown, 3.6e-9 relative)."""
    w, p = _world(), _pmpc()
    (ps, ths, us), sj = _jax_episode(_state0(), EPISODE_STEPS,
                                     warmup=EPISODE_WARMUP)
    got = tfs.run_full_stack(
        w["scene_t"], p["tsolve"], p["tctlr"].init_carry(2, torch.float64,
                                                         "cpu"),
        from_jax(jax.device_get(_state0()), "cpu"), p["t6"], w["op_t"],
        EPISODE_STEPS, dt=DT, control_every=5, warmup_steps=EPISODE_WARMUP,
        qp_iters=QP_ITERS)
    for g, want in zip(got[:3], (ps, ths, us)):
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=ATOL)
    _close(got[3], sj, atol=1e-8, scaled=True)
    gu = got[2].numpy()
    assert (np.abs(gu) <= 0.6 + 1e-12).all()
    assert np.abs(gu[:, EPISODE_WARMUP:]).max() > 0.05   # the solves acted


def test_jax_world_chatters_at_rest():
    """Why free-running episodes are held loosely past their first steps
    (chip_smoke.py's FS_FREE_TOL, JAX_FULL_STACK's witness): JAX's own
    world at rest, started one ulp away in one joint angle, parts from
    itself by more than 1e-7 rad of tray tilt within the command's 250
    warm-up steps, as the joints' friction chatters."""
    s1 = _state0()
    q = np.asarray(s1.qL).copy()
    q[:, 2] = np.nextafter(q[:, 2], np.inf)
    (_, ths, _), _ = _jax_episode(_state0(), 250)
    (_, ths1, _), _ = _jax_episode(s1._replace(qL=jnp.asarray(q)), 250)
    gap = np.abs(ths1 - ths).max(axis=(0, 2))
    assert gap[:20].max() < 1e-13 and gap.max() > 1e-7, gap[::25]


def test_tray_pose_and_tilt_match_jax():
    """`_tray_pose_from_arms` and `tray_tilt_from_quat` on 16 random EE
    pose pairs near the grasp, `_ee_pose` on random joints."""
    rng = np.random.default_rng(8)
    posL = rng.normal(size=(16, 3)) * 0.05 + [-0.175, 0, 0.4]
    posR = rng.normal(size=(16, 3)) * 0.05 + [0.175, 0, 0.4]
    qu = rng.normal(size=(2, 16, 4))
    qu /= np.linalg.norm(qu, axis=-1, keepdims=True)
    want = jax.vmap(jfs._tray_pose_from_arms)(
        jnp.asarray(posL), jnp.asarray(qu[0]), jnp.asarray(posR),
        jnp.asarray(qu[1]))
    got = tfs._tray_pose_from_arms(*(torch.from_numpy(x) for x in (
        posL, qu[0], posR, qu[1])))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), rtol=0,
                                   atol=1e-13)
    tilt = jax.vmap(jfs.tray_tilt_from_quat)(want[1])
    np.testing.assert_allclose(tfs.tray_tilt_from_quat(got[1]).numpy(),
                               np.asarray(tilt), rtol=0, atol=1e-13)
    w = _world()
    q = np.asarray(jfs.HOME_QL) + rng.uniform(-0.5, 0.5, (4, 7))
    pos, quat, _ = jax.vmap(lambda q: jfs._ee_pose(w["scene"].left, q))(
        jnp.asarray(q))
    tpos, tquat, _ = tfs._ee_pose(w["scene_t"].left, torch.from_numpy(q))
    np.testing.assert_allclose(tpos.numpy(), np.asarray(pos), atol=1e-14)
    np.testing.assert_allclose(tquat.numpy(), np.asarray(quat), atol=1e-14)


@pytest.mark.parametrize("name", ["observe_object", "observe_object_4",
                                  "observe_object_8"])
def test_observations_match_jax(name):
    """The three front-ends' observations on object states drawn from a
    seed (tilted tray, moving object)."""
    rng = np.random.default_rng(9)
    w = _world()
    s = jax.device_get(_state0())
    obj = s.obj._replace(**{f: jnp.asarray(rng.normal(size=(2, 2)) * sc)
                            for f, sc in (("theta", 0.2), ("theta_dot", 1.0),
                                          ("p", 0.05), ("v", 0.1))})
    s = s._replace(obj=obj)
    want = jax.vmap(getattr(jfs, name))(s, w["op"])
    got = getattr(tfs, name)(from_jax(s, "cpu"), w["op_t"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-15)


def test_convert_round_trips_the_world():
    """JAX's scene, world state, arm gains and carries, the
    operational-space params and carry cross into the port's NamedTuples
    of the same names and back unchanged; python scalars stay python."""
    from dart_tpu.control import arm as jarm
    from dart_tpu.control import opspace as jops

    w = _world()
    s = jax.device_get(_state0())
    ops = jops.OpspaceParams(K=jnp.ones(6), K_null=jnp.ones(7),
                             q0=jnp.zeros(7), taumin=-jnp.ones(7),
                             taumax=jnp.ones(7), gravity_compensation=False)
    trees = (w["scene"], s, jarm.default_arm_params(dtype=F64),
             jarm.arm_init_carry(F64), ops, jops.opspace_init(F64))
    for tree in trees:
        tree = jax.device_get(tree)
        got = from_jax(tree, "cpu")
        assert type(got).__name__ == type(tree).__name__
        assert type(got).__module__.startswith("dart_tpu_torch")
        back = dict(_flat(to_numpy(got)))
        for name, x in _flat(tree):
            np.testing.assert_array_equal(back[name], x, err_msg=name)
    got = from_jax(jax.device_get(ops), "cpu")
    assert got.gravity_compensation is False and got.damping_ratio == 1.0
    assert from_jax(jax.device_get(w["scene"]), "cpu").arm_params.dt == DT


def test_full_stack_command_writes_its_log(capsys, tmp_path, monkeypatch):
    """`pmpc --full_stack --cpu --f64 --no_tune --log_dir` for 50 world
    steps (inside the warm-up: the solves are `test_pmpc_episode_
    matches_jax`'s), one episode (`timed_call` without its 3 timed
    repeats): JAX's keys, and the npz log, whose 17-channel schema and
    metrics JAX's `EpisodeLog` reproduces from the same t, X and U_cmd."""
    from dart_tpu.io.logging import EpisodeLog
    from dart_tpu_torch.cli import pmpc as tcli_pmpc
    from dart_tpu_torch.utils import timing

    monkeypatch.setattr(timing, "timed_call",
                        lambda fn, *a: (fn(*a), 0.0, 0.0))
    assert tcli_pmpc.main(["--full_stack", "--cpu", "--runtime", "0.1",
                           "--f64", "--no_tune", "--log_dir",
                           str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"steady_state_error", "convergence_time",
                        "control_effort", "converged", "compile_s", "run_s",
                        "sim_steps", "log_path"}
    assert out["sim_steps"] == 50 and out["control_effort"] == 0
    assert out["log_path"].startswith(str(tmp_path / "cube" /
                                          "mass=1.0_friction=0.1"))
    log = np.load(out["log_path"])
    assert log["X"].shape == (50, 6) and log["U_cmd"].shape == (50, 2)
    want = EpisodeLog()
    want.log_arrays(t=log["t"], X=log["X"], U_cmd=log["U_cmd"])
    for k, v in want.compute_metrics((0.05, -0.04), 0.01).items():
        assert float(log[k]) == v, k
    assert float(log["steady_state_error"]) == out["steady_state_error"]


FULL_STACK_CONFIGS = (("float32", []), ("float64", ["--f64"]),
                      ("float64_no_tune", ["--f64", "--no_tune"]))


def _jax_commands() -> dict:
    """JAX's own `pmpc --full_stack` on the CPU at chip_smoke.py's
    FULL_STACK_RUNTIME, and for the float64 configurations the largest
    change of its error and effort (and the median) under a 1-ulp change
    of each initial joint angle."""
    import chip_smoke
    from dart_tpu.cli import pmpc as jp

    R = chip_smoke.FULL_STACK_RUNTIME
    out = {}
    for name, extra in FULL_STACK_CONFIGS:
        buf = io.StringIO()
        with redirect_stdout(buf):
            jp.main(["--full_stack", "--cpu", "--runtime", str(R), *extra])
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        out[name] = {k: res[k] for k in ("converged", "steady_state_error",
                                         "control_effort")}
        if name.startswith("float64"):
            out[name]["witness"] = _witness("--no_tune" in extra, R)
    return out


def _witness(no_tune: bool, runtime: float) -> dict:
    """How far JAX's own command moves under a 1-ulp change of one of the
    14 initial joint angles (each in turn): the largest and the median
    change of the steady-state error (m) and of the control effort
    (relative), float64, the command's loop jitted once."""
    ctlr = jmpc.PMPC(N=15, dt=DT, u_bound=0.6,
                     cfg=jmpc.ilqr.ILQRConfig(max_iters=10))
    wts = jax.tree.map(jnp.asarray, jmpc.pmpc_schedule_weights(
        jmpc.PMPC_WEIGHTS["general" if no_tune else "cube"], 0.1, True))
    params = jdyn.PMPCParams(mu=0.1, dt=DT)
    scene = jfs.make_scene(dt=DT, dtype=F64)
    op = jto.make_params("cube", 1.0, 0.1, dtype=F64)
    t6 = jnp.asarray([0.05, 0, -0.04, 0, 0.43, 0], F64)
    n = int(runtime / DT)

    @jax.jit
    def run(s0):
        ps, _, us, _ = jfs.run_full_stack(
            scene, lambda c, o, t: ctlr.solve(c, o, t, params, wts),
            ctlr.init_carry(F64), s0, t6, op, n_steps=n, dt=DT,
            control_every=5, warmup_steps=250, qp_iters=QP_ITERS)
        return ps, us

    def metrics(s0):
        ps, us = (np.asarray(x) for x in run(s0))
        return (np.linalg.norm(ps[-1] - [0.05, -0.04]),
                np.sum(np.linalg.norm(us, axis=1)) * DT)

    s0 = jfs.init_full_state(F64)
    e0, f0 = metrics(s0)
    de, df = [], []
    for side in ("qL", "qR"):
        for j in range(7):
            q = np.asarray(getattr(s0, side)).copy()
            q[j] = np.nextafter(q[j], np.inf)
            e, f = metrics(s0._replace(**{side: jnp.asarray(q)}))
            de.append(abs(e - e0))
            df.append(abs(f / f0 - 1))
    return {"sse_max": float(max(de)), "sse_median": float(np.median(de)),
            "effort_rel_max": float(max(df)),
            "effort_rel_median": float(np.median(df))}


if __name__ == "__main__":
    sys.path.insert(0, ".")
    print(json.dumps(_jax_commands(), indent=1))

"""Port parity: the tray-object contact plant
(`dart_tpu_torch.physics.tray_object`) against `dart_tpu.physics.
tray_object`.

The same numpy inputs go through both: the JAX functions vmapped over
lanes, the port's on a leading lane axis. Lanes cover the three shapes,
calibrated and legacy params at masses 1, 1.5 and 2 kg, and objects at
rest, about to start rocking, rocking, and past the critical tilt.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.physics import tray_object as jto
from dart_tpu.rollout import evaluate as jev
from dart_tpu_torch.physics import tray_object as tto
from dart_tpu_torch.utils.convert import to_numpy

DT = 0.002
NPZ = (Path(__file__).resolve().parents[1] / "artifacts" / "mujoco"
       / "tray_object_calibration.npz")
# One call in float64: the two differ by the exp/tanh/sin/atan2 libraries
# and XLA's fusion, a few ulps of values below 10.
ATOL_CALL = 1e-12
# One `step` in float64 from the same state: theta_dot is a backward
# difference over dt, 500x an ulp of theta.
ATOL_STEP = 1e-11
# Free-running trajectories. The friction update is explicit Euler on a
# stiff tanh: near zero slip it multiplies a slip difference by up to
# |1 - dt mu gn (1 + kappa_inv) / slip_eps| ~ 4 per step, so a sticking
# contact chatters and an ulp picks another phase of the chatter. The
# velocities are then held to twice its amplitude dt mu gn (1 + kappa_inv)
# (mu <= 0.2, kappa_inv <= 2.5), the positions, which integrate the chatter
# over its two-step period, to 0.1 mm, and everything the chatter does not
# reach (tilt, lag, rocking) as tightly as a dtype's rounding allows.
CHATTER = DT * 0.2 * 9.81 * (1.0 + 2.5)
FREE_TOL = {
    np.float64: dict(other=1e-9, p=1e-4, v=2 * CHATTER, v_roll=2 * CHATTER),
    # float32: 1.2e-7 relative per rounding; theta_dot is an ulp of theta
    # (6e-8 at 0.6 rad) over dt, 3e-5 per ulp.
    np.float32: dict(other=1e-5, theta_dot=1e-3, w_rock=1e-4, p=1e-4,
                     v=2 * CHATTER, v_roll=2 * CHATTER),
}


def _lanes():
    """18 scenario rows: 3 shapes x masses (1, 1.5, 2) x {calibrated,
    legacy}; mu drawn from a seed."""
    rng = np.random.default_rng(0)
    kap, mass = [], []
    for shape in jto.SHAPES:
        for m in (1.0, 1.5, 2.0):
            kap.append(jto._KAPPA_INV[shape])
            mass.append(m)
    kap, mass = np.asarray(kap), np.asarray(mass)
    mu = rng.uniform(0.05, 0.2, len(mass))
    return kap, mass, mu


def _params(dtype_np, lag):
    """(JAX params, port params) for the 9 rows under one lag; the JAX
    side is `_tray_params` vmapped, the port's `scenario_params`.
    Half of the rolling lanes get a breakaway cone (roll_stick 0.3) so the
    stiction branch runs."""
    kap, mass, mu = _lanes()
    jd = jnp.float64 if dtype_np == np.float64 else jnp.float32
    td = torch.float64 if dtype_np == np.float64 else torch.float32
    jp = jax.vmap(lambda k, m, f: jev._tray_params(k, m, f, jd, lag))(
        jnp.asarray(kap, jd), jnp.asarray(mass, jd), jnp.asarray(mu, jd))
    tp = tto.scenario_params(torch.tensor(kap, dtype=td),
                             torch.tensor(mass, dtype=td),
                             torch.tensor(mu, dtype=td), td, lag)
    stick = np.where((kap > 0) & (np.arange(len(mass))[:, None] % 2 == 0),
                     0.3, 0.0).astype(dtype_np)
    jp = jp._replace(roll_stick=jnp.asarray(stick))
    tp = tp._replace(roll_stick=torch.from_numpy(stick))
    return jp, tp


def _both_params(dtype_np=np.float64):
    """Calibrated and legacy rows side by side: 18 lanes."""
    jc, tc = _params(dtype_np, None)
    jl, tl = _params(dtype_np, jto.LEGACY_TRAY_LAG)

    def cat_j(a, b):
        a, b = jnp.asarray(a), jnp.asarray(b)
        if a.ndim != b.ndim:   # legacy per-lane lag against per-axis pairs
            b = jnp.broadcast_to(b[:, None], a.shape)
        return jnp.concatenate([a, b])

    jp = jax.tree.map(cat_j, jc, jl)
    tp = type(tc)(*(torch.cat([a, b]) for a, b in zip(tc, tl)))
    return jp, tp


def _state(B, dtype_np, seed=1):
    """A state per lane by category (lane % 4): 0 at rest, 1 tilted past
    the lift-off angle with the object flat, 2 rocking, 3 past the critical
    rocking angle; lanes 5 and 11 start toppled."""
    rng = np.random.default_rng(seed)
    cat = np.arange(B) % 4
    theta = rng.uniform(-0.3, 0.3, (B, 2))
    theta[cat == 1] = rng.choice([-0.9, 0.9], (np.sum(cat == 1), 2))
    q = np.where(cat[:, None] == 2, rng.uniform(-0.3, 0.3, (B, 2)), 0.0)
    q[cat == 3] = rng.choice([-0.8, 0.8], (np.sum(cat == 3), 2))
    w = np.where(cat[:, None] >= 2, rng.uniform(-2, 2, (B, 2)), 0.0)
    st = dict(theta=theta, theta_dot=rng.uniform(-1, 1, (B, 2)),
              p=rng.uniform(-0.1, 0.1, (B, 2)), v=rng.uniform(-0.2, 0.2,
                                                               (B, 2)),
              v_roll=rng.uniform(-0.2, 0.2, (B, 2)), q_rock=q, w_rock=w,
              lag_x1=rng.uniform(-0.2, 0.2, (B, 2)),
              lag_x2=rng.uniform(-0.2, 0.2, (B, 2)),
              lag_b=rng.uniform(-0.2, 0.2, (B, 2)))
    rest = cat == 0
    for k in st:
        if k != "p":
            st[k][rest] = 0.0
    st = {k: v.astype(dtype_np) for k, v in st.items()}
    toppled = np.zeros(B, bool)
    toppled[[5, 11]] = True
    js = jto.TrayObjectState(**{k: jnp.asarray(v) for k, v in st.items()},
                             toppled=jnp.asarray(toppled))
    ts = tto.TrayObjectState(**{k: torch.from_numpy(v.copy())
                                for k, v in st.items()},
                             toppled=torch.from_numpy(toppled.copy()))
    return js, ts


def _close(j, t, atol):
    t = t.numpy() if isinstance(t, torch.Tensor) else t
    np.testing.assert_allclose(t, np.asarray(j), rtol=0, atol=atol)


def _assert_state(js, ts, atol):
    """`atol`: one tolerance, or a dict by field with a default `other`."""
    for name, a, b in zip(jto.TrayObjectState._fields, js, ts):
        if name == "toppled":
            assert b.dtype == torch.bool
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        else:
            tol = atol.get(name, atol["other"]) if isinstance(atol, dict) \
                else atol
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=tol, err_msg=name)


def test_params_and_calibration_helpers():
    for shape in jto.SHAPES:
        for mass in (1.0, 1.5, 2.0):
            for cal in (False, True):
                jp = jto.make_params(shape, mass, 0.12, dtype=jnp.float64,
                                     calibrated=cal)
                tp = tto.make_params(shape, mass, 0.12, dtype=torch.float64,
                                     calibrated=cal, device="cpu")
                for name, a, b in zip(jto.TrayObjectParams._fields, jp, tp):
                    assert b.dtype == torch.float64, name
                    # The port stores per-axis leaves as pairs.
                    want = np.broadcast_to(np.asarray(a), b.shape)
                    _close(want, b, ATOL_CALL)
    masses = np.asarray([0.5, 1.0, 1.25, 1.5, 2.0, 3.0])
    for a, b in zip(jto.calibrated_lag(jnp.asarray(masses), jnp.float64),
                    tto.calibrated_lag(torch.tensor(masses), torch.float64)):
        assert b.shape == (len(masses), 2)
        _close(a, b, ATOL_CALL)
    mus = np.asarray([0.01, 0.05, 0.1, 0.15, 0.2, 0.3])
    _close(jto.calibrated_slide_damp(2.736, jnp.asarray(mus), jnp.float64),
           tto.calibrated_slide_damp(2.736, torch.tensor(mus),
                                     torch.float64), ATOL_CALL)
    kap, _, mu = _lanes()
    _close(jax.vmap(lambda k, m: jto.calibrated_roll_stick(
        k, m, jnp.float64))(jnp.asarray(kap), jnp.asarray(mu)),
        tto.calibrated_roll_stick(torch.tensor(kap), torch.tensor(mu),
                                  torch.float64), ATOL_CALL)
    np.testing.assert_array_equal(
        tto.topple_on_from_kappa(torch.tensor(kap)).numpy(),
        np.asarray(jto.topple_on_from_kappa(jnp.asarray(kap))))


def test_single_calls_match():
    """tray_gravity, lag_step, step_object, observe_world, off_tray and
    contact_lost, one call each on every kind of lane."""
    jp, tp = _both_params()
    B = tp.mass.shape[0]
    js, ts = _state(B, np.float64)
    rng = np.random.default_rng(2)
    theta = rng.uniform(-0.95, 0.95, (B, 2))
    theta_dot = rng.uniform(-2, 2, (B, 2))
    u = rng.uniform(-0.6, 0.6, (B, 2))

    gt_j, gn_j = jto.tray_gravity(jnp.asarray(theta))
    gt_t, gn_t = tto.tray_gravity(torch.tensor(theta))
    _close(gt_j, gt_t, ATOL_CALL)
    _close(gn_j, gn_t, ATOL_CALL)

    lag_j = jax.vmap(lambda x1, x2, uu, w, z, f: jto.lag_step(
        x1, x2, uu, w, z, DT, f))(js.lag_x1, js.lag_x2, jnp.asarray(u),
                                  jp.omega_n, jp.zeta, jp.lag_fast)
    lag_t = tto.lag_step(ts.lag_x1, ts.lag_x2, torch.tensor(u), tp.omega_n,
                         tp.zeta, DT, tp.lag_fast)
    for a, b in zip(lag_j, lag_t):
        _close(a, b, ATOL_CALL)

    so_j = jax.vmap(jto.step_object, in_axes=(0, 0, 0, 0, None))(
        js, jnp.asarray(theta), jnp.asarray(theta_dot), jp, DT)
    so_t = tto.step_object(ts, torch.tensor(theta), torch.tensor(theta_dot),
                           tp, DT)
    _assert_state(so_j, so_t, ATOL_CALL)
    # Every kind of lane occurs: resting rolling lanes stick, rocking lanes
    # land or keep rocking, lanes past the edge topple.
    top = so_t.toppled.numpy()
    assert top.any() and not top.all()
    assert (so_t.q_rock.numpy() != 0).any()

    pos_j, vel_j = jax.vmap(jto.observe_world)(so_j, jp)
    pos_t, vel_t = tto.observe_world(so_t, tp)
    _close(pos_j, pos_t, ATOL_CALL)
    _close(vel_j, vel_t, ATOL_CALL)

    # Positions straddling the tray limits.
    p = np.asarray([[0.19, 0.0], [0.21, 0.0], [-0.21, 0.0], [0.0, 0.149],
                    [0.0, -0.151], [0.25, 0.2]] * 3)
    ts2 = ts._replace(p=torch.tensor(p))
    js2 = js._replace(p=jnp.asarray(p))
    for jf, tf in ((jto.off_tray, tto.off_tray),
                   (jto.contact_lost, tto.contact_lost)):
        np.testing.assert_array_equal(tf(ts2).numpy(),
                                      np.asarray(jax.vmap(jf)(js2)))


def _run_steps(jp, tp, js, ts, U):
    """Both plants free-running under U (T, B, 2); on the way, the port's
    step from JAX's state each step. Returns (JAX state, port state, the
    largest one-step difference by field)."""
    step_j = jax.jit(jax.vmap(jto.step, in_axes=(0, 0, 0, None)),
                     static_argnums=3)
    one = dict.fromkeys(jto.TrayObjectState._fields, 0.0)
    for k in range(U.shape[0]):
        u = torch.from_numpy(U[k].copy())
        js_prev = tto.TrayObjectState(*(torch.from_numpy(np.array(x))
                                        for x in js))
        js = step_j(js, jnp.asarray(U[k]), jp, DT)
        ts = tto.step(ts, u, tp, DT)
        for name, a, b in zip(one, js, tto.step(js_prev, u, tp, DT)):
            diff = np.abs(np.asarray(a, np.float64)
                          - b.numpy().astype(np.float64))
            one[name] = max(one[name], float(diff.max()))
    return js, ts, one


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_step_200_random_commands(dtype):
    """200 steps under random commands within +-0.6 rad on every kind of
    lane: step by step from the same state (float64 to ATOL_STEP), and
    free-running to FREE_TOL."""
    jp, tp = _both_params(dtype)
    B = tp.mass.shape[0]
    js, ts = _state(B, dtype)
    U = np.random.default_rng(3).uniform(-0.6, 0.6, (200, B, 2)).astype(
        dtype)
    js, ts, one = _run_steps(jp, tp, js, ts, U)
    assert ts.p.dtype == torch.from_numpy(U).dtype
    if dtype == np.float64:
        assert max(one.values()) <= ATOL_STEP, one
    _assert_state(js, ts, FREE_TOL[dtype])
    assert ts.toppled.numpy().any()


def test_replay_recorded_mujoco_commands():
    """The four recorded 10 s closed-loop command traces of the MuJoCo
    calibration (one lane each, calibrated params at 1 kg) through both
    plants from rest."""
    d = np.load(NPZ)
    keys = [("cl_cylinder_0.1", "cylinder", 0.1),
            ("cl_sphere_0.05", "sphere", 0.05),
            ("cl_sphere_0.1", "sphere", 0.1), ("cl_cube_0.05", "cube", 0.05)]
    U = np.stack([d[f"{k}_u"] for k, _, _ in keys], 1)     # (5000, 4, 2)
    jps = [jto.make_params(s, 1.0, mu, dtype=jnp.float64, calibrated=True)
           for _, s, mu in keys]
    jp = jax.tree.map(lambda *x: jnp.stack(x), *jps)
    tps = [tto.make_params(s, 1.0, mu, dtype=torch.float64, calibrated=True,
                           device="cpu") for _, s, mu in keys]
    tp = type(tps[0])(*(torch.stack(x) for x in zip(*tps)))

    def run(u):
        def f(s, uu):
            s = jax.vmap(jto.step, in_axes=(0, 0, 0, None))(s, uu, jp, DT)
            return s, s.p

        s0 = jax.vmap(lambda _: jto.init_state(dtype=jnp.float64))(
            jnp.zeros(len(keys)))
        return jax.lax.scan(f, s0, u)

    js, ps_j = jax.jit(run)(jnp.asarray(U))
    ts = tto.init_state(dtype=torch.float64, device="cpu", batch=len(keys))
    ps_t = np.empty_like(U)
    Ut = torch.from_numpy(U)
    for k in range(U.shape[0]):
        ts = tto.step(ts, Ut[k], tp, DT)
        ps_t[k] = ts.p.numpy()
    # Recorded closed-loop commands keep the contacts out of the chatter
    # (the runs agree to ~1e-15), so the whole replay holds to ATOL_STEP.
    np.testing.assert_allclose(ps_t, np.asarray(ps_j), rtol=0,
                               atol=ATOL_STEP)
    _assert_state(js, ts, ATOL_STEP)
    assert to_numpy(ts).toppled.dtype == np.bool_

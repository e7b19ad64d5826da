"""Port parity: the arm stack's controller layer against `dart_tpu`'s, on
the same numpy inputs made from a seed, in float64: the ADMM QP
(`ops.qp.solve_qp_admm`) on tests/test_arm.py's random QPs and its
active-bound case, DACTL (`control.dualarm.resolve_ee_targets`), the
impedance controller (`control.arm.compute_torque`) at the home pose and
at random poses of both chains with warm carries, and the closed-form
operational-space law (`control.opspace.opspace_torque`). JAX's functions
run vmapped over the lanes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.control import arm as jarm
from dart_tpu.control import dualarm as jdual
from dart_tpu.control import opspace as jops
from dart_tpu.ops import qp as jqp
from dart_tpu.rollout import full_stack as jfs
from dart_tpu_torch.control import arm as tarm
from dart_tpu_torch.control import dualarm as tdual
from dart_tpu_torch.control import opspace as tops
from dart_tpu_torch.ops import qp as tqp
from dart_tpu_torch.utils.convert import from_jax, to_numpy

# float64: the QP's factorisation and the controller's inverses in another
# order than JAX's (Cholesky against LU), carried through 40-400 ADMM
# iterations; torques are O(10) N m.
ATOL = 1e-9
QP_ITERS = 40        # the `pmpc --full_stack` command's


def _random_qp(seed):
    """tests/test_arm.py::test_admm_qp_matches_scipy's QP of this seed."""
    rng = np.random.default_rng(seed)
    n, m = 7, 21
    L = rng.normal(size=(n, n))
    P = L @ L.T + np.eye(n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    center = A @ rng.normal(size=n) * 0.1
    width = rng.uniform(0.5, 2.0, size=m)
    return P, q, A, center - width, center + width


def _close(got, want, atol=ATOL):
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=atol, err_msg=name)


def test_admm_qp_matches_jax():
    """The three random QPs of tests/test_arm.py (seeds 0-2) as three lanes
    of one call, cold and then warm-started from a 40-iteration solve, at
    400 iterations: x, y, z and both residuals."""
    qps = [_random_qp(s) for s in range(3)]
    P, q, A, l, u = (np.stack(x) for x in zip(*qps))
    solve = jax.jit(jax.vmap(functools.partial(jqp.solve_qp_admm,
                                               iters=400)))
    want = solve(*(jnp.asarray(x) for x in (P, q, A, l, u)))
    got = tqp.solve_qp_admm(*(torch.from_numpy(x) for x in (P, q, A, l, u)),
                            iters=400)
    _close(to_numpy(got), want)
    assert float(got.pri_res.max()) < 1e-6
    warm = jax.vmap(functools.partial(jqp.solve_qp_admm, iters=40))(
        *(jnp.asarray(x) for x in (P, q, A, l, u)))
    want = jax.jit(jax.vmap(functools.partial(
        jqp.solve_qp_admm, iters=QP_ITERS)))(
        *(jnp.asarray(x) for x in (P, q, A, l, u)), warm.x, warm.y)
    got = tqp.solve_qp_admm(*(torch.from_numpy(x) for x in (P, q, A, l, u)),
                            torch.from_numpy(np.asarray(warm.x)),
                            torch.from_numpy(np.asarray(warm.y)),
                            iters=QP_ITERS)
    _close(to_numpy(got), want)


def test_admm_qp_active_bounds_match_jax():
    """tests/test_arm.py's box case: the unconstrained optimum far outside
    the box lands on its faces, as JAX's does."""
    P = np.eye(3) * 2.0
    q = np.asarray([-10.0, 0.0, 10.0])
    A, l, u = np.eye(3), -np.ones(3), np.ones(3)
    want = jqp.solve_qp_admm(*(jnp.asarray(x) for x in (P, q, A, l, u)),
                             iters=200)
    got = tqp.solve_qp_admm(*(torch.from_numpy(x) for x in (P, q, A, l, u)),
                            iters=200)
    _close(to_numpy(got), want)
    np.testing.assert_allclose(got.x.numpy(), [1.0, 0.0, -1.0], atol=1e-6)


def test_cho_solve_matches_the_inverse():
    """`spd_solve`/`spd_inv` (the port's Cholesky route where JAX takes LU)
    on SPD matrices, against numpy's LU solve: 1e-12 relative."""
    rng = np.random.default_rng(4)
    L = rng.normal(size=(6, 7, 7))
    M = L @ L.transpose(0, 2, 1) + 0.1 * np.eye(7)
    b = rng.normal(size=(6, 7, 2))
    got = tqp.spd_solve(torch.from_numpy(M), torch.from_numpy(b)).numpy()
    want = np.linalg.solve(M, b)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    inv = tqp.spd_inv(torch.from_numpy(M)).numpy()
    assert np.abs(inv - np.linalg.inv(M)).max() <= \
        1e-12 * np.abs(np.linalg.inv(M)).max()


def test_resolve_ee_targets_matches_jax():
    """DACTL on 16 random tray poses: both EE targets."""
    rng = np.random.default_rng(3)
    pos = rng.normal(size=(16, 3))
    quat = rng.normal(size=(16, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    want = jax.vmap(jdual.resolve_ee_targets)(jnp.asarray(pos),
                                             jnp.asarray(quat))
    got = tdual.resolve_ee_targets(torch.from_numpy(pos),
                                   torch.from_numpy(quat))
    for w, g in zip(want, got):
        _close(to_numpy(g), w, atol=1e-14)


@functools.lru_cache(maxsize=None)
def _snapshots():
    """Dynamics snapshots of both scene chains (JAX's `_arm_dynamics`) at
    the home pose and at 3 random poses near it with random velocities,
    targets near each EE, and warm carries from one JAX control step:
    (JAX inputs, the same for the port), every leaf (2, 4, ...)."""
    scene = jfs.make_scene(dtype=jnp.float64)
    rng = np.random.default_rng(5)
    home = np.asarray([jfs.HOME_QL, jfs.HOME_QR])
    q = home[:, None] + rng.uniform(-0.4, 0.4, (2, 4, 7))
    q[:, 0] = home
    qd = rng.normal(size=(2, 4, 7)) * 0.3
    qd[:, 0] = 0.0

    def snap(params, q, qd):
        pos, quat, _ = jfs._ee_pose(params, q)
        return jfs._arm_dynamics(params, q, qd, pos, quat)

    chains = jax.tree.map(lambda *x: jnp.stack(x), scene.left, scene.right)
    dyn = jax.jit(jax.vmap(jax.vmap(snap, in_axes=(None, 0, 0))))(
        chains, jnp.asarray(q), jnp.asarray(qd))
    tpos = np.asarray(dyn.ee_pos) + rng.normal(size=(2, 4, 3)) * 0.02
    tquat = np.asarray(dyn.ee_quat) + rng.normal(size=(2, 4, 4)) * 0.05
    tquat /= np.linalg.norm(tquat, axis=-1, keepdims=True)
    params = jarm.default_arm_params(dtype=jnp.float64)
    cold = jax.tree.map(lambda x: jnp.broadcast_to(x, (2, 4) + x.shape),
                        jarm.arm_init_carry(jnp.float64))
    step = jax.jit(jax.vmap(jax.vmap(lambda c, d, p, r: jarm.compute_torque(
        c, d, p, r, params, qp_iters=QP_ITERS))))
    warm, _, _ = step(cold, dyn, jnp.asarray(tpos), jnp.asarray(tquat))
    return dict(dyn=dyn, tpos=tpos, tquat=tquat, params=params, cold=cold,
                warm=warm, step=step)


@pytest.mark.parametrize("carry", ["cold", "warm", "pinv"])
def test_compute_torque_matches_jax(carry):
    """`compute_torque` at QP_ITERS on both chains at once (the arm axis,
    as the full stack runs them): the home pose at rest and three random
    poses, from a cold carry and from the carry one control step left
    (qdd_prev and the ADMM duals warm): the carry, the torques and the
    loss. "pinv": from the cold carry with lane 3's task-space inverse
    scaled by 1e-3 on both chains, so its determinant falls below 1e-8
    and the pseudo-inverse branch computes Mx there."""
    s = _snapshots()
    dyn = s["dyn"]
    if carry == "pinv":
        mx = np.asarray(dyn.Mx_inv).copy()
        mx[:, 3] *= 1e-3
        det = np.abs(np.linalg.det(mx))
        assert (det[:, 3] < 1e-8).all() and (det[:, :3] > 1e-8).all()
        dyn = dyn._replace(Mx_inv=jnp.asarray(mx))
        carry = "cold"
    want = s["step"](s[carry], dyn, jnp.asarray(s["tpos"]),
                     jnp.asarray(s["tquat"]))
    got = tarm.compute_torque(
        from_jax(jax.device_get(s[carry]), "cpu"),
        from_jax(jax.device_get(dyn), "cpu"),
        torch.from_numpy(s["tpos"]), torch.from_numpy(s["tquat"]),
        from_jax(jax.device_get(s["params"]), "cpu"), qp_iters=QP_ITERS)
    _close(to_numpy(got[0]), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=ATOL)
    taumax = np.asarray(s["params"].taumax)
    assert (np.abs(got[1].numpy()) <= taumax + 1e-12).all()


def test_toy_snapshot_torque_matches_jax():
    """tests/test_arm.py's synthetic 7-DoF snapshot (seed 7) with its
    target, at the controller's default 200 ADMM iterations."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=7) * 0.3
    qd = rng.normal(size=7) * 0.1
    J = rng.normal(size=(6, 7)) * 0.5
    Jd = rng.normal(size=(6, 7)) * 0.05
    L = rng.normal(size=(7, 7)) * 0.3
    M = L @ L.T + np.eye(7) * 2.0
    h = rng.normal(size=7) * 5.0
    Mx_inv = J @ np.linalg.inv(M) @ J.T
    ee_pos = rng.normal(size=3) * 0.3
    ee_quat = rng.normal(size=4)
    ee_quat /= np.linalg.norm(ee_quat)
    dyn = jarm.ArmDynamics(*(jnp.asarray(x) for x in (
        q, qd, J, Jd, M, h, Mx_inv, ee_pos, ee_quat)))
    target = ee_pos + np.array([0.02, -0.01, 0.03])
    params = jarm.default_arm_params(dt=0.002, dtype=jnp.float64)
    want = jarm.compute_torque(jarm.arm_init_carry(jnp.float64), dyn,
                               jnp.asarray(target), dyn.ee_quat, params)
    got = tarm.compute_torque(
        tarm.arm_init_carry(torch.float64, "cpu"),
        from_jax(jax.device_get(dyn), "cpu"), torch.from_numpy(target),
        torch.from_numpy(ee_quat), from_jax(jax.device_get(params), "cpu"))
    _close(to_numpy(got[0]), want[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-12)


def test_default_arm_params_match_jax():
    want = jax.device_get(jarm.default_arm_params(0.002, jnp.float64))
    got = tarm.default_arm_params(0.002, torch.float64, "cpu")
    for name, w in zip(want._fields, want):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(w), err_msg=name)


def test_opspace_torque_matches_jax():
    """The closed-form law on the same snapshots, a low-pass state from a
    seed, with and without gravity compensation; a snapshot whose
    task-space inverse is near singular takes the pinv branch."""
    s = _snapshots()
    rng = np.random.default_rng(6)
    prev = rng.normal(size=(2, 4, 7))
    dyn = jax.device_get(s["dyn"])
    # A near-singular task-space inverse at lane 3: det below 1e-2.
    mx = np.asarray(dyn.Mx_inv).copy()
    mx[:, 3] *= 1e-3
    dyn = dyn._replace(Mx_inv=jnp.asarray(mx))
    for grav in (True, False):
        p = jops.OpspaceParams(
            K=jnp.asarray([200.0, 200.0, 200.0, 20.0, 20.0, 20.0]),
            K_null=jnp.ones(7) * 5.0, q0=jnp.asarray(jfs.HOME_QL),
            taumin=-jnp.ones(7) * 30.0, taumax=jnp.ones(7) * 30.0,
            gravity_compensation=grav)
        want = jax.vmap(jax.vmap(lambda c, d, tp, tq: jops.opspace_torque(
            c, d, tp, tq, p)))(jops.OpspaceCarry(jnp.asarray(prev)), dyn,
                               jnp.asarray(s["tpos"]), jnp.asarray(s["tquat"]))
        got = tops.opspace_torque(
            tops.OpspaceCarry(torch.from_numpy(prev)), from_jax(dyn, "cpu"),
            torch.from_numpy(s["tpos"]), torch.from_numpy(s["tquat"]),
            from_jax(jax.device_get(p), "cpu"))
        for g, w in zip((got[0].prev_tau, got[1], got[2]), (
                want[0].prev_tau, want[1], want[2])):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=ATOL)

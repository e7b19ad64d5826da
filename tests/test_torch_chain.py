"""Port parity: the quaternion utilities (`utils.quat`), the xArm7 chains
(`physics.chain.make_xarm7_chain`) and the chain dynamics (`fk`,
`point_jacobian`, `mass_matrix`, `bias_forces`, `jac_and_jacdot`,
`forward_dynamics`, `step`) against `dart_tpu`'s, vmapped over the lanes,
on the same numpy inputs made from a seed, in float64.

The port builds its chains in float64 and casts them once at the end;
JAX's float32 chain (x64 off) takes two of its rotations through float32
`jnp`, so it is held to the port's within float32's rounding, and the
port's float32 chain, the one its float32 commands use, to its own
float64 chain rounded once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dart_tpu.physics import chain as jch
from dart_tpu.rollout import full_stack as jfs
from dart_tpu.utils import quat as jq
from dart_tpu_torch.physics import chain as tch
from dart_tpu_torch.utils import quat as tq
from dart_tpu_torch.utils.convert import from_jax

# float64, the same operations in another order (the port sums the mass
# matrix's bodies in one einsum, solves by Cholesky where JAX takes LU):
# a few ulps of each result's scale.
RTOL = 1e-12
# The two chains of the dual-arm scene (`rollout.full_stack.make_scene`).
MOUNTS = {"left": ((-0.7, 0, -0.12), (0.707, 0, 0, -0.707)),
          "right": ((0.7, 0, -0.12), (0.707, 0, 0, -0.707))}
LANES = 5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _quat_cases():
    rng = np.random.default_rng(0)
    q, r = _quats(rng, 16), _quats(rng, 16)
    v = rng.normal(size=(16, 3))
    ang = rng.uniform(-1.2, 1.2, (16, 3))
    # rotation vectors from tiny (the series branch) to ~pi
    rv = rng.normal(size=(16, 3)) * np.logspace(-14, 0.4, 16)[:, None]
    u = rng.uniform(-0.6, 0.6, (16, 2))
    mats = np.asarray(jax.vmap(jq.quat_to_matrix)(jnp.asarray(q)))
    return {
        "quat_mul": (q, r), "quat_conj": (q,),
        "quat_normalize": (q * 3.0,), "quat_rotate": (q, v),
        "matrix_to_quat": (mats,), "quat_to_matrix": (q,),
        "quat_from_euler_xyz": (ang,), "quat_to_euler_xyz": (q,),
        "quat_to_rotvec": (q,), "rotvec_to_quat": (rv,),
        "tilt_to_quat": (u,), "quat_error_rotvec": (q, r),
    }


@pytest.mark.parametrize("name", sorted(_quat_cases()))
def test_quat_matches_jax(name):
    """Each quaternion function on 16 lanes (JAX's vmapped, since its
    `matrix_to_quat` reads one matrix): float64, 1e-14 absolute on unit
    quantities."""
    args = _quat_cases()[name]
    want = jax.vmap(getattr(jq, name))(*(jnp.asarray(a) for a in args))
    got = getattr(tq, name)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("side", sorted(MOUNTS))
def test_make_xarm7_chain_matches_jax(side):
    """float64 against JAX's under x64 to 1e-15; the port's float32 chain
    is its float64 one rounded once, and JAX's float32 chain (built with
    x64 off, carried across by `utils.convert`) lies within 4 float32 ulps
    of it, the port's chain being the one the port's commands use."""
    pos, quat = MOUNTS[side]
    want = jch.make_xarm7_chain(pos, quat, jnp.float64)
    got = tch.make_xarm7_chain(pos, quat, torch.float64, "cpu")
    for name, w in zip(want._fields, want):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(w),
                                   rtol=0, atol=1e-15, err_msg=name)
    got32 = tch.make_xarm7_chain(pos, quat, torch.float32, "cpu")
    with jax.enable_x64(False):
        jax32 = jax.device_get(jch.make_xarm7_chain(pos, quat, jnp.float32))
    jax32 = from_jax(jax32, "cpu")
    for name in want._fields:
        a, b = getattr(got32, name), getattr(jax32, name)
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, getattr(got, name).to(torch.float32)), name
        ulp = np.spacing(np.abs(a.numpy()).max().astype(np.float32))
        assert float((a - b).abs().max()) <= 4 * ulp, name


def _inputs(seed):
    rng = np.random.default_rng(seed)
    home = np.asarray([jfs.HOME_QL, jfs.HOME_QR])
    q = home[:, None] + rng.uniform(-0.8, 0.8, (2, LANES, 7))
    q[:, 0] = home                                 # lane 0 at home
    qd = rng.normal(size=(2, LANES, 7)) * 0.5
    qd[:, 1] = 0.0                                 # lane 1 at rest
    tau = rng.normal(size=(2, LANES, 7)) * 10.0
    f_ext = rng.normal(size=(2, LANES, 6)) * 5.0
    return q, qd, tau, f_ext


def _point(f, q):
    """A world point on body 5 (the tool offset from its origin)."""
    return f.p[..., 5, :] + 0.1 * f.R[..., 5, :, 2]


_FUNCS = {
    "fk": (lambda m, p, q, qd, tau, fe: tuple(m.fk(p, q))),
    "point_jacobian": (lambda m, p, q, qd, tau, fe: m.point_jacobian(
        m.fk(p, q), _point(m.fk(p, q), q), 5)),
    "body_jacobian": (lambda m, p, q, qd, tau, fe: m.body_jacobian(p, q, 7)),
    "mass_matrix": (lambda m, p, q, qd, tau, fe: m.mass_matrix(p, q)),
    "potential_energy": (lambda m, p, q, qd, tau, fe:
                         m.potential_energy(p, q)),
    "bias_forces": (lambda m, p, q, qd, tau, fe: m.bias_forces(p, q, qd)),
    "jac_and_jacdot": (lambda m, p, q, qd, tau, fe: m.jac_and_jacdot(
        p, q, qd, 7, jfs.EE_OFFSET)),
    "forward_dynamics": (lambda m, p, q, qd, tau, fe:
                         m.forward_dynamics(p, q, qd, tau)),
    # `step` with an EE wrench: `forward_dynamics` with f_ext inside.
    "step": (lambda m, p, q, qd, tau, fe: m.step(p, q, qd, tau, 0.002,
                                                 f_ext=fe)),
}


@functools.lru_cache(maxsize=None)
def _chains():
    """Both scene chains on a leading arm axis: JAX's stacked, the port's
    as (2, 1, ...) to broadcast against (2, LANES, ...) lanes, as the full
    stack batches its arms."""
    j = [jch.make_xarm7_chain(*MOUNTS[s], jnp.float64) for s in sorted(MOUNTS)]
    t = [tch.make_xarm7_chain(*MOUNTS[s], torch.float64, "cpu")
         for s in sorted(MOUNTS)]
    return (jax.tree.map(lambda *x: jnp.stack(x), *j),
            tch.ChainParams(*(torch.stack(x)[:, None] for x in zip(*t))),
            t)


def _leaves(tree):
    return jax.tree.leaves(tree,
                           is_leaf=lambda x: isinstance(x, torch.Tensor))


@functools.lru_cache(maxsize=None)
def _jax_results():
    """Every function of `_FUNCS` through JAX, vmapped over the lanes and
    the chains, in one jit (most of the cost is tracing and compiling the
    Lagrangian's autodiff, which the functions share)."""
    jp = _chains()[0]

    def per_lane(p, *a):
        return {name: fn(jch, p, *a) for name, fn in _FUNCS.items()}

    per_chain = jax.vmap(per_lane, in_axes=(None,) + (0,) * 4)
    return jax.device_get(jax.jit(jax.vmap(per_chain))(
        jp, *(jnp.asarray(a) for a in _inputs(1))))


@pytest.mark.parametrize("name", sorted(_FUNCS))
def test_chain_dynamics_matches_jax(name):
    """Each function on LANES random (q, qd, tau, f_ext) of each chain
    (lane 0 at home, lane 1 at rest), both chains at once on a leading
    arm axis, as the full stack runs them, against JAX's function vmapped
    over the lanes and the chains: float64, 1e-12 relative to each
    result's largest entry. The left chain alone, with one chain's
    parameters for every lane, gives the same."""
    fn = _FUNCS[name]
    _, both, (left, _) = _chains()
    args = _inputs(1)
    want = _jax_results()[name]
    got = fn(tch, both, *(torch.from_numpy(a) for a in args))
    for w, g in zip(jax.tree.leaves(want), _leaves(got)):
        assert _rel(g.numpy(), w) <= RTOL, name
    alone = fn(tch, left, *(torch.from_numpy(a[0]) for a in args))
    for g, g1 in zip(_leaves(got), _leaves(alone)):
        assert _rel(g1.numpy(), g[0].numpy()) <= RTOL, name


def test_bias_forces_are_gravity_at_rest():
    """With qd = 0 the Coriolis terms vanish: h = dV/dq, which the port
    takes by a gradient of the Lagrangian; against a central
    difference of `potential_energy` (float64, 1e-6 relative)."""
    tp = _chains()[2][0]
    q, _, _, _ = _inputs(2)
    q = torch.from_numpy(q[0])
    h = tch.bias_forces(tp, q, torch.zeros_like(q))
    eps = 1e-6
    fd = torch.stack([(tch.potential_energy(tp, q + eps * e)
                       - tch.potential_energy(tp, q - eps * e)) / (2 * eps)
                      for e in torch.eye(7, dtype=q.dtype)], -1)
    assert _rel(h.numpy(), fd.numpy()) <= 1e-6

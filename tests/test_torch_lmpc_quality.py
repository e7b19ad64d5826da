"""Why the LMPC kernel branch leaves lanes short of the target, held
against JAX's own kernel semantics on lanes chosen by a fixed rule.

`chip_smoke.py`'s lmpc-main phase runs `LMPCBatch(N=12, dt=0.01)` with its
2x3 kernel budget and escalation in closed loop on the LMPC plant for 1024
steps at B=4096, float32, from rest, with the plant's parameters and
targets drawn by `adapt.lmpc_trainer` from a CPU generator seeded with
`chip_smoke.LMPC_SEED`. On an NVIDIA H100 80GB HBM3 at 700.00 W the
kernel split along the model's axes left 171 lanes 1 cm or more from the
target: REST, 105 lanes that never left rest, and STALLED_MM, 66 that moved
and stalled short (their final error in mm). Every other lane ended within
1 cm.

JAX's kernel semantics here are `_lmpc_kernel` with its iteration loop
rolled, jitted once (the same per-element operations as the eager body),
in float32 as the main path runs, inside the escalation of
`dart_tpu.control.mpc._escalate` written as a host loop. The plant is the
port's `lmpc_plant_step` (JAX's RK4 of `lmpc_dynamics` would promote
float32 to float64 here).

The lanes are fixed by rule, not by outcome: every REST lane for the first
solve; for the closed loop, the first REST lane (it keeps every step at the
round limit, as on the card), lane 371, a seeded sample of 11 other
STALLED lanes and a seeded sample of 11 lanes the card brought within 1 cm
(lane 371 stalled on the card under the kernel's first, one-thread-per-lane
design; its first control differs from JAX's by a float32 tie).
Where float32 rounding tips a line-search tie, JAX, the port's plain
version on the CPU and the kernel on the card may each take another
branch; the lanes where that happened are listed below, not left out.

Run as a script, `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_lmpc_quality.py` runs the same loop on the first REST
lane, the REST lanes JAX moves, every STALLED lane and a seeded sample of
28 lanes within 1 cm (~6 min), and prints each lane's final error in JAX
beside the card's: the measurement behind `chip_smoke.py`'s LMPC gates
(PERF.md section 6)."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from dart_tpu.control import mpc as jmpc
from dart_tpu_torch.adapt import lmpc_trainer as ttrainer
from dart_tpu_torch.control import mpc as tmpc
from dart_tpu_torch.ops.kernels import lmpc_solve as tls
from dart_tpu_torch.rollout import loop
from dart_tpu_torch.utils.convert import from_jax
from test_torch_lmpc_batch import _jax_kernel_step
from test_torch_lmpc_solve import kernel_fn

B_ALL, N, DT, STEPS = 4096, 12, 0.01, 1024
# The H100 run of chip_smoke.py's lmpc-main phase.
STALLED_MM = {2: 41.98, 69: 44.18, 74: 34.35, 236: 12.15, 306: 34.20,
              348: 11.93, 372: 13.38, 471: 36.88, 483: 11.20, 527: 45.37,
              651: 64.22, 892: 15.00, 902: 18.68, 974: 35.35, 977: 49.46,
              989: 19.80, 1024: 38.21, 1032: 19.10, 1132: 10.22, 1211: 14.40,
              1340: 10.51, 1354: 18.23, 1363: 11.87, 1372: 10.62, 1437: 16.28,
              1463: 16.57, 1484: 45.78, 1548: 58.19, 1563: 12.81, 1628: 10.71,
              1680: 10.50, 1752: 14.13, 1770: 17.72, 1901: 24.68, 1983: 30.76,
              2060: 12.67, 2097: 14.66, 2104: 13.57, 2179: 17.72, 2357: 29.05,
              2393: 40.28, 2463: 35.99, 2650: 57.76, 2675: 41.36, 2842: 34.95,
              2849: 48.27, 2850: 15.90, 2863: 46.66, 2909: 19.36, 2932: 14.09,
              2972: 17.98, 3135: 43.02, 3159: 14.01, 3189: 58.67, 3258: 10.25,
              3308: 19.38, 3316: 27.98, 3373: 17.80, 3387: 19.77, 3402: 50.80,
              3422: 11.56, 3477: 21.86, 3542: 12.03, 3820: 19.10, 3923: 40.48,
              3949: 15.78}
REST = [125, 131, 140, 274, 297, 336, 479, 507, 508, 559, 582, 583, 665, 720,
        765, 825, 991, 993, 1003, 1110, 1133, 1222, 1242, 1257, 1276, 1299,
        1334, 1381, 1417, 1428, 1448, 1497, 1502, 1517, 1533, 1538, 1539,
        1582, 1622, 1639, 1644, 1648, 1730, 1824, 1861, 1879, 1913, 1923,
        1950, 1975, 2067, 2074, 2081, 2121, 2128, 2215, 2251, 2258, 2278,
        2367, 2433, 2493, 2504, 2518, 2530, 2628, 2632, 2633, 2677, 2685,
        2692, 2694, 2704, 2709, 2720, 2825, 2831, 2883, 3078, 3088, 3107,
        3117, 3132, 3141, 3156, 3174, 3202, 3319, 3410, 3482, 3493, 3569,
        3618, 3676, 3681, 3682, 3727, 3730, 3737, 3787, 3809, 3896, 3947,
        3968, 4029]

# Lanes whose end in JAX differs from the card's: short on the card and
# within in JAX (the script's run), and at rest or stalled in JAX and within
# on the card (the lanes 2139, 2759, 3409 that JAX keeps at rest and 2614
# that it stalls, from the script's run on the one-thread-per-lane kernel's
# lists, where the card left them short too).
DISAGREE = {1132, 1211, 1417, 2632, 2139, 2614, 2759, 3409}
# Lanes at rest on the card whose first solve from rest moves them, in JAX
# and in the port's plain version on the CPU.
JAX_REST_MOVES = {1417, 2632}
PORT_REST_MOVES = {131, 1417}
B_T = 24            # the closed loop's lanes; also the rest check's chunks
# Steps at which the port solves from JAX's carry and state, and the lanes
# whose control there differs from JAX's by more than 5e-3.
CHECKPOINTS = {0: [371, 1132], 512: [], 1023: []}


def within_lanes():
    return np.setdiff1d(np.arange(B_ALL), REST + list(STALLED_MM))


def loop_lanes() -> list[int]:
    rng = np.random.default_rng(0)
    others = sorted(set(STALLED_MM) - {371})
    stalled = sorted(rng.choice(others, 11, replace=False).tolist())
    within = sorted(rng.choice(within_lanes(), 11, replace=False).tolist())
    return [REST[0], 371] + stalled + within


def script_lanes() -> list[int]:
    rng = np.random.default_rng(1)
    within = sorted(rng.choice(within_lanes(), 28, replace=False).tolist())
    return [REST[0]] + sorted(JAX_REST_MOVES) + sorted(STALLED_MM) + within


def card_short(lanes) -> np.ndarray:
    short = set(REST) | set(STALLED_MM)
    return np.array([i in short for i in lanes])


def _lanes(idx):
    gen = torch.Generator().manual_seed(chip_smoke.LMPC_SEED)
    pv = ttrainer.sample_true_params(gen, B_ALL)
    tg = ttrainer.sample_target(gen, B_ALL)
    return pv[idx], tg[idx]


def _bl(x) -> jnp.ndarray:
    """(B, ...) torch or numpy -> batch-last float32 JAX array."""
    return jnp.asarray(np.moveaxis(np.asarray(x), 0, -1), jnp.float32)


def _weights(B):
    w = jmpc.LMPC_DEFAULT_WEIGHTS
    return (_bl(np.broadcast_to(np.asarray(w.Q), (B, 8))),
            _bl(np.broadcast_to(np.asarray(w.R), (B, 4))))


def jax_body():
    """The kernel body at the main path's budget (2 iterations x 3
    alphas), rolled and jitted."""
    return jax.jit(kernel_fn(N, DT, roll=True))


def closed_loop(body, lanes, checkpoint=None):
    """1024 steps of JAX's kernel semantics on the plant from rest. At each
    step in CHECKPOINTS, `checkpoint(carry, x, u, rounds)` gets the carry
    and state the step solved from and JAX's control and extra rounds.
    Returns the final XY errors (m) and the extra rounds of every step."""
    pv, tg = _lanes(lanes)
    B = len(lanes)
    jc = jmpc.LMPCBatch(N=N, dt=DT)
    carry = jc.init_carry_batch(B, jnp.float32)
    args = jnp.asarray(tg.numpy()), jnp.asarray(pv.numpy())
    plant = loop.lmpc_plant_step(pv, DT)
    x, rounds = torch.zeros((B, 8)), []
    for step in range(STEPS):
        new, u, _, _, r = _jax_kernel_step(body, jc, carry,
                                           jnp.asarray(x.numpy()), *args)
        u = torch.from_numpy(np.array(u))
        if checkpoint is not None and step in CHECKPOINTS:
            checkpoint(carry, x, u, r)
        carry = new
        x = plant(x, u)
        rounds.append(r)
    err = torch.hypot(x[:, 0] - tg[:, 0], x[:, 2] - tg[:, 2]).numpy()
    return err, rounds


@pytest.fixture(scope="module")
def body():
    return jax_body()


def first_solve_fixed(body, lanes) -> tuple[np.ndarray, np.ndarray]:
    """Whether the first solve from rest with a zero warm start returns
    V = 0 exactly, per lane, in JAX and in the port's plain version (in
    chunks of B_T lanes, the jitted body's shape)."""
    Q, R = _weights(B_T)
    tQ, tR = torch.from_numpy(np.array(Q)), torch.from_numpy(np.array(R))
    jax_fixed, port_fixed = [], []
    for c in range(0, len(lanes), B_T):
        pv, tg = _lanes(lanes[c:c + B_T])
        V = body(_bl(pv), Q, R, Q, _bl(tg),
                 jnp.zeros((10, B_T), jnp.float32),
                 jnp.zeros((N, 2, B_T), jnp.float32))[0]
        Vt = tls.lmpc_solve(pv.T.contiguous(), tQ, tR, tQ,
                            tg.T.contiguous(), torch.zeros((10, B_T)),
                            torch.zeros((N, 2, B_T)), dt=DT)[0]
        jax_fixed.append(np.all(np.asarray(V) == 0, axis=(0, 1)))
        port_fixed.append((Vt == 0).all(dim=0).all(dim=0).numpy())
    return np.concatenate(jax_fixed), np.concatenate(port_fixed)


def test_rest_is_a_fixed_point_of_the_kernel_in_jax_and_the_port(body):
    """From rest with a zero warm start, the first solve returns V = 0
    exactly, in JAX and in the port's plain version, for the lanes the
    H100 run left at rest, apart from a few whose first trial's cost is a
    float32 tie (each library's exp and tanh round it their own way); it
    returns V = 0 for none of a seeded sample of the others; and the plant
    stays exactly at rest under u = 0."""
    rng = np.random.default_rng(2)
    moved = rng.choice(np.setdiff1d(np.arange(B_ALL), REST),
                       5 * B_T - len(REST), replace=False).tolist()
    jax_fixed, port_fixed = first_solve_fixed(body, REST + moved)
    rest = np.arange(len(REST))
    np.testing.assert_array_equal(np.array(REST)[~jax_fixed[rest]],
                                  sorted(JAX_REST_MOVES))
    np.testing.assert_array_equal(np.array(REST)[~port_fixed[rest]],
                                  sorted(PORT_REST_MOVES))
    assert not jax_fixed[len(REST):].any()
    assert not port_fixed[len(REST):].any()
    pv, _ = _lanes(REST)
    x = loop.lmpc_plant_step(pv, DT)(torch.zeros((len(REST), 8)),
                                     torch.zeros((len(REST), 2)))
    assert bool((x == 0).all())


def test_lanes_short_after_an_episode_in_jax_too(body):
    """One 1024-step loop of JAX's semantics on the rule's lanes, every
    step at the round limit as on the card. At three steps the port's
    kernel branch (the plain version, the 24 lanes padded to 128 with
    copies of the rest lane) solves from JAX's carry and state: the same
    extra rounds, and every control within 5e-3 of JAX's (the float32 rule
    of tests/test_lmpc_solve_kernel.py) but on the lanes CHECKPOINTS names,
    float32 line-search ties. At the end every lane is short of 1 cm in JAX
    exactly where it was on the card, apart from the DISAGREE lanes."""
    lanes = loop_lanes()
    pad = list(range(len(lanes))) + [0] * (128 - len(lanes))
    pv, tg = _lanes(lanes)
    tc = tmpc.LMPCBatch(N=N, dt=DT)
    seen = []

    def checkpoint(carry, x, u, r):
        c = type(carry)(*(t[pad] for t in from_jax(carry, "cpu")))
        _, tu, diag = tc.solve_batched(c, x[pad], tg[pad], pv[pad])
        np.testing.assert_array_equal(diag.iters.numpy(), 2 * (1 + r))
        d = (tu[:len(lanes)] - u).abs().amax(dim=1).numpy()
        seen.append(d)

    err, rounds = closed_loop(body, lanes, checkpoint)
    assert [np.array(lanes)[d > 5e-3].tolist() for d in seen] == list(
        CHECKPOINTS.values())
    assert set(rounds) == {2}
    want = card_short(lanes) ^ np.isin(lanes, list(DISAGREE))
    np.testing.assert_array_equal(err >= 0.01, want,
                                  err_msg=str(np.round(err * 1e3, 2)))
    assert err[0] == float(torch.hypot(tg[0, 0], tg[0, 2]))   # never moved


def main() -> None:
    lanes = script_lanes()
    err, rounds = closed_loop(jax_body(), lanes)
    card = card_short(lanes)
    print(f"rounds per step {sorted(set(rounds))}")
    for i, e, c in zip(lanes, err, card):
        mm = STALLED_MM.get(i, "rest" if i in REST else "< 10")
        flag = "" if (e >= 0.01) == c else "  DISAGREE"
        print(f"lane {i:4d}: JAX {e * 1e3:8.2f} mm, card {mm}{flag}")
    stalled = np.isin(lanes, list(STALLED_MM))
    within = ~card
    print(f"stalled lanes short in JAX too: "
          f"{int((err[stalled] >= 0.01).sum())} of {int(stalled.sum())}; "
          f"within-1-cm lanes within in JAX too: "
          f"{int((err[within] < 0.01).sum())} of {int(within.sum())}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.exit(main())

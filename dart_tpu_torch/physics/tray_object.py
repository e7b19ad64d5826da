"""Tray-object contact plant, the evaluators' ground truth (port of
`dart_tpu.physics.tray_object`).

An object (cube / cylinder / sphere) rests on a tray whose tilt tracks the
commanded [theta_x, theta_y] through a two-pole lag with a transfer zero
and a small-signal backlash (the dual-arm stack's measured response); the
object slides and rolls under regularised Coulomb friction with per-shape
dissipation, and flat axes rock about the downhill support edge and
topple once the COM passes it. The model and its MuJoCo calibration are
documented in the JAX module; this one keeps its operations in the same
order, so both agree to round-off.

The functions work on a leading lane axis. State leaves are (..., 2),
`toppled` is a (...) bool. Params leaves are per axis, (..., 2) (`kappa_inv`,
`omega_n`, `zeta`, `half_w`, `topple_on`, `lag_fast`, `roll_stick`,
`back_w`, `back_gss`; `tray_pos` is (..., 3)), or per lane, (...) (`mass`,
`mu`, `slip_eps`, `h_com`, `roll_resist`, `slide_damp`, `stick_vel`); a
python float stands for the same value on every lane.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dart_tpu_torch.utils.device import resolve

G0 = 9.81

# Tray half-extents (`world_general.xml:135`: box size 0.2 0.15 0.005).
TRAY_LIMIT_X = 0.2
TRAY_LIMIT_Y = 0.15

SHAPES = ("cube", "cylinder", "sphere")

# Tray lag fitted against the MuJoCo reference world (r3, mass-agnostic):
# ((omega_n_x, omega_n_y), (zeta_x, zeta_y), (fast_frac_x, fast_frac_y)).
CALIBRATED_TRAY_LAG = ((4.694, 3.871), (2.25, 1.331), (0.3144, 0.5994))
# r4 payload-mass-resolved fits at the two grid masses; `calibrated_lag`
# interpolates between them.
CALIBRATED_TRAY_LAG_BY_MASS = {
    1.0: ((4.752, 2.674), (2.171, 1.499), (0.3235, 0.9482)),
    2.0: ((4.023, 1.549), (2.509, 2.406), (0.3075, 0.9316)),
}
# The r1/r2 lag (omega_n, zeta), kept to reproduce historical artifacts.
LEGACY_TRAY_LAG = (40.0, 1.0)
# Per-shape contact dissipation fitted by replaying recorded MuJoCo tilt.
CALIBRATED_ROLL_RESIST = {"cube": 0.0, "cylinder": 0.0118, "sphere": 0.0089}
CALIBRATED_SLIDE_DAMP = {"cube": 2.736, "cylinder": 0.0, "sphere": 0.0}
# The cube's slide damping fades linearly to 0 between these mu anchors.
CALIBRATED_SLIDE_DAMP_MU_ANCHORS = (0.05, 0.2)
# Rolling-stiction breakaway slope per mu, measured as 0 for the reference
# world (its condim-3 geoms make rolling friction inert).
ROLL_STICK_PER_MU = 0.0
# Arm-stack backlash per axis: play half-width (rad) and presliding gain.
CALIBRATED_BACK_W = (0.007, 0.0185)
CALIBRATED_BACK_GSS = (0.095, 0.0212)
# Per-axis inverse rolling factors kappa_inv = 1/kappa.
_KAPPA_INV = {
    "cube": (0.0, 0.0),
    "cylinder": (2.0, 0.0),
    "sphere": (2.5, 2.5),
}
# Per-axis rocking enable: flat-bottomed, non-rolling axes only.
_TOPPLE_ON = {
    "cube": (1.0, 1.0),
    "cylinder": (0.0, 1.0),
    "sphere": (0.0, 0.0),
}


def _lane(x):
    """A per-lane leaf (...) as a column against the axis pair (..., 2)."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def calibrated_lag(mass, dtype=torch.float32, device=None):
    """Payload-mass-interpolated tray lag -> (omega_n, zeta, fast_frac),
    each (..., 2) for mass (...): linear between the grid masses 1 and 2
    kg, clamped outside."""
    lo = CALIBRATED_TRAY_LAG_BY_MASS[1.0]
    hi = CALIBRATED_TRAY_LAG_BY_MASS[2.0]
    m = torch.as_tensor(mass, dtype=dtype, device=device)
    t = torch.clamp(m - 1.0, 0.0, 1.0)[..., None]
    return tuple(
        (1.0 - t) * torch.tensor(a, dtype=dtype, device=m.device)
        + t * torch.tensor(b, dtype=dtype, device=m.device)
        for a, b in zip(lo, hi))


def calibrated_slide_damp(base, mu, dtype=torch.float32):
    """mu-resolved tangential damping: `base` (the mu=0.05 fit) faded
    linearly to 0 at mu=0.2, clamped outside."""
    lo, hi = CALIBRATED_SLIDE_DAMP_MU_ANCHORS
    mu = torch.as_tensor(mu, dtype=dtype)
    fade = torch.clamp((hi - mu) / (hi - lo), 0.0, 1.0)
    return torch.as_tensor(base, dtype=dtype, device=mu.device) * fade


def calibrated_roll_stick(kappa_inv, mu, dtype=torch.float32):
    """Per-axis breakaway cone (x gn), (..., 2) for kappa_inv (..., 2) and
    mu (...): ROLL_STICK_PER_MU * mu on rolling axes, 0 elsewhere."""
    mu = torch.as_tensor(mu, dtype=dtype)
    base = (ROLL_STICK_PER_MU * mu)[..., None]
    kappa_inv = torch.as_tensor(kappa_inv, dtype=dtype, device=mu.device)
    return torch.where(kappa_inv > 0, base, torch.zeros_like(base))


class TrayObjectParams(NamedTuple):
    mass: torch.Tensor            # kg (effort accounting only)
    mu: torch.Tensor              # sliding friction coefficient
    kappa_inv: torch.Tensor       # (2,) per-axis inverse rolling factor
    slip_eps: torch.Tensor        # friction regularisation velocity (m/s)
    omega_n: torch.Tensor         # (2,) tray tracking bandwidth (rad/s)
    zeta: torch.Tensor            # (2,) tray tracking damping ratio
    tray_pos: torch.Tensor        # (3,) world tray centre
    half_w: torch.Tensor          # (2,) support half-extent per tip axis (m)
    h_com: torch.Tensor           # COM height above the contact plane (m)
    topple_on: torch.Tensor       # (2,) 1.0 where rocking is modelled
    roll_resist: torch.Tensor | float = 0.0   # rolling resistance (x gn)
    slide_damp: torch.Tensor | float = 0.0    # viscous tangential damping
    lag_fast: torch.Tensor | float = 0.0      # (2,) share at the fast pole
    roll_stick: torch.Tensor | float = 0.0    # (2,) breakaway cone (x gn)
    stick_vel: torch.Tensor | float = 5e-3    # hold only below this speed
    back_w: torch.Tensor | float = 0.0        # (2,) backlash half-width
    back_gss: torch.Tensor | float = 1.0      # (2,) gain inside the play


def make_params(shape: str = "cube", mass: float = 1.0, mu: float = 0.1,
                slip_eps: float = 2e-3, omega_n=40.0, zeta=1.0,
                tray_height: float = 0.4, size: float = 0.05,
                dtype=torch.float32, calibrated: bool = False,
                device: torch.device | str = "cuda") -> TrayObjectParams:
    """One lane's params. `size` is the cube edge / cylinder or sphere
    diameter; omega_n/zeta may be scalars or per-axis pairs (stored as
    pairs); ``calibrated=True`` takes the mass-interpolated measured lag
    and the fitted dissipation and backlash instead."""
    dev = resolve(device)

    def a(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def pair(x):
        return torch.broadcast_to(a(x), (2,))

    lag_fast, roll_resist, slide_damp = 0.0, 0.0, 0.0
    roll_stick, back_w, back_gss = 0.0, 0.0, 1.0
    if calibrated:
        omega_n, zeta, lag_fast = calibrated_lag(mass, dtype, dev)
        roll_resist = CALIBRATED_ROLL_RESIST[shape]
        slide_damp = calibrated_slide_damp(CALIBRATED_SLIDE_DAMP[shape],
                                           a(mu), dtype)
        roll_stick = calibrated_roll_stick(a(_KAPPA_INV[shape]), a(mu),
                                           dtype)
        back_w, back_gss = CALIBRATED_BACK_W, CALIBRATED_BACK_GSS
    half = size / 2.0
    return TrayObjectParams(
        mass=a(mass), mu=a(mu), kappa_inv=a(_KAPPA_INV[shape]),
        slip_eps=a(slip_eps), omega_n=pair(omega_n), zeta=pair(zeta),
        tray_pos=a([0.0, 0.0, tray_height]),
        half_w=a([half, half]), h_com=a(half),
        topple_on=a(_TOPPLE_ON[shape]),
        roll_resist=a(roll_resist), slide_damp=a(slide_damp),
        lag_fast=pair(lag_fast), roll_stick=pair(roll_stick),
        stick_vel=a(5e-3), back_w=pair(back_w), back_gss=pair(back_gss))


def topple_on_from_kappa(kappa_inv: torch.Tensor) -> torch.Tensor:
    """Rocking-enable mask from the rolling signature: an axis that rolls
    (kappa_inv > 0) cannot rock (cube (0,0)->(1,1), cylinder (2,0)->(0,1),
    sphere (2.5,2.5)->(0,0))."""
    return (kappa_inv == 0).to(kappa_inv.dtype)


def shape_from_kappa(kappa_inv: torch.Tensor) -> torch.Tensor:
    """Shape from the kappa signature: cube (0,0), cylinder (k,0), sphere
    (k,k)."""
    return torch.where(kappa_inv[..., 1] > 0, 2,
                       torch.where(kappa_inv[..., 0] > 0, 1, 0))


def scenario_params(shape_kappa_inv: torch.Tensor, mass: torch.Tensor,
                    mu: torch.Tensor, dtype, tray_lag=None):
    """Scenario rows -> TrayObjectParams with (B,) and (B, 2) leaves.
    `tray_lag` is an optional (omega_n, zeta[, fast_frac]) tuple of
    scalars or per-axis pairs. Default (None): the mass-interpolated
    `calibrated_lag(mass)` plus the fitted per-shape dissipation and
    backlash; `LEGACY_TRAY_LAG` reproduces the r1/r2 artifacts
    (optimistic lag, no dissipation)."""
    B, dev = mass.shape[0], mass.device

    def axes(x):
        return torch.broadcast_to(
            torch.as_tensor(x, dtype=dtype, device=dev), (B, 2))

    def lanes(v):
        return torch.full((B,), v, dtype=dtype, device=dev)

    calibrated = tray_lag is None
    lag = calibrated_lag(mass, dtype) if calibrated else tray_lag
    omega_n, zeta = lag[0], lag[1]
    lag_fast = lag[2] if len(lag) > 2 else 0.0
    if calibrated:
        shape_id = shape_from_kappa(shape_kappa_inv).long()
        rr_tab = torch.tensor([CALIBRATED_ROLL_RESIST[s]
                               for s in SHAPES], dtype=dtype,
                              device=dev)
        sd_tab = torch.tensor([CALIBRATED_SLIDE_DAMP[s]
                               for s in SHAPES], dtype=dtype,
                              device=dev)
        roll_resist = rr_tab[shape_id]
        slide_damp = calibrated_slide_damp(sd_tab[shape_id], mu,
                                                  dtype)
        roll_stick = calibrated_roll_stick(shape_kappa_inv, mu,
                                                  dtype)
        back_w = axes(CALIBRATED_BACK_W)
        back_gss = axes(CALIBRATED_BACK_GSS)
    else:
        roll_resist, slide_damp = lanes(0.0), lanes(0.0)
        roll_stick, back_w, back_gss = axes(0.0), axes(0.0), axes(1.0)
    return TrayObjectParams(
        mass=mass, mu=mu, kappa_inv=shape_kappa_inv, slip_eps=lanes(2e-3),
        omega_n=axes(omega_n), zeta=axes(zeta),
        tray_pos=torch.broadcast_to(
            torch.tensor([0.0, 0.0, 0.4], dtype=dtype, device=dev), (B, 3)),
        half_w=axes(0.025), h_com=lanes(0.025),
        topple_on=topple_on_from_kappa(shape_kappa_inv),
        roll_resist=roll_resist, slide_damp=slide_damp,
        lag_fast=axes(lag_fast), roll_stick=roll_stick,
        stick_vel=lanes(5e-3), back_w=back_w, back_gss=back_gss)


class TrayObjectState(NamedTuple):
    theta: torch.Tensor       # (2,) actual tray tilt [tx, ty]
    theta_dot: torch.Tensor   # (2,)
    p: torch.Tensor           # (2,) object position in tray frame
    v: torch.Tensor           # (2,) object velocity in tray frame
    v_roll: torch.Tensor      # (2,) rolling-equivalent contact velocity
    q_rock: torch.Tensor      # (2,) signed rocking angle about support edges
    w_rock: torch.Tensor      # (2,) rocking rate
    toppled: torch.Tensor     # () bool, sticky: the COM passed the edge
    # The tray lag's per-pole states (theta_lin = lag_x1 + lag_x2) and the
    # backlash play state; pass-through in `step_object`.
    lag_x1: torch.Tensor | None = None
    lag_x2: torch.Tensor | None = None
    lag_b: torch.Tensor | None = None


def init_state(p0=(0.0, 0.0), dtype=torch.float32,
               device: torch.device | str = "cuda",
               batch: tuple[int, ...] | int = ()) -> TrayObjectState:
    """Rest state for `batch` lanes (a shape; () is one lane), the object
    at p0 ((2,) or (*batch, 2))."""
    dev = resolve(device)
    batch = (batch,) if isinstance(batch, int) else tuple(batch)
    z2 = torch.zeros((*batch, 2), dtype=dtype, device=dev)
    p = torch.broadcast_to(torch.as_tensor(p0, dtype=dtype, device=dev),
                           (*batch, 2)).clone()
    return TrayObjectState(theta=z2, theta_dot=z2, p=p, v=z2, v_roll=z2,
                           q_rock=z2, w_rock=z2,
                           toppled=torch.zeros(batch, dtype=torch.bool,
                                               device=dev),
                           lag_x1=z2, lag_x2=z2, lag_b=z2)


def tray_gravity(theta: torch.Tensor):
    """(tangential (..., 2), normal (...)) gravity in the tray frame."""
    tx, ty = theta[..., 0], theta[..., 1]
    gt = torch.stack([-G0 * torch.sin(tx),
                      -G0 * torch.cos(tx) * torch.sin(ty)], -1)
    gn = G0 * torch.cos(tx) * torch.cos(ty)
    return gt, gn


def step_object(s: TrayObjectState, theta: torch.Tensor,
                theta_dot: torch.Tensor, params: TrayObjectParams,
                dt: float) -> TrayObjectState:
    """Object friction / rolling / rocking update given the actual tray
    tilt (semi-implicit Euler)."""
    gt, gn = tray_gravity(theta)
    gn2 = gn[..., None]
    slip = s.v - s.v_roll
    a_f = -_lane(params.mu) * gn2 * torch.tanh(slip / _lane(params.slip_eps))
    a = gt + a_f - _lane(params.slide_damp) * s.v
    v = s.v + dt * a
    # Rolling resistance decelerates the rolling contact.
    rr = _lane(params.roll_resist) * gn2 * torch.tanh(
        s.v_roll / _lane(params.slip_eps))
    v_roll = s.v_roll + dt * (-a_f * params.kappa_inv - rr)
    # Non-rolling axes carry no rolling state.
    rolling = params.kappa_inv > 0
    v_roll = torch.where(rolling, v_roll, torch.zeros_like(v_roll))
    # Rolling stiction: a slow rolling contact inside the breakaway cone
    # snaps to rest for this step.
    stick_vel = _lane(params.stick_vel)
    stick = (rolling
             & (torch.abs(v) <= stick_vel)
             & (torch.abs(v_roll) <= stick_vel)
             & (torch.abs(gt) <= params.roll_stick * gn2))
    v = torch.where(stick, torch.zeros_like(v), v)
    v_roll = torch.where(stick, torch.zeros_like(v_roll), v_roll)
    p = s.p + dt * v

    # Rocking about the downhill support edge: torque per unit mass at
    # rocking angle q' over the edge moment of inertia per unit mass.
    w_sup, h = params.half_w, _lane(params.h_com)
    k_rock = (h * h + w_sup * w_sup) * (4.0 / 3.0)
    s_dir = torch.where(s.q_rock != 0, torch.sign(s.q_rock), torch.sign(gt))
    qp = torch.abs(s.q_rock)
    tau = (h * torch.cos(qp) + w_sup * torch.sin(qp)) * (s_dir * gt) \
        + (h * torch.sin(qp) - w_sup * torch.cos(qp)) * gn2
    alpha = s_dir * tau / k_rock * params.topple_on
    w_rock = s.w_rock + dt * alpha
    q_rock = s.q_rock + dt * w_rock
    # Inelastic landing: crossing q=0 against the active edge absorbs the
    # rocking energy.
    landed = q_rock * s_dir < 0
    q_rock = torch.where(landed, torch.zeros_like(q_rock), q_rock)
    w_rock = torch.where(landed, torch.zeros_like(w_rock), w_rock)
    q_crit = torch.atan2(w_sup, h)
    toppled = s.toppled | torch.any((torch.abs(q_rock) > q_crit)
                                    & (params.topple_on > 0), dim=-1)
    q_rock = torch.minimum(torch.maximum(q_rock, -2.0 * q_crit),
                           2.0 * q_crit)
    return TrayObjectState(theta=theta, theta_dot=theta_dot, p=p, v=v,
                           v_roll=v_roll, q_rock=q_rock, w_rock=w_rock,
                           toppled=toppled, lag_x1=s.lag_x1, lag_x2=s.lag_x2,
                           lag_b=s.lag_b)


def lag_poles(omega_n, zeta):
    """Real pole rates (lam_slow, lam_fast) of the tray lag, zeta clamped
    to >= 1 + 1e-6. `z * z - 1.0` is kept as written: at the legacy zeta
    = 1 it cancels, and another order moves the float32 poles."""
    z = torch.clamp(zeta, min=1.0 + 1e-6)
    s = omega_n * torch.sqrt(z * z - 1.0)
    a = z * omega_n
    return a - s, a + s


def lag_step(x1, x2, u_cmd, omega_n, zeta, dt: float, fast_frac=0.0):
    """Exact (ZOH) step of the tray lag as a parallel mix of its two real
    poles, a share `fast_frac` of a command step realised at the fast
    pole. Returns (x1', x2', theta', theta_dot')."""
    l1, l2 = lag_poles(omega_n, zeta)
    kf = fast_frac
    E1 = torch.exp(-l1 * dt)
    E2 = torch.exp(-l2 * dt)
    x1n = E1 * x1 + (1.0 - kf) * (1.0 - E1) * u_cmd
    x2n = E2 * x2 + kf * (1.0 - E2) * u_cmd
    theta_n = x1n + x2n
    td_n = l1 * ((1.0 - kf) * u_cmd - x1n) + l2 * (kf * u_cmd - x2n)
    return x1n, x2n, theta_n, td_n


def step(s: TrayObjectState, u_cmd: torch.Tensor, params: TrayObjectParams,
         dt: float) -> TrayObjectState:
    """One plant step at the 2 ms sim cadence: the exact tray lag through
    the backlash, then the object update."""
    x1, x2, th_lin, _ = lag_step(s.lag_x1, s.lag_x2, u_cmd,
                                 params.omega_n, params.zeta, dt,
                                 params.lag_fast)
    # Backlash with compliance: the play state trails theta_lin within
    # +-back_w, and inside the play only back_gss of the motion is realised.
    b = torch.minimum(torch.maximum(s.lag_b, th_lin - params.back_w),
                      th_lin + params.back_w)
    theta = b + params.back_gss * (th_lin - b)
    # A backward difference, as the reference takes it, also when back_w = 0
    # and the lag's own rate would be at hand.
    theta_dot = (theta - s.theta) / dt
    s2 = step_object(s, theta, theta_dot, params, dt)
    return s2._replace(lag_x1=x1, lag_x2=x2, lag_b=b)


def observe_world(s: TrayObjectState, params: TrayObjectParams,
                  surface_offset: float = 0.03):
    """World-frame object position and velocity (..., 3) as the MPC
    observes them, with R = Ry(-tx) Rx(ty) written out in closed form and
    the tray's rotation-rate term omega x r in the velocity."""
    tx, ty = s.theta[..., 0], s.theta[..., 1]
    cx, sx = torch.cos(-tx), torch.sin(-tx)
    cy, sy = torch.cos(ty), torch.sin(ty)
    # R = [[cx, sx sy, sx cy], [0, cy, -sy], [-sx, cx sy, cx cy]]
    r01, r02 = sx * sy, sx * cy
    r21, r22 = cx * sy, cx * cy
    px, py = s.p[..., 0], s.p[..., 1]
    vx, vy = s.v[..., 0], s.v[..., 1]
    off = surface_offset
    rel0 = cx * px + r01 * py + r02 * off
    rel1 = cy * py + (-sy) * off
    rel2 = -sx * px + r21 * py + r22 * off
    pos = params.tray_pos + torch.stack([rel0, rel1, rel2], -1)
    # omega_world for R = Ry(a) Rx(b): a_dot ey + Ry(a) (b_dot ex).
    a_dot, b_dot = -s.theta_dot[..., 0], s.theta_dot[..., 1]
    w0, w1, w2 = cx * b_dot, a_dot, -sx * b_dot
    vel = torch.stack([cx * vx + r01 * vy + (w1 * rel2 - w2 * rel1),
                       cy * vy + (w2 * rel0 - w0 * rel2),
                       -sx * vx + r21 * vy + (w0 * rel1 - w1 * rel0)], -1)
    return pos, vel


def off_tray(s: TrayObjectState) -> torch.Tensor:
    """Out-of-bounds flag (`rlmpc2.py:726-731` tray_limit check)."""
    return (torch.abs(s.p[..., 0]) > TRAY_LIMIT_X) | \
        (torch.abs(s.p[..., 1]) > TRAY_LIMIT_Y)


def contact_lost(s: TrayObjectState) -> torch.Tensor:
    """The object left the tray or tipped over its support edge (the
    reference's contact-loss event, `rlmpc2.py:734-736`)."""
    return off_tray(s) | s.toppled

"""Household-object presets: the reference object pack as parameter rows
(port of `dart_tpu.physics.object_presets`).

The reference ships ~57 extra object MJCFs (`PMPC/object_sim/<name>/`).
In the tray_object parameter space a scene is a parameter row: {mass,
footprint half-widths, COM height, rolling signature, rocking mask},
extracted from the reference's compiled models and kept in
`object_presets_data.py`. Round resting shapes roll on both axes, the
side-lying `<name>_side` cylinders roll across their section, everything
else slides and can rock or topple about its support axes.
"""

from __future__ import annotations

import torch

from dart_tpu_torch.physics.object_presets_data import PRESET_ROWS
from dart_tpu_torch.physics.tray_object import (CALIBRATED_BACK_GSS,
                                                CALIBRATED_BACK_W,
                                                CALIBRATED_ROLL_RESIST,
                                                CALIBRATED_SLIDE_DAMP,
                                                LEGACY_TRAY_LAG,
                                                TrayObjectParams,
                                                calibrated_lag,
                                                calibrated_roll_stick,
                                                calibrated_slide_damp)
from dart_tpu_torch.utils.device import resolve

# name -> (mass kg, half_w x, half_w y, h_com m,
#          kappa_inv_x, kappa_inv_y, topple_x, topple_y)
PRESETS = dict(PRESET_ROWS)
# The earlier name of the pack's "fryingpan".
PRESETS["pan"] = PRESETS["fryingpan"]


def make_preset_params(name: str, mu: float = 0.3,
                       tray_height: float = 0.4, slip_eps: float = 2e-3,
                       dtype=torch.float32, mass: float | None = None,
                       calibrated: bool = True,
                       device: torch.device | str = "cuda"
                       ) -> TrayObjectParams:
    """One lane's TrayObjectParams for a named pack preset (see PRESETS).

    ``calibrated`` (default) applies the MuJoCo-measured tray lag at the
    payload mass and transfers the tray-contact dissipation calibration:
    rollers get the sphere (both axes) or cylinder rolling resistance,
    sliders the cube's mu-faded tangential damping, and every preset the
    fitted backlash. False gives the undamped legacy plant. The per-axis
    fields are pairs, as `tray_object.make_params` makes them."""
    dev = resolve(device)
    m0, hx, hy, hcom, kx, ky, tx, ty = PRESETS[name]

    def a(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    def pair(x):
        return torch.broadcast_to(a(x), (2,)).clone()

    rolls = kx > 0 or ky > 0
    m_eff = mass if mass is not None else m0
    if calibrated:
        omega_n, zeta, lag_fast = calibrated_lag(m_eff, dtype, dev)
        rr = CALIBRATED_ROLL_RESIST["sphere" if ky > 0 else "cylinder"] \
            if rolls else 0.0
        sd = 0.0 if rolls else calibrated_slide_damp(
            CALIBRATED_SLIDE_DAMP["cube"], a(mu), dtype)
        rstick = calibrated_roll_stick(a([kx, ky]), a(mu), dtype)
        bw, bg = CALIBRATED_BACK_W, CALIBRATED_BACK_GSS
    else:
        (omega_n, zeta), lag_fast = LEGACY_TRAY_LAG, 0.0
        rr, sd, rstick, bw, bg = 0.0, 0.0, 0.0, 0.0, 1.0
    return TrayObjectParams(
        mass=a(m_eff), mu=a(mu), kappa_inv=a([kx, ky]),
        slip_eps=a(slip_eps), omega_n=pair(omega_n), zeta=pair(zeta),
        tray_pos=a([0.0, 0.0, tray_height]),
        half_w=a([hx, hy]), h_com=a(hcom), topple_on=a([tx, ty]),
        roll_resist=a(rr), slide_damp=a(sd), lag_fast=pair(lag_fast),
        roll_stick=pair(rstick), stick_vel=a(5e-3), back_w=pair(bw),
        back_gss=pair(bg))

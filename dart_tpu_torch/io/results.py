"""The reference's env naming convention (port of `dart_tpu.io.results`'s
`env_name` and `parse_env_name`): `<object>_<mass>_<friction>` with `x` as
the decimal separator, e.g. `sphere_0x2_0x1` (`results.py:9-19`)."""

from __future__ import annotations


def env_name(object_name: str, mass: float, friction: float) -> str:
    """`cube_1x0_0x05`-style naming (`results.py:16-19`)."""
    def fmt(v):
        return str(float(v)).replace(".", "x")

    return f"{object_name}_{fmt(mass)}_{fmt(friction)}"


def parse_env_name(name: str):
    obj, mass, fric = name.split("_", 2)

    def back(s):
        return float(s.replace("x", "."))

    return obj, back(mass), back(fric)

"""RawSpec: defaults-resolved robot/scene description (numpy only).

The port's own copy of quadruped_tpu/mjcf/spec.py, reduced to what the
port reads: the JSON loader.  The robots ship as RawSpec JSON under
assets/; the MJCF XML export stays with the JAX package.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from .model import Option


@dataclasses.dataclass
class RawSpec:
    opt: Option
    bodies: list[dict]
    joints: list[dict]
    geoms: list[dict]
    sites: list[dict]
    actuators: list[dict]
    keys: list[dict]

    @staticmethod
    def from_json(text: str) -> "RawSpec":
        p = json.loads(text)
        opt = Option(
            timestep=p["opt"]["timestep"],
            gravity=np.array(p["opt"]["gravity"]),
            impratio=p["opt"]["impratio"],
            cone=p["opt"]["cone"],
            iterations=p["opt"].get("iterations", 15),
            ls_iterations=p["opt"].get("ls_iterations", 8),
        )

        def arr(d, keys):
            out = dict(d)
            for k in keys:
                if k in out and isinstance(out[k], list):
                    out[k] = np.array(out[k], dtype=float)
            if "inertial" in out and out["inertial"]:
                out["inertial"] = arr(out["inertial"], ("pos", "quat", "diaginertia"))
            return out

        bkeys = ("pos", "quat")
        jkeys = (
            "pos", "axis", "range", "solreflimit", "solimplimit",
            "solreffriction", "solimpfriction",
        )
        gkeys = ("pos", "quat", "size", "friction", "solref", "solimp", "rgba")
        akeys = ("ctrlrange", "forcerange")
        return RawSpec(
            opt=opt,
            bodies=[arr(d, bkeys) for d in p["bodies"]],
            joints=[arr(d, jkeys) for d in p["joints"]],
            geoms=[arr(d, gkeys) for d in p["geoms"]],
            sites=[arr(d, ("pos",)) for d in p["sites"]],
            actuators=[arr(d, akeys) for d in p["actuators"]],
            keys=[arr(d, ("qpos", "ctrl")) for d in p["keys"]],
        )

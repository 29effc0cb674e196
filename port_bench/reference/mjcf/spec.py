"""RawSpec: defaults-resolved robot/scene description (numpy and stdlib).

The port's own copy of quadruped_tpu/mjcf/spec.py.  The parser resolves
MJCF default classes into plain per-element attribute dicts; RawSpec is
that resolved form.  It is the asset format of the port (shipped as JSON
under assets/), and exports back to minimal MJCF XML for two purposes:
  * building a `mujoco.MjModel` oracle in the parity tests
  * offline video rendering of logged trajectories (viz/render.py)

Both the JSON and the exported XML contain resolved numbers (no classes, no
includes), so a PhysicsModel compiled from either path is identical.
"""

from __future__ import annotations

import dataclasses
import json
from xml.etree import ElementTree as ET

import numpy as np

from .model import (
    ACT_MOTOR,
    ACT_POSITION,
    CONE_ELLIPTIC,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_PLANE,
    GEOM_SPHERE,
    JNT_FREE,
    JNT_HINGE,
    Option,
)

_GEOM_TYPE_NAMES = {
    GEOM_PLANE: "plane",
    GEOM_SPHERE: "sphere",
    GEOM_CAPSULE: "capsule",
    GEOM_CYLINDER: "cylinder",
    GEOM_BOX: "box",
}


@dataclasses.dataclass
class RawSpec:
    opt: Option
    bodies: list[dict]
    joints: list[dict]
    geoms: list[dict]
    sites: list[dict]
    actuators: list[dict]
    keys: list[dict]

    # ---- JSON round trip ----------------------------------------------------

    def to_json(self) -> str:
        def enc(o):
            if isinstance(o, np.ndarray):
                return o.tolist()
            if isinstance(o, (np.floating, np.integer)):
                return o.item()
            if isinstance(o, np.bool_):
                return bool(o)
            raise TypeError(type(o))

        payload = {
            "opt": {
                "timestep": self.opt.timestep,
                "gravity": self.opt.gravity.tolist(),
                "impratio": self.opt.impratio,
                "cone": self.opt.cone,
                "iterations": self.opt.iterations,
                "ls_iterations": self.opt.ls_iterations,
            },
            "bodies": self.bodies,
            "joints": self.joints,
            "geoms": self.geoms,
            "sites": self.sites,
            "actuators": self.actuators,
            "keys": self.keys,
        }
        return json.dumps(payload, default=enc, indent=1)

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

    # ---- minimal MJCF export (oracle + rendering) ---------------------------

    def to_xml(self) -> str:
        def fmt(v):
            a = np.asarray(v, dtype=float).ravel()
            return " ".join(f"{x:.17g}" for x in a)

        root = ET.Element("mujoco", model="qtpu")
        ET.SubElement(root, "compiler", angle="radian", autolimits="true")
        opt_attrs = dict(
            timestep=f"{self.opt.timestep:.17g}",
            gravity=fmt(self.opt.gravity),
            impratio=f"{self.opt.impratio:.17g}",
        )
        if self.opt.cone == CONE_ELLIPTIC:
            opt_attrs["cone"] = "elliptic"
        ET.SubElement(root, "option", **opt_attrs)

        elems = {0: ET.SubElement(root, "worldbody")}
        for i, bd in enumerate(self.bodies):
            if i == 0:
                continue
            parent = elems[bd["parent"]]
            e = ET.SubElement(
                parent, "body", name=bd["name"], pos=fmt(bd["pos"]),
                quat=fmt(bd["quat"]),
            )
            elems[i] = e
            if bd["inertial"] is not None:
                ine = bd["inertial"]
                ET.SubElement(
                    e, "inertial", pos=fmt(ine["pos"]), quat=fmt(ine["quat"]),
                    mass=f"{ine['mass']:.17g}",
                    diaginertia=fmt(ine["diaginertia"]),
                )
        for j in self.joints:
            e = elems[j["body"]]
            if j["type"] == JNT_FREE:
                ET.SubElement(e, "freejoint", name=j["name"])
            else:
                assert j["type"] == JNT_HINGE
                attrs = dict(
                    name=j["name"], type="hinge", pos=fmt(j["pos"]),
                    axis=fmt(j["axis"]), damping=f"{j['damping']:.17g}",
                    armature=f"{j['armature']:.17g}",
                    frictionloss=f"{j['frictionloss']:.17g}",
                    solreflimit=fmt(j["solreflimit"]),
                    solimplimit=fmt(j["solimplimit"]),
                    solreffriction=fmt(j["solreffriction"]),
                    solimpfriction=fmt(j["solimpfriction"]),
                )
                if j["limited"]:
                    attrs["range"] = fmt(j["range"])
                ET.SubElement(e, "joint", **attrs)
        for g in self.geoms:
            attrs = dict(
                type=_GEOM_TYPE_NAMES[g["type"]],
                pos=fmt(g["pos"]), quat=fmt(g["quat"]), size=fmt(g["size"]),
                contype=str(g["contype"]), conaffinity=str(g["conaffinity"]),
                condim=str(g["condim"]), priority=str(g["priority"]),
                friction=fmt(g["friction"]), solmix=f"{g['solmix']:.17g}",
                solref=fmt(g["solref"]), solimp=fmt(g["solimp"]),
                margin=f"{g['margin']:.17g}", gap=f"{g['gap']:.17g}",
                group=str(g["group"]), rgba=fmt(g["rgba"]),
            )
            if g["name"]:
                attrs["name"] = g["name"]
            ET.SubElement(elems[g["body"]], "geom", **attrs)
        for s in self.sites:
            ET.SubElement(
                elems[s["body"]], "site", name=s["name"], pos=fmt(s["pos"]),
                size="0.005",
            )
        act = ET.SubElement(root, "actuator")
        for a in self.actuators:
            if a["kind"] == ACT_MOTOR:
                ET.SubElement(
                    act, "motor", name=a["name"], joint=a["joint"],
                    gear=f"{a['gear']:.17g}", ctrlrange=fmt(a["ctrlrange"]),
                    ctrllimited="true" if a["ctrllimited"] else "false",
                )
            else:
                assert a["kind"] == ACT_POSITION
                ET.SubElement(
                    act, "position", name=a["name"], joint=a["joint"],
                    gear=f"{a['gear']:.17g}", kp=f"{a['kp']:.17g}",
                    kv=f"{a['kv']:.17g}", ctrlrange=fmt(a["ctrlrange"]),
                    forcerange=fmt(a["forcerange"]),
                )
        if self.keys:
            kf = ET.SubElement(root, "keyframe")
            for k in self.keys:
                attrs = dict(name=k["name"])
                if k.get("qpos") is not None:
                    attrs["qpos"] = fmt(k["qpos"])
                if k.get("ctrl") is not None:
                    attrs["ctrl"] = fmt(k["ctrl"])
                ET.SubElement(kf, "key", **attrs)
        return ET.tostring(root, encoding="unicode")

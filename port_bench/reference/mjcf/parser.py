"""Standalone MJCF parser -> compiled PhysicsModel (numpy and stdlib).

The port's own copy of quadruped_tpu/mjcf/parser.py.  Parses the MJCF
subset used by quadruped locomotion scenes: includes, default classes
(incl. childclass inheritance), worldbody tree, free/hinge joints,
plane/sphere/capsule/cylinder/box geoms (with fromto), sites,
motor/position actuators and keyframes.  Mesh geoms are parsed but
dropped at compile time (they are visual-only in the reference models;
all bodies carry explicit <inertial> blocks).  `compile_spec` turns the
resolved RawSpec into a PhysicsModel; `tests/test_torch_mjcf.py` holds
the result against the JAX package's parser and against `mujoco.MjModel`
built from the same XML.
"""

from __future__ import annotations

import copy
import math
import os
import xml.etree.ElementTree as ET

import numpy as np

from .model import (
    ACT_MOTOR,
    ACT_POSITION,
    CONE_ELLIPTIC,
    CONE_PYRAMIDAL,
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_CYLINDER,
    GEOM_MESH,
    GEOM_PLANE,
    GEOM_SPHERE,
    JNT_FREE,
    JNT_HINGE,
    Option,
    PhysicsModel,
)

_JNT_NQ = {JNT_FREE: 7, JNT_HINGE: 1}
_JNT_NV = {JNT_FREE: 6, JNT_HINGE: 1}

_GEOM_TYPES = {
    "plane": GEOM_PLANE,
    "sphere": GEOM_SPHERE,
    "capsule": GEOM_CAPSULE,
    "cylinder": GEOM_CYLINDER,
    "box": GEOM_BOX,
    "mesh": GEOM_MESH,
}

# defaults per MJCF schema (MuJoCo 3.x)
_GEOM_DEFAULTS = {
    "type": "sphere",
    "contype": "1",
    "conaffinity": "1",
    "condim": "3",
    "group": "0",
    "priority": "0",
    "size": "0 0 0",
    "friction": "1 0.005 0.0001",
    "solmix": "1",
    "solref": "0.02 1",
    "solimp": "0.9 0.95 0.001 0.5 2",
    "margin": "0",
    "gap": "0",
    "pos": "0 0 0",
    "quat": "1 0 0 0",
    "rgba": "0.5 0.5 0.5 1",
}
_JOINT_DEFAULTS = {
    "type": "hinge",
    "pos": "0 0 0",
    "axis": "0 0 1",
    "damping": "0",
    "armature": "0",
    "frictionloss": "0",
    "solreflimit": "0.02 1",
    "solimplimit": "0.9 0.95 0.001 0.5 2",
    "solreffriction": "0.02 1",
    "solimpfriction": "0.9 0.95 0.001 0.5 2",
    "margin": "0",
}
_SITE_DEFAULTS = {"pos": "0 0 0"}
_MOTOR_DEFAULTS = {"gear": "1", "ctrlrange": "0 0", "forcerange": "0 0"}
_POSITION_DEFAULTS = {
    "gear": "1",
    "kp": "1",
    "kv": "0",
    "ctrlrange": "0 0",
    "forcerange": "0 0",
}


def _floats(s: str) -> np.ndarray:
    return np.array([float(x) for x in s.split()])


def _pad(s: str, defaults: str) -> np.ndarray:
    """MJCF partial-attribute semantics: missing trailing values keep their
    schema defaults (e.g. friction="0.6" -> (0.6, 0.005, 0.0001))."""
    out = _floats(defaults)
    v = _floats(s)
    out[: len(v)] = v
    return out


class _Defaults:
    """MJCF default class tree: class name -> {tag: {attr: value}} with
    parent chaining."""

    def __init__(self):
        self.classes: dict[str, dict[str, dict[str, str]]] = {"main": {}}
        self.parent: dict[str, str | None] = {"main": None}

    def add(self, elem: ET.Element, parent_class: str = "main"):
        name = elem.get("class", "main" if parent_class == "main" else None)
        if name is None:
            raise ValueError("nested default element requires class attr")
        if name not in self.classes:
            self.classes[name] = {}
            self.parent[name] = parent_class if name != "main" else None
        for child in elem:
            if child.tag == "default":
                self.add(child, parent_class=name)
            else:
                d = self.classes[name].setdefault(child.tag, {})
                d.update(child.attrib)

    def resolve(self, tag: str, cls: str) -> dict[str, str]:
        """Attributes for `tag` with class `cls`, innermost wins."""
        chain = []
        c: str | None = cls
        while c is not None:
            chain.append(c)
            c = self.parent.get(c)
        out: dict[str, str] = {}
        for c in reversed(chain):  # root first, innermost last
            out.update(self.classes.get(c, {}).get(tag, {}))
        return out


def _attr(elem: ET.Element, defaults: _Defaults, cls: str, tag: str | None = None):
    """Resolved attribute dict: schema defaults <- class defaults <- element."""
    tag = tag or elem.tag
    merged = defaults.resolve(tag, elem.get("class", cls))
    merged.update(elem.attrib)
    return merged


def load_mjcf(path: str) -> ET.Element:
    """Parse an MJCF file, splicing <include> elements."""
    tree = ET.parse(path)
    root = tree.getroot()
    base = os.path.dirname(os.path.abspath(path))
    _splice_includes(root, base)
    return root


def load_mjcf_string(xml: str, base: str = ".") -> ET.Element:
    root = ET.fromstring(xml)
    _splice_includes(root, base)
    return root


def _splice_includes(elem: ET.Element, base: str):
    i = 0
    while i < len(elem):
        child = elem[i]
        if child.tag == "include":
            inc = ET.parse(os.path.join(base, child.get("file"))).getroot()
            del elem[i]
            # merge top-level sections of the included <mujoco> element
            for section in inc:
                elem.insert(i, section)
                i += 1
        else:
            _splice_includes(child, base)
            i += 1


class _Builder:
    def __init__(self, defaults: _Defaults):
        self.defaults = defaults
        self.bodies: list[dict] = []
        self.joints: list[dict] = []
        self.geoms: list[dict] = []
        self.sites: list[dict] = []
        self.actuators: list[dict] = []
        self.keys: list[dict] = []

    # ---- worldbody recursion ----------------------------------------------

    def add_world(self):
        self.bodies.append(
            dict(
                name="world",
                parent=-1,
                pos=np.zeros(3),
                quat=np.array([1.0, 0, 0, 0]),
                inertial=None,
            )
        )

    def parse_body(self, elem: ET.Element, parent_id: int, cls: str):
        body_id = len(self.bodies)
        cls = elem.get("childclass", cls)
        a = elem.attrib
        body = dict(
            name=a.get("name", f"body{body_id}"),
            parent=parent_id,
            pos=_floats(a.get("pos", "0 0 0")),
            quat=self._orient(a),
            inertial=None,
        )
        self.bodies.append(body)
        self.parse_body_children(elem, body_id, cls)

    def parse_body_children(self, elem: ET.Element, body_id: int, cls: str):
        body = self.bodies[body_id]
        for child in elem:
            if child.tag == "inertial":
                body["inertial"] = dict(
                    pos=_floats(child.get("pos", "0 0 0")),
                    quat=self._orient(child.attrib),
                    mass=float(child.get("mass")),
                    diaginertia=_floats(child.get("diaginertia", "0 0 0")),
                )
            elif child.tag in ("joint", "freejoint"):
                self._parse_joint(child, body_id, cls)
            elif child.tag == "geom":
                self._parse_geom(child, body_id, cls)
            elif child.tag == "site":
                a = _attr(child, self.defaults, cls)
                self.sites.append(
                    dict(
                        name=a.get("name", f"site{len(self.sites)}"),
                        body=body_id,
                        pos=_floats(a.get("pos", "0 0 0")),
                    )
                )
            elif child.tag == "body":
                self.parse_body(child, body_id, cls)
            # cameras / lights are rendering-only: ignored

    def _orient(self, a: dict) -> np.ndarray:
        if "quat" in a:
            q = _floats(a["quat"])
            return q / np.linalg.norm(q)
        if "euler" in a:  # radian (compiler angle="radian")
            r, p, y = _floats(a["euler"])
            qs = []
            for ang, ax in ((r, [1, 0, 0]), (p, [0, 1, 0]), (y, [0, 0, 1])):
                qs.append(
                    np.concatenate(
                        [[math.cos(ang / 2)], np.array(ax) * math.sin(ang / 2)]
                    )
                )
            q = qs[0]
            for qq in qs[1:]:
                q = _quat_mul_np(q, qq)
            return q
        if "axisangle" in a:
            v = _floats(a["axisangle"])
            ax, ang = v[:3] / np.linalg.norm(v[:3]), v[3]
            return np.concatenate([[math.cos(ang / 2)], ax * math.sin(ang / 2)])
        return np.array([1.0, 0, 0, 0])

    def _parse_joint(self, elem: ET.Element, body_id: int, cls: str):
        if elem.tag == "freejoint":
            self.joints.append(
                dict(
                    name=elem.get("name", f"joint{len(self.joints)}"),
                    body=body_id,
                    type=JNT_FREE,
                    pos=np.zeros(3),
                    axis=np.array([0.0, 0, 1]),
                    range=np.zeros(2),
                    limited=False,
                    damping=0.0,
                    armature=0.0,
                    frictionloss=0.0,
                    solreflimit=_floats("0.02 1"),
                    solimplimit=_floats("0.9 0.95 0.001 0.5 2"),
                    solreffriction=_floats("0.02 1"),
                    solimpfriction=_floats("0.9 0.95 0.001 0.5 2"),
                    margin=0.0,
                )
            )
            return
        a = dict(_JOINT_DEFAULTS)
        a.update(_attr(elem, self.defaults, cls))
        jtype = {"hinge": JNT_HINGE, "free": JNT_FREE}[a["type"]]
        limited = "range" in a and a.get("limited", "auto") != "false"
        self.joints.append(
            dict(
                name=a.get("name", f"joint{len(self.joints)}"),
                body=body_id,
                type=jtype,
                pos=_floats(a["pos"]),
                axis=_floats(a["axis"]),
                range=_floats(a["range"]) if "range" in a else np.zeros(2),
                limited=limited,
                damping=float(a["damping"]),
                armature=float(a["armature"]),
                frictionloss=float(a["frictionloss"]),
                solreflimit=_floats(a["solreflimit"]),
                solimplimit=_floats(a["solimplimit"]),
                solreffriction=_floats(a["solreffriction"]),
                solimpfriction=_floats(a["solimpfriction"]),
                margin=float(a["margin"]),
            )
        )

    def _parse_geom(self, elem: ET.Element, body_id: int, cls: str):
        a = dict(_GEOM_DEFAULTS)
        a.update(_attr(elem, self.defaults, cls))
        gtype = _GEOM_TYPES[a["type"]]
        size = np.zeros(3)
        sz = _floats(a["size"])
        size[: len(sz)] = sz
        pos = _floats(a["pos"])
        quat = self._orient(a)
        if "fromto" in a:
            ft = _floats(a["fromto"])
            p0, p1 = ft[:3], ft[3:]
            pos = 0.5 * (p0 + p1)
            d = p1 - p0
            length = np.linalg.norm(d)
            quat = _quat_z_to_np(d / length)
            size[1] = 0.5 * length
        self.geoms.append(
            dict(
                name=a.get("name", ""),
                body=body_id,
                type=gtype,
                pos=pos,
                quat=quat,
                size=size,
                contype=int(a["contype"]),
                conaffinity=int(a["conaffinity"]),
                condim=int(a["condim"]),
                group=int(a["group"]),
                priority=int(a["priority"]),
                friction=_pad(a["friction"], _GEOM_DEFAULTS["friction"]),
                solmix=float(a["solmix"]),
                solref=_pad(a["solref"], _GEOM_DEFAULTS["solref"]),
                solimp=_pad(a["solimp"], _GEOM_DEFAULTS["solimp"]),
                margin=float(a["margin"]),
                gap=float(a["gap"]),
                rgba=_floats(a["rgba"]),
            )
        )

    # ---- actuators / keyframes --------------------------------------------

    def parse_actuator(self, elem: ET.Element, cls: str):
        for child in elem:
            if child.tag == "motor":
                a = dict(_MOTOR_DEFAULTS)
                a.update(_attr(child, self.defaults, cls))
                self.actuators.append(
                    dict(
                        name=a.get("name", f"act{len(self.actuators)}"),
                        kind=ACT_MOTOR,
                        joint=a["joint"],
                        gear=float(a["gear"].split()[0]),
                        kp=0.0,
                        kv=0.0,
                        ctrlrange=_floats(a["ctrlrange"]),
                        forcerange=_floats(a["forcerange"]),
                        ctrllimited="ctrlrange" in a,
                        forcelimited=not np.allclose(_floats(a["forcerange"]), 0),
                    )
                )
            elif child.tag == "position":
                a = dict(_POSITION_DEFAULTS)
                a.update(_attr(child, self.defaults, cls))
                self.actuators.append(
                    dict(
                        name=a.get("name", f"act{len(self.actuators)}"),
                        kind=ACT_POSITION,
                        joint=a["joint"],
                        gear=float(a["gear"].split()[0]),
                        kp=float(a["kp"]),
                        kv=float(a["kv"]),
                        ctrlrange=_floats(a["ctrlrange"]),
                        forcerange=_floats(a["forcerange"]),
                        ctrllimited="ctrlrange" in a,
                        forcelimited=not np.allclose(_floats(a["forcerange"]), 0),
                    )
                )

    def parse_keyframe(self, elem: ET.Element):
        for child in elem:
            if child.tag == "key":
                self.keys.append(
                    dict(
                        name=child.get("name", f"key{len(self.keys)}"),
                        qpos=_floats(child.get("qpos")) if child.get("qpos") else None,
                        ctrl=_floats(child.get("ctrl")) if child.get("ctrl") else None,
                    )
                )


def _quat_mul_np(u, v):
    w1, x1, y1, z1 = u
    w2, x2, y2, z2 = v
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _quat_z_to_np(v):
    z = np.array([0.0, 0.0, 1.0])
    c = float(np.dot(z, v))
    ax = np.cross(z, v)
    s = float(np.linalg.norm(ax))
    if s < 1e-12:
        if c > 0:
            return np.array([1.0, 0, 0, 0])
        return np.array([0.0, 1, 0, 0])
    axis = ax / s
    ang = math.atan2(s, c)
    return np.concatenate([[math.cos(ang / 2)], axis * math.sin(ang / 2)])


def parse_raw(root: ET.Element) -> "RawSpec":
    """Parse an MJCF element tree into a defaults-resolved RawSpec."""
    from .spec import RawSpec

    defaults = _Defaults()
    for d in root.findall("default"):
        defaults.add(d)

    opt = Option()
    oe = root.find("option")
    if oe is not None:
        opt.timestep = float(oe.get("timestep", opt.timestep))
        if oe.get("gravity"):
            opt.gravity = _floats(oe.get("gravity"))
        opt.impratio = float(oe.get("impratio", opt.impratio))
        opt.cone = (
            CONE_ELLIPTIC if oe.get("cone", "pyramidal") == "elliptic"
            else CONE_PYRAMIDAL
        )
        opt.iterations = int(oe.get("iterations", opt.iterations))

    b = _Builder(defaults)
    wbs = root.findall("worldbody")
    if not wbs:
        raise ValueError("MJCF has no worldbody")
    b.add_world()
    # multiple worldbody sections appear after <include> splicing; MuJoCo
    # merges them all into the single world body
    for wb in wbs:
        b.parse_body_children(wb, 0, wb.get("childclass", "main"))
    for ae in root.findall("actuator"):
        b.parse_actuator(ae, "main")
    for ke in root.findall("keyframe"):
        b.parse_keyframe(ke)

    # drop mesh geoms (visual-only; bodies have explicit inertials)
    geoms = [g for g in b.geoms if g["type"] != GEOM_MESH]
    # MjModel groups geoms/sites by body id (stable within a body); match
    # that ordering so indices line up with the mujoco oracle
    geoms.sort(key=lambda g: g["body"])
    sites = sorted(b.sites, key=lambda s: s["body"])
    # joints too, as MjModel orders them: a body's joints come before its
    # descendants' even where the XML lists them after the child bodies,
    # as RawSpec.to_xml writes them (the JAX package's parser keeps
    # document order there, so its parse of an exported scene permutes
    # the joints; ROADMAP.md queue 3)
    joints = sorted(b.joints, key=lambda j: j["body"])
    return RawSpec(
        opt=opt, bodies=b.bodies, joints=joints, geoms=geoms,
        sites=sites, actuators=b.actuators, keys=b.keys,
    )


def parse(root: ET.Element) -> PhysicsModel:
    """Compile an MJCF element tree into a PhysicsModel."""
    return compile_spec(parse_raw(root))


def parse_file(path: str) -> PhysicsModel:
    return parse(load_mjcf(path))


def parse_string(xml: str, base: str = ".") -> PhysicsModel:
    return parse(load_mjcf_string(xml, base))


def compile_spec(spec) -> PhysicsModel:
    opt, b, geoms = spec.opt, spec, spec.geoms

    nbody = len(b.bodies)
    njnt = len(b.joints)
    ngeom = len(geoms)
    nsite = len(b.sites)
    nu = len(b.actuators)
    nkey = len(b.keys)

    # joint addressing (document order == body order already)
    jnt_qposadr = np.zeros(njnt, dtype=np.int32)
    jnt_dofadr = np.zeros(njnt, dtype=np.int32)
    nq = nv = 0
    for i, j in enumerate(b.joints):
        jnt_qposadr[i] = nq
        jnt_dofadr[i] = nv
        nq += _JNT_NQ[j["type"]]
        nv += _JNT_NV[j["type"]]

    body_parentid = np.array([bd["parent"] for bd in b.bodies], dtype=np.int32)
    body_parentid[0] = 0  # MuJoCo convention: world's parent is itself
    body_rootid = np.zeros(nbody, dtype=np.int32)
    for i in range(1, nbody):
        p = body_parentid[i]
        body_rootid[i] = i if p == 0 else body_rootid[p]

    body_jntadr = np.full(nbody, -1, dtype=np.int32)
    body_jntnum = np.zeros(nbody, dtype=np.int32)
    body_dofadr = np.full(nbody, -1, dtype=np.int32)
    body_dofnum = np.zeros(nbody, dtype=np.int32)
    for i, j in enumerate(b.joints):
        bid = j["body"]
        if body_jntadr[bid] < 0:
            body_jntadr[bid] = i
            body_dofadr[bid] = jnt_dofadr[i]
        body_jntnum[bid] += 1
        body_dofnum[bid] += _JNT_NV[j["type"]]

    def _stack(dicts, key, default):
        if not dicts:
            return np.zeros((0,) + np.shape(default))
        return np.stack([np.asarray(d.get(key, default), dtype=float) for d in dicts])

    body_ipos = np.zeros((nbody, 3))
    body_iquat = np.tile(np.array([1.0, 0, 0, 0]), (nbody, 1))
    body_mass = np.zeros(nbody)
    body_inertia = np.zeros((nbody, 3))
    for i, bd in enumerate(b.bodies):
        if bd["inertial"] is not None:
            body_ipos[i] = bd["inertial"]["pos"]
            body_iquat[i] = bd["inertial"]["quat"]
            body_mass[i] = bd["inertial"]["mass"]
            body_inertia[i] = bd["inertial"]["diaginertia"]

    dof_bodyid = np.zeros(nv, dtype=np.int32)
    dof_jntid = np.zeros(nv, dtype=np.int32)
    dof_armature = np.zeros(nv)
    dof_damping = np.zeros(nv)
    dof_frictionloss = np.zeros(nv)
    dof_solref = np.tile(np.array([0.02, 1.0]), (nv, 1))
    dof_solimp = np.tile(np.array([0.9, 0.95, 0.001, 0.5, 2.0]), (nv, 1))
    for i, j in enumerate(b.joints):
        adr, n = jnt_dofadr[i], _JNT_NV[j["type"]]
        dof_bodyid[adr : adr + n] = j["body"]
        dof_jntid[adr : adr + n] = i
        dof_armature[adr : adr + n] = j["armature"]
        dof_damping[adr : adr + n] = j["damping"]
        dof_frictionloss[adr : adr + n] = j["frictionloss"]
        dof_solref[adr : adr + n] = j["solreffriction"]
        dof_solimp[adr : adr + n] = j["solimpfriction"]

    jname2id = {j["name"]: i for i, j in enumerate(b.joints)}

    key_qpos = np.zeros((nkey, nq))
    key_ctrl = np.zeros((nkey, nu))
    for i, k in enumerate(b.keys):
        if k["qpos"] is not None:
            key_qpos[i] = k["qpos"]
        if k["ctrl"] is not None:
            key_ctrl[i] = k["ctrl"]

    return PhysicsModel(
        opt=opt,
        nq=nq,
        nv=nv,
        nu=nu,
        nbody=nbody,
        njnt=njnt,
        ngeom=ngeom,
        nsite=nsite,
        nkey=nkey,
        body_parentid=body_parentid,
        body_rootid=body_rootid,
        body_jntadr=body_jntadr,
        body_jntnum=body_jntnum,
        body_dofadr=body_dofadr,
        body_dofnum=body_dofnum,
        body_pos=_stack(b.bodies, "pos", np.zeros(3)),
        body_quat=_stack(b.bodies, "quat", np.array([1.0, 0, 0, 0])),
        body_ipos=body_ipos,
        body_iquat=body_iquat,
        body_mass=body_mass,
        body_inertia=body_inertia,
        jnt_type=np.array([j["type"] for j in b.joints], dtype=np.int32),
        jnt_bodyid=np.array([j["body"] for j in b.joints], dtype=np.int32),
        jnt_qposadr=jnt_qposadr,
        jnt_dofadr=jnt_dofadr,
        jnt_pos=_stack(b.joints, "pos", np.zeros(3)),
        jnt_axis=_stack(b.joints, "axis", np.array([0.0, 0, 1])),
        jnt_range=_stack(b.joints, "range", np.zeros(2)),
        jnt_limited=np.array([j["limited"] for j in b.joints], dtype=bool),
        jnt_solref=_stack(b.joints, "solreflimit", np.array([0.02, 1.0])),
        jnt_solimp=_stack(
            b.joints, "solimplimit", np.array([0.9, 0.95, 0.001, 0.5, 2.0])
        ),
        jnt_margin=np.array([j["margin"] for j in b.joints]),
        dof_bodyid=dof_bodyid,
        dof_jntid=dof_jntid,
        dof_armature=dof_armature,
        dof_damping=dof_damping,
        dof_frictionloss=dof_frictionloss,
        dof_solref=dof_solref,
        dof_solimp=dof_solimp,
        geom_type=np.array([g["type"] for g in geoms], dtype=np.int32),
        geom_bodyid=np.array([g["body"] for g in geoms], dtype=np.int32),
        geom_pos=_stack(geoms, "pos", np.zeros(3)),
        geom_quat=_stack(geoms, "quat", np.array([1.0, 0, 0, 0])),
        geom_size=_stack(geoms, "size", np.zeros(3)),
        geom_contype=np.array([g["contype"] for g in geoms], dtype=np.int32),
        geom_conaffinity=np.array([g["conaffinity"] for g in geoms], dtype=np.int32),
        geom_condim=np.array([g["condim"] for g in geoms], dtype=np.int32),
        geom_priority=np.array([g["priority"] for g in geoms], dtype=np.int32),
        geom_friction=_stack(geoms, "friction", np.array([1.0, 0.005, 0.0001])),
        geom_solmix=np.array([g["solmix"] for g in geoms]),
        geom_solref=_stack(geoms, "solref", np.array([0.02, 1.0])),
        geom_solimp=_stack(
            geoms, "solimp", np.array([0.9, 0.95, 0.001, 0.5, 2.0])
        ),
        geom_margin=np.array([g["margin"] for g in geoms]),
        geom_gap=np.array([g["gap"] for g in geoms]),
        geom_group=np.array([g["group"] for g in geoms], dtype=np.int32),
        geom_rgba=_stack(geoms, "rgba", np.array([0.5, 0.5, 0.5, 1.0])),
        site_bodyid=np.array([s["body"] for s in b.sites], dtype=np.int32),
        site_pos=_stack(b.sites, "pos", np.zeros(3)),
        actuator_kind=np.array([a["kind"] for a in b.actuators], dtype=np.int32),
        actuator_trnid=np.array(
            [jname2id[a["joint"]] for a in b.actuators], dtype=np.int32
        ),
        actuator_gear=np.array([a["gear"] for a in b.actuators]),
        actuator_kp=np.array([a["kp"] for a in b.actuators]),
        actuator_kv=np.array([a["kv"] for a in b.actuators]),
        actuator_ctrlrange=_stack(b.actuators, "ctrlrange", np.zeros(2)),
        actuator_forcerange=_stack(b.actuators, "forcerange", np.zeros(2)),
        actuator_ctrllimited=np.array(
            [a["ctrllimited"] for a in b.actuators], dtype=bool
        ),
        actuator_forcelimited=np.array(
            [a["forcelimited"] for a in b.actuators], dtype=bool
        ),
        key_qpos=key_qpos,
        key_ctrl=key_ctrl,
        body_names=[bd["name"] for bd in b.bodies],
        joint_names=[j["name"] for j in b.joints],
        geom_names=[g["name"] for g in geoms],
        site_names=[s["name"] for s in b.sites],
        actuator_names=[a["name"] for a in b.actuators],
        key_names=[k["name"] for k in b.keys],
    )

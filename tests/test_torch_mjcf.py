"""The port's MJCF front end held against the JAX package's and against
mujoco's compiler, on the CPU.

On the four bundled scenes (go1 and go2, torque motors and position
servos): `RawSpec.to_xml` and `to_json` as strings equal to the
reference's; `parse_string(robot_xml(...))` equal, array by array, to the
port's bundled model and to the reference's parse of the same XML; and
the parsed model against `mujoco.MjModel.from_xml_string` of that XML
with the checks of tests/test_mjcf.py (sizes, option, bodies, joints and
dofs, geoms, actuators, keyframe).  Then an `<include>` splice from a
temporary directory, and default classes with childclass inheritance.
"""

import dataclasses
import xml.etree.ElementTree as ET

import mujoco
import numpy as np
import pytest

from quadruped_tpu.assets import robot_spec as jax_robot_spec
from quadruped_tpu.mjcf import compile_spec as jax_compile_spec
from quadruped_tpu.mjcf import load_mjcf_string as jax_load_mjcf_string
from quadruped_tpu.mjcf import parse_raw as jax_parse_raw
from quadruped_tpu.mjcf import parse_string as jax_parse_string
from quadruped_tpu_torch.assets import (
    go1_model,
    go1_spec,
    go1_xml,
    robot_model,
    robot_spec,
    robot_xml,
)
from quadruped_tpu_torch.mjcf import (
    PhysicsModel,
    load_mjcf,
    parse_file,
    parse_raw,
    parse_string,
)
from quadruped_tpu_torch.mjcf.model import ACT_MOTOR, ACT_POSITION, CONE_ELLIPTIC

SCENES = ["go1-torque", "go1-position", "go2-torque", "go2-position"]


def _split(scene):
    return scene.split("-")


def _same_model(a: PhysicsModel, b: PhysicsModel, skip_opt=(), atol=0.0):
    """Every field of two compiled models equal: arrays exactly (float
    arrays within `atol`), the option's fields (but `skip_opt`), name
    lists."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) and atol and x.dtype.kind == "f":
            np.testing.assert_allclose(x, np.asarray(y), atol=atol, rtol=0,
                                       err_msg=f.name)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, np.asarray(y), err_msg=f.name)
        elif dataclasses.is_dataclass(x):
            for g in dataclasses.fields(x):
                if g.name not in skip_opt:
                    np.testing.assert_array_equal(
                        getattr(x, g.name), getattr(y, g.name),
                        err_msg=f"{f.name}.{g.name}")
        else:
            assert x == y, f.name


def _jax_parse_body_order(xml):
    """The JAX package's parse of `xml` with its joints in body order, as
    MjModel orders them: its own parse_raw, the joints sorted by body
    (stable), its own compile_spec.  Its parse_string keeps the joints
    in document order, and RawSpec.to_xml writes a body's joints after
    its child bodies, so on an exported scene its joint order is a
    descendants-first permutation of mujoco's (ROADMAP.md queue 3)."""
    spec = jax_parse_raw(jax_load_mjcf_string(xml))
    spec.joints.sort(key=lambda j: j["body"])
    return jax_compile_spec(spec)


@pytest.mark.parametrize("scene", SCENES)
def test_to_xml_matches_reference(scene):
    robot, ctrl = _split(scene)
    assert robot_spec(robot, ctrl).to_xml() == jax_robot_spec(robot, ctrl).to_xml()
    assert robot_xml(robot, ctrl) == robot_spec(robot, ctrl).to_xml()


@pytest.mark.parametrize("scene", SCENES)
def test_to_json_matches_reference(scene):
    """The JSON round trip: equal to the reference's string, and loading
    it back gives the same JSON."""
    robot, ctrl = _split(scene)
    text = robot_spec(robot, ctrl).to_json()
    assert text == jax_robot_spec(robot, ctrl).to_json()
    assert type(robot_spec()).from_json(text).to_json() == text


@pytest.mark.parametrize("scene", SCENES)
def test_parse_string_matches_bundled_and_reference(scene):
    """The parse of the exported scene equals the bundled model in every
    array (floats to 1e-12: the parser normalizes quaternions again, a
    float64 rounding) and option field but the solver iterations, which
    the exported XML does not carry (both parsers then take Option's
    default), and
    equals the JAX package's parse with its joints in body order; the
    JAX package's own parse_string differs from it only in the joints'
    order."""
    robot, ctrl = _split(scene)
    xml = robot_xml(robot, ctrl)
    m = parse_string(xml)
    _same_model(m, robot_model(robot, ctrl), skip_opt=("iterations",), atol=1e-12)
    _same_model(m, _jax_parse_body_order(xml))
    j = jax_parse_string(xml)
    assert j.opt.iterations == m.opt.iterations == 10
    assert sorted(j.jnt_bodyid.tolist()) == m.jnt_bodyid.tolist() == list(range(1, 14))
    assert j.jnt_bodyid.tolist() != m.jnt_bodyid.tolist()


def test_go1_helpers():
    assert go1_xml("position") == robot_xml("go1", "position")
    assert go1_spec().to_json() == robot_spec("go1", "torque").to_json()
    _same_model(go1_model("position"), robot_model("go1", "position"))


def test_include_splice(tmp_path):
    """A scene split over files: the worldbody and actuators in robot.xml,
    included by scene.xml, which keeps the compiler, option and keyframe.
    parse_file splices the include and compiles the same model as the
    whole XML; load_mjcf leaves no <include> in the tree."""
    xml = robot_xml("go1", "torque")
    root = ET.fromstring(xml)
    inc = ET.Element("mujoco", model="robot")
    for tag in ("worldbody", "actuator"):
        e = root.find(tag)
        root.remove(e)
        inc.append(e)
    pos = list(root).index(root.find("keyframe"))
    root.insert(pos, ET.Element("include", file="robot.xml"))
    (tmp_path / "robot.xml").write_text(ET.tostring(inc, encoding="unicode"))
    (tmp_path / "scene.xml").write_text(ET.tostring(root, encoding="unicode"))
    assert load_mjcf(str(tmp_path / "scene.xml")).find("include") is None
    _same_model(parse_file(str(tmp_path / "scene.xml")), parse_string(xml))
    _same_model(parse_file(str(tmp_path / "scene.xml")), robot_model("go1", "torque"),
                skip_opt=("iterations",), atol=1e-12)


DEFAULTS_XML = """
<mujoco model="classes">
  <compiler angle="radian"/>
  <option timestep="0.004" impratio="10" cone="elliptic"/>
  <default>
    <geom friction="0.6" condim="3"/>
    <default class="leg">
      <joint damping="0.5" range="-1 1" armature="0.01"/>
      <geom type="capsule" size="0.02" rgba="1 0 0 1"/>
      <default class="foot">
        <geom type="sphere" size="0.03" condim="6" priority="1"/>
      </default>
    </default>
  </default>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 0.05"/>
    <body name="base" pos="0 0 0.4">
      <freejoint name="root"/>
      <inertial pos="0 0 0" mass="2" diaginertia="0.01 0.02 0.03"/>
      <geom type="box" size="0.1 0.05 0.03"/>
      <body name="thigh" pos="0.1 0 0" childclass="leg">
        <inertial pos="0 0 -0.05" mass="0.3" diaginertia="1e-3 1e-3 1e-4"/>
        <joint name="hip" axis="0 1 0"/>
        <geom fromto="0 0 0 0 0 -0.1"/>
        <geom class="foot" pos="0 0 -0.1"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <motor name="hip" joint="hip" gear="20" ctrlrange="-1 1"/>
  </actuator>
</mujoco>
"""


def test_default_classes_match_reference_and_mujoco():
    """Default classes, nested classes, childclass inheritance, partial
    attributes (friction="0.6"), fromto capsules: the port's parse equals
    the reference's and mujoco's compiled arrays."""
    m = parse_string(DEFAULTS_XML)
    _same_model(m, jax_parse_string(DEFAULTS_XML))
    mj = mujoco.MjModel.from_xml_string(DEFAULTS_XML)
    assert (m.nbody, m.njnt, m.ngeom, m.nu) == (mj.nbody, mj.njnt, mj.ngeom, mj.nu)
    np.testing.assert_array_equal(m.geom_type, mj.geom_type)
    np.testing.assert_array_equal(m.geom_condim, mj.geom_condim)
    np.testing.assert_array_equal(m.geom_priority, mj.geom_priority)
    np.testing.assert_allclose(m.geom_size, mj.geom_size, atol=1e-12)
    np.testing.assert_allclose(m.geom_pos, mj.geom_pos, atol=1e-12)
    np.testing.assert_allclose(m.geom_friction, mj.geom_friction)
    np.testing.assert_allclose(m.dof_damping, mj.dof_damping)
    np.testing.assert_allclose(m.dof_armature, mj.dof_armature)
    np.testing.assert_allclose(m.jnt_range, mj.jnt_range)
    np.testing.assert_allclose(m.opt.timestep, mj.opt.timestep)
    raw = parse_raw(ET.fromstring(DEFAULTS_XML))
    assert [g["condim"] for g in raw.geoms] == [3, 3, 3, 6]


# ---- the parsed model against mujoco's compiler (tests/test_mjcf.py) -------

@pytest.fixture(scope="module", params=SCENES)
def pair(request):
    robot, ctrl = _split(request.param)
    xml = robot_xml(robot, ctrl)
    return parse_string(xml), mujoco.MjModel.from_xml_string(xml), ctrl, robot


def test_sizes(pair):
    m, mj, _ctrl, _robot = pair
    assert m.nq == mj.nq == 19
    assert m.nv == mj.nv == 18
    assert m.nu == mj.nu == 12
    assert m.nbody == mj.nbody == 14
    assert m.njnt == mj.njnt == 13
    assert m.ngeom == mj.ngeom
    assert m.nkey == mj.nkey == 1


def test_option(pair):
    m, mj, _ctrl, _robot = pair
    assert m.opt.timestep == mj.opt.timestep
    assert m.opt.impratio == mj.opt.impratio == 100.0
    assert m.opt.cone == CONE_ELLIPTIC == mj.opt.cone
    np.testing.assert_allclose(m.opt.gravity, mj.opt.gravity)


def test_bodies(pair):
    m, mj, _ctrl, _robot = pair
    np.testing.assert_array_equal(m.body_parentid, mj.body_parentid)
    np.testing.assert_array_equal(m.body_rootid, mj.body_rootid)
    np.testing.assert_array_equal(m.body_jntadr, mj.body_jntadr)
    np.testing.assert_array_equal(m.body_jntnum, mj.body_jntnum)
    np.testing.assert_array_equal(m.body_dofadr, mj.body_dofadr)
    np.testing.assert_array_equal(m.body_dofnum, mj.body_dofnum)
    np.testing.assert_allclose(m.body_pos, mj.body_pos, atol=1e-12)
    np.testing.assert_allclose(m.body_quat, mj.body_quat, atol=1e-9)
    np.testing.assert_allclose(m.body_ipos, mj.body_ipos, atol=1e-12)
    np.testing.assert_allclose(m.body_iquat, mj.body_iquat, atol=1e-9)
    np.testing.assert_allclose(m.body_mass, mj.body_mass, atol=1e-12)
    np.testing.assert_allclose(m.body_inertia, mj.body_inertia, atol=1e-12)
    trunk = m.name2id("body", "trunk")
    assert mujoco.mj_name2id(mj, mujoco.mjtObj.mjOBJ_BODY.value, "trunk") == trunk


def test_joints_dofs(pair):
    m, mj, _ctrl, _robot = pair
    np.testing.assert_array_equal(m.jnt_type, mj.jnt_type)
    np.testing.assert_array_equal(m.jnt_bodyid, mj.jnt_bodyid)
    np.testing.assert_array_equal(m.jnt_qposadr, mj.jnt_qposadr)
    np.testing.assert_array_equal(m.jnt_dofadr, mj.jnt_dofadr)
    np.testing.assert_allclose(m.jnt_axis, mj.jnt_axis)
    np.testing.assert_allclose(m.jnt_range, mj.jnt_range)
    np.testing.assert_array_equal(m.jnt_limited, mj.jnt_limited.astype(bool))
    np.testing.assert_allclose(m.dof_armature, mj.dof_armature)
    np.testing.assert_allclose(m.dof_damping, mj.dof_damping)
    np.testing.assert_allclose(m.dof_frictionloss, mj.dof_frictionloss)
    np.testing.assert_array_equal(m.dof_bodyid, mj.dof_bodyid)
    np.testing.assert_array_equal(m.dof_jntid, mj.dof_jntid)


def test_geoms(pair):
    m, mj, _ctrl, _robot = pair
    np.testing.assert_array_equal(m.geom_type, mj.geom_type)
    np.testing.assert_array_equal(m.geom_bodyid, mj.geom_bodyid)
    np.testing.assert_allclose(m.geom_pos, mj.geom_pos, atol=1e-12)
    # quaternion sign is arbitrary: compare up to sign
    sign = np.sign(np.sum(m.geom_quat * mj.geom_quat, axis=1, keepdims=True))
    np.testing.assert_allclose(m.geom_quat * sign, mj.geom_quat, atol=1e-9)
    np.testing.assert_allclose(m.geom_size, mj.geom_size, atol=1e-12)
    np.testing.assert_array_equal(m.geom_contype, mj.geom_contype)
    np.testing.assert_array_equal(m.geom_conaffinity, mj.geom_conaffinity)
    np.testing.assert_array_equal(m.geom_condim, mj.geom_condim)
    np.testing.assert_array_equal(m.geom_priority, mj.geom_priority)
    np.testing.assert_allclose(m.geom_friction, mj.geom_friction)
    np.testing.assert_allclose(m.geom_solref, mj.geom_solref)
    np.testing.assert_allclose(m.geom_solimp, mj.geom_solimp)
    np.testing.assert_allclose(m.geom_margin, mj.geom_margin)


def test_actuators(pair):
    m, mj, ctrl, robot = pair
    np.testing.assert_allclose(m.actuator_gear, mj.actuator_gear[:, 0])
    np.testing.assert_allclose(m.actuator_ctrlrange, mj.actuator_ctrlrange)
    np.testing.assert_allclose(m.actuator_forcerange, mj.actuator_forcerange)
    if ctrl == "torque":
        assert (m.actuator_kind == ACT_MOTOR).all()
        gears = ([23, 23, 35] if robot == "go1" else [23.7, 23.7, 45.43]) * 4
        np.testing.assert_allclose(m.actuator_gear, gears)
    else:
        assert (m.actuator_kind == ACT_POSITION).all()
        # position gain/bias: gainprm[0]=kp, biasprm=[0,-kp,-kv]
        np.testing.assert_allclose(m.actuator_kp, mj.actuator_gainprm[:, 0])
        np.testing.assert_allclose(-m.actuator_kp, mj.actuator_biasprm[:, 1])


def test_keyframe(pair):
    m, mj, _ctrl, robot = pair
    np.testing.assert_allclose(m.key_qpos, mj.key_qpos)
    np.testing.assert_allclose(m.key_ctrl, mj.key_ctrl)
    z = 0.30 if robot == "go1" else 0.29
    np.testing.assert_allclose(
        m.key_qpos[0],
        [0, 0, z, 1, 0, 0, 0] + [0, 0.9, -1.8] * 4,
    )

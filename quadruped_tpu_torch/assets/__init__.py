"""Bundled robot assets (defaults-resolved RawSpec JSON), the port's copy
of quadruped_tpu/assets' scenes: go1 and go2, each with torque motors or
position servos (the reference's `scene_{ctrl_type}.xml` selection)."""

from pathlib import Path

from ..mjcf import PhysicsModel, RawSpec, compile_spec

_DIR = Path(__file__).parent


def robot_spec(robot: str = "go1", ctrl_type: str = "torque") -> RawSpec:
    """Load a bundled robot scene spec."""
    if robot not in ("go1", "go2"):
        raise ValueError(f"unknown robot: {robot}")
    if ctrl_type not in ("torque", "position"):
        raise ValueError(f"unknown ctrl_type: {ctrl_type}")
    return RawSpec.from_json((_DIR / f"{robot}_{ctrl_type}.json").read_text())


def robot_model(robot: str = "go1", ctrl_type: str = "torque") -> PhysicsModel:
    return compile_spec(robot_spec(robot, ctrl_type))

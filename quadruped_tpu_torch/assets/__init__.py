"""Bundled robot assets (defaults-resolved RawSpec JSON)."""

from pathlib import Path

from ..mjcf import PhysicsModel, RawSpec, compile_spec

_DIR = Path(__file__).parent


def robot_spec(robot: str = "go1", ctrl_type: str = "torque") -> RawSpec:
    """Load a bundled robot scene spec.  This slice ships the Go1 torque
    scene only; the other robots and the position-servo scenes come with
    the environment-breadth slice."""
    if (robot, ctrl_type) != ("go1", "torque"):
        raise NotImplementedError(
            f"robot={robot!r} ctrl_type={ctrl_type!r}: only go1/torque is "
            "ported"
        )
    return RawSpec.from_json((_DIR / f"{robot}_{ctrl_type}.json").read_text())


def robot_model(robot: str = "go1", ctrl_type: str = "torque") -> PhysicsModel:
    return compile_spec(robot_spec(robot, ctrl_type))

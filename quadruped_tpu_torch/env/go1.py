"""Batched Go1 velocity-command locomotion environment.

Counterpart of quadruped_tpu/env/go1.py, batch-first: an EnvState holds
tensors with the env batch on the leading axis, and reset/step act on the
whole batch at once.  Randomness comes from an explicit torch.Generator.
Semantics follow the reference, including the quirks it replicates from
the original Gymnasium env (go1_mujoco_env.py):

  * obs contains the *previous* action (go1.py:511-513)
  * projected_gravity uses the euler-angle formula, not a quaternion
    rotation
  * the health check reads quaternion x/y components as "roll"/"pitch"
  * collision_cost is a Frobenius norm over all contact bodies (0/1)
  * body kinematics and cfrc in rewards are pre-integration values of the
    final substep, obs and velocity rewards use post-integration qpos/qvel
  * reward floored at zero: max(0, rewards - costs)

This slice ports the configuration of record: Go1, torque control, flat
floor, full collision table, default rewards.  Every other option raises
NotImplementedError in Go1Env.__init__.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import resolve_device
from ..physics.consts import cached
from ..physics.forward import Pipeline, step_n
from ..physics.math import axis_angle_to_quat, euler_from_quat, norm
from ..timing import TIMER
from .config import Go1Config

# body ids: world, trunk, then hip/thigh/calf x FR,FL,RR,RL
TRUNK = 1
FEET_BODIES = (4, 7, 10, 13)                 # go1_mujoco_env.py:124
CONTACT_BODIES = (2, 3, 5, 6, 8, 9, 11, 12)  # go1_mujoco_env.py:126

TERM_NOT = 0
TERM_NOT_FINITE = 1
TERM_Z = 2
TERM_ROLL = 3
TERM_PITCH = 4


@dataclasses.dataclass
class EnvState:
    """Per-env state, every field batch-first (B, ...)."""

    qpos: torch.Tensor                 # (B, nq)
    qvel: torch.Tensor                 # (B, nv)
    params: dict[str, torch.Tensor]    # physics params, (B, ...) each
    steps: torch.Tensor                # (B,) i32
    time_unhealthy: torch.Tensor       # (B,)
    feet_air_time: torch.Tensor        # (B, 4)
    last_contacts: torch.Tensor        # (B, 4) bool
    last_action: torch.Tensor          # (B, 12)
    desired_vel: torch.Tensor          # (B, 3)
    last_health_dev: torch.Tensor      # (B, 3) z/roll/pitch deviations
    front_feet_touched: torch.Tensor   # (B,) bool
    last_feet_forces: torch.Tensor     # (B, 4) cfrc norms, previous step
    rand_power: torch.Tensor           # (B,) reset-noise scale
    qacc_warm: torch.Tensor            # (B, nv) solver warm start
    action_buf: torch.Tensor           # (B, max_latency+1, 12)
    latency: torch.Tensor              # (B,) i32
    gait: torch.Tensor                 # (B,) i32
    gait_phase: torch.Tensor           # (B,)

    def select(self, mask: torch.Tensor, other: "EnvState") -> "EnvState":
        """Per env: this state where mask is True, else `other`."""
        def pick(a, b):
            m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)

        out = {}
        for f in dataclasses.fields(self):
            a, b = getattr(self, f.name), getattr(other, f.name)
            if f.name == "params":
                out[f.name] = {k: pick(a[k], b[k]) for k in a}
            else:
                out[f.name] = pick(a, b)
        return EnvState(**out)


def _unsupported(cfg: Go1Config) -> list[str]:
    """Config values this slice does not implement."""
    d = Go1Config()
    bad = []
    checks = [
        ("robot", cfg.robot == "go1"),
        ("ctrl_type", cfg.ctrl_type == "torque"),
        ("biped", not cfg.biped),
        ("terrain", cfg.terrain == "flat"),
        ("gait_conditioning", not cfg.gait_conditioning),
        ("dr.enabled", not cfg.dr.enabled),
        ("dr.max_latency_steps", cfg.dr.max_latency_steps == 0),
        ("action_mode", cfg.action_mode == "raw"),
        ("collision_mode", cfg.collision_mode == "full"),
        ("reward_floor", cfg.reward_floor == d.reward_floor),
        ("accel_cost_mode", cfg.accel_cost_mode == d.accel_cost_mode),
        ("command_speed_floor", cfg.command_speed_floor == d.command_speed_floor),
        ("stand_still_cost", cfg.stand_still_cost == d.stand_still_cost),
        ("feet_airtime_bootstrap",
         cfg.feet_airtime_bootstrap == d.feet_airtime_bootstrap),
    ]
    for name, ok in checks:
        if not ok:
            bad.append(name)
    return bad


class Go1Env:
    """Batched env: compiled pipeline + config + derived constants."""

    def __init__(self, cfg: Go1Config, device="cuda"):
        bad = _unsupported(cfg)
        if bad:
            raise NotImplementedError(
                f"Go1Config options not ported in this slice: {bad}"
            )
        from ..assets import robot_model

        self.device = resolve_device(device)
        self.cfg = cfg
        self.m = robot_model(cfg.robot, cfg.ctrl_type)
        if cfg.solver_iterations is not None:
            self.m.opt.iterations = int(cfg.solver_iterations)
        pools = None
        if cfg.contact_pools is not None:
            if len(cfg.contact_pools) != 3:
                raise ValueError(
                    "contact_pools must be (K_condim6, K_condim3, "
                    f"K_condim1); got {cfg.contact_pools!r}"
                )
            pools = dict(zip((6, 3, 1), cfg.contact_pools))
        self.pipeline = Pipeline.build(
            self.m, "full", max_contacts=cfg.max_contacts, contact_pools=pools,
        )
        m = self.m
        if m.body_names[TRUNK] != "trunk" or [
            m.body_names[i] for i in FEET_BODIES
        ] != ["FR_calf", "FL_calf", "RR_calf", "RL_calf"]:
            raise ValueError("body order differs from the Go1 model's")
        self.key_qpos = m.key_qpos[0].copy()
        # reference quirk: default joint position = key_ctrl (zeros for the
        # torque model), go1_mujoco_env.py:105
        self.default_joint_position = m.key_ctrl[0].copy()
        r = m.actuator_ctrlrange
        off = 0.5 * (1 - cfg.soft_joint_factor) * (r[:, 1] - r[:, 0])
        self.soft_joint_range = np.stack([r[:, 0] + off, r[:, 1] - off], axis=1)
        self.jnt_range_hinges = m.jnt_range[1:, :].copy()
        self.gravity_vec = m.opt.gravity.copy()
        self.nu = m.nu
        self.obs_dim = 48

    def _const(self, name, make, dtype=torch.float32):
        return cached(self, name, make, self.device, dtype)

    # ------------------------------------------------------------------ reset

    def reset(
        self, num_envs: int, generator: torch.Generator | None = None,
        params: dict[str, torch.Tensor] | None = None,
        rand_power: torch.Tensor | float | None = None,
    ) -> EnvState:
        """reset_model (go1_mujoco_env.py:949-1001) for num_envs envs."""
        cfg, dev, f32 = self.cfg, self.device, torch.float32
        B = num_envs
        if params is None:
            params = {
                k: self._const(f"param_{k}", lambda v=v: v).expand(B, *v.shape)
                for k, v in self.m.params().items()
            }
        if rand_power is None:
            rand_power = cfg.rand_power
        rp = torch.as_tensor(rand_power, dtype=f32, device=dev).expand(B)

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, device=dev, dtype=f32)
            return lo + (hi - lo) * u

        qpos = self._const("key_qpos", lambda: self.key_qpos).expand(B, -1).clone()
        # 20%: fallen start (roll or pitch 85-120 deg, z = 0.1)
        angle = uniform((B,), math.pi / 2.1, math.pi / 1.5)
        ex = self._const("ex", lambda: [1.0, 0.0, 0.0])
        ey = self._const("ey", lambda: [0.0, 1.0, 0.0])
        roll_q = axis_angle_to_quat(ex, angle)
        pitch_q = axis_angle_to_quat(ey, angle)
        fall_q = torch.where(uniform((B, 1), 0.0, 1.0) < 0.5, roll_q, pitch_q)
        fallen = uniform((B,), 0.0, 1.0) < cfg.fallen_start_prob

        joints = qpos[:, 7:]
        noise = torch.randn((B, 12), generator=generator, device=dev, dtype=f32)
        joints = torch.clamp(
            joints + noise * (0.1 * rp[:, None]),
            self._const("jlo", lambda: self.jnt_range_hinges[:, 0]),
            self._const("jhi", lambda: self.jnt_range_hinges[:, 1]),
        )
        qpos[:, 2] = torch.where(fallen, torch.full_like(qpos[:, 2], 0.1), qpos[:, 2])
        qpos[:, 3:7] = torch.where(fallen[:, None], fall_q, qpos[:, 3:7])
        qpos[:, 7:] = joints
        desired = uniform(
            (B, 3), self._const("vmin", lambda: cfg.desired_vel_min),
            self._const("vmax", lambda: cfg.desired_vel_max),
        )

        def zeros(*shape, dtype=f32):
            return torch.zeros((B, *shape), dtype=dtype, device=dev)

        return EnvState(
            qpos=qpos,
            qvel=zeros(self.m.nv),
            params=params,
            steps=zeros(dtype=torch.int32),
            time_unhealthy=zeros(),
            feet_air_time=zeros(4),
            last_contacts=zeros(4, dtype=torch.bool),
            last_action=zeros(12),
            desired_vel=desired,
            last_health_dev=zeros(3),
            front_feet_touched=zeros(dtype=torch.bool),
            last_feet_forces=zeros(4),
            rand_power=rp.clone(),
            qacc_warm=zeros(self.m.nv),
            action_buf=zeros(cfg.dr.max_latency_steps + 1, 12),
            latency=zeros(dtype=torch.int32),
            gait=zeros(dtype=torch.int32),
            gait_phase=zeros(),
        )

    # ------------------------------------------------------------------- obs

    def _projected_gravity(self, qpos):
        """Reference formula (go1_mujoco_env.py:596-608): gravity projected
        onto the euler-angle vector, then normalized."""
        roll, pitch, yaw = euler_from_quat(qpos[:, 3:7])
        euler = torch.stack([roll, pitch, yaw], dim=-1)
        g = self._const("gravity_vec", lambda: self.gravity_vec, qpos.dtype)
        pg = (euler @ g)[:, None] * euler
        n = norm(pg, keepdim=True)
        return torch.where(n == 0, pg, pg / torch.where(n == 0, torch.ones_like(n), n))

    def obs(self, state: EnvState) -> torch.Tensor:
        """48-dim observation (go1_mujoco_env.py:915-947)."""
        cfg = self.cfg
        qpos, qvel = state.qpos, state.qvel
        key = self._const("key_qpos", lambda: self.key_qpos)
        o = torch.cat(
            [
                qvel[:, :3] * cfg.obs_scale_lin_vel,
                qvel[:, 3:6] * cfg.obs_scale_ang_vel,
                self._projected_gravity(qpos),
                state.desired_vel * cfg.obs_scale_lin_vel,
                (qpos[:, 7:] - key[7:]) * cfg.obs_scale_dof_pos,
                qvel[:, 6:] * cfg.obs_scale_dof_vel,
                state.last_action,
            ],
            dim=-1,
        )
        return torch.clamp(o, -cfg.clip_obs, cfg.clip_obs)

    # ----------------------------------------------------------------- health

    def _health(self, qpos, qvel):
        """(is_healthy, reason): 'roll'/'pitch' are quaternion x/y
        components (state_vector[4:6]), as in the reference."""
        cfg = self.cfg
        finite = torch.isfinite(qpos).all(-1) & torch.isfinite(qvel).all(-1)
        z_ok = (cfg.healthy_z[0] <= qpos[:, 2]) & (qpos[:, 2] <= cfg.healthy_z[1])
        roll_ok = (cfg.healthy_roll[0] <= qpos[:, 4]) & (qpos[:, 4] <= cfg.healthy_roll[1])
        pitch_ok = (cfg.healthy_pitch[0] <= qpos[:, 5]) & (qpos[:, 5] <= cfg.healthy_pitch[1])
        healthy = finite & z_ok & roll_ok & pitch_ok
        reason = torch.full_like(qpos[:, 0], TERM_NOT, dtype=torch.int32)
        for ok, code in ((pitch_ok, TERM_PITCH), (roll_ok, TERM_ROLL),
                         (z_ok, TERM_Z), (finite, TERM_NOT_FINITE)):
            reason = torch.where(ok, reason, torch.full_like(reason, code))
        return healthy, reason

    def _health_deviation(self, qpos):
        """Deviation from the healthy ranges (go1_mujoco_env.py:544-564)."""
        cfg = self.cfg

        def dev(v, lo, hi):
            inside = (lo <= v) & (v <= hi)
            d = torch.minimum((v - lo).abs(), (v - hi).abs())
            return torch.where(inside, torch.zeros_like(d), d)

        return torch.stack(
            [dev(qpos[:, 2], *cfg.healthy_z), dev(qpos[:, 4], *cfg.healthy_roll),
             dev(qpos[:, 5], *cfg.healthy_pitch)],
            dim=-1,
        )

    # ------------------------------------------------------------------- step

    def step(self, state: EnvState, action: torch.Tensor):
        """One control step = frame_skip physics substeps + obs/reward/term.
        Returns (new_state, obs, reward, terminated, truncated, info)."""
        cfg = self.cfg
        dtype = state.qpos.dtype
        action = action.to(dtype)
        qpos, qvel, data = step_n(
            self.pipeline, state.params, state.qpos, state.qvel, action,
            cfg.frame_skip, warmstart=state.qacc_warm,
        )
        with TIMER.phase("env"):
            return self._finish(state, action, qpos, qvel, data)

    def _finish(self, state, action, qpos, qvel, data):
        cfg = self.cfg
        dtype = qpos.dtype
        steps = state.steps + 1
        healthy, reason = self._health(qpos, qvel)
        feet = self._const("feet", lambda: FEET_BODIES, None)
        feet_forces = norm(data.cfrc_ext[:, feet])
        reward, reward_info, new_feet_air, new_contacts, new_dev = self._reward(
            state, action, qpos, qvel, data, healthy, feet_forces
        )
        time_unhealthy = torch.where(
            healthy, torch.zeros_like(state.time_unhealthy),
            state.time_unhealthy + cfg.dt,
        )
        # a non-finite state terminates at once and its reward/obs are
        # zeroed, so NaN never stays in the batch (go1.py:459-468)
        finite = torch.isfinite(qpos).all(-1) & torch.isfinite(qvel).all(-1)
        terminated = (time_unhealthy > cfg.max_unhealthy_time) | ~finite
        truncated = steps >= cfg.max_episode_steps
        info = {
            "x_position": qpos[:, 0],
            "y_position": qpos[:, 1],
            "distance_from_origin": norm(qpos[:, 0:2]),
            "termination_reason": torch.where(
                terminated | ~healthy, reason, torch.zeros_like(reason)
            ),
            "contact_overflow": data.con_overflow,
            **reward_info,
        }
        gait_phase = torch.remainder(
            state.gait_phase + cfg.dt / cfg.gait_period, 1.0
        )
        new_state = dataclasses.replace(
            state,
            qpos=qpos,
            qvel=qvel,
            gait_phase=gait_phase,
            steps=steps,
            time_unhealthy=time_unhealthy,
            feet_air_time=new_feet_air,
            last_contacts=new_contacts,
            last_action=action,
            last_health_dev=new_dev,
            last_feet_forces=feet_forces,
            qacc_warm=data.qacc,
        )
        # obs uses the PREVIOUS action (reference quirk)
        observation = self.obs(
            dataclasses.replace(new_state, last_action=state.last_action)
        )
        reward = torch.where(
            finite & torch.isfinite(reward), reward, torch.zeros_like(reward)
        )
        observation = torch.where(
            finite[:, None], observation, torch.zeros_like(observation)
        )
        return new_state, observation, reward, terminated, truncated, info

    # ----------------------------------------------------------------- reward

    def _reward(self, state, action, qpos, qvel, data, healthy, feet_forces):
        cfg = self.cfg
        dtype = qpos.dtype
        w, c = cfg.rewards, cfg.costs
        pg = self._projected_gravity(qpos)
        one = torch.ones_like(qpos[:, 0])
        zero = torch.zeros_like(one)
        des = state.desired_vel
        moving_cmd = norm(des[:, :2]) > 0.1

        lin_err = torch.sum((des[:, :2] - qvel[:, :2]) ** 2, dim=-1)
        linear_vel = torch.exp(-lin_err / cfg.tracking_sigma) * w.linear_vel_tracking
        ang_err = (des[:, 2] - qvel[:, 5]) ** 2
        angular_vel = torch.exp(-ang_err / cfg.tracking_sigma) * w.angular_vel_tracking
        healthy_r = torch.where(healthy, one, zero) * w.healthy

        # feet air time (go1_mujoco_env.py:634-668)
        curr_contact = feet_forces > 1.0
        contact_filter = curr_contact | state.last_contacts
        first_contact = (state.feet_air_time > 0.0) & contact_filter
        air = state.feet_air_time + cfg.dt
        over = torch.clamp(air - 0.2, min=0.0)
        feet_air = torch.sum(over * over * first_contact.to(dtype), dim=-1)
        feet_air = feet_air * moving_cmd.to(dtype) * w.feet_airtime
        new_feet_air_time = air * (~contact_filter).to(dtype)

        # recovery (go1_mujoco_env.py:535-580)
        dev = self._health_deviation(qpos)
        improvement = torch.sum(state.last_health_dev - dev, dim=-1)
        recovery = torch.where(healthy, zero, improvement) * w.recovery
        new_dev = torch.where(healthy[:, None], torch.zeros_like(dev), dev)

        # get up (go1_mujoco_env.py:220-243): pre-integration trunk height
        trunk_z = data.kin.xpos[:, TRUNK, 2]
        height_r = torch.clamp(trunk_z / cfg.healthy_z[0], 0.0, 1.0)
        orient_good = 1.0 - torch.sum(pg[:, :2] ** 2, dim=-1)
        get_up = torch.where(healthy, zero, 1.5 * height_r + 0.5 * orient_good)
        get_up = get_up * w.get_up

        rewards = linear_vel + angular_vel + healthy_r + feet_air + recovery + get_up

        # costs
        unhealthy_scale = torch.where(healthy, one, 0.1 * one)
        torque = torch.sum(data.qfrc_actuator[:, -12:] ** 2, dim=-1)
        ctrl_cost = torque * unhealthy_scale * c.torque
        action_rate = torch.sum((state.last_action - action) ** 2, dim=-1)
        action_rate_cost = action_rate * unhealthy_scale * c.action_rate
        vertical = qvel[:, 2] ** 2 * c.vertical_vel
        xy_ang = torch.sum(qvel[:, 3:5] ** 2, dim=-1) * c.xy_angular_vel
        soft_lo = self._const("soft_lo", lambda: self.soft_joint_range[:, 0])
        soft_hi = self._const("soft_hi", lambda: self.soft_joint_range[:, 1])
        out_of_range = torch.clamp(soft_lo - qpos[:, 7:], min=0.0) + torch.clamp(
            qpos[:, 7:] - soft_hi, min=0.0
        )
        joint_limit = torch.sum(out_of_range, dim=-1) * c.joint_limit
        joint_vel = torch.sum(qvel[:, 6:] ** 2, dim=-1) * c.joint_velocity
        # reference "dynamic" accel cost (go1_mujoco_env.py:736-751)
        accel = torch.sum(data.qacc[:, 6:] ** 2 / (qvel[:, 6:].abs() + 1e-6), dim=-1)
        joint_accel = accel * unhealthy_scale * c.joint_acceleration
        # collision: Frobenius norm over the 8 contact bodies -> indicator
        cb = self._const("contact_bodies", lambda: CONTACT_BODIES, None)
        coll = (norm(data.cfrc_ext[:, cb].reshape(qpos.shape[0], -1)) > 0.1).to(dtype)
        coll = coll * c.collision
        unhealthy_cost = torch.where(healthy, zero, one) * c.unhealthy_state
        orientation = torch.sum(pg[:, :2] ** 2, dim=-1) * c.orientation
        djp = self._const("default_jpos", lambda: self.default_joint_position)
        default_pos = torch.sum((qpos[:, 7:] - djp) ** 2, dim=-1) * c.default_joint_position

        costs = (
            ctrl_cost + action_rate_cost + vertical + xy_ang + joint_limit
            + joint_vel + joint_accel + coll + unhealthy_cost
            + orientation + default_pos
        )
        raw = rewards - costs
        reward = torch.clamp(raw, min=0.0)   # go1_mujoco_env.py:911
        reward_info = {
            "linear_vel_tracking_reward": linear_vel,
            "reward_ctrl": -ctrl_cost,
            "reward_survive": healthy_r,
            "recovery_reward": recovery,
            "get_up_reward": get_up,
            "unhealthy_state_cost": -unhealthy_cost,
            "angular_vel_tracking_reward": angular_vel,
            "feet_airtime_reward": feet_air,
            "action_rate_cost": -action_rate_cost,
            "vertical_vel_cost": -vertical,
            "xy_angular_vel_cost": -xy_ang,
            "joint_limit_cost": -joint_limit,
            "joint_velocity_cost": -joint_vel,
            "joint_acceleration_cost": -joint_accel,
            "collision_cost": -coll,
            "orientation_cost": -orientation,
            "default_joint_position_cost": -default_pos,
            "reward_raw": raw,
        }
        return reward, reward_info, new_feet_air_time, curr_contact, new_dev

    # -------------------------------------------------------------- autoreset

    def step_autoreset(
        self, state: EnvState, action: torch.Tensor,
        generator: torch.Generator | None = None,
        fresh: EnvState | None = None,
    ):
        """step + reset-on-done for the whole batch, on the device.  The
        returned obs of a done env is its fresh post-reset observation
        (VecEnv semantics).  `fresh` injects the reset states (tests);
        otherwise a reset is drawn from `generator` for every env and
        selected where done, as the reference selects."""
        new_state, obs, reward, terminated, truncated, info = self.step(state, action)
        with TIMER.phase("env"):
            done = terminated | truncated
            info["terminal_observation"] = obs
            if fresh is None:
                fresh = self.reset(
                    state.qpos.shape[0], generator, params=state.params,
                    rand_power=state.rand_power,
                )
            picked = fresh.select(done, new_state)
            obs = torch.where(done[:, None], self.obs(picked), obs)
        return picked, obs, reward, terminated, truncated, info

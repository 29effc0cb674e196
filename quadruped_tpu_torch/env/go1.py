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
  * reward floored at zero: max(0, rewards - costs), unless reward_floor
    is off

Every Go1Config option of the reference runs: go1 and go2, torque motors
and position servos, raw and centered actions, biped mode, rough terrain,
gait conditioning, domain randomization with actuator latency, and the
train-time reward levers.  One does not: collision_mode="plane" (the
floor-only table, which the reference solves without its kernel) raises
NotImplementedError in Go1Env.__init__, except in biped mode, which maps
it to "full" as the reference does.
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
from ..physics.terrain import height_normal, sample_terrain_params
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

# stance sets during the first half of the gait cycle, feet ordered (FR,
# FL, RR, RL); the other pair takes the second half (go1.py:523-532)
GAIT_STANCE = (
    (1, 0, 0, 1),   # trot: diagonal pairs
    (1, 0, 1, 0),   # pace: lateral pairs (right side first)
    (1, 1, 0, 0),   # bound: front pair then rear pair
)


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


class Go1Env:
    """Batched env: compiled pipeline + config + derived constants."""

    def __init__(self, cfg: Go1Config, device="cuda"):
        mode = cfg.collision_mode
        if cfg.biped and mode == "plane":
            mode = "full"  # self-collision costs need self pairs
        if mode != "full":
            raise NotImplementedError(
                f"collision_mode={cfg.collision_mode!r} is not ported: the "
                "reference solves its floor-only table without the Newton "
                "kernel (physics/solver.py:311-316)"
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
        # torque model, the home pose for position), go1_mujoco_env.py:105
        self.default_joint_position = m.key_ctrl[0].copy()
        r = m.actuator_ctrlrange
        off = 0.5 * (1 - cfg.soft_joint_factor) * (r[:, 1] - r[:, 0])
        self.soft_joint_range = np.stack([r[:, 0] + off, r[:, 1] - off], axis=1)
        self.jnt_range_hinges = m.jnt_range[1:, :].copy()

        # biped-term entities, go1_mujoco_env.py:155-164
        feet_sites = [m.site_names.index(s) for s in ("FR", "FL", "RR", "RL")]
        self.front_feet_sites = feet_sites[:2]
        self.front_knee_bodies = [m.name2id("body", n) for n in ("FR_calf", "FL_calf")]
        self.rear_hip_bodies = [m.name2id("body", n) for n in ("RR_hip", "RL_hip")]
        self.front_hip_bodies = [m.name2id("body", n) for n in ("FR_hip", "FL_hip")]
        self.unwanted_contact_bodies = [
            m.name2id("body", n)
            for n in ("trunk", "FR_thigh", "FL_thigh", "RR_thigh", "RL_thigh",
                      "FR_calf", "FL_calf")
        ]
        # self-collision candidates (biped): pairs between the two front
        # legs or the two rear legs, go1_mujoco_env.py:202-217
        lay = self.pipeline.layout

        def limb(*names):
            return {m.name2id("body", n) for n in names}

        def pair_mask(a, b):
            return np.array([(x in a and y in b) or (x in b and y in a)
                             for x, y in zip(lay.con_body1, lay.con_body2)])

        legs = {s: limb(f"{s}_hip", f"{s}_thigh", f"{s}_calf")
                for s in ("FR", "FL", "RR", "RL")}
        self.self_collision_mask = (pair_mask(legs["FR"], legs["FL"])
                                    | pair_mask(legs["RR"], legs["RL"]))

        self.gravity_vec = m.opt.gravity.copy()
        self.nu = m.nu
        # 48 (go1_mujoco_env.py:151-153) + gait one-hot and clock
        self.obs_dim = 48 + (5 if cfg.gait_conditioning else 0)

    def _const(self, name, make, dtype=torch.float32):
        return cached(self, name, make, self.device, dtype)

    def nominal_params(self, num_envs: int) -> dict[str, torch.Tensor]:
        """The model's params for num_envs envs (views of one copy)."""
        return {
            k: self._const(f"param_{k}", lambda v=v: v).expand(num_envs, *v.shape)
            for k, v in self.m.params().items()
        }

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
            params = self.nominal_params(B)
        if rand_power is None:
            rand_power = cfg.rand_power
        rp = torch.as_tensor(rand_power, dtype=f32, device=dev).expand(B)

        def uniform(shape, lo, hi):
            u = torch.rand(shape, generator=generator, device=dev, dtype=f32)
            return lo + (hi - lo) * u

        def randint(hi):
            return torch.randint(0, hi, (B,), generator=generator, device=dev,
                                 dtype=torch.int32)

        qpos = self._const("key_qpos", lambda: self.key_qpos).expand(B, -1).clone()
        # 20%: fallen start (roll or pitch 85-120 deg, z = 0.1)
        angle = uniform((B,), math.pi / 2.1, math.pi / 1.5)
        ex = self._const("ex", lambda: [1.0, 0.0, 0.0])
        ey = self._const("ey", lambda: [0.0, 1.0, 0.0])
        roll_q = axis_angle_to_quat(ex, angle)
        pitch_q = axis_angle_to_quat(ey, angle)
        fall_q = torch.where(uniform((B, 1), 0.0, 1.0) < 0.5, roll_q, pitch_q)
        fallen = uniform((B,), 0.0, 1.0) < cfg.fallen_start_prob

        if cfg.biped:
            # the ready pose: joints, height and pitch (go1.py:202-206)
            half = 0.5 * math.radians(cfg.biped_ready_pitch_deg)
            alt_joints = self._const("biped_joints", lambda: cfg.biped_ready_joints)
            alt_z = torch.full_like(qpos[:, 2], cfg.biped_ready_height)
            alt_q = self._const(
                "biped_quat", lambda: [math.cos(half), 0.0, math.sin(half), 0.0])
        else:
            alt_joints, alt_z, alt_q = qpos[:, 7:], qpos[:, 2], qpos[:, 3:7]
        joints = torch.where(fallen[:, None], qpos[:, 7:], alt_joints)
        noise = torch.randn((B, 12), generator=generator, device=dev, dtype=f32)
        joints = torch.clamp(
            joints + noise * (0.1 * rp[:, None]),
            self._const("jlo", lambda: self.jnt_range_hinges[:, 0]),
            self._const("jhi", lambda: self.jnt_range_hinges[:, 1]),
        )
        qpos[:, 2] = torch.where(fallen, torch.full_like(alt_z, 0.1), alt_z)
        qpos[:, 3:7] = torch.where(fallen[:, None], fall_q, alt_q)
        qpos[:, 7:] = joints
        desired = uniform(
            (B, 3), self._const("vmin", lambda: cfg.desired_vel_min),
            self._const("vmax", lambda: cfg.desired_vel_max),
        )
        if cfg.command_speed_floor > 0:
            # anti-standing lever: the x command's magnitude U(0, hi)
            # remapped to U(floor, hi), its sign kept (go1.py:233-243)
            hi = abs(cfg.desired_vel_max[0])
            lo = cfg.command_speed_floor
            d0 = desired[:, 0]
            sign = torch.where(d0 >= 0, 1.0, -1.0).to(f32)
            desired[:, 0] = sign * (lo + (d0.abs() / hi) * (hi - lo))

        if cfg.dr.enabled:
            # from the NOMINAL params, never the episode's own: the factors
            # must not compound over resets (go1.py:250-257)
            params = self._randomize(B, generator)
        if cfg.terrain == "rough":
            # a fresh field every episode; the spawn height rides it
            params = dict(params)
            params.update(sample_terrain_params(
                B, generator, cfg.terrain_waves, cfg.terrain_amplitude,
                cfg.terrain_wavelength, device=dev, dtype=f32,
            ))
            h0, _ = height_normal(params, qpos[:, :2])
            qpos[:, 2] = qpos[:, 2] + h0
        zeros_i = torch.zeros((B,), dtype=torch.int32, device=dev)
        latency = (randint(cfg.dr.max_latency_steps + 1)
                   if cfg.dr.enabled and cfg.dr.max_latency_steps > 0 else zeros_i)
        gait = randint(3) if cfg.gait_conditioning else zeros_i

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
            latency=latency,
            gait=gait,
            gait_phase=zeros(),
        )

    def _randomize(self, num_envs: int, generator) -> dict[str, torch.Tensor]:
        """Per-env multiplicative factors on the nominal params
        (go1.py:309-321): friction, mass and inertia (one draw for both),
        servo gain, damping.  geom_friction is scaled as in the reference,
        and as there no physics reads it: contact friction comes from the
        static collision table (collision.py:_combine_pair)."""
        dr = self.cfg.dr
        params = self.nominal_params(num_envs)

        def factor(r):
            u = torch.rand((num_envs,), generator=generator, device=self.device)
            return r[0] + (r[1] - r[0]) * u

        def scale(v, f):
            return v * f.reshape((-1,) + (1,) * (v.dim() - 1))

        friction, mass = factor(dr.friction_range), factor(dr.mass_range)
        kp, damping = factor(dr.kp_range), factor(dr.damping_range)
        params["geom_friction"] = scale(params["geom_friction"], friction)
        params["body_mass"] = scale(params["body_mass"], mass)
        params["body_inertia"] = scale(params["body_inertia"], mass)
        params["actuator_kp"] = scale(params["actuator_kp"], kp)
        params["dof_damping"] = scale(params["dof_damping"], damping)
        return params

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
        """48-dim observation (go1_mujoco_env.py:915-947); with gait
        conditioning 53: the gait's one-hot, then sin and cos of the
        shared gait clock."""
        cfg = self.cfg
        qpos, qvel = state.qpos, state.qvel
        key = self._const("key_qpos", lambda: self.key_qpos)
        parts = [
            qvel[:, :3] * cfg.obs_scale_lin_vel,
            qvel[:, 3:6] * cfg.obs_scale_ang_vel,
            self._projected_gravity(qpos),
            state.desired_vel * cfg.obs_scale_lin_vel,
            (qpos[:, 7:] - key[7:]) * cfg.obs_scale_dof_pos,
            qvel[:, 6:] * cfg.obs_scale_dof_vel,
            state.last_action,
        ]
        if cfg.gait_conditioning:
            ph = 2.0 * math.pi * state.gait_phase
            gaits = self._const("gaits", lambda: np.arange(3), torch.int32)
            parts += [(state.gait[:, None] == gaits).to(qpos.dtype),
                      torch.sin(ph)[:, None], torch.cos(ph)[:, None]]
        o = torch.cat(parts, dim=-1)
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
        with TIMER.phase("env"):
            # biped: the front feet's touch from the previous step's
            # forces, before the simulation (go1.py:413-419)
            front_touched = state.front_feet_touched
            if cfg.biped:
                front_touched = front_touched | (state.last_feet_forces[:, :2] > 1.0).any(-1)
            # actuator latency: the physics sees the action from `latency`
            # control steps ago (go1.py:421-429)
            action_buf = state.action_buf
            applied = action
            if cfg.dr.max_latency_steps > 0:
                action_buf = torch.cat([action[:, None], action_buf[:, :-1]], dim=1)
                bidx = torch.arange(action.shape[0], device=action.device)
                applied = action_buf[bidx, state.latency.long()]
            # centered actions: ctrl re-based at the home keyframe; reward,
            # obs and last_action still see the policy action
            ctrl = applied
            if cfg.action_mode == "centered":
                djp = self._const("default_jpos", lambda: self.default_joint_position)
                ctrl = djp + cfg.action_scale * applied
        qpos, qvel, data = step_n(
            self.pipeline, state.params, state.qpos, state.qvel, ctrl,
            cfg.frame_skip, warmstart=state.qacc_warm,
        )
        with TIMER.phase("env"):
            return self._finish(state, action, qpos, qvel, data, front_touched,
                                action_buf)

    def _finish(self, state, action, qpos, qvel, data, front_touched, action_buf):
        cfg = self.cfg
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
        bipedal_success = (truncated & ~front_touched if cfg.biped
                           else torch.zeros_like(truncated))
        info = {
            "x_position": qpos[:, 0],
            "y_position": qpos[:, 1],
            "distance_from_origin": norm(qpos[:, 0:2]),
            "termination_reason": torch.where(
                terminated | ~healthy, reason, torch.zeros_like(reason)
            ),
            "bipedal_success": bipedal_success,
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
            front_feet_touched=front_touched,
            last_feet_forces=feet_forces,
            qacc_warm=data.qacc,
            action_buf=action_buf,
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

    def _gait_pattern_reward(self, state, curr_contact, moving_cmd, healthy):
        """Command-conditioned gait shaping (go1.py:534-550): the share of
        feet whose contact matches the commanded gait's stance template at
        the pre-step clock phase, while commanded to move and healthy."""
        dtype = state.gait_phase.dtype
        tmpl = self._const("gait_stance", lambda: GAIT_STANCE)[state.gait.long()]
        first_half = (state.gait_phase < 0.5)[:, None]
        expected = torch.where(first_half, tmpl, 1.0 - tmpl)
        match = (curr_contact.to(dtype) == expected).to(dtype)
        r = torch.mean(match, dim=-1)
        return torch.where(moving_cmd & healthy, r, torch.zeros_like(r)) * (
            self.cfg.gait_reward_weight)

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

        # feet air time (go1_mujoco_env.py:634-668); biped: the rear feet's
        # alternation bonus, air time and contacts left as they were
        curr_contact = feet_forces > 1.0
        if cfg.biped:
            alternating = curr_contact[:, 2] != curr_contact[:, 3]
            feet_air = torch.where(alternating, one, zero) * w.feet_airtime
            new_feet_air_time = state.feet_air_time
            new_contacts = state.last_contacts
        else:
            contact_filter = curr_contact | state.last_contacts
            new_contacts = curr_contact
            first_contact = (state.feet_air_time > 0.0) & contact_filter
            air = state.feet_air_time + cfg.dt
            over = torch.clamp(air - 0.2, min=0.0)
            feet_air = torch.sum(over * over * first_contact.to(dtype), dim=-1)
            feet_air = feet_air * moving_cmd.to(dtype) * w.feet_airtime
            if cfg.feet_airtime_bootstrap:
                # anti-standing lever: a linear payment per touchdown after
                # >= 0.1 s of air time (go1.py:585-596)
                qualifying = (first_contact & (air >= 0.1)).sum(-1).to(dtype)
                feet_air = feet_air + (
                    qualifying * moving_cmd.to(dtype)
                    * torch.where(healthy, one, zero) * cfg.feet_airtime_bootstrap
                )
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
        gait_info = {}
        if cfg.gait_conditioning and not cfg.biped:
            gait_r = self._gait_pattern_reward(state, curr_contact, moving_cmd, healthy)
            rewards = rewards + gait_r
            gait_info = {"gait_pattern_reward": gait_r}

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
        # accel cost: "dynamic" is the reference formula
        # (go1_mujoco_env.py:736-751); "plain" and "off" are train-time
        # shaping (go1.py:640-651)
        if cfg.accel_cost_mode == "plain":
            joint_accel = (torch.sum(data.qacc[:, 6:] ** 2, dim=-1)
                           * unhealthy_scale * c.joint_acceleration_plain)
        elif cfg.accel_cost_mode == "off":
            joint_accel = zero
        else:
            accel = torch.sum(data.qacc[:, 6:] ** 2 / (qvel[:, 6:].abs() + 1e-6), dim=-1)
            joint_accel = accel * unhealthy_scale * c.joint_acceleration
        # collision: Frobenius norm over the 8 contact bodies -> indicator
        cb = self._const("contact_bodies", lambda: CONTACT_BODIES, None)
        coll = (norm(data.cfrc_ext[:, cb].reshape(qpos.shape[0], -1)) > 0.1).to(dtype)
        coll = coll * c.collision
        unhealthy_cost = torch.where(healthy, zero, one) * c.unhealthy_state
        # anti-standing lever: a cost while commanded to move, healthy and
        # standing, by all four feet in stance ("contact") or by the speed
        # along the command below 30% of it ("velocity"), go1.py:658-676
        if cfg.stand_still_mode == "velocity":
            cmd_norm = torch.clamp(norm(des[:, :2]), min=1e-6)
            proj = torch.sum(qvel[:, :2] * des[:, :2], dim=-1) / cmd_norm
            ss_trigger = moving_cmd & healthy & (proj < 0.3 * cmd_norm)
        else:
            ss_trigger = moving_cmd & healthy & curr_contact.all(-1)
        stand_still = torch.where(ss_trigger, one, zero) * cfg.stand_still_cost

        costs = (
            ctrl_cost + action_rate_cost + vertical + xy_ang + joint_limit
            + joint_vel + joint_accel + coll + unhealthy_cost + stand_still
        )
        # every channel, costs negative (go1.py:689-713)
        reward_info = {
            **gait_info,
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
        }
        if cfg.stand_still_cost:
            reward_info["stand_still_cost"] = -stand_still

        if cfg.biped:
            upright, biped_costs = self._biped_terms(qpos, data, feet_forces)
            rewards = rewards + upright
            for v in biped_costs.values():
                costs = costs + v
            reward_info["biped_upright_reward"] = upright
            reward_info.update({k: -v for k, v in biped_costs.items()})
        else:
            orientation = torch.sum(pg[:, :2] ** 2, dim=-1) * c.orientation
            djp = self._const("default_jpos", lambda: self.default_joint_position)
            default_pos = torch.sum((qpos[:, 7:] - djp) ** 2, dim=-1) * c.default_joint_position
            costs = costs + orientation + default_pos
            reward_info["orientation_cost"] = -orientation
            reward_info["default_joint_position_cost"] = -default_pos

        raw = rewards - costs
        # go1_mujoco_env.py:911; reward_floor=False is train-time shaping
        reward = torch.clamp(raw, min=0.0) if cfg.reward_floor else raw
        reward_info["reward_raw"] = raw
        return reward, reward_info, new_feet_air_time, new_contacts, new_dev

    def _biped_terms(self, qpos, data, feet_forces):
        """(upright reward, {cost name: cost}) of biped mode
        (go1.py:715-786), each cost positive, in the reference's order."""
        cfg = self.cfg
        bw = cfg.biped_weights
        dtype = qpos.dtype
        kin = data.kin

        def idx(name, ids):
            return self._const(name, lambda: ids, None)

        upright = torch.clamp(kin.xmat[:, TRUNK, 2, 0], min=0.0) * bw.upright
        front_forces = feet_forces[:, :2]
        indicator = cfg.biped_contact_mode == "indicator"
        if indicator:
            # bounded train-time form: the count of loaded front feet
            front_contact = (front_forces > 1.0).to(dtype).sum(-1) * (bw.front_contact / 10.0)
        else:
            front_contact = torch.sum(front_forces ** 2, dim=-1) * bw.front_contact
        rear_airborne = torch.where(
            (feet_forces[:, 2:] < 1.0).all(-1),
            torch.full_like(front_contact, bw.rear_feet_airborne),
            torch.zeros_like(front_contact),
        )
        feet_z = kin.site_xpos[:, idx("front_feet_sites", self.front_feet_sites), 2]
        knees_z = kin.xpos[:, idx("front_knees", self.front_knee_bodies), 2]
        front_foot_height = torch.sum(
            torch.clamp(knees_z - feet_z, min=0.0), dim=-1) * bw.front_foot_height
        rear_hips = kin.xpos[:, idx("rear_hips", self.rear_hip_bodies)]
        crossed = torch.clamp(rear_hips[:, 0, 1] - rear_hips[:, 1, 1], min=0.0) * bw.crossed_legs
        low_hips = torch.sum(
            torch.clamp(0.2 - rear_hips[..., 2], min=0.0), dim=-1) * 10.0 * bw.low_rear_hips
        front_hips_z = kin.xpos[:, idx("front_hips", self.front_hip_bodies), 2]
        below_hips = torch.sum(
            torch.clamp(front_hips_z - feet_z, min=0.0) ** 2, dim=-1) * bw.front_feet_below_hips
        abduction = torch.sum(qpos[:, 7:][:, 0::3] ** 2, dim=-1) * bw.abduction_joints
        unwanted_norms = norm(
            data.cfrc_ext[:, idx("unwanted_bodies", self.unwanted_contact_bodies)])
        if indicator:
            unwanted = (unwanted_norms > 1.0).to(dtype).sum(-1) * (bw.unwanted_contact / 10.0)
        else:
            unwanted = torch.sum(unwanted_norms ** 2, dim=-1) * bw.unwanted_contact
        self_mask = self._const("self_mask", lambda: self.self_collision_mask, None)
        selfc = (data.con_active & self_mask[data.con_sel]).sum(-1).to(dtype) * bw.self_collision
        return upright, {
            "biped_front_contact_cost": front_contact,
            "biped_rear_feet_airborne_cost": rear_airborne,
            "biped_front_foot_height_cost": front_foot_height,
            "biped_crossed_legs_cost": crossed,
            "biped_low_rear_hips_cost": low_hips,
            "biped_front_feet_below_hips_cost": below_hips,
            "biped_abduction_joints_cost": abduction,
            "biped_unwanted_contact_cost": unwanted,
            "self_collision_cost": selfc,
        }

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

"""Go1 environment configuration.

All constants mirror the reference's hard-coded class attributes
(go1_mujoco_env.py:64-150) but are promoted to a structured, serializable
config — the reference's curriculum pokes env internals via VecEnv
set_attr (training_callback.py:64); here curriculum state (rand_power) is
explicit functional input instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(eq=False)
class RewardWeights:
    """go1_mujoco_env.py:69-89."""

    linear_vel_tracking: float = 2.0
    angular_vel_tracking: float = 1.0
    healthy: float = 1.0
    feet_airtime: float = 5.0
    recovery: float = 10.0
    get_up: float = 20.0


@dataclasses.dataclass(eq=False)
class CostWeights:
    """go1_mujoco_env.py:77-89."""

    torque: float = 0.0002
    vertical_vel: float = 2.0
    xy_angular_vel: float = 0.05
    action_rate: float = 0.01
    joint_limit: float = 10.0
    joint_velocity: float = 0.01
    joint_acceleration: float = 2.0e-4
    # weight for accel_cost_mode="plain" (plain qacc², the formulation
    # used by the walking-era literature the reference's reward stack
    # descends from); the reference's "dynamic" qacc²/(|qvel|+1e-6) blows
    # up ~1e6x at rest and is the measured reason its current objective
    # cannot bootstrap (VERDICT r2 weak #1)
    joint_acceleration_plain: float = 2.5e-7
    orientation: float = 1.0
    collision: float = 1.0
    default_joint_position: float = 0.1
    unhealthy_state: float = 5.0


@dataclasses.dataclass(eq=False)
class BipedWeights:
    """go1_mujoco_env.py:91-101."""

    upright: float = 15.0
    front_contact: float = 50.0
    rear_feet_airborne: float = 5.0
    front_foot_height: float = 8.0
    crossed_legs: float = 5.0
    low_rear_hips: float = 9.0
    front_feet_below_hips: float = 6.0
    abduction_joints: float = 0.7
    unwanted_contact: float = 150.0
    self_collision: float = 25.0


@dataclasses.dataclass(eq=False)
class DomainRandomization:
    """Per-episode physics randomization (BASELINE.json config 3:
    'Go1 + domain randomization (mass/friction/actuator latency)')."""

    enabled: bool = False
    friction_range: tuple = (0.6, 1.4)       # multiplier on geom friction
    mass_range: tuple = (0.8, 1.2)           # multiplier on body mass
    kp_range: tuple = (0.9, 1.1)             # position-servo gain multiplier
    damping_range: tuple = (0.9, 1.1)
    max_latency_steps: int = 0               # action delay in control steps


@dataclasses.dataclass(eq=False)
class Go1Config:
    # "go1" (reference robot) or "go2" (BASELINE config 4; authored asset,
    # tools/gen_go2_assets.py) — entity names match, so the whole env/
    # reward stack is robot-agnostic
    robot: str = "go1"
    ctrl_type: str = "torque"                # scene_{ctrl_type}.xml selection
    biped: bool = False
    rand_power: float = 0.0                  # reset joint-noise scale
    # "full" (default) includes robot self-collision pairs — the reference
    # model allows them (contype/conaffinity 1 on all geoms) and both the
    # dynamics and the collision/unwanted-contact costs observe them;
    # "plane" restricts to geom-vs-floor for speed experiments.
    collision_mode: str = "full"
    # top-K solver slots.  Measured worst case on the flat-plane Go1 is 46
    # simultaneously-active candidates (deep-fall states); actives beyond K
    # are dropped by constraint.assemble's stream compaction, and the drop
    # count is surfaced per step as info["contact_overflow"].
    max_contacts: int = 48
    # condim row pools (K6, K3, K1): per-condim-class top-K solver slots.
    # Foot-involved pairs are condim 6, other-vs-floor pairs condim 3,
    # robot self pairs condim 1 (go1_torque.xml defaults), so class
    # budgets cover the same contact capacity with ~2x fewer solver rows
    # than uniform 6-row slots (deep-fall worst case measured 2x condim-6
    # + 44x condim-3).  None = uniform top-K (max_contacts).
    contact_pools: tuple | None = None
    # command-conditioned multi-gait (BASELINE.json config 5): appends a
    # gait one-hot + shared-clock sin/cos to the observation (53 dims) and
    # rewards contact patterns matching the commanded gait template
    gait_conditioning: bool = False
    gait_period: float = 0.5                 # s per full gait cycle
    gait_reward_weight: float = 0.8

    # rough-terrain heightfield (BASELINE.json config 4): "flat" uses the
    # MJCF plane; "rough" replaces it with a per-episode procedural
    # sum-of-cosines field (physics/terrain.py) — fresh draw per reset
    terrain: str = "flat"
    terrain_amplitude: float = 0.04          # peak height scale (m)
    terrain_wavelength: float = 1.0          # center feature size (m)
    terrain_waves: int = 8

    # Newton iteration override (None = model default, 15): the speed/
    # accuracy profile knob — oracle parity is pinned at the default;
    # training-quality runs can trade iterations for throughput after an
    # A/B reward validation (PLAN.md)
    solver_iterations: int | None = None

    # --- train-time shaping deviations (documented; defaults = exact
    # reference semantics, go1_mujoco_env.py:911/736-751).  The reference's
    # CURRENT objective provably cannot bootstrap: standing at the home
    # keyframe with small random actions earns reward exactly 0.0 in both
    # ctrl modes (the max(0, rewards-costs) floor + the dynamic accel cost
    # swallow every signal; VERDICT r2 weak #1 verified the mechanism, and
    # results/parity/ENDORSED_MODELS.md shows no shipped reference artifact
    # was trained on it either).  Training runs may deviate here; evals and
    # the parity harness keep reference semantics (learn/runner.py builds a
    # reference-semantics eval env when these are active).
    reward_floor: bool = True        # False: signed reward (drop max(0,·))
    accel_cost_mode: str = "dynamic"  # "dynamic" | "plain" | "off"
    # Action parameterization.  "raw" = reference semantics: the policy
    # action IS the actuator ctrl (go1_mujoco_env.py passes the action
    # straight to do_simulation), so in position mode action=0 targets
    # all-zero joint angles — straight legs, instant collapse (measured:
    # zero-action z 0.30->0.06 in 2 s).  "centered" re-bases the ctrl at
    # the home keyframe: ctrl = key_ctrl + action_scale * action, the
    # standard parameterization of the walking-era recipes this task
    # descends from — action=0 stands (measured: holds z=0.26 with
    # POSITIVE shaped reward indefinitely), so PPO explores around
    # standing instead of around collapse.  Part of the policy<->env
    # interface, not reward semantics: checkpoints record it and evals
    # keep it while restoring reference reward semantics.
    action_mode: str = "raw"          # "raw" | "centered"
    action_scale: float = 0.3         # rad around key_ctrl ("centered")
    # Anti-standing levers (VERDICT r3 next #1): the round-3 flagship
    # converged to a perfect stander — a local optimum the shaped
    # objective pays (+2.5/step incl. 1.64 of linear-vel tracking earned
    # while stationary: exp(-err²/0.25) is generous at |v_des|~0.2, and
    # nothing makes standing-under-command unprofitable).  Both knobs are
    # train-time deviations; evals restore reference semantics
    # (learn/runner.py zeroes them in the eval env).
    #   command_speed_floor: resample the x-velocity command as
    #     sign · U(floor, |desired_vel_max_x|) instead of U(-0.5, 0.5)
    #     (reference: go1_mujoco_env.py:1011-1015) so no training episode
    #     is trackable by standing still.  0 = reference sampling.
    command_speed_floor: float = 0.0
    #   stand_still_cost: per-step cost while healthy, commanded to move
    #     (|v_des|>0.1) and ALL FOUR feet in contact — dense pressure to
    #     lift a foot; vanishes the moment any foot swings, so a trotting
    #     policy never pays it.  0 = off (reference has no such term).
    stand_still_cost: float = 0.0
    #   stand_still_mode: trigger for stand_still_cost.  "contact" = all
    #     four feet in stance (round-4 lever — proved DODGEABLE: the 60M
    #     flagship learned to swing feet in place, airtime 0.97/eval while
    #     covering 0.10 m, paying nothing).  "velocity" = commanded-
    #     direction speed below 30% of the command while healthy — charges
    #     standing AND stepping-in-place AND walking the wrong way; only
    #     actual commanded translation escapes.  Train-time only (evals
    #     keep reference semantics, which has neither).
    stand_still_mode: str = "contact"
    #   feet_airtime_bootstrap: linear per-touchdown payment (w per foot
    #     touching down after >= 0.1 s airborne, while healthy and
    #     commanded) — the REACHABLE version of the reference's airtime
    #     reward, whose (air-0.2s)^2-on-first-contact payout is ~0.0025
    #     for the earliest explorable swings and therefore carries no
    #     usable gradient out of a stance (round-4 probe: the 12.8M-step
    #     levered policy converged to a static four-feet stance, vx=0.000,
    #     absorbing stand_still_cost).  A static tripod earns nothing (no
    #     touchdowns); foot vibration fails the 0.1 s bar.  0 = off.
    feet_airtime_bootstrap: float = 0.0
    # Biped contact-cost form.  "force_sq" = reference semantics
    # (go1_mujoco_env.py:425-430, 771-781): cost = w * ||force||^2 — at
    # fall-impact forces (~1e3 N) this reaches 1e8/step, which the
    # reference's max(0,.) floor silently clamps to reward 0 (the r3
    # preflight measured density 2.4%: structurally unlearnable), and
    # which under the unfloored shaped profile produced train reward
    # -4.3e10/step (round-4 biped attempt #1 — value targets that large
    # are equally unlearnable).  "indicator" = train-time shaping: cost =
    # (w/10) * count(contacts with force > 1 N) — bounded, same sign
    # structure, gradient survives.  Evals keep reference semantics.
    biped_contact_mode: str = "force_sq"   # "force_sq" | "indicator"

    frame_skip: int = 10                     # go1_mujoco_env.py:49
    max_episode_time: float = 120.0          # go1_mujoco_env.py:64
    max_unhealthy_time: float = 15.0         # go1_mujoco_env.py:130

    # observation scales, go1_mujoco_env.py:110-115
    obs_scale_lin_vel: float = 2.0
    obs_scale_ang_vel: float = 0.25
    obs_scale_dof_pos: float = 1.0
    obs_scale_dof_vel: float = 0.05
    clip_obs: float = 100.0                  # go1_mujoco_env.py:150

    tracking_sigma: float = 0.25             # go1_mujoco_env.py:116

    # healthy ranges, go1_mujoco_env.py:118-120 (note: applied to quat x/y
    # components via state_vector[4:6], replicating the reference quirk)
    healthy_z: tuple = (0.22, 1.8)
    healthy_pitch: tuple = (-np.pi, 0.0)
    healthy_roll: tuple = (-np.deg2rad(80), np.deg2rad(80))

    desired_vel_min: tuple = (-0.5, 0.0, 0.0)  # go1_mujoco_env.py:107-108
    desired_vel_max: tuple = (0.5, 0.0, 0.0)

    fallen_start_prob: float = 0.2           # go1_mujoco_env.py:953
    soft_joint_factor: float = 0.9           # go1_mujoco_env.py:134

    rewards: RewardWeights = dataclasses.field(default_factory=RewardWeights)
    costs: CostWeights = dataclasses.field(default_factory=CostWeights)
    biped_weights: BipedWeights = dataclasses.field(default_factory=BipedWeights)
    dr: DomainRandomization = dataclasses.field(
        default_factory=DomainRandomization
    )

    # bipedal ready pose, go1_mujoco_env.py:32-39 / reset 967-972
    biped_ready_joints: tuple = (
        0.0, 4.0, -2.0, 0.0, 4.0, -2.0, 0.0, 2.8, -1.2, 0.0, 2.8, -1.2,
    )
    biped_ready_height: float = 0.65
    biped_ready_pitch_deg: float = -95.0

    @property
    def dt(self) -> float:
        return self.frame_skip * 0.002

    @property
    def max_episode_steps(self) -> int:
        return int(self.max_episode_time / self.dt)

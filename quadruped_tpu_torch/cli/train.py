"""Training/eval CLI of the PyTorch port: flag-compatible with the JAX
package's quadruped_tpu/cli/train.py (every flag, default and choice).

Runs on the card; with QTPU_FORCE_CPU set it runs the plain PyTorch path
on the CPU instead, and without either it raises.  `--run test` loads a
policy artifact of the port, runs deterministic episodes and prints
per-episode stats and, with `--record_test_episodes`, renders each
episode to eval_videos/test_ep{i}_r{reward}.mp4.

Usage:
    python -m quadruped_tpu_torch.cli.train --run train --total_timesteps 5000000
    python -m quadruped_tpu_torch.cli.train --run test --model_path models/<run>/best_model
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from .. import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # ---- reference-compatible flags (train.py:141-225) ----------------------
    p.add_argument("--run", type=str, required=True, choices=["train", "test"])
    p.add_argument("--run_name", type=str, default=None,
                   help="Run name; saved under models/ with timestamp prefix.")
    p.add_argument("--num_parallel_envs", type=int, default=4096,
                   help="Parallel envs (reference default 12 subprocess envs;"
                        " here batched on the device).")
    p.add_argument("--num_test_episodes", type=int, default=5)
    p.add_argument("--record_test_episodes", action="store_true")
    p.add_argument("--total_timesteps", type=int, default=5_000_000)
    p.add_argument("--eval_frequency", type=int, default=300_000)
    p.add_argument("--model_path", type=str, default=None,
                   help="Checkpoint dir: resume (train) or policy (test).")
    # Interface flags use a None sentinel so run_test can tell "user
    # passed the flag" (non-None, even via argparse prefix abbreviation
    # or programmatic argv) from "parser default" without scanning
    # sys.argv (ADVICE r4 low).  main() fills the canonical defaults
    # right after parsing; the rest of the CLI never sees None.
    p.add_argument("--robot", type=str, choices=["go1", "go2"],
                   default=None,
                   help="go1 = reference robot (default); go2 = BASELINE "
                        "config 4 (authored asset, tools/gen_go2_assets.py)")
    p.add_argument("--ctrl_type", type=str, choices=["torque", "position"],
                   default=None, help="default: position")
    p.add_argument("--biped", action="store_true", default=None)
    p.add_argument("--video_duration", type=int, default=20)
    p.add_argument("--video_interval", type=int, default=300_000)
    p.add_argument("--rand_power", type=float, default=0.0)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--kl_target", type=float, default=None,
                   help="Adaptive-KL learning rate (legged_gym-style): "
                        "scale lr x1.5 / 1.5x per minibatch to hold "
                        "approx_kl near this target (try 0.01).  Default: "
                        "fixed --learning_rate.")
    p.add_argument("--seed", type=int, default=0)
    # ---- extras of the JAX package's CLI ---------------------------------------------------
    p.add_argument("--n_steps", type=int, default=32,
                   help="Rollout length per env per PPO iteration.")
    p.add_argument("--num_minibatches", type=int, default=32)
    p.add_argument("--n_epochs", type=int, default=10)
    # default "full" = the reference's collision semantics (every geom has
    # contype/conaffinity 1, so self-pairs are live); contact pools are
    # only available for the full table.  "plane" is the floor-only table
    # (every candidate a solver slot), the reference's learning-regression
    # env.
    p.add_argument("--collision", type=str, default="full",
                   choices=["plane", "full"])
    p.add_argument("--no_videos", action="store_true")
    p.add_argument("--checkpoint_interval", type=int, default=500_000)
    p.add_argument("--rollout_chunk", type=int, default=1,
                   help="Accepted for compatibility with the JAX package's "
                        "CLI and not read: the eager rollout has no program "
                        "time to bound.")
    p.add_argument("--gait_conditioning", action="store_true", default=None,
                   help="command-conditioned multi-gait (trot/pace/bound)")
    p.add_argument("--terrain", type=str, default="flat",
                   choices=["flat", "rough"],
                   help="procedural rough-terrain heightfield")
    p.add_argument("--terrain_amplitude", type=float, default=0.04)
    p.add_argument("--solver_iterations", type=int, default=None,
                   help="Newton iterations override (default: model opt, 15)")
    p.add_argument("--reward_profile", type=str, default="full",
                   choices=["full", "locomotion", "shaped"],
                   help="'full' is the reference's current reward stack "
                        "(go1_mujoco_env.py:69-89) incl. the fall-recovery "
                        "curriculum channels. 'locomotion' zeroes the "
                        "get_up(x20)/recovery(x10) channels and fallen "
                        "starts — the objective the reference's walking-era "
                        "models were actually trained on (models/2024-04-*; "
                        "under the full stack, farming recovery reward "
                        "while unhealthy pays ~25/step vs ~5.5/step for "
                        "healthy walking, so at gamma=0.99 a collapsed "
                        "policy is the true optimum; every shipped "
                        "reference artifact predates those channels). "
                        "'shaped' = locomotion + two documented TRAIN-TIME "
                        "deviations that restore a learnable gradient "
                        "(VERDICT r2 #1: the locomotion objective is still "
                        "reward-0 from init — max(0,r-c) floor + dynamic "
                        "accel cost): signed reward (no floor) and plain "
                        "qacc2 accel cost. Evals report REFERENCE-semantics "
                        "reward (runner builds a separate eval env).")
    p.add_argument("--action_mode", type=str, default=None,
                   choices=["raw", "centered"],
                   help="'raw' = reference semantics (action IS the "
                        "actuator ctrl; in position mode action=0 targets "
                        "straight legs -> collapse). 'centered' = ctrl is "
                        "re-based at the home keyframe (key_ctrl + "
                        "action_scale*action) so action=0 stands — the "
                        "walking-era parameterization; recorded in "
                        "checkpoint metadata and honored by --run test.")
    p.add_argument("--action_scale", type=float, default=None,
                   help="rad around key_ctrl for --action_mode centered "
                        "(default 0.3)")
    p.add_argument("--command_speed_floor", type=float, default=0.0,
                   help="anti-standing lever (a), VERDICT r3 #1: resample "
                        "the x-velocity command as sign*U(floor, 0.5) so "
                        "no training episode is trackable by standing "
                        "still (reference: U(-0.5,0.5), go1_mujoco_env.py"
                        ":1011-1015). Train-time only; evals keep "
                        "reference sampling. 0 = off.")
    p.add_argument("--stand_still_cost", type=float, default=0.0,
                   help="anti-standing lever (c): per-step cost while "
                        "healthy, commanded to move and ALL FOUR feet in "
                        "contact — vanishes the moment any foot swings. "
                        "Train-time only; evals keep reference semantics. "
                        "0 = off.")
    p.add_argument("--stand_still_mode", type=str, default="contact",
                   choices=["contact", "velocity"],
                   help="stand_still_cost trigger: 'contact' = all four "
                        "feet planted (dodgeable by stepping in place — "
                        "the 60M flagship did); 'velocity' = commanded-"
                        "direction speed < 30%% of the command (only real "
                        "translation escapes). Train-time only.")
    p.add_argument("--feet_airtime_bootstrap", type=float, default=0.0,
                   help="linear payment per foot touchdown with >= 0.1 s "
                        "airtime while commanded+healthy — the reachable "
                        "bootstrap for stepping (the reference's "
                        "(air-0.2)^2 payout is ~0 for the earliest "
                        "explorable swings). Train-time only. 0 = off.")
    p.add_argument("--eval_max_time", type=float, default=20.0,
                   help="Simulated seconds per eval episode during "
                        "training (reference show_duration_seconds, "
                        "train.py:93). Set 120 to evaluate full episodes "
                        "up to the truncation horizon.")
    p.add_argument("--contact_pools", type=str, default=None,
                   help="'K6,K3,K1' per-condim-class top-K solver slots "
                        "(condim row pools), e.g. '8,28,12'. Default: "
                        "uniform top-K (max_contacts).")
    p.add_argument("--max_unhealthy_time", type=float, default=None,
                   help="Seconds of continuous unhealthy time before "
                        "termination (reference: 15, go1_mujoco_env.py:130)."
                        " Lower values (e.g. 1.0) terminate fallen episodes"
                        " early — a fallen robot earns the floored-at-zero "
                        "reward, so its samples carry no gradient; early "
                        "reset densifies the learning signal without "
                        "touching the reward function. Default: reference "
                        "semantics (15 s).")
    p.add_argument("--best_metric", type=str, default="reward",
                   choices=["reward", "gait"],
                   help="best_model ranking: 'reward' = eval mean reward "
                        "(reference semantics). 'gait' = healthy_frac - "
                        "tracking_error; use when evals run under the "
                        "reference reward floor, where early eval rewards "
                        "are all exactly 0.0 and reward-ranked best "
                        "degenerates to 'first eval wins'.")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="Capture a torch.profiler trace of a few training "
                        "iterations to this directory (a Chrome trace JSON; "
                        "view it in chrome://tracing or Perfetto).")
    return p


#: Policy<->env interface flags: parser default is a None sentinel so
#: explicit-passing is detectable (ADVICE r4 low); these are the
#: canonical values filled in before any consumer reads them.
IFACE_DEFAULTS = {
    "robot": "go1", "ctrl_type": "position", "action_mode": "raw",
    "action_scale": 0.3, "biped": False, "gait_conditioning": False,
}


def fill_iface_defaults(args):
    """Record which interface flags were explicitly passed, then replace
    None sentinels with canonical defaults.  Idempotent; called by main()
    and defensively by make_config() for external parse_args users."""
    if not hasattr(args, "_explicit_iface"):
        args._explicit_iface = {
            k for k in IFACE_DEFAULTS
            if getattr(args, k, None) is not None
        }
        for k, v in IFACE_DEFAULTS.items():
            if getattr(args, k, None) is None:
                setattr(args, k, v)
    return args


def default_device() -> str:
    """The CLI's device: the card, or the CPU when QTPU_FORCE_CPU is set
    (the JAX package's switch for its CPU backend)."""
    return "cpu" if os.environ.get("QTPU_FORCE_CPU") else "cuda"


def make_config(args):
    """The Go1Config the flags select (the JAX package's make_env, less
    building the env)."""
    from ..env.config import Go1Config, RewardWeights

    fill_iface_defaults(args)
    extra = {}
    profile = getattr(args, "reward_profile", "full")
    if profile in ("locomotion", "shaped"):
        extra = dict(
            rewards=RewardWeights(recovery=0.0, get_up=0.0),
            fallen_start_prob=0.0,
        )
    if profile == "shaped":
        extra.update(reward_floor=False, accel_cost_mode="plain")
        if args.biped:
            # force-squared contact costs reach 1e8/step unfloored
            # (round-4 biped attempt #1: train reward -4.3e10); the
            # bounded indicator form keeps the objective learnable
            extra.update(biped_contact_mode="indicator")
    if getattr(args, "contact_pools", None):
        extra["contact_pools"] = tuple(
            int(x) for x in args.contact_pools.split(",")
        )
    if getattr(args, "max_unhealthy_time", None) is not None:
        extra["max_unhealthy_time"] = args.max_unhealthy_time
    if getattr(args, "action_mode", "raw") != "raw":
        extra["action_mode"] = args.action_mode
        extra["action_scale"] = args.action_scale
    if getattr(args, "command_speed_floor", 0.0):
        extra["command_speed_floor"] = args.command_speed_floor
    if getattr(args, "stand_still_cost", 0.0):
        extra["stand_still_cost"] = args.stand_still_cost
        extra["stand_still_mode"] = getattr(
            args, "stand_still_mode", "contact"
        )
    if getattr(args, "feet_airtime_bootstrap", 0.0):
        extra["feet_airtime_bootstrap"] = args.feet_airtime_bootstrap
    return Go1Config(
        robot=getattr(args, "robot", "go1"),
        ctrl_type=args.ctrl_type,
        biped=args.biped,
        rand_power=args.rand_power,
        solver_iterations=args.solver_iterations,
        gait_conditioning=args.gait_conditioning,
        terrain=args.terrain,
        terrain_amplitude=args.terrain_amplitude,
        collision_mode=args.collision,
        **extra,
    )


def make_env(args, device=None):
    from ..env.go1 import Go1Env

    return Go1Env(make_config(args),
                  device=default_device() if device is None else device)


def run_train(args, device=None):
    from ..learn.ppo import PPOConfig
    from ..learn.runner import Runner, RunnerConfig

    os.makedirs("models", exist_ok=True)
    os.makedirs("logs", exist_ok=True)
    env = make_env(args, device)
    ppo_cfg = PPOConfig(
        num_envs=args.num_parallel_envs,
        n_steps=args.n_steps,
        learning_rate=args.learning_rate,
        kl_target=args.kl_target,
        num_minibatches=args.num_minibatches,
        n_epochs=args.n_epochs,
        rollout_chunk=args.rollout_chunk or None,
    )
    run_cfg = RunnerConfig(
        total_timesteps=args.total_timesteps,
        eval_frequency=args.eval_frequency,
        video_interval=args.video_interval,
        video_duration=args.video_duration,
        run_name=args.run_name,
        save_videos=not args.no_videos,
        checkpoint_interval=args.checkpoint_interval,
        profile_dir=args.profile_dir,
        eval_max_time=args.eval_max_time,
        best_metric=args.best_metric,
    )
    runner = Runner(env, ppo_cfg, run_cfg)
    print(
        f"Training on {args.num_parallel_envs} envs on {env.device} "
        f"({args.ctrl_type}{', biped' if args.biped else ''}) for "
        f"{args.total_timesteps:,} timesteps"
    )
    return runner.train(
        seed=args.seed, resume_path=args.model_path,
        rand_power=args.rand_power,
    )


def load_for_test(args, device=None):
    """The playback setup of --run test -> (runner, ts, metadata): the env
    the artifact's metadata describes, a runner evaluating
    num_test_episodes full episodes, and the artifact's policy loaded.

    Self-describing artifacts: the checkpoint metadata records the
    policy<->env interface it was trained with (ctrl_type/action_mode);
    honor it unless the user explicitly passed the flag (None-sentinel
    detection, robust to argparse prefix abbreviations and programmatic
    argv).  Falls back to the run-level best_model metadata when a
    periodic checkpoint_N predates the interface fields."""
    from .. import checkpoint as ckpt
    from ..learn.ppo import PPOConfig
    from ..learn.runner import Runner, RunnerConfig

    if not args.model_path:
        raise SystemExit("--run test requires --model_path")
    explicit = getattr(args, "_explicit_iface", set())
    meta0 = {}
    for src in (Path(args.model_path),
                Path(args.model_path).parent / "best_model"):
        mp = src / "metadata.json"
        if mp.exists():
            meta0 = {**json.loads(mp.read_text()), **meta0}
    for k in ("ctrl_type", "action_mode", "action_scale", "robot",
              "biped", "gait_conditioning"):
        if k in meta0 and k not in explicit:
            setattr(args, k, meta0[k])
    env = make_env(args, device)
    runner = Runner(
        env,
        PPOConfig(num_envs=args.num_test_episodes, n_steps=4),
        RunnerConfig(
            n_eval_episodes=args.num_test_episodes,
            eval_max_time=env.cfg.max_episode_time,
            verbose=True,
        ),
    )
    ts = runner.trainer.init(args.seed)
    _policy, meta = ckpt.load_policy_any(args.model_path, ts)
    return runner, ts, meta


def run_test(args, device=None):
    """Playback mode (the capability the reference advertises but lacks)."""
    runner, ts, meta = load_for_test(args, device)
    print(f"loaded {args.model_path} (metadata: {meta})")
    gen = torch.Generator(device=runner.device).manual_seed(args.seed + 1)
    ep_rew, ep_len, success, out = runner.evaluate(ts, gen)
    for i in range(len(ep_rew)):
        print(
            f"episode {i}: reward {ep_rew[i]:9.2f}  length {ep_len[i]:5.0f}"
            f"  success {bool(success[i])}"
        )
    print(
        f"mean reward {ep_rew.mean():.2f} +- {ep_rew.std():.2f} over "
        f"{len(ep_rew)} episodes"
    )
    if args.record_test_episodes:
        from ..viz.render import render_trajectory

        cfg = runner.env.cfg
        every = max(1, int(1 / (cfg.dt * 30)))
        for i in range(len(ep_rew)):
            p = f"eval_videos/test_ep{i}_r{ep_rew[i]:.1f}.mp4"
            render_trajectory(
                out["qpos"][i][: int(ep_len[i])], p, cfg.ctrl_type, fps=30,
                every=every, robot=cfg.robot, device=runner.device,
            )
            print(f"  recorded {p}")
    return ep_rew, ep_len, success, out


def main(argv=None):
    device = resolve_device(default_device())
    args = fill_iface_defaults(build_parser().parse_args(argv))
    if args.run == "train":
        return run_train(args, device)
    return run_test(args, device)


if __name__ == "__main__":
    main()

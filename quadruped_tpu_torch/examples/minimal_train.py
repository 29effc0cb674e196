"""Minimal end-to-end example: train, evaluate, and render a Go1 policy.

The port's counterpart of examples/minimal_train.py: the same capability
is three objects — a batched env, a PPO trainer, and a Runner that owns
eval, videos and checkpoints — plus a rendered video of the final eval.

Run small on the CPU:  QTPU_FORCE_CPU=1 python -m quadruped_tpu_torch.examples.minimal_train
Run on the card:       python -m quadruped_tpu_torch.examples.minimal_train --num_envs 4096

Without QTPU_FORCE_CPU it runs on the card or raises.  The run writes
models/, logs/, training_videos/ and example_eval.mp4 into the working
directory.
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--num_envs", type=int, default=64)
    p.add_argument("--total_timesteps", type=int, default=50_000)
    p.add_argument("--n_steps", type=int, default=32)
    p.add_argument("--eval_max_time", type=float, default=20.0,
                   help="seconds of sim time per eval episode")
    p.add_argument("--solver_iterations", type=int, default=None,
                   help="Newton iterations (default: the model's)")
    args = p.parse_args(argv)

    import torch

    from quadruped_tpu_torch import resolve_device
    from quadruped_tpu_torch.env.config import Go1Config, RewardWeights
    from quadruped_tpu_torch.env.go1 import Go1Env
    from quadruped_tpu_torch.learn.ppo import PPOConfig
    from quadruped_tpu_torch.learn.runner import Runner, RunnerConfig
    from quadruped_tpu_torch.viz.render import render_trajectory

    device = resolve_device("cpu" if os.environ.get("QTPU_FORCE_CPU") else "cuda")

    # 1. the env: a batch of robots on one device.  `locomotion`
    #    objective = the reference's walking-era reward
    env = Go1Env(Go1Config(
        ctrl_type="torque",
        rewards=RewardWeights(recovery=0.0, get_up=0.0),
        fallen_start_prob=0.0,
        solver_iterations=args.solver_iterations,
    ), device=device)

    # 2. the trainer: rollout + GAE + clipped PPO updates on the device
    ppo_cfg = PPOConfig(num_envs=args.num_envs, n_steps=args.n_steps,
                        num_minibatches=4 if args.num_envs >= 4 else 1,
                        n_epochs=4)

    # 3. the runner: curriculum, periodic eval with gait metrics,
    #    best-model checkpoints, progress plots, videos
    runner = Runner(env, ppo_cfg, RunnerConfig(
        total_timesteps=args.total_timesteps,
        eval_frequency=args.total_timesteps // 2,
        eval_max_time=args.eval_max_time,
        run_name="example",
        save_videos=False,
    ))
    ts, _history, _run_dir = runner.train(seed=0)

    # direct programmatic eval: gait metrics beyond summed reward
    gen = torch.Generator(device=device).manual_seed(1)
    ep_rew, ep_len, _success, out = runner.evaluate(ts, gen)
    g = out["gait_metrics"]
    print(f"eval reward {float(ep_rew.mean()):.1f}  "
          f"healthy {g['healthy_frac']*100:.1f}%  "
          f"tracking err {g['tracking_error']:.3f} m/s")

    # 4. a video of the first eval episode
    every = max(1, int(1 / (env.cfg.dt * 30)))
    path = render_trajectory(out["qpos"][0][: int(ep_len[0])], "example_eval.mp4",
                             env.cfg.ctrl_type, fps=30, every=every,
                             device=device)
    print(f"video -> {path}")
    return path


if __name__ == "__main__":
    main()

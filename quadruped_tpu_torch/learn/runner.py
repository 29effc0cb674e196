"""Training orchestration: curriculum, evaluation, checkpoints.

Counterpart of quadruped_tpu/learn/runner.py, which replaces the
reference's SB3 callback stack (training_callback.py):
  * CurriculumCallback (24-69): rand_power annealed linearly to 0 over the
    first 70% of total timesteps — a plain schedule on TrainState
  * EnhancedVisualCallback (270-646): periodic deterministic evaluation
    (n_eval_episodes forced to 2, line 348), best-model saving,
    training_history.json, progress plot PNG, failure analysis
  * VideoRecordingCallback (649-756): the eval rollout's qpos is spooled
    to disk (native.TrajectoryLog) for an offline renderer
plus TensorBoard scalars and periodic full-resume checkpoints with
metadata JSON.

Where the reference bounds TPU program time, the port runs eagerly:
  * the evaluation steps the whole eval batch on the device, gathers its
    per-step outputs into (T, B, ...) device buffers and copies them to
    the host once (the reference's QTPU_EVAL_CHUNK has nothing to bound
    and is not read);
  * `profile_dir` records a torch.profiler trace of the same iterations
    (a Chrome trace JSON in that directory);
  * QTPU_PHASE_TIMING=1 splits each iteration into rollout and update,
    timed with a device synchronize after each.
The video step renders the first eval episode to
training_videos/*.mp4 (viz/render.py: mujoco where the host has it and a
GL context, else a cv2 wireframe from one batched fk on the device) and
prints the termination table.  A failed render prints one line and
training goes on, as in the reference.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from .. import checkpoint as ckpt
from ..env.go1 import GAIT_STANCE, EnvState, Go1Env
from ..physics.math import norm
from ..viz import plots
from .ppo import PPO, PPOConfig, TrainState


@dataclasses.dataclass(eq=False)
class RunnerConfig:
    total_timesteps: int = 5_000_000      # train.py:170
    eval_frequency: int = 300_000         # eval_freq = video_interval (train.py:90)
    video_interval: int = 300_000         # train.py:207
    video_duration: int = 20              # seconds of sim time per video
    n_eval_episodes: int = 2              # forced to 2 (training_callback.py:348)
    eval_max_time: float = 20.0           # show_duration_seconds (train.py:93)
    checkpoint_interval: int = 500_000    # metadata_N.json cadence
    curriculum_fraction: float = 0.7      # training_callback.py:49
    model_dir: str = "models"
    log_dir: str = "logs"
    run_name: str | None = None
    save_videos: bool = True
    video_fps: int = 30
    verbose: bool = True
    # profiling (SURVEY.md §5 TPU equivalent of the reference's wall-clock
    # prints): capture a jax.profiler trace of training iterations
    # [profile_start_iter, profile_start_iter + profile_iters) to
    # `profile_dir` (view with tensorboard or xprof)
    profile_dir: str | None = None
    profile_start_iter: int = 2       # skip compile on iteration 0
    profile_iters: int = 3
    # best-model ranking: "reward" = eval mean reward (reference
    # semantics, training_callback.py:470-491).  "gait" = healthy_frac
    # minus tracking_error — use for runs evaluated under the reference
    # reward floor, where every early eval reward is exactly 0.0 and
    # reward-ranked "best" degenerates to "first eval wins" (round-3
    # finding; see checkpoint.TrainingHistory).  The gait score rises
    # monotonically toward the tests/test_gait_gate.py bar (healthy>=0.8,
    # tracking<=0.15 -> score>=0.65).
    best_metric: str = "reward"
    # dead-signal guard (VERDICT r2 #2): if every reward in the rollout is
    # identically zero for this many consecutive iterations, advantages are
    # identically zero and PPO updates are no-ops — abort loudly with the
    # per-channel reward decomposition instead of burning TPU-hours (round
    # 2 lost ~5 h to four such runs).  0 disables.
    dead_signal_iters: int = 10


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_floats(metrics: dict) -> dict:
    """Metrics as Python floats, with one device-to-host copy."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).float().reshape(())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


class Runner:
    def __init__(self, env: Go1Env, ppo_cfg: PPOConfig, run_cfg: RunnerConfig,
                 trainer: PPO | None = None):
        self.env = env
        self.trainer = trainer or PPO(env, ppo_cfg)
        self.cfg = run_cfg
        self.device = self.trainer.device
        # evals keep REFERENCE reward semantics even when training uses
        # the shaped objective (config.py reward_floor/accel_cost_mode):
        # eval reward numbers stay comparable to the reference scale and
        # to runs trained without shaping.  Same physics, same weights —
        # only the floor and the accel formula are restored.
        ecfg = env.cfg
        if (not ecfg.reward_floor or ecfg.accel_cost_mode != "dynamic"
                or ecfg.command_speed_floor or ecfg.stand_still_cost
                or ecfg.feet_airtime_bootstrap
                or ecfg.biped_contact_mode != "force_sq"):
            self.eval_env = Go1Env(dataclasses.replace(
                ecfg, reward_floor=True, accel_cost_mode="dynamic",
                command_speed_floor=0.0, stand_still_cost=0.0,
                feet_airtime_bootstrap=0.0, biped_contact_mode="force_sq",
            ), device=env.device)
        else:
            self.eval_env = env

    # ------------------------------------------------------------- evaluation

    @torch.no_grad()
    def evaluate(self, ts: TrainState, generator: torch.Generator,
                 initial: EnvState | None = None):
        """Deterministic episodes of the eval env (runner.py:113-219) ->
        (ep_rew (B,), ep_len (B,), success (B,), out), numpy, with `out`'s
        per-step fields (B, T, ...) and out["gait_metrics"].  Envs start
        from n_eval_episodes resets drawn from `generator`, or from
        `initial` (tests inject the reference's reset states).  A done env
        freezes: its state, obs and totals stop, and its later steps are
        marked not valid."""
        env, policy = self.eval_env, ts.policy
        T = min(
            int(self.cfg.eval_max_time / self.env.cfg.dt),
            self.env.cfg.max_episode_steps,
        )
        state = initial
        if state is None:
            state = env.reset(self.cfg.n_eval_episodes, generator)
        obs = env.obs(state)
        n = state.qpos.shape[0]
        dev = state.qpos.device
        done = torch.zeros((n,), dtype=torch.bool, device=dev)
        ep_rew = torch.zeros((n,), dtype=torch.float32, device=dev)
        ep_len = torch.zeros((n,), dtype=torch.int32, device=dev)
        bufs = None
        for t in range(T):
            action, _ = policy.act_deterministic(obs.to(torch.float32))
            state2, obs2, reward, term, trunc, info = env.step(state, action)
            ep_rew = ep_rew + torch.where(done, torch.zeros_like(reward), reward)
            ep_len = ep_len + (~done).to(torch.int32)
            done2 = done | term | trunc
            state = state2.select(~done, state)
            obs = torch.where(done[:, None], obs, obs2)
            # gait-quality signals (VERDICT r1 weak #3: summed reward alone
            # cannot distinguish walking from reward farming)
            healthy, _reason = env._health(state2.qpos, state2.qvel)
            step_out = {
                "qpos": state.qpos,
                "reward": reward,
                "terminated": term & ~done,
                "termination_reason": info["termination_reason"],
                "distance_from_origin": info["distance_from_origin"],
                "bipedal_success": info["bipedal_success"],
                "valid": ~done,          # steps past episode end are frozen
                "healthy": healthy,
                "tracking_error": norm(
                    state2.desired_vel[:, :2] - state2.qvel[:, :2]),
                # the episode's commanded speed: lets the gait gate scale
                # its displacement floor by what was actually commanded
                "desired_speed": norm(state.desired_vel[:, :2]),
                # per-foot airtime accumulator (resets to 0 at touchdown):
                # touchdown events for _gait_metrics
                "feet_air": state2.feet_air_time,
                # commanded gait + shared clock: the per-gait
                # contact-pattern match rate
                "gait": state.gait,
                "gait_phase": state2.gait_phase,
                "reward_components": {
                    k: v for k, v in info.items()
                    if k.endswith("_reward") or k.endswith("_cost")
                    or k.startswith("reward_")
                },
            }
            if bufs is None:
                bufs = _tree_map(
                    lambda x: torch.empty((T,) + tuple(x.shape), dtype=x.dtype,
                                          device=x.device), step_out)
            _tree_store(bufs, step_out, t)
            done = done2
        # one device-to-host copy of every buffer, (T, B, ...) -> (B, T, ...)
        out = _tree_map(lambda x: np.moveaxis(x.cpu().numpy(), 0, 1), bufs)
        done = done.cpu().numpy()
        success = (~done) | out["bipedal_success"][:, -1]
        out["gait_metrics"] = self._gait_metrics(out, self.eval_env.cfg.dt)
        return ep_rew.cpu().numpy(), ep_len.cpu().numpy(), success, out

    @staticmethod
    def _gait_metrics(out, dt: float = 0.02) -> dict:
        """Aggregate gait-quality metrics over an eval batch (B, T).

        A reward-farming collapsed policy (VERDICT r1: eval lengths pinned
        at the 15-s unhealthy cap, get_up x20 dominating) shows up here as
        healthy_frac ~ 0 and tracking_error ~ |v_des|, where a walking
        policy has healthy_frac ~ 1 and tracking_error < 0.1 m/s."""
        valid = np.asarray(out["valid"], bool)
        healthy = np.asarray(out["healthy"], bool)
        err = np.asarray(out["tracking_error"], np.float64)
        nv = max(valid.sum(), 1)
        vh = valid & healthy
        metrics = {
            "healthy_frac": float((vh).sum() / nv),
            # tracking error over healthy time only: a fallen robot tracks
            # nothing, and counting it would double-penalize healthy_frac.
            # Zero healthy steps -> NaN, NOT 0.0: a fully collapsed policy
            # must not read as perfect tracking (and the parity harness's
            # reference side reports NaN for the same case)
            "tracking_error": float(
                (err * vh).sum() / vh.sum() if vh.sum() else float("nan")
            ),
            # final distance from origin of each episode, averaged
            "distance": float(
                np.asarray(out["distance_from_origin"])[:, -1].mean()
            ),
            # mean commanded speed across episodes — the displacement
            # yardstick for the hardened gait gate (VERDICT r3 next #2):
            # a walking policy covers ~|v_des|*T; a stander covers ~0
            "mean_desired_speed": float(
                np.asarray(out["desired_speed"])[:, 0].mean()
            ),
            # feet leave the ground at all, measured via the REFERENCE
            # airtime reward channel — which only pays swings LONGER than
            # 0.2 s (go1_mujoco_env.py airtime threshold), so a genuinely
            # stepping gait with sub-0.2 s swings reads 0.0 here; the
            # touchdowns metric below has no such threshold (ADVICE r4)
            # (masked to live steps — past-done steps re-step frozen state)
            "feet_airtime": float(
                (
                    np.asarray(
                        out["reward_components"].get(
                            "feet_airtime_reward", np.zeros_like(valid, float)
                        ),
                        np.float64,
                    )
                    * valid
                ).sum()
            ),
        }
        # threshold-free stepping detector: a touchdown is the airtime
        # accumulator resetting to 0 after >= 2 control steps airborne
        # (the 2-step floor rejects single-step contact-force jitter).
        # A stander's feet never leave the ground -> 0.0 exactly.
        fa = out.get("feet_air")
        if fa is not None:
            fa = np.asarray(fa, np.float64)              # (B, T, 4)
            touchdown = (fa[:, :-1, :] >= 2.0 * dt - 1e-9) & (
                fa[:, 1:, :] == 0.0
            )
            live = valid[:, 1:, None]
            sim_secs = max(float(valid.sum()) * dt, 1e-9)
            metrics["touchdowns_per_sec"] = float(
                (touchdown & live).sum() / sim_secs
            )
        # per-gait contact-pattern match rate (BASELINE config 5 success
        # criterion): fraction of foot-steps whose stance/swing state
        # matches the commanded gait's template at the shared clock
        # phase, over valid+healthy steps.  Stance <-> airtime
        # accumulator at 0 (it resets on touchdown, accumulates while
        # airborne — the same signal the airtime reward integrates).
        if fa is not None and "gait" in out and "gait_phase" in out:
            g_cmd = np.asarray(out["gait"])              # (B, T)
            phase = np.asarray(out["gait_phase"])        # (B, T)
            stance = fa == 0.0                           # (B, T, 4)
            tmpl = np.asarray(GAIT_STANCE)[g_cmd]        # (B, T, 4)
            expected = np.where(
                (phase < 0.5)[..., None], tmpl, 1.0 - tmpl
            )
            match = (stance == (expected > 0.5))
            live_h = (valid & healthy)[..., None]
            denom = max(float(live_h.sum() * 4), 1.0)
            metrics["gait_match_rate"] = float(
                (match & live_h).sum() / denom
            )
            for gi, gname in enumerate(("trot", "pace", "bound")):
                sel_g = live_h & (g_cmd == gi)[..., None]
                n_g = float(sel_g.sum() * 4)
                if n_g:
                    metrics[f"gait_match_rate/{gname}"] = float(
                        (match & sel_g).sum() / n_g
                    )
        for k, v in out["reward_components"].items():
            v = np.asarray(v, np.float64)
            metrics[f"channel/{k}"] = float((v * valid).sum() / nv)
        return metrics

    # ------------------------------------------------------------- metadata

    def _interface_metadata(self) -> dict:
        """The policy<->env interface a consumer must rebuild to evaluate
        a checkpoint of this run correctly (gait gate, --run test).
        Written into EVERY artifact's metadata — best_model and periodic
        checkpoints alike (ADVICE r3 medium)."""
        c = self.env.cfg
        return {
            "ctrl_type": c.ctrl_type,
            "action_mode": getattr(c, "action_mode", "raw"),
            "action_scale": float(getattr(c, "action_scale", 0.3)),
            "robot": getattr(c, "robot", "go1"),
            "biped": bool(c.biped),
            "gait_conditioning": bool(getattr(c, "gait_conditioning", False)),
        }

    # ----------------------------------------------------------- dead signal

    # distinct exit code: a supervisor treats it as fatal-do-not-restart
    # (a dead objective stays dead on relaunch)
    DEAD_SIGNAL_EXIT = 17

    def _dead_signal_abort(self, ts, eval_gen, dead_iters: int):
        """Every reward in the last `dead_iters` rollouts was exactly 0.0:
        zero advantages, no-op updates.  Print the per-channel reward
        decomposition so the objective can be diagnosed, then exit with a
        code a supervisor will not restart."""
        print(
            f"\nDEAD LEARNING SIGNAL: reward identically 0.0 for "
            f"{dead_iters} consecutive iterations — PPO updates are no-ops."
            f"\nPer-channel decomposition from a fresh eval rollout "
            f"(negative entries are costs; the max(0, rewards-costs) floor "
            f"swallows the gradient when costs dominate):",
            flush=True,
        )
        try:
            *_rest, out = self.evaluate(ts, eval_gen)
            for key, v in sorted(out["gait_metrics"].items()):
                if key.startswith("channel/"):
                    print(f"  {key[8:]:40s} {v:12.4f}", flush=True)
        except Exception as e:  # diagnosis must not mask the abort
            print(f"  (channel decomposition failed: {e})", flush=True)
        print(
            "Aborting. Preflight new objectives with "
            "tools/preflight_signal.py before launching.",
            flush=True,
        )
        raise SystemExit(self.DEAD_SIGNAL_EXIT)

    # ----------------------------------------------------------------- train

    def _iterate(self, ts: TrainState, phase_t: dict):
        """One PPO iteration -> (ts, metrics as floats).  With
        QTPU_PHASE_TIMING=1 the rollout and the update are timed apart,
        each ended by a device synchronize, into `phase_t`."""
        trainer = self.trainer
        if os.environ.get("QTPU_PHASE_TIMING") == "1":
            t0 = time.time()
            ts, traj = trainer.rollout(ts)
            _sync(self.device)
            phase_t["rollout_s"] = time.time() - t0
            t1 = time.time()
            ts, metrics = trainer.update_with_metrics(ts, traj)
            metrics = _host_floats(metrics)
            phase_t["update_s"] = time.time() - t1
            return ts, metrics
        ts, metrics = trainer.train_iteration(ts)
        return ts, _host_floats(metrics)

    def train(self, seed: int = 0, resume_path: str | None = None,
              rand_power: float = 0.0):
        cfg = self.cfg
        trainer = self.trainer
        run_name = time.strftime("%Y-%m-%d_%H-%M-%S")
        if cfg.run_name:
            run_name += f"-{cfg.run_name}"
        run_dir = Path(cfg.model_dir) / run_name
        run_dir.mkdir(parents=True, exist_ok=True)
        video_dir = Path("training_videos")

        ts = trainer.init(seed, rand_power=rand_power)
        history = ckpt.TrainingHistory()
        global_step = 0
        if resume_path:
            ts, meta = ckpt.load_train_state(resume_path, ts)
            global_step = int(meta.get("global_step", 0))
            hist_path = Path(resume_path) / "training_history.json"
            if hist_path.exists():
                history = ckpt.TrainingHistory.load(hist_path)
                if cfg.verbose:
                    print(f"resumed history from {hist_path}")
        history.set_score_metric(cfg.best_metric)

        writer = None
        try:
            # dependency-free scalar writer (utils/tb.py)
            from ..utils.tb import SummaryWriter

            writer = SummaryWriter(str(Path(cfg.log_dir) / run_name))
        except Exception:
            pass

        steps_per_iter = trainer.cfg.num_envs * trainer.cfg.n_steps
        eval_gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        next_eval = 0          # reference evaluates on the first step too
        next_video = cfg.video_interval
        next_ckpt = cfg.checkpoint_interval
        initial_rp = rand_power
        t_start = time.time()
        metrics = {}
        iteration = 0
        profiler = None
        dead_iters = 0  # consecutive identically-zero-reward iterations

        while global_step < cfg.total_timesteps:
            # curriculum: linear anneal to 0 over the first 70% of training
            progress = global_step / max(cfg.total_timesteps, 1)
            rp = max(
                0.0, initial_rp * (1 - progress / cfg.curriculum_fraction)
            ) if initial_rp > 0 else 0.0
            ts.rand_power = torch.tensor(rp, dtype=torch.float32,
                                         device=self.device)

            if cfg.profile_dir and iteration == cfg.profile_start_iter:
                profiler = _start_profiler(self.device)

            t_iter = time.time()
            phase_t = {}
            ts, metrics = self._iterate(ts, phase_t)
            iter_seconds = time.time() - t_iter
            for k, v in phase_t.items():
                metrics[f"phase_{k}"] = v
            if phase_t and cfg.verbose:
                print(
                    f"  iter {iteration}: "
                    + " ".join(f"{k} {v:.2f}s" for k, v in phase_t.items())
                    + f" | total {iter_seconds:.2f}s",
                    flush=True,
                )
            elif cfg.verbose:
                # one-line heartbeat: a stall supervisor watches log
                # mtime, and evals can be many iterations apart
                lr_note = (
                    f"  lr={metrics['lr_effective']:.2e}"
                    if "lr_effective" in metrics else ""
                )
                print(
                    f"  iter {iteration} done: {steps_per_iter/iter_seconds:,.0f} "
                    f"steps/s  r={float(metrics['mean_reward']):.3f}"
                    f"  kl={float(metrics.get('approx_kl', 0.0)):.4f}{lr_note}",
                    flush=True,
                )
            global_step += steps_per_iter
            step = global_step
            iteration += 1

            # dead-signal guard (VERDICT r2 #2)
            if cfg.dead_signal_iters:
                if float(metrics.get("reward_nonzero_frac", 1.0)) == 0.0:
                    dead_iters += 1
                else:
                    dead_iters = 0
                if dead_iters >= cfg.dead_signal_iters:
                    self._dead_signal_abort(ts, eval_gen, dead_iters)

            if profiler is not None and (
                    iteration >= cfg.profile_start_iter + cfg.profile_iters):
                _stop_profiler(profiler, cfg, iteration)
                profiler = None

            if writer:
                for k, v in metrics.items():
                    writer.add_scalar(f"train/{k}", float(v), step)
                writer.add_scalar("curriculum/rand_power", rp, step)
                writer.add_scalar(
                    "perf/iter_seconds", iter_seconds, step
                )
                writer.add_scalar(
                    "perf/env_steps_per_sec",
                    steps_per_iter / max(iter_seconds, 1e-9), step,
                )

            if step >= next_eval:
                next_eval = step + cfg.eval_frequency
                ep_rew, ep_len, success, out = self.evaluate(ts, eval_gen)

                # spool the eval trajectory through the native async writer
                # (never blocks on disk); an offline renderer reads it
                spool_path = run_dir / "trajectories" / f"eval_{step}.qtl"
                try:
                    from ..native import TrajectoryLog

                    spool_path.parent.mkdir(exist_ok=True)
                    with TrajectoryLog(
                        spool_path, out["qpos"].shape[-1]
                    ) as tl:
                        tl.append_batch(
                            step, out["reward"][0], out["qpos"][0]
                        )
                        tl.flush()
                except Exception as e:
                    print(f"  trajectory spool failed: {e}")
                mean_rew = float(ep_rew.mean())
                gait = out["gait_metrics"]
                score = (
                    gait["healthy_frac"] - gait["tracking_error"]
                    if cfg.best_metric == "gait" else mean_rew
                )
                is_best = history.append(
                    step, mean_rew, float(ep_len.mean()), bool(success.any()),
                    gait_metrics=gait, score=score,
                )
                history.save(run_dir / "training_history.json")
                try:
                    plots.save_progress_plot(history, "training_progress.png")
                    plots.save_progress_plot(
                        history, run_dir / "training_progress.png"
                    )
                except ImportError as e:
                    # matplotlib is an optional host package (the
                    # reference's "viz" extra): a missing plot must not
                    # kill training, as a failed video does not
                    print(f"  progress plot skipped: {e}")
                analysis = plots.failure_analysis(
                    {
                        "termination_reason": out["termination_reason"],
                        "distance_from_origin": out["distance_from_origin"],
                    }
                )
                if writer:
                    writer.add_scalar("eval/mean_reward", mean_rew, step)
                    writer.add_scalar(
                        "eval/mean_length", float(ep_len.mean()), step
                    )
                    for k, v in gait.items():
                        writer.add_scalar(f"eval/{k}", v, step)
                if is_best:
                    ckpt.save_policy(
                        run_dir / "best_model", ts.policy,
                        {
                            "global_step": step,
                            "mean_reward": mean_rew,
                            "best_metric": cfg.best_metric,
                            "score": float(score),
                            # self-describing artifact: consumers (gait
                            # gate, --run test) must rebuild the SAME env
                            **self._interface_metadata(),
                            "gait_metrics": gait,
                        },
                    )
                if cfg.verbose:
                    sps = step / max(time.time() - t_start, 1e-9)
                    print(
                        f"[{step:>12,}] eval reward {mean_rew:8.2f} "
                        f"(best {history.best_reward:8.2f}) "
                        f"len {float(ep_len.mean()):6.1f} "
                        f"| train reward {float(metrics['mean_reward']):6.3f} "
                        f"| {sps:,.0f} steps/s | rand_power {rp:.3f}"
                    )
                    print(
                        f"  gait: healthy {gait['healthy_frac']*100:5.1f}% "
                        f"| track err {gait['tracking_error']:.3f} m/s "
                        f"| dist {gait['distance']:.2f} m"
                    )
                    if analysis["failure_modes"]:
                        print(
                            "  failures:",
                            json.dumps(analysis["failure_modes"]),
                        )

                if cfg.save_videos and step >= next_video:
                    next_video = step + cfg.video_interval
                    from ..viz.render import TrajectoryRenderer, write_video

                    qpos_log = out["qpos"][0]  # first eval episode
                    n_frames = min(
                        len(qpos_log), cfg.video_duration * cfg.video_fps
                    )
                    # control rate is 50 Hz; subsample to ~video_fps
                    every = max(1, int(1 / (self.env.cfg.dt * cfg.video_fps)))
                    path = video_dir / (
                        f"training_t{step}_r{mean_rew:.1f}_"
                        f"{time.strftime('%Y%m%d_%H%M%S')}.mp4"
                    )
                    try:
                        # render_trajectory's steps, with the renderer kept
                        # to print which backend drew the video
                        renderer = TrajectoryRenderer(
                            self.env.cfg.ctrl_type, robot=self.env.cfg.robot,
                            device=self.device,
                        )
                        try:
                            write_video(path, renderer.frames(
                                qpos_log[: n_frames * every : every]),
                                cfg.video_fps)
                        finally:
                            renderer.close()
                        hist = plots.termination_histogram(
                            out["termination_reason"][
                                out["termination_reason"] != 0
                            ]
                        )
                        if cfg.verbose:
                            print(f"  video -> {path} ({renderer.backend})")
                            if hist:
                                print(plots.format_termination_table(hist))
                    except Exception as e:  # rendering must never kill training
                        print(f"  video rendering failed: {e}")

            if step >= next_ckpt:
                next_ckpt = step + cfg.checkpoint_interval
                ckpt.save_train_state(
                    run_dir / f"checkpoint_{step}", ts,
                    {
                        "global_step": step,
                        "learning_rate": trainer.cfg.learning_rate,
                        "num_envs": trainer.cfg.num_envs,
                        "n_steps": trainer.cfg.n_steps,
                        "clip_range": trainer.cfg.clip_range,
                        "rand_power": rp,
                        "mean_reward": float(metrics.get("mean_reward", 0.0)),
                        # policy<->env interface fields, SAME set best_model
                        # records (ADVICE r3 medium): without them, --run
                        # test on a periodic checkpoint would evaluate a
                        # centered policy in the wrong env
                        **self._interface_metadata(),
                    },
                )

        if profiler is not None:
            _stop_profiler(profiler, cfg, iteration)
        ckpt.save_train_state(
            run_dir / "final_model", ts,
            {"global_step": global_step},
        )
        history.save(run_dir / "training_history.json")
        if writer:
            writer.close()
        if cfg.verbose:
            print(f"training done: {run_dir}")
        return ts, history, run_dir


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _tree_store(bufs, tree, t: int):
    for k, v in tree.items():
        if isinstance(v, dict):
            _tree_store(bufs[k], v, t)
        else:
            bufs[k][t] = v


def _start_profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _stop_profiler(prof, cfg: RunnerConfig, iteration: int):
    prof.stop()
    out = Path(cfg.profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"trace_iters_{cfg.profile_start_iter}-{iteration - 1}.json"
    prof.export_chrome_trace(str(path))
    if cfg.verbose:
        print(f"profiler trace -> {path}")

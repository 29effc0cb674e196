"""The port's training CLI, runner and capacity probe.

Held against the JAX package: `build_parser().parse_args(argv)` gives
equal `vars` and `make_env` an equal `dataclasses.asdict` of the env
config on each argument set (both sides' Go1Env replaced by a stub that
returns its config: the configs are compared, no env is built).  Then on
the port alone, on the CPU (QTPU_FORCE_CPU): a CLI training run at 4 envs
x 2 steps on a cheap env (torque, condim pools, 2 Newton iterations,
"shaped" profile, so that the reward is live) with evals of 2 control
steps and a video due at every eval; its artifact tree, videos and
metadata; a resume from its first checkpoint; the dead-signal abort;
`--run test` on its best model with each episode recorded; a training
run on the floor-only table (`--collision plane`); and the capacity
probe.
"""

import contextlib
import dataclasses
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_tpu.cli import train as jcli
from quadruped_tpu_torch import checkpoint as tckpt
from quadruped_tpu_torch.cli import train as tcli
from quadruped_tpu_torch.env.config import Go1Config
from quadruped_tpu_torch.env.go1 import Go1Env
from quadruped_tpu_torch.learn.ppo import PPOConfig
from quadruped_tpu_torch.learn.runner import Runner, RunnerConfig

ARGSETS = {
    "defaults": [],
    "reference_flags": [
        "--run_name", "x", "--num_parallel_envs", "12",
        "--num_test_episodes", "5", "--record_test_episodes",
        "--total_timesteps", "1000", "--eval_frequency", "100",
        "--model_path", "m", "--ctrl_type", "torque", "--biped",
        "--video_duration", "10", "--video_interval", "500",
        "--rand_power", "0.5", "--learning_rate", "1e-4", "--seed", "3",
    ],
    "shaped_biped": ["--reward_profile", "shaped", "--biped",
                     "--ctrl_type", "torque", "--kl_target", "0.01"],
    "pools": ["--contact_pools", "8,28,12", "--solver_iterations", "8",
              "--ctrl_type", "torque", "--n_steps", "16",
              "--num_minibatches", "8", "--rollout_chunk", "0"],
    "centered": ["--action_mode", "centered", "--action_scale", "0.25",
                 "--robot", "go2", "--best_metric", "gait"],
    "rough_gait": ["--terrain", "rough", "--terrain_amplitude", "0.05",
                   "--gait_conditioning", "--reward_profile", "locomotion",
                   "--command_speed_floor", "0.2", "--stand_still_cost", "1.0",
                   "--stand_still_mode", "velocity",
                   "--feet_airtime_bootstrap", "0.5",
                   "--max_unhealthy_time", "1.0"],
}

# the cheap env of the port-only runs
CHEAP = ["--ctrl_type", "torque", "--contact_pools", "8,28,12",
         "--solver_iterations", "2", "--reward_profile", "shaped"]
TRAIN = ["--run", "train", *CHEAP, "--num_parallel_envs", "4",
         "--n_steps", "2", "--num_minibatches", "1", "--n_epochs", "1",
         "--eval_frequency", "8", "--eval_max_time", "0.04",
         "--checkpoint_interval", "8", "--video_interval", "8",
         "--run_name", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU path at these batch sizes runs on one intra-op
    thread: torch's thread pool only adds synchronization to tensors of a
    few envs, and stalls for seconds per control step when the host's
    cores are busy with other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(ARGSETS))
def test_parse_and_config_match_reference(name, monkeypatch):
    """Equal parsed flags (interface sentinels filled) and equal env
    configs."""
    from quadruped_tpu.env import go1 as jgo1
    from quadruped_tpu_torch.env import go1 as tgo1

    argv = ["--run", "train", *ARGSETS[name]]
    ja = jcli.fill_iface_defaults(jcli.build_parser().parse_args(argv))
    ta = tcli.fill_iface_defaults(tcli.build_parser().parse_args(argv))
    assert vars(ta) == vars(ja)
    monkeypatch.setattr(jgo1, "Go1Env", lambda cfg, **kw: cfg)
    monkeypatch.setattr(tgo1, "Go1Env", lambda cfg, **kw: cfg)
    jc = jcli.make_env(jcli.build_parser().parse_args(argv))
    tc = tcli.make_env(tcli.build_parser().parse_args(argv), device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_parser_flags_match_reference():
    """Every flag of the reference's parser with its default, type,
    choices and required flag."""
    def table(p):
        return {a.dest: (a.option_strings, a.default, a.type, a.choices,
                         a.required, a.nargs, a.const)
                for a in p._actions if a.dest != "help"}

    assert table(tcli.build_parser()) == table(jcli.build_parser())
    assert tcli.IFACE_DEFAULTS == jcli.IFACE_DEFAULTS


def _main(argv):
    """cli.train.main with its printed lines -> (result, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = tcli.main(argv)
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A CLI training run of 2 iterations (16 timesteps) from a fresh
    working directory, with the dead-signal guard at 1 iteration, ->
    (workdir, run_dir, ts, history, stdout)."""
    work = tmp_path_factory.mktemp("cli")
    init = Runner.__init__

    def guarded(self, *a, **kw):
        init(self, *a, **kw)
        self.cfg.dead_signal_iters = 1

    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        mp.setenv("QTPU_FORCE_CPU", "1")
        mp.setattr(Runner, "__init__", guarded)
        (ts, history, run_dir), out = _main(
            [*TRAIN, "--total_timesteps", "16", "--seed", "0"])
    return work, work / run_dir, ts, history, out


def test_train_artifact_tree(trained):
    """Best model, periodic checkpoints, final model, history with 2
    evals, spools of 2 records, plots, tfevents; the eval env keeps the
    reference reward semantics; a due video writes an MP4 of the first
    eval episode (one frame per control step at 30 fps) under
    training_videos/, named by step and eval reward; a live reward does
    not trip the guard."""
    import cv2

    from quadruped_tpu_torch.native import read_log

    work, run_dir, ts, history, out = trained
    files = {p.relative_to(run_dir).as_posix() for p in run_dir.rglob("*")
             if p.is_file()}
    assert files == {
        "best_model/metadata.json", "best_model/policy.pt",
        "checkpoint_8/metadata.json", "checkpoint_8/train_state.pt",
        "checkpoint_16/metadata.json", "checkpoint_16/train_state.pt",
        "final_model/metadata.json", "final_model/train_state.pt",
        "training_history.json", "training_progress.png",
        "trajectories/eval_8.qtl", "trajectories/eval_16.qtl",
    }
    assert (work / "training_progress.png").exists()
    (tb,) = list((work / "logs").rglob("events.out.tfevents.*"))
    assert tb.stat().st_size > 1000
    h = tckpt.TrainingHistory.load(run_dir / "training_history.json")
    assert h.series["timesteps"] == [8, 16] == history.series["timesteps"]
    for step in (8, 16):
        steps, rewards, qpos = read_log(run_dir / "trajectories" / f"eval_{step}.qtl")
        assert steps.tolist() == [step, step + 1] and qpos.shape == (2, 19)
        assert torch.isfinite(torch.as_tensor(qpos)).all()
    videos = sorted((work / "training_videos").glob("*.mp4"))
    assert [v.name.split("_")[1] for v in videos] == ["t16", "t8"]
    for v in videos:
        cap = cv2.VideoCapture(str(v))
        assert cap.get(cv2.CAP_PROP_FRAME_COUNT) == 2 and cap.read()[0]
        cap.release()
    assert out.count("  video -> training_videos/training_t") == 2
    assert "DEAD LEARNING SIGNAL" not in out
    assert ts.policy.log_std.device.type == "cpu"


def test_artifact_metadata_keys(trained):
    """The metadata key sets of runner.py:569-576 (best model), 637-651
    (checkpoint_N) and 656-659 (final model)."""
    _, run_dir, _, _, _ = trained
    iface = {"ctrl_type", "action_mode", "action_scale", "robot", "biped",
             "gait_conditioning"}
    best = json.loads((run_dir / "best_model" / "metadata.json").read_text())
    assert set(best) == {"global_step", "mean_reward", "best_metric", "score",
                         "gait_metrics"} | iface
    assert best["ctrl_type"] == "torque" and best["global_step"] in (8, 16)
    ck = json.loads((run_dir / "checkpoint_8" / "metadata.json").read_text())
    assert set(ck) == {"global_step", "learning_rate", "num_envs", "n_steps",
                       "clip_range", "rand_power", "mean_reward"} | iface
    assert (ck["global_step"], ck["num_envs"], ck["n_steps"]) == (8, 4, 2)
    final = json.loads((run_dir / "final_model" / "metadata.json").read_text())
    assert final == {"global_step": 16}


def test_resume_continues(trained, monkeypatch):
    """Resuming from checkpoint_8 (with the run's history beside it) runs
    one iteration (8 -> 16) from the saved params and Adam state, bit for
    bit, and appends its eval to the reloaded history.  Without
    matplotlib the progress plot is skipped with one line, and training
    goes on."""
    work, run_dir, _, _, _ = trained
    src = work / "resume_from"
    shutil.copytree(run_dir / "checkpoint_8", src)
    shutil.copy(run_dir / "training_history.json", src)
    saved = torch.load(src / "train_state.pt", weights_only=True)
    loaded = {}
    load = tckpt.load_train_state

    def spy(path, ts):
        ts, meta = load(path, ts)
        loaded["policy"] = {k: v.clone() for k, v in ts.policy.state_dict().items()}
        loaded["optimizer"] = {i: {k: v.clone() for k, v in s.items()} for i, s
                               in ts.optimizer.state_dict()["state"].items()}
        return ts, meta

    monkeypatch.chdir(work)
    monkeypatch.setenv("QTPU_FORCE_CPU", "1")
    monkeypatch.setattr(tckpt, "load_train_state", spy)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    (ts, history, run2), out = _main(
        [*TRAIN, "--run_name", "resumed", "--total_timesteps", "16",
         "--model_path", str(src)])
    assert out.count("  iter ") == 1 and "resumed history from" in out
    for k, v in saved["policy"].items():
        assert torch.equal(loaded["policy"][k], v), k
    assert loaded["optimizer"].keys() == saved["optimizer"].keys()
    for i, s in saved["optimizer"].items():
        for k, v in s.items():
            assert torch.equal(loaded["optimizer"][i][k], v), (i, k)
    assert history.series["timesteps"] == [8, 16, 16]
    final = json.loads((work / run2 / "final_model" / "metadata.json").read_text())
    assert final == {"global_step": 16}
    assert out.count("progress plot skipped") == 1
    assert not (work / run2 / "training_progress.png").exists()


def test_run_test_plays_artifact(trained, monkeypatch):
    """`--run test` on the run's best model: the env its metadata names
    (torque), deterministic episodes (max_episode_time cut to 2 control
    steps through make_env), per-episode lines, and with
    --record_test_episodes one MP4 per episode under eval_videos/."""
    work, run_dir, _, _, _ = trained
    monkeypatch.chdir(work)
    make_config = tcli.make_config
    envs = []

    def short_env(args, device=None):
        cfg = dataclasses.replace(make_config(args), max_episode_time=0.04)
        envs.append(Go1Env(cfg, device=device))
        return envs[-1]

    monkeypatch.setenv("QTPU_FORCE_CPU", "1")
    monkeypatch.setattr(tcli, "make_env", short_env)
    (ep_rew, ep_len, success, out), text = _main(
        ["--run", "test", "--model_path", str(run_dir / "best_model"),
         "--num_test_episodes", "2", "--contact_pools", "8,28,12",
         "--solver_iterations", "2", "--record_test_episodes"])
    assert envs[0].cfg.ctrl_type == "torque"
    assert ep_rew.shape == ep_len.shape == success.shape == (2,)
    assert out["qpos"].shape == (2, 2, 19)
    assert "episode 1: reward" in text
    names = [f"test_ep{i}_r{ep_rew[i]:.1f}.mp4" for i in range(2)]
    assert sorted(p.name for p in (work / "eval_videos").glob("*.mp4")) == sorted(names)
    assert text.count("  recorded eval_videos/test_ep") == 2


def test_run_test_plays_orbax_artifact(monkeypatch, tmp_path):
    """`--run test` on the JAX package's multi-gait best_model, read from
    its orbax params/ with no conversion: the env its metadata names
    (position servos, centered actions, gait conditioning), one episode
    cut to 2 control steps, the policy holding the checkpoint's weights."""
    from quadruped_tpu_torch.checkpoint.orbax_format import read_tree
    from quadruped_tpu_torch.convert import flax_pairs

    best = Path(__file__).resolve().parent.parent / "results" / "live" \
        / "multigait-r5" / "best_model"
    monkeypatch.chdir(tmp_path)
    make_config = tcli.make_config
    envs, loaded = [], []

    def short_env(args, device=None):
        cfg = dataclasses.replace(make_config(args), max_episode_time=0.04)
        envs.append(Go1Env(cfg, device=device))
        return envs[-1]

    load_policy_any = tckpt.load_policy_any

    def spy(path, ts):
        policy, meta = load_policy_any(path, ts)
        loaded.append(policy)
        return policy, meta

    monkeypatch.setenv("QTPU_FORCE_CPU", "1")
    monkeypatch.setattr(tcli, "make_env", short_env)
    monkeypatch.setattr(tckpt, "load_policy_any", spy)
    (ep_rew, ep_len, _success, out), text = _main(
        ["--run", "test", "--model_path", str(best), "--num_test_episodes",
         "1", "--contact_pools", "8,28,12", "--solver_iterations", "2"])
    cfg = envs[0].cfg
    assert (cfg.ctrl_type, cfg.action_mode, cfg.gait_conditioning) == (
        "position", "centered", True)
    assert envs[0].obs_dim == 53
    assert ep_len.tolist() == [2] and np.isfinite(ep_rew).all()
    assert np.isfinite(out["qpos"]).all() and "episode 0: reward" in text
    for param, value in flax_pairs(loaded[0], read_tree(best / "params")):
        assert np.array_equal(param.detach().numpy(), value)


class ZeroRewardEnv(Go1Env):
    def _reward(self, *a, **kw):
        reward, info, *rest = super()._reward(*a, **kw)
        return torch.zeros_like(reward), info, *rest


def test_dead_signal_abort(tmp_path, monkeypatch):
    """An objective whose reward is identically 0.0 aborts with exit
    code 17 after dead_signal_iters iterations, before its budget."""
    monkeypatch.chdir(tmp_path)
    env = ZeroRewardEnv(Go1Config(ctrl_type="torque", contact_pools=(8, 28, 12),
                                  solver_iterations=2), device="cpu")
    runner = Runner(
        env,
        PPOConfig(num_envs=4, n_steps=1, num_minibatches=1, n_epochs=1),
        RunnerConfig(total_timesteps=400, dead_signal_iters=2,
                     eval_frequency=10**9, n_eval_episodes=1,
                     eval_max_time=0.02, save_videos=False, verbose=False),
    )
    with pytest.raises(SystemExit) as ex:
        runner.train(seed=0)
    assert ex.value.code == Runner.DEAD_SIGNAL_EXIT == 17


def test_collision_plane_raises(tmp_path, monkeypatch):
    """--collision plane trains: one CLI iteration at 2 envs x 2 steps on
    the floor-only table (116 candidates, every one a solver slot) and
    an eval, with finite metrics and a best model."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QTPU_FORCE_CPU", "1")
    envs = []
    make_env = tcli.make_env

    def spy(args, device=None):
        envs.append(make_env(args, device))
        return envs[-1]

    monkeypatch.setattr(tcli, "make_env", spy)
    (ts, history, run_dir), _out = _main(
        ["--run", "train", "--collision", "plane", "--ctrl_type", "torque",
         "--solver_iterations", "2", "--num_parallel_envs", "2",
         "--n_steps", "2", "--num_minibatches", "1", "--n_epochs", "1",
         "--total_timesteps", "4", "--eval_frequency", "4",
         "--eval_max_time", "0.04", "--no_videos", "--run_name", "plane"])
    env = envs[0]
    assert env.cfg.collision_mode == "plane"
    assert env.pipeline.table.ncand == 116 and env.pipeline.layout.max_contacts is None
    assert history.series["timesteps"] == [4]
    assert all(np.isfinite(history.series["rewards"]))
    assert (tmp_path / run_dir / "best_model" / "policy.pt").exists()


def test_capacity_probe_smoke():
    from quadruped_tpu_torch.cli.capacity import probe

    with contextlib.redirect_stdout(io.StringIO()):
        res = probe([4, 8], steps=2, device="cpu")
    assert [r["n"] for r in res] == [4, 8]
    assert all(r["steps_per_sec"] > 0 and r["mem_gb"] is None for r in res)

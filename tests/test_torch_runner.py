"""The port's runner, gate and host-side copies, held against the JAX
package.

Eval and gate: the committed multi-gait artifact
(results/live/multigait-r5/best_model: position servos, centered
actions, gait conditioning with a 53-dim obs, evaluated under the
locomotion profile) goes through the JAX package's evaluate_gate (2
episodes of 0.1 s: 5 control steps on one JAX compile) and, converted to
a port artifact, through the port's, from the same initial states: the
reference's resets, drawn as runner.py:198-199 draws them.  Then the
host-side copies: _gait_metrics, TrainingHistory's JSON, the trajectory
spool's bytes, the tfevents writer's bytes and the run-analysis helpers
give the reference's results on the same inputs.
"""

import copy
import json
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from quadruped_tpu import checkpoint as jckpt
from quadruped_tpu.learn import gate as jgate
from quadruped_tpu.learn.runner import Runner as JRunner
from quadruped_tpu.models.actor_critic import Policy
from quadruped_tpu_torch import checkpoint as tckpt
from quadruped_tpu_torch.convert import state_from_jax, write_best_model
from quadruped_tpu_torch.learn import gate as tgate
from quadruped_tpu_torch.learn.runner import Runner as TRunner

ROOT = Path(__file__).resolve().parent.parent
ARTIFACT = ROOT / "results" / "live" / "multigait-r5" / "best_model"
EPISODES, EVAL_TIME, SEED = 2, 0.1, 1
# 5 control steps (10 substeps x 15 Newton iterations each) of a walking
# policy from standing resets: the two sides differ by float32 summation
# order and by the reference running its physics in float64 under the
# tests' x64 setting; held at 1e-3 of each output's scale, as the
# breadth tests hold one step.
TOL = 1e-3


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


def close(t, j, tol, name):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (name, t.shape, j.shape)
    scale = 1.0 + np.abs(j).max()
    np.testing.assert_allclose(t / scale, j / scale, atol=tol, rtol=0,
                               err_msg=name)


@pytest.fixture(scope="module")
def gated(tmp_path_factory):
    """(JAX verdict, port verdict, port artifact dir, the port's copy of
    the initial states)."""
    jv = jgate.evaluate_gate(ARTIFACT, episodes=EPISODES,
                             eval_time=EVAL_TIME, seed=SEED)
    jenv = jv["_env"]
    initial = jax.vmap(jenv.reset)(
        jax.random.split(jax.random.PRNGKey(SEED), EPISODES))
    like = Policy.make(act_dim=jenv.nu).init(jax.random.PRNGKey(0),
                                             obs_dim=jenv.obs_dim)
    params, meta = jckpt.load_policy(ARTIFACT, like)
    port_dir = tmp_path_factory.mktemp("artifact") / "best_model"
    write_best_model(port_dir, jax.tree.map(np.asarray, params), meta)
    tinitial = state_from_jax(jax.tree.map(np.asarray, initial), device="cpu")
    tv = tgate.evaluate_gate(
        port_dir, episodes=EPISODES, eval_time=EVAL_TIME, seed=SEED,
        device="cpu", initial=copy.deepcopy(tinitial),
    )
    return jv, tv, port_dir, tinitial


def test_eval_matches_reference(gated):
    """Episode returns and lengths, the qpos trajectory and every
    per-step output of the eval, from the same initial states."""
    jv, tv, *_ = gated
    jo, to = jv["_out"], tv["_out"]
    assert tv["_env"].obs_dim == 53 and tv["_env"].cfg.action_mode == "centered"
    np.testing.assert_array_equal(tv["_ep_len"], jv["_ep_len"])
    assert tv["mean_length"] == jv["mean_length"] == 5.0
    close(tv["mean_reward_reference_semantics"],
          jv["mean_reward_reference_semantics"], TOL, "ep_rew")
    assert set(to) == set(jo)
    assert set(to["reward_components"]) == set(jo["reward_components"])
    for k, j in jo.items():
        if k == "gait_metrics":
            continue
        if k == "reward_components":
            for c, jc in j.items():
                close(to[k][c], jc, TOL, c)
        elif np.asarray(j).dtype.kind in "biu":
            np.testing.assert_array_equal(to[k], j, err_msg=k)
        else:
            close(to[k], j, TOL, k)
    # the trajectory moved: the robots stepped, not stood
    assert np.abs(jo["qpos"][:, -1] - jo["qpos"][:, 0]).max() > 1e-3


def test_gait_metrics_and_gate_match_reference(gated):
    """The same gait_metrics key set, each value within the tolerance,
    and the gate's verdict: every number and every boolean."""
    jv, tv, *_ = gated
    jg, tg = jv["_out"]["gait_metrics"], tv["_out"]["gait_metrics"]
    assert set(tg) == set(jg)
    for k in jg:
        close(tg[k], jg[k], TOL, k)
    for k, j in jv.items():
        if k.startswith("_"):
            continue
        if isinstance(j, bool):
            assert tv[k] is j, k
        else:
            close(tv[k], j, TOL, k)


def test_port_artifact_layout(gated):
    """The converted artifact is a port best_model (policy.pt beside the
    reference's metadata.json) that loads on the CPU; the JAX artifact,
    read directly from its orbax params/, gives the same verdict as the
    converted one from the same initial states: every number and every
    boolean."""
    _, tv, port_dir, tinitial = gated
    assert sorted(p.name for p in port_dir.iterdir()) == ["metadata.json", "policy.pt"]
    assert json.loads((port_dir / "metadata.json").read_text()) == json.loads(
        (ARTIFACT / "metadata.json").read_text())
    direct = tgate.evaluate_gate(ARTIFACT, episodes=EPISODES,
                                 eval_time=EVAL_TIME, seed=SEED, device="cpu",
                                 initial=copy.deepcopy(tinitial))
    for k, v in tv.items():
        if not k.startswith("_"):
            assert direct[k] == v, k


def _fake_out(rng, B=3, T=12, dt=0.02):
    """A synthetic eval batch with every field _gait_metrics reads."""
    valid = np.ones((B, T), bool)
    valid[1, 7:] = False
    air = np.zeros((B, T, 4))
    for b in range(B):
        for f in range(4):
            run = 0.0
            for t in range(T):
                run = 0.0 if rng.uniform() < 0.35 else run + dt
                air[b, t, f] = run
    return {
        "valid": valid,
        "healthy": rng.uniform(size=(B, T)) < 0.8,
        "tracking_error": rng.uniform(0, 0.5, (B, T)),
        "distance_from_origin": rng.uniform(0, 2, (B, T)),
        "desired_speed": np.repeat(rng.uniform(0, 0.5, (B, 1)), T, 1),
        "feet_air": air,
        "gait": rng.integers(0, 3, (B, T)),
        "gait_phase": rng.uniform(0, 1, (B, T)),
        "reward_components": {
            "feet_airtime_reward": rng.uniform(0, 1, (B, T)),
            "linear_vel_tracking_reward": rng.uniform(0, 2, (B, T)),
            "action_rate_cost": -rng.uniform(0, 1, (B, T)),
            "reward_raw": rng.normal(size=(B, T)),
        },
    }


def test_gait_metrics_copy_equal():
    """_gait_metrics on the same synthetic batch: equal dicts, with and
    without the gait fields."""
    rng = np.random.default_rng(0)
    out = _fake_out(rng)
    assert TRunner._gait_metrics(out, 0.02) == JRunner._gait_metrics(out, 0.02)
    for drop in (("gait", "gait_phase"), ("feet_air",)):
        o = {k: v for k, v in out.items() if k not in drop}
        assert TRunner._gait_metrics(o) == JRunner._gait_metrics(o)


def test_training_history_interchangeable(tmp_path):
    """A history written by either side loads on the other and compares
    equal, gait series and best scores included."""
    rng = np.random.default_rng(1)
    for write, read in ((tckpt, jckpt), (jckpt, tckpt)):
        h = write.TrainingHistory()
        h.set_score_metric("gait")
        for i in range(4):
            g = {k: float(v) for k, v in zip(
                h.GAIT_FIELDS, rng.uniform(size=len(h.GAIT_FIELDS)))}
            h.append(1000 * (i + 1), float(rng.normal()), 50.0 + i, i % 2 == 0,
                     gait_metrics=g, score=float(rng.normal()))
        path = tmp_path / f"{write.__name__}.json"
        h.save(path)
        back = read.TrainingHistory.load(path)
        for attr in ("best_reward", "best_score", "score_metric", "series", "gait"):
            assert getattr(back, attr) == getattr(h, attr), attr
        back.save(tmp_path / "again.json")
        assert (tmp_path / "again.json").read_text() == path.read_text()


def test_spool_byte_identical(tmp_path):
    """The port's spool writes the reference's bytes for the same records,
    and each side reads the other's file."""
    from quadruped_tpu.native import TrajectoryLog as JLog, read_log as jread
    from quadruped_tpu_torch.native import TrajectoryLog as TLog, read_log as tread

    rng = np.random.default_rng(2)
    qpos = rng.normal(size=(30, 19)).astype(np.float32)
    rewards = rng.normal(size=30).astype(np.float32)
    for Log, name in ((JLog, "jax.qtl"), (TLog, "port.qtl")):
        with Log(tmp_path / name, 19) as tl:
            tl.append_batch(131072, rewards, qpos)
            tl.flush()
    assert (tmp_path / "jax.qtl").read_bytes() == (tmp_path / "port.qtl").read_bytes()
    for read, name in ((tread, "jax.qtl"), (jread, "port.qtl")):
        steps, r, q = read(tmp_path / name)
        np.testing.assert_array_equal(steps, 131072 + np.arange(30))
        np.testing.assert_array_equal(r, rewards)
        np.testing.assert_array_equal(q, qpos)


def test_tfevents_byte_identical(tmp_path, monkeypatch):
    """Under a patched clock the port's tfevents file has the reference's
    name and bytes."""
    from quadruped_tpu.utils.tb import SummaryWriter as JW
    from quadruped_tpu_torch.utils.tb import SummaryWriter as TW

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    for W, d in ((JW, "jax"), (TW, "port")):
        w = W(str(tmp_path / d))
        for step, v in ((0, 1.5), (131072, -2.25e-3), (2**40, float("nan"))):
            w.add_scalar("eval/mean_reward", v, step)
            w.add_scalar("train/approx_kl", v * 3, step)
        w.close()
    (jf,), (tf,) = (list((tmp_path / d).iterdir()) for d in ("jax", "port"))
    assert jf.name == tf.name
    assert jf.read_bytes() == tf.read_bytes()


def test_run_analysis_equal():
    """failure_analysis, termination_histogram and its table give the
    reference's results."""
    from quadruped_tpu.viz import plots as jp
    from quadruped_tpu_torch.viz import plots as tp

    rng = np.random.default_rng(3)
    infos = {"termination_reason": rng.integers(0, 6, (4, 40)),
             "distance_from_origin": rng.uniform(0, 3, (4, 40))}
    assert tp.failure_analysis(infos) == jp.failure_analysis(infos)
    h = tp.termination_histogram(infos["termination_reason"])
    assert h == jp.termination_histogram(infos["termination_reason"])
    assert tp.format_termination_table(h) == jp.format_termination_table(h)
    assert tp.TERMINATION_NAMES == jp.TERMINATION_NAMES


def test_checkpoint_roundtrip_cpu(tmp_path):
    """A train state saved and loaded on the CPU: params, Adam state,
    rand_power and the generator's stream come back bit for bit; the
    metadata beside them; lr_mult is not stored."""
    from quadruped_tpu_torch.env.config import Go1Config
    from quadruped_tpu_torch.env.go1 import Go1Env
    from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig

    env = Go1Env(Go1Config(ctrl_type="torque", contact_pools=(8, 28, 12)),
                 device="cpu")
    trainer = PPO(env, PPOConfig(num_envs=2, n_steps=2, n_epochs=1,
                                 num_minibatches=1))
    ts = trainer.init(0, rand_power=0.3)
    obs = torch.randn(4, env.obs_dim, generator=torch.Generator().manual_seed(0))
    loss = ts.policy(obs)[0].square().sum()
    loss.backward()
    ts.optimizer.step()
    ts.lr_mult.fill_(2.0)
    tckpt.save_train_state(tmp_path / "ck", ts, {"global_step": 7})
    want = torch.randn(3, generator=ts.generator)
    ts2 = trainer.init(1)
    ts2, meta = tckpt.load_train_state(tmp_path / "ck", ts2)
    assert meta == {"global_step": 7}
    for a, b in zip(ts.policy.parameters(), ts2.policy.parameters()):
        assert torch.equal(a, b)
    sa, sb = ts.optimizer.state_dict()["state"], ts2.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    assert float(ts2.rand_power) == np.float32(0.3)
    assert float(ts2.lr_mult) == 1.0
    assert torch.equal(torch.randn(3, generator=ts2.generator), want)
    policy, meta = tckpt.load_policy_any(tmp_path / "ck", ts2)
    assert policy is ts2.policy and meta["global_step"] == 7

"""Shared cases of the env-breadth parity tests (test_torch_env_breadth.py,
test_torch_env_levers.py): the port's Go1Env against the JAX env.

Each combined configuration runs one control step of step_autoreset from
the same injected float32 EnvState (the reference's own reset draws:
terrain, domain-randomized params, latencies, gaits), moved near the
keyframe, pitched 2.3 deg nose-down so the reference's health check (the
quaternion's y component must stay <= 0) holds, with env 1 forced to
truncate.  The reference's post-reset state of env 1 is injected into the
port as its reset (`fresh=`), since torch and JAX draw different numbers.

  cli     Go1 position servos at the training CLI's defaults: full
          collision table, 48 uniform 6-row slots, full reward profile;
  levers  Go2 position servos with centered actions on rough terrain,
          gait conditioning (53-dim obs), domain randomization with an
          actuator latency of up to 2 steps, and the "shaped" profile with
          the three anti-standing levers; env 2 copies env 0 with its
          friction multiplier changed;
  biped   Go1 torque biped on condim pools (8, 28, 12) with the
          reference's force-squared contact costs, env 0 with its front
          legs crossed a little (a self-collision slot active through the
          step).

Newton iterations are cut to 3 on both sides: the reference's solve
compiles unrolled, and each config's compile is most of its test time.
The test functions below are imported by the two test files, each with
its own `stepped` fixture over its configs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from quadruped_tpu.env import config as jcfg
from quadruped_tpu.env.go1 import Go1Env as JaxGo1Env
from quadruped_tpu_torch.convert import state_from_jax
from quadruped_tpu_torch.env import config as tcfg
from quadruped_tpu_torch.env.go1 import Go1Env

DONE = 1          # env forced to truncate on this step
ITERS = 3
PITCH = -0.02     # half-angle of the injected nose-down pitch (rad)


def config(mod, name, **over):
    """The named configuration, built from one package's config module."""
    shaped = dict(
        reward_floor=False, accel_cost_mode="plain",
        rewards=mod.RewardWeights(recovery=0.0, get_up=0.0),
        fallen_start_prob=0.0, command_speed_floor=0.2,
        stand_still_cost=1.0, stand_still_mode="velocity",
        feet_airtime_bootstrap=0.5,
    )
    kw = {
        "cli": dict(ctrl_type="position"),
        "levers": dict(
            robot="go2", ctrl_type="position", action_mode="centered",
            terrain="rough", gait_conditioning=True,
            dr=mod.DomainRandomization(enabled=True, max_latency_steps=2),
            **shaped),
        "biped": dict(ctrl_type="torque", biped=True,
                      contact_pools=(8, 28, 12)),
    }[name]
    kw.update(over)
    return mod.Go1Config(solver_iterations=ITERS, **kw)


def port_env(name, **over):
    return Go1Env(config(tcfg, name, **over), device="cpu")


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


def _inject(name, st, jenv, rng):
    """The step's start state: the reference's reset near its keyframe
    (on the drawn ground), with the fields each config's options read set
    so that their code paths do work."""
    B = st.qpos.shape[0]
    s = {f.name: np.array(getattr(st, f.name)) for f in dataclasses.fields(st)
         if f.name not in ("params", "rng")}
    if name == "levers":
        s["qpos"][:, 7:] += rng.normal(0, 0.01, (B, 12))   # z rides the field
    else:
        s["qpos"] = jenv.key_qpos + rng.normal(0, 0.01, (B, 19))
    s["qpos"][:, 3:7] = [np.cos(PITCH), 0.0, np.sin(PITCH), 0.0]
    s["qvel"] = rng.normal(0, 0.1, (B, 18))
    s["steps"] = np.full(B, 5, np.int32)
    s["steps"][DONE] = jenv.cfg.max_episode_steps - 1
    if name == "levers":
        s["feet_air_time"] = np.tile([0.15, 0.3, 0.15, 0.3], (B, 1))
        s["last_contacts"] = np.zeros((B, 4), bool)
        s["action_buf"] = rng.uniform(-1, 1, s["action_buf"].shape)
        s["latency"] = np.array([2, 1, 2], np.int32)
        s["gait"] = np.array([1, 2, 1], np.int32)
        s["gait_phase"] = np.array([0.3, 0.7, 0.3])
    if name == "biped":
        # front legs crossed a little: a self-collision slot stays active
        s["qpos"][0, 7], s["qpos"][0, 10] = 0.44, -0.44
        s["last_feet_forces"] = np.array([[3.0, 0, 5, 5], [0.5, 0.2, 5, 5]])
    for k in ("qpos", "qvel", "feet_air_time", "action_buf", "gait_phase",
              "last_feet_forces"):
        s[k] = s[k].astype(np.float32)
    if name == "levers":   # env 2: env 0 again
        for v in s.values():
            v[2] = v[0]
    return st.replace(**{k: jnp.asarray(v) for k, v in s.items()})


@functools.lru_cache(maxsize=None)
def run_case(name):
    """(name, JAX outputs (numpy), port outputs (torch), the reference's
    post-step state (numpy), the port's env) of one config."""
    jenv = JaxGo1Env(config(jcfg, name))
    B = 3 if name == "levers" else 2
    st = _f32(jax.jit(jax.vmap(jenv.reset))(
        jax.random.split(jax.random.PRNGKey(1), B)))
    rng = np.random.default_rng(0)
    st = _inject(name, st, jenv, rng)
    if name == "levers":   # env 2: env 0's params, friction scaled
        params = {k: np.array(v) for k, v in st.params.items()}
        for v in params.values():
            v[2] = v[0]
        params["geom_friction"][2] *= 1.3
        st = st.replace(params={k: jnp.asarray(v) for k, v in params.items()})
    action = rng.uniform(-1, 1, (B, 12)).astype(np.float32)
    if name == "levers":
        action[2] = action[0]
    out = _np(jax.jit(jax.vmap(jenv.step_autoreset))(st, jnp.asarray(action)))
    # the reference's post-step state holds its reset of the done env;
    # the port takes it as its reset there (its other rows go unused)
    fresh = out[0]
    tenv = port_env(name)
    tout = tenv.step_autoreset(
        state_from_jax(_np(st), device="cpu"), torch.as_tensor(action),
        fresh=state_from_jax(fresh, device="cpu"),
    )
    return name, out, tout, fresh, tenv


def close(t, j, tol, name):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (name, t.shape, j.shape)
    scale = 1.0 + np.abs(j).max()
    np.testing.assert_allclose(t / scale, j / scale, atol=tol, rtol=0,
                               err_msg=name)


# From near-keyframe states one control step (10 substeps x 3 Newton
# iterations) differs between the two sides only by float32 summation
# order (BLAS vs XLA), as in tests/test_torch_env.py; held at 1e-3 of each
# output's scale.
TOL = 1e-3
EXACT_INFO = ("bipedal_success", "termination_reason", "contact_overflow",
              "self_collision_cost", "collision_cost")


def test_step_matches(stepped):
    """Every reward_info key and its value, the step's obs, reward,
    terminated and truncated; the con_sel-dependent costs, the biped
    success flag and the counters exactly."""
    name, (jst, jobs, jrew, jterm, jtrunc, jinfo), (tst, tobs, trew, tterm,
                                                    ttrunc, tinfo), _, tenv = stepped
    assert set(tinfo) == set(jinfo)
    for key, j in jinfo.items():
        t = tinfo[key]
        if key in EXACT_INFO or j.dtype == bool:
            np.testing.assert_array_equal(t.numpy(), j.astype(t.numpy().dtype),
                                          err_msg=key)
        else:
            close(t, j, TOL, key)
    close(trew, jrew, TOL, "reward")
    np.testing.assert_array_equal(tterm.numpy(), jterm)
    np.testing.assert_array_equal(ttrunc.numpy(), jtrunc)
    assert bool(ttrunc[DONE]) and not bool(ttrunc[0])
    assert tobs.shape[1] == tenv.obs_dim == (53 if name == "levers" else 48)
    assert jinfo["reward_survive"][0] > 0, "env 0 must stay healthy"
    if name == "biped":
        assert jinfo["self_collision_cost"][0] < 0.0
        np.testing.assert_array_equal(tinfo["bipedal_success"].numpy(), [False, True])
    if name == "levers":
        for key in ("gait_pattern_reward", "stand_still_cost"):
            assert np.abs(jinfo[key]).max() > 0, key
        assert jinfo["feet_airtime_reward"][0] >= 0.5     # a bootstrap payment


def test_state_matches(stepped):
    """Every EnvState field of the envs that did not reset: floats at
    1e-3 scaled, integers, flags and the (passed-through) params
    exactly."""
    name, (jst, *_), (tst, *_), _, _ = stepped
    keep = [i for i in range(tst.qpos.shape[0]) if i != DONE]
    for f in dataclasses.fields(tst):
        t, j = getattr(tst, f.name), getattr(jst, f.name)
        if f.name == "params":
            assert set(t) == set(j)
            for k in t:
                np.testing.assert_array_equal(
                    t[k][keep].numpy(), j[k][keep].astype(np.float32), err_msg=k)
        elif t.dtype.is_floating_point:
            close(t[keep], j[keep], TOL, f.name)
        else:
            np.testing.assert_array_equal(t[keep].numpy(), j[keep], err_msg=f.name)


def test_autoreset_matches(stepped):
    """The done env takes the reference's reset state, params included,
    and its obs is the fresh post-reset observation (53 dims where
    gated)."""
    name, (jst, jobs, *_), (tst, tobs, *_), fresh, _ = stepped
    for f in dataclasses.fields(tst):
        t, j = getattr(tst, f.name), getattr(fresh, f.name)
        if f.name == "params":
            for k in t:
                np.testing.assert_array_equal(t[k][DONE].numpy(),
                                              j[k][DONE].astype(np.float32), err_msg=k)
        else:
            np.testing.assert_array_equal(
                t[DONE].numpy(), j[DONE].astype(t.numpy().dtype), err_msg=f.name)
    close(tobs[DONE], jobs[DONE], 1e-5, "obs after autoreset")

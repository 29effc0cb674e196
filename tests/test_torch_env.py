"""The port's control step and policy held against the JAX package.

One control step of the configuration of record (Go1 torque, full
collision table, condim pools (8, 28, 12), 8 warm-started Newton
iterations, 10 substeps) from the same injected float32 EnvState at
B = 2, both envs near the keyframe and well-conditioned; env 1 is one
step short of truncation, so step_autoreset resets it.  torch and JAX
draw different numbers, so the reference's reset state and policy noise
are computed on the JAX side and injected into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.env.config import Go1Config as JaxGo1Config
from quadruped_tpu.env.go1 import Go1Env as JaxGo1Env
from quadruped_tpu.models.actor_critic import Policy as JaxPolicy
from quadruped_tpu_torch.convert import policy_from_jax, state_from_jax
from quadruped_tpu_torch.env.config import Go1Config
from quadruped_tpu_torch.env.go1 import Go1Env
from quadruped_tpu_torch.models.actor_critic import ActorCritic

RECORD = dict(ctrl_type="torque", solver_iterations=8,
              contact_pools=(8, 28, 12))
DONE = 1   # env forced to truncate on this step


def _f32(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float32)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


@pytest.fixture(scope="module")
def stepped():
    jenv = JaxGo1Env(JaxGo1Config(**RECORD))
    B = 2
    st = _f32(jax.vmap(jenv.reset)(jax.random.split(jax.random.PRNGKey(1), B)))
    rng = np.random.default_rng(0)
    qpos = (jenv.key_qpos + rng.normal(0, 0.01, (B, 19))).astype(np.float32)
    qvel = rng.normal(0, 0.1, (B, 18)).astype(np.float32)
    steps = np.array([5, jenv.cfg.max_episode_steps - 1], np.int32)
    st = st.replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                    steps=jnp.asarray(steps))
    action = rng.uniform(-1, 1, (B, 12)).astype(np.float32)
    out = jax.jit(jax.vmap(jenv.step_autoreset))(st, jnp.asarray(action))
    # the reset state step_autoreset drew: reset(split(rng)[1]) with the
    # env's params and rand_power (go1.py:817-821)
    reset_keys = jax.vmap(lambda k: jax.random.split(k)[1])(st.rng)
    fresh = _f32(jax.vmap(
        lambda k, p, rp: jenv.reset(k, params=p, rand_power=rp)
    )(reset_keys, st.params, st.rand_power))

    np_tree = lambda t: jax.tree.map(np.asarray, t)
    tenv = Go1Env(Go1Config(**RECORD), device="cpu")
    tout = tenv.step_autoreset(
        state_from_jax(np_tree(st), device="cpu"), torch.as_tensor(action),
        fresh=state_from_jax(np_tree(fresh), device="cpu"),
    )
    return jax.tree.map(np.asarray, out), tout, np_tree(fresh)


def _close(t, j, tol, name):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (name, t.shape, j.shape)
    scale = 1.0 + np.abs(j).max()
    np.testing.assert_allclose(t / scale, j / scale, atol=tol, rtol=0,
                               err_msg=name)


# One control step is 10 substeps x 8 Newton iterations; from these
# well-conditioned states the only differences are float32 summation
# orders (BLAS vs XLA).  Measured: qpos ~1e-7, obs ~4e-6, qvel ~6e-6 and
# the warm-start qacc ~1.2e-4 of their scales; held at 1e-3.
TOL = 1e-3


def test_control_step_matches(stepped):
    (jst, jobs, jrew, jterm, jtrunc, jinfo), (tst, tobs, trew, tterm,
                                              ttrunc, tinfo), _ = stepped
    keep = [i for i in range(2) if i != DONE]
    _close(tinfo["terminal_observation"], jinfo["terminal_observation"], TOL,
           "obs of the step")
    for name in ("qpos", "qvel", "qacc_warm", "feet_air_time",
                 "last_feet_forces", "last_health_dev", "time_unhealthy"):
        _close(getattr(tst, name)[keep], getattr(jst, name)[keep], TOL, name)
    _close(trew, jrew, TOL, "reward")
    _close(tinfo["reward_raw"], jinfo["reward_raw"], TOL, "reward_raw")
    for key in ("linear_vel_tracking_reward", "joint_acceleration_cost",
                "reward_ctrl", "collision_cost", "orientation_cost"):
        _close(tinfo[key], jinfo[key], TOL, key)
    np.testing.assert_array_equal(tterm.numpy(), jterm)
    np.testing.assert_array_equal(ttrunc.numpy(), jtrunc)
    assert bool(ttrunc[DONE]) and not bool(ttrunc[keep[0]])
    np.testing.assert_array_equal(tst.last_contacts[keep].numpy(),
                                  jst.last_contacts[keep])
    np.testing.assert_array_equal(tst.steps[keep].numpy(), jst.steps[keep])


def test_autoreset_matches(stepped):
    """The done env takes the injected reset state, and its obs is the
    fresh post-reset observation (VecEnv semantics)."""
    (jst, jobs, *_), (tst, tobs, *_), fresh = stepped
    for name in ("qpos", "qvel", "qacc_warm", "desired_vel", "steps",
                 "last_action", "feet_air_time", "time_unhealthy"):
        t = getattr(tst, name)[DONE].numpy()
        # the reference draws its reset in float64 here (tests/conftest.py
        # turns x64 on) and selects it into the float32 state; the port's
        # state is float32, so compare at float32
        j = getattr(jst, name)[DONE].astype(t.dtype)
        np.testing.assert_array_equal(t, j, err_msg=name)
        np.testing.assert_array_equal(t, getattr(fresh, name)[DONE], err_msg=name)
    _close(tobs, jobs, 1e-5, "obs after autoreset")


def test_policy_sample_matches():
    """ActorCritic with weights carried from a flax tree: mean, value,
    action and log-prob of JAX Policy.sample, with its noise injected.
    float32 64-wide matmuls in another summation order: 1e-5."""
    jp = JaxPolicy.make(act_dim=12)
    variables = _f32(jp.init(jax.random.PRNGKey(0)))
    variables = jax.tree.map(
        lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(3), x.shape, x.dtype),
        variables)
    rng = np.random.default_rng(0)
    obs = rng.normal(0, 1, (5, 48)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    action, logp, value, mean = jp.sample(variables, jnp.asarray(obs), key)
    noise = jax.random.normal(key, mean.shape, mean.dtype)

    net = policy_from_jax(jax.tree.map(np.asarray, variables), device="cpu")
    ta, tl, tv, tm = net.sample(torch.as_tensor(obs), noise=torch.as_tensor(np.array(noise)))
    for name, t, j in (("action", ta, action), ("log_prob", tl, logp),
                       ("value", tv, value), ("mean", tm, mean)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    log_std = variables["params"]["log_std"]
    np.testing.assert_allclose(
        ActorCritic.entropy(net.log_std.detach()).numpy(),
        np.asarray(JaxPolicy.entropy(log_std)), rtol=1e-6)


def test_policy_init_shapes():
    net = ActorCritic(device="cpu", generator=torch.Generator().manual_seed(0))
    mean, log_std, value = net(torch.zeros(3, 48))
    assert mean.shape == (3, 12) and value.shape == (3,)
    assert torch.equal(log_std, torch.zeros(12))
    # orthogonal init with the reference's gains: hidden rows orthonormal
    # up to sqrt(2), action head 0.01
    w0 = net.actor[0].weight.detach()
    np.testing.assert_allclose((w0.T @ w0).numpy(), 2.0 * np.eye(48), atol=1e-5)
    w2 = net.actor[4].weight.detach()
    np.testing.assert_allclose((w2 @ w2.T).numpy(), 1e-4 * np.eye(12), atol=1e-9)

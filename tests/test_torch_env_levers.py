"""The port's Go1Env under the combined levers config, held against the
JAX env (the case and the shared checks are in torch_env_cases.py): Go2
position servos, centered actions, rough terrain, gait conditioning,
domain randomization with actuator latency, and the shaped profile with
the anti-standing levers; and the friction multiplier that changes no
step on either side.  Then, on the port alone (torch and JAX draw
different numbers): the reset's distributions, and PPO on the 53-dim gait
observation.
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig
from quadruped_tpu_torch.physics.terrain import height_normal
from torch_env_cases import (  # noqa: F401  (shared tests)
    port_env,
    run_case,
    test_autoreset_matches,
    test_state_matches,
    test_step_matches,
)


@pytest.fixture(scope="module", params=["levers"])
def stepped(request):
    return run_case(request.param)


def test_friction_multiplier_changes_nothing():
    """geom_friction is domain-randomized in params, but contact friction
    comes from the static collision table, on both sides (the reference's
    behaviour, kept): env 2 of the levers case, env 0 with its friction
    multiplier changed, steps exactly as env 0."""
    _, (jst, jobs, jrew, _, _, jinfo), (tst, tobs, trew, _, _, tinfo), _, _ = (
        run_case("levers"))
    assert not np.array_equal(jst.params["geom_friction"][2],
                              jst.params["geom_friction"][0])
    for side, (st, obs, rew, info) in (("jax", (jst, jobs, jrew, jinfo)),
                                       ("torch", (tst, tobs, trew, tinfo))):
        for what, x in (("qpos", st.qpos), ("qvel", st.qvel), ("obs", obs),
                        ("reward", rew), ("reward_raw", info["reward_raw"])):
            x = np.asarray(x)
            np.testing.assert_array_equal(x[2], x[0], err_msg=f"{side} {what}")


def test_reset_distributions():
    """The port's own resets over 4096 envs: commands in range, the speed
    floor keeping the sign and remapping the magnitude; domain-randomized
    params within their ranges, mass and inertia from one draw, never
    compounding over resets; latencies in [0, 2] and gaits in {0, 1, 2},
    each value drawn; the spawn height riding the terrain."""
    B = 4096
    env = port_env("levers")
    nominal = {k: torch.as_tensor(v, dtype=torch.float32)
               for k, v in env.m.params().items()}
    st = env.reset(B, torch.Generator().manual_seed(0))
    vx = st.desired_vel[:, 0]
    assert (vx.abs() >= 0.2 - 1e-6).all() and (vx.abs() <= 0.5 + 1e-6).all()
    assert (vx > 0).any() and (vx < 0).any()
    # the floor remaps the draw of a floorless reset from the same seed
    plain = port_env("levers", command_speed_floor=0.0).reset(
        B, torch.Generator().manual_seed(0))
    v0 = plain.desired_vel[:, 0]
    torch.testing.assert_close(vx, torch.sign(v0) * (0.2 + v0.abs() / 0.5 * 0.3))

    def factor(p, k):
        f = (p[k] / nominal[k]).reshape(B, -1)[:, nominal[k].reshape(-1) != 0]
        torch.testing.assert_close(f, f[:, :1].expand_as(f))
        return f[:, 0]

    dr = env.cfg.dr
    # a reset from an episode's randomized params draws from the nominal
    # ones again: no compounding
    again = env.reset(B, torch.Generator().manual_seed(1),
                      params={k: v * 1.2 for k, v in st.params.items()})
    for params in (st.params, again.params):
        for k, r in (("geom_friction", dr.friction_range),
                     ("body_mass", dr.mass_range), ("actuator_kp", dr.kp_range),
                     ("dof_damping", dr.damping_range)):
            f = factor(params, k)
            assert f.min() >= r[0] - 1e-6 and f.max() <= r[1] + 1e-6, k
            assert f.max() - f.min() > 0.5 * (r[1] - r[0]), k
        torch.testing.assert_close(factor(params, "body_inertia"),
                                   factor(params, "body_mass"))
        for k in ("dof_armature", "actuator_gear", "gravity"):
            assert torch.equal(params[k], nominal[k].expand_as(params[k]))
    assert set(st.latency.tolist()) == {0, 1, 2}
    assert set(st.gait.tolist()) == {0, 1, 2}
    h0, _ = height_normal(st.params, st.qpos[:, :2])
    torch.testing.assert_close(st.qpos[:, 2], env.key_qpos[2] + h0)
    assert h0.abs().max() > 0.005
    assert not torch.equal(st.params["terrain_amp"], again.params["terrain_amp"])


def test_ppo_sizes_by_the_gait_obs():
    """PPO builds its networks from env.obs_dim: on the 53-dim gait env it
    trains one tiny iteration on the CPU with finite metrics."""
    env = port_env("levers")
    trainer = PPO(env, PPOConfig(num_envs=4, n_steps=2, n_epochs=1,
                                 num_minibatches=1))
    ts = trainer.init(seed=0)
    assert ts.obs.shape == (4, 53)
    assert ts.policy.actor[0].in_features == 53
    ts, metrics = trainer.train_iteration(ts)
    assert all(torch.isfinite(v).item() for v in metrics.values())

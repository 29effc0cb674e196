"""The port's Go1Env held against the JAX env (the cases and the shared
checks are in torch_env_cases.py; the levers config is in
test_torch_env_levers.py): the training CLI's default env (Go1 position
servos, full table, 48 uniform 6-row slots, full reward profile), and
biped mode (Go1 torque on condim pools with the reference's force-squared
contact costs, one env with its front legs crossed a little).  Then, on
the port alone: the biped reset pose, and the "indicator" contact-cost
form against its formulas.
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.physics.forward import step_n
from torch_env_cases import (  # noqa: F401  (shared tests)
    port_env,
    run_case,
    test_autoreset_matches,
    test_state_matches,
    test_step_matches,
)


@pytest.fixture(scope="module", params=["cli", "biped"])
def stepped(request):
    return run_case(request.param)


def test_reset_biped_pose():
    """Biped resets stand in the ready pose (joints, 0.65 m, pitch -95
    deg) or start fallen at 0.1 m; no latency, gait 0, flat floor; and
    collision_mode="plane" maps to the full table with its self pairs."""
    env = port_env("biped")
    st = env.reset(512, torch.Generator().manual_seed(0))
    cfg = env.cfg
    fallen = st.qpos[:, 2] == np.float32(0.1)
    assert 0 < fallen.sum() < 512
    up = ~fallen
    n = int(up.sum())
    torch.testing.assert_close(st.qpos[up, 2], torch.full((n,), 0.65))
    half = np.deg2rad(cfg.biped_ready_pitch_deg) / 2
    q = torch.tensor([np.cos(half), 0.0, np.sin(half), 0.0], dtype=torch.float32)
    torch.testing.assert_close(st.qpos[up, 3:7], q.expand(n, 4))
    torch.testing.assert_close(
        st.qpos[up, 7:],
        torch.tensor(cfg.biped_ready_joints, dtype=torch.float32).expand(n, 12))
    assert "terrain_amp" not in st.params
    assert not st.latency.any() and not st.gait.any()
    plane = port_env("biped", collision_mode="plane")
    assert plane.pipeline.table.ncand == env.pipeline.table.ncand == 811
    assert plane.self_collision_mask.sum() == env.self_collision_mask.sum() > 0


def test_biped_indicator_costs():
    """biped_contact_mode="indicator" against its formulas (go1.py:721-726,
    755-758): w / 10 per front foot, and per unwanted-contact body, whose
    force norm exceeds 1 N; "force_sq" against w times the squared norms;
    on the same physics outputs of a standing and a crossed-legs state.
    Every other biped term is the same in both modes."""
    env_i = port_env("biped", biped_contact_mode="indicator")
    env_f = port_env("biped")
    B = 2
    qpos = torch.as_tensor(np.tile(env_i.key_qpos, (B, 1)), dtype=torch.float32)
    qpos[0, 7], qpos[0, 10] = 0.5, -0.5
    qpos[:, 2] -= 0.01
    _, _, data = step_n(env_i.pipeline, env_i.nominal_params(B), qpos,
                        torch.zeros(B, 18), torch.zeros(B, 12), 2)
    feet = data.cfrc_ext[:, [4, 7, 10, 13]].norm(dim=-1)
    unwanted = data.cfrc_ext[:, env_i.unwanted_contact_bodies].norm(dim=-1)
    bw = env_i.cfg.biped_weights
    _, ci = env_i._biped_terms(qpos, data, feet)
    _, cf = env_f._biped_terms(qpos, data, feet)
    torch.testing.assert_close(
        ci["biped_front_contact_cost"],
        (feet[:, :2] > 1.0).float().sum(-1) * bw.front_contact / 10)
    torch.testing.assert_close(
        ci["biped_unwanted_contact_cost"],
        (unwanted > 1.0).float().sum(-1) * bw.unwanted_contact / 10)
    torch.testing.assert_close(cf["biped_front_contact_cost"],
                               (feet[:, :2] ** 2).sum(-1) * bw.front_contact)
    torch.testing.assert_close(cf["biped_unwanted_contact_cost"],
                               (unwanted ** 2).sum(-1) * bw.unwanted_contact)
    assert (ci["biped_front_contact_cost"] > 0).any()
    assert (ci["biped_unwanted_contact_cost"] > 0).any()
    for k in ci:
        if k not in ("biped_front_contact_cost", "biped_unwanted_contact_cost"):
            assert torch.equal(ci[k], cf[k]), k
    assert ci["self_collision_cost"][0] > 0 and ci["self_collision_cost"][1] == 0

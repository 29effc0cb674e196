"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and skip elsewhere.  The file imports no
JAX, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_kernel_cuda.py -q -m cuda --noconftest

(--noconftest: tests/conftest.py configures JAX for the reference tests.)
Inputs come from the port's own pipeline at near-keyframe standing
states, where the float32 Newton solve is stable (chip_smoke.py covers
fallen-start and stiff states with its float64-referenced check).  The
kernel runs in both Gram modes ("vpu" on the CUDA cores, "mxu" on the
tensor cores), on the pooled and uniform contact layouts and on the
floor-only table's (collision_mode="plane": 116 slots whose condim runs
are its pools), at B = 1, 256 and 4099 (a
ragged last block); a batch and a permutation of it give bitwise the same
result per env, two launches are bitwise equal, and the phase profile's
cycles add up; the launch plan the kernel's host code computes fits the
card's shared memory, and layouts it cannot hold raise; a short PPO
train_iteration runs on the card; a train state saved on the card loads
on the CPU and the other way round, equal; 2 data-parallel gloo ranks on
the card agree with one process on the same batch; the gate on the JAX
package's orbax train state finds healthy full episodes; one control step of the
position-servo Go2 env, of the rough-terrain env and of the plane env
on the card agrees with the CPU.
"""

import numpy as np
import pytest
import torch

from quadruped_tpu_torch.env.config import Go1Config
from quadruped_tpu_torch.env.go1 import Go1Env
from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig
from quadruped_tpu_torch.ops import newton as N
from quadruped_tpu_torch.parallel.mesh import spawn_ranks
from quadruped_tpu_torch.physics.constraint import assemble
from quadruped_tpu_torch.physics.kinematics import fk
from quadruped_tpu_torch.physics.smooth import smooth_dynamics
from quadruped_tpu_torch.physics.solver import newton_args
from torch_parallel_ranks import (check_equivalence, iteration_rank,
                                  single_iteration)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", params=["pooled", "uniform", "plane"])
def inputs(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pools = (8, 28, 12) if request.param == "pooled" else None
    mode = "plane" if request.param == "plane" else "full"
    env = Go1Env(Go1Config(contact_pools=pools, collision_mode=mode,
                           solver_iterations=8), device="cuda")
    B = 256
    rng = np.random.default_rng(0)
    qpos = torch.as_tensor(
        (env.key_qpos + rng.normal(0, 0.005, (B, 19))).astype(np.float32)).cuda()
    qvel = torch.as_tensor(rng.normal(0, 0.1, (B, 18)).astype(np.float32)).cuda()
    ctrl = torch.as_tensor(rng.uniform(-0.5, 0.5, (B, 12)).astype(np.float32)).cuda()
    params = env.reset(B).params
    kin = fk(env.m, qpos, qvel)
    M, _L, _qf, qs, _qa = smooth_dynamics(env.m, params, kin, qpos, qvel, ctrl)
    efc = assemble(env.m, env.pipeline.layout, env.pipeline.table, kin, qpos, qvel)
    return newton_args(M, qs, torch.zeros_like(qs), efc)


def _scaled(k, p):
    return ((k - p).abs().amax(-1) / (1.0 + p.abs().amax(-1))).max().item()


@pytest.mark.parametrize("mode", N.GRAM_MODES)
def test_newton_kernel_matches_plain(inputs, mode):
    """2 iterations, every env within 1e-3 scaled as in tests/test_ops.py
    (stable float32 states: chip_smoke.py measured <= 3.2e-4 on such envs);
    the launch counter of the mode moves by one per launch, the other's
    not at all."""
    args, static = inputs
    before = dict(N.newton_solve.launches)
    k = N.newton_solve(*args, iterations=2, gram_mode=mode, **static)
    torch.cuda.synchronize()
    assert N.newton_solve.launches == {
        m: before[m] + (m == mode) for m in N.GRAM_MODES}
    p = N.newton_core_torch(*args, iterations=2, **static)
    for kk, pp, what in zip(k, p, ("qacc", "f", "qfrc")):
        assert _scaled(kk, pp) <= 1e-3, what


def test_newton_kernel_mxu_matches_vpu(inputs):
    """The two Gram modes at 2 iterations, 1e-3 scaled."""
    args, static = inputs
    v = N.newton_solve(*args, iterations=2, gram_mode="vpu", **static)
    m = N.newton_solve(*args, iterations=2, gram_mode="mxu", **static)
    for vv, mm, what in zip(v, m, ("qacc", "f", "qfrc")):
        assert _scaled(mm, vv) <= 1e-3, what


@pytest.mark.parametrize("mode", N.GRAM_MODES)
def test_newton_kernel_finite_at_8_iterations(inputs, mode):
    args, static = inputs
    for x in N.newton_solve(*args, iterations=8, gram_mode=mode, **static):
        assert torch.isfinite(x).all()


@pytest.mark.parametrize("mode", N.GRAM_MODES)
def test_gram_kernel_matches_float64(inputs, mode):
    """H of the first iteration alone, through the kernel's own staging,
    penalty and Gram device code, against a float64 gram_torch on the
    first iteration's weights: 1e-5 scaled by 1 + max |H| per env (the
    reference's MXU Gram measured ~2e-6)."""
    args, static = inputs
    J, M = args[3], args[0]
    z = (J @ args[2][..., None])[..., 0] - args[4]
    _f, w, U, wU = N.Penalty(J, *args[5:], **static).fw(z, True)
    H = N.gram(*args, gram_mode=mode, **static)
    H64 = N.gram_torch(*(x.double() for x in (J, w, U, wU, M)))
    err = (H.double() - H64).abs().amax((1, 2)) / (1.0 + H64.abs().amax((1, 2)))
    assert err.max().item() <= 1e-5


def _tiled(args, B):
    """The inputs' envs repeated to a batch of B."""
    reps = -(-B // args[0].shape[0])
    return [a.repeat(reps, *([1] * (a.dim() - 1)))[:B].contiguous() for a in args]


@pytest.mark.parametrize("mode", N.GRAM_MODES)
def test_newton_kernel_ragged_batches(inputs, mode):
    """B = 1 and B = 4096 + 3 (the last block holds fewer envs than the
    others): every env within 1e-3 of the plain version at 2 iterations,
    as at B = 256."""
    args, static = inputs
    for B in (1, 4096 + 3):
        a = _tiled(args, B)
        k = N.newton_solve(*a, iterations=2, gram_mode=mode, **static)
        p = N.newton_core_torch(*a, iterations=2, **static)
        for kk, pp, what in zip(k, p, ("qacc", "f", "qfrc")):
            assert kk.shape == pp.shape and _scaled(kk, pp) <= 1e-3, (B, what)


@pytest.mark.parametrize("mode", N.GRAM_MODES)
def test_newton_kernel_permutation_invariant(inputs, mode):
    """A batch and a permutation of it give bitwise the same result per
    env at 8 iterations: nothing leaks between the envs of a block."""
    args, static = inputs
    B = args[0].shape[0]
    perm = torch.as_tensor(np.random.default_rng(3).permutation(B)).cuda()
    k = N.newton_solve(*args, iterations=8, gram_mode=mode, **static)
    kp = N.newton_solve(*[a[perm].contiguous() for a in args], iterations=8,
                        gram_mode=mode, **static)
    for x, xp in zip(k, kp):
        assert torch.equal(x[perm], xp)


@pytest.mark.parametrize("mode", N.GRAM_MODES)
def test_newton_kernel_deterministic(inputs, mode):
    """Two launches on the same inputs are bitwise equal."""
    args, static = inputs
    k1 = N.newton_solve(*args, iterations=8, gram_mode=mode, **static)
    k2 = N.newton_solve(*args, iterations=8, gram_mode=mode, **static)
    assert all(torch.equal(x, y) for x, y in zip(k1, k2))


@pytest.mark.parametrize("mode", N.GRAM_MODES)
def test_newton_profile_phases(inputs, mode):
    """The profile entry: every phase's cycles positive for every env,
    their sum no more than the total; its solve agrees with the plain
    kernel's within 1e-5 scaled; no launch counted."""
    args, static = inputs
    before = dict(N.newton_solve.launches)
    *out, cyc = N.newton_profile(*args, iterations=8, gram_mode=mode, **static)
    torch.cuda.synchronize()
    assert N.newton_solve.launches == before
    assert cyc.shape == (args[0].shape[0], len(N.PHASES) + 1)
    assert bool((cyc[:, :-1] > 0).all())
    assert bool((cyc[:, :-1].sum(1) <= cyc[:, -1]).all())
    k = N.newton_solve(*args, iterations=8, gram_mode=mode, **static)
    for x, y in zip(out, k):
        assert _scaled(x, y) <= 1e-5


@pytest.mark.parametrize("mode", N.GRAM_MODES)
def test_newton_kernel_plan(inputs, mode):
    """The launch plan the kernel's host code computes: an env's shared
    arrays (J, then aref, z, jd, f and the tables) in a multiple of 16
    bytes, 1-4 envs per block within 227 KB of shared memory, no spills;
    at least 12 resident envs per SM on the pooled layout, 6 on the
    uniform one, 5 on the plane table's (384 rows, 43,600 bytes per env
    in chip_smoke.py's run)."""
    args, static = inputs
    nv, ne, K = args[0].shape[-1], args[3].shape[1], args[9].shape[1]
    r = N.kernel_resources(nv, static["nf"], static["nl"], K,
                           static["pool_dims"], mode)
    assert r["env_bytes"] % 16 == 0 and r["env_bytes"] >= 4 * ne * (nv + 4)
    assert 1 <= r["envs_per_block"] <= 4
    assert r["smem_bytes_per_block"] == r["envs_per_block"] * r["env_bytes"]
    assert r["smem_bytes_per_block"] <= 227 * 1024
    want = 5 if K == 116 else 12 if static["pool_dims"] else 6
    assert r["envs_per_sm"] >= want
    assert r["local_bytes"] == 0


def test_newton_kernel_refuses_layouts():
    """Layouts the kernel cannot hold raise before a launch: condim 7,
    256 slots (the active list packs a slot in 8 bits), and rows too few
    for jd and f to hold the 18 x 18 Gram."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for nf, nl, K, pools in ((12, 12, 4, ((4, 7),)), (12, 12, 256, None),
                             (0, 0, 1, ((1, 1),))):
        with pytest.raises(RuntimeError, match="cudaError"):
            N.kernel_resources(18, nf, nl, K, pools)


def test_train_iteration_on_card():
    """PPO.train_iteration at B = 256, T = 4 (2 epochs x 2 minibatches):
    finite metrics and params, params moved, 10 Newton launches per
    control step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = Go1Env(Go1Config(ctrl_type="torque", solver_iterations=8,
                           contact_pools=(8, 28, 12)), device="cuda")
    trainer = PPO(env, PPOConfig(num_envs=256, n_steps=4, n_epochs=2,
                                 num_minibatches=2))
    ts = trainer.init(0)
    before = [p.detach().clone() for p in ts.policy.parameters()]
    launches = sum(N.newton_solve.launches.values())
    ts, metrics = trainer.train_iteration(ts)
    torch.cuda.synchronize()
    assert sum(N.newton_solve.launches.values()) == launches + 40
    assert all(torch.isfinite(v).item() for v in metrics.values())
    after = list(ts.policy.parameters())
    assert all(torch.isfinite(p).all() for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(after, before))


def test_parallel_iteration_matches_single_process():
    """chip_smoke.py's parallel equivalence at a small size: 2 gloo ranks
    x 8 envs, each its own process on this card, against one process on
    the same 16 envs, fallen starts included (tests/torch_parallel_ranks.py:
    mean-sample policy, n_steps 2, one minibatch, one epoch): metrics and
    params within rtol 1e-5 / atol 1e-7, qpos within 1e-5 (a fallen env's
    within 3 x its noise floor over 8 moved runs where that is larger),
    the ranks' params bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ranks = spawn_ranks(iteration_rank, 2, (16, 0, "cuda"), 300.0)
    check_equivalence(ranks, single_iteration(16, 0, "cuda", moved=8))


def _same_train_state(a, b):
    """Params, Adam state and rand_power of two TrainStates, bit for bit
    (compared on the host)."""
    for p, q in zip(a.policy.parameters(), b.policy.parameters()):
        assert torch.equal(p.detach().cpu(), q.detach().cpu())
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        for k in sa[i]:
            assert torch.equal(sa[i][k].cpu(), sb[i][k].cpu()), (i, k)
    assert torch.equal(a.rand_power.cpu(), b.rand_power.cpu())


def test_checkpoint_card_to_cpu(tmp_path):
    """A train state saved on the card (capturable Adam with its step on
    the device, a CUDA generator) loads on the CPU, equal, and trains on;
    saved there, it loads back on the card, equal, and trains on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from quadruped_tpu_torch import checkpoint as ckpt

    cfg = Go1Config(ctrl_type="torque", solver_iterations=2,
                    contact_pools=(8, 28, 12))
    pcfg = PPOConfig(num_envs=8, n_steps=2, n_epochs=1, num_minibatches=1)
    card = PPO(Go1Env(cfg, device="cuda"), pcfg)
    cpu = PPO(Go1Env(cfg, device="cpu"), pcfg)
    ts, _ = card.train_iteration(card.init(0, rand_power=0.25))
    ckpt.save_train_state(tmp_path / "card", ts, {"global_step": 16})
    tc, meta = ckpt.load_train_state(tmp_path / "card", cpu.init(1))
    assert meta == {"global_step": 16}
    _same_train_state(ts, tc)
    assert all(s["step"].device.type == "cpu" for s in tc.optimizer.state.values())
    tc, metrics = cpu.train_iteration(tc)
    assert all(torch.isfinite(v).item() for v in metrics.values())
    ckpt.save_train_state(tmp_path / "cpu", tc)
    tg, _ = ckpt.load_train_state(tmp_path / "cpu", card.init(2))
    _same_train_state(tc, tg)
    assert all(s["step"].device.type == "cuda" for s in tg.optimizer.state.values())
    tg, metrics = card.train_iteration(tg)
    assert all(torch.isfinite(v).item() for v in metrics.values())


def test_gate_on_orbax_train_state():
    """The gate on the JAX package's results/walk_r5_progress (an orbax
    train_state/, read by the port's reader) at 2 s per episode on the
    card: healthy and full episodes, as the JAX package's 20-s gate found
    them on these weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pathlib import Path

    from quadruped_tpu_torch.learn.gate import evaluate_gate

    walk = Path(__file__).resolve().parent.parent / "results" / "walk_r5_progress"
    v = evaluate_gate(walk, episodes=8, eval_time=2.0)
    assert v["healthy_ok"] and v["length_ok"], v
    assert v["mean_length"] == 100.0


@pytest.mark.parametrize("option", ["go2_position", "rough_terrain", "plane"])
def test_control_step_matches_cpu(option):
    """One step_autoreset of the position-servo Go2 env (centered actions,
    10 Newton iterations, uniform slots) and of the rough-terrain env
    (tilted contact normals, 15 iterations) on the card against the plain
    path on the CPU, from the same near-keyframe states on the drawn
    ground at B = 16, and of the floor-only table (Go1 torque,
    collision_mode="plane", 116 slots), env 1 resetting into the same
    injected state: qpos,
    qvel and obs within 1e-3 scaled (chip_smoke.py holds every option so;
    the reward's "dynamic" acceleration cost divides by |qvel| + 1e-6
    and magnifies float32 rounding, so it is not held)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from quadruped_tpu_torch.physics.terrain import height_normal

    cfg = {"go2_position": Go1Config(robot="go2", ctrl_type="position",
                                     action_mode="centered"),
           "rough_terrain": Go1Config(ctrl_type="position", terrain="rough"),
           "plane": Go1Config(ctrl_type="torque", collision_mode="plane")}[option]
    env_c, env_g = Go1Env(cfg, device="cpu"), Go1Env(cfg, device="cuda")
    B = 16
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(0)
    st = env_c.reset(B, g)
    fresh = env_c.reset(B, g, params=st.params)
    qpos = torch.as_tensor(
        (env_c.key_qpos + rng.normal(0, 0.01, (B, 19))).astype(np.float32))
    if "terrain_amp" in st.params:
        qpos[:, 2] += height_normal(st.params, qpos[:, :2])[0]
    st.qpos = qpos
    st.qvel = torch.as_tensor(rng.normal(0, 0.1, (B, 18)).astype(np.float32))
    st.steps[1] = cfg.max_episode_steps - 1
    action = torch.as_tensor(rng.uniform(-1, 1, (B, 12)).astype(np.float32))

    def cuda(s):
        return type(s)(**{k: ({n: t.cuda() for n, t in v.items()}
                              if k == "params" else v.cuda())
                          for k, v in vars(s).items()})

    launches = N.newton_solve.launches["vpu"]
    out_c = env_c.step_autoreset(st, action, fresh=fresh)
    out_g = env_g.step_autoreset(cuda(st), action.cuda(), fresh=cuda(fresh))
    torch.cuda.synchronize()
    assert N.newton_solve.launches["vpu"] == launches + 10
    assert bool(out_g[4][1]) and bool(out_c[4][1])
    for what, c, k in (("qpos", out_c[0].qpos, out_g[0].qpos),
                       ("qvel", out_c[0].qvel, out_g[0].qvel),
                       ("obs", out_c[1], out_g[1])):
        assert _scaled(k.cpu(), c) <= 1e-3, what

"""The PyTorch port's static tables and math, held against the JAX package.

Model arrays, tree schedules, collision tables and constraint layouts are
numpy on both sides and must be equal array by array; the quaternion /
spatial / Cholesky helpers run float32 batches from a numpy seed through
both and agree to float32 rounding.  Also: the port imports no JAX, and
its entry points refuse what it does not implement.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quadruped_tpu.assets import robot_model as jax_robot_model
from quadruped_tpu.physics import collision as JCol
from quadruped_tpu.physics import constraint as JCon
from quadruped_tpu.physics import kinematics as JKin
from quadruped_tpu.physics import math as JM
from quadruped_tpu_torch.assets import robot_model
from quadruped_tpu_torch.env.config import Go1Config
from quadruped_tpu_torch.physics import collision as TCol
from quadruped_tpu_torch.physics import constraint as TCon
from quadruped_tpu_torch.physics import kinematics as TKin
from quadruped_tpu_torch.physics import math as TM

ROOT = Path(__file__).resolve().parent.parent
POOLS = {6: 8, 3: 28, 1: 12}


@pytest.fixture(scope="module")
def models():
    return jax_robot_model("go1", "torque"), robot_model("go1", "torque")


def _eq(a, b, name):
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], str):
        assert list(a) == list(b), name
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


def test_model_arrays_equal(models):
    jm, tm = models
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if f.name == "opt":
            for g in dataclasses.fields(a):
                _eq(getattr(a, g.name), getattr(b, g.name), f"opt.{g.name}")
        else:
            _eq(a, b, f.name)


def test_tree_tables_equal(models):
    jm, tm = models
    jl, tl = JKin.tree_levels(jm), TKin.tree_levels(tm)
    assert len(jl.levels) == len(tl.levels)
    for a, b in zip(jl.levels, tl.levels):
        for k in a:
            _eq(a[k], b[k], f"levels.{k}")
    for f in dataclasses.fields(jl):
        if f.name != "levels":
            _eq(getattr(jl, f.name), getattr(tl, f.name), f.name)
    _eq(JKin.ancestor_dof_mask(jm), TKin.ancestor_dof_mask(tm), "anc mask")
    _eq(JKin.ancestor_dof_pair_mask(jm), TKin.ancestor_dof_pair_mask(tm),
        "pair mask")


def test_collision_table_equal(models):
    jm, tm = models
    jt, tt = JCol.build_table(jm, "full"), TCol.build_table(tm, "full")
    assert jt.ncand == tt.ncand == 811
    assert [g.kind for g in jt.groups] == [g.kind for g in tt.groups]
    for ga, gb in zip(jt.groups, tt.groups):
        for f in dataclasses.fields(ga):
            _eq(getattr(ga, f.name), getattr(gb, f.name), f"{ga.kind}.{f.name}")


def test_invweights_match(models):
    # float64 on both sides (tests/conftest.py turns JAX x64 on); the two
    # take the same operations in different array libraries, so agreement
    # is to float64 rounding
    jm, tm = models
    for a, b in zip(JCon.invweights(jm), TCon.invweights(tm)):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("pools", [POOLS, None], ids=["pooled", "uniform"])
def test_layout_equal(models, pools):
    jm, tm = models
    jl = JCon.build_layout(jm, JCol.build_table(jm, "full"), 48, pools,
                           defer_cyl=pools is not None)
    tl = TCon.build_layout(tm, TCol.build_table(tm, "full"), 48, pools,
                           defer_cyl=pools is not None)
    for f in dataclasses.fields(jl):
        a, b = getattr(jl, f.name), getattr(tl, f.name)
        if f.name == "con_diagapprox":
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)
        elif f.name == "pools" and a is not None:
            for (ca, ia, ka), (cb, ib, kb) in zip(a, b):
                assert (ca, ka) == (cb, kb)
                _eq(ia, ib, "pool idx")
        else:
            _eq(a, b, f.name)
    np.testing.assert_allclose(
        TCon._packed_const(tl), JCon._packed_const(jl), rtol=1e-12, atol=0
    )


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize(
    "name", ["quat_mul", "quat_rotate", "quat_to_mat", "quat_integrate",
             "skew", "motion_cross", "force_cross", "euler_from_quat"],
)
def test_math_matches(name):
    # float32 elementwise formulas in the same operation order: agreement
    # to a few float32 ulps of O(1) values
    rng = np.random.default_rng(0)
    q = _rand(rng, 64, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v3, v6a, v6b = _rand(rng, 64, 3), _rand(rng, 64, 6), _rand(rng, 64, 6)
    args = {
        "quat_mul": (q, q[::-1].copy()),
        "quat_rotate": (q, v3),
        "quat_to_mat": (q,),
        "quat_integrate": (q, v3, 0.002),
        "skew": (v3,),
        "motion_cross": (v6a, v6b),
        "force_cross": (v6a, v6b),
        "euler_from_quat": (q,),
    }[name]
    ja = getattr(JM, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                             for a in args])
    ta = getattr(TM, name)(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                             for a in args])
    if not isinstance(ja, tuple):
        ja, ta = (ja,), (ta,)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=2e-6, rtol=1e-5)


def test_cholesky_matches():
    # 18x18 SPD batch in float32: the same right-looking sweep on both
    # sides; the solve takes another summation order (triangular solves),
    # so it agrees to float32 rounding times the condition number (~1e2)
    rng = np.random.default_rng(1)
    A = _rand(rng, 16, 18, 18)
    A = A @ np.swapaxes(A, -1, -2) + 18 * np.eye(18, dtype=np.float32)
    b = _rand(rng, 16, 18)
    jl = JM.chol_factor(jnp.asarray(A))
    tl = TM.chol_factor(torch.as_tensor(A))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=1e-5)
    jx = JM.chol_solve(jl, jnp.asarray(b))
    tx = TM.chol_solve(tl, torch.as_tensor(b))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-4)
    # a non-positive pivot gives NaN, which the solvers test for
    bad = A.copy()
    bad[:, 5, 5] = -1.0
    assert torch.isnan(TM.chol_factor(torch.as_tensor(bad))[:, -1, -1]).all()


def test_port_imports_no_jax():
    """The package and chip_smoke.py import with jax, flax, optax, orbax,
    tensorstore, zstandard and the JAX package blocked."""
    code = (
        "import sys\n"
        "for n in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tensorstore',\n"
        "          'zstandard', 'quadruped_tpu'):\n"
        "    sys.modules[n] = None\n"
        "import quadruped_tpu_torch\n"
        "from quadruped_tpu_torch import convert\n"
        "from quadruped_tpu_torch.env import go1\n"
        "from quadruped_tpu_torch.ops import newton, build\n"
        "from quadruped_tpu_torch.physics import forward, solver\n"
        "from quadruped_tpu_torch.models import actor_critic\n"
        "from quadruped_tpu_torch.learn import ppo, runner, gate\n"
        "from quadruped_tpu_torch import checkpoint, native\n"
        "from quadruped_tpu_torch.checkpoint import ocdbt, orbax_format, zstd\n"
        "from quadruped_tpu_torch.utils import tb\n"
        "from quadruped_tpu_torch.viz import plots\n"
        "from quadruped_tpu_torch.cli import train, capacity\n"
        "from quadruped_tpu_torch import mjcf, assets\n"
        "from quadruped_tpu_torch.viz import render, tools\n"
        "from quadruped_tpu_torch.monitor import server\n"
        "from quadruped_tpu_torch.examples import minimal_train\n"
        "from quadruped_tpu_torch.parallel import mesh, dryrun\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'tensorstore', 'zstandard', "
        "'quadruped_tpu') "
        "and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_precision_rule_set():
    import quadruped_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize(
    "overrides",
    [dict(ctrl_type="position"), dict(biped=True), dict(robot="go2"),
     dict(terrain="rough"), dict(gait_conditioning=True),
     dict(action_mode="centered"), dict(reward_floor=False),
     dict(stand_still_cost=1.0), dict(collision_mode="plane")],
    ids=lambda d: next(iter(d)),
)
def test_env_rejects_unported_options(overrides):
    """Every option builds, alone and with collision_mode="plane" beside
    it: the floor-only table of the robot (go1 116 candidates, go2 100),
    every candidate a solver slot (no top-K), except in biped mode, which
    maps "plane" to the full table (811) as the reference does."""
    from quadruped_tpu_torch.env.go1 import Go1Env

    if "collision_mode" not in overrides:
        env = Go1Env(Go1Config(**overrides), device="cpu")
        assert env.pipeline.table.ncand > 0
    plane = dict(overrides, collision_mode="plane")
    env = Go1Env(Go1Config(**plane), device="cpu")
    if plane.get("biped"):
        assert env.pipeline.table.ncand == 811
    else:
        ncand = 100 if plane.get("robot") == "go2" else 116
        assert env.pipeline.table.ncand == ncand
        assert env.pipeline.layout.max_contacts is None
        assert env.pipeline.layout.pools is None


def test_entry_points_default_to_cuda():
    """Without a card, the default device="cuda" raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable here")
    from quadruped_tpu_torch.env.go1 import Go1Env
    from quadruped_tpu_torch.learn.ppo import PPO, PPOConfig
    from quadruped_tpu_torch.models.actor_critic import ActorCritic

    with pytest.raises(RuntimeError):
        Go1Env(Go1Config(contact_pools=(8, 28, 12)))
    with pytest.raises(RuntimeError):
        ActorCritic()
    with pytest.raises(RuntimeError):
        PPO(None, PPOConfig())
    # the runner's entry points: Runner through its trainer, the gate,
    # the capacity probe and the training CLI (QTPU_FORCE_CPU unset)
    from quadruped_tpu_torch.cli import capacity
    from quadruped_tpu_torch.cli import train as cli
    from quadruped_tpu_torch.learn.gate import evaluate_gate
    from quadruped_tpu_torch.learn.runner import Runner, RunnerConfig

    with pytest.raises(RuntimeError, match="cuda"):
        Runner(Go1Env(Go1Config(contact_pools=(8, 28, 12))), PPOConfig(),
               RunnerConfig())
    artifact = ROOT / "results" / "live" / "multigait-r5" / "best_model"
    with pytest.raises(RuntimeError, match="cuda"):
        evaluate_gate(artifact, episodes=2, eval_time=0.02)
    with pytest.raises(RuntimeError, match="cuda"):
        capacity.probe([4], steps=1)
    # the renderer (its wireframe's fk runs on its device)
    from quadruped_tpu_torch.viz.render import TrajectoryRenderer

    with pytest.raises(RuntimeError, match="cuda"):
        TrajectoryRenderer()
    saved = os.environ.pop("QTPU_FORCE_CPU", None)
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(["--run", "train", "--num_parallel_envs", "4"])
    finally:
        if saved is not None:
            os.environ["QTPU_FORCE_CPU"] = saved

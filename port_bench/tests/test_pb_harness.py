"""The harness finds every configuration, traffic, limit and metric file
by name, a new cell or metric is only new files, the frozen Newton
counts agree with chip_smoke.py's, and a run refuses to report without a
card or with JAX loaded.  CPU only.

    python -m pytest port_bench/tests -q
"""

import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import counts, guard, spec  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    from port_bench.reference.env import config as ref_config
    from port_bench.reference.env.go1 import Go1Env as RefEnv
    from quadruped_tpu_torch.env import config as prog_config
    from quadruped_tpu_torch.learn.ppo import PPOConfig

    cell = spec.load_cell(workload)
    entry = spec.entry_module(cell.traffic["entry"])
    assert entry.METRIC in {m["name"] for m in cell.end_to_end}
    prog = spec.env_config(prog_config.Go1Config, cell.config)
    ref = spec.env_config(ref_config.Go1Config, cell.config)
    assert prog.ctrl_type == ref.ctrl_type == cell.config["env"]["ctrl_type"]
    ppo = spec.ppo_config(PPOConfig, cell.config, cell.traffic)
    assert ppo.num_envs == (cell.traffic["num_envs"] or cell.config["ppo"]["num_envs"])
    assert set(cell.limits) >= {"reset_gap", "policy_gap", "step_gap_p50",
                                "step_gap_p90", "done_mismatch", "reset_row_gap"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
    assert RefEnv(ref, device="cpu").obs_dim == 48


def test_every_file_named_exists():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        traffic = ROOT / "port_bench" / "traffic" / f"{w['traffic']}.json"
        assert traffic.is_file()
        entry = json.loads(traffic.read_text())["entry"]
        assert (ROOT / "port_bench" / "entries" / f"{entry}.py").is_file()
        assert (ROOT / "port_bench" / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"]:
        assert (ROOT / "port_bench" / "metrics" / f"{m['name']}.py").is_file()


def test_new_cell_and_metric_are_new_files_only(tmp_path):
    """A later cell (configuration, traffic, limits), a later entry the
    window drives and a later per-layer metric come as new files and new
    entries; no file there changes."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((ROOT / "port_bench/configs/go1_torque_record.json").read_text())
    cfg["name"] = "go1_plane"
    cfg["env"]["collision_mode"] = "plane"
    cfg["env"]["contact_pools"] = None
    (tmp_path / "port_bench/configs/go1_plane.json").write_text(json.dumps(cfg))
    (tmp_path / "port_bench/traffic/sim4k.json").write_text(json.dumps(
        dict(json.loads((ROOT / "port_bench/traffic/sim.json").read_text()),
             num_envs=4096)))
    (tmp_path / "port_bench/limits/go1_plane.sim4k.json").write_text(
        (ROOT / "port_bench/limits/go1_torque_record.sim16k.json").read_text())
    (tmp_path / "port_bench/entries/evaluate.py").write_text(
        '"""Entry `evaluate`: a later call the window can drive."""\n\n'
        'METRIC = "env_steps_per_s"\n\n\nclass Entry:\n'
        '    def __init__(self, su):\n        self.su = su\n')
    (tmp_path / "port_bench/traffic/eval8.json").write_text(json.dumps(
        dict(entry="evaluate", num_envs=8, length=8, warmup_steps=2,
             check=dict(rows=8, steps=4, record_from=1, record_calls=1),
             trace=dict(rollout_start=1, rollout_steps=1))))
    (tmp_path / "port_bench/metrics/physics.smooth_ms.sim.py").write_text(
        "from port_bench.harness import readers\n\n\ndef read(ctx):\n"
        "    return readers.timer_per_step_ms(ctx, 'smooth')\n")
    bench["configs"].append(dict(bench["configs"][0], name="go1_plane",
                                 file="port_bench/configs/go1_plane.json"))
    bench["workloads"].append(dict(name="go1_plane.sim4k", config="go1_plane",
                                   traffic="sim4k", chips=1, why="plane"))
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("go1_plane.sim4k")
    bench["per_layer"].append(dict(bench["per_layer"][-1], name="physics.smooth_ms.sim",
                                   workloads=["go1_plane.sim4k"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p.relative_to(ROOT): p.read_bytes()
              for p in (ROOT / "port_bench").rglob("*") if p.is_file()
              and "__pycache__" not in p.parts and "tests" not in p.parts}
    cell = spec.load_cell("go1_plane.sim4k", root=tmp_path)
    assert cell.config["env"]["collision_mode"] == "plane"
    assert cell.traffic["num_envs"] == 4096
    assert [m["name"] for m in cell.per_layer] == ["physics.smooth_ms.sim"]
    entry = spec.entry_module("evaluate", root=tmp_path)
    assert entry.METRIC == "env_steps_per_s" and callable(entry.Entry)
    read = spec.metric_reader("physics.smooth_ms.sim", root=tmp_path)
    assert read({"timer_ms": {"smooth": 30.0}, "control_steps": 3}) == 10.0
    assert read({}) is None
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


def _newton_inputs(B=6, nf=0, nl=4, pools=((8, 6), (28, 3), (12, 1)), seed=0):
    gen = torch.Generator().manual_seed(seed)
    nv, K = 18, sum(k for k, _ in pools)
    ne = nf + nl + sum(k * d for k, d in pools)
    args = [None] * 15
    args[0] = torch.randn(B, nv, nv, generator=gen)
    args[3] = torch.randn(B, ne, nv, generator=gen)
    args[12] = (torch.rand(B, K, generator=gen) < 0.3).float()
    return args, dict(nf=nf, nl=nl, pool_dims=pools)


@pytest.mark.parametrize("pools", [((8, 6), (28, 3), (12, 1)), None])
def test_newton_counts_frozen_copy_agrees(pools):
    import chip_smoke

    args, kw = _newton_inputs(pools=pools or ((48, 6),))
    kw["pool_dims"] = pools
    for active in (True, False):
        assert (counts.newton_counts(args, kw, 8, active)
                == chip_smoke.newton_counts(args, kw, 8, active))
    f, g, b = counts.newton_counts(args, kw, 8)
    assert counts.bound_ms(f, g, b, "vpu") == chip_smoke.bound_ms(f, g, b, "vpu")


@pytest.mark.parametrize("names, found", [
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client", "flax.linen", "optax", "orbax.checkpoint"],
     ["flax", "jaxlib", "optax", "orbax"]),
    (["quadruped_tpu.env.go1"], ["quadruped_tpu"]),
    (["quadruped_tpu_torch", "quadruped_tpu_torch.env.go1", "jaxfoo",
      "port_bench.harness"], []),
])
def test_guard_compares_whole_top_level_names(names, found):
    assert guard.forbidden_modules(names) == found


def test_run_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_refuses_with_jax_loaded(monkeypatch, capsys):
    import port_bench.run as run
    from port_bench.harness import cell

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(cell, "run_cell", lambda *a, **k: ({"correct": True}, []))
    monkeypatch.setattr(run, "pin_one_core", lambda: None)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", WORKLOADS[0], "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out.strip() == ""
    monkeypatch.delitem(sys.modules, "jax")
    assert run.main(["--workload", WORKLOADS[0], "--seed", "1",
                     "--seconds", "1"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "correct": True}


def test_newton_tap_keeps_the_launch_counter():
    """The tap replaces the module-level name that the program counts
    its launches through, so the counter has to stay reachable."""
    from port_bench.harness.trace import NewtonTap
    from quadruped_tpu_torch.ops import newton

    orig = newton.newton_solve
    tap = NewtonTap()
    tap.install()
    try:
        assert newton.newton_solve is not orig
        assert newton.newton_solve.launches is orig.launches
    finally:
        tap.remove()
    assert newton.newton_solve is orig

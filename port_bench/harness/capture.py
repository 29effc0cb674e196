"""The benchmark's hands on the timed path: the seeded weights and
episode counters it hands to both sides, and wrappers that record what
the program's rollout and update took in and gave out during the
window's recorded calls, for the reference to judge once the window
has closed.

The wrappers sit on the program's objects (the env's `step_autoreset`,
the policy's `sample`, the trainer's `update` and `_loss`, an optimizer
step hook) as instance attributes, and `close()` takes them off again.
They keep device clones of every row of every recorded control step
(some hundred MB at 16,384 envs), so that the check can pick the sampled
rows and every row that reset after the window, without a host sync
inside it."""

from __future__ import annotations

import dataclasses
import math

import torch

HIDDEN = (64, 64)


def weight_shapes(obs_dim: int, act_dim: int) -> dict:
    """name -> (shape, scale) of the actor-critic's parameters, named as
    the port's ActorCritic.named_parameters(); a weight's entries are
    N(0, 1) x gain / sqrt(fan_in) (gains sqrt 2 hidden, 0.01 for the
    action mean, 1 for the value), biases x 0.05, log-std x 0.1."""
    out = {"log_std": ((act_dim,), 0.1)}
    for head, width, gain in (("actor", act_dim, 0.01), ("critic", 1, 1.0)):
        sizes = (obs_dim, *HIDDEN, width)
        for i in range(3):
            g = gain if i == 2 else math.sqrt(2.0)
            out[f"{head}.{2 * i}.weight"] = ((sizes[i + 1], sizes[i]),
                                             g / math.sqrt(sizes[i]))
            out[f"{head}.{2 * i}.bias"] = ((sizes[i + 1],), 0.05)
    return out


def make_weights(seed: int, obs_dim: int, act_dim: int, device) -> dict:
    """The policy's weights from `seed`: one normal draw on the device,
    cut into the parameters and scaled."""
    shapes = weight_shapes(obs_dim, act_dim)
    total = sum(math.prod(s) for s, _ in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, (shape, scale) in shapes.items():
        n = math.prod(shape)
        out[name] = (flat[at:at + n] * scale).reshape(shape)
        at += n
    return out


def draw_counters(state, seed: int, lo: int, max_steps: int,
                  max_unhealthy: float, device) -> None:
    """Spreads the episode counters of a batch of fresh states as in
    steady-state training: `steps` uniform over [lo, max_steps) and
    `time_unhealthy` over [0, max_unhealthy), drawn from `seed`, so that
    rows truncate (and reset) inside the recorded steps."""
    gen = torch.Generator(device=device).manual_seed(seed)
    B = state.steps.shape[0]
    state.steps = torch.randint(lo, max_steps, (B,), generator=gen,
                                device=device, dtype=state.steps.dtype)
    state.time_unhealthy = (torch.rand(B, generator=gen, device=device)
                            * max_unhealthy).to(state.time_unhealthy.dtype)


def params_of(policy: torch.nn.Module) -> dict:
    """A copy of the policy's weights, by name."""
    return {k: p.detach().clone() for k, p in policy.named_parameters()}


def load_weights(policy: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into the program's policy, name by name."""
    named = dict(policy.named_parameters())
    if set(named) != set(weights):
        raise KeyError(f"the policy's parameters {sorted(named)} are not "
                       f"the benchmark's {sorted(weights)}")
    with torch.no_grad():
        for k, v in weights.items():
            if tuple(named[k].shape) != tuple(v.shape):
                raise ValueError(f"{k}: {tuple(named[k].shape)} != {tuple(v.shape)}")
            named[k].copy_(v)


class _Patch:
    """Sets attributes of an object, and puts back what was there."""

    def __init__(self, obj, **attrs):
        self.obj = obj
        self.saved = {k: obj.__dict__.get(k) for k in attrs}
        for k, v in attrs.items():
            setattr(obj, k, v)

    def undo(self):
        for k, v in self.saved.items():
            if v is None:
                delattr(self.obj, k)
            else:
                setattr(self.obj, k, v)


def copy_state(state) -> dict:
    """A copy of every field of an EnvState (params as a dict)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out[f.name] = ({k: x.clone() for k, x in v.items()} if isinstance(v, dict)
                       else v.clone())
    return out


class RolloutCapture:
    """Records every control step of the rollouts that run while it is
    on, every row: the policy's input and outputs with the generator
    state it drew its noise from, and the env's input state, action,
    generator state (for the reset draw) and outputs.  `weights` are the
    policy's weights when it was switched on."""

    def __init__(self, env, policy):
        self.env, self.policy = env, policy
        self.weights = params_of(policy)
        self.records: list[dict] = []
        self._sample, self._step = policy.sample, env.step_autoreset
        self._patches = [_Patch(policy, sample=self.sample),
                         _Patch(env, step_autoreset=self.step_autoreset)]

    def sample(self, obs, generator=None, noise=None):
        rec = dict(batch=obs.shape[0], obs=obs.clone(),
                   gen_policy=generator.get_state())
        self.records.append(rec)
        out = self._sample(obs, generator, noise)
        for name, x in zip(("action", "log_prob", "value"), out[:3]):
            rec[name] = x.clone()
        return out

    def step_autoreset(self, state, action, generator=None, fresh=None):
        rec = self.records[-1]
        rec.update(state=copy_state(state), action_in=action.clone(),
                   gen_reset=generator.get_state())
        out = self._step(state, action, generator, fresh)
        nxt, obs, reward, term, trunc, info = out
        rec.update(next_qpos=nxt.qpos.clone(), next_qvel=nxt.qvel.clone(),
                   obs_next=obs.clone(), reward=reward.clone(),
                   terminated=term.clone(), truncated=trunc.clone(),
                   terminal_obs=info["terminal_observation"].clone())
        return out

    def note_bootstrap(self, bootstrap: torch.Tensor, first: int):
        """The bootstrap values (T, B) that the rollout whose first step
        is record `first` wrote."""
        for t in range(bootstrap.shape[0]):
            self.records[first + t]["bootstrap"] = bootstrap[t].clone()

    def close(self):
        for p in self._patches:
            p.undo()


class UpdateCapture:
    """Records one update: its input (the rollout, the last observations,
    the generator state it draws its permutations from, the weights and
    Adam's state it starts from), the losses of its first `first`
    minibatch steps, the first gradient as Adam got it (from Adam's first
    moment before and after one step), the weights after `first` steps,
    and the number of optimizer steps the whole update took."""

    def __init__(self, trainer, ts, first: int):
        self.trainer, self.ts, self.first = trainer, ts, first
        self.losses, self.first_grad = [], None
        self.w_first = self.inputs = self.steps_taken = None
        self.n_steps = 0
        self._update, self._loss = trainer.update, trainer._loss
        self._patch = _Patch(trainer, update=self.update, _loss=self.loss)
        self._hook = ts.optimizer.register_step_post_hook(self.after_step)

    def _adam(self) -> dict:
        opt, out, step = self.ts.optimizer, {}, torch.zeros(())
        for k, p in self.ts.policy.named_parameters():
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                out[k] = (st["exp_avg"].detach().clone(),
                          st["exp_avg_sq"].detach().clone())
                step = torch.as_tensor(st["step"]).detach().clone()
            else:
                out[k] = (torch.zeros_like(p), torch.zeros_like(p))
        out["step"] = step
        return out

    def update(self, ts, traj, perms=None):
        self.inputs = dict(
            traj={f.name: getattr(traj, f.name).clone()
                  for f in dataclasses.fields(traj)},
            last_obs=ts.obs.clone(), gen=ts.generator.get_state(),
            w0=params_of(ts.policy), adam0=self._adam())
        out = self._update(ts, traj, perms)
        self.steps_taken = self.n_steps
        return out

    def loss(self, policy, batch):
        out = self._loss(policy, batch)
        if len(self.losses) < self.first:
            self.losses.append(out[0].detach().clone())
        return out

    def after_step(self, opt, args, kwargs):
        self.n_steps += 1
        named = dict(self.ts.policy.named_parameters())
        if self.n_steps == 1:
            beta1 = opt.param_groups[0]["betas"][0]
            m0 = self.inputs["adam0"]
            self.first_grad = {
                k: (opt.state[p]["exp_avg"].detach() - beta1 * m0[k][0]) / (1 - beta1)
                for k, p in named.items()}
        if self.n_steps == self.first:
            self.w_first = {k: p.detach().clone() for k, p in named.items()}

    def close(self):
        self._hook.remove()
        self._patch.undo()

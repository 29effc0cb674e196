"""How `correct` is decided: the plain reference (port_bench/reference)
works out again what the program produced during the window's recorded
calls, and each number compared is held to the cell's limit.

The reference runs in float64 and evaluates every contact candidate as
a solver slot (no pool, no top-K).  It follows the program step by step:
for the sampled control steps and rows, and for every row that reset at
any recorded step, it takes the program's input state and action and
computes the step with its reset from them; for a training cell's
recorded update it takes the program's rollout, weights and Adam state
at the update's start, and runs its first minibatch steps.  The whole
update's weights are not compared: float32 and float64 part where a
sample's ratio lies within a rounding of the clip's edge, which changes
that minibatch's gradient by ~1% and every step after it; its optimizer
steps are counted instead.  The start (the reset
states) is checked by itself.

Numbers (each the larger the worse; a NaN reads as infinity):
  reset_gap       widest scaled gap of the initial states and observations
  policy_gap      widest scaled gap of action, log-prob and value on the
                  sampled rows
  step_gap_p50    median over sampled rows and steps of the row's widest
  step_gap_p90    scaled gap of next qpos, qvel, observations (terminal and
                  after reset), reward and bootstrap value; 90th percentile
  done_mismatch   rows whose terminated or truncated flag differs: every
                  re-stepped row, and every row of every recorded step for
                  truncation (a function of the episode counter)
  reset_row_gap   widest scaled gap of the state and observation after the
                  reset, over every row that reset at a recorded step
  loss_gap        widest relative gap of the first minibatch steps' losses
  grad_gap        worst leaf: gap of the first gradient's norms (after the
                  clip), against the larger of the leaf's and the median
                  leaf's reference norm
  update_gap      worst leaf: gap of the norms of the weights' change after
                  the first steps, same scale; leaves whose reference
                  gradient is under 1e-3 of the median leaf's are left out
  update_steps_missing  optimizer steps the whole update should have
                  taken (n_epochs x num_minibatches) and did not
A scaled gap of a row is max |a - b| / (1 + max |b|)."""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from ..reference import ppo as ref_ppo

POLICY_KEYS = ("action", "log_prob", "value")
STEP_KEYS = ("qpos", "qvel", "obs_next", "terminal_obs", "reward", "bootstrap")
RESET_KEYS = ("qpos", "qvel", "obs_next")
STEP_FAULTS = ("unchanged", "half_batch", "altered", "stale_reset")
UPDATE_FAULTS = ("unchanged", "half_batch", "altered", "skip_epochs")
REF_DTYPE = torch.float64
BLOCK = 512


@contextlib.contextmanager
def tf32(on: bool):
    """Matmuls in TF32 while on (the control's precision)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    if on:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def scaled_gap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per row max |a - b| / (1 + max |b|), float64; infinity where
    only one side is NaN, 0 where both are."""
    a = a.double().reshape(a.shape[0], -1)
    b = b.double().reshape(b.shape[0], -1)
    both = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both, torch.zeros_like(a), (a - b).abs())
    d = torch.nan_to_num(d, nan=math.inf)
    scale = 1.0 + torch.nan_to_num(b.abs(), nan=0.0).amax(-1)
    return d.amax(-1) / scale


def _num(x) -> float:
    x = float(x)
    return math.inf if math.isnan(x) else x


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def _map(fields: dict, fn) -> dict:
    return {k: ({kk: fn(x) for kk, x in v.items()} if isinstance(v, dict) else fn(v))
            for k, v in fields.items()}


def _cast(fields: dict, dtype) -> dict:
    return _map(fields, lambda x: x.to(dtype) if x.is_floating_point() else x)


def _cat(parts: list) -> dict:
    first = parts[0]
    return {k: ({kk: torch.cat([p[k][kk] for p in parts]) for kk in v}
                if isinstance(v, dict) else torch.cat([p[k] for p in parts]))
            for k, v in first.items()}


# ----------------------------------------------------------------- start

def reset_gap(prog: dict, ref_env, num_envs: int, seed_env: int, device) -> float:
    """The program's initial states against the reference's reset from
    the same generator seed."""
    gen = torch.Generator(device=device).manual_seed(seed_env)
    st = ref_env.reset(num_envs, gen, rand_power=0.0)
    ref = dict(qpos=st.qpos, qvel=st.qvel, desired_vel=st.desired_vel,
               obs=ref_env.obs(st))
    return _num(max(scaled_gap(prog[k], ref[k]).max() for k in ref))


# --------------------------------------------------------------- rollout

def picks_of(records: list, steps, rows: torch.Tensor):
    """(sampled, resets): the (record, rows) pairs the reference re-steps:
    the sampled rows at the sampled records, and at every record the rows
    that the program reset."""
    sampled = [(k, rows) for k in steps]
    resets = []
    for k, rec in enumerate(records):
        done = torch.nonzero(rec["terminated"] | rec["truncated"])[:, 0]
        if done.numel():
            resets.append((k, done))
    return sampled, resets


def program_rows(records: list, picks: list) -> dict:
    """The program's outputs at the picks, concatenated."""
    out = {k: [] for k in POLICY_KEYS + STEP_KEYS + ("terminated", "truncated")}
    src = dict(qpos="next_qpos", qvel="next_qvel")
    for k, rows in picks:
        rec = records[k]
        for key in out:
            out[key].append(rec[src.get(key, key)][rows])
    return {k: torch.cat(v) for k, v in out.items()}


def reference_policy(records: list, picks: list, weights: dict,
                     control: bool = False) -> dict:
    """The reference's policy at the picks, on the program's observations
    with the noise the program's generator state gives: float64, or for
    the control float32 with TF32 matmuls."""
    dtype = torch.float32 if control else REF_DTYPE
    w = {k: v.to(dtype) for k, v in weights.items()}
    out = {k: [] for k in POLICY_KEYS}
    with torch.no_grad(), tf32(control):
        for k, rows in picks:
            rec = records[k]
            dev = rec["obs"].device
            gen = torch.Generator(device=dev)
            gen.set_state(rec["gen_policy"])
            noise = torch.randn((rec["batch"], rec["action"].shape[-1]),
                                generator=gen, device=dev)[rows]
            res = ref_ppo.sample(w, rec["obs"][rows].to(dtype), noise.to(dtype))
            for key, x in zip(POLICY_KEYS, res):
                out[key].append(x)
    return {k: torch.cat(v) for k, v in out.items()}


def reference_rows(ref_env, records: list, picks: list, weights: dict,
                   control: bool = False, actions=None) -> dict:
    """The reference's env step with its reset at the picks, from the
    program's input states and actions (`actions`, the control's own, in
    its place), in blocks of rows: float64, or for the control float32
    with the physics' state, action and outputs held in bfloat16 and the
    value's matmuls in TF32 (TF32 reaches none of the physics, whose
    float32 work is elementwise and in small batched solves).  Also
    returns the stepped state before the reset select (`new_qpos`,
    `new_qvel`) and the input state and observations (`in_*`)."""
    from ..reference.env.go1 import EnvState

    dtype = torch.float32 if control else REF_DTYPE
    ins, fresh, acts = [], [], []
    with torch.no_grad():
        for k, rows in picks:
            rec = records[k]
            ins.append(_map(rec["state"], lambda x: x[rows]))
            acts.append(rec["action_in"][rows])
            dev = rec["obs"].device
            gen = torch.Generator(device=dev)
            gen.set_state(rec["gen_reset"])
            B = rec["batch"]
            st = ref_env.reset(B, gen, params=ref_env.nominal_params(B),
                               rand_power=rec["state"]["rand_power"])
            fields = {f.name: getattr(st, f.name) for f in dataclasses.fields(st)}
            fresh.append(_map(fields, lambda x: x[rows]))
        state_in = _cast(_cat(ins), dtype)
        fresh = _cast(_cat(fresh), dtype)
        action = torch.cat(acts).to(dtype) if actions is None else actions.to(dtype)
        w = {k: v.to(dtype) for k, v in weights.items()}
        if control:
            state_in.update({k: _bf16(state_in[k]) for k in ("qpos", "qvel", "qacc_warm")})
            action = _bf16(action)
        n = action.shape[0]
        parts = []
        for a in range(0, n, BLOCK):
            b = min(n, a + BLOCK)
            st = EnvState(**_map(state_in, lambda x: x[a:b]))
            new, obs, reward, term, trunc, _info = ref_env.step(st, action[a:b])
            fr = EnvState(**_map(fresh, lambda x: x[a:b]))
            done = term | trunc
            picked = fr.select(done, new)
            obs_next = torch.where(done[:, None], ref_env.obs(picked), obs)
            with tf32(control):
                _, _, tv = ref_ppo.forward(w, obs)
            parts.append(dict(
                qpos=picked.qpos, qvel=picked.qvel, obs_next=obs_next,
                terminal_obs=obs, reward=reward,
                bootstrap=torch.where(term, torch.zeros_like(tv), tv),
                terminated=term, truncated=trunc,
                new_qpos=new.qpos, new_qvel=new.qvel))
        out = _cat(parts)
        if control:
            out.update({k: _bf16(out[k]) for k in STEP_KEYS})
        out.update(in_qpos=state_in["qpos"], in_qvel=state_in["qvel"],
                   in_steps=state_in["steps"])
    return out


def faulted_rows(ref: dict, picks: list, records: list, fault: str) -> dict:
    """The reference's outputs with a planted fault: `unchanged` (the
    step returns its input state), `half_batch` (the second half of each
    pick's rows not stepped), `altered` (every reward off by 1),
    `stale_reset` (the rows that reset keep their stepped state and
    terminal observation)."""
    out = dict(ref)
    obs_in = torch.cat([records[k]["obs"][rows] for k, rows in picks])
    if fault == "unchanged":
        out.update(qpos=ref["in_qpos"], qvel=ref["in_qvel"],
                   obs_next=obs_in, terminal_obs=obs_in)
    elif fault == "half_batch":
        keep = []
        for _k, rows in picks:
            n = rows.numel()
            keep.append(torch.arange(n, device=rows.device) < n - n // 2)
        keep = torch.cat(keep)
        for key, src in (("qpos", ref["in_qpos"]), ("qvel", ref["in_qvel"]),
                         ("obs_next", obs_in), ("terminal_obs", obs_in)):
            out[key] = torch.where(keep.reshape((-1,) + (1,) * (src.dim() - 1)),
                                   ref[key], src.to(ref[key].dtype))
    elif fault == "altered":
        out["reward"] = ref["reward"] + 1.0
    elif fault == "stale_reset":
        done = (ref["terminated"] | ref["truncated"])[:, None]
        out.update(qpos=torch.where(done, ref["new_qpos"], ref["qpos"]),
                   qvel=torch.where(done, ref["new_qvel"], ref["qvel"]),
                   obs_next=torch.where(done, ref["terminal_obs"], ref["obs_next"]))
    return out


def _split(d: dict, n: int) -> tuple:
    return ({k: v[:n] for k, v in d.items()}, {k: v[n:] for k, v in d.items()})


def compare_rows(cand_pol: dict, ref_pol: dict, cand: dict, ref: dict,
                 n_sampled: int, truncation_rows: int) -> dict:
    """policy_gap, step_gap_p50/p90, done_mismatch and reset_row_gap of
    the candidate's outputs at the picks (the sampled ones first, then
    the resets) against the reference's; `truncation_rows` counts the
    rows of the recorded steps whose truncation differs from the rule."""
    cs, cr = _split(cand, n_sampled)
    rs, rr = _split(ref, n_sampled)
    pol = torch.stack([scaled_gap(cand_pol[k], ref_pol[k]) for k in POLICY_KEYS]).amax(0)
    rows = torch.stack([scaled_gap(cs[k], rs[k]) for k in STEP_KEYS]).amax(0).cpu()
    flags = ((cand["terminated"] != ref["terminated"])
             | (cand["truncated"] != ref["truncated"])).sum()
    reset = 0.0
    if rr["qpos"].shape[0]:
        reset = torch.stack([scaled_gap(cr[k], rr[k]) for k in RESET_KEYS]).max()
    return dict(policy_gap=_num(pol.max()),
                step_gap_p50=_num(torch.quantile(rows, 0.5)),
                step_gap_p90=_num(torch.quantile(rows, 0.9)),
                done_mismatch=float(flags) + float(truncation_rows),
                reset_row_gap=_num(reset))


def truncation_mismatch(records: list, max_steps: int) -> int:
    """Rows of the recorded steps whose truncated flag is not the rule's
    (the input counter plus one reaches the episode's steps)."""
    bad = 0
    for rec in records:
        rule = (rec["state"]["steps"] + 1) >= max_steps
        bad += int((rule != rec["truncated"]).sum())
    return bad


# ---------------------------------------------------------------- update

def reference_update(inputs: dict, cfg: dict, first: int, tf32_on: bool = False,
                     half_batch: bool = False):
    """(losses, first gradient, weights after `first` steps, optimizer
    steps of the whole update) of the reference's update from the
    program's rollout, weights and Adam state at the update's start, with
    the first epoch's permutation drawn from the generator state the
    program's update drew from: float64, or for the control float32 with
    TF32 matmuls."""
    traj = inputs["traj"]
    dev = traj["reward"].device
    T, B = traj["reward"].shape
    gen = torch.Generator(device=dev)
    gen.set_state(inputs["gen"])
    perm = torch.randperm(T * B, generator=gen, device=dev)
    with tf32(tf32_on):
        out = ref_ppo.first_steps(inputs["w0"], inputs["adam0"], traj,
                                  inputs["last_obs"], perm, cfg, first,
                                  half_batch=half_batch,
                                  dtype=torch.float32 if tf32_on else REF_DTYPE)
    return (*out, cfg["n_epochs"] * cfg["num_minibatches"])


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _leaf_gap(w0: dict, wc: dict, wr: dict, moved: list) -> float:
    """The worst leaf's gap of the norms of the weights' change, against
    the larger of the leaf's and the median leaf's reference norm."""
    dc = _norms({k: wc[k].double() - w0[k].double() for k in moved})
    dr = _norms({k: wr[k].double() - w0[k].double() for k in moved})
    med = sorted(dr.values())[len(dr) // 2]
    return max(abs(dc[k] - dr[k]) / max(dr[k], med) for k in moved)


def compare_update(w0: dict, cand: tuple, ref: tuple) -> dict:
    """loss_gap, grad_gap, update_gap, update_steps_missing of a candidate
    update (losses, first gradient, weights after the first steps,
    optimizer steps) against the reference's."""
    lc, gc, wc, nc = cand
    lr_, gr, wr, nr = ref
    loss_gap = max(abs(float(a) - b) / max(abs(b), 1e-12) for a, b in zip(lc, lr_))
    ng_c, ng_r = _norms(gc), _norms(gr)
    med_g = sorted(ng_r.values())[len(ng_r) // 2]
    grad_gap = max(abs(ng_c[k] - ng_r[k]) / max(ng_r[k], med_g) for k in ng_r)
    moved = [k for k in ng_r if ng_r[k] >= 1e-3 * med_g]
    return dict(loss_gap=_num(loss_gap), grad_gap=_num(grad_gap),
                update_gap=_num(_leaf_gap(w0, wc, wr, moved)),
                update_steps_missing=float(abs(nr - nc)))


def program_update(cap) -> tuple:
    return ([float(x) for x in cap.losses], cap.first_grad, cap.w_first,
            cap.steps_taken)


def faulted_update(inputs: dict, cfg: dict, first: int, ref: tuple,
                   fault: str) -> tuple:
    """The reference's update with a planted fault: `unchanged` (weights
    left as they were), `half_batch` (each minibatch's loss over half of
    its rows), `altered` (every reward off by 1 in the rollout),
    `skip_epochs` (the first epoch only)."""
    if fault == "unchanged":
        return ref[0], ref[1], {k: v.clone() for k, v in inputs["w0"].items()}, ref[3]
    if fault == "half_batch":
        return reference_update(inputs, cfg, first, half_batch=True)
    if fault == "skip_epochs":
        return (*ref[:3], cfg["num_minibatches"])
    traj = dict(inputs["traj"], reward=inputs["traj"]["reward"] + 1.0)
    return reference_update(dict(inputs, traj=traj), cfg, first)


def judge(numbers: dict, limits: dict) -> bool:
    """True when every number is present, finite and within its limit."""
    return all(k in numbers and math.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)

"""Where a control step's time goes on the card.

    python -m quadruped_tpu_torch.profile_step [--envs 4096]

Runs the configuration of record (as chip_smoke.py does) and prints:
  * torch.profiler's per-operator table for one control step at --envs
    envs, sorted by device time and by host time, with the step's kernel
    launch count, total device time and host time;
  * the wall time of a control step at several batch sizes, which tells
    a host-bound step (flat in the batch) from a device-bound one.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .env.config import Go1Config
from .env.go1 import Go1Env
from .models.actor_critic import ActorCritic

RECORD = dict(ctrl_type="torque", solver_iterations=8,
              contact_pools=(8, 28, 12))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    env = Go1Env(Go1Config(**RECORD), device=dev)
    policy = ActorCritic(device=dev,
                         generator=torch.Generator().manual_seed(args.seed))

    def control_step(state, obs):
        action, *_ = policy.sample(obs, gen)
        state, obs, *_ = env.step_autoreset(state, action, gen)
        return state, obs

    def wall_ms(B, reps=3):
        state = env.reset(B, gen)
        obs = env.obs(state)
        for _ in range(2):
            state, obs = control_step(state, obs)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, obs = control_step(state, obs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3, state, obs

    ms, state, obs = wall_ms(args.envs)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, obs = control_step(state, obs)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    print(ka.table(sort_by="self_cuda_time_total", row_limit=20), flush=True)
    print(ka.table(sort_by="self_cpu_time_total", row_limit=20), flush=True)
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    device_ms = sum(e.self_device_time_total for e in ka if e.device_type
                    == torch.autograd.DeviceType.CUDA) / 1e3
    host_ms = sum(e.self_cpu_time_total for e in ka) / 1e3
    print(f"one control step at {args.envs} envs: {launches} kernel launches, "
          f"device time {device_ms:.3f} ms, host time {host_ms:.3f} ms "
          f"(profiled); unprofiled wall {ms:.3f} ms", flush=True)
    for B in (256, 1024, 4096, 16384):
        ms, *_ = wall_ms(B)
        print(f"B={B}: {ms:.3f} ms per control step, {B / ms * 1e3:.1f} env "
              "control steps/s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

"""Procedural rough-terrain heightfield, batch-first.

Counterpart of quadruped_tpu/physics/terrain.py.  The terrain is a smooth
parametric field

    h(x, y) = sum_k amp_k * cos(freq_k . (x, y) + phase_k)

whose per-episode amplitudes, frequencies and phases ride in the env's
params dict ("terrain_amp" (B, K), "terrain_freq" (B, K, 2),
"terrain_phase" (B, K)), so every autoreset walks on fresh ground.  The
surface normal is analytic.  Each plane-group contact candidate collides
against the local tangent plane under its geom's centre; with zero
amplitudes that is exactly the flat plane.

Terrain arrays may carry leading batch axes (per env) or none (shared);
the query points' leading axes start with the same batch axes.
"""

from __future__ import annotations

import math

import torch

TERRAIN_KEYS = ("terrain_amp", "terrain_freq", "terrain_phase")


def terrain_of(params: dict) -> dict | None:
    """The terrain entries of a params dict, or None on a flat floor (the
    reference's rule: terrain is present exactly when params hold
    terrain_amp, forward.py:120-127)."""
    if "terrain_amp" not in params:
        return None
    return {k: params[k] for k in TERRAIN_KEYS}


def sample_terrain_params(
    num_envs: int, generator: torch.Generator | None = None,
    n_waves: int = 8, amplitude: float = 0.04, wavelength: float = 1.0,
    device="cpu", dtype=torch.float32,
) -> dict[str, torch.Tensor]:
    """One terrain draw per env.  amplitude: total peak height scale (m),
    each wave ~amplitude / n_waves so the summed field stays within
    +-amplitude; wavelength: centre feature size (m), waves span
    [0.5, 2] x wavelength."""
    def uniform(shape, lo, hi):
        u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
        return lo + (hi - lo) * u

    shape = (num_envs, n_waves)
    amp = uniform(shape, 0.5, 1.0) * (2.0 * amplitude / n_waves)
    ang = uniform(shape, 0.0, 2.0 * math.pi)
    wl = wavelength * uniform(shape, 0.5, 2.0)
    freq = (2.0 * math.pi / wl)[..., None] * torch.stack(
        [torch.cos(ang), torch.sin(ang)], dim=-1
    )
    phase = uniform(shape, 0.0, 2.0 * math.pi)
    return {"terrain_amp": amp, "terrain_freq": freq, "terrain_phase": phase}


def flat_terrain_params(n_waves: int = 8, device="cpu", dtype=torch.float32):
    """Zero-amplitude terrain, exactly the flat plane (the same dict
    shape, so flat and rough envs share one code path)."""
    return {
        "terrain_amp": torch.zeros((n_waves,), dtype=dtype, device=device),
        "terrain_freq": torch.ones((n_waves, 2), dtype=dtype, device=device),
        "terrain_phase": torch.zeros((n_waves,), dtype=dtype, device=device),
    }


def height_normal(terrain, xy: torch.Tensor):
    """Field height and unit surface normal at xy (..., 2).
    Returns (h (...,), n (..., 3))."""
    amp = terrain["terrain_amp"]
    freq = terrain["terrain_freq"]
    phase = terrain["terrain_phase"]
    # the query points' extra axes after the terrain's batch axes
    extra = (1,) * (xy.dim() - amp.dim())
    amp = amp.reshape(amp.shape[:-1] + extra + amp.shape[-1:])
    phase = phase.reshape(amp.shape)
    freq = freq.reshape(amp.shape + (2,))
    arg = xy[..., None, 0] * freq[..., 0] + xy[..., None, 1] * freq[..., 1] + phase
    h = torch.sum(amp * torch.cos(arg), dim=-1)
    # dh/dxy = sum_k -amp_k sin(arg_k) freq_k
    s = -amp * torch.sin(arg)
    g = torch.sum(s[..., None] * freq, dim=-2)
    n = torch.cat([-g, torch.ones_like(g[..., :1])], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    return h, n


def local_plane(terrain, point: torch.Tensor):
    """Tangent plane under world points (..., 3): (ppos (..., 3), n (..., 3))."""
    xy = point[..., :2]
    h, n = height_normal(terrain, xy)
    return torch.cat([xy, h[..., None]], dim=-1), n

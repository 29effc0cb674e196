"""Per-device tensor copies of static host tables.

Models, collision tables and constraint layouts are numpy; the physics
reads some of their arrays on every substep.  `cached` uploads each array
once per (device, dtype) and keeps it beside the owning object, so a
substep issues no host-to-device copies.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

_CACHE: "weakref.WeakKeyDictionary[object, dict]" = weakref.WeakKeyDictionary()


def cached(owner, key: str, make, device, dtype=None) -> torch.Tensor:
    """Tensor of `make()` (numpy or python data) on `device`, cached on
    `owner` under (key, device, dtype).  dtype None keeps numpy's dtype."""
    per = _CACHE.setdefault(owner, {})
    k = (key, str(device), dtype)
    t = per.get(k)
    if t is None:
        t = torch.as_tensor(np.asarray(make()), device=device)
        if dtype is not None:
            t = t.to(dtype)
        per[k] = t
    return t


def index(owner, key: str, make, device) -> torch.Tensor:
    """int64 index tensor of `make()` on `device`, cached like `cached`.
    Indexing a CUDA tensor with a host (numpy) index array copies the
    index to the device and synchronizes on every call; these don't."""
    return cached(owner, key, make, device, torch.int64)

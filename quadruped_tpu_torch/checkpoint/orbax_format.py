"""The orbax StandardCheckpointer layout, read without JAX: what
`quadruped_tpu.checkpoint` writes under `params/` and `train_state/`.

A checkpoint directory holds

  _CHECKPOINT_METADATA  JSON; `item_handlers` names the
                        StandardCheckpointHandler
  _METADATA             JSON; `tree_metadata` maps each leaf's key path
                        to its `key_metadata` (the path's keys) and
                        `value_metadata` (`value_type`, `write_shape`);
                        `use_ocdbt` and `use_zarr3` name the storage
  manifest.ocdbt, d/,   the OCDBT database (ocdbt.py) holding one zarr v2
  ocdbt.process_N/      array per leaf: "<keys joined by .>/.zarray" and
                        its chunks "<keys>/0", "<keys>/0.0", ...

Only `use_ocdbt: true` with `use_zarr3: false` is read; any other
layout, dtype, order, filter or compressor is refused with an error that
names the field and its value.

`read_tree(path)` gives the nested dict of numpy arrays that
`ocp.StandardCheckpointer().restore(path)` restores, with the same
dtypes, except that sequence positions (tuples, lists) become string
keys '0', '1', ...; a leaf stored as None (optax's EmptyState) is None.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from .ocdbt import OcdbtStore
from .zstd import decompress

__all__ = ["OrbaxFormatError", "read_tree", "read_leaves", "nest", "flatten",
           "tree_digest"]

HANDLER = "StandardCheckpointHandler"
DTYPES = ("<f4", "<f8", "<i4", "<u4", "<i8", "|b1")
ARRAY_TYPES = ("jax.Array", "np.ndarray")


class OrbaxFormatError(ValueError):
    """A checkpoint this reader does not read."""


def _json(path: Path) -> dict:
    if not path.exists():
        raise OrbaxFormatError(f"{path.parent}: no {path.name}")
    return json.loads(path.read_text())


def _check_layout(path: Path) -> dict:
    """The checks on _CHECKPOINT_METADATA and _METADATA -> tree_metadata."""
    handlers = _json(path / "_CHECKPOINT_METADATA").get("item_handlers")
    if not isinstance(handlers, str) or handlers.rsplit(".", 1)[-1] != HANDLER:
        raise OrbaxFormatError(
            f"{path}: _CHECKPOINT_METADATA item_handlers is {handlers!r}, "
            f"not the {HANDLER}")
    meta = _json(path / "_METADATA")
    for field, want in (("use_ocdbt", True), ("use_zarr3", False)):
        if meta.get(field) is not want:
            raise OrbaxFormatError(
                f"{path}: _METADATA {field} is {meta.get(field)!r}; only "
                f"{field}: {json.dumps(want)} is read")
    return meta["tree_metadata"]


def _fill(zarray: dict):
    v = zarray.get("fill_value")
    if isinstance(v, str):
        v = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}.get(v, v)
    return v


def _read_array(store: OcdbtStore, name: str, where: str) -> np.ndarray:
    """The zarr v2 array `name` in `store` as a numpy array."""
    key = f"{name}/.zarray"
    if key not in store:
        raise OrbaxFormatError(f"{where}: no {key} in the store")
    z = json.loads(store.read(key))

    def refuse(field):
        raise OrbaxFormatError(
            f"{where}: {key} {field} is {z.get(field)!r}, which is not read")

    if z.get("zarr_format") != 2:
        refuse("zarr_format")
    if z.get("dtype") not in DTYPES:
        refuse("dtype")
    if z.get("order") != "C":
        refuse("order")
    if z.get("filters") is not None:
        refuse("filters")
    comp = z.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        refuse("compressor")
    sep = z.get("dimension_separator", ".")
    if sep != ".":
        refuse("dimension_separator")
    dtype = np.dtype(z["dtype"])
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        refuse("chunks")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}"
        sel = tuple(slice(i * c, min((i + 1) * c, s))
                    for i, c, s in zip(idx, chunks, shape))
        if ckey not in store:
            fill = _fill(z)
            if fill is None:
                raise OrbaxFormatError(
                    f"{where}: chunk {ckey} is missing and fill_value is null")
            out[sel] = fill
            continue
        raw = store.read(ckey)
        if comp is not None:
            raw = decompress(raw)
        n = int(np.prod(chunks)) * dtype.itemsize
        if len(raw) != n:
            raise OrbaxFormatError(
                f"{where}: chunk {ckey} holds {len(raw)} bytes, expected {n}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks)
        out[sel] = chunk[tuple(slice(0, e.stop - e.start) for e in sel)]
    return out


def read_leaves(path) -> dict:
    """{key path (tuple of str): numpy array or None} of the checkpoint
    at `path`, in _METADATA's order."""
    path = Path(path).absolute()
    tree_meta = _check_layout(path)
    store = OcdbtStore(path)
    leaves = {}
    for name, leaf in tree_meta.items():
        keys = tuple(str(k["key"]) for k in leaf["key_metadata"])
        vtype = leaf["value_metadata"].get("value_type")
        if vtype in (None, "None"):
            leaves[keys] = None
        elif vtype in ARRAY_TYPES:
            leaves[keys] = _read_array(store, ".".join(keys), f"{path} {name}")
        else:
            raise OrbaxFormatError(
                f"{path}: {name} value_type is {vtype!r}; only "
                f"{', '.join(ARRAY_TYPES)} and None are read")
    return leaves


def nest(leaves: dict) -> dict:
    """{key path: leaf} -> the nested dict of those leaves."""
    tree: dict = {}
    for keys, value in leaves.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def read_tree(path) -> dict:
    """The checkpoint at `path` as a nested dict of numpy arrays (see the
    module docstring)."""
    return nest(read_leaves(path))


def flatten(tree, prefix=()) -> list:
    """[(key path, array)] of a nested dict's array leaves (None leaves
    left out), sorted by key path."""
    if tree is None:
        return []
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in tree:
        out += flatten(tree[k], prefix + (k,))
    return sorted(out, key=lambda kv: kv[0])


def tree_digest(tree) -> str:
    """sha256 over the tree's array leaves in sorted key order, each as
    little-endian bytes."""
    h = hashlib.sha256()
    for _, a in flatten(tree):
        a = np.asarray(a)
        h.update(np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tobytes())
    return h.hexdigest()

"""The port's reader of the JAX package's orbax checkpoints, held against
the libraries it replaces.

zstd.py against `zstandard` (hypothesis-drawn inputs at levels 1, 3 and
19, with and without the content checksum; frames of several blocks,
streams flushed block by block, concatenated and skippable frames; a
flipped checksum bit and a dictionary frame are refused); ocdbt.py
against tensorstore's "ocdbt" kvstore (every key and value of the three
committed payloads, and of databases tensorstore writes with interior
b-tree nodes, version-tree nodes, indirect values and a numbered
manifest); orbax_format.py against `ocp.StandardCheckpointer().restore`
(every leaf, dtype included, of the committed payloads and of fresh ones
that the JAX package's save_policy and save_train_state write); its
refusals; and the port's loaders against the JAX package's.  No env is
built here.
"""

import json
import shutil
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from quadruped_tpu import checkpoint as jckpt
from quadruped_tpu.learn import ppo as jppo
from quadruped_tpu.models.actor_critic import Policy
from quadruped_tpu_torch import checkpoint as tckpt
from quadruped_tpu_torch.checkpoint.ocdbt import OcdbtError, OcdbtStore, crc32c
from quadruped_tpu_torch.checkpoint.orbax_format import (
    OrbaxFormatError, read_tree, tree_digest)
from quadruped_tpu_torch.checkpoint.zstd import ZstdError, decompress, xxh64
from quadruped_tpu_torch.convert import (flax_pairs, load_flax, opt_state_from_jax,
                                         policy_from_jax)
from quadruped_tpu_torch.learn.ppo import PPOConfig, make_optimizer
from quadruped_tpu_torch.models.actor_critic import ActorCritic

ROOT = Path(__file__).resolve().parent.parent
RESULTS = ROOT / "results"
BEST = RESULTS / "live" / "multigait-r5" / "best_model"
LATEST = RESULTS / "live" / "multigait-r5" / "latest_checkpoint"
WALK = RESULTS / "walk_r5_progress"
PAYLOADS = {
    "best_model": BEST / "params",
    "latest_checkpoint": LATEST / "train_state",
    "walk_r5_progress": WALK / "train_state",
}
OBS_DIM, ACT_DIM = 53, 12


# ------------------------------------------------------------------ zstd

def _runs(pairs):
    return b"".join(bytes([b]) * n for b, n in pairs)


def _floats(seed_n):
    seed, n, digits = seed_n
    a = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    # a few decimals: repeated values and byte patterns, as weights have
    return (np.round(a, digits) if digits < 8 else a).tobytes()


PAYLOAD_BYTES = st.one_of(
    st.binary(max_size=3000),
    st.lists(st.tuples(st.integers(0, 255), st.integers(1, 400)),
             max_size=60).map(_runs),
    st.tuples(st.integers(0, 2**32 - 1), st.integers(0, 12000),
              st.integers(0, 8)).map(_floats),
)


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("level", [1, 3, 19])
@settings(max_examples=12, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=PAYLOAD_BYTES)
def test_zstd_matches_zstandard(level, checksum, data):
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert decompress(frame) == data


@pytest.mark.parametrize("level", [1, 19])
def test_zstd_blocks_and_frames(level):
    """A frame over 128 KiB (several blocks), a stream flushed block by
    block (tables repeated across blocks, RLE and treeless literals),
    concatenated frames with a skippable frame between them."""
    rng = np.random.default_rng(level)
    big = b"".join([
        rng.standard_normal(40000).astype(np.float32).tobytes(),
        bytes(rng.integers(0, 6, 90000, dtype=np.uint8)),
        b"\x00" * 20000,
        rng.bytes(30000),
    ])
    assert len(big) > 2 * 128 * 1024
    cz = zstandard.ZstdCompressor(level=level, write_checksum=True)
    assert decompress(cz.compress(big)) == big
    pool = [rng.bytes(8) for _ in range(64)]
    parts = [b"".join(pool)] + [
        b"x".join(pool[i] for i in rng.integers(0, 64, 400)),
        bytes(rng.integers(0, 3, 5000, dtype=np.uint8)),
        rng.standard_normal(3000).astype(np.float32).tobytes(),
    ] * 3
    co = zstandard.ZstdCompressor(level=level).compressobj()
    stream = b"".join(co.compress(p) + co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                      for p in parts) + co.flush()
    assert decompress(stream) == b"".join(parts)
    skip = (0x184D2A5E).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"abc"
    small = zstandard.ZstdCompressor(level=level).compress(b"frame" * 50)
    assert decompress(small + skip + stream + small) == (
        b"frame" * 50 + b"".join(parts) + b"frame" * 50)


def test_zstd_refusals():
    """A flipped checksum bit, a frame naming a dictionary, a truncated
    frame and bytes that are no frame raise ZstdError."""
    data = np.arange(5000, dtype=np.float32).tobytes()
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True)
                      .compress(data))
    assert xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")
    frame[-2] ^= 0x10
    with pytest.raises(ZstdError, match="checksum"):
        decompress(bytes(frame))
    # single segment, 1-byte dictionary id 5, 1-byte content size 0, an
    # empty last raw block
    named = (0xFD2FB528).to_bytes(4, "little") + bytes([0x21, 5, 0, 1, 0, 0])
    with pytest.raises(ZstdError, match="dictionary"):
        decompress(named)
    good = zstandard.ZstdCompressor(level=3).compress(data)
    with pytest.raises(ZstdError):
        decompress(good[:len(good) // 2])
    with pytest.raises(ZstdError, match="not a Zstandard frame"):
        decompress(b"PK\x03\x04 not zstd")


# ----------------------------------------------------------------- OCDBT

def _ts_items(root):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{root}"}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    return keys, {k: kv.read(k.encode()).result().value for k in keys}


def _ts_database(root, config, n):
    """A database tensorstore writes with `config`, one commit per key."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": config}).result()
    rng = np.random.default_rng(n)
    for i in range(n):
        kv.write(f"arr{i % 7}.leaf{i:03d}/{i % 3}",
                 rng.bytes(int(rng.integers(0, 40)))).result()
    return root


@pytest.fixture(scope="module")
def databases(tmp_path_factory):
    base = tmp_path_factory.mktemp("ocdbt")
    return {
        # 200-byte nodes: a b-tree of several levels; arity 2: version
        # nodes behind the inline versions; values inline and indirect
        "deep": _ts_database(base / "deep", {
            "max_decoded_node_bytes": 200, "version_tree_arity_log2": 1,
            "max_inline_value_bytes": 16}, 40),
        "numbered": _ts_database(base / "numbered",
                                 {"manifest_kind": "numbered"}, 5),
        **PAYLOADS,
    }


@pytest.mark.parametrize("name", ["deep", "numbered", *PAYLOADS])
def test_ocdbt_matches_tensorstore(databases, name):
    root = databases[name]
    keys, values = _ts_items(root)
    store = OcdbtStore(root)
    assert store.list() == keys
    for k in keys:
        assert store.read(k) == values[k], k


def test_ocdbt_checks(tmp_path):
    """crc32c's check value; a flipped manifest byte and a missing root
    manifest raise OcdbtError."""
    assert crc32c(b"123456789") == 0xE3069283
    root = tmp_path / "params"
    shutil.copytree(PAYLOADS["best_model"], root)
    m = bytearray((root / "manifest.ocdbt").read_bytes())
    m[20] ^= 1
    (root / "manifest.ocdbt").write_bytes(bytes(m))
    with pytest.raises(OcdbtError, match="crc32c"):
        OcdbtStore(root)
    with pytest.raises(OcdbtError, match="no manifest"):
        OcdbtStore(tmp_path)


# ----------------------------------------------------------------- orbax

def _numpy_tree(tree):
    """orbax's restore in the reader's form: sequences as dicts keyed
    '0', '1', ..., arrays as numpy."""
    if isinstance(tree, dict):
        return {str(k): _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _numpy_tree(v) for i, v in enumerate(tree)}
    return None if tree is None else np.asarray(tree)


def _orbax_restore(path, template=False):
    """ocp.StandardCheckpointer().restore(path).  The committed payloads
    were written on a TPU and name its devices in their sharding file, so
    on this host they restore into a template of numpy arrays made from
    the checkpoint's own metadata (numpy leaves restore as numpy)."""
    ckpt = ocp.StandardCheckpointer()
    if not template:
        return _numpy_tree(ckpt.restore(path))
    meta = ckpt.metadata(path).item_metadata.tree
    like = jax.tree.map(lambda m: np.zeros(m.shape, m.dtype), meta)
    return _numpy_tree(ckpt.restore(path, like))


def _assert_same(mine, ref, path=()):
    if isinstance(ref, dict):
        assert isinstance(mine, dict) and set(mine) == set(ref), path
        for k in ref:
            _assert_same(mine[k], ref[k], path + (k,))
    elif ref is None:
        assert mine is None, path
    else:
        assert isinstance(mine, np.ndarray), path
        assert (mine.dtype, mine.shape) == (ref.dtype, ref.shape), path
        assert mine.tobytes() == ref.tobytes(), path


def _jax_policy(seed=0):
    return Policy.make(act_dim=ACT_DIM).init(jax.random.PRNGKey(seed),
                                             obs_dim=OBS_DIM)


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """Payloads the JAX package writes here: a policy, and a train state
    of a stand-in with params, opt_state (the reference's optax chain,
    one update in), rand_power and rng, plus leaves of the other dtypes
    the reader takes."""
    base = tmp_path_factory.mktemp("fresh")
    params = _jax_policy(1)
    jckpt.save_policy(base / "best_model", params, {"global_step": 3})
    tx = jppo.PPO(None, jppo.PPOConfig(), policy=Policy.make(act_dim=ACT_DIM)).tx
    opt_state = tx.init(params)
    grads = jax.tree.map(lambda p: jnp.sin(jnp.arange(p.size, dtype=p.dtype)
                                           ).reshape(p.shape), params)
    _, opt_state = tx.update(grads, opt_state, params)
    stand_in = types.SimpleNamespace(
        params=params, opt_state=opt_state,
        rand_power=jnp.float32(0.375), rng=jax.random.PRNGKey(11))
    jckpt.save_train_state(base / "checkpoint_8", stand_in, {"global_step": 8})
    extra = {"f8": np.linspace(0, 1, 7), "i4": np.arange(-3, 3, dtype=np.int32),
             "i8": np.arange(5, dtype=np.int64) << 40,
             "b1": np.array([[True, False], [False, True]]),
             "u4": np.array(7, np.uint32)}
    ocp.StandardCheckpointer().save(base / "extra", extra)
    ocp.StandardCheckpointer().wait_until_finished()
    return {"fresh_policy": base / "best_model" / "params",
            "fresh_train_state": base / "checkpoint_8" / "train_state",
            "fresh_dtypes": base / "extra"}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_reader_matches_orbax_committed(name):
    path = PAYLOADS[name]
    _assert_same(read_tree(path), _orbax_restore(path, template=True))


@pytest.mark.parametrize("name", ["fresh_policy", "fresh_train_state",
                                  "fresh_dtypes"])
def test_reader_matches_orbax_fresh(fresh, name):
    path = fresh[name]
    _assert_same(read_tree(path), _orbax_restore(path))


def test_chip_smoke_digests_match_orbax():
    """The digests chip_smoke.py holds the card host's reads to are those
    of orbax's own restore."""
    assert set(chip_smoke.ORBAX_DIGESTS) == set(PAYLOADS)
    for name, path in PAYLOADS.items():
        ref = _orbax_restore(path, template=True)
        assert chip_smoke.ORBAX_DIGESTS[name] == tree_digest(ref), name


def _overwrite(root, key, value):
    """Commit `value` under `key` into the orbax checkpoint's root
    database (None deletes the key)."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}"}).result()
    if value is None:
        kv.delete_range(ts.KvStore.KeyRange(key.encode(),
                                            key.encode() + b"\x00")).result()
    else:
        kv.write(key.encode(), value).result()


def _edit_json(path, **changes):
    meta = json.loads(path.read_text())
    meta.update(changes)
    path.write_text(json.dumps(meta))


@pytest.mark.parametrize("case", ["zarr3", "ocdbt", "handler", "compressor",
                                  "dtype", "missing_chunk"])
def test_reader_refusals(tmp_path, case):
    """Layouts the reader does not read raise an error naming the field."""
    root = tmp_path / "train_state"
    shutil.copytree(PAYLOADS["walk_r5_progress"], root)
    zarray = json.loads(OcdbtStore(root).read("rng/.zarray"))
    if case == "zarr3":
        _edit_json(root / "_METADATA", use_zarr3=True)
        match = "use_zarr3 is True"
    elif case == "ocdbt":
        _edit_json(root / "_METADATA", use_ocdbt=False)
        match = "use_ocdbt is False"
    elif case == "handler":
        _edit_json(root / "_CHECKPOINT_METADATA",
                   item_handlers="orbax.checkpoint.PyTreeCheckpointHandler")
        match = "item_handlers"
    elif case == "compressor":
        zarray["compressor"] = {"id": "blosc", "cname": "lz4", "clevel": 5,
                                "shuffle": 1}
        _overwrite(root, "rng/.zarray", json.dumps(zarray).encode())
        match = "compressor is {'id': 'blosc'"
    elif case == "dtype":
        zarray["dtype"] = "<f2"
        _overwrite(root, "rng/.zarray", json.dumps(zarray).encode())
        match = "dtype is '<f2'"
    else:
        _overwrite(root, "rng/0", None)
        match = "rng/0 is missing and fill_value is null"
    with pytest.raises(OrbaxFormatError, match=match):
        read_tree(root)


# --------------------------------------------------------------- loaders

def _port_train_state():
    policy = ActorCritic(OBS_DIM, ACT_DIM, device="cpu")
    return types.SimpleNamespace(
        policy=policy, optimizer=make_optimizer(policy, PPOConfig()),
        rand_power=torch.zeros(()), generator=torch.Generator())


def _state_bytes(module):
    return {k: v.numpy().tobytes() for k, v in module.state_dict().items()}


def test_load_policy_matches_reference():
    """load_policy on the orbax best_model gives the weights of the JAX
    package's load_policy, converted: bit for bit."""
    params, meta = jckpt.load_policy(BEST, _jax_policy())
    ref = policy_from_jax(jax.tree.map(np.asarray, params), device="cpu")
    net, tmeta = tckpt.load_policy(BEST, ActorCritic(OBS_DIM, ACT_DIM,
                                                     device="cpu"))
    assert _state_bytes(net) == _state_bytes(ref)
    assert tmeta == meta
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_policy(BEST, ActorCritic(48, ACT_DIM, device="cpu"))


@pytest.mark.parametrize("case", ["deeper_policy", "extra_array", "shape"])
def test_load_flax_refusals(case):
    """convert.load_flax, which the loaders and policy_from_jax share,
    refuses a tree that does not fit the policy (a parameter without its
    array, an array without its parameter, an array of another shape)
    before it copies anything."""
    tree = read_tree(BEST / "params")
    lins = [m for m in policy_from_jax(tree, device="cpu").actor
            if isinstance(m, torch.nn.Linear)]
    hidden = tuple(lin.out_features for lin in lins[:-1])
    obs_dim, match = OBS_DIM, "arrays for a policy of"
    if case == "deeper_policy":
        hidden += hidden[-1:]
    elif case == "extra_array":
        tree["params"]["extra"] = np.zeros(3, np.float32)
    else:
        obs_dim, match = 48, "shape"
    net = ActorCritic(obs_dim, ACT_DIM, hidden, device="cpu")
    before = _state_bytes(net)
    with pytest.raises(ValueError, match=match):
        load_flax(net, tree)
    assert _state_bytes(net) == before


def test_load_train_state_matches_reference():
    """load_train_state on walk_r5_progress: params, Adam's step and
    moments bit-equal to opt_state_from_jax of orbax's restore, the same
    rand_power; load_policy_any takes the train-state layout too."""
    ref = _orbax_restore(WALK / "train_state", template=True)
    ts_, meta = tckpt.load_train_state(WALK, _port_train_state())
    assert meta == json.loads((WALK / "metadata.json").read_text())
    for param, value in flax_pairs(ts_.policy, ref["params"]):
        assert param.detach().numpy().tobytes() == value.tobytes()
    adam = ref["opt_state"]["1"]["0"]
    want = opt_state_from_jax(adam, ts_.policy)
    got = ts_.optimizer.state
    assert len(got) == len(want) == len(list(ts_.policy.parameters()))
    for p, w in want.items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert got[p][k].device.type == "cpu"
            assert got[p][k].numpy().tobytes() == w[k].numpy().tobytes(), k
        assert float(got[p]["step"]) == float(adam["count"]) > 0
    assert ts_.rand_power.numpy().tobytes() == ref["rand_power"].tobytes()
    policy, _ = tckpt.load_policy_any(WALK, _port_train_state())
    assert _state_bytes(policy) == _state_bytes(ts_.policy)


def test_generator_reseed_is_deterministic():
    """The JAX key re-seeds the generator from a hash of its bytes: the
    same key the same stream, another key another."""
    a = tckpt.load_train_state(WALK, _port_train_state())[0].generator
    b = tckpt.load_train_state(WALK, _port_train_state())[0].generator
    c = tckpt.load_train_state(LATEST, _port_train_state())[0].generator
    assert torch.equal(a.get_state(), b.get_state())
    assert not torch.equal(a.get_state(), c.get_state())
    assert not torch.equal(a.get_state(), torch.Generator().get_state())

"""A read-only key-value store over tensorstore's OCDBT format, the
database orbax writes its array chunks into when `use_ocdbt` is set.

What it reads, from the database's root directory:

  manifest.ocdbt    magic 0x0cdb3a2a (big-endian), the file length
                    (uint64le), a format version varint, a compression
                    varint (0 none, 1 zstd), the body, and the crc32c of
                    everything before it (uint32le).  The body holds the
                    config (uuid, manifest kind, size limits, version-tree
                    arity, compression) and, for a single-file manifest,
                    the version tree: a data-file table, the newest
                    versions inline, then references to older version
                    nodes.  A numbered manifest keeps only the config
                    here and the versions in `manifest.<16 hex digits>`.
  b-tree nodes      magic 0x0cdb20de, the same header, trailer and
                    compression, inside a data file at (offset, length).
                    The body: the height, the node's data-file table, the
                    entries with prefix-coded keys, and per entry either a
                    child node (interior) or a value (leaf), the value
                    inline in the node or indirect (file, offset, length).

Only the newest version is read, and it always lies in the manifest's
inline part, so the older version nodes are not parsed.  Data-file paths
are relative to the database root: orbax's root database at a checkpoint
directory points into the per-process databases below it
(`ocdbt.process_0/d/...`), so open the checkpoint directory, not a
process's own database.

Errors raise `OcdbtError`, naming the file and what is wrong.
"""

from __future__ import annotations

from pathlib import Path

from .zstd import decompress

__all__ = ["OcdbtError", "OcdbtStore", "crc32c"]

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
HEADER_BYTES = 4 + 8           # magic, length
EMPTY = (1 << 64) - 1          # offset and length of an empty tree's root


class OcdbtError(ValueError):
    """Malformed or unsupported OCDBT data."""


def _crc_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as tensorstore checksums manifests and
    nodes."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in data:
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.p, self.what = data, 0, what

    def fail(self, msg: str):
        raise OcdbtError(f"{self.what}: {msg}")

    def take(self, n: int) -> bytes:
        if self.p + n > len(self.data):
            self.fail("ends early")
        b = self.data[self.p:self.p + n]
        self.p += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return int.from_bytes(self.take(4), "little")

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]

    def done(self):
        if self.p != len(self.data):
            self.fail(f"{len(self.data) - self.p} bytes left over")


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """Check the header and trailer of a manifest or node -> its decoded
    body."""
    if len(raw) < HEADER_BYTES + 2 + 4:
        raise OcdbtError(f"{what}: {len(raw)} bytes is too short")
    got = int.from_bytes(raw[:4], "big")
    if got != magic:
        raise OcdbtError(f"{what}: magic {got:#010x}, expected {magic:#010x}")
    length = int.from_bytes(raw[4:12], "little")
    if length != len(raw):
        raise OcdbtError(f"{what}: header length {length}, found {len(raw)} bytes")
    want = int.from_bytes(raw[-4:], "little")
    if crc32c(raw[:-4]) != want:
        raise OcdbtError(f"{what}: crc32c mismatch")
    r = _Reader(raw[HEADER_BYTES:-4], what)
    version = r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version} is not supported")
    compression = r.varint()
    body = r.data[r.p:]
    if compression == 1:
        return decompress(body)
    if compression != 0:
        raise OcdbtError(f"{what}: compression {compression} is not supported")
    return body


def _data_files(r: _Reader) -> list:
    """A data-file table: prefix-coded paths -> [path]."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                      # base-path lengths: part of each path
    paths, prev = [], b""
    for pre, suf in zip(prefix, suffix):
        if pre > len(prev):
            r.fail("data-file path prefix longer than the previous path")
        prev = prev[:pre] + r.take(suf)
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int) -> list:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    return prefix, suffix


def _read_config(r: _Reader) -> dict:
    cfg = {
        "uuid": r.take(16).hex(),
        "manifest_kind": r.varint(),
        "max_inline_value_bytes": r.varint(),
        "max_decoded_node_bytes": r.varint(),
        "version_tree_arity_log2": r.u8(),
        "compression": r.varint(),
    }
    if cfg["compression"] == 1:
        cfg["zstd_level"] = r.u32()
    elif cfg["compression"] != 0:
        r.fail(f"config compression {cfg['compression']} is not supported")
    if cfg["manifest_kind"] not in (0, 1):
        r.fail(f"manifest kind {cfg['manifest_kind']} is not supported")
    return cfg


class OcdbtStore:
    """The newest version of the OCDBT database at `root`: `list()` and
    `read(key)`.  Keys are str (UTF-8), values bytes."""

    def __init__(self, root):
        self.root = Path(root)
        self.config, ref = self._latest_root()
        # key -> bytes (inline) or (path, offset, length) (indirect)
        self._values = {}
        if ref is not None:
            self._walk(ref, b"")

    # -------------------------------------------------------- manifest
    def _manifest(self, path: Path):
        what = str(path)
        r = _Reader(_unwrap(path.read_bytes(), MANIFEST_MAGIC, what), what)
        return r, _read_config(r)

    def _latest_root(self):
        path = self.root / "manifest.ocdbt"
        if not path.exists():
            raise OcdbtError(f"{self.root}: no manifest.ocdbt")
        r, cfg = self._manifest(path)
        if cfg["manifest_kind"] == 1:
            r.done()
            numbered = sorted(
                p for p in self.root.glob("manifest.*")
                if len(p.suffix) == 17 and all(
                    c in "0123456789abcdef" for c in p.suffix[1:]))
            if not numbered:
                raise OcdbtError(f"{self.root}: numbered manifest kind, "
                                 "but no manifest.<number> file")
            r, cfg2 = self._manifest(numbered[-1])
            if cfg2["uuid"] != cfg["uuid"]:
                r.fail("uuid differs from manifest.ocdbt's")
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            r.fail("no inline version: the newest version is missing")
        gen = r.varints(n)
        height = [r.u8() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(n)                  # num_keys
        r.varints(n)                  # num_tree_bytes
        r.varints(n)                  # num_indirect_value_bytes
        for _ in range(n):
            r.u64()                   # commit_time
        # then the references to older version nodes, not needed here
        i = max(range(n), key=gen.__getitem__)
        if offset[i] == EMPTY and length[i] == EMPTY:
            return cfg, None
        if file_id[i] >= len(files):
            r.fail(f"root in data file {file_id[i]} of {len(files)}")
        return cfg, (files[file_id[i]], offset[i], length[i], height[i])

    # ---------------------------------------------------------- b-tree
    def _slice(self, path: str, offset: int, length: int) -> bytes:
        f = self.root / path
        try:
            with open(f, "rb") as fh:
                fh.seek(offset)
                data = fh.read(length)
        except FileNotFoundError:
            raise OcdbtError(f"{self.root}: missing data file {path}") from None
        if len(data) != length:
            raise OcdbtError(f"{f}: {length} bytes at {offset} run past the end")
        return data

    def _walk(self, ref, prefix: bytes):
        path, offset, length, height = ref
        what = f"{self.root / path}@{offset}"
        r = _Reader(_unwrap(self._slice(path, offset, length), NODE_MAGIC,
                            what), what)
        h = r.u8()
        if h != height:
            r.fail(f"height {h}, its reference says {height}")
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            r.fail("node without entries")
        kpre, ksuf = _keys(r, n)
        common = r.varints(n) if h > 0 else None
        keys, prev = [], b""
        for pre, suf in zip(kpre, ksuf):
            if pre > len(prev):
                r.fail("key prefix longer than the previous key")
            prev = prev[:pre] + r.take(suf)
            keys.append(prev)

        def files_of(ids):
            for i in ids:
                if i >= len(files):
                    r.fail(f"data file {i} of {len(files)}")
            return [files[i] for i in ids]

        if h > 0:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            r.varints(n)              # num_keys
            r.varints(n)              # num_tree_bytes
            r.varints(n)              # num_indirect_value_bytes
            r.done()
            for key, c, f, o, l in zip(keys, common, files_of(fid), off, ln):
                if c > len(key):
                    r.fail("subtree prefix longer than its key")
                self._walk((f, o, l, h - 1), prefix + key[:c])
            return
        vlen = r.varints(n)
        kind = r.varints(n)
        if any(k not in (0, 1) for k in kind):
            r.fail(f"value kinds {sorted(set(kind))}")
        indirect = [i for i in range(n) if kind[i] == 1]
        fid = r.varints(len(indirect))
        off = r.varints(len(indirect))
        for i, f, o in zip(indirect, files_of(fid), off):
            self._values[(prefix + keys[i]).decode()] = (f, o, vlen[i])
        for i in range(n):
            if kind[i] == 0:
                self._values[(prefix + keys[i]).decode()] = r.take(vlen[i])
        r.done()

    # -------------------------------------------------------------- API
    def list(self) -> list:
        """Every key, sorted."""
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def read(self, key: str) -> bytes:
        """The value stored under `key`; KeyError if there is none."""
        v = self._values[key]
        return v if isinstance(v, bytes) else self._slice(*v)

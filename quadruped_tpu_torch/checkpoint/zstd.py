"""A Zstandard decoder (RFC 8878) in plain Python, for the compressed
nodes and chunks of the JAX package's orbax checkpoints.

Covers what a frame without a dictionary may hold: Raw, RLE and
Compressed blocks; Raw, RLE, Compressed and Treeless literals; Huffman
tables given as direct 4-bit weights or as FSE-coded weights, over one
stream or four; sequences with predefined, RLE, FSE-compressed and
repeated tables; repeat offsets; concatenated and skippable frames; and
the XXH64 content checksum, verified when the frame carries it.  A frame
that names a dictionary is refused.

Entry point: `decompress(data) -> bytes`.  Errors raise `ZstdError`.
"""

from __future__ import annotations

import struct

__all__ = ["ZstdError", "decompress", "xxh64"]

MAGIC = 0xFD2FB528
SKIPPABLE_MASK = 0xFFFFFFF0
SKIPPABLE_MAGIC = 0x184D2A50
MAX_BLOCK = 128 * 1024


class ZstdError(ValueError):
    """Malformed or unsupported Zstandard data."""


# ---------------------------------------------------------------- XXH64

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """The 64-bit xxHash of `data`."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        stripes = n // 32
        lanes = struct.unpack_from(f"<{4 * stripes}Q", data)
        for s in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[s])
            v2 = _round(v2, lanes[s + 1])
            v3 = _round(v3, lanes[s + 2])
            v4 = _round(v4, lanes[s + 3])
        i = 32 * stripes
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, struct.unpack_from("<Q", data, i)[0])
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (struct.unpack_from("<I", data, i)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------- bit streams


class _Forward:
    """Little-endian bit reader over bytes, least significant bit first
    (FSE table descriptions)."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read(self, n: int) -> int:
        lo, p = self.pos >> 3, self.pos
        hi = (p + n + 7) >> 3
        if hi > len(self.data):
            raise ZstdError("FSE table description runs past its data")
        self.pos += n
        return (int.from_bytes(self.data[lo:hi], "little") >> (p & 7)) & ((1 << n) - 1)

    def nbytes(self) -> int:
        return (self.pos + 7) >> 3


class _Backward:
    """The backward bit stream of Huffman and FSE coded data: read from
    the end, after the highest set bit of the last byte (the padding
    marker), down to the first byte; bits below the start read as 0."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("backward bit stream without its end marker")
        self.data = data
        self.pos = 8 * len(data) - 9 + data[-1].bit_length()

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            return (int.from_bytes(self.data[p >> 3:(p + n + 7) >> 3], "little")
                    >> (p & 7)) & ((1 << n) - 1)
        k = n + p
        if k <= 0:
            return 0
        v = int.from_bytes(self.data[:(k + 7) >> 3], "little") & ((1 << k) - 1)
        return v << -p


# ------------------------------------------------------------------ FSE


class _FSETable:
    """An FSE decoding table: per state the symbol, the number of bits to
    read and the base of the next state."""

    __slots__ = ("log", "symbol", "nbits", "base")

    def __init__(self, log, symbol, nbits, base):
        self.log, self.symbol, self.nbits, self.base = log, symbol, nbits, base

    @classmethod
    def from_counts(cls, counts, log: int) -> "_FSETable":
        size = 1 << log
        symbol = [0] * size
        high = size
        nxt = [0] * len(counts)
        for s, c in enumerate(counts):
            if c == -1:
                high -= 1
                symbol[high] = s
                nxt[s] = 1
        step = (size >> 1) + (size >> 3) + 3
        mask = size - 1
        pos = 0
        for s, c in enumerate(counts):
            if c <= 0:
                continue
            nxt[s] = c
            for _ in range(c):
                symbol[pos] = s
                pos = (pos + step) & mask
                while pos >= high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ZstdError("FSE distribution does not fill its table")
        nbits = [0] * size
        base = [0] * size
        for i in range(size):
            d = nxt[symbol[i]]
            nxt[symbol[i]] = d + 1
            nbits[i] = log - (d.bit_length() - 1)
            base[i] = (d << nbits[i]) - size
        return cls(log, symbol, nbits, base)

    @classmethod
    def rle(cls, sym: int) -> "_FSETable":
        return cls(0, [sym], [0], [0])


def _read_fse_counts(data: bytes, max_log: int, max_symbol: int):
    """An FSE table description (RFC 8878 4.1.1) -> (counts, accuracy
    log, bytes used)."""
    r = _Forward(data)
    log = r.read(4) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining = 1 << log
    counts = []
    while remaining > 0:
        if len(counts) > max_symbol:
            raise ZstdError("FSE table description has too many symbols")
        bits = (remaining + 1).bit_length()
        val = r.read(bits)
        lower = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - (remaining + 1)
        if (val & lower) < threshold:
            r.pos -= 1
            val &= lower
        elif val > lower:
            val -= threshold
        proba = val - 1
        remaining -= -proba if proba < 0 else proba
        counts.append(proba)
        if proba == 0:
            while True:
                rep = r.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
    if remaining != 0 or len(counts) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return counts, log, r.nbytes()


# --------------------------------------------------------------- Huffman

HUF_MAX_BITS = 11


class _HufTable:
    """A Huffman decoding table indexed by the next `max_bits` bits of
    the stream: the symbol and the code length there."""

    __slots__ = ("max_bits", "symbol", "nbits")

    def __init__(self, weights):
        total = sum(1 << (w - 1) for w in weights if w > 0)
        if total == 0:
            raise ZstdError("Huffman weights are all zero")
        max_bits = total.bit_length()
        left = (1 << max_bits) - total
        if left & (left - 1):
            raise ZstdError("Huffman weights do not sum to a power of two")
        weights = list(weights) + [left.bit_length()]
        if len(weights) > 256:
            raise ZstdError("more than 256 Huffman weights")
        if max_bits > HUF_MAX_BITS:
            raise ZstdError(f"Huffman code of {max_bits} bits")
        bits = [max_bits + 1 - w if w > 0 else 0 for w in weights]
        rank_count = [0] * (max_bits + 1)
        for b in bits:
            rank_count[b] += 1
        rank_idx = [0] * (max_bits + 1)
        size = 1 << max_bits
        nbits = [0] * size
        for i in range(max_bits, 0, -1):
            start = rank_idx[i]
            rank_idx[i - 1] = start + rank_count[i] * (1 << (max_bits - i))
            nbits[start:rank_idx[i - 1]] = [i] * (rank_idx[i - 1] - start)
        symbol = [0] * size
        for s, b in enumerate(bits):
            if b:
                n = 1 << (max_bits - b)
                code = rank_idx[b]
                symbol[code:code + n] = [s] * n
                rank_idx[b] += n
        self.max_bits, self.symbol, self.nbits = max_bits, symbol, nbits

    def decode_stream(self, data: bytes, count: int) -> bytes:
        """`count` symbols of one backward stream, which they must use up
        exactly."""
        if not data or data[-1] == 0:
            raise ZstdError("Huffman stream without its end marker")
        mb = self.max_bits
        mask = (1 << mb) - 1
        symbol, nbits = self.symbol, self.nbits
        pos = 8 * len(data) - 9 + data[-1].bit_length()
        out = bytearray(count)
        # a window of up to 8 bytes of the stream: acc holds bytes
        # [lo_byte, hi_byte), acc_lo = 8 * lo_byte
        acc, acc_lo = 0, pos + 1
        for i in range(count):
            if pos <= 0:
                raise ZstdError("Huffman stream ends early")
            if pos - mb < acc_lo and acc_lo > 0:
                hi = (pos + 7) >> 3
                lo = max(0, hi - 8)
                acc = int.from_bytes(data[lo:hi], "little")
                acc_lo = 8 * lo
            sh = pos - mb - acc_lo
            v = (acc >> sh) & mask if sh >= 0 else (acc << -sh) & mask
            out[i] = symbol[v]
            pos -= nbits[v]
        if pos != 0:
            raise ZstdError("Huffman stream not used up exactly")
        return bytes(out)


def _read_huffman_table(data: bytes):
    """A Huffman tree description -> (table, bytes used)."""
    if not data:
        raise ZstdError("missing Huffman tree description")
    hb = data[0]
    if hb >= 128:
        n = hb - 127
        nbytes = (n + 1) // 2
        if 1 + nbytes > len(data):
            raise ZstdError("Huffman weights run past the block")
        weights = []
        for i in range(n):
            b = data[1 + i // 2]
            weights.append(b >> 4 if i % 2 == 0 else b & 15)
        return _HufTable(weights), 1 + nbytes
    if 1 + hb > len(data):
        raise ZstdError("Huffman weights run past the block")
    body = data[1:1 + hb]
    counts, log, used = _read_fse_counts(body, 6, 255)
    table = _FSETable.from_counts(counts, log)
    r = _Backward(body[used:])
    sym, nb, base = table.symbol, table.nbits, table.base
    s1 = r.read(log)
    s2 = r.read(log)
    weights = []
    while True:
        weights.append(sym[s1])
        s1 = base[s1] + r.read(nb[s1])
        if r.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + r.read(nb[s2])
        if r.pos < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return _HufTable(weights), 1 + hb


# ------------------------------------------------------------- sequences

LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256,
                             512, 1024, 2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13,
                      14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195, 16387,
                                32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13,
                      14, 15, 16]

_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5

# (name, predefined counts, predefined accuracy log, max log, max symbol)
_SEQ_KINDS = (
    ("literal lengths", _LL_DEFAULT, 6, 9, 35),
    ("offsets", _OF_DEFAULT, 5, 8, 31),
    ("match lengths", _ML_DEFAULT, 6, 9, 52),
)
_PREDEFINED = tuple(_FSETable.from_counts(counts, log)
                    for _, counts, log, _, _ in _SEQ_KINDS)


class _FrameState:
    """What the blocks of one frame share: the output so far, the repeat
    offsets, and the last Huffman and FSE tables."""

    def __init__(self, window: int):
        self.out = bytearray()
        self.window = window
        self.rep = [1, 4, 8]
        self.huf = None
        self.seq_tables = [None, None, None]   # LL, OF, ML


def _literals(block: bytes, st: _FrameState):
    """The literals section -> (literals, bytes used)."""
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                     # Raw, RLE
        if fmt in (0, 2):
            size, hdr = b0 >> 3, 1
        elif fmt == 1:
            size, hdr = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, hdr = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if kind == 0:
            if hdr + size > len(block):
                raise ZstdError("raw literals run past the block")
            return bytes(block[hdr:hdr + size]), hdr + size
        if hdr >= len(block):
            raise ZstdError("RLE literals run past the block")
        return bytes([block[hdr]]) * size, hdr + 1
    # Compressed (2) or Treeless (3)
    if fmt in (0, 1):
        c = int.from_bytes(block[:3], "little")
        regen, comp, hdr = (c >> 4) & 0x3FF, (c >> 14) & 0x3FF, 3
    elif fmt == 2:
        c = int.from_bytes(block[:4], "little")
        regen, comp, hdr = (c >> 4) & 0x3FFF, (c >> 18) & 0x3FFF, 4
    else:
        c = int.from_bytes(block[:5], "little")
        regen, comp, hdr = (c >> 4) & 0x3FFFF, (c >> 22) & 0x3FFFF, 5
    streams = 1 if fmt == 0 else 4
    if hdr + comp > len(block):
        raise ZstdError("compressed literals run past the block")
    data = block[hdr:hdr + comp]
    if kind == 2:
        st.huf, used = _read_huffman_table(data)
        data = data[used:]
    elif st.huf is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    if streams == 1:
        lits = st.huf.decode_stream(data, regen)
    else:
        if len(data) < 6:
            raise ZstdError("4-stream literals without their jump table")
        s1, s2, s3 = struct.unpack_from("<3H", data)
        s4 = len(data) - 6 - s1 - s2 - s3
        if s4 < 1:
            raise ZstdError("corrupt literals jump table")
        per = (regen + 3) // 4
        counts = (per, per, per, regen - 3 * per)
        if counts[3] < 0:
            raise ZstdError("corrupt literals sizes")
        parts, p = [], 6
        for size, n in zip((s1, s2, s3, s4), counts):
            parts.append(st.huf.decode_stream(data[p:p + size], n))
            p += size
        lits = b"".join(parts)
    return lits, hdr + comp


def _sequences(data: bytes, st: _FrameState):
    """The sequences section -> [(literal length, match length, offset
    value)]."""
    if not data:
        raise ZstdError("missing sequences section")
    b0 = data[0]
    if b0 == 0:
        if len(data) != 1:
            raise ZstdError("bytes after an empty sequences section")
        return []
    if b0 < 128:
        nseq, p = b0, 1
    elif b0 < 255:
        nseq, p = ((b0 - 128) << 8) + data[1], 2
    else:
        nseq, p = data[1] + (data[2] << 8) + 0x7F00, 3
    modes = data[p]
    p += 1
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    for i, shift in enumerate((6, 4, 2)):       # LL, OF, ML
        mode = (modes >> shift) & 3
        name, _, _, max_log, max_sym = _SEQ_KINDS[i]
        if mode == 0:
            st.seq_tables[i] = _PREDEFINED[i]
        elif mode == 1:
            if data[p] > max_sym:
                raise ZstdError(f"RLE code {data[p]} out of range for {name}")
            st.seq_tables[i] = _FSETable.rle(data[p])
            p += 1
        elif mode == 2:
            counts, log, used = _read_fse_counts(data[p:], max_log, max_sym)
            st.seq_tables[i] = _FSETable.from_counts(counts, log)
            p += used
        elif st.seq_tables[i] is None:
            raise ZstdError(f"repeat mode for {name} without an earlier table")
    ll_t, of_t, ml_t = st.seq_tables
    r = _Backward(data[p:])
    ll, of, ml = r.read(ll_t.log), r.read(of_t.log), r.read(ml_t.log)
    seqs = []
    for i in range(nseq):
        of_code = of_t.symbol[of]
        ll_code = ll_t.symbol[ll]
        ml_code = ml_t.symbol[ml]
        if of_code > 31:
            raise ZstdError(f"offset code {of_code}")
        off = (1 << of_code) + r.read(of_code)
        mlen = ML_BASE[ml_code] + r.read(ML_BITS[ml_code])
        llen = LL_BASE[ll_code] + r.read(LL_BITS[ll_code])
        seqs.append((llen, mlen, off))
        if i + 1 < nseq:
            ll = ll_t.base[ll] + r.read(ll_t.nbits[ll])
            ml = ml_t.base[ml] + r.read(ml_t.nbits[ml])
            of = of_t.base[of] + r.read(of_t.nbits[of])
        if r.pos < 0:
            raise ZstdError("sequence bit stream overrun")
    if r.pos != 0:
        raise ZstdError("sequence bit stream not used up exactly")
    return seqs


def _execute(lits: bytes, seqs, st: _FrameState):
    out, rep = st.out, st.rep
    lp = 0
    for llen, mlen, off in seqs:
        if lp + llen > len(lits):
            raise ZstdError("sequence takes more literals than there are")
        out += lits[lp:lp + llen]
        lp += llen
        if off > 3:
            offset = off - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = off - 1 + (llen == 0)
            if idx == 0:
                offset = rep[0]
            else:
                offset = rep[idx] if idx < 3 else rep[0] - 1
                if idx > 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], offset
        if offset <= 0 or offset > len(out) or offset > st.window:
            raise ZstdError(f"match offset {offset} outside the window")
        start = len(out) - offset
        if offset >= mlen:
            out += out[start:start + mlen]
        else:
            chunk = out[start:]
            out += (chunk * (mlen // offset + 1))[:mlen]
    out += lits[lp:]


def _compressed_block(block: bytes, st: _FrameState):
    lits, used = _literals(block, st)
    _execute(lits, _sequences(block[used:], st), st)


def _frame(data, p: int):
    """Decode the frame at data[p:] -> (content, end position)."""
    fhd = data[p + 4]
    p += 5
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    checksum, did_flag = (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    window = None
    if not single:
        wd = data[p]
        p += 1
        wlog = 10 + (wd >> 3)
        wbase = 1 << wlog
        window = wbase + (wbase >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[did_flag]
    did = int.from_bytes(data[p:p + did_size], "little")
    p += did_size
    if did:
        raise ZstdError(f"frame needs dictionary {did}; dictionaries are not supported")
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            fcs += 256
        p += fcs_size
    if single:
        window = fcs
    st = _FrameState(window)
    block_max = min(MAX_BLOCK, window) if window else MAX_BLOCK
    while True:
        if p + 3 > len(data):
            raise ZstdError("truncated block header")
        bh = int.from_bytes(data[p:p + 3], "little")
        p += 3
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 0:
            if p + size > len(data):
                raise ZstdError("truncated raw block")
            st.out += data[p:p + size]
            p += size
        elif btype == 1:
            if p >= len(data):
                raise ZstdError("truncated RLE block")
            st.out += bytes([data[p]]) * size
            p += 1
        elif btype == 2:
            if size > block_max or p + size > len(data):
                raise ZstdError("compressed block too large or truncated")
            _compressed_block(data[p:p + size], st)
            p += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    out = bytes(st.out)
    if fcs is not None and len(out) != fcs:
        raise ZstdError(f"frame content is {len(out)} bytes, header says {fcs}")
    if checksum:
        if p + 4 > len(data):
            raise ZstdError("truncated content checksum")
        want = int.from_bytes(data[p:p + 4], "little")
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum mismatch")
        p += 4
    return out, p


def decompress(data: bytes) -> bytes:
    """The content of every frame in `data`, in order (skippable frames
    are skipped)."""
    data = bytes(data)
    parts = []
    p = 0
    while p < len(data):
        if p + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[p:p + 4], "little")
        if magic == MAGIC:
            try:
                out, p = _frame(data, p)
            except (IndexError, struct.error) as e:
                raise ZstdError(f"truncated frame: {e}") from e
            parts.append(out)
        elif magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            if p + 8 > len(data):
                raise ZstdError("truncated skippable frame")
            p += 8 + int.from_bytes(data[p + 4:p + 8], "little")
            if p > len(data):
                raise ZstdError("truncated skippable frame")
        else:
            raise ZstdError(f"not a Zstandard frame (magic {magic:#010x})")
    return b"".join(parts)

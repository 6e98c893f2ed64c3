"""MSB-first bit accumulation, splicing and reading on the host.

The counterpart of ``tpubz/hostref/bitio.py`` for what the port's stream
assembly and decoders use: ``BitAccum`` (header and footer fields, the
emitted blocks as byte runs, and payload words packed on the device), ``pack_bits`` on the native packer
and ``pack_bits_numpy`` (the scalar codec's, without it),
``splice_byte_chunks`` and ``IncrementalSplicer`` (blocks joined at bit
granularity) and ``BitReader`` (header fields of the decoders, and every bit
of the scalar decoder).
"""
from __future__ import annotations

import numpy as np

from ..native import pack_bits_native


class BitAccum:
    """Accumulates (value, nbits) fields and pre-packed byte runs; packs once
    at the end."""

    def __init__(self):
        # tagged chunks: ("f", vals, bits) field runs and ("b", bytes, nbits)
        # byte runs, zero-padded to the byte, which pack() splices verbatim
        self._chunks: list[tuple] = []
        self._pend_vals: list[int] = []
        self._pend_bits: list[int] = []
        self._total = 0

    def put(self, value: int, nbits: int) -> None:
        if nbits < 0 or nbits > 48:
            raise ValueError(f"nbits out of range: {nbits}")
        if nbits == 0:
            return
        value &= (1 << nbits) - 1
        # fields above 24 bits split, so the packer stays in 32-bit words
        while nbits > 24:
            hi = nbits - 24
            self._pend_vals.append(value >> 24)
            self._pend_bits.append(hi)
            self._total += hi
            value &= (1 << 24) - 1
            nbits = 24
        self._pend_vals.append(value)
        self._pend_bits.append(nbits)
        self._total += nbits

    def _flush_pending(self) -> None:
        if self._pend_vals:
            self._chunks.append(("f", np.asarray(self._pend_vals, dtype=np.uint32),
                                 np.asarray(self._pend_bits, dtype=np.int64)))
            self._pend_vals = []
            self._pend_bits = []

    def extend(self, vals, bits) -> None:
        """Append fields of at most 24 bits each."""
        vals = np.asarray(vals, dtype=np.uint32)
        bits = np.asarray(bits, dtype=np.int64)
        if vals.size == 0:
            return
        if int(bits.max(initial=0)) > 24:
            raise ValueError("extend() fields must be <= 24 bits")
        self._flush_pending()
        self._chunks.append(("f", vals, bits))
        self._total += int(bits.sum())

    def put_words(self, words: np.ndarray, nbits: int) -> None:
        """Append ``nbits`` of pre-packed MSB-first uint32 words (a payload
        packed on the device). Stored as a byte run, big-endian, with the
        bits of the last word past ``nbits`` zeroed."""
        if nbits == 0:
            return
        nw = (nbits + 31) // 32
        w = np.ascontiguousarray(np.asarray(words[:nw], dtype=np.uint32))
        pad = nw * 32 - nbits
        if pad:
            w = w.copy()
            w[-1] &= np.uint32(0xFFFFFFFF) << np.uint32(pad)
        self._flush_pending()
        self._chunks.append(("b", w.astype(">u4").tobytes(), nbits))
        self._total += nbits

    def put_bytes(self, data: bytes, nbits: int) -> None:
        """Append ``nbits`` of pre-packed MSB-first bytes (the pad bits of
        the final byte must be zero)."""
        if nbits == 0:
            return
        self._flush_pending()
        self._chunks.append(("b", data, nbits))
        self._total += nbits

    @property
    def bit_len(self) -> int:
        return self._total

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The fields as (vals, bits) arrays; byte runs become 8-bit fields
        and a sub-byte tail."""
        self._flush_pending()
        if not self._chunks:
            return np.zeros(0, np.uint32), np.zeros(0, np.int64)
        vs, bs = [], []
        for c in self._chunks:
            if c[0] == "f":
                vs.append(c[1])
                bs.append(c[2])
                continue
            _, data, nbits = c
            arr = np.frombuffer(data, np.uint8)[: (nbits + 7) // 8]
            full = nbits // 8
            vs.append(arr[:full].astype(np.uint32))
            bs.append(np.full(full, 8, np.int64))
            rem = nbits - full * 8
            if rem:
                vs.append(np.array([int(arr[full]) >> (8 - rem)], np.uint32))
                bs.append(np.array([rem], np.int64))
        return np.concatenate(vs), np.concatenate(bs)

    def pack(self) -> tuple[bytes, int]:
        """(bytes zero-padded to a whole byte, exact bit length)."""
        self._flush_pending()
        pieces: list[tuple[bytes, int]] = []
        fv: list[np.ndarray] = []
        fb: list[np.ndarray] = []

        def flush_fields():
            if fv:
                v = np.concatenate(fv) if len(fv) > 1 else fv[0]
                b = np.concatenate(fb) if len(fb) > 1 else fb[0]
                pieces.append((pack_bits(v, b), int(b.sum())))
                fv.clear()
                fb.clear()

        for c in self._chunks:
            if c[0] == "f":
                fv.append(c[1])
                fb.append(c[2])
            else:
                flush_fields()
                pieces.append((c[1], c[2]))
        flush_fields()
        data, total = splice_byte_chunks(pieces)
        if total != self._total:
            raise RuntimeError(f"packed {total} bits of {self._total}")
        return data, self._total


def pack_bits(vals: np.ndarray, bits: np.ndarray) -> bytes:
    """Pack fields MSB-first: field i takes bits [off_i, off_i + bits_i)."""
    return pack_bits_native(vals, bits)


def pack_bits_numpy(vals: np.ndarray, bits: np.ndarray) -> bytes:
    """``pack_bits`` in numpy: the offsets' prefix sum and word scatters.
    A field of at most 24 bits at an in-word offset of at most 31 spans at
    most two 32-bit words (24 + 31 < 64)."""
    vals = np.asarray(vals, dtype=np.uint64)
    bits = np.asarray(bits, dtype=np.int64)
    if vals.size == 0:
        return b""
    if int(bits.max()) > 24:
        raise ValueError("pack_bits_numpy fields must be <= 24 bits")
    offs = np.concatenate(([0], np.cumsum(bits)))[:-1]
    total = int(offs[-1] + bits[-1])
    nwords = (total + 31) // 32 + 1
    words = np.zeros(nwords, dtype=np.uint64)
    w = offs >> 5
    # the 64-bit window at word w holds the field at bit 64 - (offs % 32) - bits
    contrib = vals << (64 - (offs & 31) - bits).astype(np.uint64)
    np.bitwise_or.at(words, w, contrib >> np.uint64(32))
    np.bitwise_or.at(words, w + 1, contrib & np.uint64(0xFFFF_FFFF))
    return words.astype(">u4").tobytes()[: (total + 7) // 8]


def splice_byte_chunks(chunks: list[tuple[bytes, int]]) -> tuple[bytes, int]:
    """Join byte-padded bit chunks [(payload, exact bit length), ...] at bit
    granularity: (bytes, total bits)."""
    total = sum(n for _, n in chunks)
    inc = IncrementalSplicer(cap_hint=(total + 7) // 8 + 1)
    for payload, nbits in chunks:
        inc.add(payload, nbits)
    return inc.finish()


class IncrementalSplicer:
    """``splice_byte_chunks`` one chunk at a time, so the stream assembler
    folds each block in as the ordered drain yields it. Each chunk ORs in
    shifted right by the bit offset mod 8; the buffer doubles on demand."""

    def __init__(self, cap_hint: int = 1 << 16):
        self._buf = np.zeros(max(cap_hint, 64), np.uint8)
        self._off = 0  # bit offset

    def add(self, payload: bytes, nbits: int) -> None:
        if nbits == 0:
            return
        nb = (nbits + 7) // 8
        need = ((self._off + nbits + 7) >> 3) + 1  # +1: the low spill byte
        if need > self._buf.size:
            grown = np.zeros(max(need, 2 * self._buf.size), np.uint8)
            grown[: (self._off + 7) >> 3] = self._buf[: (self._off + 7) >> 3]
            self._buf = grown
        arr = np.frombuffer(payload, np.uint8)[:nb]
        rem = nbits & 7
        if rem and (int(arr[nb - 1]) & (0xFF >> rem)):
            arr = arr.copy()
            arr[nb - 1] &= (0xFF << (8 - rem)) & 0xFF
        base = self._off >> 3
        s = self._off & 7
        if s == 0:
            self._buf[base: base + nb] |= arr
        else:
            self._buf[base: base + nb] |= arr >> s
            self._buf[base + 1: base + 1 + nb] |= arr << (8 - s)
        self._off += nbits

    def finish(self) -> tuple[bytes, int]:
        return self._buf[: (self._off + 7) >> 3].tobytes(), self._off


class BitReader:
    """MSB-first reader over an in-memory byte buffer."""

    def __init__(self, data: bytes):
        self._d = np.frombuffer(data, dtype=np.uint8)
        self.pos = 0  # bit position

    @property
    def bit_len(self) -> int:
        return len(self._d) * 8

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if self.pos + nbits > self.bit_len:
            raise EOFError("bitstream exhausted")
        pos = self.pos
        first_byte = pos >> 3
        last_byte = (pos + nbits - 1) >> 3
        acc = 0
        for i in range(first_byte, last_byte + 1):
            acc = (acc << 8) | int(self._d[i])
        drop_right = (last_byte - first_byte + 1) * 8 - (pos & 7) - nbits
        self.pos = pos + nbits
        return (acc >> drop_right) & ((1 << nbits) - 1)

    def remaining(self) -> int:
        return self.bit_len - self.pos

    def read_bit(self) -> int:
        if self.pos >= self.bit_len:
            raise EOFError("bitstream exhausted")
        b = (int(self._d[self.pos >> 3]) >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return b

    def peek_bits_array(self, start_bit: int, count: int) -> np.ndarray:
        """Bits [start_bit, start_bit + count) as a uint8 array of 0 and 1."""
        idx = np.arange(start_bit, start_bit + count)
        return (self._d[idx >> 3] >> (7 - (idx & 7))) & 1

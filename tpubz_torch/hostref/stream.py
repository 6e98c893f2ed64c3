"""The scalar codec: whole streams in numpy and Python, none of the native
engine and none of the card.

The counterpart of ``tpubz/hostref/stream.py``, tpubz's codec oracle. It
shares no code with the port's kernels or its native engine, so it is their
independent oracle (``tests/test_torch_hostref.py``, ``chip_smoke.py``'s
``[oracle]``). No route of ``compress`` or ``decompress`` takes it; the
command line's ``--trace-bits`` decodes through it.

A stream is "BZh" and the level's digit, the blocks at bit granularity, the
48-bit footer magic, the stream CRC (each block's folded in order) and zero
bits to the byte.
"""
from __future__ import annotations

import os

import numpy as np

from ..format.constants import BLOCK_MAGIC, FOOTER_MAGIC, STREAM_MAGIC, block_budget
from ..format.crc import block_crc_numpy, stream_crc_fold
from .bitio import BitAccum, BitReader, pack_bits_numpy
from .block import decode_block, encode_block
from .rle1 import rle1_encode, split_blocks


def compress(data, level: int = 9) -> bytes:
    """``data`` (bytes-like or uint8 ndarray) -> a bzip2 stream at ``level``."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    if isinstance(data, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(data, dtype=np.uint8)
    else:
        arr = np.asarray(data, dtype=np.uint8)
    acc = BitAccum()
    for b in STREAM_MAGIC:
        acc.put(b, 8)
    acc.put(0x30 + level, 8)
    out, seg_out, seg_in = rle1_encode(arr)
    s_crc = 0
    for olo, ohi, ilo, ihi in split_blocks(out, seg_out, seg_in, block_budget(level)):
        crc = block_crc_numpy(arr[ilo:ihi])
        s_crc = stream_crc_fold(s_crc, crc)
        acc.extend(*encode_block(out[olo:ohi], crc).arrays())
    acc.put(FOOTER_MAGIC, 48)
    acc.put(s_crc, 32)
    return pack_bits_numpy(*acc.arrays())


def decompress(data: bytes, *, trace: bool | None = None) -> bytes:
    """Decode a bzip2 stream, or streams one after another (each starts at
    the byte after the previous one's end), as bunzip2 does. ``trace``
    logs each payload symbol's bit position at DEBUG on the ``tpubz_torch``
    logger; None takes it from TPUBZ_TRACE_BITS."""
    if trace is None:
        trace = bool(os.environ.get("TPUBZ_TRACE_BITS"))
    br = BitReader(data)
    parts: list[np.ndarray] = []
    while True:
        if bytes(br.read(8) for _ in range(3)) != STREAM_MAGIC:
            raise ValueError("not a bzip2 stream")
        level = br.read(8) - 0x30
        if not 1 <= level <= 9:
            raise ValueError("invalid block size digit")
        s_crc = 0
        while True:
            magic48 = br.read(48)
            if magic48 == FOOTER_MAGIC:
                break
            if magic48 != BLOCK_MAGIC:
                raise ValueError("invalid block header magic")
            raw, blk_crc = decode_block(br, level, trace)
            actual = block_crc_numpy(raw)
            if actual != blk_crc:
                raise ValueError(
                    f"block CRC mismatch: stream says {blk_crc:#010x}, got {actual:#010x}")
            s_crc = stream_crc_fold(s_crc, blk_crc)
            parts.append(raw)
        stored = br.read(32)
        if stored != s_crc:
            raise ValueError(f"stream CRC mismatch: stream says {stored:#010x}, got {s_crc:#010x}")
        nxt = (br.pos + 7) // 8
        if nxt + 4 > len(data) or data[nxt: nxt + 3] != STREAM_MAGIC:
            break
        br.pos = nxt * 8
    return np.concatenate(parts).tobytes() if parts else b""

"""bzip2's CRC-32 (CRC-32/BZIP2: MSB-first, poly 0x04C11DB7, init and xorout
0xFFFFFFFF), and the stream CRC fold.

``block_crc`` runs on the native engine (the routes'); ``block_crc_numpy``
is tpubz's numpy form for the scalar codec: CRC-32/BZIP2 is the bit
reversal of zlib's reflected CRC-32 over bit-reversed bytes,
rev32(zlib.crc32(rev8(d))).
"""
from __future__ import annotations

import zlib

import numpy as np

from ..native import block_crc_native

# the bit reversal of each byte value
_BITREV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.uint8)


def _as_bytes(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.asarray(data, dtype=np.uint8)


def block_crc(data) -> int:
    """CRC-32/BZIP2 of ``data`` (bytes-like or uint8 ndarray)."""
    return block_crc_native(_as_bytes(data))


def _rev32(x: int) -> int:
    return int(f"{x:032b}"[::-1], 2)


def block_crc_numpy(data) -> int:
    """``block_crc`` through zlib, without the native engine."""
    rev = _BITREV8[_as_bytes(data)]
    return _rev32(zlib.crc32(rev.tobytes()) & 0xFFFF_FFFF)


def stream_crc_fold(stream_crc: int, blk_crc: int) -> int:
    """The order-dependent stream CRC: rotate left by one, xor the block's."""
    s = ((stream_crc << 1) | (stream_crc >> 31)) & 0xFFFF_FFFF
    return s ^ blk_crc

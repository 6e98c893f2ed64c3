"""bzip2's CRC-32 (CRC-32/BZIP2: MSB-first, poly 0x04C11DB7, init and xorout
0xFFFFFFFF) on the native engine, and the stream CRC fold."""
from __future__ import annotations

import numpy as np

from ..native import block_crc_native


def block_crc(data) -> int:
    """CRC-32/BZIP2 of ``data`` (bytes-like or uint8 ndarray)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(data, dtype=np.uint8)
    return block_crc_native(np.asarray(data, dtype=np.uint8))


def stream_crc_fold(stream_crc: int, blk_crc: int) -> int:
    """The order-dependent stream CRC: rotate left by one, xor the block's."""
    s = ((stream_crc << 1) | (stream_crc >> 31)) & 0xFFFF_FFFF
    return s ^ blk_crc

"""Host emission of one block: Huffman refinement, headers, payload and packing.

The counterpart of ``tpubz/block/emit.py``. The whole emission is one
GIL-free call into the port's native engine (``native/emit.cpp``); it takes
the transform outputs as numpy arrays, whether a device block or the
native CPU engine made them.
"""
from __future__ import annotations

from ..format.constants import huffman_iters
from ..hostref.bitio import BitAccum
from ..native import emit_block_native


def emit_block(key, syms, rle2_len, freqs, used, crc) -> BitAccum:
    """The block's bits: magic, CRC, key, tables and payload. ``freqs`` is
    not read: the native refinement counts the symbols itself."""
    data, nbits = emit_block_native(int(key), int(crc), syms[:rle2_len], used,
                                    huffman_iters())
    acc = BitAccum()
    acc.put_bytes(data, nbits)
    return acc

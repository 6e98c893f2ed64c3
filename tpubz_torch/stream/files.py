"""Streaming file compression in bounded memory, on the port's scheduler.

The counterpart of ``tpubz/stream/files.py:compress_stream`` and
``compress_file``. The window reader, the bit sink and the decoders are
tpubz's (``_WindowItems``, ``_BitSink``, ``decompress_stream``,
``decompress_file``); only the engine choice and the block pipeline are the
port's: one ``block_results`` pipeline spans every window of the input.
"""
from __future__ import annotations

import numpy as np

from tpubz.format.constants import FOOTER_MAGIC, STREAM_MAGIC, block_budget
from tpubz.format.crc import stream_crc_fold
from tpubz.hostref.bitio import BitAccum
from tpubz.hostref.rle1 import rle1_blocks
from tpubz.stream.files import (  # noqa: F401 (decoders re-exported)
    WINDOW_BYTES,
    _BitSink,
    _WindowItems,
    decompress_file,
    decompress_stream,
)

from ..block.encode import resolve_device
from .api import block_results


def compress_stream(fin, fout, level: int = 9, *, device="cuda") -> int:
    """Compress the binary stream ``fin`` into a .bz2 stream on ``fout``
    with device blocks on ``device`` (None: the CPU engine alone). Returns
    the bytes written."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    dev = None if device is None else resolve_device(device)
    sink = _BitSink(fout)
    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + level, 8)
    sink.write_fields(*header.arrays())

    budget = block_budget(level)
    # the engine choice needs a block count before the pipeline starts: a
    # stream that ends inside the first window counts its blocks there; a
    # longer one goes by the reader's estimate, a window's worth or more
    first = np.frombuffer(fin.read(WINDOW_BYTES), np.uint8)
    items = _WindowItems(fin, budget, first_data=first)
    n_blocks = None
    if first.size < WINDOW_BYTES:
        n_blocks = len(rle1_blocks(first, budget)[1])
    s_crc = 0
    for crc, blk_bytes, nbits in block_results(level, items, dev, n_blocks):
        s_crc = stream_crc_fold(s_crc, crc)
        sink.write_chunk(blk_bytes, nbits)
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    sink.write_fields(*footer.arrays())
    sink.close()
    return (sink.total_bits + 7) // 8


def compress_file(src: str, dst: str, level: int = 9, *, device="cuda") -> None:
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        compress_stream(fin, fout, level, device=device)

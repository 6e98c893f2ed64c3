"""Whole-stream compression with every block's transforms on a torch device.

The counterpart of ``tpubz/stream/api.py:compress`` on its full-chain device
route. The stream assembly is tpubz's: the RLE1 scan cuts blocks (the
background ``Rle1Feed`` for large inputs), the header goes first, and an
ordered drain splices each block's bits and folds the stream CRC. Output
bytes equal ``tpubz.stream.api.compress_cpu`` and C bzip2's framing.

Pipeline:
  dispatcher thread  -- transform + fetch of each block, in block order
  emit pool          -- block CRC + native refinement and emission
                        (GIL-free), several blocks at a time
  caller's thread    -- ordered drain over a bounded window of blocks

Every block goes to the device. tpubz's hybrid CPU pool, tiny-stream CPU
routing, rig profile and straggler twinning are not ported yet.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from tpubz.format.constants import FOOTER_MAGIC, STREAM_MAGIC, block_budget
from tpubz.format.crc import block_crc, stream_crc_fold
from tpubz.hostref.bitio import BitAccum, IncrementalSplicer
from tpubz.hostref.rle1 import Rle1Feed, rle1_blocks

from ..block.encode import DeviceBlockEncoder

# emission is ~14 ms per level-9 block against ~14 ms of device work per
# block on the dispatcher (PERF.md), so 3 threads keep up with it
EMIT_THREADS = 3
# in-flight blocks of the ordered drain: one on the dispatcher, one per
# emit thread and one waiting; each pins ~1-3 MB of host memory
WINDOW = EMIT_THREADS + 2

# block count of the most recent compress() call
last_stream_stats: dict = {}


def compress(data, level: int = 9, *, device="cuda") -> bytes:
    """bzip2-compress ``data`` with the block transforms on ``device``
    ("cuda" or "cpu"; a CUDA device without a card raises RuntimeError)."""
    enc = DeviceBlockEncoder(level, device)
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    budget = block_budget(level)
    if arr.size > 4 * budget:
        # scan in a background thread; blocks dispatch as they are confirmed
        feed = Rle1Feed(arr, budget)
        items = (
            (feed.out[o0:o1], arr[i0:i1]) for o0, o1, i0, i1 in feed
        )
    else:
        out, blocks = rle1_blocks(arr, budget)
        items = [(out[o0:o1], arr[i0:i1]) for o0, o1, i0, i1 in blocks]

    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + level, 8)
    splicer = IncrementalSplicer(cap_hint=arr.size // 2 + 64)
    splicer.add(*header.pack())
    s_crc = 0
    for crc, data_b, nbits in _device_block_results(enc, items):
        s_crc = stream_crc_fold(s_crc, crc)
        splicer.add(data_b, nbits)
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    splicer.add(*footer.pack())
    payload, _ = splicer.finish()
    return payload


def _device_block_results(enc: DeviceBlockEncoder, items):
    """Yield (crc, packed bytes, nbits) per block, in block order, while
    later blocks are still on the device or in emission."""
    dispatch = ThreadPoolExecutor(1)  # device work stays in block order
    emit_pool = ThreadPoolExecutor(EMIT_THREADS)

    def on_device(blk):
        return enc.fetch(enc.transform(blk))

    def emit(fetch_fut, raw):
        crc = block_crc(raw)  # overlaps the block's device work
        key, syms, rle2_len, freqs, used = fetch_fut.result()
        acc = enc.emit_block(key, syms, rle2_len, freqs, used, crc)
        return (crc, *acc.pack())

    inflight: deque = deque()
    n_blocks = 0
    last_stream_stats.clear()
    try:
        for blk, raw in items:
            inflight.append(emit_pool.submit(emit, dispatch.submit(on_device, blk), raw))
            n_blocks += 1
            if len(inflight) >= WINDOW:
                yield inflight.popleft().result()
        while inflight:
            yield inflight.popleft().result()
    finally:
        dispatch.shutdown(wait=True, cancel_futures=True)
        emit_pool.shutdown(wait=True, cancel_futures=True)
    last_stream_stats.update(blocks=n_blocks)

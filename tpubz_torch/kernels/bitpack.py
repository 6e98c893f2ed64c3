"""MSB-first packing of variable-length fields into uint32 words.

The counterpart of ``tpubz/kernels/bitpack.py``. Field i takes the bits
[off_i, off_i + bits_i) of the stream, off_i the exclusive prefix sum of
the lengths, bit 0 the top bit of word 0; fields are 0 to 24 bits long and
hold no bit above their length. The words are uint32 bit patterns held in
an int32 tensor (PyTorch's uint32 has few kernels); ``words_to_bytes``
views them as uint32 on the host.

For a CUDA tensor ``pack_bits_device`` launches the hand-written kernel of
``csrc/bitpack.cu`` on the current stream (one CTA a tile of 4096 fields:
a block-wide scan of the lengths, a decoupled look-back across the tiles,
``atomicOr`` into words the call zeroes); for a CPU tensor it runs the plain
torch version ``pack_bits_device_ref``, tpubz's cumsum and two scatter-adds
in int64 arithmetic. ``kernels/huffman_dev.py:pack_payload`` launches the
same kernel with its fields gathered from the Huffman tables (``launch``).
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from . import _build

TILE = 4096  # fields one CTA of csrc/bitpack.cu takes (256 threads x 16)

# launches of the packing kernel in this process, by pack_bits_device or
# fused behind pack_payload's gather (CPU calls are not counted)
LAUNCHES = 0
_launch_lock = threading.Lock()


def _as_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) as the int32 tensor of their bit patterns."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def pack_bits_device_ref(vals: torch.Tensor, bits: torch.Tensor, out_words: int):
    """Plain torch version of ``pack_bits_device``."""
    v = vals.to(torch.int64) & 0xFFFFFFFF
    b = bits.to(torch.int64)
    v = torch.where(b > 0, v, 0)
    offs = torch.cumsum(b, 0) - b
    total = offs[-1] + b[-1]
    w = offs >> 5
    end = (offs & 31) + b
    fits = end <= 32
    # a field ends in its first word, or spills its low end - 32 bits into
    # the next; the shifts stay below 64 in either branch
    hi = torch.where(fits, v << torch.where(fits, 32 - end, 0), v >> torch.where(fits, 0, end - 32))
    lo = torch.where(fits, 0, (v << torch.where(fits, 0, 64 - end)) & 0xFFFFFFFF)
    # words past out_words go to a dump slot that is then cut off
    words = torch.zeros(out_words + 1, dtype=torch.int64, device=vals.device)
    words.index_add_(0, w.clamp(max=out_words), hi)
    words.index_add_(0, (w + 1).clamp(max=out_words), lo)
    return _as_int32_bits(words[:out_words]), total


def launch(entry: str, args, m: int, out_words: int, device: torch.device):
    """Launch the packing kernel through the library's ``entry`` with
    ``args`` (the pointers and sizes before its scratch), allocating the
    scratch and the outputs: (words int32[out_words], total 0-d int64)."""
    global LAUNCHES
    if not 1 <= m < 1 << 30 or out_words < 1:
        raise ValueError(f"the packing kernel takes 1 to 2^30 - 1 fields and a word or more, "
                         f"got {m} fields and {out_words} words")
    tiles = -(-m // TILE)
    scratch = torch.empty(tiles + 1, dtype=torch.int64, device=device)
    words = torch.empty(out_words, dtype=torch.int32, device=device)
    total = torch.empty((), dtype=torch.int64, device=device)
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, m, out_words, scratch.data_ptr(), words.data_ptr(),
                                 total.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return words, total


def pack_bits_device(vals: torch.Tensor, bits: torch.Tensor, out_words: int):
    """vals: int32[M] (uint32 bit patterns of fields of at most 24 bits),
    bits: int32[M] (0 allowed), M >= 1.

    Returns (words int32[out_words], the uint32 words MSB-first, and total
    0-d int64, the sum of the lengths); fields past out_words are dropped.
    A CUDA tensor launches the kernel on the current stream or raises; a
    CPU tensor runs the plain version."""
    if vals.dim() != 1 or vals.shape != bits.shape or vals.device != bits.device:
        raise TypeError("pack_bits_device takes two 1-D tensors of one length on one device")
    if vals.numel() < 1:
        raise ValueError("pack_bits_device takes one field or more")
    dev = vals.device
    if dev.type == "cpu":
        return pack_bits_device_ref(vals, bits, out_words)
    if dev.type != "cuda":
        raise ValueError(f"pack_bits_device: unsupported device {dev}")
    if vals.dtype != torch.int32 or bits.dtype != torch.int32:
        raise TypeError("the CUDA kernel takes int32 values and lengths")
    v, b = vals.contiguous(), bits.contiguous()
    return launch("tpubz_pack_bits_device", (v.data_ptr(), b.data_ptr()), v.numel(), out_words,
                  dev)


def words_to_bytes(words, total_bits: int) -> bytes:
    """Host: the big-endian bytes of the packed words, cut to the whole
    bytes of ``total_bits``. ``words``: the int32 tensor (on the CPU) or a
    numpy array of the uint32 words."""
    arr = np.ascontiguousarray(words.numpy() if isinstance(words, torch.Tensor) else words)
    arr = arr.view(np.uint32) if arr.dtype.itemsize == 4 else arr.astype(np.uint32)
    return arr.astype(">u4").tobytes()[: (int(total_bits) + 7) // 8]

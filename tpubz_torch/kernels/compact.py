"""The compact transfer forms of RLE2 symbol rows: a byte a symbol and a
sidecar of the rare symbols >= 256.

The counterpart of ``tpubz/block/encode.py:_stage_compact``, vmapped over the
block rows in ``tpubz/dist/sharded.py``. A symbol row of uint16 becomes its
low bytes (256 becomes 0, 257 becomes 1) and ``hi_packed``, the entries
``(pos << 1) | (sym - 256)`` of the symbols >= 256 before ``rle2_len`` in
position order; entries past ``HI_CAP`` are dropped and the rest of the
array is zero, while ``hi_count`` counts them all. The host fetches the
bytes and the sidecar, half the bytes of the symbols, and rebuilds the row
with ``block.encode.uncompact_syms``; a row whose count exceeds the cap is
fetched whole.

For a CUDA tensor ``stage_compact`` launches the hand-written kernel of
``csrc/compact.cu`` on the current stream, one launch and no memset (one CTA
a tile of a row: 16-byte loads of the symbols, the low bytes stored as whole
words, a block-wide scan of the flags and a look-back across the row's tiles
on the stream's scratch, ``kernels/look_back.py``; the row's last tile zeroes
the sidecar past the count); for a CPU tensor it runs the plain torch
version ``stage_compact_ref``, tpubz's cumsum and scatter.

``rle2_compact`` is the counterpart of ``tpubz/block/encode.py:
_rle2_compact``, the lean form of the one-block chain: RLE2 of the MTF
ranks without frequencies, the symbols clamped to a byte (``min(sym,
255)``: 256 and an EOB of 257 become 255, not their low bytes), and
``hi_pos``, the slots of the body's symbols 256 (the literals of rank 255;
the EOB at ``rle2_len - 1`` is never among them) in ascending order, the
entries past the count ``1 << 30``; ``hi_count`` counts them all, those
past ``HI_CAP`` too. The host rebuilds the symbols and counts the
frequencies (``block.encode.DeviceBlockEncoder.fetch_async``); a block whose
count exceeds the cap is fetched as its full symbol row. tpubz cuts the
byte stream into four quarters (``reshape(4, -1)`` views; N + 8 is a
multiple of 4, N a multiple of 256), which here is the one tensor. For a
CUDA tensor it is one call into ``csrc/rle2.cu`` (``tpubz_rle2_compact``:
the memset and the one-pass RLE2 kernel with the histogram left out, the
byte written beside each symbol, the EOB counted from the used map on the
card, and the rank-255 literals ranked in input order by their count in
each tile's look-back prefix and a block scan, so that no sort runs); for a
CPU tensor the plain version ``rle2_compact_ref``, tpubz's formulation:
``rle2_encode_ref``, the clamp and the positions of the flagged slots.
"""
from __future__ import annotations

import threading

import torch

from . import _build, look_back
from . import rle2

HI_CAP = 8192  # sidecar entries a row (csrc/compact.cu: kHiCap)
TILE = 8192  # symbols one CTA of csrc/compact.cu takes (256 threads x 32)

HI_NONE = 1 << 30  # a hi_pos entry past the count

# calls into the kernel library in this process (CPU calls are not
# counted): stage_compact's (one kernel each) and rle2_compact's, and the
# launches rle2_compact's calls enqueued (the memset and the kernel)
LAUNCHES = 0
LEAN_LAUNCHES = 0
LEAN_KERNEL_LAUNCHES = 0
_launch_lock = threading.Lock()


def stage_compact_ref(syms: torch.Tensor, rle2_len: torch.Tensor):
    """Plain torch version of ``stage_compact``."""
    B, OUT = syms.shape
    dev = syms.device
    s32 = syms.to(torch.int32)
    idx = torch.arange(OUT, dtype=torch.int32, device=dev)
    is_hi = (s32 >= 256) & (idx[None, :] < rle2_len.to(torch.int32)[:, None])
    hi_rank = torch.cumsum(is_hi, 1) - 1
    # every entry past the cap, and every lane that is no entry, goes to a
    # dump column that is then cut off
    tgt = torch.where(is_hi & (hi_rank < HI_CAP), hi_rank, HI_CAP)
    val = torch.where(is_hi, (idx[None, :] << 1) | (s32 - 256), 0)
    hi_packed = torch.zeros(B, HI_CAP + 1, dtype=torch.int32, device=dev)
    hi_packed.scatter_(1, tgt, val)
    return ((s32 & 0xFF).to(torch.uint8), hi_packed[:, :HI_CAP].contiguous(),
            is_hi.sum(1, dtype=torch.int32))


def stage_compact(syms: torch.Tensor, rle2_len: torch.Tensor):
    """syms: uint16[B, OUT] RLE2 symbol rows, row b's first rle2_len[b] the
    stream (rle2_len: int32[B] on the same device).

    Returns (syms_u8 uint8[B, OUT], hi_packed int32[B, HI_CAP], hi_count
    int32[B]). A CUDA tensor launches the kernel on the current stream or
    raises; a CPU tensor runs the plain version."""
    global LAUNCHES
    if syms.dtype != torch.uint16 or syms.dim() != 2 or not syms.is_contiguous():
        raise TypeError("stage_compact takes a contiguous 2-D uint16 tensor")
    B, OUT = syms.shape
    if rle2_len.dtype != torch.int32 or rle2_len.shape != (B,) or rle2_len.device != syms.device:
        raise TypeError(f"rle2_len must be an int32[{B}] tensor on the symbols' device")
    dev = syms.device
    if dev.type == "cpu":
        return stage_compact_ref(syms, rle2_len)
    if dev.type != "cuda":
        raise ValueError(f"stage_compact: unsupported device {dev}")
    if not 1 <= B <= 65535 or not 1 <= OUT < 1 << 29:
        raise ValueError(f"stage_compact takes 1 to 65535 rows of 1 to 2^29 symbols, got {B}x{OUT}")
    lengths = rle2_len.contiguous()
    syms_u8 = torch.empty(B, OUT, dtype=torch.uint8, device=dev)
    hi_packed = torch.empty(B, HI_CAP, dtype=torch.int32, device=dev)  # 16-byte aligned
    hi_count = torch.empty(B, dtype=torch.int32, device=dev)
    rc = look_back.enqueue(_build.load().tpubz_stage_compact, dev, look_back.status_words(OUT, B, TILE),
                           (syms.data_ptr(), lengths.data_ptr(), B, OUT),
                           (syms_u8.data_ptr(), hi_packed.data_ptr(), hi_count.data_ptr()))
    if rc != 0:
        raise RuntimeError(f"tpubz_stage_compact launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return syms_u8, hi_packed, hi_count


def rle2_compact_ref(ranks: torch.Tensor, n: int, used: torch.Tensor):
    """Plain torch version of ``rle2_compact``."""
    syms, rle2_len, _ = rle2.encode_ref64(ranks, n, used.sum() + 1)
    idx = torch.arange(syms.shape[0], device=syms.device)
    is_hi = (syms >= 256) & (idx < rle2_len - 1)
    hi_count = is_hi.sum(dtype=torch.int32)
    hi_pos = torch.full((HI_CAP,), HI_NONE, dtype=torch.int32, device=syms.device)
    found = torch.nonzero(is_hi).flatten()[:HI_CAP]  # ascending slots
    hi_pos[: found.numel()] = found.to(torch.int32)
    return (rle2_len, torch.clamp(syms, max=255).to(torch.uint8), hi_pos, hi_count,
            syms.to(torch.uint16))


def rle2_compact(ranks: torch.Tensor, n: int, used: torch.Tensor):
    """ranks: int32[N] MTF ranks (first n valid); used: bool[256], the
    block's used map (EOB = its count + 1), on the ranks' device.

    Returns (rle2_len 0-d int64, syms_u8 uint8[N+8], hi_pos int32[HI_CAP],
    hi_count 0-d int32, syms uint16[N+8]): syms and rle2_len are
    ``rle2_encode``'s, syms_u8 = min(syms, 255), and hi_pos the ascending
    slots below rle2_len - 1 that hold 256, padded with 1 << 30. A CUDA
    tensor launches the kernel on the current stream or raises; a CPU
    tensor runs the plain version."""
    global LEAN_LAUNCHES, LEAN_KERNEL_LAUNCHES
    dev = ranks.device
    if used.dtype != torch.bool or used.shape != (256,) or used.device != dev:
        raise TypeError("used must be a bool[256] tensor on the ranks' device")
    if dev.type == "cpu":
        return rle2_compact_ref(ranks, n, used)
    if dev.type != "cuda":
        raise ValueError(f"rle2_compact: unsupported device {dev}")
    rle2._check(ranks, n)  # the kernel is csrc/rle2.cu's
    N = ranks.shape[0]
    (rle2_len, hi_count, hi_pos, scratch, syms, syms_u8), zero, zero_bytes = rle2.carve(
        dev, ((torch.int64, ()), (torch.int32, ()), (torch.int32, (HI_CAP,))),
        ((None, rle2.scratch_bytes(1, N)), (torch.uint16, (N + 8,)), (torch.uint8, (N + 8,))))
    launched = rle2.enqueue("tpubz_rle2_compact", dev, ranks.data_ptr(), n, N,
                            used.contiguous().data_ptr(), scratch, syms.data_ptr(),
                            rle2_len.data_ptr(), syms_u8.data_ptr(), hi_pos.data_ptr(),
                            hi_count.data_ptr(), zero, zero_bytes)
    with _launch_lock:
        LEAN_LAUNCHES += 1
        LEAN_KERNEL_LAUNCHES += launched
    return rle2_len, syms_u8, hi_pos, hi_count, syms

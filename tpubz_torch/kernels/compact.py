"""The compact transfer form of RLE2 symbol rows: a byte a symbol and a
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
``csrc/compact.cu`` on the current stream (one CTA a tile of a row: the low
bytes, a block-wide scan of the flags and a look-back across the row's
tiles); for a CPU tensor it runs the plain torch version
``stage_compact_ref``, tpubz's cumsum and scatter.
"""
from __future__ import annotations

import threading

import torch

from . import _build

HI_CAP = 8192  # sidecar entries a row (csrc/compact.cu: kHiCap)
TILE = 4096  # symbols one CTA of csrc/compact.cu takes (256 threads x 16)

# calls into the kernel library in this process, one kernel each (CPU calls
# are not counted)
LAUNCHES = 0
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
    tiles = -(-OUT // TILE)
    scratch = torch.empty(B * (tiles + 1), dtype=torch.int32, device=dev)
    syms_u8 = torch.empty(B, OUT, dtype=torch.uint8, device=dev)
    hi_packed = torch.empty(B, HI_CAP, dtype=torch.int32, device=dev)
    hi_count = torch.empty(B, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_stage_compact(syms.data_ptr(), lengths.data_ptr(), B, OUT,
                                     scratch.data_ptr(), syms_u8.data_ptr(), hi_packed.data_ptr(),
                                     hi_count.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_stage_compact launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return syms_u8, hi_packed, hi_count

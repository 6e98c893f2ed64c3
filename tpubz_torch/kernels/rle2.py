"""RLE2 zero-run coding of MTF ranks.

The counterpart of ``tpubz/kernels/rle2.py:rle2_encode``. For a CUDA tensor
``rle2_encode`` enqueues the hand-written kernel of ``csrc/rle2.cu`` on the
current stream, after one memset: a single pass over the ranks, each tile's
output offset found by decoupled look-back over the tiles before it. For a
CPU tensor it runs the plain torch version ``rle2_encode_ref``, which keeps
tpubz's closed form (see that module's docstring): every input position
computes its own output slot and symbol, and one scatter writes them. A
zero run of length L becomes the floor(log2(L+1)) bijective base-2 digits
of L (RUNA=0, RUNB=1, low digit first), a rank r >= 1 becomes symbol r+1,
and the EOB goes last. The symbols are tpubz's uint16 (torch has few uint16
kernels besides copies and conversions: compare them as int64).

``rle2_encode_used`` is the same call with the EOB taken from the block's
used map on the card (its count + 1), as ``DeviceBlockEncoder.transform``
calls it: no launch of torch computes the EOB.

``rle2_encode_batch`` is the counterpart of ``tpubz/kernels/rle2.py:
rle2_encode_batch``, in its types (uint16 symbols, int32 length and
frequencies): for a CUDA tensor the same kernel runs with the row as a grid
dimension (``csrc/rle2.cu:tpubz_rle2_batch``), the EOBs a device int32[B];
``rle2_encode_batch_ref`` runs ``rle2_encode_ref`` row by row.

Each call allocates its outputs and the kernel's scratch as one
``torch.empty`` (``carve``), laid out so that the library's memset clears
the scratch, the frequencies and the symbols in one range.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import _build
from .mtf import row_lengths

TILE = 4096  # ranks one CTA of csrc/rle2.cu takes (256 threads x 16)
MAX_OUT = 1 << 20  # a row's output slots, N + 8, stay below it (csrc/rle2.cu: kMaxOut)

# calls into the kernel library in this process (CPU calls are not
# counted): rle2_encode's and rle2_encode_used's, and rle2_encode_batch's;
# and the launches those calls enqueued (the memset and the kernel)
LAUNCHES = 0
BATCH_LAUNCHES = 0
KERNEL_LAUNCHES = 0
BATCH_KERNEL_LAUNCHES = 0
_launch_lock = threading.Lock()


def num_digits(run_len: torch.Tensor) -> torch.Tensor:
    """Digit count of the bijective base-2 coding: floor(log2(L+1)), 0 when
    L <= 0. Exact integer ops: a 5-step binary search for the top set bit of
    L+1 (L < 2^31)."""
    x = torch.clamp(run_len + 1, min=1)
    top = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        hi = (x >> s) > 0
        top += hi * s
        x = torch.where(hi, x >> s, x)
    return torch.where(run_len > 0, top, 0)


def encode_ref64(ranks: torch.Tensor, n: int, eob: torch.Tensor | int):
    """tpubz's closed form with the symbols as int64: (syms int64[N+8],
    rle2_len 0-d int64, freqs int64[258])."""
    N = ranks.shape[0]
    OUT = N + 8  # slack for the EOB and a trailing run's digits
    dev = ranks.device
    BIG = 1 << 30
    r = ranks.to(torch.int64)
    idx = torch.arange(N, dtype=torch.int64, device=dev)
    valid = idx < n
    nonzero = valid & (r != 0)
    # last nonzero index strictly before i (or -1): exclusive prefix max
    last_nz = torch.cummax(torch.where(nonzero, idx, -1), 0).values
    prev_nz = torch.cat((torch.full((1,), -1, dtype=torch.int64, device=dev), last_nz[:-1]))
    # next nonzero index at or after i (or BIG): reverse prefix min
    next_nz = torch.cummin(torch.where(nonzero, idx, BIG).flip(0), 0).values.flip(0)
    run_before = torch.where(nonzero, idx - prev_nz - 1, 0)
    d = num_digits(run_before)
    emit = torch.where(nonzero, d + 1, 0)
    off = torch.cumsum(emit, 0) - emit  # exclusive; constant across a zero run
    total_body = emit.sum()
    # the trailing zero run after the last nonzero (or the whole block)
    tail_run = n - 1 - torch.where(nonzero, idx, -1).max()
    tail_d = num_digits(tail_run)

    # the (t+1)-th zero of a run carries digit t of the run's code, a
    # nonzero carries its literal at off + d; targets are unique, and every
    # other lane goes to the dump slot OUT
    run_len = torch.clamp(next_nz, max=n) - prev_nz - 1
    t = idx - prev_nz - 1
    zero_live = valid & (r == 0) & (t < num_digits(run_len))
    tgt = torch.where(nonzero, off + d, torch.where(zero_live, off + t, OUT))
    val = torch.where(nonzero, r + 1, ((run_len + 1) >> torch.clamp(t, 0, 31)) & 1)
    rle2_len = total_body + tail_d + 1
    syms = torch.zeros(OUT + 1, dtype=torch.int64, device=dev)
    syms[tgt] = val
    syms[rle2_len - 1] = torch.as_tensor(eob, dtype=torch.int64, device=dev)
    syms = syms[:OUT]
    out_idx = torch.arange(OUT, device=dev)
    freqs = torch.bincount(torch.where(out_idx < rle2_len, syms, 258), minlength=259)
    return syms, rle2_len, freqs[:258]


def rle2_encode_ref(ranks: torch.Tensor, n: int, eob: torch.Tensor | int):
    """Plain torch version of ``rle2_encode``."""
    syms, rle2_len, freqs = encode_ref64(ranks, n, eob)
    return syms.to(torch.uint16), rle2_len, freqs


def scratch_bytes(B: int, N: int) -> int:
    """The kernel's scratch for B rows: each row's status words (8 bytes a
    tile, at least one tile: csrc/rle2.cu's tiles_of), then each row's
    ticket (4 bytes)."""
    return B * (8 * max(1, -(-N // TILE)) + 4)


@functools.lru_cache(maxsize=64)
def _layout(parts):
    """Per part (its first 8-byte word, its last + 1, dtype, count, shape),
    every part 16-byte aligned; the words in all; the first cleared word
    is the caller's to pick."""
    plan, at = [], 0
    for dtype, shape in parts:
        nbytes = shape if dtype is None else math.prod(shape) * dtype.itemsize
        count = None if dtype is None else math.prod(shape)
        plan.append((at, at - (-nbytes // 8), dtype, count, shape))
        at += -(-nbytes // 16) * 2
    return tuple(plan), max(at, 2)


def carve(device, head, cleared):
    """One ``torch.empty`` of 8-byte words cut into the call's outputs and
    scratch: the ``head`` parts, then the ``cleared`` parts, each a (dtype,
    shape), or (None, bytes) for scratch that only the library touches.
    Returns (per part a tensor, or the scratch's address; the address of
    the first cleared byte; the cleared bytes): the range the library's
    memset clears. Few torch calls: this is the host side of every call."""
    plan, words = _layout((*head, *cleared))
    buf = torch.empty(words, dtype=torch.int64, device=device)
    base = buf.data_ptr()
    out = []
    for start, end, dtype, count, shape in plan:
        if dtype is None:
            out.append(base + 8 * start)
            continue
        t = buf[start] if shape == () and dtype == torch.int64 else buf[start:end]
        if dtype != torch.int64:
            t = t.view(dtype)
            t = t[0] if shape == () else t if t.shape[0] == count else t[:count]
        out.append(t.view(shape) if len(shape) > 1 else t)
    first = plan[len(head)][0]
    return out, base + 8 * first, 8 * (words - first)


# the current stream's handle without building a torch.cuda.Stream (12 us
# a call against 0.2 on an H100's host, PERF.md); the public call
# where this torch lacks it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def enqueue(name: str, device: torch.device, *args) -> int:
    """Call the library's entry point ``name`` with args, then its launch
    count (out) and the current stream of ``device``; the device is made
    current for the call only where it is not already. Returns the
    launches; raises RuntimeError when the library reports a CUDA error."""
    fn = getattr(_build.load(), name)
    launched = ctypes.c_int(0)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if _raw_stream is not None:
        stream = _raw_stream(index)
    else:
        stream = torch.cuda.current_stream(index).cuda_stream
    if index == current:
        rc = fn(*args, ctypes.byref(launched), stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return launched.value


def _check(ranks: torch.Tensor, n: int) -> None:
    if ranks.dtype != torch.int32 or ranks.dim() != 1:
        raise TypeError("rle2_encode takes a 1-D int32 tensor")
    N = ranks.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f"n={n} outside [0, {N}]")
    if N + 8 >= MAX_OUT:
        raise ValueError(f"N={N} is too large for the CUDA kernel (N + 8 must stay below 2^20)")
    if not ranks.is_contiguous() or ranks.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a contiguous, 16-byte aligned tensor")


def _eob_args(eob, device):
    """(value, int64 scalar, int32 scalar, the tensor kept alive) for
    tpubz_rle2: a host int goes by value, a device scalar by pointer."""
    if not isinstance(eob, torch.Tensor):
        return int(eob), None, None, None
    if eob.numel() != 1:
        raise ValueError("eob must be one symbol")
    if eob.device != device or eob.dtype not in (torch.int64, torch.int32):
        eob = eob.to(device=device, dtype=torch.int64)
    if eob.dtype == torch.int64:
        return 0, eob.data_ptr(), None, eob
    return 0, None, eob.data_ptr(), eob


def _one_block(ranks: torch.Tensor, n: int, eob, used):
    """The CUDA call of rle2_encode (eob) and rle2_encode_used (used)."""
    global LAUNCHES, KERNEL_LAUNCHES
    dev = ranks.device
    _check(ranks, n)
    N = ranks.shape[0]
    # the EOB's tensor (keep) stays referenced until the call is enqueued
    value, eob64, eob32, keep = (0, None, None, None) if used is not None else _eob_args(eob, dev)
    (rle2_len, scratch, freqs, syms), zero, zero_bytes = carve(
        dev, ((torch.int64, ()),),
        ((None, scratch_bytes(1, N)), (torch.int64, (258,)), (torch.uint16, (N + 8,))))
    launched = enqueue("tpubz_rle2", dev, ranks.data_ptr(), n, N, value, eob64, eob32,
                       None if used is None else used.data_ptr(), scratch, syms.data_ptr(),
                       rle2_len.data_ptr(), freqs.data_ptr(), zero, zero_bytes)
    with _launch_lock:
        LAUNCHES += 1
        KERNEL_LAUNCHES += launched
    return syms, rle2_len, freqs


def rle2_encode(ranks: torch.Tensor, n: int, eob: torch.Tensor | int):
    """ranks: int32[N] MTF ranks (first n valid); eob = used symbol count + 1,
    a host int or a device scalar (it stays on the device).

    Returns (syms uint16[N+8], rle2_len 0-d int64, freqs int64[258]): the
    RLE2 symbol stream, whose first rle2_len entries end with the EOB, and
    the histogram of those entries; syms[rle2_len:] is 0. A CUDA tensor
    launches the kernel on the current stream or raises; a CPU tensor runs
    the plain version."""
    dev = ranks.device
    if dev.type == "cpu":
        return rle2_encode_ref(ranks, n, eob)
    if dev.type != "cuda":
        raise ValueError(f"rle2_encode: unsupported device {dev}")
    return _one_block(ranks, n, eob, None)


def rle2_encode_used(ranks: torch.Tensor, n: int, used: torch.Tensor):
    """``rle2_encode(ranks, n, used.sum() + 1)`` with the EOB counted on the
    card from ``used``, the block's bool[256] used map on the ranks'
    device."""
    dev = ranks.device
    if used.dtype != torch.bool or used.shape != (256,) or used.device != dev:
        raise TypeError("used must be a bool[256] tensor on the ranks' device")
    if dev.type == "cpu":
        return rle2_encode_ref(ranks, n, used.sum() + 1)
    if dev.type != "cuda":
        raise ValueError(f"rle2_encode_used: unsupported device {dev}")
    return _one_block(ranks, n, None, used.contiguous())


def _batch_eob(eob, B: int, device) -> torch.Tensor:
    eob = torch.as_tensor(eob, device=device)
    if eob.shape != (B,):
        raise ValueError(f"eob must hold one symbol for each of the {B} rows")
    return eob.to(torch.int32).contiguous()


def rle2_encode_batch_ref(ranks: torch.Tensor, n, eob):
    """Plain torch version of ``rle2_encode_batch``: ``rle2_encode_ref`` row
    by row."""
    B, N = ranks.shape
    lengths = row_lengths(n, B, N, ranks.device).tolist()
    ends = _batch_eob(eob, B, ranks.device)
    syms = torch.zeros(B, N + 8, dtype=torch.uint16, device=ranks.device)
    rle2_len = torch.zeros(B, dtype=torch.int32, device=ranks.device)
    freqs = torch.zeros(B, 258, dtype=torch.int32, device=ranks.device)
    for b in range(B):
        syms[b], rle2_len[b], freqs[b] = rle2_encode_ref(ranks[b], lengths[b], ends[b])
    return syms, rle2_len, freqs


def rle2_encode_batch(ranks: torch.Tensor, n, eob):
    """ranks: int32[B, N] MTF ranks, row b's first n[b] valid (B host ints,
    or an int32[B] tensor on ranks' device); eob: each row's used symbol
    count + 1, int32[B] (it stays on the device).

    Returns (syms uint16[B, N+8], rle2_len int32[B], freqs int32[B, 258]),
    row b equal to ``rle2_encode(ranks[b], n[b], eob[b])``'s in tpubz's
    batch types; syms are 0 past rle2_len. A CUDA tensor launches the
    kernel on the current stream or raises; a CPU tensor runs the plain
    version."""
    global BATCH_LAUNCHES, BATCH_KERNEL_LAUNCHES
    dev = ranks.device
    if dev.type == "cpu":
        return rle2_encode_batch_ref(ranks, n, eob)
    if dev.type != "cuda":
        raise ValueError(f"rle2_encode_batch: unsupported device {dev}")
    if ranks.dtype != torch.int32 or ranks.dim() != 2 or not ranks.is_contiguous():
        raise TypeError("rle2_encode_batch takes a contiguous 2-D int32 tensor")
    B, N = ranks.shape
    if not 1 <= B <= 65535:
        raise ValueError(f"rle2_encode_batch takes 1 to 65535 rows, got {B}")
    if N % 4:
        raise ValueError("the CUDA kernel takes rows of a multiple of 4 ranks")
    _check(ranks[0], 0)
    lengths = row_lengths(n, B, N, dev)
    ends = _batch_eob(eob, B, dev)
    (rle2_len, scratch, freqs, syms), zero, zero_bytes = carve(
        dev, ((torch.int32, (B,)),),
        ((None, scratch_bytes(B, N)), (torch.int32, (B, 258)), (torch.uint16, (B, N + 8))))
    launched = enqueue("tpubz_rle2_batch", dev, ranks.data_ptr(), lengths.data_ptr(), B, N,
                       ends.data_ptr(), scratch, syms.data_ptr(), rle2_len.data_ptr(),
                       freqs.data_ptr(), zero, zero_bytes)
    with _launch_lock:
        BATCH_LAUNCHES += 1
        BATCH_KERNEL_LAUNCHES += launched
    return syms, rle2_len, freqs

"""RLE2 zero-run coding of MTF ranks.

The counterpart of ``tpubz/kernels/rle2.py:rle2_encode``. For a CUDA tensor
``rle2_encode`` launches the hand-written kernels of ``csrc/rle2.cu`` on the
current stream (tile statistics, a scan over the tiles, the tiled write);
for a CPU tensor it runs the plain torch version ``rle2_encode_ref``, which
keeps tpubz's closed form (see that module's docstring): every input
position computes its own output slot and symbol, and one scatter writes
them. A zero run of length L becomes the floor(log2(L+1)) bijective base-2
digits of L (RUNA=0, RUNB=1, low digit first), a rank r >= 1 becomes symbol
r+1, and the EOB goes last.

``rle2_encode_batch`` is the counterpart of ``tpubz/kernels/rle2.py:
rle2_encode_batch``, in its types (uint16 symbols, int32 length and
frequencies): for a CUDA tensor the same three kernels run with the row as
a grid dimension (``csrc/rle2.cu:tpubz_rle2_batch``), the EOBs a device
int32[B]; ``rle2_encode_batch_ref`` runs ``rle2_encode_ref`` row by row.
"""
from __future__ import annotations

import threading

import torch

from . import _build
from .mtf import row_lengths

TILE = 4096  # ranks one CTA of csrc/rle2.cu takes (256 threads x 16)

# calls into the kernel library in this process, three kernels each (CPU
# calls are not counted): rle2_encode's, and rle2_encode_batch's
LAUNCHES = 0
BATCH_LAUNCHES = 0
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


def rle2_encode_ref(ranks: torch.Tensor, n: int, eob: torch.Tensor | int):
    """Plain torch version of ``rle2_encode``."""
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
    syms = syms[:OUT].to(torch.int32)
    out_idx = torch.arange(OUT, device=dev)
    freqs = torch.bincount(torch.where(out_idx < rle2_len, syms, 258), minlength=259)
    return syms, rle2_len, freqs[:258]


def _check(ranks: torch.Tensor, n: int) -> None:
    if ranks.dtype != torch.int32 or ranks.dim() != 1:
        raise TypeError("rle2_encode takes a 1-D int32 tensor")
    N = ranks.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f"n={n} outside [0, {N}]")
    if N + 8 >= 1 << 31:
        raise ValueError(f"N={N} is too large for the CUDA kernels")
    if not ranks.is_contiguous() or ranks.data_ptr() % 16:
        raise ValueError("the CUDA kernels take a contiguous, 16-byte aligned tensor")


def rle2_encode(ranks: torch.Tensor, n: int, eob: torch.Tensor | int):
    """ranks: int32[N] MTF ranks (first n valid); eob = used symbol count + 1,
    a host int or a device scalar (it stays on the device).

    Returns (syms int32[N+8], rle2_len 0-d int64, freqs int64[258]): the
    RLE2 symbol stream, whose first rle2_len entries end with the EOB, and
    the histogram of those entries; syms[rle2_len:] is 0. A CUDA tensor
    launches the kernels on the current stream or raises; a CPU tensor runs
    the plain version."""
    global LAUNCHES
    dev = ranks.device
    if dev.type == "cpu":
        return rle2_encode_ref(ranks, n, eob)
    if dev.type != "cuda":
        raise ValueError(f"rle2_encode: unsupported device {dev}")
    _check(ranks, n)
    N = ranks.shape[0]
    nb = -(-N // TILE)
    end = torch.as_tensor(eob, device=dev).to(torch.int64).reshape(())
    scratch = torch.empty(6 * nb, dtype=torch.int32, device=dev)
    syms = torch.empty(N + 8, dtype=torch.int32, device=dev)
    rle2_len = torch.empty((), dtype=torch.int64, device=dev)
    freqs = torch.empty(258, dtype=torch.int64, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_rle2(ranks.data_ptr(), n, N, end.data_ptr(), scratch.data_ptr(), nb,
                            syms.data_ptr(), rle2_len.data_ptr(), freqs.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_rle2 launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return syms, rle2_len, freqs


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
    # built in int32: torch has few uint16 kernels besides conversion
    syms = torch.zeros(B, N + 8, dtype=torch.int32, device=ranks.device)
    rle2_len = torch.zeros(B, dtype=torch.int32, device=ranks.device)
    freqs = torch.zeros(B, 258, dtype=torch.int32, device=ranks.device)
    for b in range(B):
        syms[b], rle2_len[b], freqs[b] = rle2_encode_ref(ranks[b], lengths[b], ends[b])
    return syms.to(torch.uint16), rle2_len, freqs


def rle2_encode_batch(ranks: torch.Tensor, n, eob):
    """ranks: int32[B, N] MTF ranks, row b's first n[b] valid (B host ints,
    or an int32[B] tensor on ranks' device); eob: each row's used symbol
    count + 1, int32[B] (it stays on the device).

    Returns (syms uint16[B, N+8], rle2_len int32[B], freqs int32[B, 258]),
    row b equal to ``rle2_encode(ranks[b], n[b], eob[b])``'s in tpubz's
    batch types; syms are 0 past rle2_len. A CUDA tensor launches the
    kernels on the current stream or raises; a CPU tensor runs the plain
    version."""
    global BATCH_LAUNCHES
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
        raise ValueError("the CUDA kernels take rows of a multiple of 4 ranks")
    _check(ranks[0], 0)
    lengths = row_lengths(n, B, N, dev)
    ends = _batch_eob(eob, B, dev)
    nb = -(-N // TILE)
    scratch = torch.empty(6 * B * nb, dtype=torch.int32, device=dev)
    syms = torch.empty(B, N + 8, dtype=torch.uint16, device=dev)
    rle2_len = torch.empty(B, dtype=torch.int32, device=dev)
    freqs = torch.empty(B, 258, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_rle2_batch(ranks.data_ptr(), lengths.data_ptr(), B, N, ends.data_ptr(),
                                  scratch.data_ptr(), nb, syms.data_ptr(), rle2_len.data_ptr(),
                                  freqs.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_rle2_batch launch failed: CUDA error {rc}")
    with _launch_lock:
        BATCH_LAUNCHES += 1
    return syms, rle2_len, freqs

"""RLE2 zero-run coding of MTF ranks, in plain torch.

The counterpart of ``tpubz/kernels/rle2.py:rle2_encode``, with the same
closed form (see that module's docstring): every input position computes its
own output slot and symbol, and one scatter writes them. A zero run of
length L becomes the floor(log2(L+1)) bijective base-2 digits of L (RUNA=0,
RUNB=1, low digit first), a rank r >= 1 becomes symbol r+1, and the EOB goes
last.
"""
from __future__ import annotations

import torch


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


def rle2_encode(ranks: torch.Tensor, n: int, eob: torch.Tensor | int):
    """ranks: int32[N] MTF ranks (first n valid); eob = used symbol count + 1.

    Returns (syms int32[N+8], rle2_len 0-d int64, freqs int64[258]): the
    RLE2 symbol stream, whose first rle2_len entries end with the EOB, and
    the histogram of those entries. Only syms[:rle2_len] is specified."""
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

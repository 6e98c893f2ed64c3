"""Move-to-front ranks of a BWT last column, chunk by chunk.

The counterpart of ``tpubz/kernels/mtf.py:mtf_ranks`` (see that module's
docstring for the formulation). ``mtf_parts`` builds, for each 256-wide
chunk, each position's in-chunk previous and next occurrence and the
recency keys at the chunk start, in plain torch; ``ranks_from_parts``
(``mtf_dominance.py``, the CUDA kernel on the card) turns them into ranks.

Where the TPU formulation avoided gathers and scatters, this one uses them:
the (symbol, position) sort is taken back by a scatter, and the initial rank
of a first-ever occurrence is a gather from the cumulative count of used
symbols instead of a (nc, 256, 256) compare-count.
"""
from __future__ import annotations

import torch

from .mtf_dominance import ranks_from_parts

ABSENT = 256


def mtf_parts(last: torch.Tensor, n: int, chunk: int = 256):
    """last: uint8[N] BWT output (first n valid; N % chunk == 0).

    Returns (lprev, lnext, keyi int32 (nc, chunk), keyrow int32 (nc, 256),
    used bool[256]), the inputs of ``ranks_from_parts``."""
    N = last.shape[0]
    if N % chunk:
        raise ValueError("N must be a multiple of the chunk size")
    nc = N // chunk
    dev = last.device
    i64 = torch.int64
    idx = torch.arange(N, dtype=i64, device=dev)
    # pad lanes carry symbol 256, their own column of last_pos below
    sym = torch.where(idx < n, last.to(i64), 256)

    # global prev/next occurrence: a stable sort keeps equal symbols in
    # position order, and a scatter takes the result back to positions
    s_sym, s_idx = torch.sort(sym, stable=True)
    same = s_sym[1:] == s_sym[:-1]
    prev_sorted = torch.full((N,), -1, dtype=i64, device=dev)
    prev_sorted[1:] = torch.where(same, s_idx[:-1], -1)
    next_sorted = torch.full((N,), N, dtype=i64, device=dev)
    next_sorted[:-1] = torch.where(same, s_idx[1:], N)
    prev_g = torch.empty(N, dtype=i64, device=dev)
    prev_g[s_idx] = prev_sorted
    next_g = torch.empty(N, dtype=i64, device=dev)
    next_g[s_idx] = next_sorted

    # last occurrence per (chunk, symbol): the last entry of each group in
    # the sorted stream, scattered into (nc, 257) plus one dump slot
    s_cid = s_idx // chunk
    last_in_group = torch.ones(N, dtype=torch.bool, device=dev)
    last_in_group[:-1] = ~same | (s_cid[1:] != s_cid[:-1])
    tgt = torch.where(last_in_group, s_cid * 257 + s_sym, nc * 257)
    last_pos = torch.full((nc * 257 + 1,), -1, dtype=i64, device=dev)
    last_pos[tgt] = s_idx
    # running max over chunks; its last row is the global last occurrence
    run = torch.cummax(last_pos[:-1].view(nc, 257), dim=0).values
    used = run[-1, :256] >= 0
    used_count = torch.cumsum(used.to(i64), 0)
    init_rank = torch.where(used, used_count - 1, ABSENT)
    last_before = torch.cat(
        (torch.full((1, 256), -1, dtype=i64, device=dev), run[:-1, :256])
    )
    keyrow = torch.where(last_before >= 0, N - last_before, 2 * N + init_rank[None, :])

    # initial rank of each position's symbol = #{used t < sym}; pad lanes
    # (sym 256) read the used count, as in tpubz, and are never consumed
    used_below = torch.cat((torch.zeros(1, dtype=i64, device=dev), used_count))
    irank_pos = used_below[sym]
    cstart = idx // chunk * chunk
    keyi = torch.where(prev_g >= 0, N - prev_g, 2 * N + irank_pos)
    lprev = torch.where(prev_g >= cstart, prev_g - cstart, -1)
    lnext = torch.where(next_g < cstart + chunk, next_g - cstart, chunk)
    i32 = torch.int32
    return (
        lprev.to(i32).view(nc, chunk),
        lnext.to(i32).view(nc, chunk),
        keyi.to(i32).view(nc, chunk),
        keyrow.to(i32),
        used,
    )


def mtf_ranks(last: torch.Tensor, n: int, chunk: int = 256):
    """last: uint8[N] BWT output (first n valid; N % chunk == 0).

    Returns (ranks int32[N], used bool[256]): ranks[:n] are the MTF ranks of
    last[:n] over the sorted used-symbol alphabet; pad lanes are unspecified.
    """
    lprev, lnext, keyi, keyrow, used = mtf_parts(last, n, chunk)
    return ranks_from_parts(lprev, lnext, keyi, keyrow).view(-1), used

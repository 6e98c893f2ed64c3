"""Rotation suffix sort (BWT forward) by prefix doubling, in plain torch.

The counterpart of ``tpubz/kernels/suffix_sort.py:bwt_forward``, with the
same contract: ``key`` is the number of rotations strictly smaller than
rotation 0, ``last[:n]`` is the BWT last column (periodic inputs included)
and the pad lanes are zero. The JAX package runs this outside any Pallas
kernel, as XLA sorts; here ``torch.sort`` carries it.

Differences from the TPU formulation, which avoided gathers and scatters:
  - 2-ary doubling on one packed int64 key per round, (rank[i] << 32) |
    rank[(i+k) mod n], instead of a 4-key variadic sort. The seed rank packs
    three bytes (24 bits) and later ranks are dense (< n < 2^20), so the key
    fits 56 bits;
  - the work runs over the first n lanes only, so the mod-n shift is a
    gather at (i+k) % n and no pad rank is needed;
  - the rank write-back to position order is a scatter ``rank[order] = ...``;
  - the stop test reads the class count to the host once per round: stop when
    every rotation is its own class, or when a round leaves the count (and
    so the partition, since classes only split) unchanged, which is the
    fixpoint of periodic blocks.
"""
from __future__ import annotations

import torch


def bwt_forward(data: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """data: uint8[N], first n valid. Returns (key, last uint8[N]): key is a
    0-d int64 tensor on data's device."""
    N = data.shape[0]
    dev = data.device
    last = torch.zeros(N, dtype=torch.uint8, device=dev)
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=dev), last
    block = data[:n]
    idx = torch.arange(n, dtype=torch.int64, device=dev)

    def shifted(r, k):
        return r[(idx + k) % n]

    d0 = block.to(torch.int64)
    rank = (d0 << 16) | (shifted(d0, 1) << 8) | shifted(d0, 2)
    k = 3
    prev_distinct = -1
    while True:
        skey, order = torch.sort((rank << 32) | shifted(rank, k))
        new_sorted = torch.zeros(n, dtype=torch.int64, device=dev)
        torch.cumsum(skey[1:] != skey[:-1], 0, out=new_sorted[1:])
        distinct = int(new_sorted[-1]) + 1
        if distinct == prev_distinct:
            break  # fixpoint: rank already encodes this partition
        rank = torch.empty_like(rank)
        rank[order] = new_sorted
        if distinct == n:
            break
        prev_distinct = distinct
        k *= 2
    # ties left in rank are classes of identical rotations (periodic blocks):
    # they share their last byte, so a stable sort keyed by the next
    # rotation's rank, in j order, gives the true last column
    key = (rank < rank[0]).sum()
    perm = torch.sort(shifted(rank, 1), stable=True).indices
    last[:n] = block[perm]
    return key, last

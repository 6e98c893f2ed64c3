"""Rotation suffix sort (BWT forward) by prefix doubling, on the bitonic sort.

The counterpart of ``tpubz/kernels/suffix_sort.py:bwt_forward``, with the
same contract: ``key`` is the number of rotations strictly smaller than
rotation 0, ``last[:n]`` is the BWT last column (periodic inputs included)
and the pad lanes are zero. The JAX package runs this outside any Pallas
kernel, as XLA sorts; here both sorts are the bitonic network of
``bitonic.py`` (hand-written CUDA on the card, its plain torch version on
the CPU), over the first n lanes padded to P, the next power of two.

Differences from the TPU formulation, which avoided gathers and scatters:
  - 2-ary doubling on one packed int64 key per round, (rank[i] << 32) |
    rank[(i+k) mod n], instead of a 4-key variadic sort. The seed rank packs
    three bytes (24 bits) and later ranks are dense (< n < 2^20), so the key
    fits 56 bits and the pad key INT64_MAX sorts after every real one. The
    payload is the position; the sort is not stable, which the round does
    not need: equal keys get equal new ranks whatever their order;
  - the mod-n shift is a gather at (i+k) % n and no pad rank is needed;
  - the rank write-back to position order is a scatter ``rank[order] = ...``;
  - the stop test reads the class count to the host once per round: stop when
    every rotation is its own class, or when a round leaves the count (and
    so the partition, since classes only split) unchanged, which is the
    fixpoint of periodic blocks;
  - the last column's sort, stable by rank[(j+1) mod n], is a keys-only sort
    of the unique keys (rank[(j+1) mod n] << 20) | j.
"""
from __future__ import annotations

import torch

from .bitonic import MAX_LOG2, bitonic_1op, bitonic_2op

INT64_MAX = torch.iinfo(torch.int64).max
POS_MASK = (1 << MAX_LOG2) - 1


def padded_length(n: int) -> int:
    """P: the next power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def _pad(keys: torch.Tensor, P: int) -> torch.Tensor:
    out = torch.full((P,), INT64_MAX, dtype=torch.int64, device=keys.device)
    out[: keys.shape[0]] = keys
    return out


def _shifted(r: torch.Tensor, k: int) -> torch.Tensor:
    n = r.shape[0]
    return r[(torch.arange(n, device=r.device) + k) % n]


def seed_rank(block: torch.Tensor) -> torch.Tensor:
    """int64 rank of each rotation's first three bytes (24 bits)."""
    d0 = block.to(torch.int64)
    return (d0 << 16) | (_shifted(d0, 1) << 8) | _shifted(d0, 2)


def round_keys(rank: torch.Tensor, k: int) -> torch.Tensor:
    """A doubling round's sort keys, padded to P with INT64_MAX: int64[P]."""
    return _pad((rank << 32) | _shifted(rank, k), padded_length(rank.shape[0]))


def bwt_forward(data: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """data: uint8[N], first n valid, n <= 2^20. Returns (key, last
    uint8[N]): key is a 0-d int64 tensor on data's device."""
    N = data.shape[0]
    dev = data.device
    last = torch.zeros(N, dtype=torch.uint8, device=dev)
    if n == 0:
        return torch.zeros((), dtype=torch.int64, device=dev), last
    if n > 1 << MAX_LOG2:
        raise ValueError(f"bwt_forward takes n <= 2^{MAX_LOG2}, got {n}")
    block = data[:n]
    positions = torch.arange(padded_length(n), dtype=torch.int32, device=dev)
    rank = seed_rank(block)
    k = 3
    prev_distinct = -1
    while True:
        skey, order = bitonic_2op(round_keys(rank, k), positions)
        skey = skey[:n]
        new_sorted = torch.zeros(n, dtype=torch.int64, device=dev)
        torch.cumsum(skey[1:] != skey[:-1], 0, out=new_sorted[1:])
        distinct = int(new_sorted[-1]) + 1
        if distinct == prev_distinct:
            break  # fixpoint: rank already encodes this partition
        rank = torch.empty_like(rank)
        rank[order[:n].long()] = new_sorted
        if distinct == n:
            break
        prev_distinct = distinct
        k *= 2
    # ties left in rank are classes of identical rotations (periodic blocks):
    # they share their last byte, so an order by the next rotation's rank,
    # ties in j order, gives the true last column. rank is dense (< n <=
    # 2^20), so (rank << 20) | j is unique and orders exactly so.
    key = (rank < rank[0]).sum()
    j = torch.arange(n, dtype=torch.int64, device=dev)
    col = bitonic_1op(_pad((_shifted(rank, 1) << MAX_LOG2) | j, padded_length(n)))
    last[:n] = block[col[:n] & POS_MASK]
    return key, last

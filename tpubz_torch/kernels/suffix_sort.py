"""Rotation suffix sort (BWT forward) by prefix doubling, on the bitonic sort.

The counterpart of ``tpubz/kernels/suffix_sort.py:bwt_forward``, with the
same contract: ``key`` is the number of rotations strictly smaller than
rotation 0, ``last[:n]`` is the BWT last column (periodic inputs included)
and the pad lanes are zero. The JAX package runs this outside any Pallas
kernel, as XLA sorts.

For a CUDA tensor ``bwt_forward`` is one call into the kernel library
(``csrc/bwt.cu``): it enqueues the seed keys, every doubling round (key
build, the bitonic sort of ``csrc/bitonic.cu``, re-rank), the stop test and
the last column on the current stream, with no torch op and no Python
between the kernels; the host follows the class counts one round behind the
card through a pinned word. For a CPU tensor it runs the plain torch version
``bwt_forward_ref``, whose sorts are the plain bitonic network, over the
first n lanes padded to P, the next power of two.

Differences from the TPU formulation, which avoided gathers and scatters
(both versions):
  - 2-ary doubling on one packed int64 key per round, (rank[i] << 32) |
    rank[(i+k) mod n], instead of a 4-key variadic sort. The seed rank packs
    three bytes (24 bits) and later ranks are dense (< n < 2^20), so the key
    fits 56 bits and the pad key INT64_MAX sorts after every real one. The
    payload is the position; the sort is not stable, which the round does
    not need: equal keys get equal new ranks whatever their order;
  - the mod-n shift is a gather at (i+k) % n and no pad rank is needed;
  - the rank write-back to position order is a scatter ``rank[order] = ...``;
  - the stop test follows the class count round by round: stop when every
    rotation is its own class, or when a round leaves the count (and so the
    partition, since classes only split) unchanged, which is the fixpoint of
    periodic blocks. The plain version reads the count to the host each
    round; the kernels keep it in a device record and never wait for the
    host;
  - the last column: when every rotation is its own class, rank is a
    permutation and last[rank[(j+1) mod n]] = block[j] is one scatter (the
    kernels); with ties, and always in the plain version, a keys-only sort
    of the unique keys (rank[(j+1) mod n] << 20) | j, stable by
    rank[(j+1) mod n].
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, bitonic
from .bitonic import MAX_LOG2, bitonic_1op, bitonic_2op

INT64_MAX = torch.iinfo(torch.int64).max
POS_MASK = (1 << MAX_LOG2) - 1

# calls into the kernel library's BWT in this process, one per block (CPU
# calls are not counted), and the doubling rounds those calls ran
LAUNCHES = 0
ROUNDS_RUN = 0
# the same calls' kernel launches outside the sorts (three a round enqueued,
# one or two for the last column)
KERNEL_LAUNCHES = 0
# the host's microseconds inside those calls: enqueueing rounds, waiting for
# a round's event (asleep, so the thread's core is free for the emit threads
# and the hybrid's CPU workers), in all
HOST_US = {"enqueue": 0, "wait": 0, "call": 0}
_launch_lock = threading.Lock()


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


def call_sizes(n: int) -> tuple[int, int, int]:
    """(scratch bytes, pinned int32 words, round cap) of the library call
    for a block of n bytes: csrc/bwt.cu alone knows its scratch's layout.
    The cap is one more than the most doubling rounds the block can run."""
    sizes = (ctypes.c_int * 3)()
    _build.load().tpubz_bwt_sizes(n, sizes)
    return tuple(sizes)


def bwt_forward_ref(data: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``bwt_forward``, on data's device."""
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


def bwt_forward(data: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """data: uint8[N], first n valid, n <= 2^20. Returns (key, last
    uint8[N]): key is a 0-d int64 tensor on data's device. A CUDA tensor
    makes one call into the kernel library on the current stream or raises;
    a CPU tensor runs the plain version. The call returns once the last
    column is enqueued: it reads each round's class count, never ``key`` or
    ``last``."""
    global LAUNCHES, ROUNDS_RUN, KERNEL_LAUNCHES
    dev = data.device
    if dev.type == "cpu":
        return bwt_forward_ref(data, n)
    if dev.type != "cuda":
        raise ValueError(f"bwt_forward: unsupported device {dev}")
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise TypeError("bwt_forward takes a contiguous 1-D uint8 tensor")
    N = data.shape[0]
    if not 0 <= n <= N:
        raise ValueError(f"n={n} outside [0, {N}]")
    if n > 1 << MAX_LOG2:
        raise ValueError(f"bwt_forward takes n <= 2^{MAX_LOG2}, got {n}")
    if n == 0:
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.zeros(N, dtype=torch.uint8, device=dev))
    # one set of buffers per call: encoders are shared between threads
    nbytes, words, cap = call_sizes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    pinned = torch.empty(words, dtype=torch.int32, pin_memory=True)
    key = torch.empty((), dtype=torch.int64, device=dev)
    last = torch.empty(N, dtype=torch.uint8, device=dev)
    plan, plan_len = bitonic._sort_plan(padded_length(n).bit_length() - 1, bitonic.TILE_LOG2,
                                        bitonic.REGS_LOG2, bitonic.FUSE)
    stats = (ctypes.c_int * 7)()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_bwt_forward(data.data_ptr(), n, N, scratch.data_ptr(), nbytes,
                                   pinned.data_ptr(), plan, plan_len, key.data_ptr(),
                                   last.data_ptr(), stats, stream)
    if rc == -1:
        raise RuntimeError(f"tpubz_bwt_forward: no fixpoint after {cap} rounds, n={n}")
    if rc != 0:
        raise RuntimeError(f"tpubz_bwt_forward launch failed: CUDA error {rc}")
    rounds, tied_sorts, pass_launches, own_launches, *host_us = stats
    bitonic.count_sorts(rounds, tied_sorts, pass_launches)
    with _launch_lock:
        LAUNCHES += 1
        ROUNDS_RUN += rounds
        KERNEL_LAUNCHES += own_launches
        for name, us in zip(HOST_US, host_us):
            HOST_US[name] += us
    return key, last

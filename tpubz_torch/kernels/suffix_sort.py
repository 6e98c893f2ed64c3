"""Rotation suffix sort (BWT forward) by prefix doubling that drops sorted
rotations, on the radix sort.

The counterpart of ``tpubz/kernels/suffix_sort.py:bwt_forward``, with the
same contract: ``key`` is the number of rotations strictly smaller than
rotation 0, ``last[:n]`` is the BWT last column (periodic inputs included)
and the pad lanes are zero. Only those outputs are held to tpubz; the
algorithm inside is this card's. The JAX package runs its version outside
any Pallas kernel, as XLA sorts.

For a CUDA tensor ``bwt_forward`` is one call into the kernel library
(``csrc/bwt.cu``): it enqueues every doubling round (keys and their digit
histogram, the radix passes of ``csrc/radix.cuh``, the re-rank and the
compaction of the next round's rotations), the stop test and the last
column on the current stream, with no torch op and no Python between the
kernels; the host follows each round's state one round behind the card
through pinned words. For a CPU tensor it runs the plain torch version
``bwt_forward_ref``, the same formulation on ``radix.radix_sort_ref``.

``bwt_forward_batch`` is the counterpart of tpubz's batched BWT, its
``lax.map`` of ``bwt_forward(..., skip_converged="batch")`` over block rows
(``tpubz/dist/sharded.py:61-64``): row b of its result is ``bwt_forward``
of row b. For a CUDA tensor it is one library call for up to 32 rows
(``csrc/bwt.cu:tpubz_bwt_forward_batch``): every row keeps its own state,
the card runs each round's kernels over the rows still refining, and a row
of one byte (the multi-process path's pad rows) takes no round. Its plain
version ``bwt_forward_batch_ref`` runs ``bwt_forward_ref`` row by row.

The formulation (both versions):
  - ranks are group starts: rank[i] is the number of rotations in classes
    strictly smaller than i's class, so a rotation alone in its class holds
    its final position and no later round changes it. sa[slot] holds the
    positions in slot order; a class of size s keeps the slots [g, g + s);
  - round 0 sorts all n rotations by their first SEED_BYTES cyclic bytes,
    key (bytes << 20) | i. Round r >= 1, with h = SEED_BYTES * 2^(r-1) mod n,
    sorts only the active rotations, the members of classes of size >= 2,
    by key rank[i] << 40 | rank[(i + h) mod n] << 20 | i. Bits 20-59 are
    sorted; the position rides in bits 0-19 (n <= 2^20), so there is no
    payload, and the sort need not be stable for the round's sake;
  - the re-rank reads the sorted active keys: a head is a key whose bits
    20-59 differ from the key before it. Key q's slot is its class's g plus
    q's offset within the class; its new rank is its head's slot. rank[i]
    and sa[slot] are written, and the members of new classes of size >= 2
    are compacted, in sorted order, into the next round's active list;
  - the call stops after a round that leaves no active rotation, or after a
    round in which no active class split: then the partition at 2h equals
    the one at h, a fixpoint that periodic blocks reach, and each class left
    is a set of identical rotations;
  - the last column is one gather, last[p] = block[(sa[p] + n - 1) mod n]:
    identical rotations share their last byte, so any order inside a class
    gives the same column; key = rank[0], the group start of rotation 0.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build, radix
from .radix import radix_sort_ref

MAX_LOG2 = 20
POS_MASK = (1 << MAX_LOG2) - 1
SEED_BYTES = 5
KEY_LO, KEY_HI = MAX_LOG2, 3 * MAX_LOG2  # the sorted bits of a round's key

# calls into the kernel library's BWT in this process, one per block (CPU
# calls are not counted), the doubling rounds those calls ran and the
# active rotations they sorted (the sum over rounds of each round's count)
LAUNCHES = 0
ROUNDS_RUN = 0
ACTIVE_SORTED = 0
# the same calls' launches of csrc/bwt.cu's own kernels (three a round
# enqueued, the last column once); the radix passes are counted in
# radix.PASS_LAUNCHES
KERNEL_LAUNCHES = 0
# the host's microseconds inside those calls: enqueueing rounds, waiting for
# a round's event (asleep, so the thread's core is free for the emit threads
# and the hybrid's CPU workers), in all
HOST_US = {"enqueue": 0, "wait": 0, "call": 0}
# calls of bwt_forward_batch into the kernel library, one per call of up to
# MAX_ROWS rows (CPU calls are not counted); their rounds (summed over the
# rows), active rotations and kernel launches add to the counts above
BATCH_LAUNCHES = 0
MAX_ROWS = 32  # rows a batched library call takes (csrc/radix.cuh: kMaxRows)
_launch_lock = threading.Lock()


def seed_keys(block: torch.Tensor) -> torch.Tensor:
    """Round 0's keys, (the SEED_BYTES cyclic bytes at i) << 20 | i: int64[n]."""
    n = block.shape[0]
    b = block.to(torch.int64)
    i = torch.arange(n, device=block.device)
    packed = torch.zeros(n, dtype=torch.int64, device=block.device)
    for q in range(SEED_BYTES):
        packed = (packed << 8) | b[(i + q) % n]
    return (packed << MAX_LOG2) | i


def _rerank(skeys: torch.Tensor, r: int, rank: torch.Tensor, sa: torch.Tensor):
    """Round r's re-rank of its sorted active keys into rank and sa. Returns
    the next round's active positions and whether an active class split."""
    m = skeys.shape[0]
    q = torch.arange(m, device=skeys.device)
    pos = skeys & POS_MASK
    hi = skeys >> KEY_LO
    g = skeys >> (2 * MAX_LOG2) if r else torch.zeros_like(skeys)
    head = torch.ones(m, dtype=torch.bool, device=skeys.device)
    head[1:] = hi[1:] != hi[:-1]
    gstart = torch.ones_like(head)
    gstart[1:] = g[1:] != g[:-1]
    first = torch.cummax(torch.where(gstart, q, 0), 0).values  # the class's first index
    headq = torch.cummax(torch.where(head, q, 0), 0).values
    rank[pos] = g + headq - first
    sa[g + q - first] = pos
    alone = head.clone()
    alone[:-1] &= head[1:]
    return pos[~alone], int(head.sum()) > int(gstart.sum())


def _doubling(block: torch.Tensor):
    """The plain version's rounds: yields (r, keys, rank, sa) after each
    round's re-rank, until the stop rule holds."""
    n = block.shape[0]
    rank = torch.zeros(n, dtype=torch.int64, device=block.device)
    sa = torch.zeros(n, dtype=torch.int64, device=block.device)
    r = 0
    while True:
        if r == 0:
            keys = seed_keys(block)
        else:
            h = (SEED_BYTES << (r - 1)) % n
            keys = (rank[act] << (2 * MAX_LOG2)) | (rank[(act + h) % n] << MAX_LOG2) | act
        act, split = _rerank(radix_sort_ref(keys, KEY_LO, KEY_HI, radix.DIGIT_BITS), r, rank, sa)
        yield r, keys, rank, sa
        if act.numel() == 0 or not split:
            return
        r += 1


def round_keys(block: torch.Tensor, r: int) -> torch.Tensor:
    """The unsorted keys of round r of a block's BWT (the plain version's,
    on the block's device): int64[active rotations of round r]."""
    for rr, keys, _, _ in _doubling(block):
        if rr == r:
            return keys
    raise ValueError(f"the block's BWT stops before round {r}")


def round_cap(n: int) -> int:
    """One more than the most doubling rounds a block of n bytes can run:
    round r compares SEED_BYTES * 2^r bytes, and once that covers n the
    next round leaves no rotation or splits no class."""
    c = 0
    while SEED_BYTES << c < n:
        c += 1
    return c + 2


def call_sizes(n: int) -> tuple[int, int, int, int]:
    """(scratch bytes, pinned int32 words, round cap, radix passes a round)
    of the library call for a block of n bytes: csrc/bwt.cu alone knows its
    scratch's layout and its sort's digits."""
    sizes = (ctypes.c_int * 4)()
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
    for _, _, rank, sa in _doubling(block):
        pass
    last[:n] = block[(sa + n - 1) % n]
    return rank[0].clone(), last


def bwt_forward(data: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """data: uint8[N], first n valid, n <= 2^20. Returns (key, last
    uint8[N]): key is a 0-d int64 tensor on data's device. A CUDA tensor
    makes one call into the kernel library on the current stream or raises;
    a CPU tensor runs the plain version. The call returns once the last
    column is enqueued: it reads each round's state, never ``key`` or
    ``last``."""
    global LAUNCHES, ROUNDS_RUN, ACTIVE_SORTED, KERNEL_LAUNCHES
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
    nbytes, words, cap, _ = call_sizes(n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    pinned = torch.empty(words, dtype=torch.int32, pin_memory=True)
    key = torch.empty((), dtype=torch.int64, device=dev)
    last = torch.empty(N, dtype=torch.uint8, device=dev)
    stats = (ctypes.c_int * 7)()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_bwt_forward(data.data_ptr(), n, N, scratch.data_ptr(), nbytes,
                                   pinned.data_ptr(), key.data_ptr(), last.data_ptr(), stats,
                                   stream)
    if rc == -1:
        raise RuntimeError(f"tpubz_bwt_forward: no fixpoint after {cap} rounds, n={n}")
    if rc != 0:
        raise RuntimeError(f"tpubz_bwt_forward launch failed: CUDA error {rc}")
    rounds, own_launches, pass_launches, active, *host_us = stats
    radix.count_sorts(rounds, pass_launches)
    with _launch_lock:
        LAUNCHES += 1
        ROUNDS_RUN += rounds
        ACTIVE_SORTED += active
        KERNEL_LAUNCHES += own_launches
        for name, us in zip(HOST_US, host_us):
            HOST_US[name] += us
    return key, last


def _check_batch(data: torch.Tensor, n) -> list[int]:
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise TypeError("bwt_forward_batch takes a contiguous 2-D uint8 tensor")
    B, N = data.shape
    n = [int(x) for x in n]
    if len(n) != B:
        raise ValueError(f"{len(n)} lengths for {B} rows")
    for x in n:
        if not 0 <= x <= N:
            raise ValueError(f"n={x} outside [0, {N}]")
        if x > 1 << MAX_LOG2:
            raise ValueError(f"bwt_forward_batch takes n <= 2^{MAX_LOG2}, got {x}")
    return n


def bwt_forward_batch_ref(data: torch.Tensor, n) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of ``bwt_forward_batch``: ``bwt_forward_ref`` row
    by row, on data's device."""
    n = _check_batch(data, n)
    B, N = data.shape
    keys = torch.zeros(B, dtype=torch.int64, device=data.device)
    last = torch.zeros(B, N, dtype=torch.uint8, device=data.device)
    for b, nb in enumerate(n):
        keys[b], last[b] = bwt_forward_ref(data[b], nb)
    return keys, last


def bwt_forward_batch(data: torch.Tensor, n) -> tuple[torch.Tensor, torch.Tensor]:
    """data: uint8[B, N], row b's first n[b] bytes valid (n: B host ints,
    each <= 2^20). Returns (keys int64[B], last uint8[B, N]), row b equal to
    ``bwt_forward(data[b], n[b])``. A CUDA tensor makes one library call per
    MAX_ROWS rows on the current stream or raises (no fixpoint names its
    row); a CPU tensor runs the plain version."""
    global BATCH_LAUNCHES, ROUNDS_RUN, ACTIVE_SORTED, KERNEL_LAUNCHES
    dev = data.device
    if dev.type == "cpu":
        return bwt_forward_batch_ref(data, n)
    if dev.type != "cuda":
        raise ValueError(f"bwt_forward_batch: unsupported device {dev}")
    n = _check_batch(data, n)
    B, N = data.shape
    keys = torch.empty(B, dtype=torch.int64, device=dev)
    last = torch.empty(B, N, dtype=torch.uint8, device=dev)
    lib = _build.load()
    for r0 in range(0, B, MAX_ROWS):
        rows = n[r0:r0 + MAX_ROWS]
        ns = (ctypes.c_int * len(rows))(*rows)
        sizes = (ctypes.c_longlong * 3)()
        lib.tpubz_bwt_batch_sizes(ns, len(rows), sizes)
        if sizes[2] != MAX_ROWS:
            raise RuntimeError(f"the library takes {sizes[2]} rows a call, not {MAX_ROWS}")
        scratch = torch.empty(sizes[0], dtype=torch.uint8, device=dev)
        pinned = torch.empty(sizes[1], dtype=torch.int32, pin_memory=True)
        stats = (ctypes.c_int * 8)()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.tpubz_bwt_forward_batch(data[r0].data_ptr(), ns, len(rows), N,
                                             scratch.data_ptr(), sizes[0], pinned.data_ptr(),
                                             keys[r0:].data_ptr(), last[r0].data_ptr(), stats,
                                             stream)
        if rc == -1:
            b = r0 + stats[7]
            raise RuntimeError(f"tpubz_bwt_forward_batch: row {b} (n={n[b]}) reached no "
                               f"fixpoint after {round_cap(n[b])} rounds")
        if rc != 0:
            raise RuntimeError(f"tpubz_bwt_forward_batch launch failed: CUDA error {rc}")
        rounds, own_launches, pass_launches, active, *host_us, _ = stats
        radix.count_sorts(rounds, pass_launches)
        with _launch_lock:
            BATCH_LAUNCHES += 1
            ROUNDS_RUN += rounds
            ACTIVE_SORTED += active
            KERNEL_LAUNCHES += own_launches
            for name, us in zip(HOST_US, host_us):
                HOST_US[name] += us
    return keys, last

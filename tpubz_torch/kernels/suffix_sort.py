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
histogram, the radix passes of ``csrc/radix.cuh`` over the members of large
classes, the shared-memory sort of the small classes, the re-rank and the
compaction of the next round's rotations), the stop test and the last
column on the current stream, with no torch op and no Python between the
kernels. The rounds run on the card, as one CUDA graph whose conditional
loop the card itself ends, so the call makes no host wait per round. It
returns once the last column is enqueued; the call's record (rounds,
active rotations, the launches the card ran, the cap error) lives in
pinned words that the card writes, read when the caller next waits on the
stream: ``BwtCall.finish``. ``bwt_forward`` finishes its call before it
returns; ``bwt_forward_async`` hands the call to its caller (the device
encoder's fetch finishes it after its own event). The call's scratch and
pinned words live on the ``BwtCall`` until it is finished, since the card
may still write them after the wrapper returns. For a CPU tensor it runs the
plain torch version ``bwt_forward_ref``, the same formulation on
``radix.radix_sort_ref``.

``bwt_forward_batch`` is the counterpart of tpubz's batched BWT, its
``lax.map`` of ``bwt_forward(..., skip_converged="batch")`` over block rows
(``tpubz/dist/sharded.py:61-64``): row b of its result is ``bwt_forward``
of row b. For a CUDA tensor it is one library call for up to 32 rows
(``csrc/bwt.cu:tpubz_bwt_forward_batch``, the call the one-block form makes
with one row): every row keeps its own state, each round's kernels leave
at once for the rows that stopped, and a row of one byte (the
multi-process path's pad rows) takes no round. Its plain version
``bwt_forward_batch_ref`` runs ``bwt_forward_ref`` row by row.

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
import functools
import threading
import time

import torch

from . import _build, radix
from .radix import radix_sort_ref

MAX_LOG2 = 20
POS_MASK = (1 << MAX_LOG2) - 1
SEED_BYTES = 5
KEY_LO, KEY_HI = MAX_LOG2, 3 * MAX_LOG2  # the sorted bits of a round's key

# calls into the kernel library's BWT in this process, one per block (CPU
# calls are not counted), counted once the call is enqueued; the doubling
# rounds those calls ran and the active rotations they sorted (the sum over
# rounds of each round's count), read from the card's record when the call
# is finished (``BwtCall.finish``)
LAUNCHES = 0
ROUNDS_RUN = 0
ACTIVE_SORTED = 0
# the same calls' launches of csrc/bwt.cu's own kernels. A graph's launch
# counts the body kernels that the card ran, each counted on the card by
# its CTA (0, 0) into the record (one launch a loop iteration each, over
# every row of the call: bwt_keys, bwt_small_sort, bwt_rank_tiles,
# bwt_rank_scan, bwt_rank_apply, bwt_round_end), plus the setup and the
# last column, counted on the host once enqueued; the body's radix passes
# (bwt_pass, five launches an iteration) are counted in radix.PASS_LAUNCHES
# and the rounds whose large list was sorted in radix.SORTS, also from the
# card's record
KERNEL_LAUNCHES = 0
# radix passes that moved keys, and those the card skipped because one
# digit held every key (passes over an empty large list are neither)
PASSES_RUN = 0
PASSES_SKIPPED = 0
# the host's microseconds in those calls: enqueueing (the memsets, the
# setup, the graph and the last column), building graphs (the first call of
# a stream and shape), inside the library call in all, and waiting for a
# call's event in finish() (bwt_forward and bwt_forward_batch wait once a
# call; the device encoder's calls are finished at their fetch, whose own
# wait is not counted here)
HOST_US = {"enqueue": 0, "graph": 0, "call": 0, "wait": 0}
# calls of bwt_forward_batch into the kernel library, one per call of up to
# MAX_ROWS rows (CPU calls are not counted); their rounds (summed over the
# rows), active rotations and kernel launches add to the counts above
BATCH_LAUNCHES = 0
MAX_ROWS = 32  # rows a batched library call takes (csrc/bwt.cu: kMaxRows)
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


@functools.lru_cache(maxsize=64)
def _sizes(n: int) -> tuple:
    sizes = (ctypes.c_int * 8)()
    _build.load().tpubz_bwt_sizes(n, sizes)
    return tuple(sizes)


def call_sizes(n: int) -> tuple[int, int, int, int]:
    """(scratch bytes, pinned int32 words, round cap, radix passes a round)
    of the library call for a block of n bytes: csrc/bwt.cu alone knows its
    scratch's layout and its sort's digits."""
    return _sizes(n)[:4]


# a row's record: rounds, active rotations sorted, passes skipped, the cap
# error, sorts (rounds whose large list was not empty), passes run, the
# launches of each body kernel (row 0's; 0 in the other rows), then the low
# 32 bits of the card's %globaltimer (ns) at the start of bwt_setup and at
# the end of the row's bwt_last_column CTA 0
BODY = ("bwt_keys", "bwt_pass", "bwt_small_sort", "bwt_rank_tiles", "bwt_rank_scan",
        "bwt_rank_apply", "bwt_round_end")
TIMER = ("timer_setup", "timer_end")
RECORD = ("rounds", "active", "skipped", "error", "sorts", "passes_run") + BODY + TIMER


def record_sizes() -> tuple[int, int]:
    """(a row's record words before its rounds' words, words a round) of
    the library's pinned record; its record words are RECORD's."""
    head, per_round = _sizes(1)[4:6]
    if head != len(RECORD):
        raise RuntimeError(f"the library's record has {head} words, not {len(RECORD)}")
    return head, per_round


def launch_sizes() -> tuple[int, int]:
    """(csrc/bwt.cu's kernels a round, its kernels a call around the rounds):
    a one-block call of r rounds adds r * the first + the second to
    KERNEL_LAUNCHES, and r * call_sizes(n)[3] to radix.PASS_LAUNCHES."""
    return _sizes(1)[6:8]


class BwtCall:
    """One library call in flight on a stream: its scratch and pinned words
    (kept alive until the stream has passed the call, since the card writes
    them after the wrapper returns), the event recorded after it, and the
    host's part of its counts. ``finish()`` waits for the event, reads the
    record the card left in the pinned words, adds the call to the module's
    counts and raises if a row reached its round cap short of the stop rule
    (which no input can cause); it runs once, whoever calls it. A call
    dropped unfinished waits for its event before its buffers go. After
    ``finish()``, ``device_ns`` is the call's time on the card, from the
    start of its setup launch to the end of row 0's last column, by the
    card's own clock (None for a call that ran no round)."""

    def __init__(self, n, scratch, pinned, stats, event):
        self.n = n  # the rows' lengths
        self._keep = (scratch, pinned)
        self.stats = tuple(stats)
        self.event = event
        self.rows = None  # after finish: per row, its record (RECORD's names) and per-round words
        self.device_ns = None
        self._lock = threading.Lock()
        self._error = None

    def done(self) -> bool:
        """Whether the stream has passed the call."""
        return self.rows is not None or self.event.query()

    def __del__(self):
        if getattr(self, "_keep", None) is not None:
            self.event.synchronize()

    def finish(self):
        global ROUNDS_RUN, ACTIVE_SORTED, KERNEL_LAUNCHES, PASSES_RUN, PASSES_SKIPPED
        with self._lock:
            if self.rows is None:
                waited = 0
                if not self.event.query():  # the stream has not passed the call yet
                    t = time.perf_counter()
                    self.event.synchronize()
                    waited = int((time.perf_counter() - t) * 1e6)
                own_outside, ran, enqueue_us, graph_us, call_us = self.stats
                head, per_round = record_sizes()
                words = self._keep[1].numpy().reshape(len(self.n), -1)
                rows = []
                for b in range(len(self.n)):
                    record = dict(zip(RECORD, (int(x) for x in words[b, :head]) if ran
                                      else [0] * len(RECORD)))
                    rounds = record["rounds"]
                    record["words"] = words[b, head:head + per_round * rounds].reshape(
                        rounds, per_round).copy()
                    rows.append(record)
                    if record["error"] and self._error is None:
                        self._error = (b, rounds)
                self.rows = rows
                self._keep = None
                if ran:
                    # the timer's low words: exact for a call shorter than 2^32 ns
                    self.device_ns = (rows[0]["timer_end"] - rows[0]["timer_setup"]) & 0xFFFFFFFF
                body = {k: sum(r[k] for r in rows) for k in BODY}
                radix.count_sorts(sum(r["sorts"] for r in rows), body["bwt_pass"])
                with _launch_lock:
                    ROUNDS_RUN += sum(r["rounds"] for r in rows)
                    ACTIVE_SORTED += sum(r["active"] for r in rows)
                    PASSES_RUN += sum(r["passes_run"] for r in rows)
                    PASSES_SKIPPED += sum(r["skipped"] for r in rows)
                    KERNEL_LAUNCHES += sum(body.values()) - body["bwt_pass"] + own_outside
                    for name, us in (("enqueue", enqueue_us), ("graph", graph_us),
                                     ("call", call_us), ("wait", waited)):
                        HOST_US[name] += us
        if self._error is not None:
            b, rounds = self._error
            raise RuntimeError(f"tpubz_bwt_forward: row {b} (n={self.n[b]}) reached no fixpoint "
                               f"after {rounds} rounds")
        return self


def _launch(data: torch.Tensor, n: list, N: int, batch: bool, cap,
            key: torch.Tensor, last: torch.Tensor) -> BwtCall:
    """One library call for len(n) rows of data (row b at data + b * N) on
    the current stream, counted once enqueued."""
    global LAUNCHES, BATCH_LAUNCHES
    dev = data.device
    lib = _build.load()
    ns = (ctypes.c_int * len(n))(*n)
    sizes = (ctypes.c_longlong * 3)()
    lib.tpubz_bwt_batch_sizes(ns, len(n), sizes)
    if sizes[2] != MAX_ROWS:
        raise RuntimeError(f"the library takes {sizes[2]} rows a call, not {MAX_ROWS}")
    scratch = torch.empty(sizes[0], dtype=torch.uint8, device=dev)
    pinned = torch.empty(sizes[1], dtype=torch.int32, pin_memory=True)
    stats = (ctypes.c_int * 5)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = lib.tpubz_bwt_forward_batch(data.data_ptr(), ns, len(n), N, 2 if batch else 1,
                                         cap or 0, scratch.data_ptr(), sizes[0], pinned.data_ptr(),
                                         key.data_ptr(), last.data_ptr(), stats, stream.cuda_stream)
        if rc != 0:
            stream.synchronize()  # the card may have been writing the buffers
            raise RuntimeError(f"tpubz_bwt_forward_batch launch failed: CUDA error {rc}")
        event = torch.cuda.Event()
        event.record(stream)
    with _launch_lock:
        if batch:
            BATCH_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return BwtCall(n, scratch, pinned, stats, event)


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


def bwt_forward_async(data: torch.Tensor, n: int, cap: int | None = None):
    """``bwt_forward`` without waiting: (key, last, call), the call a
    ``BwtCall`` in flight (None on the CPU), which the caller finishes once
    it waits on the stream anyway. cap: a round cap below the block's own,
    to test the cap error."""
    dev = data.device
    if dev.type == "cpu":
        return (*bwt_forward_ref(data, n), None)
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
                torch.zeros(N, dtype=torch.uint8, device=dev), None)
    # one set of buffers per call: encoders are shared between threads
    key = torch.empty((), dtype=torch.int64, device=dev)
    last = torch.empty(N, dtype=torch.uint8, device=dev)
    return key, last, _launch(data, [n], N, False, cap, key, last)


def bwt_forward(data: torch.Tensor, n: int, cap: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """data: uint8[N], first n valid, n <= 2^20. Returns (key, last
    uint8[N]): key is a 0-d int64 tensor on data's device. A CUDA tensor
    makes one call into the kernel library on the current stream or raises;
    a CPU tensor runs the plain version. The rounds run on the card with no
    host wait among them; the call is finished (its record read, its counts
    added) before this returns. cap: as ``bwt_forward_async``."""
    key, last, call = bwt_forward_async(data, n, cap)
    if call is not None:
        call.finish()
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


def bwt_forward_batch(data: torch.Tensor, n, cap: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """data: uint8[B, N], row b's first n[b] bytes valid (n: B host ints,
    each <= 2^20). Returns (keys int64[B], last uint8[B, N]), row b equal to
    ``bwt_forward(data[b], n[b])``. A CUDA tensor makes one library call per
    MAX_ROWS rows on the current stream, each finished before this returns,
    or raises (no fixpoint names its row); a CPU tensor runs the plain
    version. cap: as ``bwt_forward_async``, for every row."""
    dev = data.device
    if dev.type == "cpu":
        return bwt_forward_batch_ref(data, n)
    if dev.type != "cuda":
        raise ValueError(f"bwt_forward_batch: unsupported device {dev}")
    n = _check_batch(data, n)
    B, N = data.shape
    keys = torch.empty(B, dtype=torch.int64, device=dev)
    last = torch.empty(B, N, dtype=torch.uint8, device=dev)
    calls = [_launch(data[r0], n[r0:r0 + MAX_ROWS], N, True, cap, keys[r0:], last[r0])
             for r0 in range(0, B, MAX_ROWS)]
    for r0, call in zip(range(0, B, MAX_ROWS), calls):
        try:
            call.finish()
        except RuntimeError as e:
            raise RuntimeError(f"tpubz_bwt_forward_batch: rows from {r0}: {e}") from None
    return keys, last

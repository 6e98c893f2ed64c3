"""The inverse BWT on a torch device: next pointers and the key's orbit.

The counterpart of ``tpubz/kernels/ibwt.py``. ``next_pointers`` is
``_next_pointers``: the stable (byte, position) order of the last column,
the lanes at or past n counting as byte 256, so that ``nxt[n:]`` is
``arange(n, N)``. ``bwt_inverse_device`` is tpubz's function, out[i] =
last[jump^(i+1)(key)] with jump = nxt; tpubz builds the orbit in ceil(log2 n)
pointer-doubling steps because a TPU has no fast random gather. As in
tpubz, no decode route takes it: the decoder is the native engine's chase
(``native/decode.cpp``).

For a CUDA tensor each is one call into ``csrc/ibwt.cu``: the next pointers
by a counting sort (the keys and their byte histogram in one launch, one
onesweep 8-bit pass of ``csrc/radix.cuh``, the pointers read off the sorted
keys), and the inverse by list ranking in O(n) on the same sort: splitters
(one row in each window of ``2^LOG_D[0]`` rows, picked by a fixed hash of
the window, and p_0 = nxt[key]) cut the cycles of nxt into segments that
one thread each walks, keeping the segment's first ``KEPT`` bytes; the
segments are ranked the same way two levels up, the last in one CTA's
shared memory by pointer doubling; then each segment of p_0's cycle copies
its bytes to its place, and when the cycle is shorter than n (a periodic
block) the rest repeats it. Seven launches a call, no host wait; the card
counts what the call did into a pinned record (``RECORD``), which
``finish_calls`` reads once the stream has passed the call. For a CPU
tensor they run the plain versions ``next_pointers_ref`` (a counting sort
in torch: a byte's positions in order, byte by byte) and
``bwt_inverse_device_ref`` (tpubz's doubling loop in torch).
"""
from __future__ import annotations

import collections
import ctypes
import threading

import torch

from . import _build

MAX_N = 1 << 20  # a position fits the sort key's 20 bits (csrc/ibwt.cu)
LOG_D = (3, 3, 3)  # log2 of csrc/ibwt.cu's splitter windows: rows, level-1 and level-2 nodes
KEPT = 64  # the bytes of its segment a level-1 walk keeps (csrc/ibwt.cu kBuffered)

# calls whose kernels ran on the card in this process (CPU calls are not
# counted): the next pointers (next_pointers' calls, counted where the
# library reports all NEXT_KERNELS launches, so not for n = 0, and the sort
# of each bwt_inverse_device call of n > 0) and bwt_inverse_device's calls
# of n > 0, counted once enqueued; the orbit's kernels those calls ran, as
# the card counted them, added when a call is finished (``finish_calls``)
NEXT_KERNELS = 3  # csrc/ibwt.cu: the keys and histogram, one 8-bit pass, the pointers
NEXT_LAUNCHES = 0
INVERSE_LAUNCHES = 0
KERNEL_LAUNCHES = 0
# an inverse call's record, counted on the card: the orbit's kernel
# launches (walk_rows, walk_list, rank_top, write_orbit), the level-1 splitters that
# walked, the level-1 segments of p_0's cycle, the longest level-1 walk
# (rows), the cycle's length L, the level-2 splitters that walked, the
# longest level-2 walk (level-1 segments), the top's walks (levels 3 and 4)
RECORD = ("launches", "splitters", "segments", "longest", "orbit", "list_splitters",
          "list_longest", "top_splitters")
_launch_lock = threading.Lock()
_in_flight: collections.deque = collections.deque()  # InverseCall, oldest first
_finished: collections.deque = collections.deque(maxlen=4096)  # records not yet read


def next_pointers_ref(last: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of ``next_pointers``."""
    N = last.shape[0]
    idx = torch.arange(N, dtype=torch.int32, device=last.device)
    sym = torch.where(idx < n, last.to(torch.int32), 256)
    nxt = torch.empty(N, dtype=torch.int32, device=last.device)
    at = 0
    for b in range(257):
        pos = torch.nonzero(sym == b).flatten()  # ascending
        nxt[at: at + pos.numel()] = pos.to(torch.int32)
        at += pos.numel()
    return nxt


def bwt_inverse_device_ref(key: int, last: torch.Tensor, n: int) -> torch.Tensor:
    """Plain torch version of ``bwt_inverse_device``: tpubz's loop."""
    nxt = next_pointers_ref(last, n)
    if n == 0:
        return torch.zeros(0, dtype=torch.uint8, device=last.device)
    positions = torch.empty(n, dtype=torch.int64, device=last.device)
    positions[0] = nxt[key]
    filled = 1
    jump = nxt.to(torch.int64)
    while filled < n:
        take = min(filled, n - filled)
        positions[filled: filled + take] = jump[positions[:take]]
        filled += take
        if filled < n:
            jump = jump[jump]
    return last[positions]


def _check(last: torch.Tensor, n: int) -> None:
    if last.dtype != torch.uint8 or last.dim() != 1:
        raise TypeError("the inverse BWT takes a 1-D uint8 tensor")
    if not 0 <= n <= last.shape[0]:
        raise ValueError(f"n={n} outside [0, {last.shape[0]}]")


def _sizes(lib, n: int, N: int) -> list[int]:
    if n > MAX_N:
        raise ValueError(f"the CUDA kernels take blocks of at most {MAX_N} bytes, got {n}")
    sizes = (ctypes.c_longlong * 7)()
    if lib.tpubz_ibwt_sizes(n, N, sizes) != 0:
        raise ValueError(f"the CUDA kernels do not take n={n} of N={N}")
    return list(sizes)


def sizes(n: int = MAX_N, N: int | None = None) -> dict:
    """The library's sizes for an inverse of n of N bytes: its scratch
    bytes, its record's words, log2 of the splitter windows of the three
    levels (``log_d``) and the orbit's kernels a call (needs the library)."""
    s = _sizes(_build.load(), n, n if N is None else N)
    if s[2] != len(RECORD) or tuple(s[3:6]) != LOG_D:
        raise RuntimeError(f"the library's record has {s[2]} words and windows 2^{s[3:6]}, "
                           f"not {len(RECORD)} and 2^{LOG_D}")
    return {"next_bytes": s[0], "inverse_bytes": s[1], "record_words": s[2],
            "log_d": tuple(s[3:6]), "orbit_kernels": s[6]}


class InverseCall:
    """An inverse call in flight: the pinned words the card writes its
    record into (kept alive until the stream has passed the call) and the
    event after it. ``finish()`` waits for the event, reads the record,
    adds the card's launches to KERNEL_LAUNCHES and returns the record by
    RECORD's names, once."""

    def __init__(self, n: int, pinned: torch.Tensor, event):
        self.n = n
        self.pinned = pinned
        self.event = event
        self.record = None

    def finish(self) -> dict:
        global KERNEL_LAUNCHES
        if self.record is None:
            self.event.synchronize()
            self.record = {"n": self.n, **dict(zip(RECORD, (int(x) for x in self.pinned)))}
            self.pinned = None
            with _launch_lock:
                KERNEL_LAUNCHES += self.record["launches"]
                _finished.append(self.record)
        return self.record


def finish_calls() -> list[dict]:
    """Finish every inverse call in flight (waiting for the card where it
    has not passed them) and return the records of the calls finished since
    the last call of this function, oldest first (at most 4096)."""
    while True:
        with _launch_lock:
            if not _in_flight:
                break
            call = _in_flight.popleft()
        call.finish()
    with _launch_lock:
        out = list(_finished)
        _finished.clear()
    return out


def _reap() -> None:
    """Finish the calls in flight that the card has passed, without waiting."""
    while True:
        with _launch_lock:
            if not _in_flight or not _in_flight[0].event.query():
                return
            call = _in_flight.popleft()
        call.finish()


def next_pointers(last: torch.Tensor, n: int) -> torch.Tensor:
    """last: uint8[N], the first n the BWT's last column.

    Returns nxt int32[N]: nxt[j] is the position of the j-th entry of last
    in (byte, position) order, positions >= n after every byte. A CUDA
    tensor launches the kernels on the current stream or raises; a CPU
    tensor runs the plain version."""
    global NEXT_LAUNCHES
    _check(last, n)
    dev = last.device
    if dev.type == "cpu":
        return next_pointers_ref(last, n)
    if dev.type != "cuda":
        raise ValueError(f"next_pointers: unsupported device {dev}")
    N = last.shape[0]
    lib = _build.load()
    scratch_bytes = _sizes(lib, n, N)[0]
    last = last.contiguous()
    scratch = torch.empty(max(scratch_bytes, 1), dtype=torch.uint8, device=dev)
    nxt = torch.empty(N, dtype=torch.int32, device=dev)
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_next_pointers(last.data_ptr(), n, N, scratch.data_ptr(), scratch_bytes,
                                     nxt.data_ptr(), ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_next_pointers launch failed: CUDA error {rc}")
    with _launch_lock:
        NEXT_LAUNCHES += launched.value >= NEXT_KERNELS
    return nxt


def bwt_inverse_device(key: int, last: torch.Tensor, n: int) -> torch.Tensor:
    """Invert the rotation BWT (key, last[:n]). Returns uint8[n] on last's
    device. A CUDA tensor makes one library call (the next pointers and the
    orbit's kernels, enqueued on the current stream, with no host wait;
    its record is read by ``finish_calls``) or raises; a CPU tensor runs
    the plain version."""
    global NEXT_LAUNCHES, INVERSE_LAUNCHES
    _check(last, n)
    key = int(key)
    if n and not 0 <= key < n:
        raise ValueError(f"key={key} outside [0, {n})")
    dev = last.device
    if dev.type == "cpu":
        return bwt_inverse_device_ref(key, last, n)
    if dev.type != "cuda":
        raise ValueError(f"bwt_inverse_device: unsupported device {dev}")
    N = last.shape[0]
    lib = _build.load()
    s = _sizes(lib, n, N)
    _reap()
    last = last.contiguous()
    scratch = torch.empty(max(s[1], 1), dtype=torch.uint8, device=dev)
    out = torch.empty(n, dtype=torch.uint8, device=dev)
    pinned = torch.empty(s[2], dtype=torch.int32, pin_memory=True)  # the card writes each word
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        rc = lib.tpubz_bwt_inverse(last.data_ptr(), key if n else 0, n, N, scratch.data_ptr(),
                                   s[1], pinned.data_ptr(), out.data_ptr(),
                                   ctypes.byref(launched), stream.cuda_stream)
        if rc != 0:
            stream.synchronize()  # the card may have been writing the buffers
            raise RuntimeError(f"tpubz_bwt_inverse launch failed: CUDA error {rc}")
        event = torch.cuda.Event()
        event.record(stream)
    with _launch_lock:
        NEXT_LAUNCHES += n > 0  # its sort: the walks read the sorted keys
        INVERSE_LAUNCHES += n > 0
        if n > 0:
            _in_flight.append(InverseCall(n, pinned, event))
    return out

"""The look-back scratch of the packing and compact kernels, one a stream.

``csrc/bitpack.cu`` and ``csrc/compact.cu`` find each tile's offset by
decoupled look-back over per-tile status words (``csrc/look_back.cuh``).
They take no memset: the scratch, a ticket word and the status words, is
zeroed once when it is allocated, and each call leaves it ready for the
next one on its stream (the ticket back at 0, every status word either the
call's own, tagged with its epoch, or 0). Here each (device, stream) keeps
one scratch, grown when a call needs more words, with the epoch of its last
call and the words that call may have used (``dirty``, what the next call
zeroes past its own). Calls on one stream run in order on the card, so they
share it; calls on two streams have two.
"""
from __future__ import annotations

import threading

import torch

EPOCH_MAX = (1 << 26) - 1  # csrc/look_back.cuh: kEpochMax
TILE = 4096  # lanes a tile of csrc/bitpack.cu (csrc/compact.cu's: compact.TILE)
SHIFT_MAX = 7  # lanes a 16-byte vector of uint16 may start before the first

# the current stream's handle without building a torch.cuda.Stream; the
# public call where this torch lacks it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


class Scratch:
    """One stream's scratch: int64 words, the ticket in word 0 and
    ``capacity`` status words after it, zeroed once; ``epoch`` of the last
    call (0: none yet) and ``dirty``, the status words it may have used."""

    def __init__(self, device: torch.device, capacity: int):
        self.words = torch.zeros(capacity + 1, dtype=torch.int64, device=device)
        self.capacity = capacity
        self.epoch = 0
        self.dirty = 0


_scratch: dict = {}  # (device index, stream handle) -> Scratch
_lock = threading.Lock()


def status_words(lanes: int, rows: int = 1, tile: int = TILE) -> int:
    """Status words a call of ``rows`` rows of ``lanes`` lanes may use: a
    word a tile of ``tile`` lanes, the tiles starting up to SHIFT_MAX lanes
    early (csrc/bitpack.cu's ``status_words``, csrc/compact.cu's ``tiles``)."""
    return rows * -(-(lanes + SHIFT_MAX) // tile)


def current_stream(device: torch.device) -> tuple[int, int, int]:
    """(the device's index, the current device's index, the device's
    current stream's handle)."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if _raw_stream is not None:
        return index, current, _raw_stream(index)
    return index, current, torch.cuda.current_stream(index).cuda_stream


def enqueue(fn, device: torch.device, words: int, head: tuple, tail: tuple) -> int:
    """Call ``fn(*head, scratch, capacity, epoch, dirty, *tail, stream)`` on
    the current stream of ``device`` with that stream's scratch (allocated,
    or grown, to at least ``words`` status words), the device made current
    for the call only where it is not. Returns fn's code (0: launched)."""
    index, current, stream = current_stream(device)
    with _lock:  # the epoch and the launch in one order
        key = (index, stream)
        sc = _scratch.get(key)
        if sc is None or sc.capacity < words:
            grown = max(words, 256) if sc is None else max(words, 2 * sc.capacity)
            sc = _scratch[key] = Scratch(torch.device("cuda", index), grown)
        epoch = sc.epoch % EPOCH_MAX + 1
        args = (*head, sc.words.data_ptr(), sc.capacity, epoch, sc.dirty, *tail, stream)
        if index == current:
            rc = fn(*args)
        else:
            with torch.cuda.device(index):
                rc = fn(*args)
        if rc == 0:
            sc.epoch, sc.dirty = epoch, words
    return rc


def scratch_of(device: torch.device) -> Scratch | None:
    """The current stream's scratch on ``device``, if a call made one."""
    index, _, stream = current_stream(device)
    with _lock:
        return _scratch.get((index, stream))

"""The device half of the Huffman refinement, and the payload packed on the
device.

The counterpart of ``tpubz/kernels/huffman_dev.py``. Every refinement pass
is one call (``refine_pass``) over the block's symbols: each 50-symbol
group's cheapest table under the pass's code lengths, ties to the lowest
table, and each table's symbol frequencies over the groups that chose it.
tpubz builds a dense histogram hist[nsel, 258] once (``chunk_hist``) and runs
each pass as two MXU products over it; the kernel here reads each group's
symbols once and gathers their lengths instead, so a pass moves the 1.8 MB
of a level-9 block's symbols rather than its 18.6 MB histogram. Only the six
tree builds of a pass run on the host (``native.code_lengths_native``), with
the selectors and the 6 x 258 frequencies crossing the link instead of the
symbol stream; ``RefinePasses`` holds one block's buffers for its passes
(the lengths up and the results back through pinned memory, nothing
allocated a pass). ``pack_payload`` then gathers each symbol's code and
length by its group's selector and packs them MSB-first, so the payload
crosses the link as packed words. tpubz runs its products in float32; here
every sum is an integer sum (at most 50 lengths of at most 20 bits), so the
results are tpubz's exactly. ``chunk_hist`` and ``chunk_hist_batch`` remain,
tpubz's functions with kernels of their own, off the refinement's path.

For CUDA tensors the wrappers launch the hand-written kernels on the
current stream: ``chunk_hist`` and ``chunk_hist_batch`` and ``refine_pass``
those of ``csrc/huffman_dev.cu``, ``pack_payload`` the packing kernel of
``csrc/bitpack.cu`` with the gather fused into its load. For CPU tensors
they run the plain torch versions (``*_ref``), tpubz's formulas in integer
arithmetic. Symbols are the one-block transform's int32 or the batch's
uint16; a length is a device scalar (int64 or int32) or a host int.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..format.constants import GROUP_SIZE, MAX_ALPHA_SIZE, MAX_GROUPS
from . import _build, bitpack

ALPHA_MAX = MAX_ALPHA_SIZE
PAYLOAD_MAX_BITS_PER_SYM = 20  # the format's ceiling; the encoder emits <= 17

# calls into the kernel library in this process, one kernel each (CPU calls
# are not counted)
HIST_LAUNCHES = 0  # chunk_hist
HIST_BATCH_LAUNCHES = 0  # chunk_hist_batch
REFINE_LAUNCHES = 0  # refine_pass
PAYLOAD_LAUNCHES = 0  # pack_payload (also counted in bitpack.LAUNCHES)
_launch_lock = threading.Lock()


def nsel_cap(out_len: int) -> int:
    """Selector groups of a symbol array of ``out_len`` lanes."""
    return (out_len + GROUP_SIZE - 1) // GROUP_SIZE


def payload_words_cap(out_len: int) -> int:
    """Words that hold the payload of ``out_len`` symbols at the format's
    longest code, and one more."""
    return (out_len * PAYLOAD_MAX_BITS_PER_SYM + 31) // 32 + 1


def _length(rle2_len, device, rows: int | None = None) -> torch.Tensor:
    """A stream length (or one a row) as a contiguous int64 or int32 tensor
    on ``device``."""
    t = rle2_len if isinstance(rle2_len, torch.Tensor) and rle2_len.device == device else \
        torch.as_tensor(rle2_len, device=device)
    if t.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"a stream length must be int64 or int32, not {t.dtype}")
    if t.shape != (() if rows is None else (rows,)):
        raise ValueError(f"the stream lengths have shape {tuple(t.shape)}")
    return t.contiguous()


def _symbols(syms: torch.Tensor, dim: int) -> None:
    if syms.dim() != dim or syms.dtype not in (torch.int32, torch.uint16):
        raise TypeError(f"the symbols must be a {dim}-D int32 or uint16 tensor")


def chunk_hist_batch_ref(syms: torch.Tensor, rle2_len) -> torch.Tensor:
    """Plain torch version of ``chunk_hist_batch`` (and, for one row, of
    ``chunk_hist``): tpubz's scatter-add of ones at the flat index."""
    B, out = syms.shape
    dev = syms.device
    nsel = nsel_cap(out)
    lengths = torch.as_tensor(rle2_len, device=dev).reshape(B, 1).to(torch.int64)
    idx = torch.arange(out, dtype=torch.int64, device=dev)[None, :]
    chunk = torch.arange(B, dtype=torch.int64, device=dev)[:, None] * nsel + idx // GROUP_SIZE
    flat = torch.where(idx < lengths, chunk * ALPHA_MAX + syms.to(torch.int64), B * nsel * ALPHA_MAX)
    hist = torch.zeros(B * nsel * ALPHA_MAX + 1, dtype=torch.int32, device=dev)
    hist.index_add_(0, flat.reshape(-1), torch.ones(B * out, dtype=torch.int32, device=dev))
    return hist[:-1].reshape(B, nsel, ALPHA_MAX)


def chunk_hist_ref(syms: torch.Tensor, rle2_len) -> torch.Tensor:
    """Plain torch version of ``chunk_hist``."""
    return chunk_hist_batch_ref(syms[None, :],
                                torch.as_tensor(rle2_len, device=syms.device).reshape(1))[0]


def _hist_launch(syms: torch.Tensor, lengths: torch.Tensor, B: int) -> torch.Tensor:
    out = syms.shape[-1]
    if not 1 <= B <= 65535 or not 1 <= out < 1 << 30:
        raise ValueError(f"chunk_hist takes 1 to 65535 rows of 1 to 2^30 - 1 symbols, got {B}x{out}")
    syms = syms.contiguous()
    dev = syms.device
    hist = torch.empty(B, nsel_cap(out), ALPHA_MAX, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_chunk_hist(syms.data_ptr(), syms.element_size(), lengths.data_ptr(),
                                  lengths.element_size(), B, out, hist.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_chunk_hist launch failed: CUDA error {rc}")
    return hist


def chunk_hist(syms: torch.Tensor, rle2_len) -> torch.Tensor:
    """syms: int32 or uint16 [OUT], the first rle2_len symbols the stream.

    Returns int32[ceil(OUT / 50), 258]: row g counts the symbols of group g
    (positions 50g to 50g + 49 below rle2_len); rows past the stream are 0.
    A CUDA tensor launches the kernel on the current stream or raises; a
    CPU tensor runs the plain version."""
    global HIST_LAUNCHES
    _symbols(syms, 1)
    dev = syms.device
    if dev.type == "cpu":
        return chunk_hist_ref(syms, rle2_len)
    if dev.type != "cuda":
        raise ValueError(f"chunk_hist: unsupported device {dev}")
    hist = _hist_launch(syms, _length(rle2_len, dev), 1)[0]
    with _launch_lock:
        HIST_LAUNCHES += 1
    return hist


def chunk_hist_batch(syms: torch.Tensor, rle2_len) -> torch.Tensor:
    """syms: uint16 (or int32) [B, OUT], row b's first rle2_len[b] symbols
    its stream (rle2_len: int32 or int64 [B]).

    Returns int32[B, ceil(OUT / 50), 258], row b ``chunk_hist`` of row b,
    in one launch. A CUDA tensor launches the kernel on the current stream
    or raises; a CPU tensor runs the plain version."""
    global HIST_BATCH_LAUNCHES
    _symbols(syms, 2)
    dev = syms.device
    if dev.type == "cpu":
        return chunk_hist_batch_ref(syms, rle2_len)
    if dev.type != "cuda":
        raise ValueError(f"chunk_hist_batch: unsupported device {dev}")
    hist = _hist_launch(syms, _length(rle2_len, dev, syms.shape[0]), syms.shape[0])
    with _launch_lock:
        HIST_BATCH_LAUNCHES += 1
    return hist


def _check_tables(*tables: torch.Tensor) -> None:
    for t in tables:
        if t.shape != (MAX_GROUPS, ALPHA_MAX) or t.dtype != torch.int32:
            raise TypeError(f"a table array must be int32[{MAX_GROUPS}, {ALPHA_MAX}]")


def refine_pass_ref(syms: torch.Tensor, rle2_len, lens: torch.Tensor, table_count: int):
    """Plain torch version of ``refine_pass``: tpubz's products over the
    groups' histograms, in int64 arithmetic."""
    h = chunk_hist_ref(syms, rle2_len).to(torch.int64)
    lens = lens.to(syms.device)
    cost = torch.stack([(h * lens[t].to(torch.int64)).sum(1) for t in range(MAX_GROUPS)], 1)
    # tables past the count never win, whatever their stale lengths
    live = torch.arange(MAX_GROUPS, device=syms.device) < table_count
    cost = torch.where(live[None, :], cost, torch.iinfo(torch.int64).max)
    sel = torch.argmin(cost, 1)  # the first minimum: ties to the lowest table
    rfreq = torch.zeros(MAX_GROUPS, ALPHA_MAX, dtype=torch.int32, device=syms.device)
    rfreq.index_add_(0, sel, h.to(torch.int32))
    return sel.to(torch.int8), rfreq


_scratch: dict = {}  # refine_pass's scratch when the caller gives none, by (device, stream)


def _refine_scratch(lib, dev: torch.device, stream: int) -> torch.Tensor:
    """A zeroed scratch for the calls on one stream without buffers of their
    own: each call leaves it zeroed for the next, and the stream orders them."""
    with _launch_lock:
        key = (dev.index, stream)
        if key not in _scratch:
            _scratch[key] = torch.zeros(lib.tpubz_refine_scratch_words(), dtype=torch.int32,
                                        device=dev)
        return _scratch[key]


def _refine_args(syms: torch.Tensor, rle2_len):
    """The checked symbols (contiguous) and length tensor of a pass, and the
    symbol lanes OUT."""
    _symbols(syms, 1)
    dev = syms.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"refine_pass: unsupported device {dev}")
    OUT = syms.shape[0]
    if not 1 <= OUT < 1 << 30:
        raise ValueError(f"refine_pass takes 1 to 2^30 - 1 symbols, got {OUT}")
    return syms.contiguous(), _length(rle2_len, dev), OUT


def _check_count(table_count: int) -> None:
    if not 2 <= table_count <= MAX_GROUPS:
        raise ValueError(f"table_count {table_count} outside 2..{MAX_GROUPS}")


def _counted(rc: int) -> None:
    global REFINE_LAUNCHES
    if rc != 0:
        raise RuntimeError(f"tpubz_refine_pass launch failed: CUDA error {rc}")
    with _launch_lock:
        REFINE_LAUNCHES += 1


def refine_pass(syms: torch.Tensor, rle2_len, lens: torch.Tensor, table_count: int):
    """One refinement pass over a block's symbols. syms: int32 or uint16
    [OUT], the first rle2_len the stream (a device scalar, int64 or int32,
    or a host int); lens: int32[6, 258] on syms' device, the pass's code
    lengths, each of the first table_count rows below 256 (the format's are
    at most 20); table_count: 2..6 (the rows of lens past it are ignored).
    A block's passes go through its ``RefinePasses`` instead.

    Returns (sel int8[ceil(OUT / 50)], each group's table of least cost,
    ties to the lowest, 0 for a group with no symbol; rfreq int32[6, 258],
    rfreq[t, s] the count of s in the groups that chose t): tpubz's
    ``refine_pass(chunk_hist(syms, rle2_len), lens, table_count)``. A CUDA
    tensor launches the kernel on the current stream, one launch and no
    memset (its scratch is the stream's), or raises; a CPU tensor runs the
    plain version."""
    syms, length, OUT = _refine_args(syms, rle2_len)
    _check_tables(lens)
    _check_count(table_count)
    dev = syms.device
    if dev.type == "cpu":
        return refine_pass_ref(syms, length, lens, table_count)
    if lens.device != dev:
        raise ValueError(f"the lengths are on {lens.device}, the symbols on {dev}")
    lens = lens.contiguous()
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sel = torch.empty(nsel_cap(OUT), dtype=torch.int8, device=dev)
        rfreq = torch.empty(MAX_GROUPS, ALPHA_MAX, dtype=torch.int32, device=dev)
        scratch = _refine_scratch(lib, dev, stream)
        _counted(lib.tpubz_refine_pass(syms.data_ptr(), syms.element_size(), length.data_ptr(),
                                       length.element_size(), OUT, lens.data_ptr(), table_count,
                                       sel.data_ptr(), rfreq.data_ptr(), scratch.data_ptr(),
                                       stream))
    return sel, rfreq


class RefinePasses:
    """One block's refinement passes over its symbols (syms and rle2_len as
    ``refine_pass`` takes them), with every buffer they need allocated once:
    one device buffer carved into the lengths, the frequencies, the
    selectors and the kernel's scratch (zeroed once here), and on a card one
    pinned buffer for the lengths going up and the frequencies and
    selectors coming back. ``launch`` is one pass on ``lens`` into ``sel``
    and ``rfreq`` (one kernel on the current stream, its arguments checked
    and kept here, or the plain version on the CPU); ``run`` is a pass from
    host lengths to host results: the lengths copied up non-blocking, the
    launch, the results copied back behind one event, which it waits for.
    Its host microseconds add to ``host_us`` (``upload``, ``launch``,
    ``fetch``: the copy's enqueue and the wait)."""

    def __init__(self, syms: torch.Tensor, rle2_len):
        self.syms, self.length, OUT = _refine_args(syms, rle2_len)
        self.device = self.syms.device
        self.nsel = nsel_cap(OUT)
        tables = MAX_GROUPS * ALPHA_MAX
        sel_words = (self.nsel + 3) // 4
        cuda = self.device.type == "cuda"
        lib = _build.load() if cuda else None
        scratch_words = lib.tpubz_refine_scratch_words() if cuda else 1
        # [lens | rfreq | sel] travel; the scratch stays on the device
        words = torch.empty(2 * tables + sel_words + scratch_words, dtype=torch.int32,
                            device=self.device)
        self.lens = words[:tables].view(MAX_GROUPS, ALPHA_MAX)
        self.rfreq = words[tables: 2 * tables].view(MAX_GROUPS, ALPHA_MAX)
        self._back = words[tables: 2 * tables + sel_words]
        self.sel = self._back[tables:].view(torch.int8)[: self.nsel]
        self.scratch = words[2 * tables + sel_words:]
        self.scratch.zero_()
        host = torch.empty(2 * tables + sel_words, dtype=torch.int32, pin_memory=cuda)
        self._host_lens = host[:tables]
        self._host_back = host[tables:]
        self._lens_flat = self.lens.view(-1)
        self._event = torch.cuda.Event() if cuda else None
        if cuda:  # the kernel's arguments but the table count and the stream
            self._fn = lib.tpubz_refine_pass
            self._head = (self.syms.data_ptr(), self.syms.element_size(), self.length.data_ptr(),
                          self.length.element_size(), OUT, self.lens.data_ptr())
            self._tail = (self.sel.data_ptr(), self.rfreq.data_ptr(), self.scratch.data_ptr())
        self.host_us = {"upload": 0, "launch": 0, "fetch": 0}

    def launch(self, table_count: int) -> None:
        """One pass with the lengths in ``lens`` (each of the first
        table_count rows below 256) into ``sel`` and ``rfreq``."""
        _check_count(table_count)
        if self._event is None:
            sel, rfreq = refine_pass_ref(self.syms, self.length, self.lens, table_count)
            self.sel.copy_(sel)
            self.rfreq.copy_(rfreq)
            return
        idx = self.device.index
        if torch.cuda.current_device() != idx:
            with torch.cuda.device(idx):
                return self.launch(table_count)
        # the current stream's raw handle by torch's own getter (the one its
        # generated code calls): a pass's call is paced by its host time
        _counted(self._fn(*self._head, table_count, *self._tail,
                          torch._C._cuda_getCurrentRawStream(idx)))

    def run(self, lens: np.ndarray, table_count: int, nsel: int):
        """One pass with the code lengths ``lens`` (int[6, 258], each below
        256). Returns (sel int8[nsel], rfreq int32[6, 258]) as numpy
        arrays of their own."""
        if lens.shape != (MAX_GROUPS, ALPHA_MAX) or lens.min() < 0 or lens.max() > 255:
            raise ValueError("the code lengths must be [6, 258], each in 0..255")
        t0 = time.perf_counter()
        self._host_lens.numpy()[:] = lens.reshape(-1)
        self._lens_flat.copy_(self._host_lens, non_blocking=True)
        t1 = time.perf_counter()
        self.launch(table_count)
        t2 = time.perf_counter()
        self._host_back.copy_(self._back, non_blocking=True)
        if self._event is not None:
            self._event.record()
            self._event.synchronize()
        back = self._host_back.numpy()
        tables = MAX_GROUPS * ALPHA_MAX
        rfreq = back[:tables].reshape(MAX_GROUPS, ALPHA_MAX).copy()
        sel = back[tables:].view(np.int8)[:nsel].copy()
        t3 = time.perf_counter()
        for k, a, b in (("upload", t0, t1), ("launch", t1, t2), ("fetch", t2, t3)):
            self.host_us[k] += int((b - a) * 1e6)
        return sel, rfreq


def pack_payload_ref(syms, rle2_len, sel, codes, lens):
    """Plain torch version of ``pack_payload``."""
    out = syms.shape[0]
    dev = syms.device
    idx = torch.arange(out, dtype=torch.int64, device=dev)
    valid = idx < torch.as_tensor(rle2_len, device=dev).to(torch.int64)
    flat = sel.to(torch.int64)[idx // GROUP_SIZE] * ALPHA_MAX + syms.to(torch.int64)
    v = codes.reshape(-1).to(torch.int64)[flat]
    b = torch.where(valid, lens.reshape(-1).to(torch.int64)[flat], 0)
    return bitpack.pack_bits_device_ref(v, b, payload_words_cap(out))


def pack_payload(syms: torch.Tensor, rle2_len, sel: torch.Tensor, codes: torch.Tensor,
                 lens: torch.Tensor):
    """The block's Huffman payload packed MSB-first. syms: int32 or uint16
    [OUT], the first rle2_len the stream; sel: int8[ceil(OUT / 50)], the
    final selectors; codes: int32[6, 258] (the canonical codes, uint32 bit
    patterns); lens: int32[6, 258].

    Returns (words int32[payload_words_cap(OUT)], the uint32 words, and
    total 0-d int64, the payload's bits). A CUDA tensor launches the
    packing kernel with the gather fused into it on the current stream or
    raises; a CPU tensor runs the plain version."""
    global PAYLOAD_LAUNCHES
    _symbols(syms, 1)
    _check_tables(codes, lens)
    out = syms.shape[0]
    if sel.shape != (nsel_cap(out),) or sel.dtype != torch.int8:
        raise TypeError(f"sel must be int8[{nsel_cap(out)}]")
    dev = syms.device
    if dev.type == "cpu":
        return pack_payload_ref(syms, rle2_len, sel, codes, lens)
    if dev.type != "cuda":
        raise ValueError(f"pack_payload: unsupported device {dev}")
    syms = syms.contiguous()
    # a device length goes by pointer, a host int by value: no copy
    if isinstance(rle2_len, torch.Tensor):
        length = _length(rle2_len, dev)
        len_args = (length.data_ptr(), length.element_size(), 0)
    else:
        len_args = (None, 8, int(rle2_len))
    sel, codes, lens = (t if t.device == dev and t.is_contiguous() else t.to(dev).contiguous()
                        for t in (sel, codes, lens))
    packed = bitpack.launch(
        "tpubz_pack_payload",
        (syms.data_ptr(), syms.element_size(), *len_args, sel.data_ptr(), codes.data_ptr(),
         lens.data_ptr()),
        out, payload_words_cap(out), dev)
    with _launch_lock:
        PAYLOAD_LAUNCHES += 1
    return packed

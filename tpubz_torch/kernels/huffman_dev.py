"""The device half of the Huffman refinement, and the payload packed on the
device.

The counterpart of ``tpubz/kernels/huffman_dev.py``. With a block's
per-group histograms hist[nsel, 258] built once (``chunk_hist``), every
refinement pass is one call (``refine_pass``): each 50-symbol group's
cheapest table under the pass's code lengths, ties to the lowest table,
and each table's symbol frequencies over the groups that chose it. Only
the six tree builds of a pass run on the host (``native.code_lengths_native``),
with the selectors and the 6 x 258 frequencies crossing the link instead
of the symbol stream. ``pack_payload`` then gathers each symbol's code and
length by its group's selector and packs them MSB-first, so the payload
crosses the link as packed words. tpubz runs the two products of a pass on
the MXU in float32; here every sum is an integer sum (counts <= 50,
lengths <= 20), so the results are tpubz's exactly.

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
    t = torch.as_tensor(rle2_len, device=device)
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


def refine_pass_ref(hist: torch.Tensor, lens: torch.Tensor, table_count: int):
    """Plain torch version of ``refine_pass``, in int64 arithmetic."""
    h = hist.to(torch.int64)
    cost = torch.stack([(h * lens[t].to(torch.int64)).sum(1) for t in range(MAX_GROUPS)], 1)
    # tables past the count never win, whatever their stale lengths
    live = torch.arange(MAX_GROUPS, device=hist.device) < table_count
    cost = torch.where(live[None, :], cost, torch.iinfo(torch.int64).max)
    sel = torch.argmin(cost, 1)  # the first minimum: ties to the lowest table
    rfreq = torch.zeros(MAX_GROUPS, ALPHA_MAX, dtype=torch.int32, device=hist.device)
    rfreq.index_add_(0, sel, hist.to(torch.int32))
    return sel.to(torch.int8), rfreq


def refine_pass(hist: torch.Tensor, lens: torch.Tensor, table_count: int):
    """One refinement pass. hist: int32[NSEL, 258] (``chunk_hist``); lens:
    int32[6, 258], the code lengths of the pass; table_count: 2..6 (the
    rows of lens past it are ignored).

    Returns (sel int8[NSEL], each group's table of least cost, ties to the
    lowest, 0 for an all-zero row; rfreq int32[6, 258], rfreq[t] the sum of
    the rows that chose t). A CUDA tensor launches the kernel on the current
    stream or raises; a CPU tensor runs the plain version."""
    global REFINE_LAUNCHES
    if hist.dim() != 2 or hist.shape[1] != ALPHA_MAX or hist.dtype != torch.int32:
        raise TypeError(f"hist must be int32[NSEL, {ALPHA_MAX}]")
    _check_tables(lens)
    if not 2 <= table_count <= MAX_GROUPS:
        raise ValueError(f"table_count {table_count} outside 2..{MAX_GROUPS}")
    dev = hist.device
    if dev.type == "cpu":
        return refine_pass_ref(hist, lens, table_count)
    if dev.type != "cuda":
        raise ValueError(f"refine_pass: unsupported device {dev}")
    nsel = hist.shape[0]
    if not 1 <= nsel < 1 << 30:
        raise ValueError(f"refine_pass takes 1 to 2^30 - 1 groups, got {nsel}")
    hist, lens = hist.contiguous(), lens.to(dev).contiguous()
    sel = torch.empty(nsel, dtype=torch.int8, device=dev)
    rfreq = torch.empty(MAX_GROUPS, ALPHA_MAX, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_refine_pass(hist.data_ptr(), lens.data_ptr(), table_count, nsel,
                                   sel.data_ptr(), rfreq.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_refine_pass launch failed: CUDA error {rc}")
    with _launch_lock:
        REFINE_LAUNCHES += 1
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
    length = _length(rle2_len, dev)
    sel, codes, lens = (t.to(dev).contiguous() for t in (sel, codes, lens))
    packed = bitpack.launch(
        "tpubz_pack_payload",
        (syms.data_ptr(), syms.element_size(), length.data_ptr(), length.element_size(),
         sel.data_ptr(), codes.data_ptr(), lens.data_ptr()),
        out, payload_words_cap(out), dev)
    with _launch_lock:
        PAYLOAD_LAUNCHES += 1
    return packed

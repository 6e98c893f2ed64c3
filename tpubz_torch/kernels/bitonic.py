"""Bitonic sorting network on one tensor, keys-only or carrying a payload.

The counterpart of the Pallas kernels in ``tools/probe_pallas_sort.py``
(``bitonic_1op``, ``bitonic_2op``) and ``tools/probe_pallas_pass.py``
(``make_stage_kernel(js, mode).run``, here ``stage_passes``). The network
is theirs, pass for pass: for stage k = 1..log2 L and j = k-1..0, element i
meets its partner i ^ 2^j, the pair is in ascending order where bit k of
the lower index is 0 and descending elsewhere, and on equal keys neither
side moves (``probe_pallas_sort.py:76-79``). So keys and payloads come out
bit for bit as the Pallas body ``_bitonic_body`` leaves them, payload order
on duplicate keys included.

For a CUDA tensor each function launches the hand-written kernels of
``csrc/bitonic.cu`` on the current stream; for a CPU tensor it runs the
plain torch version (``*_ref``), which writes every pass in the pair-view
form of ``probe_pallas_pass.py:_cex_row`` (min and max of the two halves of
a (..., 2, d) view), with no gathers.

Keys are int32 or int64, payloads int32; the length is a power of two up
to 2^20.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _build

MAX_LOG2 = 20
KEY_DTYPES = {torch.int32: "i32", torch.int64: "i64"}

# calls into the kernel library in this process (CPU calls are not counted)
LAUNCHES = 0
# the same calls by wrapper
CALLS = {"bitonic_1op": 0, "bitonic_2op": 0, "stage_passes": 0}
# CUDA launches of the two pass kernels (bitonic_tile, bitonic_global_pass)
# that those calls made
PASS_LAUNCHES = 0
_launch_lock = threading.Lock()


def _log2(length: int) -> int:
    if length < 1 or length & (length - 1):
        raise ValueError(f"the length must be a power of two, got {length}")
    log2 = length.bit_length() - 1
    if log2 > MAX_LOG2:
        raise ValueError(f"the length must be at most 2^{MAX_LOG2}, got {length}")
    return log2


def network(log2n: int) -> list[tuple[int, int]]:
    """The (k, j) passes of the full sort of 2^log2n elements, in order."""
    return [(k, j) for k in range(1, log2n + 1) for j in range(k - 1, -1, -1)]


def _run_ref(keys, payload, passes):
    """The passes (k, j), in order, on copies of keys and payload (which
    may be None). Returns the new (keys, payload)."""
    L = keys.shape[0]
    log2n = L.bit_length() - 1
    keys = keys.clone(memory_format=torch.contiguous_format)
    kbuf = torch.empty_like(keys)
    if payload is not None:
        payload = payload.clone(memory_format=torch.contiguous_format)
        pbuf = torch.empty_like(payload)
    for k, j in passes:
        d = 1 << j
        # pair view (blocks, half, pairs, 2, d): a block of 2^(k+1) indices
        # is an ascending half (bit k = 0) and a descending one; at
        # k = log2 L the whole array is one ascending half
        if k >= log2n:
            shape = (1, 1, L >> (j + 1), 2, d)
        else:
            shape = (L >> (k + 1), 2, 1 << (k - j - 1), 2, d)
        src, dst = keys.view(shape), kbuf.view(shape)
        for h in range(shape[1]):
            a, b = src[:, h, :, 0], src[:, h, :, 1]
            # the smaller key goes first in the ascending half, last in the other
            torch.minimum(a, b, out=dst[:, h, :, h])
            torch.maximum(a, b, out=dst[:, h, :, 1 - h])
            if payload is not None:
                # swap where the pair is out of order; on equal keys neither
                # side moves. Blend by xor: no select, no overflow.
                swap = torch.lt(b, a) if h == 0 else torch.lt(a, b)
                pv, qv = payload.view(shape), pbuf.view(shape)
                pa, pb = pv[:, h, :, 0], pv[:, h, :, 1]
                m = torch.bitwise_xor(pa, pb).mul_(swap)
                torch.bitwise_xor(pa, m, out=qv[:, h, :, 0])
                torch.bitwise_xor(pb, m, out=qv[:, h, :, 1])
        keys, kbuf = kbuf, keys
        if payload is not None:
            payload, pbuf = pbuf, payload
    return keys, payload


def bitonic_1op_ref(keys: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``bitonic_1op``: the keys, sorted."""
    return _run_ref(keys, None, network(_log2(keys.shape[0])))[0]


def bitonic_2op_ref(keys: torch.Tensor, payload: torch.Tensor):
    """Plain torch version of ``bitonic_2op``: (sorted keys, payload)."""
    return _run_ref(keys, payload, network(_log2(keys.shape[0])))


def stage_passes_ref(keys: torch.Tensor, js) -> torch.Tensor:
    """Plain torch version of ``stage_passes``: writes into keys."""
    log2n = _log2(keys.shape[0])
    out, _ = _run_ref(keys, None, [(log2n, j) for j in js])
    keys.copy_(out)
    return keys


def _check(keys, payload=None):
    if keys.dtype not in KEY_DTYPES:
        raise TypeError(f"keys must be int32 or int64, got {keys.dtype}")
    if keys.dim() != 1:
        raise ValueError("keys must be one-dimensional")
    log2n = _log2(keys.shape[0])
    if payload is not None:
        if payload.dtype != torch.int32:
            raise TypeError(f"the payload must be int32, got {payload.dtype}")
        if payload.shape != keys.shape:
            raise ValueError("the payload must have the keys' shape")
        if payload.device != keys.device:
            raise ValueError("keys and payload must share one device")
    dev = keys.device
    if dev.type == "cuda":
        if not keys.is_contiguous() or (payload is not None and not payload.is_contiguous()):
            raise ValueError("the CUDA kernel takes contiguous tensors")
    elif dev.type != "cpu":
        raise ValueError(f"bitonic: unsupported device {dev}")
    return log2n


def _launch(name, entry, keys, *args):
    """Call a library entry point on keys' device and current stream,
    with the kernel-launch counter as its out argument."""
    global LAUNCHES, PASS_LAUNCHES
    fn = getattr(_build.load(), entry)
    launched = ctypes.c_int(0)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = fn(keys.data_ptr(), *args, ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
        CALLS[name] += 1
        PASS_LAUNCHES += launched.value


def bitonic_1op(keys: torch.Tensor) -> torch.Tensor:
    """The keys in ascending order, as a new tensor."""
    _check(keys)
    if keys.device.type == "cpu":
        return bitonic_1op_ref(keys)
    out = keys.clone()
    _launch("bitonic_1op", f"tpubz_bitonic_sort_{KEY_DTYPES[keys.dtype]}",
            out, None, out.shape[0])
    return out


def bitonic_2op(keys: torch.Tensor, payload: torch.Tensor):
    """(keys in ascending order, payload moved with them), as new tensors.
    Equal keys keep the order the network leaves them in."""
    _check(keys, payload)
    if keys.device.type == "cpu":
        return bitonic_2op_ref(keys, payload)
    out, pout = keys.clone(), payload.clone()
    _launch("bitonic_2op", f"tpubz_bitonic_sort_{KEY_DTYPES[keys.dtype]}",
            out, pout.data_ptr(), out.shape[0])
    return out, pout


def stage_passes(keys: torch.Tensor, js) -> torch.Tensor:
    """Ascending compare-exchange passes at distances 2^j, j in the order
    given, in place on keys (returned)."""
    log2n = _check(keys)
    js = [int(j) for j in js]
    if any(not 0 <= j < log2n for j in js):
        raise ValueError(f"pass distances must be 2^j with 0 <= j < {log2n}, got {js}")
    if keys.device.type == "cpu":
        return stage_passes_ref(keys, js)
    arr = (ctypes.c_int * max(len(js), 1))(*js)
    _launch("stage_passes", f"tpubz_bitonic_stage_{KEY_DTYPES[keys.dtype]}",
            keys, keys.shape[0], arr, len(js))
    return keys

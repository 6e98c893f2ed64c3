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
``csrc/bitonic.cu`` on the current stream, following a launch plan that
``plan`` makes here from the pass list: tile launches, each a list of
groups of passes run in registers over a tile in shared memory, and
global launches of up to ``FUSE`` consecutive long passes each. For a CPU
tensor it runs the plain torch version (``*_ref``), which writes every pass
in the pair-view form of ``probe_pallas_pass.py:_cex_row`` (min and max of
the two halves of a (..., 2, d) view), with no gathers.

Keys are int32 or int64, payloads int32; the length is a power of two up
to 2^20.
"""
from __future__ import annotations

import ctypes
import functools
import threading

import torch

from . import _build

MAX_LOG2 = 20
KEY_DTYPES = {torch.int32: "i32", torch.int64: "i64"}

# The launch plan's shape, chosen from 2^20 sorts measured on an H100 (PERF.md).
# A tile is 2^TILE_LOG2 keys in shared memory; each of its threads holds
# 2^REGS_LOG2 elements per array in registers (more where the tile would
# need more threads than a block may have); a global launch runs up to FUSE
# consecutive passes of one stage.
TILE_LOG2 = 12
REGS_LOG2 = 4
FUSE = 4
MAX_TILE_LOG2 = 14  # 2^14 keys with a payload fill 192 of the 227 KB
MAX_REGS_LOG2 = 5
MAX_TILE_PASSES = 128  # per tile launch, the kernel's TilePlan arrays
MAX_GROUPS = 64

# calls of this module's wrappers into the kernel library in this process
# (CPU calls are not counted)
LAUNCHES = 0
# sorts and pass runs on the card by kind: the same calls by wrapper, and the
# sorts the BWT's library call ran (suffix_sort.bwt_forward: a 2op sort per
# doubling round run, a 1op sort per block with ties)
CALLS = {"bitonic_1op": 0, "bitonic_2op": 0, "stage_passes": 0}
# CUDA launches of the two pass kernels (bitonic_tile, bitonic_global) that
# all of those made, a skipped round's empty launches included
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


def tile_threads_log2(regs_log2: int) -> int:
    """log2 of the most threads a tile block may have (csrc/bitonic.cu's
    max_tile_threads): 1024 with up to 8 elements a thread, else 512."""
    return 10 if regs_log2 <= 3 else 9


def _fill_bits(bits: set, t: int, R: int) -> tuple[int, ...]:
    """A group's R register bits: its pass bits and filler bits. Bits below
    R only: 0..R-1, the thread's elements consecutive. Otherwise fillers
    from bit 5 up first, so the lanes of a warp take bits 0..4 and walk
    consecutive elements."""
    if max(bits) < R:
        return tuple(range(R))
    free = [b for b in range(t) if b not in bits]
    pref = [b for b in free if b >= 5] + [b for b in free if R <= b < 5] + [b for b in free if b < R]
    return tuple(sorted(bits | set(pref[: R - len(bits)])))


def _tile_launches(run, t: int, R: int) -> list:
    """Tile launches for a run of passes all shorter than the tile: passes
    are packed in order into groups whose distance bits fit R register bits
    of one kind (all below R, or none), and groups into launches within the
    kernel's limits."""
    groups, cur, bits = [], [], set()

    def close():
        groups.append((_fill_bits(bits, t, R), cur))

    for k, j in run:
        nb = bits | {j}
        same_kind = max(nb) < R or min(nb) >= R
        if cur and (len(nb) > R or not same_kind or len(cur) == MAX_TILE_PASSES):
            close()
            cur, nb = [], {j}
        cur.append((k, j))
        bits = nb
    close()
    launches, lg, npass = [], [], 0
    for g in groups:
        if lg and (len(lg) == MAX_GROUPS or npass + len(g[1]) > MAX_TILE_PASSES):
            launches.append(("tile", t, R, lg))
            lg, npass = [], 0
        lg.append(g)
        npass += len(g[1])
    launches.append(("tile", t, R, lg))
    return launches


def plan(passes, log2n: int, tile_log2: int | None = None, regs_log2: int | None = None,
         fuse: int | None = None) -> list:
    """The launches that run ``passes`` ((k, j) pairs, in order) on 2^log2n
    keys: ("global", k, j_lo, r) runs (k, j_lo + r - 1) .. (k, j_lo) in
    device memory, r <= fuse, j_lo >= the tile's bits; ("tile", t, R,
    groups) runs, over tiles of 2^t keys, each group (register bits,
    passes) in registers, the tile in shared memory between groups.
    Defaults: TILE_LOG2, REGS_LOG2, FUSE."""
    tile_log2 = TILE_LOG2 if tile_log2 is None else tile_log2
    regs_log2 = REGS_LOG2 if regs_log2 is None else regs_log2
    fuse = FUSE if fuse is None else fuse
    if not 1 <= tile_log2 <= MAX_TILE_LOG2 or not 1 <= regs_log2 <= MAX_REGS_LOG2:
        raise ValueError(f"tile 2^{tile_log2}, registers 2^{regs_log2} out of range")
    if not 1 <= fuse <= MAX_REGS_LOG2:
        raise ValueError(f"fuse must be 1..{MAX_REGS_LOG2}, got {fuse}")
    t = min(tile_log2, log2n)
    R = min(regs_log2, t)
    while t - R > tile_threads_log2(R):
        R += 1
    if R > MAX_REGS_LOG2:
        raise ValueError(f"a tile of 2^{t} needs 2^{R} registers a thread")
    launches, i = [], 0
    while i < len(passes):
        k, j = passes[i]
        if j >= t:
            r = 1
            while (i + r < len(passes) and r < fuse and j - r >= t
                   and passes[i + r] == (k, j - r)):
                r += 1
            launches.append(("global", k, j - r + 1, r))
            i += r
        else:
            run = []
            while i < len(passes) and passes[i][1] < t:
                run.append(passes[i])
                i += 1
            launches += _tile_launches(run, t, R)
    return launches


def plan_passes(launches) -> list[tuple[int, int]]:
    """The (k, j) passes a plan runs, in order."""
    out = []
    for launch in launches:
        if launch[0] == "global":
            _, k, j_lo, r = launch
            out += [(k, j) for j in range(j_lo + r - 1, j_lo - 1, -1)]
        else:
            out += [p for _, ps in launch[3] for p in ps]
    return out


def encode(launches) -> list[int]:
    """The plan as the ints ``tpubz_bitonic_run_*`` reads: per global launch
    [0, k, j_lo, r]; per tile launch [1, t, R, groups, passes], then per
    group its R register bits, 1 if they are 0..R-1, and one past its last
    pass, then per pass the register position of j, k, and the register
    position of k or 255."""
    words = []
    for launch in launches:
        if launch[0] == "global":
            words += [0, *launch[1:]]
            continue
        _, t, R, groups = launch
        words += [1, t, R, len(groups), sum(len(ps) for _, ps in groups)]
        end = 0
        for bits, ps in groups:
            end += len(ps)
            words += [*bits, int(bits == tuple(range(R))), end]
        for bits, ps in groups:
            for k, j in ps:
                words += [bits.index(j), k, bits.index(k) if k in bits else 255]
    return words


@functools.lru_cache(maxsize=64)
def _sort_plan(log2n: int, tile_log2: int, regs_log2: int, fuse: int):
    words = encode(plan(network(log2n), log2n, tile_log2, regs_log2, fuse))
    return (ctypes.c_int * len(words))(*words), len(words)


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
        for t in (keys, payload):
            if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
                raise ValueError("the CUDA kernel takes contiguous, 16-byte aligned tensors")
    elif dev.type != "cpu":
        raise ValueError(f"bitonic: unsupported device {dev}")
    return log2n


def _launch(name, keys, payload, words):
    """Run an encoded plan through the library on keys' device and current
    stream, with the kernel-launch counter as its out argument."""
    global LAUNCHES, PASS_LAUNCHES
    fn = getattr(_build.load(), f"tpubz_bitonic_run_{KEY_DTYPES[keys.dtype]}")
    arr, count = words
    launched = ctypes.c_int(0)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = fn(keys.data_ptr(), None if payload is None else payload.data_ptr(),
                keys.shape[0], arr, count, ctypes.byref(launched), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_bitonic_run launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
        CALLS[name] += 1
        PASS_LAUNCHES += launched.value


def count_sorts(two_op: int, one_op: int, pass_launches: int) -> None:
    """Count sorts that another entry point of the library ran through the
    plan runner (the BWT's rounds and its tied last column): CALLS and
    PASS_LAUNCHES, not LAUNCHES, which counts this module's own calls."""
    global PASS_LAUNCHES
    with _launch_lock:
        CALLS["bitonic_2op"] += two_op
        CALLS["bitonic_1op"] += one_op
        PASS_LAUNCHES += pass_launches


def bitonic_1op(keys: torch.Tensor) -> torch.Tensor:
    """The keys in ascending order, as a new tensor."""
    log2n = _check(keys)
    if keys.device.type == "cpu":
        return bitonic_1op_ref(keys)
    out = keys.clone()
    _launch("bitonic_1op", out, None, _sort_plan(log2n, TILE_LOG2, REGS_LOG2, FUSE))
    return out


def bitonic_2op(keys: torch.Tensor, payload: torch.Tensor):
    """(keys in ascending order, payload moved with them), as new tensors.
    Equal keys keep the order the network leaves them in."""
    log2n = _check(keys, payload)
    if keys.device.type == "cpu":
        return bitonic_2op_ref(keys, payload)
    out, pout = keys.clone(), payload.clone()
    _launch("bitonic_2op", out, pout, _sort_plan(log2n, TILE_LOG2, REGS_LOG2, FUSE))
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
    if js:
        words = encode(plan([(log2n, j) for j in js], log2n))
        _launch("stage_passes", keys, None, ((ctypes.c_int * len(words))(*words), len(words)))
    return keys

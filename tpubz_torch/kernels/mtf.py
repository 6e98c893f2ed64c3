"""Move-to-front ranks of a BWT last column, chunk by chunk.

The counterpart of ``tpubz/kernels/mtf.py:mtf_ranks`` (see that module's
docstring for the formulation). For a CUDA tensor ``mtf_ranks`` launches the
hand-written kernels of ``csrc/mtf.cu`` (the whole MTF: chunk-start recency
rows, initial ranks, in-chunk occurrences and the dominance counts) on the
current stream; for a CPU tensor it runs the plain torch version
``mtf_ranks_ref``: ``mtf_parts`` builds, for each 256-wide chunk, each
position's in-chunk previous and next occurrence and the recency keys at the
chunk start, and ``ranks_from_parts_ref`` turns them into ranks as the
Pallas kernel ``tpubz/kernels/mtf_pallas.py`` does.

Where the TPU formulation avoided gathers and scatters, the plain version
uses them: the (symbol, position) sort is taken back by a scatter, and the
initial rank of a first-ever occurrence is a gather from the cumulative
count of used symbols instead of a (nc, 256, 256) compare-count.
"""
from __future__ import annotations

import threading

import torch

from . import _build

ABSENT = 256
CHUNK = 256  # the CUDA kernels run one 256-thread CTA per chunk
# chunks one CTA of the recency scan walks (csrc/mtf.cu: at most 16); the
# scan of the group totals then runs over ceil(nc / GROUP) rows
GROUP = 16

# calls into the kernel library in this process, three kernels each (CPU
# calls are not counted)
LAUNCHES = 0
_launch_lock = threading.Lock()


def mtf_parts(last: torch.Tensor, n: int, chunk: int = CHUNK):
    """last: uint8[N] BWT output (first n valid; N % chunk == 0).

    Returns (lprev, lnext, keyi int32 (nc, chunk), keyrow int32 (nc, 256),
    used bool[256]), the inputs of ``ranks_from_parts_ref``."""
    N = last.shape[0]
    if N % chunk:
        raise ValueError("N must be a multiple of the chunk size")
    nc = N // chunk
    dev = last.device
    i64 = torch.int64
    idx = torch.arange(N, dtype=i64, device=dev)
    # pad lanes carry symbol 256, their own column of last_pos below
    sym = torch.where(idx < n, last.to(i64), 256)

    # global prev/next occurrence: a stable sort keeps equal symbols in
    # position order, and a scatter takes the result back to positions
    s_sym, s_idx = torch.sort(sym, stable=True)
    same = s_sym[1:] == s_sym[:-1]
    prev_sorted = torch.full((N,), -1, dtype=i64, device=dev)
    prev_sorted[1:] = torch.where(same, s_idx[:-1], -1)
    next_sorted = torch.full((N,), N, dtype=i64, device=dev)
    next_sorted[:-1] = torch.where(same, s_idx[1:], N)
    prev_g = torch.empty(N, dtype=i64, device=dev)
    prev_g[s_idx] = prev_sorted
    next_g = torch.empty(N, dtype=i64, device=dev)
    next_g[s_idx] = next_sorted

    # last occurrence per (chunk, symbol): the last entry of each group in
    # the sorted stream, scattered into (nc, 257) plus one dump slot
    s_cid = s_idx // chunk
    last_in_group = torch.ones(N, dtype=torch.bool, device=dev)
    last_in_group[:-1] = ~same | (s_cid[1:] != s_cid[:-1])
    tgt = torch.where(last_in_group, s_cid * 257 + s_sym, nc * 257)
    last_pos = torch.full((nc * 257 + 1,), -1, dtype=i64, device=dev)
    last_pos[tgt] = s_idx
    # running max over chunks; its last row is the global last occurrence
    run = torch.cummax(last_pos[:-1].view(nc, 257), dim=0).values
    used = run[-1, :256] >= 0
    used_count = torch.cumsum(used.to(i64), 0)
    init_rank = torch.where(used, used_count - 1, ABSENT)
    last_before = torch.cat(
        (torch.full((1, 256), -1, dtype=i64, device=dev), run[:-1, :256])
    )
    keyrow = torch.where(last_before >= 0, N - last_before, 2 * N + init_rank[None, :])

    # initial rank of each position's symbol = #{used t < sym}; pad lanes
    # (sym 256) read the used count, as in tpubz, and are never consumed
    used_below = torch.cat((torch.zeros(1, dtype=i64, device=dev), used_count))
    irank_pos = used_below[sym]
    cstart = idx // chunk * chunk
    keyi = torch.where(prev_g >= 0, N - prev_g, 2 * N + irank_pos)
    lprev = torch.where(prev_g >= cstart, prev_g - cstart, -1)
    lnext = torch.where(next_g < cstart + chunk, next_g - cstart, chunk)
    i32 = torch.int32
    return (
        lprev.to(i32).view(nc, chunk),
        lnext.to(i32).view(nc, chunk),
        keyi.to(i32).view(nc, chunk),
        keyrow.to(i32),
        used,
    )


def ranks_from_parts_ref(lprev, lnext, keyi, keyrow):
    """The dominance count of ``tpubz/kernels/mtf_pallas.py`` with the srank
    compare-count fused in, in plain torch. Case 2 compares srank
    (``mtf_pallas.py:35-37``), not keyi as the jnp form of ``mtf.py:81``
    does. The two agree only where keys are distinct, which real MTF parts
    guarantee and random test inputs do not.

    lprev, lnext, keyi: int32 (rows, C); keyrow: int32 (rows, 256).
    Returns int32 (rows, C). Materializes (rows, C, C) masks."""
    rows, C = lprev.shape
    srank = (keyrow[:, None, :] < keyi[:, :, None]).sum(-1, dtype=torch.int32)
    li = torch.arange(C, dtype=torch.int32, device=lprev.device)
    ii = li[None, :, None]  # row: position i
    jj = li[None, None, :]  # col: candidate j
    before = jj < ii
    case1 = (jj > lprev[:, :, None]) & (lnext[:, None, :] >= ii)
    case2 = (lprev[:, None, :] < 0) & (srank[:, None, :] >= srank[:, :, None])
    mat = before & torch.where((lprev >= 0)[:, :, None], case1, case2)
    counts = mat.sum(-1, dtype=torch.int32)
    return counts + torch.where(lprev < 0, srank, 0)


def mtf_ranks_ref(last: torch.Tensor, n: int, chunk: int = CHUNK):
    """Plain torch version of ``mtf_ranks``: ``mtf_parts`` then
    ``ranks_from_parts_ref``, pad lanes set to 0 as the kernels leave them."""
    lprev, lnext, keyi, keyrow, used = mtf_parts(last, n, chunk)
    ranks = ranks_from_parts_ref(lprev, lnext, keyi, keyrow).view(-1)
    ranks[n:] = 0
    return ranks, used


def _check(last: torch.Tensor, n: int, chunk: int) -> None:
    if last.dtype != torch.uint8 or last.dim() != 1:
        raise TypeError("mtf_ranks takes a 1-D uint8 tensor")
    N = last.shape[0]
    if chunk != CHUNK:
        raise ValueError(f"the CUDA kernels take chunks of {CHUNK}, got {chunk}")
    if N % CHUNK:
        raise ValueError("N must be a multiple of the chunk size")
    if not 0 <= n <= N:
        raise ValueError(f"n={n} outside [0, {N}]")
    # the kernels sort (recency key << 8 | symbol) in an int32
    if 2 * N + ABSENT >= 1 << 23:
        raise ValueError(f"N={N} is too large for the CUDA kernels")
    if not last.is_contiguous():
        raise ValueError("the CUDA kernels take a contiguous tensor")


def mtf_ranks(last: torch.Tensor, n: int, chunk: int = CHUNK):
    """last: uint8[N] BWT output (first n valid; N % chunk == 0).

    Returns (ranks int32[N], used bool[256]): ranks[:n] are the MTF ranks of
    last[:n] over the sorted used-symbol alphabet; pad lanes are 0. A CUDA
    tensor launches the kernels on the current stream (chunk must be 256)
    or raises; a CPU tensor runs the plain version. ``n`` is a host int and
    nothing is read back."""
    global LAUNCHES
    dev = last.device
    if dev.type == "cpu":
        return mtf_ranks_ref(last, n, chunk)
    if dev.type != "cuda":
        raise ValueError(f"mtf_ranks: unsupported device {dev}")
    _check(last, n, chunk)
    N = last.shape[0]
    nc = N // CHUNK
    ng = -(-nc // GROUP)
    scratch = torch.empty((nc + 2 * ng) * CHUNK, dtype=torch.int32, device=dev)
    used = torch.empty(256, dtype=torch.bool, device=dev)
    ranks = torch.empty(N, dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_mtf_ranks(last.data_ptr(), n, N, GROUP, scratch.data_ptr(),
                                 used.data_ptr(), ranks.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tpubz_mtf_ranks launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return ranks, used

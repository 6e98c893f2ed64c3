"""MTF ranks within each chunk, from the chunk's occurrence parts.

The counterpart of ``tpubz/kernels/mtf_pallas.py``. It computes what
``tpubz/kernels/mtf.py:_ranks_from_parts(..., use_pallas=True)`` computes:
the chunk-start rank count (``srank``) fused into the Pallas dominance
count. For a CUDA tensor ``ranks_from_parts`` launches the hand-written
kernel ``csrc/mtf_dominance.cu``; for a CPU tensor it runs the plain torch
version ``ranks_from_parts_ref``.
"""
from __future__ import annotations

import threading

import torch

from . import _build

CHUNK = 256  # the CUDA kernel runs one 256-thread CTA per chunk

# launches of the CUDA kernel in this process (CPU calls are not counted)
LAUNCHES = 0
_launch_lock = threading.Lock()


def ranks_from_parts_ref(lprev, lnext, keyi, keyrow):
    """Plain torch version of the kernel, in the Pallas form: case 2
    compares srank (``mtf_pallas.py:35-37``), not keyi as the jnp form of
    ``mtf.py:81`` does. The two agree only where keys are distinct, which
    real MTF parts guarantee and random test inputs do not.

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


def _check(lprev, lnext, keyi, keyrow):
    parts = (lprev, lnext, keyi, keyrow)
    if any(t.dtype != torch.int32 for t in parts):
        raise TypeError("ranks_from_parts takes int32 tensors")
    if lprev.dim() != 2 or any(t.shape != lprev.shape for t in (lnext, keyi)):
        raise ValueError("lprev, lnext and keyi must share one (rows, C) shape")
    if keyrow.shape != (lprev.shape[0], 256):
        raise ValueError("keyrow must be (rows, 256)")
    if any(t.device != lprev.device for t in parts):
        raise ValueError("ranks_from_parts inputs must share one device")


def ranks_from_parts(lprev, lnext, keyi, keyrow):
    """(rows, C) int32 MTF ranks. A CUDA tensor launches the kernel on the
    current stream (C must be 256) or raises; a CPU tensor runs the plain
    version."""
    global LAUNCHES
    _check(lprev, lnext, keyi, keyrow)
    dev = lprev.device
    if dev.type == "cpu":
        return ranks_from_parts_ref(lprev, lnext, keyi, keyrow)
    if dev.type != "cuda":
        raise ValueError(f"ranks_from_parts: unsupported device {dev}")
    nc, C = lprev.shape
    if C != CHUNK:
        raise ValueError(f"the CUDA kernel takes chunks of {CHUNK}, got {C}")
    parts = (lprev, lnext, keyi, keyrow)
    if not all(t.is_contiguous() for t in parts):
        raise ValueError("the CUDA kernel takes contiguous tensors")
    out = torch.empty((nc, C), dtype=torch.int32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tpubz_mtf_dominance(
            *(t.data_ptr() for t in parts), out.data_ptr(), nc, stream
        )
    if rc != 0:
        raise RuntimeError(f"tpubz_mtf_dominance launch failed: CUDA error {rc}")
    with _launch_lock:
        LAUNCHES += 1
    return out

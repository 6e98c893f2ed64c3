"""The batched block transform of one card: BWT, MTF, RLE2 and the compact
transfer form over rows of blocks.

The counterpart of ``tpubz/dist/sharded.py:make_sharded_transform``. There a
``shard_map`` hands each device of a mesh its rows of the global block batch
and one jitted program runs the batched stages on them. Here each process of
the multi-process path drives one card and runs its own rows through the
batched kernels itself, so no mesh and no ``shard_map`` is needed: the
function returned works on the rows of one card. tpubz's ``block_mesh`` and
its warm stamps (``warm_sharded``, ``probe_sharded``) have no counterpart:
they guard a JAX compile of the sharded program that takes minutes on a TPU,
and PyTorch compiles nothing at run time (the CUDA kernels are built once,
by ``kernels/_build.py``).
"""
from __future__ import annotations

import torch

from ..block.encode import resolve_device
from ..kernels.compact import stage_compact
from ..kernels.mtf import CHUNK as MTF_CHUNK
from ..kernels.mtf import mtf_ranks_batch, row_lengths
from ..kernels.rle2 import rle2_encode_batch
from ..kernels.suffix_sort import bwt_forward_batch


def make_sharded_transform(device, N: int):
    """A function (data uint8[B, N], n) -> (keys int64[B], syms uint16[B,
    N+8], rle2_len int32[B], freqs int32[B, 258], used bool[B, 256],
    syms_u8 uint8[B, N+8], hi_packed int32[B, HI_CAP], hi_count int32[B]) on
    ``device``: row b's first n[b] bytes (n: B host ints) through the
    batched BWT, MTF, RLE2 and compact kernels, tpubz's outputs in the same
    order. ``data`` is moved to the device if it is not there. A CUDA device
    runs the kernels, the CPU their plain versions."""
    dev = resolve_device(device)
    if N % MTF_CHUNK:
        raise ValueError(f"N={N} must be a multiple of {MTF_CHUNK}")

    def transform(data: torch.Tensor, n):
        data = data.to(dev)
        if data.dim() != 2 or data.shape[1] != N:
            raise ValueError(f"the transform takes rows of N={N} bytes, got {tuple(data.shape)}")
        n = [int(x) for x in n]
        lengths = row_lengths(n, data.shape[0], N, dev)
        keys, lasts = bwt_forward_batch(data, n)
        ranks, used = mtf_ranks_batch(lasts, lengths)
        eob = used.sum(1, dtype=torch.int32) + 1
        syms, rle2_len, freqs = rle2_encode_batch(ranks, lengths, eob)
        syms_u8, hi_packed, hi_count = stage_compact(syms, rle2_len)
        return keys, syms, rle2_len, freqs, used, syms_u8, hi_packed, hi_count

    return transform

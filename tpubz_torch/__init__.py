"""tpubz_torch — the tpubz bzip2 codec ported to PyTorch and CUDA (NVIDIA Hopper).

Public API:
  compress(data, level=9, *, device="cuda") -> bytes
  decompress(data)                          -> bytes  (tpubz's host decoder)

Layer map:
  kernels/  BWT (torch sorts), MTF parts (torch) with the dominance count as
            a hand-written CUDA kernel (csrc/mtf_dominance.cu, built with
            nvcc at first use into _build/), RLE2 (torch)
  block/    per-block device transform chain and host fetch
  stream/   whole-stream assembly and the block pipeline

Shared with tpubz, not copied: format/, hostref/ (RLE1 scan, bit splicing),
block/emit.py with the native Huffman refine and emission engine, native/,
and stream/decode.py. None of them imports jax, and neither does this
package.

The device is explicit. Asking for "cuda" without a card raises; the port
never falls back to the CPU.
"""
from tpubz.stream.decode import decompress

from .stream.api import compress

__all__ = ["compress", "decompress"]

"""tpubz_torch — the tpubz bzip2 codec ported to PyTorch and CUDA (NVIDIA Hopper).

Public API, the surfaces of tpubz and of the stdlib ``bz2``:
  compress(data, level=9, *, device="cuda") -> bytes
  compress_cpu(data, level=9)               -> bytes  (native CPU engine alone)
  decompress(data)                          -> bytes  (the native host decoder)
  open(filename, mode="rb", ..., device="cuda"), BZ2File
  BZ2Compressor(compresslevel=9, *, device="cuda"), BZ2Decompressor
  python -m tpubz_torch [bzip2 flags] [files]
  dist.multihost.initialize / compress_multihost / decompress_multihost:
            the multi-process path over torch.distributed (gloo)

Layer map:
  kernels/  BWT (csrc/bwt.cu) on a hand-written radix sort (csrc/radix.cu),
            MTF (csrc/mtf.cu) and RLE2 (csrc/rle2.cu) as hand-written CUDA
            kernels, each beside its plain torch version for CPU tensors,
            and the bitonic sorts of the TPU probes (csrc/bitonic.cu); the
            CUDA sources are built with nvcc at first use into _build/
  block/    per-block device transforms (full chain, or the BWT alone) and
            the pinned, event-synchronised host fetches
  dist/     the multi-process path: one card per process, its rows through
            the batched BWT, MTF and RLE2 kernels and the compact transfer
            form (csrc/compact.cu), the packed blocks gathered to rank 0
  stream/   the hybrid scheduler (device blocks beside native CPU workers,
            the full and bwt device stages), its measured profile, and the
            bounded-memory file streams
  fileobj.py, incremental.py, cli.py: the file, incremental and command
            line surfaces on the stream layer
  native/   the host engine (C++ built with g++ at first use into _build/):
            RLE1 scan, the CPU engine's block transform, MTF/RLE2 of the bwt
            stage, Huffman refinement and emission, the block decoder
  format/, hostref/, block/emit.py, stream/decode.py: the format constants
            and CRC, bit packing and splicing, the RLE1 block feed, block
            emission and the block-parallel decoder, on native/
  hostref/stream.py: the scalar codec (tpubz's numpy and Python codec, no
            native code and no card; the oracle of both, behind
            --trace-bits; no route takes it)

The package stands alone: it imports torch, numpy and the standard library,
never tpubz and never jax. Its host engine is its own copy of tpubz's C++
sources, so its streams equal tpubz's and C bzip2's byte for byte.

The device is explicit. Asking for "cuda" without a card raises; the port
never falls back to the CPU, and a device error always reaches the caller.
"""
from .stream.api import compress, compress_cpu
from .stream.decode import decompress

__version__ = "0.1.0"  # tpubz's

__all__ = [
    "BZ2Compressor",
    "BZ2Decompressor",
    "BZ2File",
    "compress",
    "compress_cpu",
    "decompress",
    "open",
]


def __dir__():
    return sorted(set(globals()) | set(__all__))


def __getattr__(name):
    # the file and incremental surfaces load on first use
    if name in ("BZ2Compressor", "BZ2Decompressor"):
        from . import incremental

        return getattr(incremental, name)
    if name in ("BZ2File", "open"):
        from . import fileobj

        return fileobj.TpubzFile if name == "BZ2File" else fileobj.open
    raise AttributeError(f"module 'tpubz_torch' has no attribute {name!r}")

"""Device block encoder: BWT -> MTF -> RLE2 on one torch device.

The counterpart of ``tpubz/block/encode.py:DeviceBlockEncoder``. ``transform``
copies an RLE1 block to the device once, pads it there and runs the three
transforms; ``fetch`` brings back what the host emission needs, as
``tpubz.block.encode.materialize`` returns it. Huffman refinement and bit
emission stay in tpubz's native engine (``tpubz.block.emit.emit_block``).

The TPU relay and compile machinery of the JAX encoder (persistent compile
cache, staged jits, warm stamps, the compact u8 transfer form) has no
counterpart here: PyTorch runs eagerly and the card sits on PCIe.
"""
from __future__ import annotations

import numpy as np
import torch

from tpubz.block.emit import emit_block

from ..kernels.mtf import mtf_ranks
from ..kernels.mtf_dominance import CHUNK as MTF_CHUNK
from ..kernels.rle2 import rle2_encode
from ..kernels.suffix_sort import bwt_forward


def block_n(level: int) -> int:
    """Padded device block length: level * 100k rounded up to the chunk.
    Declared here, not imported (tpubz.block.encode imports jax); the tests
    hold it and MTF_CHUNK equal to tpubz's."""
    raw = level * 100_000
    return (raw + MTF_CHUNK - 1) // MTF_CHUNK * MTF_CHUNK


def resolve_device(device) -> torch.device:
    """The device asked for. A CUDA device without a usable card raises:
    the port never carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


class DeviceBlockEncoder:
    """Encodes RLE1 blocks through the torch transform chain on ``device``."""

    def __init__(self, level: int, device="cuda"):
        if not 1 <= level <= 9:
            raise ValueError("level must be 1..9")
        self.level = level
        self.device = resolve_device(device)
        self.N = block_n(level)

    def upload(self, rle1_block: np.ndarray) -> torch.Tensor:
        """The block on the device, zero-padded to N: uint8[N]."""
        n = int(rle1_block.size)
        if n > self.N:
            raise ValueError(f"block of {n} bytes exceeds N={self.N}")
        data = torch.zeros(self.N, dtype=torch.uint8, device=self.device)
        # np.require copies only a read-only view, which torch cannot wrap
        data[:n].copy_(torch.from_numpy(np.require(rle1_block, np.uint8, "CW")))
        return data

    def transform(self, rle1_block: np.ndarray):
        """Device tensors (key, syms, rle2_len, freqs, used) of one block."""
        n = int(rle1_block.size)
        key, last = bwt_forward(self.upload(rle1_block), n)
        ranks, used = mtf_ranks(last, n, MTF_CHUNK)
        eob = used.sum() + 1
        syms, rle2_len, freqs = rle2_encode(ranks, n, eob)
        return key, syms, rle2_len, freqs, used

    @staticmethod
    def fetch(out):
        """Host copy of a transform result: (key int, syms uint16[rle2_len],
        rle2_len int, freqs int64[258], used bool[256]), EOB at rle2_len-1."""
        key, syms, rle2_len, freqs, used = out
        rl = int(rle2_len)
        return (
            int(key),
            syms[:rl].cpu().numpy().astype(np.uint16),
            rl,
            freqs.cpu().numpy().astype(np.int64),
            used.cpu().numpy(),
        )

    emit_block = staticmethod(emit_block)

    def encode_block(self, rle1_block: np.ndarray, crc: int):
        """One block's packed bits (a tpubz BitAccum)."""
        return self.emit_block(*self.fetch(self.transform(rle1_block)), crc)

"""One block through the scalar codec: encode and decode in numpy and
Python, none of the native engine.

The counterpart of ``tpubz/hostref/block.py``. A block is its 48-bit magic,
the CRC of its raw bytes (32 bits), the randomized bit (0), the BWT key (24
bits), the symbol map, then the Huffman tables, the selectors and the
payload. The header fields log their bit position at DEBUG on the
``tpubz_torch`` logger, in tpubz's words.
"""
from __future__ import annotations

import logging

import numpy as np

from ..format.constants import BLOCK_MAGIC
from ..format.symbol_map import decode_symbol_map
from .bitio import BitAccum, BitReader
from .bwt import bwt_decode_fast, bwt_encode
from .huffman import build_decode_table, huffman_decode_payload, huffman_encode, read_huffman_tables
from .mtf_rle2 import mtf_rle2_decode, mtf_rle2_encode
from .rle1 import rle1_decode

log = logging.getLogger("tpubz_torch")


def encode_block(rle1_block: np.ndarray, crc: int) -> BitAccum:
    """One RLE1 block and the CRC of its raw bytes -> its bit fields."""
    acc = BitAccum()
    acc.put(BLOCK_MAGIC, 48)
    acc.put(crc, 32)
    acc.put(0, 1)  # randomized: always 0
    key, last = bwt_encode(rle1_block)
    log.debug("key %d written at bit %d", key, acc.bit_len)
    acc.put(key, 24)
    rle2, freqs, used = mtf_rle2_encode(last)
    log.info("block: %d bytes in, %d symbols after MTF+RLE2, %d byte values in use",
             rle1_block.size, rle2.size, int(used.sum()))
    huffman_encode(acc, rle2, freqs, used)
    return acc


def decode_block(br: BitReader, level: int, trace: bool = False) -> tuple[np.ndarray, int]:
    """Decode one block body, its 48-bit magic already read: (raw bytes, the
    block CRC the stream states). ``trace`` logs each payload symbol."""
    log.debug("block CRC read at bit %d", br.pos)
    blk_crc = br.read(32)
    br.read_bit()  # the randomized flag: read and ignored
    log.debug("key read at bit %d", br.pos)
    key = br.read(24)
    if key > level * 100_000 + 10:
        raise ValueError("invalid BWT key pointer")
    log.debug("symbol map read at bit %d", br.pos)
    l1 = br.read(16)
    words = [l1] + [br.read(16) for _ in range(bin(l1).count("1"))]
    symbol_set = decode_symbol_map(words)
    alpha = symbol_set.size + 2
    eob = symbol_set.size + 1
    log.debug("table count read at bit %d", br.pos)
    table_count = br.read(3)
    if not 2 <= table_count <= 6:
        raise ValueError("invalid table count")
    log.debug("selector count read at bit %d", br.pos)
    nsel = br.read(15)
    # selectors past the most a block can use are read and dropped
    max_sel = level * 100_000 // 50
    raw_sel = []
    for _ in range(nsel):
        g = 0
        while br.read_bit():
            g += 1
        if len(raw_sel) < max_sel:
            raw_sel.append(g)
    # undo the selectors' move-to-front
    idx = list(range(table_count))
    selectors = np.empty(len(raw_sel), dtype=np.int64)
    for i, g in enumerate(raw_sel):
        if g >= table_count:
            raise ValueError("selector out of range")
        selectors[i] = idx[g]
        idx.insert(0, idx.pop(g))
    lengths = read_huffman_tables(br, alpha, table_count)
    tables = [build_decode_table(lengths[t]) for t in range(table_count)]
    rle2 = huffman_decode_payload(br, tables, selectors, eob, trace)
    mtf_out = mtf_rle2_decode(rle2, symbol_set, level * 100_000)
    if key >= mtf_out.size and mtf_out.size > 0:
        raise ValueError("BWT key out of range for block")
    return rle1_decode(bwt_decode_fast(int(key), mtf_out)), blk_crc

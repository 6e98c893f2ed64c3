"""bzip2 stream-format constants, and the port's Huffman refinement count.

The values are the format's (those of ``tpubz/format/constants.py``). The
refinement count is the port's own setting: ``set_huffman_iters`` (the
command line's ``--iterations``) changes it for this package only.
"""
import os

# 48-bit block magic: BCD of pi
BLOCK_MAGIC = 0x314159265359
# 48-bit stream footer magic: BCD of sqrt(pi)
FOOTER_MAGIC = 0x177245385090

STREAM_MAGIC = b"BZh"  # followed by ASCII '1'..'9'


def block_budget(level: int) -> int:
    """Post-RLE1 bytes of a block at ``level`` (1..9)."""
    return level * 100_000 - 19


# RLE1: runs of RUN_THRESHOLD..MAX_RUN equal bytes become RUN_THRESHOLD
# literals and a count byte
RUN_THRESHOLD = 4
MAX_RUN = 255

# the most zeros RLE2 run digits may decode to before the decoder refuses
ZERO_BOMB = 2 * 1024 * 1024

# Huffman coding: symbols a selector group, tables, alphabet (256 byte
# symbols + RUNA/RUNB overlay + EOB) and the longest code the encoder emits
GROUP_SIZE = 50
MAX_GROUPS = 6
MAX_ALPHA_SIZE = 258
MAX_CODE_LEN_ENCODE = 17
MAX_CODE_LEN_DECODE = 20  # the longest code a decoder must accept


def group_count_for(rle2_len: int) -> int:
    """Huffman tables for a block of ``rle2_len`` RLE2 symbols."""
    if rle2_len < 200:
        return 2
    if rle2_len < 600:
        return 3
    if rle2_len < 1200:
        return 4
    if rle2_len < 2400:
        return 5
    return 6


# Huffman refinement passes. The emitter keeps the best snapshot by exact
# emitted size, so more passes can only shrink the output; the first 4 are
# C bzip2's trajectory, which pins the output at or below C's size.
HUFFMAN_ITERS = 8

_iters_override: int | None = None


def huffman_iters() -> int:
    """The refinement pass count: ``set_huffman_iters``'s value, else
    TPUBZ_ITERATIONS, else 8; never below 4."""
    if _iters_override is not None:
        return _iters_override
    v = os.environ.get("TPUBZ_ITERATIONS")
    return max(4, int(v)) if v else HUFFMAN_ITERS


def set_huffman_iters(n: int | None) -> None:
    """Set the refinement pass count (clamped to >= 4); None restores the
    default."""
    global _iters_override
    _iters_override = None if n is None else max(4, int(n))

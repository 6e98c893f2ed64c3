"""A deterministic mixed corpus, made from a seed, for runs of the port.

The ingredients are the kinds of bytes bzip2 users archive: prose, server
logs, fixed-width binary records, already-compressed (random) bytes, a
four-letter alphabet (sequence data) and long runs. They are cut into 1 MiB
pieces and interleaved by weight, so every prefix, and every 900k block,
holds a mix. Nothing is read from the machine: the same seed gives the same
bytes everywhere.
"""
from __future__ import annotations

import numpy as np

PIECE = 1 << 20
# (ingredient, weight): of every 16 pieces, 6 are prose, 3 logs, ...
MIX = (("text", 6), ("logs", 3), ("records", 3), ("random", 2), ("acgt", 1), ("runs", 1))

_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
_LETTER_P = np.array(
    [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
     2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.2, 0.1, 0.1]
)


def _vocab(rng, size=4000):
    lens = rng.integers(1, 11, size)
    p = _LETTER_P / _LETTER_P.sum()
    return [rng.choice(_LETTERS, k, p=p).tobytes() for k in lens]


def _zipf_words(rng, vocab, count):
    w = 1.0 / np.arange(1, len(vocab) + 1)
    return [vocab[i] for i in rng.choice(len(vocab), count, p=w / w.sum())]


def _text(rng, vocab):
    buf = np.frombuffer(b" ".join(_zipf_words(rng, vocab, PIECE // 5)), np.uint8).copy()
    spaces = np.flatnonzero(buf == ord(" "))
    buf[spaces[rng.random(spaces.size) < 1 / 14]] = ord("\n")
    return buf[:PIECE].tobytes()


def _logs(rng, vocab, t0):
    levels = (b"INFO", b"INFO", b"INFO", b"DEBUG", b"WARN", b"ERROR")
    hosts = [b"node%02d" % i for i in range(16)]
    lines, size, t = [], 0, t0
    while size < PIECE:
        t += int(rng.integers(0, 2000))
        msg = b" ".join(_zipf_words(rng, vocab, int(rng.integers(3, 12))))
        line = b"%d.%03d %s %s req=%08x %s\n" % (
            t // 1000, t % 1000, hosts[int(rng.integers(16))],
            levels[int(rng.integers(6))], int(rng.integers(1 << 32)), msg,
        )
        lines.append(line)
        size += len(line)
    return b"".join(lines)[:PIECE], t


def _records(rng, first_id):
    dt = np.dtype([("id", "<u4"), ("ts", "<u8"), ("kind", "u1"), ("qty", "<u2"),
                   ("price", "<f4"), ("flags", "u1")])
    n = PIECE // dt.itemsize + 1
    rec = np.zeros(n, dt)
    rec["id"] = np.arange(first_id, first_id + n)
    rec["ts"] = 1_700_000_000_000 + np.cumsum(rng.integers(0, 50, n))
    rec["kind"] = rng.choice(8, n, p=[0.4, 0.2, 0.1, 0.1, 0.1, 0.05, 0.03, 0.02])
    rec["qty"] = rng.geometric(0.1, n)
    rec["price"] = np.round(rng.lognormal(3, 1, n), 2)
    rec["flags"] = rng.random(n) < 0.05
    return rec.tobytes()[:PIECE], first_id + n


def _runs(rng):
    vals = rng.integers(0, 256, PIECE // 50, dtype=np.uint8)
    return np.repeat(vals, rng.geometric(1 / 100, vals.size)).tobytes()[:PIECE]


def mixed_corpus(mib: int, seed: int) -> bytes:
    """``mib`` MiB of mixed bytes, a function of ``seed`` alone."""
    rng = np.random.default_rng(seed)
    vocab = _vocab(rng)
    order = [name for name, w in MIX for _ in range(w)]
    rng.shuffle(order)
    pieces, t, rid = [], 0, 0
    for i in range(mib):
        kind = order[i % len(order)]
        if kind == "text":
            pieces.append(_text(rng, vocab))
        elif kind == "logs":
            piece, t = _logs(rng, vocab, t)
            pieces.append(piece)
        elif kind == "records":
            piece, rid = _records(rng, rid)
            pieces.append(piece)
        elif kind == "random":
            pieces.append(rng.bytes(PIECE))
        elif kind == "acgt":
            pieces.append(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, PIECE)].tobytes())
        else:
            pieces.append(_runs(rng))
    return b"".join(pieces)


def edge_blocks() -> dict[str, bytes]:
    """Level-9 blocks where divergence hides: a near-periodic block (tie
    classes, the key), a 900k run of one byte (RLE1), and a block that uses
    all 256 byte values and reaches MTF rank 255 (RLE2 symbol 256)."""
    return {
        "near_periodic": b"ab" * 449_000 + b"c",
        "one_byte_run": b"\x07" * 900_000,
        "all256": bytes(range(256)) * 3500,
    }


def sidecar_overflow_block(size: int = 900_000) -> bytes:
    """``size`` bytes of every byte pair (x, y) in order, repeated: its BWT
    column cycles through the alphabet, so that most MTF ranks are 255 and
    the RLE2 symbols >= 256 (65,282 in a level-9 block, 49,860 in a level-1
    block) overflow the compact transfer form's sidecar of 8,192."""
    pairs = np.arange(256, dtype=np.uint8)
    one = np.stack(np.meshgrid(pairs, pairs, indexing="ij"), -1).tobytes()
    return (one * (size // len(one) + 1))[:size]


def with_tied_tail(data: bytes, level: int) -> bytes:
    """data plus a tail of all 256 byte values in order, cut so that the
    stream's last block at ``level`` lies inside the tail and is a whole
    number of its periods: every rotation of that block has 3,000-odd
    equals (at level 9), as a file that ends in padding gives."""
    from .format.constants import block_budget
    from .hostref.rle1 import rle1_blocks

    period = bytes(range(256))
    reps = 4000  # more than one block: the last block starts inside the tail
    while True:
        out = data + period * reps
        _, blocks = rle1_blocks(np.frombuffer(out, np.uint8), block_budget(level))
        o0, o1, i0, _ = blocks[-1]
        whole = (o1 - o0) // 256 * 256  # the tail has no runs: RLE1 leaves it as it is
        if whole and i0 >= len(data):
            return out[: len(out) - ((o1 - o0) - whole)]
        reps += 2

"""The traffic generator: a cell's pool of files, made from ``--seed``.

One generator reads every traffic file (``traffic/<name>.json``). Its
``content`` key picks the kind of bytes:

- ``page_history``: a MediaWiki XML export with full history, as in
  Wikimedia's ``pages-meta-history*.xml.bz2`` dumps. Each page is a run of
  revisions; each revision is the page's text after a few word edits, under
  its own ``<revision>`` header. The pages' sizes (text bytes, revision
  count, edits a revision; the traffic file's assumed ranges, not
  published statistics) are one fixed list, drawn from a constant seed,
  so every ``--seed`` compresses the same set of page shapes; the seed
  picks their order, the vocabulary, the words, where the edits fall and
  the headers' fields.
- ``mixed``: the port's mixed corpus (prose, logs, binary records, random
  bytes, ACGT and runs, 6:3:3:2:1:1), a copy of its arithmetic.

The pool is one stream of ``pool_files * file_bytes`` bytes, cut into
``pool_files`` files of ``file_bytes`` each, as a dump cut into pieces.
Nothing is read from the machine and nothing of the program is imported.
"""
from __future__ import annotations

import numpy as np

# a constant: the list of page shapes is the same for every seed
SHAPE_SEED = 0x5EED_B2
_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
_LETTER_P = np.array(
    [12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0, 2.8, 2.8,
     2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8, 0.2, 0.2, 0.1, 0.1]
)
_B36 = np.frombuffer(b"0123456789abcdefghijklmnopqrstuvwxyz", np.uint8)
# bytes of a revision's XML around its text, for the shape list's estimate
_HEADER_EST = 420


def rng_of(seed: int, salt: int = 0) -> np.random.Generator:
    """The generator of a seed of any size or sign."""
    return np.random.default_rng([seed & (2**64 - 1), salt])


def pool(traffic: dict, seed: int) -> list[bytes]:
    """The cell's files: ``pool_files`` of ``file_bytes`` bytes each."""
    n, size = int(traffic["pool_files"]), int(traffic["file_bytes"])
    content = traffic["content"]
    if content == "page_history":
        stream = page_history(n * size, traffic, seed)
    elif content == "mixed":
        stream = mixed(n * size, seed)
    else:
        raise ValueError(f"unknown content {content!r}")
    if len(stream) < n * size:
        raise RuntimeError(f"generated {len(stream)} bytes of {n * size}")
    return [stream[i * size:(i + 1) * size] for i in range(n)]


# ---------------------------------------------------------------------------
# the vocabulary (the arithmetic of the port's corpus)
# ---------------------------------------------------------------------------

def vocab(rng, size: int) -> list[bytes]:
    """``size`` words of 1-10 letters at English letter frequencies."""
    lens = rng.integers(1, 11, size)
    p = _LETTER_P / _LETTER_P.sum()
    letters = rng.choice(_LETTERS, int(lens.sum()), p=p)
    ends = np.cumsum(lens)
    return [letters[e - k:e].tobytes() for e, k in zip(ends.tolist(), lens.tolist())]


def zipf_p(size: int) -> np.ndarray:
    w = 1.0 / np.arange(1, size + 1)
    return w / w.sum()


# ---------------------------------------------------------------------------
# page history
# ---------------------------------------------------------------------------

def page_shapes(total: int, traffic: dict) -> list[tuple[int, list[int]]]:
    """(text bytes, edits of each revision after the first) of every page of
    a pool of ``total`` bytes, from the constant seed: log-uniform text
    sizes, uniform revision and edit counts, 5% more bytes than the pool
    holds."""
    rng = np.random.default_rng(SHAPE_SEED)
    lo, hi = traffic["page_text_bytes"]
    r_lo, r_hi = traffic["revisions"]
    e_lo, e_hi = traffic["edits"]
    shapes, est = [], 0
    while est < 1.05 * total:
        text = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        revs = int(rng.integers(r_lo, r_hi + 1))
        edits = rng.integers(e_lo, e_hi + 1, revs - 1).tolist()
        shapes.append((text, edits))
        est += revs * (text + _HEADER_EST)
    return shapes


class _Words:
    """Tokens (word id * 2 + newline flag) to bytes: each word followed by a
    space, or by a newline where the flag is set."""

    def __init__(self, words: list[bytes]):
        flat, offs = [], []
        pos = 0
        for w in words:
            for sep in (b" ", b"\n"):
                offs.append(pos)
                flat.append(w + sep)
                pos += len(w) + 1
        self.table = np.frombuffer(b"".join(flat), np.uint8)
        self.offs = np.array(offs, np.int64)
        self.lens = np.array([len(w) + 1 for w in words for _ in (0, 1)], np.int64)

    def render(self, tokens: np.ndarray) -> np.ndarray:
        lens = self.lens[tokens]
        starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
        idx = np.repeat(self.offs[tokens] - starts, lens) + np.arange(int(lens.sum()))
        return self.table[idx]


def _draw(rng, cdf: np.ndarray, count: int) -> np.ndarray:
    """``count`` indices drawn by a cumulative distribution."""
    return np.minimum(np.searchsorted(cdf, rng.random(count), side="right"), cdf.size - 1)


def _tokens(rng, count: int, cdf: np.ndarray, newline_p: float) -> np.ndarray:
    return _draw(rng, cdf, count) * 2 + (rng.random(count) < newline_p)


def page_history(total: int, traffic: dict, seed: int) -> bytes:
    """``total`` bytes or a little more of the export's XML."""
    rng = rng_of(seed)
    words = vocab(rng, int(traffic["vocab"]))
    p = zipf_p(len(words))
    cdf = np.cumsum(p)
    render = _Words(words)
    avg_tok = float((render.lens[::2] * p).sum())
    newline_p = 1.0 / 14
    users = [words[i].capitalize() + b"%d" % int(rng.integers(0, 1000))
             for i in rng.integers(0, len(words), 500).tolist()]
    user_ids = rng.integers(1, 40_000_000, len(users))
    user_cdf = np.cumsum(zipf_p(len(users)))
    shapes = page_shapes(total, traffic)
    order = rng.permutation(len(shapes))

    parts = [b'<mediawiki xmlns="http://www.mediawiki.org/xml/export-0.10/" '
             b'version="0.10" xml:lang="en">\n']
    size = len(parts[0])
    page_id = int(rng.integers(1, 1 << 20))
    rev_id = int(rng.integers(1 << 20, 1 << 28))
    t = int(rng.integers(1_000_000_000, 1_300_000_000))
    for k in order.tolist():
        if size >= total:
            break
        text_bytes, edits = shapes[k]
        page_id += int(rng.integers(1, 50))
        title = b" ".join(words[i].capitalize() for i in _draw(rng, cdf, 2).tolist())
        head = (b"  <page>\n    <title>%s</title>\n    <ns>0</ns>\n    <id>%d</id>\n"
                % (title, page_id))
        parts.append(head)
        size += len(head)
        # every revision's tokens, then one render of the page
        tok = _tokens(rng, max(1, int(text_bytes / avg_tok)), cdf, newline_p)
        revs = [tok]
        for n_edit in edits:
            for _ in range(n_edit):
                at = int(rng.integers(0, tok.size))
                kind = rng.random()
                new = _tokens(rng, 1, cdf, newline_p)
                if kind < 0.6:
                    tok = tok.copy()
                    tok[at] = new[0]
                elif kind < 0.8 or tok.size < 2:
                    tok = np.insert(tok, at, new)
                else:
                    tok = np.delete(tok, at)
            revs.append(tok)
        counts = np.array([r.size for r in revs])
        body = render.render(np.concatenate(revs))
        tok_ends = np.cumsum(render.lens[np.concatenate(revs)])
        ends = tok_ends[np.cumsum(counts) - 1]
        starts = np.concatenate(([0], ends[:-1]))
        sha = _B36[rng.integers(0, 36, (len(revs), 31))]
        parent = 0
        for r in range(len(revs)):
            rev_id += int(rng.integers(1, 5000))
            t += int(rng.integers(60, 3_000_000))
            u = int(_draw(rng, user_cdf, 1)[0])
            text = body[starts[r]:ends[r]].tobytes()
            comment = b" ".join(words[i] for i in _draw(rng, cdf, int(rng.integers(0, 7))).tolist())
            piece = b"".join((
                b"    <revision>\n      <id>%d</id>\n" % rev_id,
                b"      <parentid>%d</parentid>\n" % parent if parent else b"",
                b"      <timestamp>%s</timestamp>\n" % _iso(t),
                b"      <contributor>\n        <username>%s</username>\n        <id>%d</id>\n"
                b"      </contributor>\n" % (users[u], int(user_ids[u])),
                b"      <comment>%s</comment>\n" % comment if comment else b"",
                b"      <model>wikitext</model>\n      <format>text/x-wiki</format>\n",
                b'      <text bytes="%d" xml:space="preserve">' % len(text),
                text,
                b"</text>\n      <sha1>%s</sha1>\n    </revision>\n" % sha[r].tobytes(),
            ))
            parts.append(piece)
            size += len(piece)
            parent = rev_id
        parts.append(b"  </page>\n")
        size += 10
    return b"".join(parts)


def _iso(t: int) -> bytes:
    days, sec = divmod(t, 86400)
    y, m, d = _civil(days)
    return b"%04d-%02d-%02dT%02d:%02d:%02dZ" % (y, m, d, sec // 3600, sec // 60 % 60, sec % 60)


def _civil(days: int) -> tuple[int, int, int]:
    """(year, month, day) of a count of days since 1970-01-01."""
    z = days + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = mp + 3 if mp < 10 else mp - 9
    return yoe + era * 400 + (m <= 2), m, d


# ---------------------------------------------------------------------------
# the mixed corpus
# ---------------------------------------------------------------------------

PIECE = 1 << 20
MIX = (("text", 6), ("logs", 3), ("records", 3), ("random", 2), ("acgt", 1), ("runs", 1))


def _zipf_words(rng, words, p, count):
    return [words[i] for i in rng.choice(len(words), count, p=p)]


def _text(rng, words, p):
    buf = np.frombuffer(b" ".join(_zipf_words(rng, words, p, PIECE // 5)), np.uint8).copy()
    spaces = np.flatnonzero(buf == ord(" "))
    buf[spaces[rng.random(spaces.size) < 1 / 14]] = ord("\n")
    return buf[:PIECE].tobytes()


def _logs(rng, words, p, t0):
    levels = (b"INFO", b"INFO", b"INFO", b"DEBUG", b"WARN", b"ERROR")
    hosts = [b"node%02d" % i for i in range(16)]
    lines, size, t = [], 0, t0
    while size < PIECE:
        t += int(rng.integers(0, 2000))
        msg = b" ".join(_zipf_words(rng, words, p, int(rng.integers(3, 12))))
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


def mixed(total: int, seed: int) -> bytes:
    """``total`` bytes (whole MiB pieces, cut) of the mixed corpus."""
    rng = rng_of(seed)
    words = vocab(rng, 4000)
    p = zipf_p(len(words))
    order = [name for name, w in MIX for _ in range(w)]
    rng.shuffle(order)
    pieces, t, rid = [], 0, 0
    for i in range(-(-total // PIECE)):
        kind = order[i % len(order)]
        if kind == "text":
            pieces.append(_text(rng, words, p))
        elif kind == "logs":
            piece, t = _logs(rng, words, p, t)
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
    return b"".join(pieces)[:total]

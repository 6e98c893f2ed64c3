"""The packing kernel (csrc/bitpack.cu:pack_tiles) and the compact form's
kernel (csrc/compact.cu:compact_rows), emulated in numpy with the kernels'
index math, on the look-back scratch of csrc/look_back.cuh.

Tiles are small (threads x per lanes; a thread's lanes consecutive) and a
look-back window has `window` tiles (the kernels' warp reads 32 x 8 at
once and takes them 32 at a time, nearest first: the same prefix). A call
runs its
tiles as events: each tile's first part (its ticket, the stale status words
it clears, its slice of the words zeroed, its loads, its scan and the
publication of its count) and its second part (the look-back, the inclusive
count, the words or sidecar entries written). Tickets are taken in order;
the second parts run in order, in reverse, or interleaved at random with
the first parts, a second part only once every status word its look-back
reads is published (as the card would wait for it). The emulation holds
the kernels to what their comments claim:

- a tile writes a word only after the word's slice was zeroed, by itself or
  by a tile whose publication its look-back read (directly, or through an
  inclusive count published after a look-back that read it), and a slice is
  never zeroed after a word in it was written;
- a word stored whole has one writer; the others are ORed, by the two tiles
  that share them;
- every sidecar entry is written once: below the count by its tile, past it
  by the row's last tile;
- after a call the ticket is 0 and every status word is this call's (its
  epoch) or 0, whatever the scratch held before;
- a thread loads 16-byte vectors only at 16-byte boundaries, and only the
  threads at an array's ends load lane by lane; compact's byte stores are
  as wide as the row's alignment allows.
"""
from __future__ import annotations

import numpy as np

MASK = 0xFFFFFFFF
EPOCH_SHIFT = 38
EPOCH_MAX = (1 << 26) - 1
VALUE = (1 << 36) - 1
FLAGS = 3 << 36
AGGREGATE = 1 << 36
INCLUSIVE = 2 << 36
GARBAGE = 0xDEADBEEF
SHIFT_MAX = 7


def status_word(epoch, flag, value):
    assert 0 <= value <= VALUE and 1 <= epoch <= EPOCH_MAX
    return epoch << EPOCH_SHIFT | flag | value


class Scratch:
    """csrc/look_back.cuh's scratch and kernels/look_back.py's record of it:
    the ticket, `capacity` status words (zeroed once), the last call's epoch
    and its status words (dirty)."""

    def __init__(self, capacity, epoch=0):
        self.ticket = 0
        self.status = [0] * capacity
        self.capacity = capacity
        self.epoch = epoch
        self.dirty = 0

    def begin(self, words):
        """A call's epoch and the previous call's words (enqueue's order)."""
        assert words <= self.capacity
        epoch = self.epoch % EPOCH_MAX + 1
        dirty = self.dirty
        self.epoch, self.dirty = epoch, words
        return epoch, dirty

    def take_ticket(self, ctas):
        """atomicInc(ticket, ctas - 1)."""
        t = self.ticket
        self.ticket = 0 if t >= ctas - 1 else t + 1
        return t

    def clear_stale(self, start, dirty):
        for i in range(start, dirty):
            self.status[i] = 0

    def check_after(self, epoch, published):
        """Every word this call's (published) or 0, and the ticket 0."""
        assert self.ticket == 0, "the ticket did not come back to 0"
        for i, w in enumerate(self.status):
            if i in published:
                assert w >> EPOCH_SHIFT == epoch and w & FLAGS == INCLUSIVE, i
            else:
                assert w == 0, f"status word {i} left at {w:#x}"


def look_back(status, tile, epoch, window):
    """warp_look_back: lane l reads tile t0 - l (before tile 0: an inclusive
    0); the window waits until each is published; the nearest inclusive
    count ends it, with the counts up to it. Returns (the count of the tiles
    before, the tiles whose words were read) or None when a word is not yet
    published."""
    total, read, t0 = 0, [], tile - 1
    while True:
        srcs = [t0 - lane for lane in range(window)]
        words = [status_word(epoch, INCLUSIVE, 0) if s < 0 else status[s] for s in srcs]
        if any(w >> EPOCH_SHIFT != epoch for w in words):
            return None
        incl = [w & FLAGS == INCLUSIVE for w in words]
        k = incl.index(True) if any(incl) else window - 1
        total += sum(w & VALUE for w in words[: k + 1])
        read += [s for s in srcs[: k + 1] if s >= 0]
        if any(incl):
            return total, read
        t0 -= window


def _schedule(n_tiles, order, rng):
    """The events of a call: ("A", tile) in ticket order and ("B", tile),
    as a list of candidates the runner takes in turn (a "B" it cannot run
    yet waits)."""
    firsts = [("A", t) for t in range(n_tiles)]
    if order == "in_order":
        return firsts + [("B", t) for t in range(n_tiles)]
    if order == "reverse":
        return firsts + [("B", t) for t in range(n_tiles - 1, -1, -1)]
    seconds = [("B", t) for t in rng.permutation(n_tiles)]
    merged, a, b = [], 0, 0
    while a < len(firsts) or b < len(seconds):
        if b == len(seconds) or (a < len(firsts) and rng.random() < 0.5):
            merged.append(firsts[a])
            a += 1
        else:
            merged.append(seconds[b])
            b += 1
    return merged


def _run(events, first, second):
    """Run the events: first(t) at once, second(t) when it returns True;
    the ones that cannot run yet are retried after the next event."""
    waiting = []
    for kind, t in events:
        if kind == "A":
            first(t)
        else:
            waiting.append(t)
        progress = True
        while progress:
            progress = False
            for u in list(waiting):
                if second(u):
                    waiting.remove(u)
                    progress = True
    assert not waiting, "a look-back waited for a tile that never published"


def emulate_pack(fields, m, out_words, *, threads, per, vec, shift=0, bits_shift=None,
                 length=None, scratch, window=32, order="random", seed=0):
    """csrc/bitpack.cu:pack_tiles on `fields(i) -> (value, bits)` of lanes
    i < m (the array form), or of the stream's `length` lanes (the payload
    form: lanes at or past it are fields of 0 bits, and its tiles past the
    stream load no tables). `vec`: lanes a 16-byte vector; `shift` the lanes
    the primary array starts past a 16-byte boundary (< vec), `bits_shift`
    the lengths' (the array form). Returns (words, total, info)."""
    tile_lanes = threads * per
    slice_words = tile_lanes  # a field is at most 32 bits
    assert per % vec == 0 and 0 <= shift < vec
    payload = length is not None
    n = min(max(length, 0), m) if payload else m
    lane_tiles = -(-(m + shift) // tile_lanes)
    ctas = max(lane_tiles, -(-out_words // slice_words))
    stream_tiles = -(-(n + shift) // tile_lanes) if n > 0 else 0
    rng = np.random.default_rng(seed)
    epoch, dirty = scratch.begin(-(-(m + SHIFT_MAX) // tile_lanes))
    status = scratch.status

    words = [GARBAGE] * out_words
    zeroed = [False] * out_words
    plain_writers = [[] for _ in range(out_words)]
    or_writers = [[] for _ in range(out_words)]
    tickets = {}
    state = {}
    sees = {}  # the tiles whose zeroing each inclusive count carries
    total = [None]
    info = {"tables_loaded": 0, "vector_loads": 0, "lane_loads": 0, "read": {}}

    def load(base, k_shift):
        """One thread's lanes: by vector when the thread's lanes lie in the
        array; its vector at a 16-byte boundary."""
        if base >= 0 and base + per <= n:
            assert (base + shift) % vec == 0, "a vector load off a 16-byte boundary"
            info["vector_loads"] += 1
            if k_shift is not None and (base + k_shift) % vec:
                info["lane_loads"] += 1  # the lengths, lane by lane
        elif base < n and base + per > 0:
            info["lane_loads"] += 1
        return [fields(i) if 0 <= i < n else (0, 0) for i in range(base, base + per)]

    def first(c):
        tile = scratch.take_ticket(ctas)
        tickets[c] = tile
        lo = tile * slice_words
        for w in range(lo, min(lo + slice_words, out_words)):
            assert not plain_writers[w] and not or_writers[w], "a slice zeroed after a write"
            words[w], zeroed[w] = 0, True
        # clear_stale, spread over the CTAs: this CTA's share
        for i in range(stream_tiles + tile * threads, dirty, ctas * threads):
            for j in range(i, min(i + threads, dirty)):
                status[j] = 0
        if tile >= stream_tiles:
            if tile == 0:
                total[0] = 0
            return
        if payload:
            info["tables_loaded"] += 1
        loaded = [load(tile * tile_lanes + th * per - shift, None if payload else bits_shift)
                  for th in range(threads)]
        sums = [sum(min(max(b, 0), 32) for _, b in f) for f in loaded]
        offs = np.concatenate(([0], np.cumsum(sums)[:-1])).astype(int)
        tile_bits = int(sum(sums))
        status[tile] = status_word(epoch, INCLUSIVE if tile == 0 else AGGREGATE, tile_bits)
        sees[("agg", tile)] = {tile}
        if tile == 0:
            sees[("incl", 0)] = {0}
        # the tile's words, counted from its first bit (shared memory): one
        # OR a field's word
        nw = (tile_bits + 31) >> 5
        s_words = [0] * (nw + 1)
        for th in range(threads):
            pos = int(offs[th])
            for v, b in loaded[th]:
                b = min(max(b, 0), 32)
                wi, end = pos >> 5, (pos & 31) + b
                if b:
                    s_words[wi] |= (v << (32 - end)) & MASK if end <= 32 else v >> (end - 32)
                    if end > 32:
                        s_words[wi + 1] |= (v << (64 - end)) & MASK
                pos += b
        state[tile] = (tile_bits, s_words)

    def second(c):
        if c not in tickets:
            return False
        tile = tickets[c]
        if tile not in state:
            return True  # past the stream: no second part
        tile_bits, s_words = state[tile]
        seen = {tile}
        before = 0
        if tile > 0:
            found = look_back(status, tile, epoch, window)
            if found is None:
                return False
            before, read = found
            info["read"][tile] = tile - min(read)
            for s in read:
                w = status[s]
                seen |= sees[("incl", s)] if w & FLAGS == INCLUSIVE else sees[("agg", s)]
            status[tile] = status_word(epoch, INCLUSIVE, before + tile_bits)
            sees[("incl", tile)] = seen
        if tile == stream_tiles - 1:
            assert total[0] is None
            total[0] = before + tile_bits
        r, w0 = before & 31, before >> 5
        nout = (r + tile_bits + 31) >> 5 if tile_bits else 0
        for j in range(nout):
            gw = w0 + j
            if gw >= out_words:
                break
            x = ((s_words[j] >> r) | ((s_words[j - 1] << (32 - r)) & MASK if j else 0)) if r \
                else s_words[j]
            assert zeroed[gw] and gw // slice_words in seen, \
                f"tile {tile} wrote word {gw} before it saw its slice zeroed"
            shared = (j == 0 and r) or (j == nout - 1 and (r + tile_bits) & 31)
            if shared:
                if x:
                    words[gw] |= x
                    or_writers[gw].append(tile)
            else:
                words[gw] = x
                plain_writers[gw].append(tile)
        return True

    _run(_schedule(ctas, order, rng), first, second)
    for w in range(out_words):
        assert zeroed[w], f"word {w} never zeroed"
        assert len(plain_writers[w]) <= 1 and not (plain_writers[w] and or_writers[w]), w
        assert len(set(or_writers[w])) == len(or_writers[w]), w
    scratch.check_after(epoch, set(range(stream_tiles)))
    info.update(stream_tiles=stream_tiles, ctas=ctas)
    return np.array(words, np.uint32), total[0], info


def store_width(at):
    """compact's stores of a thread's bytes at byte address `at`: words of
    the widest of 16, 8 and 4 bytes it is aligned to, else byte by byte."""
    for width in (16, 8, 4):
        if at % width == 0:
            return width
    return 1


def emulate_compact(syms, lengths, *, threads, per=32, sym_offset=0, scratch, window=32,
                    order="random", seed=0, hi_cap=8192):
    """csrc/compact.cu:compact_rows on uint16 rows syms[B, OUT] that start
    at element `sym_offset` of their buffer (a row's shift: the elements it
    starts past a 16-byte boundary), the bytes written to a 16-byte aligned
    buffer. Tiles of threads x per symbols (the kernel's 32 a thread), one
    ticket counter for the call (ticket = row * tiles + tile). Returns
    (syms_u8, hi_packed, hi_count, info)."""
    assert per % 8 == 0
    B, out = syms.shape
    tile_lanes = threads * per
    tiles = -(-(out + SHIFT_MAX) // tile_lanes)
    ctas = B * tiles
    rng = np.random.default_rng(seed)
    epoch, dirty = scratch.begin(ctas)
    status = scratch.status

    u8 = np.full((B, out), 0xAB, np.int64)
    u8_writes = np.zeros((B, out), np.int64)
    hi = np.full((B, hi_cap), GARBAGE, np.int64)
    hi_writes = np.zeros((B, hi_cap), np.int64)
    count = np.full(B, -1, np.int64)
    tickets, state = {}, {}
    info = {"store_widths": {}, "vector_loads": 0, "lane_loads": 0}

    def first(c):
        ticket = scratch.take_ticket(ctas)
        tickets[c] = ticket
        row, tile = divmod(ticket, tiles)
        for i in range(ctas + ticket * threads, dirty, ctas * threads):
            for j in range(i, min(i + threads, dirty)):
                status[j] = 0
        shift = (sym_offset + row * out) % 8
        row_tiles = -(-(out + shift) // tile_lanes)
        if tile >= row_tiles:
            status[row * tiles + tile] = 0
            return
        n = min(max(int(lengths[row]), 0), out)
        flags, lanes = [], []
        for th in range(threads):
            base = tile * tile_lanes + th * per - shift
            whole = base >= 0 and base + per <= out
            if whole:
                assert (sym_offset + row * out + base) % 8 == 0, "a load off a 16-byte boundary"
                info["vector_loads"] += 1
                width = store_width(row * out + base)
                info["store_widths"][width] = info["store_widths"].get(width, 0) + 1
            elif base < out and base + per > 0:
                info["lane_loads"] += 1
            s = [int(syms[row, i]) if 0 <= i < out else 0 for i in range(base, base + per)]
            for k, i in enumerate(range(base, base + per)):
                if 0 <= i < out:
                    u8[row, i] = s[k] & 0xFF
                    u8_writes[row, i] += 1
            flags.append(sum(1 for k in range(per) if base + k < n and s[k] >= 256))
            lanes.append((base, s))
        tile_flags = sum(flags)
        status[row * tiles + tile] = status_word(
            epoch, INCLUSIVE if tile == 0 else AGGREGATE, tile_flags)
        state[ticket] = (row, tile, row_tiles, n, tile_flags, np.cumsum([0] + flags[:-1]), lanes)

    def second(c):
        if c not in tickets:
            return False
        ticket = tickets[c]
        if ticket not in state:
            return True
        row, tile, row_tiles, n, tile_flags, ranks, lanes = state[ticket]
        before = 0
        if tile > 0:
            found = look_back(status[row * tiles:(row + 1) * tiles], tile, epoch, window)
            if found is None:
                return False
            before = found[0]
            status[row * tiles + tile] = status_word(epoch, INCLUSIVE, before + tile_flags)
        for (base, s), rank in zip(lanes, ranks):
            rank += before
            for k in range(per):
                i = base + k
                if i < n and s[k] >= 256:
                    if rank < hi_cap:
                        hi[row, rank] = (i << 1) | (s[k] - 256)
                        hi_writes[row, rank] += 1
                    rank += 1
        if tile == row_tiles - 1:
            total = before + tile_flags
            count[row] = total
            for j in range(min(total, hi_cap), hi_cap):
                hi[row, j] = 0
                hi_writes[row, j] += 1
        return True

    _run(_schedule(ctas, order, rng), first, second)
    assert (u8_writes == 1).all(), "a byte written twice or never"
    assert (hi_writes == 1).all(), "a sidecar entry written twice or never"
    assert (count >= 0).all()
    scratch.check_after(epoch, set(state))
    return u8, hi, count, info

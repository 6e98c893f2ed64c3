"""The radix sort's and the BWT's kernels (csrc/radix.cuh, csrc/radix.cu,
csrc/bwt.cu) emulated in numpy, CTA by CTA, with their index math.

The CUDA kernels run only on the card. Here every CTA of a launch is a
generator that yields where the kernel may wait for another CTA (after it
takes its tile ticket, after it publishes its aggregates, at each spin of
the look-back), and ``run_grid`` steps the live CTAs in a random order, so
tickets, early aggregates and look-back chains interleave as they may on
the card. Warps, lanes and the keys a thread holds are parameters
(``Shape``), so that small tiles (16-64 keys) and 4-bit digits make classes
and digit runs cross many tiles; the card's are 8 warps of 32 lanes, 16 keys
a thread and 8-bit digits. The BWT's rounds run as the card's graph runs
them: one body a round over every row, the loop's condition set by its last
kernel, the shared-memory sort of the small classes in chunks of twice the
radix tile.
"""
from dataclasses import dataclass, field

import numpy as np

# csrc/radix.cuh's status words
COUNT_BITS = 21
COUNT_MASK = (1 << COUNT_BITS) - 1
AGGREGATE = 1 << COUNT_BITS
INCLUSIVE = 2 << COUNT_BITS
FLAG_MASK = 3 << COUNT_BITS
TAG_SHIFT = 23
LOOK_BACK = 8  # status words a look-back step reads at once
MAX_PASSES = 8  # the card's tag stride: 63 bits in 8-bit digits
# csrc/bwt.cu's
MAX_LOG2 = 20
POS_MASK = (1 << MAX_LOG2) - 1
KEY_LO, KEY_HI = 20, 60
SEED_BYTES = 5
MAX_ROUNDS = 24
# the graph body's kernels, in the order of their launch counts
BODY = ("bwt_keys", "bwt_pass", "bwt_small_sort", "bwt_rank_tiles", "bwt_rank_scan",
        "bwt_rank_apply", "bwt_round_end")
KEYS_K, PASS_K, SMALL_K, TILES_K, SCAN_K, APPLY_K, END_K = range(len(BODY))
# a row's record: rounds, active rotations sorted, skipped passes, cap
# error, sorts (rounds whose large list was not empty), passes run, then
# each body kernel's launches (row 0's words; 0 in the other rows)
PINNED_RECORD = 6
PINNED_HEAD = PINNED_RECORD + len(BODY)
PINNED_PER_ROUND = 4  # next active count, classes, split, next large count


def tag_of(rnd: int, p: int, stride: int = MAX_PASSES) -> int:
    return 1 + rnd * stride + p


def passes_of(lo: int, hi: int, digit_bits: int) -> list:
    """(shift, width) per pass, as enqueue_passes computes them."""
    return [(s, min(digit_bits, hi - s)) for s in range(lo, hi, digit_bits)]


@dataclass(frozen=True)
class Shape:
    """A launch shape: a radix CTA has `warps` warps of `lanes` lanes, each
    thread `per` keys; a re-rank CTA `rank_threads` threads of `rank_per`
    sorted keys; digits of `digit_bits`."""
    warps: int = 2
    lanes: int = 8
    per: int = 2
    digit_bits: int = 4
    rank_threads: int = 8
    rank_per: int = 4

    @property
    def threads(self):
        return self.warps * self.lanes

    @property
    def tile(self):
        return self.threads * self.per

    @property
    def rank_tile(self):
        return self.rank_threads * self.rank_per

    @property
    def count_max(self):
        """The largest class of a chunk that the shared-memory sort places by
        counting (the card's: 64, of a 4096-key tile); above it, passes."""
        return self.tile // 8

    @property
    def max_passes(self):
        """The tag stride and ticket words a round: 63 bits in these digits
        (the card's 8 covers its 8-bit digits)."""
        return max(MAX_PASSES, -(-63 // self.digit_bits))

    def tiles(self, n):
        return -(-n // self.tile)


@dataclass
class Log:
    """What the launches did: tickets taken per pass, CTAs that had work and
    CTAs launched, look-back spins and steps, passes skipped."""
    tickets: list = field(default_factory=list)
    working: list = field(default_factory=list)
    launched: list = field(default_factory=list)
    spins: int = 0
    lookback_steps: int = 0
    skips: int = 0


def run_grid(ctas, rng, resident: int = 6) -> None:
    """Step the CTAs' generators in a random order until all return, at most
    `resident` of them started and unfinished at a time (the card's
    residency), the rest started in a random order as places free. A CTA
    takes its ticket at its first step, so the CTAs holding tickets below a
    spinning tile are resident: the grid always finishes."""
    pending = [ctas[i] for i in rng.permutation(len(ctas))]
    live = []
    steps = 0
    while live or pending:
        while pending and len(live) < resident:
            live.append(pending.pop())
        i = int(rng.integers(len(live)))
        try:
            next(live[i])
        except StopIteration:
            live.pop(i)
        steps += 1
        assert steps < 10_000_000, "the grid did not finish"


def _digit(keys, shift, width):
    return (keys >> shift) & ((1 << width) - 1)


def _hist_add(hist_row, digits, valid):
    """hist_add: one shared atomic a valid key and digit (order-free)."""
    np.add.at(hist_row, digits[valid], 1)


def _rank_warp(digits, valid, counters):
    """A warp's ranking of one row of lanes (digit_peers: the lanes with an
    equal digit; the lowest of them advances the warp's counter): each
    valid lane's index among the warp's keys of its digit so far, in lane
    order. digits, valid: (lanes,); counters: the warp's, updated."""
    peers = (digits[:, None] == digits[None, :]) & valid[None, :]
    below = np.tri(len(digits), len(digits), -1, dtype=bool)  # [lane, l]: l < lane
    prior = np.where(valid, counters[np.maximum(digits, 0)], 0)
    pos = prior + (peers & below).sum(1)
    lead = valid & (np.argmax(peers, axis=1) == np.arange(len(digits)))
    for lane in np.nonzero(lead)[0]:
        counters[digits[lane]] = prior[lane] + peers[lane].sum()
    return pos


def histogram_cta(bid, keys_of, m, shape, lo, hi, hist, log):
    """A CTA of radix_histogram / bwt_keys: keys_of(q) gives the keys of the
    indices q (and, for bwt_keys, writes them out)."""
    base = bid * shape.tile
    if base >= m:
        return
        yield  # a generator that does nothing
    log.working[-1] += 1
    D = shape.digit_bits
    s_hist = np.zeros((shape.max_passes, 1 << D), np.int64)
    for j in range(shape.per):
        q = base + j * shape.threads + np.arange(shape.threads)
        valid = q < m
        key = np.zeros(shape.threads, np.int64)
        key[valid] = keys_of(q[valid])
        for p, (shift, width) in enumerate(passes_of(lo, hi, D)):
            d = np.where(valid, _digit(key, shift, width), -1)
            _hist_add(s_hist[p], d, valid)
    yield
    hist += s_hist[: hist.shape[0]]


def pass_cta(bid, a, shape, log):
    """A CTA of radix_pass. a: the PassArgs, as a dict."""
    m = a["m"]
    T, W, L, K = shape.tile, shape.warps, shape.lanes, shape.per
    if bid >= shape.tiles(m):
        return
        yield
    log.working[-1] += 1
    tile = int(a["tickets"][a["pass"]])
    a["tickets"][a["pass"]] += 1
    log.tickets[-1].append(tile)
    yield
    bins = 1 << shape.digit_bits
    status, tag, shift, width = a["status"], a["tag"], a["shift"], a["width"]
    base = tile * T
    count = min(T, m - base)
    # warp w's tile indices (w * K + j) * L + lane
    x = (np.arange(W)[:, None, None] * K + np.arange(K)[None, :, None]) * L + np.arange(L)
    valid = x < count
    key = np.zeros((W, K, L), np.int64)
    key[valid] = a["in"][base + x[valid]]
    d = np.where(valid, _digit(key, shift, width), -1)
    warp = np.zeros((W, bins), np.int64)
    pos = np.zeros((W, K, L), np.int64)
    for w in range(W):
        for j in range(K):
            pos[w, j] = _rank_warp(d[w, j], valid[w, j], warp[w])
    total = warp.sum(0)
    warp_before = np.cumsum(warp, 0) - warp  # in place on the card
    for b in range(bins):
        status[tile * bins + b] = (tag << TAG_SHIFT) | (INCLUSIVE if tile == 0 else AGGREGATE) | int(total[b])
    yield
    before = np.zeros(bins, np.int64)
    for b in range(bins):
        excl, t = 0, tile - 1
        while t >= 0:
            # LOOK_BACK words read at once; the walk goes on from the first
            # not yet published, or past the batch
            words = [int(status[(t - k) * bins + b]) for k in range(min(LOOK_BACK, t + 1))]
            done = False
            for k, word in enumerate(words):
                if word >> TAG_SHIFT != tag or word & FLAG_MASK == 0:
                    log.spins += 1
                    break
                log.lookback_steps += 1
                excl += word & COUNT_MASK
                if word & FLAG_MASK == INCLUSIVE:
                    done = True
                    break
            else:
                k = len(words)
            if done:
                break
            t -= k
            yield
        if tile > 0:
            status[tile * bins + b] = (tag << TAG_SHIFT) | INCLUSIVE | (excl + int(total[b]))
        before[b] = excl
    # each thread owns bins_per consecutive digits: a CTA scan of the
    # threads' sums, then a running sum over its own
    per_t = max(bins // shape.threads, 1)
    hist = a["hist"]

    def scan_owned(v):
        sums = v.reshape(-1, per_t).sum(1)
        start = np.cumsum(sums) - sums
        return (start[:, None] + np.cumsum(v.reshape(-1, per_t), 1) - v.reshape(-1, per_t)).ravel()

    hstart, tstart = scan_owned(hist), scan_owned(total)
    delta = hstart + before - tstart
    w_idx = np.broadcast_to(np.arange(W)[:, None, None], x.shape)
    pos[valid] += tstart[d[valid]] + warp_before[w_idx[valid], d[valid]]
    smem = np.full(T, -1, np.int64)
    smem[pos[valid]] = key[valid]
    assert (smem[:count] >= 0).all() and (smem[count:] == -1).all()
    out_at = np.arange(count) + delta[_digit(smem[:count], shift, width)]
    a["out"][out_at] = smem[:count]


def emulate_sort(keys, lo, hi, shape, rng, log=None, status=None, tickets=None, rnd=0, m=None,
                 grid_n=None, hist=None, bufs=None, key_src=None):
    """tpubz_radix_sort (or the passes of a BWT round): returns the sorted
    keys. By default a standalone call: status and tickets zeroed, the
    histogram launch of its own over `keys`."""
    D = shape.digit_bits
    bins = 1 << D
    n = keys.shape[0] if m is None else m
    grid_n = n if grid_n is None else grid_n
    log = Log() if log is None else log
    plist = passes_of(lo, hi, D)
    P = len(plist)
    if status is None:
        status = np.zeros(shape.tiles(grid_n) * bins, np.int64)
        tickets = np.zeros(shape.max_passes, np.int64)
    if hist is None:
        hist = np.zeros((P, bins), np.int64)
        log.working.append(0)
        log.launched.append(shape.tiles(grid_n))
        run_grid([histogram_cta(b, lambda q: keys[q], n, shape, lo, hi, hist, log)
                  for b in range(shape.tiles(grid_n))], rng)
    if bufs is None:
        bufs = [np.full(max(grid_n, 1), -5, np.int64), np.full(max(grid_n, 1), -5, np.int64)]
    src = keys
    for p, (shift, width) in enumerate(plist):
        dst = bufs[(P - 1 - p) & 1]
        a = {"in": src, "out": dst, "shift": shift, "width": width, "hist": hist[p],
             "status": status, "tickets": tickets, "pass": p,
             "tag": tag_of(rnd, p, shape.max_passes), "m": n}
        log.tickets.append([])
        log.working.append(0)
        log.launched.append(shape.tiles(grid_n))
        run_grid([pass_cta(b, a, shape, log) for b in range(shape.tiles(grid_n))], rng)
        assert sorted(log.tickets[-1]) == list(range(shape.tiles(n)))
        src = dst
    return bufs[0][:n]


# ------------------------------------------------------------------ the BWT


def _wrap(i, k, n):
    """(i + k) mod n for 0 <= i < n, 0 <= k < n, as the kernels write it."""
    assert 0 <= k < n
    j = i + k
    return np.where(j >= n, j - n, j)


def seed_key(block, i):
    """bwt_keys' round-0 key of rotation i."""
    n = block.size
    packed, j = 0, int(i)
    for _ in range(SEED_BYTES):
        packed = (packed << 8) | int(block[j])
        j = 0 if j + 1 == n else j + 1
    return (packed << MAX_LOG2) | int(i)


def load_flags(skey, base, m, rnd, per, ml):
    """load_flags: head, class start and active of one thread's keys (m in
    all, the large list's first ml: key ml is a head and a class start)."""
    gshift = 2 * MAX_LOG2 if rnd > 0 else 63
    idx = base + np.arange(per)
    ok = idx < m
    key = np.where(ok, skey[np.minimum(idx, max(m - 1, 0))], 0)
    prev = np.concatenate([[skey[base - 1] if 0 < base <= m else 0], key[:-1]])
    head = ok & ((idx == 0) | (idx == ml) | ((key >> KEY_LO) != (prev >> KEY_LO)))
    start = ok & ((idx == 0) | (idx == ml) | ((key >> gshift) != (prev >> gshift)))
    if base + per < m:
        head_next = base + per == ml or (skey[base + per] >> KEY_LO) != (key[-1] >> KEY_LO)
    else:
        head_next = True
    nxt = np.concatenate([(idx[1:] >= m) | head[1:], [head_next]])
    active = ok & ~(head & nxt)
    return key, head, start, active


NONE = 0x7FFFFFFF  # no head: the first head's identity under min


class Row:
    """One row's scratch as the card keeps it: torch.empty garbage where the
    call does not zero, the zeroed words where it does."""

    def __init__(self, c: bytes, shape: "Shape", cap: int, min_n: int, slots: int, index: int):
        self.index = index  # the row's grid index y
        self.block = np.frombuffer(c, np.uint8)
        n = self.n = self.block.size
        self.cap = cap
        self.live_ever = n >= min_n and n >= 1
        m = max(n, 1)
        bins = 1 << shape.digit_bits
        P = len(passes_of(KEY_LO, KEY_HI, shape.digit_bits))
        self.keys = [np.full(m, -3, np.int64), np.full(m, -3, np.int64)]
        self.rank = np.full(m, -7, np.int64)
        self.sa = np.full(m, -7, np.int64)
        self.act_large = [np.full(m, -9, np.int64), np.full(m, -9, np.int64)]
        self.act_small = [np.full(m, -9, np.int64), np.full(m, -9, np.int64)]
        self.chunk = np.full(m // shape.tile + 2, -13, np.int64)
        self.agg = np.full((6, -(-m // shape.rank_tile)), -11, np.int64)
        self.scan = None  # bwt_rank_scan's per-tile words
        # the rank of each large class by ordinal, a table a round parity
        self.table = [np.full(256, -17, np.int64), np.full(256, -17, np.int64)]
        # the words zeroed once per call
        self.m_large = np.zeros(MAX_ROUNDS + 1, np.int64)
        self.m_small = np.zeros(MAX_ROUNDS + 1, np.int64)
        self.done = np.zeros(MAX_ROUNDS, np.int64)
        self.sel = np.zeros((MAX_ROUNDS, shape.max_passes + 1), np.int64)
        self.finished = self.rounds = self.active = self.skipped = self.error = 0
        self.sorts = self.passes_run = 0
        self.launched = np.zeros(len(BODY), np.int64)  # row 0's: each body kernel's launches
        # every row's at the longest row's size and round cap (one stride)
        self.tickets = np.zeros((slots, shape.max_passes), np.int64)
        self.hist = np.zeros((slots, P, bins), np.int64)
        self.status = np.zeros(shape.tiles(m) * bins, np.int64)
        self.pinned = np.full(PINNED_HEAD + PINNED_PER_ROUND * MAX_ROUNDS, -99, np.int64)

    def live(self, R):
        return self.live_ever and not self.finished and R < self.cap

    def lists(self, R):
        """(m_large, m_small) of round R (round 0: all n rotations, one class)."""
        if not self.live(R):
            return 0, 0
        return (self.n, 0) if R == 0 else (int(self.m_large[R]), int(self.m_small[R]))

    def snapshot(self):
        return [x.copy() for x in (self.keys[0], self.keys[1], self.rank, self.sa,
                                   self.act_large[0], self.act_large[1], self.act_small[0],
                                   self.act_small[1], self.chunk, self.agg, self.table[0],
                                   self.table[1], self.m_large,
                                   self.m_small, self.done, self.sel, self.tickets, self.hist,
                                   self.status, self.pinned)]


def count_launch(row, bid, k):
    """CTA (0, 0) of body kernel k counts the launch in row 0's words, before
    any gate."""
    if bid == 0 and row.index == 0:
        row.launched[k] += 1


def keys_cta(bid, row, R, shape, log):
    """bwt_keys: the large list's keys (all n rotations in round 0) into key
    buffer 0, and the round's histogram; a later round's key carries its
    class's ordinal in bits 40-47."""
    count_launch(row, bid, KEYS_K)
    m, _ = row.lists(R)
    n = row.n
    if bid == 0 and m > 0:
        row.sorts += 1

    def keys_of(q):
        h = (SEED_BYTES << (R - 1)) % n if R > 0 else 0
        if R == 0:
            k = np.array([seed_key(row.block, i) for i in q], np.int64)
        else:  # the large list's entry: i | its class's ordinal << 20
            e = row.act_large[R & 1][q]
            i = e & POS_MASK
            k = ((e >> MAX_LOG2) << (2 * MAX_LOG2)) | (row.rank[_wrap(i, h, n)] << MAX_LOG2) | i
        row.keys[0][q] = k
        return k

    yield from histogram_cta(bid, keys_of, m, shape, KEY_LO, KEY_HI, row.hist[R], log)


def bwt_pass_cta(bid, row, R, p, shape, log):
    """bwt_pass: pass p of the large list's sort, from the buffer sel[p]
    names into the other, or skipped when one digit holds every key."""
    count_launch(row, bid, PASS_K)
    m, _ = row.lists(R)
    if bid >= shape.tiles(m):
        return
        yield
    frm = int(row.sel[R, p])
    skip = bool((row.hist[R, p] == m).any())
    if bid == 0:
        row.sel[R, p + 1] = frm if skip else 1 - frm
        row.skipped += int(skip)
        row.passes_run += int(not skip)
    if skip:
        log.skips += 1
        return
    shift, width = passes_of(KEY_LO, KEY_HI, shape.digit_bits)[p]
    a = {"in": row.keys[frm], "out": row.keys[1 - frm], "shift": shift, "width": width,
         "hist": row.hist[R, p], "status": row.status, "tickets": row.tickets[R], "pass": p,
         "tag": tag_of(R, p, shape.max_passes), "m": m}
    yield from pass_cta(bid, a, shape, log)


# the shared-memory sort's passes over the chunk's local key (class start
# in the chunk << 40 | rank[(i + h) mod n] << 20 | i): the card's digits
SMALL_PASSES = [(20, 8), (28, 8), (36, 8), (44, 9)]
LOW40 = (1 << 40) - 1


def small_sort_cta(k, row, R, shape, log):
    """bwt_small_sort: chunk k of the small list, in shared memory, by warps
    of `lanes` lanes, each lane `per` keys (2 * warps warps: a chunk holds
    up to twice the tile)."""
    count_launch(row, k, SMALL_K)
    ml, ms = row.lists(R)
    T = shape.tile
    chunks = -(-ms // T)
    if k >= chunks:
        return
        yield
    log["small_working"][-1] += 1
    n = row.n
    h = (SEED_BYTES << (R - 1)) % n
    begin = int(row.chunk[k])
    cnt = (int(row.chunk[k + 1]) if k + 1 < chunks else ms) - begin
    W, L, K = 2 * shape.warps, shape.lanes, shape.per
    cap = W * L * K
    assert 0 <= cnt <= min(cap, 2 * T - 1)
    log["small_counts"][-1].append(cnt)
    i = row.act_small[R & 1][begin:begin + cnt]
    g = row.rank[i]
    r2 = row.rank[_wrap(i, h, n)] if cnt else i
    starts = np.r_[True, g[1:] != g[:-1]][:cnt]
    cs = np.maximum.accumulate(np.where(starts, np.arange(cnt), -1)) if cnt else starts
    smem = (cs.astype(np.int64) << 40) | (r2 << MAX_LOG2) | i
    yield  # a CTA of the grid in any order: its chunk is its own
    out = row.keys[int(row.sel[R, len(passes_of(KEY_LO, KEY_HI, shape.digit_bits))])]
    if cnt and (np.arange(cnt) - cs + 1).max() <= shape.count_max:
        # each key's place: the keys of its class before it by (r2, entry)
        log["small_counted"] += 1
        for x in range(cnt):
            first, before = int(cs[x]), 0
            for y in range(first, cnt):
                if cs[y] != first:
                    break
                before += (r2[y], y) < (r2[x], x)
            out[ml + begin + first + before] = (int(g[x]) << 40) | int(smem[x] & LOW40)
        return
    per = -(-cnt // (W * L))  # the chunk spread over every warp
    x = (np.arange(W)[:, None, None] * per + np.arange(per)[None, :, None]) * L + np.arange(L)
    valid = x < cnt
    for shift, width in SMALL_PASSES:
        key = np.zeros((W, per, L), np.int64)
        key[valid] = smem[x[valid]]
        d = np.where(valid, _digit(key, shift, width), -1)
        warp = np.zeros((W, 1 << width), np.int64)
        pos = np.zeros((W, per, L), np.int64)
        for w in range(W):
            for j in range(per):
                pos[w, j] = _rank_warp(d[w, j], valid[w, j], warp[w])
        total = warp.sum(0)
        if (total == cnt).any():  # one digit holds every key: the order stays
            log["small_skips"] += 1
            continue
        start = np.cumsum(total) - total
        warp_before = np.cumsum(warp, 0) - warp
        w_idx = np.broadcast_to(np.arange(W)[:, None, None], x.shape)
        at = pos[valid] + start[d[valid]] + warp_before[w_idx[valid], d[valid]]
        nxt = np.full(cnt, -1, np.int64)
        nxt[at] = key[valid]
        assert (nxt >= 0).all()
        smem = nxt
    out[ml + begin: ml + begin + cnt] = (g << 40) | (smem & LOW40)


def rank_tiles_cta(bid, row, R, shape):
    count_launch(row, bid, TILES_K)
    ml, ms = row.lists(R)
    m = ml + ms
    base0 = bid * shape.rank_tile
    if base0 >= m:
        return
        yield
    skey = row.keys[int(row.sel[R, len(passes_of(KEY_LO, KEY_HI, shape.digit_bits))])]
    vals = np.zeros((shape.rank_threads, 6), np.int64)
    for t in range(shape.rank_threads):
        base = base0 + t * shape.rank_per
        _, head, start, active = load_flags(skey, base, m, R, shape.rank_per, ml)
        idx = base + np.arange(shape.rank_per)
        vals[t] = [idx[start].max(initial=-1), idx[head].max(initial=-1), head.sum(),
                   start.sum(), active.sum(), idx[head].min(initial=NONE)]
    yield
    row.agg[:, bid] = [vals[:, 0].max(), vals[:, 1].max(), vals[:, 2].sum(), vals[:, 3].sum(),
                       vals[:, 4].sum(), vals[:, 5].min()]


def rank_scan_cta(row, R, shape):
    """bwt_rank_scan, one CTA a row: the tiles' aggregates scanned (per tile
    the last class start and the last head before it, the first head after
    it, the members of large and small new classes before it, the large
    classes that start before it) and the round's state."""
    count_launch(row, 0, SCAN_K)
    ml, ms = row.lists(R)
    m = ml + ms
    if m == 0:
        return
        yield
    n, T, RT = row.n, shape.tile, shape.rank_tile
    tiles = -(-m // RT)
    first_h, last_h, heads, starts_, act = (row.agg[k, :tiles] for k in (5, 1, 2, 3, 4))
    yield
    prev = np.r_[-1, np.maximum.accumulate(last_h)[:-1]]
    nxt = np.minimum(np.r_[np.minimum.accumulate(first_h[::-1])[::-1][1:], NONE], m)
    large = np.zeros(tiles, np.int64)
    lh = np.zeros(tiles, np.int64)  # the tile's last head starts a large class
    for t in range(tiles):
        b, e = t * RT, min(t * RT + RT, m)
        if first_h[t] == NONE:
            large[t] = e - b if nxt[t] - prev[t] > T else 0
        else:
            if first_h[t] > b and first_h[t] - prev[t] > T:
                large[t] += first_h[t] - b
            if nxt[t] - last_h[t] > T:
                large[t] += e - last_h[t]
                lh[t] = 1
    small = act - large
    row.scan = {"start_before": np.r_[-1, np.maximum.accumulate(row.agg[0, :tiles])[:-1]],
                "head_before": prev, "head_after": nxt,
                "large_before": np.cumsum(large) - large, "small_before": np.cumsum(small) - small,
                "ordinal": np.cumsum(lh) - lh}
    active = int(act.sum())
    split = int(heads.sum() > starts_.sum())
    row.m_large[R + 1] = large.sum()
    row.m_small[R + 1] = small.sum()
    row.done[R] = int(active == 0 or not split)
    w = PINNED_HEAD + PINNED_PER_ROUND * R
    row.pinned[w: w + PINNED_PER_ROUND] = [active, n - m + heads.sum(), split, large.sum()]


def rank_apply_cta(bid, row, R, shape, writes):
    count_launch(row, bid, APPLY_K)
    ml, ms = row.lists(R)
    m = ml + ms
    base0 = bid * shape.rank_tile
    if base0 >= m:
        return
        yield
    T, RT = shape.tile, shape.rank_tile
    skey = row.keys[int(row.sel[R, len(passes_of(KEY_LO, KEY_HI, shape.digit_bits))])]
    sc = row.scan
    start_before, head_before, head_after = (int(sc[k][bid]) for k in (
        "start_before", "head_before", "head_after"))
    large_before, small_before = int(sc["large_before"][bid]), int(sc["small_before"][bid])
    flags = [load_flags(skey, base0 + t * shape.rank_per, m, R, shape.rank_per, ml)
             for t in range(shape.rank_threads)]
    idxs = [base0 + t * shape.rank_per + np.arange(shape.rank_per) for t in range(shape.rank_threads)]
    yield
    # per key of the tile, in tile order: its new class's head and the
    # first head past it, from the scans of the threads' runs
    ok = np.concatenate([i < m for i in idxs])
    idx = np.concatenate(idxs)[ok]
    key = np.concatenate([f[0] for f in flags])[ok]
    head = np.concatenate([f[1] for f in flags])[ok]
    start = np.concatenate([f[2] for f in flags])[ok]
    active = np.concatenate([f[3] for f in flags])[ok]
    first = np.maximum(start_before, np.maximum.accumulate(np.where(start, idx, -1)))
    headq = np.maximum(head_before, np.maximum.accumulate(np.where(head, idx, -1)))
    later = np.r_[np.where(head, idx, NONE)[1:], NONE]
    after = np.minimum(np.minimum.accumulate(later[::-1])[::-1], head_after)
    size = after - headq
    is_large = active & (size > T)
    is_small = active & ~(size > T)
    out_large = large_before + np.cumsum(is_large) - is_large
    out_small = small_before + np.cumsum(is_small) - is_small
    pos = key & POS_MASK
    g = key >> (2 * MAX_LOG2) if R > 0 else np.zeros_like(key)
    if R > 0:  # a large-list key carries its class's ordinal
        g = np.where(idx < ml, row.table[R & 1][np.minimum(g, 255)], g)
    row.rank[pos] = g + headq - first
    slot = g + idx - first
    ordinal = sc["ordinal"][headq // RT]
    lead = is_large & (idx == headq)
    row.table[(R + 1) & 1][ordinal[lead]] = (g + headq - first)[lead]
    for q in range(idx.size):
        if is_small[q] and out_small[q] % T == 0:
            os = int(out_small[q])
            row.chunk[os // T] = os if idx[q] == headq[q] else os - (idx[q] - headq[q]) + size[q]
    yield  # __syncthreads: the tile's keys go out in tile order
    row.sa[slot] = pos
    np.add.at(writes, slot, 1)
    row.act_large[(R + 1) & 1][out_large[is_large]] = (pos | (ordinal << MAX_LOG2))[is_large]
    row.act_small[(R + 1) & 1][out_small[is_small]] = pos[is_small]


class NoFixpoint(Exception):
    pass


def round_cap(n: int) -> int:
    c = 0
    while SEED_BYTES << c < n:
        c += 1
    return c + 2


def emulate_batch(rows_c, size: int, shape: "Shape", seed: int = 0, cap=None, min_n: int = 2):
    """tpubz_bwt_forward_batch's call: (keys, lasts, log). The graph's loop:
    each iteration launches the round's kernels over every row (grid
    dimension y), CTAs stepped in a random order; the round's end records
    each row and decides whether the loop runs again. A row that reaches
    its cap short of the stop rule raises NoFixpoint(row)."""
    rng = np.random.default_rng(seed)
    rows = []
    slots = round_cap(max([len(c) for c in rows_c] + [1]))
    for b, c in enumerate(rows_c):
        own = round_cap(max(len(c), 1))
        rows.append(Row(c, shape, own if cap is None or cap >= own else cap, min_n, slots, b))
    P = len(passes_of(KEY_LO, KEY_HI, shape.digit_bits))
    log = {"iterations": 0, "radix": Log(), "skips_global": 0, "small_working": [],
           "small_counts": [], "small_skips": 0, "small_counted": 0, "slot_writes": [[] for _ in rows],
           "rank_before": [[] for _ in rows], "m_large": [[] for _ in rows],
           "m_small": [[] for _ in rows], "launched": []}
    rl = log["radix"]
    R = 0
    if any(r.live(0) for r in rows):
        while True:
            stopped = [r.snapshot() for r in rows if not r.live(R)]
            for b, r in enumerate(rows):
                if r.live(R):
                    ml, ms = r.lists(R)
                    log["m_large"][b].append(ml)
                    log["m_small"][b].append(ms)
                    log["rank_before"][b].append(r.rank.copy())
            grid = shape.tiles(size)
            rl.working.append(0)
            rl.launched.append(grid * len(rows))
            run_grid([keys_cta(x, r, R, shape, rl) for r in rows for x in range(grid)], rng)
            for p in range(P):
                rl.tickets.append([])
                rl.working.append(0)
                rl.launched.append(grid * len(rows))
                run_grid([bwt_pass_cta(x, r, R, p, shape, rl) for r in rows for x in range(grid)], rng)
            log["small_working"].append(0)
            log["small_counts"].append([])
            run_grid([small_sort_cta(k, r, R, shape, log) for r in rows
                      for k in range(-(-size // shape.tile))], rng)
            rtiles = -(-size // shape.rank_tile)
            run_grid([rank_tiles_cta(x, r, R, shape) for r in rows for x in range(rtiles)], rng)
            run_grid([rank_scan_cta(r, R, shape) for r in rows], rng)
            writes = [np.zeros(max(r.n, 1), np.int64) for r in rows]
            run_grid([rank_apply_cta(x, r, R, shape, writes[b]) for b, r in enumerate(rows)
                      for x in range(rtiles)], rng)
            log["launched"].append(("bwt_keys",) + ("bwt_pass",) * P
                                   + ("bwt_small_sort", "bwt_rank_tiles", "bwt_rank_scan",
                                      "bwt_rank_apply", "bwt_round_end"))
            # a row that takes no round this iteration: every launch left at once
            after = [r.snapshot() for r in rows if not r.live(R)]
            assert all(np.array_equal(x, y) for s0, s1 in zip(stopped, after)
                       for x, y in zip(s0, s1))
            # bwt_round_end: lane b records row b (lane 0 first counts the launch)
            rows[0].launched[END_K] += 1
            more = False
            for b, r in enumerate(rows):
                if r.live(R):
                    log["slot_writes"][b].append(writes[b])
                    r.rounds = R + 1
                    r.active += r.n if R == 0 else int(r.m_large[R] + r.m_small[R])
                    if r.done[R]:
                        r.finished = 1
                    elif R + 1 >= r.cap:
                        r.finished = r.error = 1
                    else:
                        more = True
                r.pinned[:PINNED_HEAD] = [r.rounds, r.active, r.skipped, r.error, r.sorts,
                                          r.passes_run, *r.launched]
            log["iterations"] += 1
            R += 1
            errors = [b for b, r in enumerate(rows) if r.error]
            if errors:
                raise NoFixpoint(errors[0])
            if not more:
                break
    log["rows"] = [{"rounds": r.rounds, "rank": r.rank.copy(), "sa": r.sa.copy(),
                    "record": r.pinned[:PINNED_HEAD].copy(),
                    "pinned": r.pinned[PINNED_HEAD: PINNED_HEAD + PINNED_PER_ROUND * r.rounds]
                    .reshape(-1, PINNED_PER_ROUND).copy()} for r in rows]
    log["skips_global"] = rl.skips
    # bwt_last_column
    keys = np.zeros(len(rows), np.int64)
    lasts = np.full((len(rows), size), 255, np.uint8)  # torch.empty: every lane is written
    for b, r in enumerate(rows):
        n = r.n
        lasts[b, n:] = 0
        if n == 1:
            lasts[b, 0] = r.block[0]
        elif n > 1:
            lasts[b, :n] = r.block[np.where(r.sa == 0, n - 1, r.sa - 1)]
            keys[b] = r.rank[0]
    return keys, lasts, log


def emulate_bwt(c: bytes, size: int, shape: "Shape", seed: int = 0, cap=None):
    """tpubz_bwt_forward's call (the batch of one row, which a block of one
    byte runs too): returns key, last and the run's record, one row's."""
    keys, lasts, blog = emulate_batch([c], size, shape, seed=seed, cap=cap, min_n=1)
    row = blog["rows"][0]
    log = {**blog, **row, "m": [a + b for a, b in zip(blog["m_large"][0], blog["m_small"][0])],
           "m_large": blog["m_large"][0], "m_small": blog["m_small"][0],
           "rank_before": blog["rank_before"][0], "slot_writes": blog["slot_writes"][0]}
    return int(keys[0]), lasts[0], log

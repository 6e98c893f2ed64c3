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
a thread and 8-bit digits.
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
MAX_PASSES = 8  # the card's tag stride: 63 bits in 8-bit digits
# csrc/bwt.cu's
MAX_LOG2 = 20
POS_MASK = (1 << MAX_LOG2) - 1
KEY_LO, KEY_HI = 20, 60
SEED_BYTES = 5
MAX_ROUNDS = 24
PINNED_PER_ROUND = 3


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
    def max_passes(self):
        """The tag stride and ticket words a round: 63 bits in these digits
        (the card's 8 covers its 8-bit digits)."""
        return max(MAX_PASSES, -(-63 // self.digit_bits))

    def tiles(self, n):
        return -(-n // self.tile)


@dataclass
class Log:
    """What the launches did: tickets taken per pass, CTAs that had work and
    CTAs launched, look-back spins and steps."""
    tickets: list = field(default_factory=list)
    working: list = field(default_factory=list)
    launched: list = field(default_factory=list)
    spins: int = 0
    lookback_steps: int = 0


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


def _warp_add(hist_row, digits, valid):
    """hist_add's warp aggregation: per warp row of lanes, the lowest lane
    of each set of equal digits adds the set's size. digits, valid:
    (warps, lanes)."""
    peers = digits[:, :, None] == digits[:, None, :]
    first = np.argmax(peers, axis=2) == np.arange(digits.shape[1])[None, :]
    lead = valid & first
    np.add.at(hist_row, digits[lead], peers.sum(2)[lead])


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
            _warp_add(s_hist[p], d.reshape(shape.warps, shape.lanes),
                      valid.reshape(shape.warps, shape.lanes))
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
    below = np.tri(L, L, -1, dtype=bool)  # [lane, l]: l < lane
    for j in range(K):
        dj = d[:, j, :]
        peers = dj[:, :, None] == dj[:, None, :]
        vj = valid[:, j, :]
        prior = np.where(vj, warp[np.arange(W)[:, None], np.maximum(dj, 0)], 0)
        lead = vj & (np.argmax(peers, axis=2) == np.arange(L)[None, :])
        for w, lane in zip(*np.nonzero(lead)):
            warp[w, dj[w, lane]] = prior[w, lane] + peers[w, lane].sum()
        pos[:, j, :] = prior + (peers & below[None]).sum(2)
    total = warp.sum(0)
    warp_before = np.cumsum(warp, 0) - warp  # in place on the card
    for b in range(bins):
        status[tile * bins + b] = (tag << TAG_SHIFT) | (INCLUSIVE if tile == 0 else AGGREGATE) | int(total[b])
    yield
    before = np.zeros(bins, np.int64)
    for b in range(bins):
        excl, t = 0, tile - 1
        while t >= 0:
            word = int(status[t * bins + b])
            if word >> TAG_SHIFT != tag or word & FLAG_MASK == 0:
                log.spins += 1
                yield
                continue
            log.lookback_steps += 1
            excl += word & COUNT_MASK
            if word & FLAG_MASK == INCLUSIVE:
                break
            t -= 1
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


def load_flags(skey, base, m, rnd, per):
    """load_flags: head, class start and active of one thread's keys."""
    gshift = 2 * MAX_LOG2 if rnd > 0 else 63
    idx = base + np.arange(per)
    ok = idx < m
    key = np.where(ok, skey[np.minimum(idx, max(m - 1, 0))], 0)
    prev = np.concatenate([[skey[base - 1] if 0 < base <= m else 0], key[:-1]])
    head = ok & ((idx == 0) | ((key >> KEY_LO) != (prev >> KEY_LO)))
    start = ok & ((idx == 0) | ((key >> gshift) != (prev >> gshift)))
    if base + per < m:
        head_next = (skey[base + per] >> KEY_LO) != (key[-1] >> KEY_LO)
    else:
        head_next = True
    nxt = np.concatenate([(idx[1:] >= m) | head[1:], [head_next]])
    active = ok & ~(head & nxt)
    return key, head, start, active


def rank_tiles_cta(bid, skey, m, rnd, shape, agg):
    base0 = bid * shape.rank_tile
    if base0 >= m:
        return
        yield
    vals = np.zeros((shape.rank_threads, 5), np.int64)
    for t in range(shape.rank_threads):
        base = base0 + t * shape.rank_per
        _, head, start, active = load_flags(skey, base, m, rnd, shape.rank_per)
        idx = base + np.arange(shape.rank_per)
        vals[t] = [idx[start].max(initial=-1), idx[head].max(initial=-1), head.sum(),
                   start.sum(), active.sum()]
    yield
    agg[:, bid] = [vals[:, 0].max(), vals[:, 1].max(), vals[:, 2].sum(), vals[:, 3].sum(),
                   vals[:, 4].sum()]


def rank_apply_cta(bid, skey, n, m, rnd, shape, agg, rank, sa, act_next, state, pinned, writes):
    base0 = bid * shape.rank_tile
    if base0 >= m:
        return
        yield
    start_before = agg[0, :bid].max(initial=-1)
    head_before = agg[1, :bid].max(initial=-1)
    active_before = agg[4, :bid].sum()
    if bid == 0:  # no tile before it: the round's state from all of them
        tiles = -(-m // shape.rank_tile)
        heads, starts, active = agg[2, :tiles].sum(), agg[3, :tiles].sum(), agg[4, :tiles].sum()
        split = heads > starts
        state["m"][rnd + 1] = active
        state["done"][rnd] = int(active == 0 or not split)
        pinned[PINNED_PER_ROUND * rnd: PINNED_PER_ROUND * (rnd + 1)] = [active, n - m + heads,
                                                                        int(split)]
    flags = [load_flags(skey, base0 + t * shape.rank_per, m, rnd, shape.rank_per)
             for t in range(shape.rank_threads)]
    idxs = [base0 + t * shape.rank_per + np.arange(shape.rank_per) for t in range(shape.rank_threads)]
    my_start = [i[f[2]].max(initial=-1) for i, f in zip(idxs, flags)]
    my_head = [i[f[1]].max(initial=-1) for i, f in zip(idxs, flags)]
    my_active = [int(f[3].sum()) for f in flags]
    yield
    # per key of the tile (tile index x = thread * rank_per + q): its
    # position, slot and index in the next active list (-1: it leaves)
    s_pos = np.zeros(shape.rank_tile, np.int64)
    s_slot = np.zeros(shape.rank_tile, np.int64)
    s_out = np.zeros(shape.rank_tile, np.int64)
    for t in range(shape.rank_threads):
        first = max(start_before, max(my_start[:t], default=-1))
        headq = max(head_before, max(my_head[:t], default=-1))
        out = active_before + sum(my_active[:t])
        key, head, start, act = flags[t]
        for q in range(shape.rank_per):
            idx = int(idxs[t][q])
            if idx >= m:
                continue
            first = idx if start[q] else first
            headq = idx if head[q] else headq
            i = int(key[q]) & POS_MASK
            g = int(key[q]) >> (2 * MAX_LOG2) if rnd > 0 else 0
            rank[i] = g + headq - first
            x = t * shape.rank_per + q
            s_pos[x], s_slot[x] = i, g + idx - first
            s_out[x] = out if act[q] else -1
            out += int(act[q])
    yield  # __syncthreads: the tile's keys go out in tile order
    for x in range(min(shape.rank_tile, m - base0)):
        sa[s_slot[x]] = s_pos[x]
        writes[s_slot[x]] += 1
        if s_out[x] >= 0:
            act_next[s_out[x]] = s_pos[x]


class NoFixpoint(Exception):
    pass


def round_cap(n: int) -> int:
    c = 0
    while SEED_BYTES << c < n:
        c += 1
    return c + 2


def emulate_bwt(c: bytes, size: int, shape: Shape, seed: int = 0, cap=None):
    """tpubz_bwt_forward's call: returns key, last and a record of the run."""
    block = np.frombuffer(c, np.uint8)
    n = block.size
    D, bins = shape.digit_bits, 1 << shape.digit_bits
    P = len(passes_of(KEY_LO, KEY_HI, D))
    cap = round_cap(n) if cap is None else cap
    rng = np.random.default_rng(seed)
    # torch.empty scratch: garbage where the call does not zero
    keys = [np.full(n, -3, np.int64), np.full(n, -3, np.int64)]
    rank = np.full(n, -7, np.int64)
    sa = np.full(n, -7, np.int64)
    act = [np.full(n, -9, np.int64), np.full(n, -9, np.int64)]
    agg = np.full((5, -(-n // shape.rank_tile)), -11, np.int64)
    pinned = np.full(PINNED_PER_ROUND * MAX_ROUNDS, -99, np.int64)
    # the words zeroed once per call
    state = {"m": np.zeros(MAX_ROUNDS + 1, np.int64), "done": np.zeros(MAX_ROUNDS, np.int64)}
    tickets = np.zeros((cap, shape.max_passes), np.int64)
    hist = np.zeros((cap, P, bins), np.int64)
    status = np.zeros(shape.tiles(n) * bins, np.int64)
    log = {"rounds_enqueued": 0, "skipped": 0, "m": [], "rank_before": [], "radix": Log(),
           "slot_writes": []}

    def enqueue_round(r):
        log["rounds_enqueued"] += 1
        m = 0 if r > 0 and state["done"][r - 1] else (state["m"][r] if r > 0 else n)
        if m == 0:
            # every CTA of every launch returns at once: nothing is written
            mem = (keys[0], keys[1], rank, sa, act[0], act[1], agg, pinned, state["m"],
                   state["done"], tickets, hist, status)
            before = [x.copy() for x in mem]
            skip = Log()
            rtiles = -(-n // shape.rank_tile)
            a = {"m": 0}
            ctas = ([histogram_cta(b, None, 0, shape, KEY_LO, KEY_HI, None, skip)
                     for b in range(shape.tiles(n))]
                    + [pass_cta(b, a, shape, skip) for b in range(shape.tiles(n))] * P
                    + [rank_tiles_cta(b, None, 0, r, shape, None) for b in range(rtiles)]
                    + [rank_apply_cta(b, None, n, 0, r, shape, None, None, None, None, None,
                                      None, None) for b in range(rtiles)])
            run_grid(ctas, rng)
            assert all(np.array_equal(x, y) for x, y in zip(before, mem))
            log["skipped"] += 1
            return
        log["m"].append(int(m))
        log["rank_before"].append(rank.copy())
        h = (SEED_BYTES << (r - 1)) % n if r > 0 else 0
        src = keys[P & 1]

        def keys_of(q):
            if r == 0:
                k = np.array([seed_key(block, i) for i in q], np.int64)
            else:
                i = act[r & 1][q]
                k = (rank[i] << (2 * MAX_LOG2)) | (rank[_wrap(i, h, n)] << MAX_LOG2) | i
            src[q] = k
            return k

        rl = log["radix"]
        rl.working.append(0)
        rl.launched.append(shape.tiles(n))
        run_grid([histogram_cta(b, keys_of, m, shape, KEY_LO, KEY_HI, hist[r], rl)
                  for b in range(shape.tiles(n))], rng)
        emulate_sort(src, KEY_LO, KEY_HI, shape, rng, log=rl, status=status, tickets=tickets[r],
                     rnd=r, m=m, grid_n=n, hist=hist[r], bufs=keys)
        rtiles = -(-n // shape.rank_tile)
        run_grid([rank_tiles_cta(b, keys[0], m, r, shape, agg) for b in range(rtiles)], rng)
        writes = np.zeros(n, np.int64)
        run_grid([rank_apply_cta(b, keys[0], n, m, r, shape, agg, rank, sa, act[(r + 1) & 1],
                                 state, pinned, writes) for b in range(rtiles)], rng)
        log["slot_writes"].append(writes)

    enqueue_round(0)
    r = 0
    while True:
        ahead = r + 1 < cap
        if ahead:
            enqueue_round(r + 1)
        m_after, _, split = pinned[PINNED_PER_ROUND * r: PINNED_PER_ROUND * (r + 1)]
        if m_after == 0 or split == 0:
            break
        if not ahead:
            raise NoFixpoint(r)
        r += 1
    log.update(rounds=r + 1, rank=rank.copy(), sa=sa.copy(),
               pinned=pinned[: PINNED_PER_ROUND * (r + 1)].reshape(-1, PINNED_PER_ROUND).copy())
    # bwt_last_column
    last = np.full(size, 255, np.uint8)  # torch.empty: every lane must be written
    last[n:] = 0
    last[:n] = block[np.where(sa == 0, n - 1, sa - 1)]
    return int(rank[0]), last, log

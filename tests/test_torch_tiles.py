"""The tile decompositions of the MTF and RLE2 kernels (csrc/mtf.cu,
csrc/rle2.cu), emulated in numpy on the CPU with the kernels' index math,
against tpubz's mtf_ranks and rle2_encode.

The CUDA kernels run only on the card. Here each kernel is run CTA by CTA
and thread by thread as its source writes it (the group walk with its
warp-level match, the scan of the group totals in 32 row slices, the
256-lane bitonic network, the per-warp occurrence tables, the ballot
scans; the tile statistics, the
scan of the tiles in rounds with a carry, the tiled write), with small groups
and tiles, so that recency rows and zero runs cross many of them. Every
comparison is exact: tolerance 0.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpubz.hostref.bwt import bwt_encode
from tpubz.kernels import mtf as jmtf
from tpubz.kernels import rle2 as jrle2
from tpubz_torch.kernels import compact, mtf, rle2

torch.set_num_threads(2)

C = 256
WARP = 32
SLICES = 32  # mtf_group_prefix's row slices
N = 4096  # 16 chunks

_rng = np.random.default_rng(20261017)
# tests/test_torch_kernels.py's cases, a block of one long zero run, and a
# mixed block that fills N, whose recency rows cross every group
CASES = {
    "banana": b"banana" * 30,
    "aaaa": b"aaaa" * 100,
    "ab": b"ab" * 300,
    "random256": bytes(_rng.integers(0, 256, 1000, dtype=np.uint8)),
    "random4": bytes(_rng.integers(0, 4, 1024, dtype=np.uint8)),
    "n1": b"x",
    "n777": bytes(_rng.integers(0, 20, 777, dtype=np.uint8)),
    "near_periodic": b"ab" * 500 + b"c",
    "all256": bytes(range(256)) * 4,
    "zero_run": b"z" * 4000,
    "mixed": (b"the quick brown fox " * 60 + bytes(_rng.integers(0, 256, 1500, dtype=np.uint8))
              + bytes(_rng.integers(0, 3, 1396, dtype=np.uint8)))[:N],
}
CASE_IDS = list(CASES)

_jax_mtf = jax.jit(jmtf.mtf_ranks, static_argnames=("chunk",))
_jax_rle2 = jax.jit(jrle2.rle2_encode)
_jax_rle2_batch = jax.jit(jrle2.rle2_encode_batch)


def _last(case):
    c = CASES[case]
    _, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    last = np.zeros(N, np.uint8)
    last[: len(c)] = hlast
    return last, len(c)


def _num_digits(run):
    run = np.asarray(run, np.int64)
    return np.where(run > 0, np.floor(np.log2(np.maximum(run, 0) + 1)).astype(np.int64), 0)


def _excl_scan(v, op, identity):
    """The exclusive scan of block_exclusive / the ballot scans."""
    return np.concatenate(([identity], op.accumulate(v)[:-1])) if v.size else v


# ---------------------------------------------------------------- MTF


def _sort256(v):
    """block_sort256: thread t meets t ^ j at every pass (k, j); the lower
    index of a pair keeps the min in an ascending block (bit k of t is 0)."""
    t = np.arange(C)
    k = 2
    while k <= C:
        j = k >> 1
        while j:
            other = v[t ^ j]
            keep_min = ((t & j) == 0) == ((t & k) == 0)
            v = np.where(keep_min, np.minimum(v, other), np.maximum(v, other))
            j >>= 1
        k <<= 1
    return v


def _ballot_index(flags):
    """Each lane's index among the flagged lanes of the CTA: the popcount of
    its warp's ballot below it plus the counts of the warps before."""
    ballots = flags.reshape(-1, WARP)
    below = np.cumsum(ballots, 1) - ballots
    warps = _excl_scan(ballots.sum(1), np.add, 0)
    return (below + warps[:, None]).reshape(-1)


def _clz(x):
    return 32 - int(x).bit_length()


def _ffs(x):
    return (int(x) & -int(x)).bit_length()


def _occurrences(sym):
    """lprev and lnext of mtf_chunk_ranks: in the warp from the lanes that
    match the symbol, across warps from the bitmask of warps holding it and
    its first and last position in each."""
    warps = {}
    first_at, last_at = {}, {}
    peers = []
    for t in range(C):
        w, lane = divmod(t, WARP)
        m = sum(1 << q for q in range(WARP) if sym[w * WARP + q] == sym[t])
        peers.append(m)
        if not m & ((1 << lane) - 1):  # the first lane of its symbol
            warps[sym[t]] = warps.get(sym[t], 0) | 1 << w
            first_at[w, sym[t]] = t
            last_at[w, sym[t]] = w * WARP + 31 - _clz(m)
    lprev = np.empty(C, np.int64)
    lnext = np.empty(C, np.int64)
    for t in range(C):
        w, lane = divmod(t, WARP)
        below = (1 << lane) - 1
        lower = peers[t] & below
        higher = peers[t] & ~below & ~(1 << lane) & 0xFFFFFFFF
        lp = w * WARP + 31 - _clz(lower) if lower else -1
        ln = w * WARP + _ffs(higher) - 1 if higher else C
        if not lower:
            m = warps[sym[t]] & ((1 << w) - 1)
            if m:
                lp = last_at[31 - _clz(m), sym[t]]
        if not higher:
            m = warps[sym[t]] & ~((2 << w) - 1) & 0xFFFFFFFF
            if m:
                ln = first_at[_ffs(m) - 1, sym[t]]
        lprev[t], lnext[t] = lp, ln
    return lprev, lnext


def emulate_mtf(last, n, group):
    """csrc/mtf.cu's three kernels on numpy arrays: (ranks int64[N], used)."""
    last = last.astype(np.int64)
    nc = last.size // C
    ng = -(-nc // group)
    lanes = np.arange(C)
    lb_local = np.full((nc, C), -99)
    gmax = np.full((ng, C), -99)
    # mtf_group_last: one CTA per group walks its chunks in order
    later = np.triu(np.ones((WARP, WARP), bool), 1)
    for g in range(ng):
        run = np.full(C, -1)
        for c in range(g * group, min(g * group + group, nc)):
            lb_local[c] = run
            pos = c * C + lanes
            sym = np.where(pos < n, last[pos], -1).reshape(-1, WARP)
            # __match_any_sync: the highest lane of a symbol in its warp
            same = sym[:, :, None] == sym[:, None, :]
            leader = (sym >= 0) & ~(same & later).any(2)
            np.maximum.at(run, sym[leader], pos.reshape(-1, WARP)[leader])
        gmax[g] = run
    # mtf_group_prefix: 32 row slices of each column
    per = -(-ng // SLICES)
    bounds = [(min(q * per, ng), min(min(q * per, ng) + per, ng)) for q in range(SLICES)]
    part = np.array([gmax[r0:r1].max(0) if r1 > r0 else np.full(C, -1) for r0, r1 in bounds])
    gpre = np.full((ng, C), -99)
    for q, (r0, r1) in enumerate(bounds):
        carry = part[:q].max(0) if q else np.full(C, -1)
        for r in range(r0, r1):
            gpre[r] = carry
            carry = np.maximum(carry, gmax[r])
    used = part.max(0) >= 0
    # mtf_chunk_ranks: one CTA per chunk
    ranks = np.full(last.size, -99)
    N_ = last.size
    for c in range(nc):
        pos = c * C + lanes
        valid = pos < n
        sym = np.where(valid, last[pos], 256)
        init = _ballot_index(used)
        before = np.maximum(lb_local[c], gpre[c // group])
        key = np.where(before >= 0, N_ - before, 2 * N_ + np.where(used, init, 256))
        assert key.max() < 1 << 23
        ks = _sort256((key << 8) | lanes)
        srank_of = np.full(C, -99)
        srank_of[ks & 0xFF] = lanes
        lprev, lnext = _occurrences(sym)
        first = valid & (lprev < 0)
        idx = _ballot_index(first)
        srank = np.where(first, srank_of[np.minimum(sym, 255)], 0)
        s_first = np.full(C, -99)
        s_first[idx[first]] = srank[first]
        jj = lanes[None, :]
        ii = lanes[:, None]
        case1 = ((jj > lprev[:, None]) & (jj < ii) & (lnext[None, :] >= ii)).sum(1)
        case2 = srank + ((jj < idx[:, None]) & (s_first[None, :] > srank[:, None])).sum(1)
        ranks[pos] = np.where(valid, np.where(lprev >= 0, case1, case2), 0)
    return ranks, used


@pytest.mark.parametrize("group", [2, 3, 8])
@pytest.mark.parametrize("case", CASE_IDS)
def test_mtf_tiles_match_tpubz(case, group):
    """The MTF kernels' decomposition, with chunk rows scanned in groups of
    2, 3 (a ragged last group) and 8, gives tpubz's ranks[:n] and used map
    and the port's plain version on every lane (pad lanes 0)."""
    last, n = _last(case)
    ranks, used = emulate_mtf(last, n, group)
    jranks, jused = _jax_mtf(jnp.asarray(last), jnp.int32(n), chunk=C)
    assert np.array_equal(ranks[:n], np.asarray(jranks)[:n])
    assert np.array_equal(used, np.asarray(jused))
    pranks, pused = mtf.mtf_ranks_ref(torch.from_numpy(last), n)
    assert np.array_equal(ranks, pranks.numpy()) and np.array_equal(used, pused.numpy())


def test_mtf_emulation_reaches_rank_255():
    last, n = _last("all256")
    ranks, used = emulate_mtf(last, n, 2)
    assert ranks[:n].max() == 255 and used.all()


# ---------------------------------------------------------------- RLE2

NONE = np.iinfo(np.int32).max  # Seg.first of a segment with no nonzero
EMPTY = (NONE, -1, 0, 0)
START = (-1, -1, 0, 0)  # the prefix before a row's first tile
AGGREGATE, INCLUSIVE = 1 << 62, 2 << 62
FIELD = (1 << 20) - 1


def _nd(run):
    """num_digits of one run, as the kernel's clz."""
    return int(run + 1).bit_length() - 1 if run > 0 else 0


def _combine(a, b):
    """Seg combine: a then b (first, last, emit, hi)."""
    if b[0] == NONE:
        return (a[0], a[1], a[2], a[3] + b[3])
    if a[0] == NONE:
        return (b[0], b[1], b[2], a[3] + b[3])
    return (a[0], b[1], a[2] + _nd(b[0] - a[1] - 1) + b[2], a[3] + b[3])


def _pack_aggregate(s, base):
    if s[0] == NONE:
        return AGGREGATE
    assert s[2] < 1 << 13 and s[3] < 1 << 13 and 0 <= s[0] - base <= s[1] - base < 1 << 12
    return AGGREGATE | s[2] | s[3] << 13 | (s[0] - base) << 26 | (s[1] - base) << 38


def _unpack_aggregate(w, base):
    emit = w & 0x1FFF
    if not emit:
        return EMPTY
    return (base + (w >> 26 & 0xFFF), base + (w >> 38 & 0xFFF), emit, w >> 13 & 0x1FFF)


def _pack_inclusive(p):
    assert p[0] == -1 and max(p[1] + 1, p[2], p[3]) <= FIELD
    return INCLUSIVE | p[2] | p[3] << 20 | (p[1] + 1) << 40


def _unpack_inclusive(w):
    return (-1, (w >> 40 & FIELD) - 1, w & FIELD, w >> 20 & FIELD)


def _look_back(status, tile, size, lanes):
    """look_back: thread t of the CTA (`lanes` threads) reads tile t0 - t
    (before tile 0: the row's start); each warp (32 threads, or all of a
    smaller CTA) takes its nearest inclusive prefix by a ballot and the
    aggregates after it through a shuffle tree (lane + d < 32); thread 0
    combines the warps from the latest back to the first that met an
    inclusive prefix; without one the window moves `lanes` tiles back.
    Returns (the exclusive prefix, the tiles it read back)."""
    warp = min(32, lanes)
    acc, t0 = EMPTY, tile - 1
    while True:
        srcs = [t0 - t for t in range(lanes)]
        words = [INCLUSIVE if src < 0 else status[src] for src in srcs]
        assert all(words), "a look-back went past a status word not yet published"
        for v in range(lanes // warp):
            lanes_v = range(v * warp, (v + 1) * warp)
            incl = [words[t] >> 62 == 2 for t in lanes_v]
            k = incl.index(True) if any(incl) else warp
            s = [_unpack_aggregate(words[t], srcs[t] * size) if lane < k else
                 _unpack_inclusive(words[t]) if lane == k else EMPTY
                 for lane, t in enumerate(lanes_v)]
            d = 1
            while d < warp:
                s = [_combine(s[lane + d], s[lane]) if lane + d < warp else s[lane]
                     for lane in range(warp)]
                d <<= 1
            acc = _combine(s[0], acc)
            if k < warp:
                return acc, tile - srcs[v * warp + k]
        t0 -= lanes


def _tile(r_all, n, tile, threads, per):
    """A CTA's ranks and block scans: (pos, r, nz, prev, before, agg)."""
    size = threads * per
    pos = tile * size + np.arange(size).reshape(threads, per)
    r = r_all[pos]
    nz = (pos < n) & (r != 0)
    first = np.where(nz.any(1), pos[np.arange(threads), nz.argmax(1)], NONE)
    last = np.where(nz, pos, -1).max(1)
    hi = (nz & (r == 255)).sum(1)
    emit = np.zeros(threads, np.int64)
    p = np.full(threads, -1)
    for k in range(per):
        m = nz[:, k]
        emit += np.where(m, np.where(p >= 0, _num_digits(pos[:, k] - p - 1), 0) + 1, 0)
        p = np.where(m, pos[:, k], p)
    prev = _excl_scan(last, np.maximum, -1)
    leads = (first != NONE) & (prev < 0)
    assert leads.sum() <= 1
    s_first = int(first[leads][0]) if leads.any() else NONE
    own = emit + np.where((first != NONE) & (prev >= 0), _num_digits(first - prev - 1), 0)
    assert own.sum() < 1 << 16 and hi.sum() < 1 << 16
    packed = own | hi << 16
    total = int(packed.sum())
    agg = (s_first, int(last.max()), total & 0xFFFF, total >> 16)
    return pos, r, nz, prev, _excl_scan(packed, np.add, 0), agg


def emulate_rle2(ranks, n, eob, threads, per, order="in_order", seed=0, lean=False,
                 hi_cap=compact.HI_CAP):
    """csrc/rle2.cu's memset and one-pass kernel on numpy arrays, tiles of
    threads * per ranks and look-back windows of `threads` tiles (the
    kernel's 256 cover a row's at most 256 tiles). Every tile
    publishes its aggregate (tile 0 its inclusive prefix) and stages its
    slots; then the tiles look back and publish their inclusive prefixes in
    ticket-publication order `order` ("in_order", "reverse" or a seeded
    "random" permutation), each seeing what the earlier ones published, and
    write their slots out. With `lean`, eob is the used map and hi_pos, u8
    and hi_count are written. Every output slot below rle2_len must be
    written exactly once and none past it (the memset's zeros). Returns
    (syms, rle2_len, freqs, extra): extra holds the lean outputs and each
    tile's tiles read back in its look-back."""
    size = threads * per
    nb = max(1, -(-ranks.size // size))
    out_len = ranks.size + 8
    r_all = np.zeros(nb * size, np.int64)
    r_all[: ranks.size] = ranks  # positions at or past N read as 0
    syms = np.zeros(out_len, np.int64)  # the memset
    writes = np.zeros(out_len, np.int64)
    freqs = np.zeros(258, np.int64)
    hi_pos = np.full(hi_cap, -7, np.int64)
    hi_writes = np.zeros(hi_cap, np.int64)

    def write(at, val):
        syms[at] = val
        np.add.at(writes, at, 1)

    def write_hi(at, val):
        hi_pos[at] = val
        np.add.at(hi_writes, at, 1)

    # every tile publishes its aggregate, tile 0 its inclusive prefix at once
    tiles = [_tile(r_all, n, b, threads, per) for b in range(nb)]
    status = [_pack_aggregate(t[5], b * size) for b, t in enumerate(tiles)]
    status[0] = _pack_inclusive(_combine(START, tiles[0][5]))
    prefix, read = {0: START}, {0: 0}
    if order == "in_order":
        visit = list(range(1, nb))
    elif order == "reverse":
        visit = list(range(nb - 1, 0, -1))
    else:
        visit = (np.random.default_rng(seed).permutation(nb - 1) + 1).tolist()
    for b in visit:
        prefix[b], read[b] = _look_back(status, b, size, threads)
        status[b] = _pack_inclusive(_combine(prefix[b], tiles[b][5]))

    for b in [0, *visit]:
        pos, r, nz, prev, before, agg = tiles[b]
        # staged before the look-back: every literal and the digits of the
        # run before it, slots counted from the tile's first literal, whose
        # own run waits for the prefix; the rank-255 literals' slots
        loc = before & 0xFFFF
        hi_at = before >> 16
        q = prev.copy()
        stage = np.full(size, -1, np.int64)
        staged = np.zeros(size, np.int64)
        hi_slot = np.full(size, -1, np.int64)
        for k in range(per):
            m = nz[:, k]
            run = pos[:, k] - q - 1
            d = np.where(m & (q >= 0), _num_digits(run), 0)
            for j in range(int(d.max(initial=0))):
                w = j < d
                digit = ((run[w] + 1) >> j) & 1
                stage[loc[w] + j] = digit
                np.add.at(staged, loc[w] + j, 1)
                np.add.at(freqs, digit, 1)
            stage[loc[m] + d[m]] = r[m, k] + 1
            np.add.at(staged, loc[m] + d[m], 1)
            np.add.at(freqs, r[m, k] + 1, 1)
            h = m & (r[:, k] == 255)
            hi_slot[hi_at[h]] = loc[h] + d[h]
            hi_at = hi_at + h
            loc = np.where(m, loc + d + 1, loc)
            q = np.where(m, pos[:, k], q)
        assert (staged[: agg[2]] == 1).all() and not staged[agg[2]:].any()
        assert (hi_slot[: agg[3]] >= 0).all() and (hi_slot[agg[3]:] == -1).all()
        # after it: the digits of the run before the first literal, then the
        # staged slots, then the rank-255 slots by rank in the row
        p = prefix[b]
        lead = _nd(agg[0] - p[1] - 1) if agg[0] != NONE else 0
        lead_digits = ((agg[0] - p[1]) >> np.arange(lead)) & 1
        write(p[2] + np.arange(lead), lead_digits)
        np.add.at(freqs, lead_digits, 1)
        write(p[2] + lead + np.arange(agg[2]), stage[: agg[2]])
        if lean:
            rank = p[3] + np.arange(agg[3])
            keep = rank < hi_cap
            write_hi(rank[keep], p[2] + lead + hi_slot[: agg[3]][keep])

    f = _combine(prefix[nb - 1], tiles[nb - 1][5])
    tail = n - 1 - f[1]
    digits = _nd(tail)
    length = f[2] + digits + 1
    end = int(eob.sum()) + 1 if lean else int(eob)
    tail_digits = ((tail + 1) >> np.arange(digits)) & 1
    write(f[2] + np.arange(digits), tail_digits)
    write(np.array([length - 1]), end)
    np.add.at(freqs, np.append(tail_digits, end), 1)
    assert (writes[:length] == 1).all(), "a slot below rle2_len was written twice or never"
    assert not writes[length:].any(), "a slot past rle2_len was written"
    extra = {"read": read}
    if lean:
        write_hi(np.arange(min(f[3], hi_cap), hi_cap), compact.HI_NONE)
        assert (hi_writes == 1).all(), "a hi_pos entry was written twice or never"
        extra.update(u8=np.minimum(syms, 255), hi_pos=hi_pos, hi_count=f[3])
    return syms, length, freqs, extra


def _check_rle2(ranks, n, eob, shape, order="random", seed=0):
    syms, length, freqs, extra = emulate_rle2(ranks, n, eob, *shape, order=order, seed=seed)
    jsyms, jlen, jfreqs = _jax_rle2(jnp.asarray(ranks, jnp.int32), jnp.int32(n), jnp.int32(eob))
    assert length == int(jlen)
    assert np.array_equal(syms[:length], np.asarray(jsyms)[:length].astype(np.int64))
    assert np.array_equal(freqs, np.asarray(jfreqs).astype(np.int64))
    psyms, plen, pfreqs = rle2.rle2_encode_ref(torch.from_numpy(ranks.astype(np.int32)), n, eob)
    assert length == int(plen)
    assert np.array_equal(syms, psyms.numpy()) and np.array_equal(freqs, pfreqs.numpy())
    return extra["read"]


# (threads, ranks a thread): tiles of 16, 32 and 64 ranks
SHAPES = [(4, 4), (8, 4), (16, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=["t16", "t32", "t64"])
@pytest.mark.parametrize("case", CASE_IDS)
def test_rle2_tiles_match_tpubz(case, shape):
    """The RLE2 kernel's decomposition on the MTF ranks of each case, with
    tiles of 16-64 ranks and the tiles publishing in a random order, gives
    tpubz's symbols, length and frequencies, and the port's plain version
    on every slot (zeros past the stream)."""
    last, n = _last(case)
    ranks, used = mtf.mtf_ranks_ref(torch.from_numpy(last), n)
    _check_rle2(ranks.numpy().astype(np.int64), n, int(used.sum()) + 1, shape,
                seed=CASE_IDS.index(case))


def _runs(seed, size, n):
    """Ranks with zero runs of every length up to a few tiles, and literals
    up to 255."""
    rng = np.random.default_rng(seed)
    ranks = np.zeros(size, np.int64)
    at = 0
    while at < size:
        at += int(rng.choice([0, 1, 2, 5, 17, 40, 300, 1500]))
        if at < size:
            ranks[at] = rng.integers(1, 256)
            at += 1
    ranks[n:] = rng.integers(0, 256, size - n)  # pad lanes must not leak
    return ranks


@pytest.mark.parametrize("shape", SHAPES + [(256, 16)], ids=["t16", "t32", "t64", "t4096"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle2_tiles_on_long_zero_runs(seed, shape):
    """Random ranks with long zero runs, n not a multiple of the tile, and
    the kernel's own tile (4096 = 256 threads x 16)."""
    size = 16384
    n = size - 1000 - seed
    _check_rle2(_runs(seed, size, n), n, 200 + seed, shape, seed=seed)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096])
def test_rle2_tiles_at_the_edges(n):
    """No valid rank, one zero, zeros with a nonzero pad lane after them,
    and zeros closed by a nonzero in the last slot."""
    ranks = np.zeros(N, np.int64)
    ranks[-1] = 9
    _check_rle2(ranks, n, 1 + (n > 0), (8, 4))


@pytest.mark.parametrize("shape", SHAPES, ids=["t16", "t32", "t64"])
@pytest.mark.parametrize("order", ["in_order", "reverse", "random"])
def test_rle2_look_back_in_every_publication_order(order, shape):
    """The tiles publish their inclusive prefixes in order (each look-back
    meets its neighbour's at once), in reverse (each sees only aggregates,
    back to tile 0's prefix) and in a seeded random order (both): the same
    outputs as tpubz and the plain version every time."""
    size = 4096
    read = _check_rle2(_runs(5, size, size - 77), size - 77, 199, shape, order=order, seed=5)
    steps = [read[b] for b in range(1, len(read))]
    if order == "in_order":
        assert set(steps) == {1}
    elif order == "reverse":
        assert steps == list(range(1, len(read)))  # each reads back to tile 0
    else:
        assert min(steps) == 1 and max(steps) > 1


def test_rle2_look_back_crosses_more_than_32_tiles():
    """A window of two warps (64 threads): tiles publishing in reverse look
    back across the warps of a window and window after window, up to 127
    tiles."""
    size = 8192
    read = _check_rle2(_runs(6, size, size - 9), size - 9, 150, (64, 1), order="reverse")
    assert max(read.values()) == len(read) - 1 == 127


def _lean_case(case):
    """(ranks int64, n, used bool[256]): a case's MTF ranks, or random
    ranks with many of rank 255, a long zero run and nonzero pad lanes,
    every byte used (EOB 257)."""
    if case == "rank255_runs":
        rng = np.random.default_rng(7)
        ranks = np.where(rng.random(N) < 0.4, rng.integers(1, 256, N), 0)
        ranks[rng.random(N) < 0.15] = 255
        ranks[1000:1700] = 0  # a run across tiles
        return ranks, N - 50, np.ones(256, bool)
    last, n = _last(case)
    ranks, used = mtf.mtf_ranks_ref(torch.from_numpy(last), n)
    return ranks.numpy().astype(np.int64), n, used.numpy()


@pytest.mark.parametrize("hi_cap", [compact.HI_CAP, 48], ids=["cap8192", "cap48"])
@pytest.mark.parametrize("case", ["all256", "random256", "mixed", "n1", "rank255_runs"])
def test_rle2_lean_tiles_match_tpubz(case, hi_cap):
    """The lean call (kLean), with the EOB from the used map: the symbols
    equal tpubz's rle2_encode; the byte stream, the slots of the rank-255
    literals (from each tile's prefix count and a block scan), their count
    and the padding equal the port's plain version, and the slots are
    tpubz's symbols 256 below the EOB in ascending order (the order of
    tpubz's _rle2_compact); with a cap of 48 entries an overflow keeps the
    first 48 and counts them all."""
    r, n, used = _lean_case(case)
    syms, length, _, extra = emulate_rle2(r, n, used, 8, 4, order="random", seed=3,
                                          lean=True, hi_cap=hi_cap)
    jsyms, jlen, _ = _jax_rle2(jnp.asarray(r, jnp.int32), jnp.int32(n),
                               jnp.int32(int(used.sum()) + 1))
    jsyms = np.asarray(jsyms).astype(np.int64)
    assert length == int(jlen) and np.array_equal(syms[:length], jsyms[:length])
    want_hi = np.flatnonzero(jsyms[: length - 1] == 256)
    assert extra["hi_count"] == want_hi.size
    assert np.array_equal(extra["hi_pos"][: min(want_hi.size, hi_cap)], want_hi[:hi_cap])
    p_rl, p_u8, p_hi, p_hc, p_syms = compact.rle2_compact_ref(
        torch.from_numpy(r.astype(np.int32)), n, torch.from_numpy(used))
    assert length == int(p_rl) and extra["hi_count"] == int(p_hc)
    assert np.array_equal(syms, p_syms.numpy()) and np.array_equal(extra["u8"], p_u8.numpy())
    assert np.array_equal(extra["hi_pos"], p_hi.numpy()[:hi_cap])
    if case == "rank255_runs":
        assert want_hi.size > 48


@pytest.mark.parametrize("shape", [(8, 4), (256, 16)], ids=["t32", "t4096"])
def test_rle2_batch_rows_match_tpubz(shape):
    """The batched call: each row its own ranks, length, EOB, tickets and
    status words (row as grid dimension y), equal to tpubz's
    rle2_encode_batch and the port's plain batch version row by row."""
    names = ["mixed", "zero_run", "n1", "all256"]
    rows = [_last(c) for c in names]
    ranks = np.stack([mtf.mtf_ranks_ref(torch.from_numpy(lst), n)[0].numpy() for lst, n in rows])
    n = np.array([m for _, m in rows], np.int32)
    eob = np.array([5, 9, 2, 257], np.int32)
    jsyms, jlen, jfreqs = _jax_rle2_batch(jnp.asarray(ranks), jnp.asarray(n),
                                                 jnp.asarray(eob))
    psyms, plen, pfreqs = rle2.rle2_encode_batch_ref(torch.from_numpy(ranks), n.tolist(),
                                                     torch.from_numpy(eob))
    for b in range(len(names)):
        syms, length, freqs, _ = emulate_rle2(ranks[b].astype(np.int64), int(n[b]), int(eob[b]),
                                              *shape, order="random", seed=b)
        assert length == int(jlen[b]) == int(plen[b])
        assert np.array_equal(syms, np.asarray(jsyms[b]).astype(np.int64))
        assert np.array_equal(syms, psyms[b].numpy().astype(np.int64))
        assert np.array_equal(freqs, np.asarray(jfreqs[b])) and np.array_equal(freqs, pfreqs[b].numpy())


# ---------------------------------------------------------------- wrappers


def test_cpu_calls_run_the_plain_versions_and_count_nothing():
    last, n = _last("mixed")
    before = (mtf.LAUNCHES, rle2.LAUNCHES)
    ranks, used = mtf.mtf_ranks(torch.from_numpy(last), n)
    rr, ru = mtf.mtf_ranks_ref(torch.from_numpy(last), n)
    assert torch.equal(ranks, rr) and torch.equal(used, ru)
    out = rle2.rle2_encode(ranks, n, used.sum() + 1)
    ref = rle2.rle2_encode_ref(ranks, n, int(used.sum()) + 1)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert all(torch.equal(a, b) for a, b in zip(rle2.rle2_encode_used(ranks, n, used), ref))
    assert out[0].dtype == torch.uint16
    assert (mtf.LAUNCHES, rle2.LAUNCHES) == before


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        mtf.mtf_ranks(torch.zeros(C, dtype=torch.uint8, device="meta"), 1)
    with pytest.raises(ValueError, match="unsupported device"):
        rle2.rle2_encode(torch.zeros(C, dtype=torch.int32, device="meta"), 1, 2)


def test_input_checks_of_the_cuda_branches():
    """What the CUDA kernels do not take raises before a launch."""
    ok = torch.zeros(2 * C, dtype=torch.uint8)
    mtf._check(ok, 2 * C, C)
    for bad, args in [(TypeError, (ok.to(torch.int32), 1, C)), (ValueError, (ok, 1, 128)),
                      (ValueError, (ok[:300], 1, C)), (ValueError, (ok, 2 * C + 1, C)),
                      (ValueError, (torch.zeros(1 << 22, dtype=torch.uint8), 1, C)),
                      (ValueError, (torch.zeros(4 * C, dtype=torch.uint8)[::2], 1, C))]:
        with pytest.raises(bad):
            mtf._check(*args)
    r = torch.zeros(64, dtype=torch.int32)
    rle2._check(r, 64)
    for bad, args in [(TypeError, (r.long(), 1)), (ValueError, (r, 65)), (ValueError, (r, -1)),
                      (ValueError, (r[1:], 1)), (ValueError, (r[::2], 1)),
                      (ValueError, (torch.zeros(rle2.MAX_OUT - 8, dtype=torch.int32), 1))]:
        with pytest.raises(bad):
            rle2._check(*args)


@pytest.mark.parametrize("fn", [mtf.mtf_ranks, rle2.rle2_encode], ids=["mtf", "rle2"])
def test_cuda_branches_leave_the_work_to_the_kernels(fn):
    """The CUDA branch of each wrapper (after its CPU return, through
    rle2's _one_block, which rle2_encode and rle2_encode_used share) calls
    no sort, scan, bincount or index scatter of torch, and no sum for the
    EOB: the kernels do that work."""
    import inspect

    src = inspect.getsource(fn)
    branch = src[src.index('if dev.type != "cuda"'):]
    if "_one_block(" in branch:
        branch += inspect.getsource(rle2._one_block)
    for word in ("sort", "cummax", "cummin", "cumsum", "bincount", "scatter", "index_put",
                 "_ref(", "mtf_parts", ".sum("):
        assert word not in branch, word
    assert "lib.tpubz_" in branch or 'enqueue("tpubz_' in branch

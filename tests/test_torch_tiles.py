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
from tpubz_torch.kernels import mtf, rle2

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


def emulate_rle2(ranks, n, eob, threads, per, scan_threads):
    """csrc/rle2.cu's three kernels on numpy arrays, tiles of threads * per
    ranks and the tile scan in rounds of scan_threads: (syms, rle2_len,
    freqs). Every output slot must be written exactly once."""
    size = ranks.size
    tile = threads * per
    nb = -(-size // tile)
    out_len = size + 8
    r_all = np.zeros(nb * tile, np.int64)
    r_all[:size] = ranks  # positions at or past N read as 0
    nz_all = (np.arange(nb * tile) < n) & (r_all != 0)
    big = np.iinfo(np.int32).max
    syms = np.full(out_len, -7)
    writes = np.zeros(out_len, np.int64)

    def write(at, val):
        syms[at] = val
        np.add.at(writes, at, 1)

    def thread_view(b):
        pos = b * tile + np.arange(tile).reshape(threads, per)
        return pos, r_all[pos], nz_all[pos]

    def walk(pos, nz, prev, count_first):
        """Each thread's emit count from its previous nonzero `prev`; with
        count_first False a thread at -1 skips its first run's digits."""
        emit = np.zeros(threads, np.int64)
        p = prev.copy()
        for k in range(per):
            m = nz[:, k]
            d = np.where((p >= 0) | count_first, _num_digits(pos[:, k] - p - 1), 0)
            emit += np.where(m, d + 1, 0)
            p = np.where(m, pos[:, k], p)
        return emit

    # rle2_tile_stats
    stats = []
    for b in range(nb):
        pos, _, nz = thread_view(b)
        first = np.where(nz, pos, big).min(1)
        last = np.where(nz, pos, -1).max(1)
        prev = _excl_scan(last, np.maximum, -1)
        emit = walk(pos, nz, prev, False)
        stats.append((first.min(), last.max(), emit.sum()))
    stats = np.array(stats, np.int64).reshape(nb, 3)
    # rle2_scan
    carry = np.zeros((nb, 2), np.int64)
    last_nz, body = -1, 0
    for b0 in range(0, nb, scan_threads):
        st = np.full((scan_threads, 3), (big, -1, 0), np.int64)
        st[: min(scan_threads, nb - b0)] = stats[b0 : b0 + scan_threads]
        prev = np.maximum(_excl_scan(st[:, 1], np.maximum, -1), last_nz)
        emit = np.where(st[:, 1] >= 0, st[:, 2] + _num_digits(st[:, 0] - prev - 1), 0)
        off = _excl_scan(emit, np.add, 0) + body
        real = min(scan_threads, nb - b0)
        carry[b0 : b0 + real] = np.stack((prev, off), 1)[:real]
        last_nz = max(last_nz, st[:, 1].max())
        body += emit.sum()
    tail = n - 1 - last_nz
    tail_digits = int(_num_digits(tail))
    length = body + tail_digits + 1
    digits = ((tail + 1) >> np.arange(tail_digits)) & 1
    freqs = np.bincount(np.append(digits, eob), minlength=258)[:258].astype(np.int64)
    write(body + np.arange(tail_digits), digits)
    write(np.arange(max(length, nb * tile), out_len), 0)
    write(np.array([length - 1]), eob)
    # rle2_write
    for b in range(nb):
        pos, r, nz = thread_view(b)
        last = np.where(nz, pos, -1).max(1)
        prev = np.maximum(_excl_scan(last, np.maximum, -1), carry[b, 0])
        off = _excl_scan(walk(pos, nz, prev, True), np.add, 0) + carry[b, 1]
        p = prev.copy()
        for k in range(per):
            m = nz[:, k]
            run = pos[:, k] - p - 1
            d = np.where(m, _num_digits(run), 0)
            for q in range(int(d.max(initial=0))):
                w = q < d
                digit = ((run[w] + 1) >> q) & 1
                write(off[w] + q, digit)
                np.add.at(freqs, digit, 1)
            write(off[m] + d[m], r[m, k] + 1)
            np.add.at(freqs, r[m, k] + 1, 1)
            off = np.where(m, off + d + 1, off)
            p = np.where(m, pos[:, k], p)
        write(np.arange(max(b * tile, length), min((b + 1) * tile, out_len)), 0)
    assert (writes == 1).all(), "an output slot was written twice or never"
    return syms, length, freqs


def _check_rle2(ranks, n, eob, shape):
    syms, length, freqs = emulate_rle2(ranks, n, eob, *shape)
    jsyms, jlen, jfreqs = _jax_rle2(jnp.asarray(ranks, jnp.int32), jnp.int32(n), jnp.int32(eob))
    assert length == int(jlen)
    assert np.array_equal(syms[:length], np.asarray(jsyms)[:length].astype(np.int64))
    assert np.array_equal(freqs, np.asarray(jfreqs).astype(np.int64))
    psyms, plen, pfreqs = rle2.rle2_encode_ref(torch.from_numpy(ranks.astype(np.int32)), n, eob)
    assert length == int(plen)
    assert np.array_equal(syms, psyms.numpy()) and np.array_equal(freqs, pfreqs.numpy())


# (threads, ranks a thread, scan threads): tiles of 16, 32 and 64 ranks
SHAPES = [(4, 4, 2), (8, 4, 3), (16, 4, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=["t16", "t32", "t64"])
@pytest.mark.parametrize("case", CASE_IDS)
def test_rle2_tiles_match_tpubz(case, shape):
    """The RLE2 kernels' decomposition on the MTF ranks of each case, with
    tiles of 16-64 ranks and the tile scan in rounds of 2-4, gives tpubz's
    symbols, length and frequencies, and the port's plain version on every
    slot (zeros past the stream)."""
    last, n = _last(case)
    ranks, used = mtf.mtf_ranks_ref(torch.from_numpy(last), n)
    _check_rle2(ranks.numpy().astype(np.int64), n, int(used.sum()) + 1, shape)


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


@pytest.mark.parametrize("shape", SHAPES + [(256, 16, 1024)], ids=["t16", "t32", "t64", "t4096"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle2_tiles_on_long_zero_runs(seed, shape):
    """Random ranks with long zero runs, n not a multiple of the tile, and
    the kernels' own tile (4096 = 256 threads x 16)."""
    size = 16384
    n = size - 1000 - seed
    _check_rle2(_runs(seed, size, n), n, 200 + seed, shape)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096])
def test_rle2_tiles_at_the_edges(n):
    """No valid rank, one zero, zeros with a nonzero pad lane after them,
    and zeros closed by a nonzero in the last slot."""
    ranks = np.zeros(N, np.int64)
    ranks[-1] = 9
    _check_rle2(ranks, n, 1 + (n > 0), (8, 4, 3))


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
                      (ValueError, (r[1:], 1)), (ValueError, (r[::2], 1))]:
        with pytest.raises(bad):
            rle2._check(*args)


@pytest.mark.parametrize("fn", [mtf.mtf_ranks, rle2.rle2_encode], ids=["mtf", "rle2"])
def test_cuda_branches_leave_the_work_to_the_kernels(fn):
    """The CUDA branch of each wrapper (after its CPU return) calls no
    sort, scan, bincount or index scatter of torch: the kernels do that
    work."""
    import inspect

    src = inspect.getsource(fn)
    branch = src[src.index('if dev.type != "cuda"'):]
    for word in ("sort", "cummax", "cummin", "cumsum", "bincount", "scatter", "index_put",
                 "_ref(", "mtf_parts"):
        assert word not in branch, word
    assert "lib.tpubz_" in branch

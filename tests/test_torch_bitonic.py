"""The port's bitonic sort (tpubz_torch.kernels.bitonic) against the Pallas
kernels of tools/probe_pallas_sort.py and tools/probe_pallas_pass.py, on the
CPU.

The same seeded inputs, made with numpy, go through the Pallas kernels'
network and through the plain torch versions that the CUDA kernels are held
to on the card. The network's body ``_bitonic_body`` runs eagerly with its
module's shape globals cut to (16, 16) and (64, 64) (a jit of the unrolled
network, or ``pallas_call`` in interpret mode, takes most of a minute to
compile); the single passes ``_cex_row`` and ``_cex_lane`` run at their full
(1024, 1024) shape. Keys and payloads are integers, so every comparison is
bit-exact: tolerance 0, payload order on duplicate keys included.
"""
import importlib.util
import inspect
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpubz.hostref.bwt import bwt_encode
from tpubz_torch.kernels import bitonic, radix, suffix_sort
from tpubz_torch.kernels.suffix_sort import bwt_forward

# the test workers share the host's cores: keep torch's intra-op pool small
torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_probe(name, monkeypatch, tmp_path):
    """A tools/ probe module, imported from its file (both call
    setup_jax_cache() at import, so the cache goes to tmp_path)."""
    monkeypatch.setenv("TPUBZ_JAX_CACHE", str(tmp_path))
    spec = importlib.util.spec_from_file_location(
        f"_probe_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def probe_sort(monkeypatch, tmp_path):
    return _load_probe("probe_pallas_sort", monkeypatch, tmp_path)


@pytest.fixture
def probe_pass(monkeypatch, tmp_path):
    return _load_probe("probe_pallas_pass", monkeypatch, tmp_path)


@pytest.mark.parametrize("op", ["1op", "2op"])
@pytest.mark.parametrize("rows,cols,log2n", [(16, 16, 8), (64, 64, 12)])
def test_network_matches_pallas_body(probe_sort, monkeypatch, rows, cols, log2n, op):
    """_bitonic_body (the body of the Pallas bitonic_1op and bitonic_2op),
    run eagerly at (rows, cols), equals bitonic_1op_ref / bitonic_2op_ref on
    seeded keys in [0, 50): keys, and the payload order on the many
    duplicate keys."""
    monkeypatch.setattr(probe_sort, "R", rows)
    monkeypatch.setattr(probe_sort, "C", cols)
    monkeypatch.setattr(probe_sort, "LOG2N", log2n)
    rng = np.random.default_rng(log2n)
    keys = rng.integers(0, 50, 1 << log2n).astype(np.int32)
    payload = rng.permutation(1 << log2n).astype(np.int32)
    jpay = jnp.asarray(payload.reshape(rows, cols)) if op == "2op" else None
    jk, jp = probe_sort._bitonic_body(jnp.asarray(keys.reshape(rows, cols)), jpay)
    if op == "1op":
        got = bitonic.bitonic_1op_ref(torch.from_numpy(keys))
        assert np.array_equal(got.numpy(), np.asarray(jk).reshape(-1))
    else:
        gk, gp = bitonic.bitonic_2op_ref(torch.from_numpy(keys), torch.from_numpy(payload))
        assert np.array_equal(gk.numpy(), np.asarray(jk).reshape(-1))
        assert np.array_equal(gp.numpy(), np.asarray(jp).reshape(-1))
    assert np.array_equal(np.asarray(jk).reshape(-1), np.sort(keys))


@pytest.mark.parametrize("case,js", [
    ("row2", [19, 18]),
    ("lane8", [9, 8, 7, 6, 5, 4, 3, 2]),
])
def test_stage_passes_match_pallas_passes(probe_pass, case, js):
    """The probe's make_stage_kernel cases: _cex_row (row distances) and
    _cex_lane (lane distances) at (1024, 1024) with k = 20, pass after pass,
    equal stage_passes_ref and the CPU wrapper, in place."""
    rng = np.random.default_rng(len(js))
    keys = rng.integers(0, 1 << 30, 1 << 20).astype(np.int32)
    cex = probe_pass._cex_row if case.startswith("row") else probe_pass._cex_lane
    x = jnp.asarray(keys.reshape(1024, 1024))
    for j in js:
        x = cex(x, j, 20)
    want = np.asarray(x).reshape(-1)
    t = torch.from_numpy(keys.copy())
    assert bitonic.stage_passes_ref(t, js) is t
    assert np.array_equal(t.numpy(), want)
    t = torch.from_numpy(keys.copy())
    assert bitonic.stage_passes(t, js) is t
    assert np.array_equal(t.numpy(), want)


@pytest.mark.parametrize("length", [1, 2, 64, 1 << 11, 1 << 14])
def test_int64_refs_match_torch_sort_on_unique_keys(length):
    """On unique int64 keys (the BWT's case) the order is unique: both refs
    and the CPU wrappers give torch.sort's values and indices."""
    rng = np.random.default_rng(length)
    keys = torch.from_numpy(rng.choice(1 << 56, length, replace=False).astype(np.int64))
    original = keys.clone()
    pos = torch.arange(length, dtype=torch.int32)
    want = torch.sort(keys)
    assert torch.equal(bitonic.bitonic_1op_ref(keys), want.values)
    assert torch.equal(bitonic.bitonic_1op(keys), want.values)
    for k, p in (bitonic.bitonic_2op_ref(keys, pos), bitonic.bitonic_2op(keys, pos)):
        assert torch.equal(k, want.values)
        assert torch.equal(p.long(), want.indices)
    assert torch.equal(keys, original)  # the sorts leave their inputs alone


def test_the_network_is_the_pallas_one():
    """network(m) lists the Pallas body's passes: k = 1..m, j = k-1..0,
    m(m+1)/2 of them (210 at 2^20)."""
    assert bitonic.network(2) == [(1, 0), (2, 1), (2, 0)]
    assert len(bitonic.network(20)) == 210
    assert bitonic.network(0) == []


def test_inputs_are_checked_and_cpu_calls_are_not_counted():
    """Lengths that are not a power of two, or above 2^20, key and payload
    types the kernel does not take, mismatched shapes and pass distances
    outside the array raise; a CPU call runs the plain version and counts
    no launch."""
    before = (bitonic.LAUNCHES, dict(bitonic.CALLS), bitonic.PASS_LAUNCHES)
    k = torch.arange(8, dtype=torch.int32).flip(0)
    assert torch.equal(bitonic.bitonic_1op(k), k.flip(0))
    bitonic.bitonic_2op(k, k.clone())
    bitonic.stage_passes(k.clone(), [2, 0])
    assert (bitonic.LAUNCHES, bitonic.CALLS, bitonic.PASS_LAUNCHES) == before
    for bad in (torch.zeros(1 << 21, dtype=torch.int32), torch.zeros(3, dtype=torch.int32),
                torch.zeros(1000, dtype=torch.int64), torch.zeros(0, dtype=torch.int32)):
        with pytest.raises(ValueError):
            bitonic.bitonic_1op(bad)
    with pytest.raises(TypeError):
        bitonic.bitonic_1op(torch.zeros(8, dtype=torch.int16))
    with pytest.raises(TypeError):
        bitonic.bitonic_2op(k, k.long())
    with pytest.raises(ValueError):
        bitonic.bitonic_2op(k, k[:4])
    with pytest.raises(ValueError):
        bitonic.bitonic_1op(k.view(2, 4))
    with pytest.raises(ValueError):
        bitonic.stage_passes(k, [3])
    with pytest.raises(ValueError):
        bitonic.stage_passes(k, [-1])


def test_bwt_forward_sorts_only_through_radix(monkeypatch):
    """bwt_forward's doubling rounds go through radix_sort_ref, one sort a
    round, with torch.sort and the bitonic sorts out of reach; the module
    names neither torch.sort nor the bitonic sorts."""
    source = inspect.getsource(suffix_sort)
    assert "torch.sort" not in source and "bitonic" not in source
    calls = []

    def counted(keys, *args):
        calls.append(keys.numel())
        return radix.radix_sort_ref(keys, *args)

    def no_sort(*args, **kwargs):
        raise AssertionError("torch.sort or a bitonic sort called")

    monkeypatch.setattr(suffix_sort, "radix_sort_ref", counted)
    monkeypatch.setattr(torch, "sort", no_sort)
    for name in ("bitonic_1op", "bitonic_2op", "bitonic_1op_ref", "bitonic_2op_ref"):
        monkeypatch.setattr(bitonic, name, no_sort)
    c = b"mississippi banana " * 20 + b"!"
    data = torch.zeros(512, dtype=torch.uint8)
    data[: len(c)] = torch.frombuffer(bytearray(c), dtype=torch.uint8)
    key, last = bwt_forward(data, len(c))
    hkey, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    assert int(key) == hkey and np.array_equal(last.numpy()[: len(c)], hlast)
    assert len(calls) >= 2 and calls[0] == len(c) and all(m < len(c) for m in calls[1:])


@pytest.mark.parametrize("n", [2, 3, 1024, 1025, 5000])
def test_bwt_forward_at_padding_edges(n):
    """n at and just past a power of two, in a buffer with pad lanes: key
    and last column equal the host oracle, pad lanes zero, in no more
    rounds than the cap. Bit-exact."""
    rng = np.random.default_rng(n)
    c = rng.integers(0, 3, n, dtype=np.uint8)
    data = torch.zeros(n + 7, dtype=torch.uint8)
    data[:n] = torch.from_numpy(c)
    key, last = bwt_forward(data, n)
    hkey, hlast = bwt_encode(c)
    assert int(key) == hkey
    assert np.array_equal(last.numpy()[:n], hlast)
    assert not last.numpy()[n:].any()
    rounds = sum(1 for _ in suffix_sort._doubling(data[:n]))
    assert 1 <= rounds <= suffix_sort.round_cap(n)


# (tile_log2, regs_log2); a 2^14 tile takes 2^5 registers
_SHAPES = [(12, 3), (12, 4), (13, 3), (13, 4), (14, 4)]


def _check_launch_limits(launches, log2n, tile_log2, fuse):
    t = min(tile_log2, log2n)
    for launch in launches:
        if launch[0] == "global":
            _, k, j_lo, r = launch
            assert 1 <= r <= fuse and j_lo >= t and k > j_lo + r - 1
            continue
        _, lt, R, groups = launch
        assert lt == t and 1 <= R <= min(bitonic.MAX_REGS_LOG2, t)
        assert t - R <= bitonic.tile_threads_log2(R)
        assert 1 <= len(groups) <= bitonic.MAX_GROUPS
        assert sum(len(ps) for _, ps in groups) <= bitonic.MAX_TILE_PASSES
        for bits, ps in groups:
            assert len(bits) == R and list(bits) == sorted(set(bits)) and max(bits) < t
            assert ps and all(j in bits for _, j in ps)


@pytest.mark.parametrize("tile_log2,regs_log2", _SHAPES, ids=["t12r3", "t12r4", "t13r3", "t13r4", "t14"])
@pytest.mark.parametrize("log2n", range(1, 21))
def test_plan_runs_exactly_the_network(log2n, tile_log2, regs_log2):
    """For every fuse width, the launch plan of a sort of 2^log2n keys runs
    network(log2n), pass for pass and in order, within the kernels' limits
    (tile threads, register bits, passes and groups per launch), and its
    encoding has one record per launch."""
    for fuse in range(1, bitonic.MAX_REGS_LOG2 + 1):
        launches = bitonic.plan(bitonic.network(log2n), log2n, tile_log2, regs_log2, fuse)
        assert bitonic.plan_passes(launches) == bitonic.network(log2n)
        _check_launch_limits(launches, log2n, tile_log2, fuse)
        words = bitonic.encode(launches)
        assert words.count(0) >= sum(1 for x in launches if x[0] == "global")
        assert words[0] in (0, 1)


@pytest.mark.parametrize("js", [[19, 18], list(range(19, 11, -1)), [9, 8], list(range(9, 1, -1)),
                                [0, 15, 3, 11, 10, 12, 1], [5, 5, 4, 19, 19, 0]],
                         ids=["row2", "row8", "lane2", "lane8", "mixed", "repeats"])
def test_plan_runs_the_given_stage_passes(js):
    """stage_passes' plan at 2^20 runs the given js, in order (k = 20)."""
    for tile_log2, regs_log2 in _SHAPES:
        for fuse in (1, 4, 5):
            passes = [(20, j) for j in js]
            launches = bitonic.plan(passes, 20, tile_log2, regs_log2, fuse)
            assert bitonic.plan_passes(launches) == passes
            _check_launch_limits(launches, 20, tile_log2, fuse)


def test_default_plan_cuts_the_launches():
    """The default plan of a 2^20 sort makes 21 kernel launches, against the
    55 of one launch per long pass and per tile run; a 2^13 tile with fuse 5
    makes 17 and a 2^14 tile 14."""
    assert len(bitonic.plan(bitonic.network(20), 20)) == 21
    assert len(bitonic.plan(bitonic.network(20), 20, 13, 4, 5)) == 17
    assert len(bitonic.plan(bitonic.network(20), 20, 14, 4, 5)) == 14


def _insert_zeros(x, bits):
    for b in bits:
        x = ((x >> b) << (b + 1)) | (x & ((1 << b) - 1))
    return x


def _cex_regs(rk, rp, lo, hi, desc):
    """The kernels' compare-exchange on register columns lo, hi: swap only
    where the pair is strictly out of order for its direction."""
    a, b = rk[:, lo].copy(), rk[:, hi].copy()
    sw = np.where(desc, a < b, b < a)
    rk[:, lo], rk[:, hi] = np.where(sw, b, a), np.where(sw, a, b)
    if rp is not None:
        pa, pb = rp[:, lo].copy(), rp[:, hi].copy()
        rp[:, lo], rp[:, hi] = np.where(sw, pb, pa), np.where(sw, pa, pb)


def _emulate(keys, payload, launches, log2n):
    """The plan on numpy arrays with the kernels' index math: each thread's
    base (its index with zeros at the register bits), its registers'
    offsets, the direction from bit k of the lower index (a register bit's
    or the thread's), the passes on register columns. Every group's threads
    cover each tile exactly once."""
    n = 1 << log2n
    keys = keys.copy()
    payload = None if payload is None else payload.copy()
    for launch in launches:
        if launch[0] == "global":
            _, k, j_lo, r = launch
            t = np.arange(n >> r)
            low = t & ((1 << j_lo) - 1)
            base = ((t - low) << r) | low
            idx = base[:, None] + (np.arange(1 << r) << j_lo)[None, :]
            steps = [(q, k, -1) for q in range(r - 1, -1, -1)]
            groups = [(idx, base, steps)]
        else:
            _, t, R, glist = launch
            tiles = np.arange(n >> t) << t
            tid = np.arange((1 << t) >> R)
            groups = []
            for bits, ps in glist:
                tbase = (tiles[:, None] + _insert_zeros(tid, bits)[None, :]).reshape(-1)
                off = np.array([sum(((c >> i) & 1) << bits[i] for i in range(R))
                                for c in range(1 << R)])
                steps = [(bits.index(j), k, bits.index(k) if k in bits else -1) for k, j in ps]
                groups.append((tbase[:, None] + off[None, :], tbase, steps))
        for idx, base, steps in groups:
            flat = np.sort(idx.reshape(-1))
            assert np.array_equal(flat, np.arange(n))
            rk = keys[idx]
            rp = None if payload is None else payload[idx]
            E = idx.shape[1]
            for q, k, qk in steps:
                for c in range(E):
                    if c >> q & 1:
                        continue
                    desc = (np.full(base.shape, (c >> qk) & 1, bool) if qk >= 0
                            else ((base >> k) & 1).astype(bool))
                    _cex_regs(rk, rp, c, c | 1 << q, desc)
            keys[idx] = rk
            if payload is not None:
                payload[idx] = rp
    return keys, payload


@pytest.mark.parametrize("dtype", [np.int32, np.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("log2n,tile_log2,regs_log2,fuse", [
    (4, 3, 2, 1), (9, 6, 2, 2), (11, 7, 3, 3), (12, 9, 4, 4), (13, 8, 5, 5), (14, 13, 4, 4),
])
def test_emulated_plan_equals_the_plain_sort(log2n, tile_log2, regs_log2, fuse, dtype):
    """Run group by group with the kernels' index math, the plan of a sort
    gives bitonic_2op_ref's keys and payload on keys with many ties, and
    stage_passes' plan gives stage_passes_ref's keys: tolerance 0."""
    rng = np.random.default_rng(log2n)
    n = 1 << log2n
    keys = rng.integers(0, max(n // 8, 2), n).astype(dtype)
    payload = rng.permutation(n).astype(np.int32)
    launches = bitonic.plan(bitonic.network(log2n), log2n, tile_log2, regs_log2, fuse)
    gk, gp = _emulate(keys, payload, launches, log2n)
    rk, rp = bitonic.bitonic_2op_ref(torch.from_numpy(keys), torch.from_numpy(payload))
    assert np.array_equal(gk, rk.numpy()) and np.array_equal(gp, rp.numpy())
    js = [log2n - 1, 0, log2n - 2, 1, 2, log2n - 1]
    launches = bitonic.plan([(log2n, j) for j in js], log2n, tile_log2, regs_log2, fuse)
    gk, _ = _emulate(keys, None, launches, log2n)
    want = bitonic.stage_passes_ref(torch.from_numpy(keys.copy()), js)
    assert np.array_equal(gk, want.numpy())

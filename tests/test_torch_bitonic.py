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
from tpubz_torch.kernels import bitonic, suffix_sort
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


def test_bwt_forward_sorts_only_through_bitonic(monkeypatch):
    """bwt_forward's doubling rounds go through bitonic_2op and its last
    column through one bitonic_1op, with torch.sort out of reach; the
    module does not name torch.sort at all."""
    assert "torch.sort" not in inspect.getsource(suffix_sort)
    calls = {"1op": 0, "2op": 0}

    def counted(name, fn):
        def wrap(*args):
            calls[name] += 1
            return fn(*args)
        return wrap

    def no_sort(*args, **kwargs):
        raise AssertionError("torch.sort called")

    monkeypatch.setattr(suffix_sort, "bitonic_1op", counted("1op", bitonic.bitonic_1op))
    monkeypatch.setattr(suffix_sort, "bitonic_2op", counted("2op", bitonic.bitonic_2op))
    monkeypatch.setattr(torch, "sort", no_sort)
    c = b"mississippi banana " * 20
    data = torch.zeros(512, dtype=torch.uint8)
    data[: len(c)] = torch.frombuffer(bytearray(c), dtype=torch.uint8)
    key, last = bwt_forward(data, len(c))
    hkey, hlast = bwt_encode(np.frombuffer(c, np.uint8))
    assert int(key) == hkey and np.array_equal(last.numpy()[: len(c)], hlast)
    assert calls["1op"] == 1 and calls["2op"] >= 2


@pytest.mark.parametrize("n", [2, 3, 1024, 1025, 5000])
def test_bwt_forward_at_padding_edges(n):
    """n at and just past a power of two (P = n, and P = 2n - 2 with almost
    half of it INT64_MAX padding): key and last column equal the host
    oracle, pad lanes zero. Bit-exact."""
    rng = np.random.default_rng(n)
    c = rng.integers(0, 3, n, dtype=np.uint8)
    data = torch.zeros(n + 7, dtype=torch.uint8)
    data[:n] = torch.from_numpy(c)
    key, last = bwt_forward(data, n)
    hkey, hlast = bwt_encode(c)
    assert int(key) == hkey
    assert np.array_equal(last.numpy()[:n], hlast)
    assert not last.numpy()[n:].any()
    assert suffix_sort.padded_length(n) == 1 << (n - 1).bit_length()

"""The port's hybrid scheduler against tpubz, on the CPU.

The counterparts of tpubz's hybrid, stage, straggler and rig-profile tests
(``tests/test_device_stream.py``, ``tests/test_rigprofile.py``) on
``tpubz_torch.stream.api`` with ``device="cpu"``: the device blocks run the
kernels' plain torch versions, the CPU pool runs tpubz's native engine.
Every stream is compared byte for byte (tolerance 0) with
``tpubz.stream.api.compress_cpu`` and the numpy oracle
``tpubz.hostref.stream.compress``. Inputs are made with numpy from a seed,
at level 1. Every call that starts threads runs under a 60 s bound.
"""
import json
import os
import threading
import time

import numpy as np
import pytest

import torch

from tpubz.hostref.stream import compress as oracle
from tpubz.stream import rigprofile as tpubz_rigprofile
from tpubz.stream.api import compress_cpu

import tpubz_torch
from tpubz_torch.block.encode import DeviceBlockEncoder
from tpubz_torch.stream import api as papi
from tpubz_torch.stream import rigprofile

# the test workers share the host's cores: keep torch's intra-op pool small
torch.set_num_threads(2)

BOUND_S = 60.0


def bounded(fn, *args, **kwargs):
    """fn(*args, **kwargs) on a daemon thread; fails the test after 60 s."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(BOUND_S)
    if t.is_alive():
        pytest.fail(f"{getattr(fn, '__name__', fn)} still running after {BOUND_S} s")
    if "error" in box:
        raise box["error"]
    return box["value"]


@pytest.fixture(autouse=True)
def fresh_scheduler(tmp_path, monkeypatch):
    """A fresh port profile under its own TPUBZ_TORCH_CACHE, fresh process
    estimates and no cached device encoder."""
    monkeypatch.setenv("TPUBZ_TORCH_CACHE", str(tmp_path / "torch_cache"))
    for name in ("TPUBZ_DEVICE_STAGE", "TPUBZ_WINDOW", "TPUBZ_MIN_DEVICE_BLOCKS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(papi, "_cpu_ema_g", [0.0])
    monkeypatch.setattr(papi, "_reprobe_left_g", [1])
    monkeypatch.setattr(papi, "_encoders", {})
    papi._dev_done_g.clear()
    rigprofile.reset_memo()
    yield
    rigprofile.reset_memo()


def _multi_block(seed: int = 3) -> bytes:
    """~260 KB that RLE1 cuts into 3 level-1 blocks."""
    rng = np.random.default_rng(seed)
    return (
        b"hybrid scheduler corpus " * 4000
        + bytes(rng.integers(0, 80, 120_000, dtype=np.uint8))
        + b"ab" * 20_000
        + bytes(rng.integers(0, 256, 12_000, dtype=np.uint8))
    )


def _one_block(seed: int = 5, size: int = 20_000) -> bytes:
    rng = np.random.default_rng(seed)
    return b"one block " * 500 + bytes(rng.integers(0, 40, size - 5000, dtype=np.uint8))


@pytest.fixture
def spy(monkeypatch):
    """Counts DeviceBlockEncoder.transform and transform_bwt calls."""
    calls = {"full": 0, "bwt": 0}
    real_full, real_bwt = DeviceBlockEncoder.transform, DeviceBlockEncoder.transform_bwt

    def full(self, blk):
        calls["full"] += 1
        return real_full(self, blk)

    def bwt(self, blk):
        calls["bwt"] += 1
        return real_bwt(self, blk)

    monkeypatch.setattr(DeviceBlockEncoder, "transform", full)
    monkeypatch.setattr(DeviceBlockEncoder, "transform_bwt", bwt)
    return calls


@pytest.mark.parametrize("stage", ["bwt", "full"])
@pytest.mark.parametrize("hybrid", ["on", "off"])
def test_routes_match_tpubz(monkeypatch, spy, hybrid, stage):
    """The hybrid on (TPUBZ_HYBRID_CPU=2) and off, on each device stage:
    the stream equals compress_cpu and the oracle, and the device ran the
    stage asked for on every device block."""
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "2" if hybrid == "on" else "0")
    monkeypatch.setenv("TPUBZ_DEVICE_STAGE", stage)
    d = _multi_block()
    got = bounded(tpubz_torch.compress, d, 1, device="cpu")
    st = papi.last_stream_stats
    assert got == compress_cpu(d, 1) == oracle(d, 1)
    assert st["blocks"] == 3 and st["stage"] == stage
    assert st["dev_blocks"] + st["cpu_blocks"] == 3
    assert st["dev_blocks"] >= 1  # the probe block always goes to the device
    assert spy[stage] == st["dev_blocks"] and spy["full" if stage == "bwt" else "bwt"] == 0
    if hybrid == "on":
        assert st["engine"] == "hybrid" and st["cpu_workers"] == 2
        assert st["window"] == papi.HYBRID_WINDOW
    else:
        assert st["engine"] == "device" and st["cpu_blocks"] == 0
        assert st["window"] == papi.WINDOW
    assert tpubz_torch.decompress(got) == d


def test_straggler_device_head_twinned_on_cpu(monkeypatch):
    """A slow device head block is twinned on a free CPU worker; the first
    result wins the ordered drain and the bytes are the same. The stream
    still joins the device block before it returns."""
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "4")
    monkeypatch.setenv("TPUBZ_DEVICE_STAGE", "full")
    real = DeviceBlockEncoder.transform
    slept = []

    def slow(self, blk):
        slept.append(time.time())
        time.sleep(1.5)
        return real(self, blk)

    monkeypatch.setattr(DeviceBlockEncoder, "transform", slow)
    d = _multi_block(8)
    t0 = time.time()
    got = bounded(tpubz_torch.compress, d, 1, device="cpu")
    assert slept and time.time() - t0 >= 1.5
    assert got == compress_cpu(d, 1) == oracle(d, 1)
    dev = {i for kind, i, _, _ in papi.last_stream_events if kind == "dev"}
    cpu = [i for kind, i, _, _ in papi.last_stream_events if kind == "cpu"]
    assert dev and dev & set(cpu), "the device head was never twinned"


def test_concurrent_compress_calls(monkeypatch):
    """compress from several threads at once, hybrid on: each stream equals
    compress_cpu of its input."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "2")
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    inputs = [_one_block(s, 30_000) + _multi_block(s)[:120_000] for s in range(3)]

    def run_all():
        with ThreadPoolExecutor(3) as ex:
            return list(ex.map(lambda d: tpubz_torch.compress(d, 1, device="cpu"), inputs))

    for d, z in zip(inputs, bounded(run_all)):
        assert z == compress_cpu(d, 1)


def test_device_on_the_host_cpu_routes_to_the_pool(monkeypatch):
    """With the device on the host's own CPU and no explicit hybrid, every
    block goes to the native pool (tpubz's dev_is_host)."""
    monkeypatch.delenv("TPUBZ_HYBRID_CPU", raising=False)
    d = _multi_block(4)
    got = bounded(tpubz_torch.compress, d, 1, device="cpu")
    st = papi.last_stream_stats
    assert got == compress_cpu(d, 1)
    assert st["engine"] == "hybrid" and st["dev_blocks"] == 0 and st["cpu_blocks"] == 3


@pytest.mark.parametrize("min_blocks,engine", [(None, "cpu"), ("1", "device")])
def test_tiny_stream_routing(monkeypatch, min_blocks, engine):
    """A 1-block stream goes to the CPU engine unless TPUBZ_MIN_DEVICE_BLOCKS
    lets it onto the device; the bytes are the same."""
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "0")
    if min_blocks:
        monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", min_blocks)
    d = _one_block()
    got = bounded(tpubz_torch.compress, d, 1, device="cpu")
    assert papi.last_stream_stats["engine"] == engine
    assert got == compress_cpu(d, 1) == oracle(d, 1)


def test_compress_cpu_is_the_native_engine():
    d = _multi_block(6)
    assert bounded(tpubz_torch.compress_cpu, d, 1) == oracle(d, 1)
    assert papi.last_stream_stats["engine"] == "cpu"
    assert papi.last_stream_stats["cpu_blocks"] == 3


def test_settings_read_tpubz_names(monkeypatch):
    for name, value in (("TPUBZ_DEVICE_STAGE", "bwt"), ("TPUBZ_HYBRID_CPU", "5"),
                        ("TPUBZ_MIN_DEVICE_BLOCKS", "2"), ("TPUBZ_WINDOW", "7"),
                        ("TPUBZ_EMIT_THREADS", "4"), ("TPUBZ_FETCH_THREADS", "6")):
        monkeypatch.setenv(name, value)
    assert papi._settings() == {
        "stage": "bwt", "hybrid_cpu": 5, "min_device_blocks": 2, "window": 7,
        "emit_threads": 4, "fetch_threads": 6,
    }


def test_window_override_drains_a_hybrid_stream(monkeypatch):
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "2")
    monkeypatch.setenv("TPUBZ_WINDOW", "2")
    d = _multi_block(9)
    assert bounded(tpubz_torch.compress, d, 1, device="cpu") == compress_cpu(d, 1)
    assert papi.last_stream_stats["window"] == 2


def test_profile_trained_under_torch_cache_only(tmp_path, monkeypatch):
    """A device stream trains the port's profile under TPUBZ_TORCH_CACHE;
    tpubz's profile under TPUBZ_JAX_CACHE is neither read nor written."""
    jax_cache = tmp_path / "jax_cache"
    jax_cache.mkdir()
    theirs = jax_cache / "tpubz_rig_profile.json"
    theirs.write_text(json.dumps({"cpu_block_s": 9.0, "dev_cadence_s": {"bwt": 9.0}}))
    before = theirs.read_bytes()
    monkeypatch.setenv("TPUBZ_JAX_CACHE", str(jax_cache))
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "0")
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    monkeypatch.setenv("TPUBZ_DEVICE_STAGE", "bwt")
    d = _one_block()
    assert bounded(tpubz_torch.compress, d, 1, device="cpu") == compress_cpu(d, 1)
    ours = tmp_path / "torch_cache" / "tpubz_torch_rig_profile.json"
    assert rigprofile.path() == str(ours)
    prof = json.loads(ours.read_text())
    assert prof["dev_cadence_s"]["bwt"] > 0 and prof["host_leg_s"]["bwt"] > 0
    assert prof["dev_cadence_s"]["bwt"] < 9.0  # nothing read from tpubz's file
    assert theirs.read_bytes() == before
    assert sorted(os.listdir(jax_cache)) == ["tpubz_rig_profile.json"]


def test_profile_default_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("TPUBZ_TORCH_CACHE")
    monkeypatch.setenv("HOME", str(tmp_path))
    assert rigprofile.path() == str(tmp_path / ".cache" / "tpubz_torch"
                                    / "tpubz_torch_rig_profile.json")


def test_profile_update_emas_and_survives_the_memo():
    rigprofile.update(cpu_block_s=0.10, dev_cadence_s={"bwt": 0.03})
    rigprofile.update(cpu_block_s=0.20, dev_cadence_s={"full": 0.0})
    p = rigprofile.load()
    assert 0.10 < p["cpu_block_s"] < 0.20 and "full" not in p["dev_cadence_s"]
    rigprofile.reset_memo()
    assert rigprofile.load()["cpu_block_s"] == p["cpu_block_s"]


def test_unwritable_profile_costs_only_the_training(monkeypatch, tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    monkeypatch.setenv("TPUBZ_TORCH_CACHE", str(blocker / "sub"))
    rigprofile.update(cpu_block_s=0.1)
    assert rigprofile.load()["cpu_block_s"] == pytest.approx(0.1)


_THROTTLED = {  # the host legs are the bottleneck: the full chain wins
    "cpu_block_s": 0.8,
    "dev_cadence_s": {"bwt": 0.021, "full": 0.041},
    "host_leg_s": {"bwt": 0.30, "full": 0.10},
}
_FAST_HOST = {  # a fast host, a slower full chain: the bwt stage wins
    "cpu_block_s": 0.095,
    "dev_cadence_s": {"bwt": 0.033, "full": 0.061},
    "host_leg_s": {"bwt": 0.032, "full": 0.015},
}


@pytest.mark.parametrize("ours,theirs,want", [
    (_THROTTLED, _FAST_HOST, "full"),
    (_FAST_HOST, _THROTTLED, "bwt"),
    (None, _THROTTLED, "bwt"),
], ids=["throttled", "fast_host", "unmeasured"])
def test_auto_stage_reads_the_port_profile(monkeypatch, spy, ours, theirs, want):
    """TPUBZ_DEVICE_STAGE unset: the stage comes from choose_stage on the
    port's profile (bwt until both stages are measured), whatever tpubz's
    profile says."""
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "0")
    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    tpubz_rigprofile.update(**theirs)
    if ours:
        rigprofile.update(**ours)
    d = _one_block()
    assert bounded(tpubz_torch.compress, d, 1, device="cpu") == compress_cpu(d, 1)
    assert papi.last_stream_stats["stage"] == want
    assert spy[want] == 1 and sum(spy.values()) == 1


def test_stream_trains_cpu_and_device_fields(monkeypatch):
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "2")
    monkeypatch.setenv("TPUBZ_DEVICE_STAGE", "bwt")
    d = _multi_block(12)
    assert bounded(tpubz_torch.compress, d, 1, device="cpu") == oracle(d, 1)
    rigprofile.reset_memo()
    p = rigprofile.load()
    assert p["cpu_block_s"] > 0 and p["host_leg_s"]["bwt"] > 0
    assert p["dev_cadence_s"]["bwt"] > 0  # first contact trains from latency


def _faulty(monkeypatch, delay: float):
    """Every device block raises after ``delay`` seconds, on both stages."""
    def boom(self, blk):
        time.sleep(delay)
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(DeviceBlockEncoder, "transform", boom)
    monkeypatch.setattr(DeviceBlockEncoder, "transform_bwt", boom)


@pytest.mark.parametrize("hybrid", ["0", "4"])
def test_device_error_raises_from_compress(monkeypatch, hybrid):
    """A device block that raises fails the stream, with or without a CPU
    pool. With the pool, the device head's twin finishes first (the fault
    comes after 1 s), and the error is raised all the same."""
    monkeypatch.setenv("TPUBZ_HYBRID_CPU", hybrid)
    _faulty(monkeypatch, 1.0 if hybrid != "0" else 0.0)
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="injected device fault"):
        bounded(tpubz_torch.compress, _multi_block(13), 1, device="cpu")
    if hybrid != "0":
        # the twin delivered the head block before the device raised
        cpu = {i for kind, i, _, _ in papi.last_stream_events if kind == "cpu"}
        assert 0 in cpu
    leaked = [t for t in threading.enumerate() if t not in before and t.is_alive()
              and t.daemon is False]
    assert leaked == []


@pytest.mark.parametrize("surface", ["compress_stream", "bz2file_close", "compressor_flush"])
def test_device_error_raises_from_the_surfaces(monkeypatch, tmp_path, surface):
    import io

    from tpubz_torch.stream.files import compress_stream

    monkeypatch.setenv("TPUBZ_HYBRID_CPU", "4")
    _faulty(monkeypatch, 0.5)
    d = _multi_block(14)

    def run():
        if surface == "compress_stream":
            compress_stream(io.BytesIO(d), io.BytesIO(), 1, device="cpu")
        elif surface == "bz2file_close":
            f = tpubz_torch.BZ2File(tmp_path / "x.bz2", "wb", compresslevel=1, device="cpu")
            try:
                f.write(d)
            finally:
                f.close()
        else:
            c = tpubz_torch.BZ2Compressor(1, device="cpu")
            c.compress(d)
            c.flush()

    with pytest.raises(RuntimeError, match="injected device fault"):
        bounded(run)


def test_cuda_without_a_card_raises_for_one_block(monkeypatch, tmp_path):
    """device="cuda" with no usable card raises even where the stream would
    route to the CPU engine, on every surface."""
    import io

    from tpubz_torch.stream.files import compress_stream

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: tpubz_torch.compress(b"x", 9),
        lambda: compress_stream(io.BytesIO(b"x"), io.BytesIO(), 9),
        lambda: tpubz_torch.open(tmp_path / "y.bz2", "wb"),
        lambda: tpubz_torch.BZ2Compressor(9),
    ):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
    assert not (tmp_path / "y.bz2").exists()
    assert tpubz_torch.compress_cpu(b"x", 9) == compress_cpu(b"x", 9)


def test_probe_routes_and_sweeps_at_small_size(monkeypatch):
    """The stage probe's bwt-stage times, route rates and hybrid sweep, on
    the CPU at a small size: the phases add up and each route's stream
    reports its engines."""
    from tpubz_torch import stage_probe

    monkeypatch.setenv("TPUBZ_MIN_DEVICE_BLOCKS", "1")
    two = _one_block(1, 30_000) * 4  # RLE1 cuts a 100,000-byte block and a short one
    st = stage_probe.bwt_stage_times(two, 1, "cpu")
    assert st["blocks_timed"] == 1
    parts = ("upload", "bwt", "fetch_bwt")
    assert st["sum_ms"]["dispatcher_total"] == pytest.approx(
        sum(st["sum_ms"][k] for k in parts))
    assert st["median_ms"]["native_mtf_rle2"] > 0 and st["median_ms"]["native_emit"] > 0
    small = _one_block()
    rates = stage_probe.route_rates(small, 1, "cpu", reps=1)
    assert set(rates) == {"full", "bwt", "hybrid", "compress_cpu"}
    assert rates["bwt"][0]["stats"]["stage"] == "bwt"
    assert rates["compress_cpu"][0]["stats"]["engine"] == "cpu"
    sweep = stage_probe.hybrid_sweep(small, 1, "cpu", reps=1, stages=("bwt",),
                                     workers=(0, 2), windows=(5,))
    rows = sweep["rows"]
    assert [(r["cpu_workers"], r["window"]) for r in rows] == [(0, 5), (2, 5)]
    assert rows[0]["dev_blocks"] == [1] and rows[0]["cpu_blocks"] == [0]
    assert "TPUBZ_WINDOW" not in os.environ

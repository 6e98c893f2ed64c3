"""Whole-stream compression: the hybrid scheduler of tpubz on a torch device.

The counterpart of ``tpubz/stream/api.py``, step for step, on the port's
own host engine. The RLE1 scan cuts blocks (the background ``Rle1Feed`` for
large inputs), the header goes first, and an ordered drain splices each
block's bits and folds the stream CRC. Output bytes equal
``tpubz.stream.api.compress_cpu`` and C bzip2's on every route.

Routing, as in tpubz:
  - a stream of fewer than ``TPUBZ_MIN_DEVICE_BLOCKS`` (3) blocks goes to
    the native CPU engine unless this process already holds an encoder for
    its level and device; the device is resolved first all the same, so
    ``device="cuda"`` without a card raises for a 1-block stream too;
  - otherwise each block goes to the device or to a pool of native CPU
    workers (the hybrid), by greedy least completion time over live
    estimates (``device_ok``, ``steal_ok``, ``_dev_hopeless``), with one
    probe block per stream for the device, a 2-strike shutoff, and an
    overdue device head twinned onto a free CPU worker (first result wins
    the ordered drain: the bytes are the same);
  - the device runs one of two stages: ``"full"`` (BWT, MTF, RLE2 on the
    device; refinement and emission on the host) or ``"bwt"`` (the suffix
    sort on the device; MTF/RLE2 in the native ``mtf_rle2_native`` on the
    fetched last column). ``"auto"`` picks by ``rigprofile.choose_stage``
    from the port's own measured profile, ``"bwt"`` until both stages have
    been measured; every device stream trains the profile at its end.

Pipeline of a device block:
  dispatcher thread -- one thread under its own CUDA stream: the upload, the
                       transforms, and the enqueue of the pinned D2H copies;
                       device work stays in block order and never waits on a
                       copy
  fetch pool        -- waits on each block's copy event
  emit pool         -- block CRC, host MTF/RLE2 on the bwt stage, native
                       refinement and emission (GIL-free)
  caller's thread   -- the ordered drain over a bounded window

Deliberate differences from tpubz:
  - No catch-all falls back to the CPU engine when the device fails:
    ``resolve_device`` raises first.
  - A device block that raises is never healed by a CPU twin. The stream
    raises that error, even when a twin already delivered the block: before
    the stream ends it joins its device blocks and re-raises the first
    device exception (tpubz's ``test_device_fast_error_healed_by_cpu_twin``
    is the behaviour this drops).
  - The bwt stage needs no AOT stamp: nothing is compiled ahead here.

Environment overrides, the names tpubz reads, all read in ``_settings``:
TPUBZ_DEVICE_STAGE, TPUBZ_HYBRID_CPU, TPUBZ_MIN_DEVICE_BLOCKS, TPUBZ_WINDOW,
TPUBZ_EMIT_THREADS, TPUBZ_FETCH_THREADS (TPUBZ_HOST_THREADS, the CPU
engine's pool, is read where that pool starts); TPUBZ_PROFILE=<dir> wraps
``compress`` in a ``torch.profiler`` trace written to that directory.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutTimeout
from concurrent.futures import wait as _fut_wait

import numpy as np
import torch

from ..block.emit import emit_block
from ..block.encode import DeviceBlockEncoder, resolve_device
from ..format.constants import FOOTER_MAGIC, STREAM_MAGIC, block_budget
from ..format.crc import block_crc, stream_crc_fold
from ..hostref.bitio import BitAccum, IncrementalSplicer
from ..hostref.rle1 import Rle1Feed, rle1_blocks
from ..native import block_transform_native, mtf_rle2_native
from . import rigprofile

log = logging.getLogger("tpubz_torch")

# emission is ~9 ms per level-9 block on one thread against ~13 ms of
# dispatcher work per block on the full stage (PERF.md, H100), so 3 emit
# threads keep up with the device
EMIT_THREADS = 3
# in-flight blocks of a device-only stream's ordered drain: one on the
# dispatcher, one per emit thread and one waiting; each pins ~1-3 MB
WINDOW = EMIT_THREADS + 2
# in-flight blocks of a hybrid stream: it must cover the CPU pool's workers
# as well as the device's blocks (PERF.md: with 4 and 8 workers on an 8-core
# H100 host, 16 matched or beat 5 and 28 on both stages)
HYBRID_WINDOW = 16
# hybrid CPU workers per core, and their cap: the dispatcher and the emit
# threads need cores of their own (PERF.md: on that host half the cores beat
# a quarter, 1x, 2x and 3x on the bwt stage)
CPU_KNEE = 0.5
MAX_CPU_WORKERS = 24
# device blocks in flight while the device's cadence rests only on the
# persisted profile, before this stream's first device completion
PROBATION_INFLIGHT = 2

# engine-speed estimates shared across compress() calls: a warm-up stream
# trains the scheduler for the whole process (see device_ok / steal_ok)
_cpu_ema_g = [0.0]
_dev_done_g: deque = deque(maxlen=8)
# device completion gaps count only between blocks of the same stream
_stream_epoch_g = [0]
# one live re-probe per process when the persisted profile says the device
# loses: the way back for a healthy device behind a stale profile
_reprobe_left_g = [1]
# the most recent stream: which engines carried its blocks, and per block
# (engine, block index, t_start, t_end) wall-clock spans
last_stream_stats: dict = {}
last_stream_events: list = []

_encoders: dict = {}
_encoders_lock = threading.Lock()


class CpuBlockEncoder:
    """The native CPU engine: BWT, MTF and RLE2 of a block in one GIL-free
    native call, then the same native emission a device block takes, so
    its bytes equal the device path's."""

    def __init__(self, level: int):
        self.level = level

    def encode_block(self, rle1_block, crc) -> BitAccum:
        key, rle2, freqs, used = block_transform_native(rle1_block)
        return emit_block(key, rle2, rle2.size, freqs, used, crc)


def _items_total(items) -> int:
    """The block count of an item stream: exact for a list, the producer's
    estimate for a streaming source (exact once its scan ends)."""
    est = getattr(items, "total_estimate", None)
    return est() if est is not None else len(items)


class _FeedItems:
    """(RLE1 block, raw input range) items over an ``Rle1Feed``; the raw
    range is what the block's CRC covers."""

    def __init__(self, feed: Rle1Feed, arr: np.ndarray):
        self.feed = feed
        self._arr = arr

    def __iter__(self):
        for o0, o1, i0, i1 in self.feed:
            yield self.feed.out[o0:o1], self._arr[i0:i1]

    def total_estimate(self) -> int:
        return self.feed.total_estimate()


def _settings() -> dict:
    """The environment overrides tpubz reads, read at the start of a stream."""
    env = os.environ
    hybrid = env.get("TPUBZ_HYBRID_CPU")
    window = env.get("TPUBZ_WINDOW")
    return {
        "stage": env.get("TPUBZ_DEVICE_STAGE", "auto"),
        "hybrid_cpu": None if hybrid is None else int(hybrid),
        "min_device_blocks": int(env.get("TPUBZ_MIN_DEVICE_BLOCKS", "3")),
        "window": None if window is None else int(window),
        "emit_threads": int(env.get("TPUBZ_EMIT_THREADS", str(EMIT_THREADS))),
        "fetch_threads": int(env.get("TPUBZ_FETCH_THREADS", "4")),
    }


def _encoder_for(level: int, n_blocks: int, dev: torch.device, min_device_blocks: int):
    """The engine for a stream of n_blocks: the CPU engine for a tiny stream
    unless a device encoder for this level and device already exists."""
    key = (level, str(dev))
    with _encoders_lock:
        enc = _encoders.get(key)
        if enc is None:
            if n_blocks < min_device_blocks:
                return CpuBlockEncoder(level)
            enc = _encoders[key] = DeviceBlockEncoder(level, dev)
    return enc


@contextlib.contextmanager
def profiled(out_dir: str, device="cuda"):
    """A ``torch.profiler`` trace of the block, written to ``out_dir``
    (viewable with TensorBoard or chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(out_dir)):
        yield


def compress(data, level: int = 9, *, device="cuda") -> bytes:
    """bzip2-compress ``data`` with device blocks on ``device`` ("cuda" or
    "cpu"; "cuda" without a card raises RuntimeError) and, in a hybrid
    stream, native CPU workers beside it."""
    prof_dir = os.environ.get("TPUBZ_PROFILE")
    if prof_dir:
        with profiled(prof_dir, device):
            return _compress_impl(data, level, device)
    return _compress_impl(data, level, device)


def compress_cpu(data, level: int = 9) -> bytes:
    """bzip2-compress ``data`` on the native CPU engine alone (a worker
    pool; no device). Output bytes equal ``compress``'s."""
    return _compress_impl(data, level, None)


def _compress_impl(data, level: int, device) -> bytes:
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    dev = None if device is None else resolve_device(device)
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    budget = block_budget(level)
    if arr.size > 4 * budget:
        # scan in a background thread; blocks dispatch as they are confirmed
        items = _FeedItems(Rle1Feed(arr, budget), arr)
    else:
        out, blocks = rle1_blocks(arr, budget)
        items = [(out[o0:o1], arr[i0:i1]) for o0, o1, i0, i1 in blocks]

    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + level, 8)
    splicer = IncrementalSplicer(cap_hint=arr.size // 2 + 64)
    splicer.add(*header.pack())
    s_crc = 0
    for crc, data_b, nbits in block_results(level, items, dev):
        s_crc = stream_crc_fold(s_crc, crc)
        splicer.add(data_b, nbits)
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    splicer.add(*footer.pack())
    payload, _ = splicer.finish()
    return payload


def block_results(level: int, items, dev, n_blocks: int | None = None):
    """Yield (crc, packed bytes, nbits) per block in block order, on the
    engine the routing picks for ``dev`` (None: the CPU engine alone).
    ``n_blocks`` is the block count for the tiny-stream rule when ``items``
    cannot say it yet."""
    last_stream_events.clear()
    if dev is not None:
        settings = _settings()
        count = _items_total(items) if n_blocks is None else n_blocks
        enc = _encoder_for(level, count, dev, settings["min_device_blocks"])
        if isinstance(enc, DeviceBlockEncoder):
            return _device_block_results(enc, items, settings)
    return _host_results(level, items)


def _host_results(level: int, items):
    """The CPU engine's pipeline: each block encoded on a thread pool (the
    native calls release the GIL), yielded in block order with at most two
    blocks per worker in flight. TPUBZ_HOST_THREADS sets the pool, by
    default 3x the cores and at most 24: the native transform is bound by
    memory latency, so more threads than cores hide its stalls."""
    enc = CpuBlockEncoder(level)
    workers = max(1, min(int(os.environ.get("TPUBZ_HOST_THREADS",
                                            str(3 * (os.cpu_count() or 4)))), 24))

    def one(idx, blk, raw):
        t0 = time.time()
        crc = block_crc(raw)
        data, nbits = enc.encode_block(blk, crc).pack()
        last_stream_events.append(("cpu", idx, t0, time.time()))
        return crc, data, nbits

    n_est = _items_total(items)
    last_stream_stats.clear()
    last_stream_stats.update(engine="cpu", blocks=n_est, dev_blocks=0, cpu_blocks=n_est)
    n_done = 0
    if workers == 1 or n_est <= 1:
        for idx, (blk, raw) in enumerate(items):
            n_done += 1
            yield one(idx, blk, raw)
    else:
        pool = ThreadPoolExecutor(workers)
        inflight: deque = deque()
        try:
            for idx, (blk, raw) in enumerate(items):
                inflight.append(pool.submit(one, idx, blk, raw))
                if len(inflight) >= 2 * workers:
                    n_done += 1
                    yield inflight.popleft().result()
            while inflight:
                n_done += 1
                yield inflight.popleft().result()
        finally:
            pool.shutdown(wait=True, cancel_futures=True)
    # the count replaces a streaming feed's estimate
    last_stream_stats.update(blocks=n_done, cpu_blocks=n_done)


def _device_block_results(enc: DeviceBlockEncoder, items, settings: dict):
    """Run blocks through the device and, when a CPU pool exists, native CPU
    workers; yield (crc, packed bytes, nbits) in block order while later
    blocks are still in flight. ``items`` yields (RLE1 block, raw input
    range) pairs: a list or a streaming producer."""
    prof = rigprofile.load()
    cores = os.cpu_count() or 4
    hybrid_n = settings["hybrid_cpu"]
    if hybrid_n is None:
        knee = float(prof.get("cpu_knee", CPU_KNEE))
        hybrid_n = min(int(knee * cores), MAX_CPU_WORKERS)
    cpu_pool = cpu_slots = None
    if hybrid_n > 0:
        cpu_pool = ThreadPoolExecutor(hybrid_n)
        cpu_slots = threading.Semaphore(hybrid_n)
    host_enc = CpuBlockEncoder(enc.level)
    # a hybrid needs the device to be a separate compute resource: on the
    # host's own CPU every device block takes the cores the native engine
    # would use, so the pool takes every block unless the user asked for a
    # hybrid explicitly (the tests pin mixed-engine behaviour that way)
    dev_is_host = (
        cpu_pool is not None
        and settings["hybrid_cpu"] is None
        and enc.device.type == "cpu"
    )
    window = settings["window"] or (WINDOW if cpu_pool is None else HYBRID_WINDOW)

    # the dispatcher launches under the encoder's stream, which its thread keeps
    dispatch_pool = ThreadPoolExecutor(
        1, initializer=torch.cuda.set_stream if enc.stream is not None else None,
        initargs=(enc.stream,) if enc.stream is not None else (),
    )
    fetch_pool = ThreadPoolExecutor(settings["fetch_threads"])
    emit_pool = ThreadPoolExecutor(settings["emit_threads"])

    inflight: deque = deque()  # (future, "dev" | "cpu", ((idx, blk, raw), t_disp))
    dev_futs: list = []  # every device block's future, joined at the end
    dev_inflight = [0]  # blocks dispatched to the device, not yet emitted
    cpu_inflight = [0]  # blocks submitted to the CPU pool, not yet finished
    # dispatch times of the blocks in device flight: the oldest one's age
    # over the flight depth is a live lower bound on the device's cadence
    dev_flight_t: dict[int, float] = {}
    dev_flight_seq = [0]
    dev_lock = threading.Lock()
    # device head blocks that lost to their CPU twin past the grace: two
    # shut the device off for the rest of the stream
    dev_strikes = [0]
    _stream_epoch_g[0] += 1
    epoch = _stream_epoch_g[0]
    _dev_done_g.clear()
    if _items_total(items) >= 8:
        # a long stream may spend one probe block on a device the profile
        # rejected; a short one keeps the once-per-process budget
        _reprobe_left_g[0] = max(_reprobe_left_g[0], 1)
    eff_cores = min(hybrid_n or 1, cores)
    leg_samples: list[float] = []  # host-side seconds per device block
    dev_lat_samples: list[float] = []  # dispatch-to-emit seconds per device block
    if not _cpu_ema_g[0] and prof.get("cpu_block_s"):
        _cpu_ema_g[0] = float(prof["cpu_block_s"])

    stage = settings["stage"]
    if stage == "auto":
        stage = rigprofile.choose_stage(
            prof, hybrid_n if cpu_pool is not None else 0, eff_cores
        ) or "bwt"
    if stage not in ("bwt", "full"):
        raise ValueError(f"TPUBZ_DEVICE_STAGE must be auto, bwt or full, not {stage!r}")

    def on_device(blk):
        """Dispatcher thread: transforms and the enqueue of the copies."""
        if stage == "bwt":
            return enc.fetch_bwt_async(enc.transform_bwt(blk))
        return enc.fetch_async(enc.transform(blk))

    def emit(fetch_fut, raw):
        t0 = time.time()
        crc = block_crc(raw)  # overlaps the block's device work
        leg = time.time() - t0
        fetched = fetch_fut.result()
        t0 = time.time()
        if stage == "bwt":
            key, last = fetched
            rle2, freqs, used = mtf_rle2_native(last)
            blk = enc.emit_block(key, rle2, rle2.size, freqs, used, crc)
        else:
            blk = enc.emit_block(*fetched, crc)
        data, nbits = blk.pack()
        leg_samples.append(leg + time.time() - t0)
        return crc, data, nbits

    def emit_timed(fetch_fut, t_disp, seq, idx, raw):
        """emit, with the in-flight count released whatever happens and the
        cadence and latency samples taken from successes only."""
        ok = False
        try:
            r = emit(fetch_fut, raw)
            ok = True
            return r
        finally:
            with dev_lock:
                dev_inflight[0] -= 1
                dev_flight_t.pop(seq, None)
            if _stream_epoch_g[0] == epoch:
                now = time.time()
                last_stream_events.append(("dev", idx, t_disp, now))
                if ok:
                    _dev_done_g.append(now)
                    dev_lat_samples.append(now - t_disp)

    def cpu_one(idx, blk, raw):
        t0 = time.time()
        try:
            crc = block_crc(raw)
            data, nbits = host_enc.encode_block(blk, crc).pack()
            return crc, data, nbits
        finally:
            dt = time.time() - t0
            if _stream_epoch_g[0] == epoch:
                last_stream_events.append(("cpu", idx, t0, t0 + dt))
            _cpu_ema_g[0] = dt if not _cpu_ema_g[0] else 0.5 * _cpu_ema_g[0] + 0.5 * dt
            with dev_lock:
                cpu_inflight[0] -= 1
            cpu_slots.release()

    def cpu_acquire(blocking=False, timeout=None):
        """A CPU slot, counted in cpu_inflight (released in cpu_one)."""
        ok = (
            cpu_slots.acquire(timeout=timeout)
            if blocking
            else cpu_slots.acquire(blocking=False)
        )
        if ok:
            with dev_lock:
                cpu_inflight[0] += 1
        return ok

    def dev_cadence():
        """Median gap between recent device completions (gaps under 5 s);
        else the median dispatch-to-emit latency of this stream; else the
        profile's cadence for the stage (None when never measured)."""
        ts = list(_dev_done_g)
        ds = sorted(b - a for a, b in zip(ts, ts[1:]) if b - a < 5.0)
        if ds:
            return ds[len(ds) // 2]
        if dev_lat_samples:
            return sorted(dev_lat_samples)[len(dev_lat_samples) // 2]
        return (prof.get("dev_cadence_s") or {}).get(stage)

    def device_ok(remaining: int) -> bool:
        """Dispatch to the device only if it would clear its queue and this
        block before the CPU pool would reach the end of the stream."""
        if dev_strikes[0] >= 2:
            return False
        cad = dev_cadence()
        if cad is None:
            return dev_inflight[0] < 1  # a single probe trains the estimate
        if cpu_pool is None:
            return True
        if not _cpu_ema_g[0]:
            return dev_inflight[0] < 2
        t_dev = cad * (dev_inflight[0] + 1)
        t_cpu = remaining * _cpu_ema_g[0] / eff_cores
        if t_dev < t_cpu:
            # a cadence resting only on the persisted profile caps the
            # device's flight until live evidence arrives
            return not (
                not dev_lat_samples
                and len(_dev_done_g) < 2
                and dev_inflight[0] >= PROBATION_INFLIGHT
            )
        # rejected on the profile alone: spend the process's re-probe
        if (
            _reprobe_left_g[0] > 0
            and not dev_lat_samples
            and len(_dev_done_g) < 2
            and dev_inflight[0] == 0
        ):
            _reprobe_left_g[0] -= 1
            return True
        return False

    def steal_ok(remaining: int) -> bool:
        """The mirror guard: a CPU worker takes a block only if it beats the
        device's cadence over what is left."""
        if not _cpu_ema_g[0]:
            return True  # probe
        cad = dev_cadence() or 0.1  # no device sample: assume healthy
        return _cpu_ema_g[0] < cad * max(1, remaining + dev_inflight[0])

    def _dev_hopeless() -> bool:
        """Device cadence so far past the CPU's that even a saturated pool
        should not overflow onto it."""
        cad = dev_cadence()
        return cad is not None and cad > max(3 * (_cpu_ema_g[0] or 0.4), 2.0)

    n_dev = [0]
    n_cpu = [0]

    def dispatch_device(idx, blk, raw):
        n_dev[0] += 1
        t_disp = time.time()
        with dev_lock:
            dev_inflight[0] += 1
            dev_flight_seq[0] += 1
            seq = dev_flight_seq[0]
            dev_flight_t[seq] = t_disp
        launch_fut = dispatch_pool.submit(on_device, blk)
        fetch_fut = fetch_pool.submit(lambda: launch_fut.result().result())
        f = emit_pool.submit(emit_timed, fetch_fut, t_disp, seq, idx, raw)
        dev_futs.append(f)
        inflight.append((f, "dev", ((idx, blk, raw), t_disp)))
        log.debug("in-flight blocks (device): %d", len(inflight))

    def wait_for_cpu(remaining: int) -> bool:
        """A CPU slot, waited for while the device stays ineligible: up to
        0.5 s, or for good when the device is off, on the host's CPU or
        hopeless. False when the wait ran out or the device became eligible
        in it (a completion came in), which sends the block to the device."""
        for_good = dev_is_host or dev_strikes[0] >= 2 or _dev_hopeless()
        deadline = time.time() + 0.5
        while not cpu_acquire(blocking=True, timeout=0.005):
            if not for_good and (time.time() >= deadline or device_ok(remaining)):
                return False
        return True

    def submit_cpu(idx, blk, raw):
        n_cpu[0] += 1
        inflight.append((cpu_pool.submit(cpu_one, idx, blk, raw), "cpu", None))

    def pop_head(tail=False):
        """Ordered drain of one block. An overdue device head is twinned on
        a free CPU worker and the first engine to finish wins; a device
        error is raised, never healed."""
        fut, kind, args = inflight.popleft()
        if kind == "dev" and cpu_pool is not None:
            args, t_disp = args
            if tail:
                grace = 0.02
            else:
                cad = dev_cadence()
                grace = max(2 * cad, 0.25) if cad is not None else 0.5
                # bounded by the cost scale of the CPU alternative
                grace = min(grace, max(1.0, 3 * (_cpu_ema_g[0] or 0.4)))

            def race():
                dup = cpu_pool.submit(cpu_one, *args)
                _fut_wait((fut, dup), return_when=FIRST_COMPLETED)
                if fut.done():
                    return fut.result()
                # the twin won: past the grace that is a strike, and a 4x
                # pessimistic latency sample
                elapsed = time.time() - t_disp
                if not tail and elapsed >= grace:
                    dev_strikes[0] += 1
                    dev_lat_samples.append(4 * elapsed)
                else:
                    dev_lat_samples.append(elapsed)
                return dup.result()

            # return the moment the device finishes; twin the moment a CPU
            # slot frees
            while not fut.done():
                if cpu_acquire():
                    return race()
                try:
                    return fut.result(timeout=0.02)
                except _FutTimeout:
                    continue
        return fut.result()

    try:
        idx = -1
        for idx, (blk, raw) in enumerate(items):
            remaining = _items_total(items) - idx
            dev_eligible = not dev_is_host and device_ok(remaining)
            routed_cpu = False
            # the device's first block of each stream always probes; greedy
            # least completion time applies from its second block on
            probe_needed = (
                not dev_lat_samples and len(_dev_done_g) == 0 and dev_inflight[0] == 0
            )
            if dev_eligible and not probe_needed and cpu_pool is not None and _cpu_ema_g[0]:
                cad = dev_cadence()
                if cad is not None:
                    with dev_lock:
                        oldest = min(dev_flight_t.values(), default=None)
                        q = dev_inflight[0]
                    eff = cad
                    if q and oldest is not None:
                        eff = max(cad, (time.time() - oldest) / q)
                    t_dev = eff * (q + 1)
                    t_cpu = _cpu_ema_g[0] * (1 + cpu_inflight[0] / max(1, hybrid_n))
                    if t_cpu < t_dev and steal_ok(remaining) and cpu_acquire():
                        routed_cpu = True
            if dev_eligible and not routed_cpu:
                dispatch_device(idx, blk, raw)
            elif routed_cpu or (
                cpu_pool is not None and steal_ok(remaining) and cpu_acquire()
            ):
                submit_cpu(idx, blk, raw)
            elif cpu_pool is not None and wait_for_cpu(remaining):
                # all slots were busy: waiting for one beats force-feeding
                # an engine the estimates just rejected
                submit_cpu(idx, blk, raw)
            else:
                # no pool, the device became eligible, or the pool stayed
                # saturated and the device still looks usable
                dispatch_device(idx, blk, raw)
            if len(inflight) >= window:
                yield pop_head()
        while inflight:
            yield pop_head(tail=True)
        # a device block that raised fails the stream, even if its CPU twin
        # delivered the block
        for f in dev_futs:
            if f.exception() is not None:
                raise f.exception()

        # train the profile with this stream's measurements
        ts = list(_dev_done_g)
        live = sorted(b - a for a, b in zip(ts, ts[1:]) if b - a < 5.0)
        leg_med = sorted(leg_samples)[len(leg_samples) // 2] if leg_samples else 0.0
        lat_med = (
            sorted(dev_lat_samples)[len(dev_lat_samples) // 2] if dev_lat_samples else 0.0
        )
        # the cadence of record is the completion-gap median; unpipelined
        # latency overestimates it, so it trains only a stage never measured
        # or a stream with strikes
        if live:
            cad_train = live[len(live) // 2]
        elif dev_lat_samples and (
            dev_strikes[0] or stage not in (prof.get("dev_cadence_s") or {})
        ):
            cad_train = lat_med
        else:
            cad_train = 0.0
        if dev_strikes[0] and dev_lat_samples:
            cad_train = max(cad_train, lat_med)
        cad_train = min(cad_train, 5.0)
        rigprofile.update(
            cpu_block_s=_cpu_ema_g[0],
            dev_cadence_s={stage: cad_train},
            host_leg_s={stage: leg_med},
        )
        last_stream_stats.clear()
        last_stream_stats.update(
            engine="hybrid" if cpu_pool is not None else "device",
            stage=stage,
            blocks=idx + 1,
            dev_blocks=n_dev[0],
            cpu_blocks=n_cpu[0],
            cpu_workers=hybrid_n if cpu_pool is not None else 0,
            window=window,
            cpu_block_s=round(_cpu_ema_g[0], 4),
            dev_cadence_s=round(live[len(live) // 2], 4) if live else None,
            dev_host_leg_s=round(leg_med, 4),
        )
    finally:
        # queued device work is cancelled and running work joined, so no
        # thread of this stream outlives it
        for pool in (dispatch_pool, fetch_pool, emit_pool, cpu_pool):
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

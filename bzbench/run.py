"""One run of one cell of the benchmark of tpubz_torch.

    python3 bzbench/run.py --workload <config>.<traffic> --seed N --seconds S --trace 0|1

(or ``python3 -m bzbench.run ...``) from the root of a checkout. The cell's
configuration (``configs/<config>.json``: level, device, the port's
environment) and traffic (``traffic/<traffic>.json``: the generator's
parameters) are found by name; so is each metric's reader
(``metrics/<name>.py``). A run:

1. sets up: imports the port, sets the configuration's environment (a
   fresh ``TPUBZ_TORCH_CACHE`` in the run's ``TMPDIR``), makes the pool of
   files from the seed, and compresses one file of the cell's size, which
   builds the port's libraries on a first run and its BWT graph;
2. measures for ``--seconds``: one client on a thread of its own, a
   closed loop, each request one file through
   ``tpubz_torch.compress(data, level, device="cuda")``; the window closes
   when the last file started before the deadline returns;
3. with ``--trace 1``, the same window with the layers' spans
   (``trace.Probe``) and a ``torch.profiler`` session of about a second
   (``trace.Timeline``), started and read on the main thread;
4. reads the metrics, then judges the window's streams against the plain
   reference (``reference.py``) on the pool files drawn from the seed;
5. checks that no module named ``jax``, ``jaxlib``, ``flax`` or ``tpubz``
   is loaded, after the readers and the reference have run; prints the
   numbers compared beside their limits on standard error, and the result
   as the last line of standard output.

It exits with code 2 and prints no result when no card (or fewer than the
cell asks for) is there, or when a forbidden module is loaded before the
window or by the time of the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()  # the run's set-up starts here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "tpubz")
EXIT_NO_RESULT = 2
TRACE_SECONDS = 1.0  # the profiler's session in a traced run


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``tpubz_torch`` is not ``tpubz``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(workload: str, root: str = ROOT) -> tuple[dict, dict, dict, dict]:
    """(bench, workload entry, configuration, traffic) of a cell: the entry
    of ``BENCHMARK.json`` by its name, else ``<config>.<traffic>`` split at
    the first dot (a cell measured off the manifest)."""
    bench_path = os.path.join(root, "BENCHMARK.json")
    bench = load_json(bench_path) if os.path.exists(bench_path) else {}
    entry = next((w for w in bench.get("workloads", []) if w["name"] == workload), None)
    if entry is None:
        config, _, traffic = workload.partition(".")
        entry = {"name": workload, "config": config, "traffic": traffic, "chips": 1}
    here = os.path.join(root, "bzbench")
    config = load_json(os.path.join(here, "configs", entry["config"] + ".json"))
    traffic = load_json(os.path.join(here, "traffic", entry["traffic"] + ".json"))
    return bench, entry, config, traffic


def metric_specs(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones:
    those that list it, or every one for a cell off the manifest."""
    specs = bench.get("per_layer" if trace else "end_to_end", [])
    on_manifest = any(w["name"] == workload for w in bench.get("workloads", []))
    return [m for m in specs
            if not on_manifest or "workloads" not in m or workload in m["workloads"]]


def load_reader(name: str, root: str = ROOT):
    """``bzbench/metrics/<name>.py``'s ``read``."""
    path = os.path.join(root, "bzbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("bzbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run:
    """What a run measured, for the metrics' readers: ``files`` (pool index,
    start, end, bytes, ok) on the host clock, ``window_s``, ``setup_s``,
    ``device_kind``, and in a traced run ``probe`` (a
    ``trace.Probe``), ``blocks`` (the device blocks' dispatch and emitted
    times from ``last_stream_events``), ``counters`` (the BWT's, over the
    window), ``busy_s`` and ``traced_s`` (the profiler's window),
    ``timeline`` (a ``trace.Timeline``), ``traced_span`` (its span on the
    profiler's clock) and ``profiled`` (the profiler's sessions and their
    reading, first start to last end, on the host clock) or None."""

    def __init__(self, **kw):
        self.files: list[tuple[int, float, float, int, bool]] = []
        self.window_s = self.setup_s = 0.0
        self.device_kind = None
        self.probe = None
        self.blocks: list[tuple[float, float]] = []
        self.counters: dict = {}
        self.busy_s = self.traced_s = None
        self.timeline = self.traced_span = self.profiled = None
        self.__dict__.update(kw)


def _profile_session(torch):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: str = ROOT,
             device: str | None = None, wrap=None) -> dict:
    """One run of a cell; returns the result. ``device`` and ``wrap`` are
    for tests on the CPU: another device, and a function that takes the
    program's ``compress`` and returns what the window calls instead."""
    import torch

    import tpubz_torch
    from tpubz_torch.kernels import suffix_sort
    from tpubz_torch.stream import api

    from bzbench import gen, reference
    from bzbench import trace as tr

    bench, entry, config, traffic = find_cell(workload, root)
    level = int(config["level"])
    device = device or config["device"]
    saved_env = {k: os.environ.get(k) for k in
                 list(config.get("env", {})) + list(config.get("fresh_dir_env", []))}
    fresh = []
    try:
        os.environ.update(config.get("env", {}))
        for var in config.get("fresh_dir_env", []):
            fresh.append(tempfile.mkdtemp(prefix="bzbench-"))
            os.environ[var] = fresh[-1]
        found = forbidden_modules()
        if found:
            raise ForbiddenModules(found)

        files = gen.pool(traffic, seed)
        compress = tpubz_torch.compress
        if wrap is not None:
            compress = wrap(compress)
        on_cuda = torch.device(device).type == "cuda"

        def sync():
            if on_cuda:
                torch.cuda.synchronize()

        probe = tr.Probe().install() if trace else None
        try:
            if trace and on_cuda:
                with _profile_session(torch):  # the profiler's own set-up
                    compress(files[0], level, device=device)
            else:
                compress(files[0], level, device=device)
            sync()
            if probe is not None:
                probe.clear()  # the warm-up's records go
            rounds0, launches0 = suffix_sort.ROUNDS_RUN, suffix_sort.LAUNCHES
            run = Run(probe=probe, device_kind=torch.cuda.get_device_name(0) if on_cuda else "cpu")
            records, failures = [], []
            cpu0 = resource.getrusage(resource.RUSAGE_SELF)
            t_window = time.perf_counter()
            run.setup_s = t_window - T_START
            deadline = t_window + seconds

            def client():
                """A closed loop: the next file when the last one's bytes are back."""
                i = 0
                while time.perf_counter() < deadline and len(failures) < 3:
                    k = i % len(files)
                    t0 = time.perf_counter()
                    try:
                        out = compress(files[k], level, device=device)
                    except Exception as e:  # noqa: BLE001 (a failed request, counted)
                        out = None
                        failures.append(repr(e))
                    t1 = time.perf_counter()
                    records.append(((k, t0, t1, len(files[k]), out is not None), out))
                    i += 1

            thread = threading.Thread(target=client, name="bzbench-client")
            thread.start()
            sessions = []
            try:
                if trace and on_cuda:
                    sessions, run.profiled = _trace_sessions(torch, tr, t_window, deadline, sync)
            finally:
                thread.join()
            sync()
            run.files = [r[0] for r in records]
            outputs = [r[1] for r in records]
            run.window_s = max(f[2] for f in run.files) - t_window
            cpu1 = resource.getrusage(resource.RUSAGE_SELF)
            cpu_s = (cpu1.ru_utime - cpu0.ru_utime) + (cpu1.ru_stime - cpu0.ru_stime)
            memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
            run.counters = {"rounds": suffix_sort.ROUNDS_RUN - rounds0,
                            "launches": suffix_sort.LAUNCHES - launches0}
            if probe is not None:
                run.blocks = list(probe.blocks)
        finally:
            if probe is not None:
                probe.uninstall()
        breakdown = None
        if sessions and sessions[-1][0].ops:
            breakdown = _read_timeline(run, sessions[-1], tr)

        metrics = {}
        for spec in metric_specs(bench, workload, trace):
            value = load_reader(spec["name"], root)(run)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

        # the program's state goes before the reference runs
        api._encoders.clear()
        if on_cuda:
            torch.cuda.empty_cache()

        # the judge: every window stream of the pool files drawn from the seed
        t_ref = time.perf_counter()
        check = sorted(gen.rng_of(seed, 1).choice(len(files), int(traffic["check_files"]),
                                                  replace=False).tolist())
        unequal = compared = 0
        for k in check:
            expect = reference.compress(files[k], level, int(config["huffman_iters"]))
            for (kk, *_), out in zip(run.files, outputs):
                if kk == k and out is not None:
                    compared += 1
                    unequal += out != expect
        ref_s = time.perf_counter() - t_ref
    finally:
        for d in fresh:
            shutil.rmtree(d, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    attempted = len(run.files)
    failed = sum(not f[4] for f in run.files)
    correct = failed == 0 and compared > 0 and unequal == 0
    checks = {"unequal": {"value": int(unequal), "limit": 0},
              "compared": {"value": int(compared), "limit": 1}}
    for line in failures[:3]:
        print(f"bzbench: a file failed: {line}", file=sys.stderr)
    print(f"bzbench: {attempted} files in {run.window_s:.3f} s, {failed} failed; "
          f"reference on pool files {check} in {ref_s:.2f} s", file=sys.stderr)
    device_rec = {"platform": "gpu" if on_cuda else "cpu", "kind": run.device_kind,
                  "count": int(entry.get("chips", 1)), "memory_peak_bytes": int(memory_peak)}
    if trace:
        device_rec.update(busy_s=run.busy_s, window_s=run.traced_s)
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["detail"] = {"workload": workload, "seed": seed, "window_s": run.window_s,
                        "files": attempted, "pool_files": len(files), "checked_pool": check,
                        "reference_s": ref_s, "blocks_traced": len(run.blocks),
                        "host_cpu_s": cpu_s,
                        "file_p95_ms": load_reader("file_p95_ms", root)(run),
                        "file_ms_quartiles": [
                            round(1000 * q, 2) for q in statistics.quantiles(
                                [f[2] - f[1] for f in run.files], n=4)] if attempted > 1 else None}
    result["checks"] = checks
    return result


def _trace_sessions(torch, tr, t_window, deadline, sync) -> tuple[list, tuple | None]:
    """On the calling thread, while the client runs: a profiler session of
    ``TRACE_SECONDS`` (at most half the window) from 2 s into the window
    (at most a quarter of it), with an annotation every 10 ms that ties the
    host clock to the profiler's; again (up to three sessions) while a
    session traces no device event. ([(Timeline, anchors)], (the first
    session's start, the last one's read) on the host clock or None)."""
    sessions, start = [], None
    trace_s = min(TRACE_SECONDS, 0.5 * (deadline - t_window))
    time.sleep(max(0.0, t_window + min(2.0, 0.25 * (deadline - t_window)) - time.perf_counter()))
    while len(sessions) < 3 and time.perf_counter() + trace_s < deadline:
        if start is None:
            start = time.perf_counter()
        prof = _profile_session(torch)
        prof.start()
        anchors = []
        stop = time.perf_counter() + trace_s
        while time.perf_counter() < stop:
            t = time.perf_counter()
            with torch.profiler.record_function("bz.anchor"):
                anchors.append(t)
            time.sleep(0.01)
        sync()  # the traced span's device work has ended
        prof.stop()
        sessions.append((tr.Timeline(prof), anchors))
        if sessions[-1][0].ops:
            break
    return sessions, (start, time.perf_counter()) if sessions else None


def _read_timeline(run: Run, session, tr) -> dict | None:
    """busy_s and traced_s of the profiler's span, and the breakdown."""
    timeline, anchors = session
    marks = timeline.cpu.get("bz.anchor", [])
    if len(marks) != len(anchors) or len(anchors) < 2:
        return None
    offset = statistics.median(m[0] - a for m, a in zip(marks, anchors))
    lo, hi = anchors[0] + offset, anchors[-1] + offset
    busy, gaps = timeline.busy(lo, hi)
    run.busy_s, run.traced_s = busy, hi - lo
    run.timeline, run.traced_span = timeline, (lo, hi)
    dispatch = [(a + offset, b + offset) for a, b, _ in run.probe.spans["dispatch"]
                if a + offset <= hi and b + offset >= lo]
    files = [(f[1] + offset, f[2] + offset) for f in run.files
             if f[1] + offset <= hi and f[2] + offset >= lo]
    return {"device_ops": timeline.top_ops(lo, hi),
            "idle_gaps": tr.name_gaps(gaps, files, dispatch)}


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__("modules that a run may not load: " + ", ".join(found))
        self.found = found


def main(argv=None, *, root: str = ROOT, device: str | None = None) -> int:
    """The command. ``root`` and ``device`` are for tests on the CPU:
    another checkout, and a device that skips the look for a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import tpubz_torch  # noqa: F401  (a checkout without the port fails here, with no result)
    _, entry, _, _ = find_cell(args.workload, root)
    chips = int(entry.get("chips", 1))
    if device is None and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        print(f"bzbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() is {torch.cuda.device_count()}", file=sys.stderr)
        return EXIT_NO_RESULT
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), root=root,
                          device=device)
    except ForbiddenModules as e:
        print(f"bzbench: {e}", file=sys.stderr)
        return EXIT_NO_RESULT
    # again once the readers and the reference have run, in the process that prints
    found = forbidden_modules()
    if found:
        print(f"bzbench: {ForbiddenModules(found)} (loaded by the time of the result)",
              file=sys.stderr)
        return EXIT_NO_RESULT
    c = result["checks"]
    print(f"bzbench: unequal {c['unequal']['value']} limit {c['unequal']['limit']} "
          f"(window streams unlike the reference's, at most)", file=sys.stderr)
    print(f"bzbench: compared {c['compared']['value']} limit {c['compared']['limit']} "
          f"(window streams compared, at least)", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

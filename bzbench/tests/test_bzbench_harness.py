"""The harness on the CPU: generators, the module check, lookups by name,
the reference against C bzip2 and the port, the trace arithmetic, and whole
runs of a small cell with the program sound, broken and replaced by the
control."""
import bz2
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bzbench import control, gen, reference, run
from bzbench import trace as tr

HISTORY = {"content": "page_history", "file_bytes": 200_000, "pool_files": 3,
           "page_text_bytes": [4096, 40960], "revisions": [10, 60], "edits": [1, 3],
           "vocab": 4000}


@pytest.mark.parametrize("traffic", [HISTORY, {"content": "mixed", "file_bytes": 300_000,
                                               "pool_files": 2}])
def test_generator_repeats_per_seed(traffic):
    a = gen.pool(traffic, 2**31 + 12345)
    assert a == gen.pool(traffic, 2**31 + 12345)
    b = gen.pool(traffic, 7)
    assert [len(f) for f in a] == [len(f) for f in b] == [traffic["file_bytes"]] * len(a)
    assert a != b


def test_page_shapes_do_not_depend_on_the_seed():
    shapes = gen.page_shapes(64 << 20, HISTORY)
    assert shapes == gen.page_shapes(64 << 20, HISTORY)
    texts = np.array([t for t, _ in shapes])
    assert texts.min() >= 4096 and texts.max() <= 40960
    assert all(10 <= len(e) + 1 <= 60 and set(e) <= {1, 2, 3} for _, e in shapes)


def test_history_is_an_export_of_revisions():
    text = gen.pool(HISTORY, 3)[0]
    assert text.startswith(b"<mediawiki")
    assert text.count(b"<revision>") >= 5 and b"<text bytes=" in text and b"<sha1>" in text


@pytest.mark.parametrize("modules,found", [
    (["tpubz_torch", "tpubz_torch.stream.api", "numpy"], []),
    (["tpubz_torch", "tpubz.format"], ["tpubz.format"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "jaxtyping"], ["flax.linen", "jax",
                                                                 "jaxlib.xla_client"]),
])
def test_forbidden_modules_compare_whole_names(modules, found):
    assert run.forbidden_modules(modules) == found


def test_this_process_loads_no_forbidden_module():
    import tpubz_torch  # noqa: F401
    assert run.forbidden_modules() == []


def test_lookup_by_name_finds_new_files(bench_root):
    """A new configuration, traffic and metric are found from their files,
    with no edit of a file that is there."""
    metric = os.path.join(bench_root, "bzbench", "metrics", "file_count.py")
    with open(metric, "w") as f:
        f.write("def read(run):\n    return len(run.files)\n")
    bench, entry, config, traffic = run.find_cell("bz1-small.history-small", bench_root)
    assert entry["config"] == "bz1-small" and config["level"] == 1
    assert traffic["file_bytes"] == 320_000
    assert run.load_reader("file_count", bench_root)(run.Run(files=[1, 2])) == 2
    # off the manifest, every metric is asked for
    assert {m["name"] for m in run.metric_specs(bench, entry["name"], False)} == {
        m["name"] for m in bench["end_to_end"]}


@pytest.mark.parametrize("data", [
    b"", b"x", b"abracadabra" * 40, bytes(range(256)) * 30, b"\x07" * 5000,
    b"ab" * 3000 + b"c",
])
def test_reference_agrees_with_c_bzip2(data):
    """C bzip2 (Python's bz2) decodes the reference's stream, and the
    reference's level-9 stream is the port's."""
    import tpubz_torch
    z = reference.compress(data, 9)
    assert bz2.decompress(z) == data
    assert z == tpubz_torch.compress_cpu(data, 9)


def test_reference_agrees_on_history_blocks():
    import tpubz_torch
    data = gen.pool(dict(HISTORY, file_bytes=250_000, pool_files=1), 5)[0]
    for level in (1, 9):
        z = reference.compress(data, level)
        assert z == tpubz_torch.compress_cpu(data, level)
        assert bz2.decompress(z) == data


def test_reference_bwt_against_sorting_every_rotation():
    rng = np.random.default_rng(1)
    for block in (rng.integers(0, 3, 500).astype(np.uint8), np.frombuffer(b"abab" * 64, np.uint8),
                  np.frombuffer(b"banana", np.uint8)):
        n = block.size
        rots = sorted(range(n), key=lambda i: (bytes(np.roll(block, -i)), i))
        key, last, _ = reference.bwt(block)
        assert key == rots.index(0)
        assert bytes(last) == bytes(block[(np.array(rots) - 1) % n])


def test_union_and_gaps():
    busy, gaps = tr.union_length([(1, 2), (1.5, 3), (5, 6), (9, 12)], 0, 10)
    assert busy == pytest.approx(4)
    assert gaps == [(0, 1), (3, 5), (6, 9)]
    named = tr.name_gaps(gaps, files=[(0.5, 6.5)], dispatch=[(2.9, 5.2)])
    assert dict(named) == pytest.approx({
        "no dispatcher working (a file's fill or drain, or the window full)": 1.0,
        "between files (no compress call in flight)": 3.0,
        "dispatcher's host work (upload, launches, copies' enqueue)": 2.0})


def test_probe_puts_every_name_back():
    from tpubz_torch.block import encode
    from tpubz_torch.stream import api
    def names():
        return (dict(encode.DeviceBlockEncoder.__dict__), encode.bwt_forward_async,
                api.mtf_rle2_native, api.last_stream_events)
    before = names()
    probe = tr.Probe().install()
    assert encode.bwt_forward_async is not before[1]
    assert api.last_stream_events is not before[3]
    probe.uninstall()
    after = names()
    assert after[:3] == before[:3] and after[3] is before[3]


def test_file_p95_leaves_out_the_profiled_files():
    read = run.load_reader("file_p95_ms")
    files = [(0, t, t + (0.5 if 10 <= t <= 12 else 0.1), 1, True) for t in range(40)]
    assert read(run.Run(files=files)) == pytest.approx(500.0)
    assert read(run.Run(files=files, profiled=(9.95, 12.2))) == pytest.approx(100.0)


def _small_run(bench_root, trace=False, wrap=None, seconds=1.0):
    return run.run_cell("bz1-small.history-small", 2**31 + 99, seconds, trace, root=bench_root,
                        device="cpu", wrap=wrap)


def test_a_sound_small_run_is_correct(bench_root):
    result = _small_run(bench_root, trace=True)
    assert result["correct"] and result["failed"] == 0
    assert result["checks"]["unequal"]["value"] == 0 and result["checks"]["compared"]["value"] > 0
    # the keys every result carries, the numbers compared last
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(result)
    assert list(result)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    bench = run.load_json(os.path.join(bench_root, "BENCHMARK.json"))
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    assert all(m["unit"] == units[name] for name, m in result["metrics"].items())
    # the CPU has no card: no device metric is read, the host's are
    metrics = result["metrics"]
    assert "device.idle_pct" not in metrics and "bwt_roofline" not in metrics
    assert "bwt.rounds_per_block" not in metrics  # the plain BWT counts no rounds
    assert metrics["emit.ms_per_block"]["value"] > 0
    assert metrics["stream.block_inflight_ms"]["value"] > 0
    json.dumps(result)


@pytest.mark.parametrize("stub", [False, True])
def test_a_module_loaded_after_the_window_stops_the_result(bench_root, capsys, stub):
    """The command on the CPU, past its look for a card: a result when the
    run is sound; none, and exit code 2, when a metric's reader loads a
    module named ``tpubz`` (a stub here) after the window has closed."""
    assert "tpubz" not in sys.modules
    if stub:
        with open(os.path.join(bench_root, "bzbench", "metrics", "encode_MBps.py"), "a") as f:
            f.write("\nimport sys, types\nsys.modules['tpubz'] = types.ModuleType('tpubz')\n")
    try:
        rc = run.main(["--workload", "bz1-small.history-small", "--seed", str(2**31 + 5),
                       "--seconds", "1", "--trace", "0"], root=bench_root, device="cpu")
        out, err = capsys.readouterr()
        assert ("tpubz" in sys.modules) == stub
    finally:
        sys.modules.pop("tpubz", None)
    if stub:
        assert rc == run.EXIT_NO_RESULT and out.strip() == "" and "tpubz" in err
    else:
        result = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and result["correct"] and "encode_MBps" in result["metrics"]
        assert err.rstrip().splitlines()[-1].startswith("bzbench: compared ")


def _flip_one_byte(compress):
    def broken(data, level, device):
        out = bytearray(compress(data, level, device=device))
        out[len(out) // 2] ^= 0x10
        return bytes(out)
    return broken


def _half_the_blocks(compress):
    def broken(data, level, device):
        return compress(data[: len(data) // 2], level, device=device)
    return broken


def _input_unchanged(compress):
    def broken(data, level, device):
        return bytes(data)
    return broken


@pytest.mark.parametrize("wrap", [_flip_one_byte, _half_the_blocks, _input_unchanged,
                                  control.control()])
def test_a_broken_program_is_not_correct(bench_root, wrap):
    """An answer altered where it is produced, half of the blocks left out,
    a step that returns its input unchanged, and the control (the reference
    with C bzip2's 4 refinement passes, ``control.py``): each reads as not
    correct. (One chip: no exchange between chips to leave out.)"""
    result = _small_run(bench_root, wrap=wrap)
    assert not result["correct"]
    assert result["checks"]["unequal"]["value"] > 0


def test_no_card_no_result(tmp_path):
    """Without a card the command exits with 2 and prints no result."""
    p = subprocess.run([sys.executable, "bzbench/run.py", "--workload", "bz9-card.history-4m",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == run.EXIT_NO_RESULT and p.stdout.strip() == ""


def test_benchmark_alone_no_result(bench_root):
    """In a directory that holds only BENCHMARK.json and bzbench/, a run
    fails and prints no result (the port is not there)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "bzbench/run.py", "--workload", "bz9-card.history-4m",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=bench_root,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    """A short traced run of a cell on the card: correct, with its metrics."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    result = run.run_cell("bz9-card.history-4m", 2**31 + 7, 2.0, True)
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert {"device.idle_pct", "bwt_roofline", "block.dispatch_ms"} <= set(result["metrics"])

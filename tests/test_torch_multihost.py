"""The port's multi-process path (tpubz_torch.dist.multihost) on the CPU:
in one process against tpubz's compress_multihost, the port's compress_cpu
and tpubz's host reference, and as two real processes over gloo (a TCPStore
on a free 127.0.0.1 port), each run bounded by a timeout so that a hang
fails the test instead of eating the suite's limit. Streams are compared
byte for byte."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tpubz_torch
from tpubz.dist import multihost as tmultihost
from tpubz.hostref.stream import compress as hostref_compress
from tpubz_torch.corpus import sidecar_overflow_block
from tpubz_torch.dist import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mixed_input(rng, n=260_000):
    """tests/test_multihost.py's input."""
    return (
        bytes(rng.integers(0, 200, n // 2, dtype=np.uint8))
        + b"m" * (n // 4)
        + bytes(rng.integers(0, 8, n // 4, dtype=np.uint8))
    )


def test_compress_multihost_one_process_matches_tpubz(rng):
    """One process, no process group: the port's compress_multihost on the
    CPU equals tpubz's compress_multihost, the port's compress_cpu and
    tpubz's host reference, and decompress_multihost reads it back."""
    d = _mixed_input(rng)
    got = multihost.compress_multihost(d, 1, device="cpu")
    assert got == tmultihost.compress_multihost(d, 1)
    assert got == tpubz_torch.compress_cpu(d, 1) == hostref_compress(d, 1)
    assert multihost.decompress_multihost(got) == d


def test_compress_multihost_sidecar_overflow_level9():
    """A level-9 stream with a block whose symbols >= 256 overflow the
    sidecar (the full-row fetch) and a 1-block tail equals compress_cpu."""
    d = sidecar_overflow_block(950_000) + b"tail" * 100
    got = multihost.compress_multihost(d, 9, device="cpu")
    assert got == tpubz_torch.compress_cpu(d, 9)
    assert multihost.decompress_multihost(got) == d


def test_decompress_multihost_concatenated_levels(rng):
    """Concatenated level-1 and level-9 streams, where the second stream's
    block decodes past the level-1 cap (tests/test_multihost.py:46)."""
    d1 = _mixed_input(rng, 120_000)
    big = (b"abcdefgh" * 16_000 + bytes(rng.integers(0, 4, 4_000, dtype=np.uint8))) * 2
    s = hostref_compress(d1, 1) + hostref_compress(big, 9)
    assert multihost.decompress_multihost(s) == d1 + big


def test_decompress_multihost_rejects_corruption(rng):
    s = bytearray(hostref_compress(_mixed_input(rng), 1))
    s[len(s) // 2] ^= 0x40
    with pytest.raises(ValueError):
        multihost.decompress_multihost(bytes(s))
    with pytest.raises(ValueError):
        multihost.decompress_multihost(b"not bzip2")


def test_compress_multihost_without_a_card_raises():
    """Asking for the card on a machine without one raises; nothing runs on
    the CPU in its place."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0\]"):
        multihost.compress_multihost(b"abc" * 1000, 1, device="cuda")
    with pytest.raises(ValueError):
        multihost.compress_multihost(b"abc", 0, device="cpu")


WORKER = textwrap.dedent(r"""
    import json, os, sys
    import numpy as np
    rank, port, out, mode = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    if mode == "asymmetric" and rank == 1:
        os.environ["TPUBZ_MULTIHOST_ALLGATHER"] = "1"  # on one rank only, on purpose
    from tpubz_torch.dist import multihost
    import tpubz_torch
    if mode == "env":  # as torchrun sets it up
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                          WORLD_SIZE="2")
        multihost.initialize()
    else:
        multihost.initialize(f"127.0.0.1:{port}", 2, rank)
    rng = np.random.default_rng(321)
    n = 260_000
    d = (bytes(rng.integers(0, 200, n // 2, dtype=np.uint8)) + b"m" * (n // 4)
         + bytes(rng.integers(0, 8, n // 4, dtype=np.uint8)))
    result = {}
    if mode in ("encode", "env"):
        stream = multihost.compress_multihost(d, 1, device="cpu")
        result["stream_is_none"] = stream is None
        result["transport"] = multihost.last_multihost_stats["transport"]
        if rank == 0:
            open(out + ".bz2", "wb").write(stream)
    elif mode == "decode":
        raw = multihost.decompress_multihost(tpubz_torch.compress_cpu(d, 1))
        result["ok"] = raw is None if rank else raw == d
    elif mode == "corrupt":
        s = bytearray(tpubz_torch.compress_cpu(d, 1))
        s[len(s) // 2] ^= 0x40  # a payload bit mid-stream
        try:
            multihost.decompress_multihost(bytes(s))
            result["raised"] = None
        except ValueError as e:
            result["raised"] = type(e).__name__
        # a healthy call after it: no rank is wedged in a collective
        ok = multihost.decompress_multihost(tpubz_torch.compress_cpu(d, 1))
        result["ok"] = ok is None if rank else ok == d
    elif mode in ("asymmetric", "transport"):
        s = tpubz_torch.compress_cpu(d, 1)
        raw = multihost.decompress_multihost(s)
        result["kv"] = dict(multihost.last_multihost_stats)
        result["ok"] = raw is None if rank else raw == d
        if mode == "transport":
            os.environ["TPUBZ_MULTIHOST_ALLGATHER"] = "1"
            raw = multihost.decompress_multihost(s)
            result["allgather"] = dict(multihost.last_multihost_stats)
            result["ok"] = result["ok"] and (raw is None if rank else raw == d)
    elif mode == "no_card":
        try:
            multihost.compress_multihost(d, 1, device="cuda" if rank == 1 else "cpu")
            result["raised"] = None
        except RuntimeError as e:
            result["raised"] = str(e)
    json.dump(result, open(out + f".rank{rank}.json", "w"))
    # leave together: a rank that exits with the group up can abort in its
    # teardown while the other still talks to it
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(tmp_path, mode):
    """Run WORKER as ranks 0 and 1 and return their results; a rank that
    does not end within the timeout fails the test."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    out = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("TPUBZ_MULTIHOST_ALLGATHER", None)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port, out, mode],
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, env=env)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=90)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e.decode()[-3000:]
    return [json.loads(open(f"{out}.rank{r}.json").read()) for r in range(2)], out


@pytest.mark.parametrize("mode", ["encode", "env"])
def test_two_processes_encode_byte_identical(tmp_path, mode):
    """Two gloo ranks give rank 0 tpubz's host-reference stream and the
    port's compress_cpu stream, and rank 1 None: with the group on the
    store initialize() makes (gather-to-0), and from the environment as
    torchrun sets it (env://, no store: the all-gather)."""
    res, out = _two_ranks(tmp_path, mode)
    assert [r["stream_is_none"] for r in res] == [False, True]
    want = "allgather" if mode == "env" else "kv-gather-to-0"
    assert [r["transport"] for r in res] == [want, want]
    stream = open(out + ".bz2", "rb").read()
    d = _mixed_input(np.random.default_rng(321))
    assert stream == hostref_compress(d, 1) == tpubz_torch.compress_cpu(d, 1)


def test_two_processes_decode(tmp_path):
    res, _ = _two_ranks(tmp_path, "decode")
    assert all(r["ok"] for r in res)


def test_two_processes_corrupt_stream_raises_on_every_rank(tmp_path):
    """A corrupt stream makes rank 0's stitch fail; the failure rides the
    walk-state broadcast, so every rank raises, none hangs, and a healthy
    call after it succeeds."""
    res, _ = _two_ranks(tmp_path, "corrupt")
    assert [r["raised"] for r in res] == ["ValueError", "ValueError"]
    assert all(r["ok"] for r in res)


def test_two_processes_asymmetric_transport_env_agrees(tmp_path):
    """TPUBZ_MULTIHOST_ALLGATHER on rank 1 only: the transport is agreed
    collectively, so both ranks take the all-gather and nothing hangs."""
    res, _ = _two_ranks(tmp_path, "asymmetric")
    assert all(r["ok"] for r in res)
    assert [r["kv"]["transport"] for r in res] == ["allgather", "allgather"]


def test_two_processes_gather_to_zero_moves_less(tmp_path):
    """The store gather-to-0 sends each payload once, to rank 0: rank 1's
    bytes sent are well under the padded all-gather's, which lands every
    payload on every rank."""
    res, _ = _two_ranks(tmp_path, "transport")
    p1 = res[1]
    assert all(r["ok"] for r in res)
    assert p1["kv"]["transport"] == "kv-gather-to-0"
    assert p1["allgather"]["transport"] == "allgather"
    assert p1["kv"]["payload_bytes_sent"] > 0
    assert p1["kv"]["payload_bytes_sent"] <= p1["allgather"]["payload_bytes_sent"] / 1.8
    assert res[0]["kv"]["payload_bytes_received"] == p1["kv"]["payload_bytes_sent"]


def test_two_processes_a_rank_without_its_card_stops_both(tmp_path):
    """Rank 1 asks for the card on this card-less machine: both ranks raise
    together, the message names rank 1, and neither carries on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res, _ = _two_ranks(tmp_path, "no_card")
    for r in res:
        assert r["raised"] is not None and "rank(s) [1]" in r["raised"]

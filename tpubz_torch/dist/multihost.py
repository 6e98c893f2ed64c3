"""Multi-process block-data-parallel compression and decoding on
``torch.distributed`` (the gloo backend), each process driving one card.

The counterpart of ``tpubz/dist/multihost.py``, with its SPMD contract:
every process calls :func:`compress_multihost` (or
:func:`decompress_multihost`) with the same input bytes; on a real
deployment each host reads the input from shared storage. Per step of
``world size`` blocks:

  1. every process takes its own block of the step (rank r the step's r-th;
     a step past the last block gives a 1-byte pad row, as tpubz pads),
  2. the batched transform (``dist/sharded.py``) runs BWT, MTF, RLE2 and the
     compact transfer form on the process's card, with no cross-block
     communication,
  3. each process fetches the compact outputs of its block (a byte a symbol
     and the sidecar of the rare symbols >= 256, the full symbol row only
     when the sidecar overflowed) in one set of pinned copies behind one
     event, and runs Huffman refinement and emission in the native engine:
     the host-side work spreads over the processes,
  4. rank 0 gathers only the packed bits, per step: a small manifest
     all-gather of block indices and bit lengths, then each process's
     flat-packed payload moves to rank 0 ONLY through the TCPStore that
     ``initialize`` made (``_gather_bytes_to_zero``: each payload crosses
     the network once, instead of landing on every process;
     TPUBZ_MULTIHOST_ALLGATHER=1 restores the padded all-gather), and rank
     0 splices the blocks in order, folding the order-dependent stream CRC
     exactly as the single-process path does. Gathering inside the step
     loop bounds every other rank's memory by one step of compressed
     blocks.

Every collective decision is taken together: the transport, whether each
rank has its device, kernels and native engine (a rank that raised alone
would leave the others blocked in the next collective), and on the decode
side whether rank 0's stitch of the stream failed. The process group gets a
finite timeout as a backstop.

Runs unchanged in one process without a process group (rank 0 of 1: the
gathers are the identity). ``tests/test_torch_multihost.py`` runs it as two
real processes over gloo on the CPU, and ``chip_smoke.py``'s [multihost]
phase as two ranks on one card.
"""
from __future__ import annotations

import datetime
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..block.emit import emit_block
from ..block.encode import HI_CAP, block_n, host_copies, resolve_device, uncompact_syms
from ..format.constants import BLOCK_MAGIC, FOOTER_MAGIC, STREAM_MAGIC, block_budget
from ..format.crc import block_crc, stream_crc_fold
from ..hostref.bitio import BitAccum, BitReader, splice_byte_chunks
from ..hostref.rle1 import rle1_blocks
from ..kernels import _build
from .sharded import make_sharded_transform

TIMEOUT_S = 600  # the process group's and the store's timeout

# Accounting of the dominant (payload) transfers, per process: lets the
# 2-process test assert that gather-to-0 moves ~1/nproc of the all-gather's
# bytes. received counts only what THIS process pulled.
last_multihost_stats: dict = {"payload_bytes_sent": 0, "payload_bytes_received": 0,
                              "transport": None}

_KV_CHUNK = 3 << 20  # bytes a store value
_kv_seq = [0]
_store = [None]  # the TCPStore of initialize(), the payload transport


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Bring up the gloo process group (nothing if one is up already), with
    a timeout of TIMEOUT_S as the backstop of every collective.

    With ``coordinator_address`` ("host:port"), a ``TCPStore`` at it with
    rank ``process_id`` 0 as its master joins ``num_processes`` processes,
    and is kept as the payload transport. Without it the group comes from
    the environment (``env://``: torchrun's MASTER_ADDR, MASTER_PORT, RANK
    and WORLD_SIZE) and the payloads take the padded all-gather."""
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator_address is None:
        dist.init_process_group("gloo", timeout=timeout)
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    host, _, port = coordinator_address.rpartition(":")
    store = dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                          timeout=timeout)
    dist.init_process_group("gloo", store=store, rank=process_id, world_size=num_processes,
                            timeout=timeout)
    _store[0] = store


def _rank_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Every rank's equally shaped array, stacked: [world, *arr.shape]."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _agree_ready(what: str, err: Exception | None, nproc: int) -> None:
    """Raise on every rank together if any rank's preparation raised: a
    rank that raised alone would leave the others blocked in the next
    collective. The message names the ranks that failed."""
    if nproc > 1:
        flags = _allgather(np.array([err is not None], np.int32)).reshape(-1)
        failed = [p for p in range(nproc) if flags[p]]
    else:
        failed = [0] if err is not None else []
    if failed:
        here = f": {type(err).__name__}: {err}" if err is not None else ""
        raise RuntimeError(f"{what}: not ready on rank(s) {failed}{here}") from err


def _agree_kv_transport(pid: int, nproc: int) -> bool:
    """Collectively agree on the payload transport for this call: the store
    gather-to-0 runs only if EVERY process has the store and none disabled
    it. The transport is asymmetric (senders set keys, rank 0 pulls), so a
    local choice could pair a process blocking in an all-gather with one
    waiting on keys that never arrive."""
    want = not os.environ.get("TPUBZ_MULTIHOST_ALLGATHER") and _store[0] is not None
    if nproc <= 1:
        return want
    return bool(_allgather(np.array([1 if want else 0], np.int32)).min())


def _gather_bytes_to_zero(tag, payload, sizes, pid, nproc, use_kv):
    """Move each process's payload bytes to rank 0 ONLY.

    ``sizes[p]`` (from the preceding manifest all-gather) tells rank 0 how
    much to pull from each peer. The transport is the TCPStore: each payload
    goes to the store's master once and out once, in _KV_CHUNK pieces that
    rank 0 deletes as it reads them. With ``use_kv`` False (agreed by
    _agree_kv_transport) the payloads take the padded all-gather instead.

    Returns a list of per-process uint8 arrays on rank 0, None elsewhere."""
    store = _store[0] if use_kv else None
    if store is None:
        last_multihost_stats["transport"] = "allgather"
        mx = max(max(sizes), 1)
        pad = np.zeros(mx, np.uint8)
        pad[: payload.size] = payload
        all_flat = _allgather(pad)
        # every process receives every other process's padded payload
        last_multihost_stats["payload_bytes_sent"] += mx * (nproc - 1)
        last_multihost_stats["payload_bytes_received"] += mx * (nproc - 1)
        if pid != 0:
            return None
        return [all_flat[p, : sizes[p]] for p in range(nproc)]
    last_multihost_stats["transport"] = "kv-gather-to-0"
    if pid != 0:
        b = payload.tobytes()
        for ci in range((len(b) + _KV_CHUNK - 1) // _KV_CHUNK):
            store.set(f"{tag}/p{pid}/c{ci}", b[ci * _KV_CHUNK: (ci + 1) * _KV_CHUNK])
        last_multihost_stats["payload_bytes_sent"] += len(b)
        return None
    outs = []
    for p in range(nproc):
        if p == 0:
            outs.append(np.asarray(payload[: sizes[0]]))
            continue
        parts = []
        for ci in range((sizes[p] + _KV_CHUNK - 1) // _KV_CHUNK):
            key = f"{tag}/p{p}/c{ci}"
            parts.append(store.get(key))  # waits for the key, up to the store's timeout
            store.delete_key(key)
        buf = b"".join(parts)
        last_multihost_stats["payload_bytes_received"] += len(buf)
        outs.append(np.frombuffer(buf, np.uint8))
    return outs


def _default_device(pid: int) -> str:
    """cuda:{LOCAL_RANK} where it is set, else cuda:{rank % cards}."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return f"cuda:{int(local)}"
    count = torch.cuda.device_count()
    return f"cuda:{pid % count if count else 0}"


def compress_multihost(data: bytes | np.ndarray, level: int = 9, *, device=None):
    """Compress over all processes of the process group, each on its card
    (``device``: default ``cuda:{LOCAL_RANK}``, else ``cuda:{rank %
    cards}``; "cpu" runs the plain versions, for the tests).

    Returns the .bz2 bytes on rank 0 and None on the other ranks. Raises on
    every rank together when any rank lacks its device, its kernels or the
    native engine: nothing runs on the CPU in place of a card."""
    if not 1 <= level <= 9:
        raise ValueError("level must be 1..9")
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    pid, nproc = _rank_world()
    err, dev = None, None
    try:
        dev = resolve_device(_default_device(pid) if device is None else device)
        if dev.type == "cuda":
            _build.load()
        native.get_lib()
    except Exception as e:  # every rank learns of it in _agree_ready, and raises
        err = e
    _agree_ready("compress_multihost", err, nproc)
    use_kv = _agree_kv_transport(pid, nproc)

    out, blocks = rle1_blocks(arr, block_budget(level))
    N = block_n(level)
    transform = make_sharded_transform(dev, N)
    _kv_seq[0] += 1
    last_multihost_stats.update(payload_bytes_sent=0, payload_bytes_received=0, transport=None)

    nblocks = len(blocks)
    # per-block packed bits, kept on rank 0 only: the gather runs INSIDE the
    # step loop, so another rank's memory holds one step of compressed
    # blocks whatever the stream's length
    per_block: dict[int, tuple[np.ndarray | bytes, int]] = {}
    for base in range(0, nblocks, nproc):
        g = base + pid  # this rank's block of the step
        row = torch.zeros(1, N, dtype=torch.uint8)
        n = [1]  # a pad row: a 1-byte dummy
        if g < nblocks:
            o0, o1, _, _ = blocks[g]
            row[0, : o1 - o0] = torch.from_numpy(out[o0:o1])
            n = [o1 - o0]
        keys, syms, rle2_len, freqs, used, syms_u8, hi_packed, hi_count = transform(row, n)
        # the compact outputs only, in one set of copies behind one event:
        # a byte a symbol instead of two
        host, event = host_copies(dev, keys, rle2_len, freqs, used, syms_u8, hi_packed, hi_count)
        if event is not None:
            event.synchronize()
        key_h, len_h, freq_h, used_h, u8_h, hip_h, hic_h = (h.numpy() for h in host)
        step_payloads: dict[int, tuple[bytes, int]] = {}
        if g < nblocks:
            _, _, i0, i1 = blocks[g]
            hc = int(hic_h[0])
            if hc > HI_CAP:  # sidecar overflow (pathological): the full row
                syms_r = syms[0].cpu().numpy()
            else:
                syms_r = uncompact_syms(u8_h[0], hip_h[0], hc)
            acc = emit_block(int(key_h[0]), syms_r, int(len_h[0]), freq_h[0], used_h[0],
                             block_crc(arr[i0:i1]))
            step_payloads[g] = acc.pack()
        if nproc == 1:
            for bi, (payload, nbits) in step_payloads.items():
                per_block[bi] = (np.frombuffer(payload, np.uint8), nbits)
            continue
        # manifest: (block index + 1, bit length) of this rank's block; the
        # flat payload
        manifest = np.zeros((1, 2), np.int64)
        flat = np.zeros(0, np.uint8)
        for bi, (payload, nbits) in step_payloads.items():
            manifest[0] = (bi + 1, nbits)
            flat = np.frombuffer(payload, np.uint8)
        all_man = _allgather(manifest)
        flat_caps = (all_man[:, :, 1] + 7) // 8 * (all_man[:, :, 0] > 0)
        sizes = [int(flat_caps[p].sum()) for p in range(nproc)]
        flats = _gather_bytes_to_zero(f"tpubz_torch/enc/{_kv_seq[0]}/{base}", flat, sizes, pid,
                                      nproc, use_kv)
        if pid != 0:
            continue
        for p in range(nproc):
            off = 0
            for j in range(all_man.shape[1]):
                bi, nbits = int(all_man[p, j, 0]) - 1, int(all_man[p, j, 1])
                if bi < 0:
                    continue
                nbytes = (nbits + 7) // 8
                per_block[bi] = (flats[p][off: off + nbytes], nbits)
                off += nbytes

    if pid != 0:
        return None

    # assemble in block order with the order-dependent stream CRC fold
    header = BitAccum()
    for b in STREAM_MAGIC:
        header.put(b, 8)
    header.put(0x30 + level, 8)
    chunks = [header.pack()]
    s_crc = 0
    for bi in range(nblocks):
        _, _, i0, i1 = blocks[bi]
        s_crc = stream_crc_fold(s_crc, block_crc(arr[i0:i1]))
        payload, nbits = per_block[bi]
        chunks.append((np.ascontiguousarray(payload).tobytes(), nbits))
    footer = BitAccum()
    footer.put(FOOTER_MAGIC, 48)
    footer.put(s_crc, 32)
    chunks.append(footer.pack())
    stream, _ = splice_byte_chunks(chunks)
    return stream


def decompress_multihost(data: bytes) -> bytes | None:
    """Decode .bz2 bytes data-parallel over all processes of the process
    group, the multi-process extension of the single-process block-parallel
    decode (``stream/decode.py``). A stream has no block index and its
    blocks are bit-aligned; the magic scan and the validating walk remove
    that constraint, and the candidate decodes spread across processes.
    Decoding is host-native work: no card is involved.

    SPMD contract as for ``compress_multihost``. Returns the raw bytes on
    rank 0 and None elsewhere; a corrupt stream raises on every rank.

    Candidate block starts (a 48-bit magic scan over the whole buffer,
    concatenated streams included) are dealt round-robin to the processes,
    a window at a time; each pre-decodes its share with the GIL-free native
    engine on a local thread pool; the decoded blocks of a window move to
    rank 0 (a manifest all-gather, then the payloads by the agreed
    transport); rank 0 walks the bit chain stream by stream, taking the
    gathered results and decoding locally any candidate that is missing or
    was a payload false positive, checking block CRCs and the stream CRC as
    the single-process decoder does. The walked-past position is broadcast
    after each window, with a flag that ends every process's loop when the
    walk is done or failed."""
    pid, nproc = _rank_world()
    # the engine must be there on every rank: the port has no numpy decoder,
    # and a rank that raised alone would leave the others in the collectives
    err = None
    try:
        native.get_lib()
    except RuntimeError as e:
        err = e
    _agree_ready("decompress_multihost", err, nproc)
    use_kv = _agree_kv_transport(pid, nproc)
    if len(data) < 4 or data[:3] != STREAM_MAGIC:
        raise ValueError("not a bzip2 stream")

    arr = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8))

    # ---- candidate scan (identical on every process: same input) ----
    blocks_hits, _ = native.find_magic2_native(arr, BLOCK_MAGIC, FOOTER_MAGIC)
    candidates = [int(c) for c in blocks_hits if c >= 32]

    # per-candidate level: byte-aligned "BZh"+digit headers partition the
    # buffer into streams; a payload false positive here only mislevels a
    # pre-decode, which rank 0's walk heals by re-decoding locally
    hdr_bytes = np.flatnonzero(
        (arr[:-3] == 0x42) & (arr[1:-2] == 0x5A) & (arr[2:-1] == 0x68)
        & (arr[3:] >= 0x31) & (arr[3:] <= 0x39)
    )
    if hdr_bytes.size == 0 or hdr_bytes[0] != 0:
        raise ValueError("invalid block size digit")
    cand_levels = [
        int(arr[hdr_bytes[np.searchsorted(hdr_bytes * 8 + 32, c, "right") - 1] + 3]) - 0x30
        for c in candidates
    ]

    def try_decode(i):
        """(raw, end_bit, blk_crc, actual, used_level) or None.

        A payload false-positive "BZh" header between this candidate's true
        stream header and the candidate can mislevel it; decoding depends on
        the level only through the output cap, so a failed pre-decode
        retries at the format's maximum. The level used rides along: a
        retry at 9 allows more output than the stream's true level, so the
        walk re-decodes at the true level whenever the level used is
        higher."""
        try:
            return (*native.decode_block_native(arr, candidates[i] + 48, cand_levels[i]),
                    cand_levels[i])
        except ValueError:
            if cand_levels[i] < 9:
                try:
                    return (*native.decode_block_native(arr, candidates[i] + 48, 9), 9)
                except ValueError:
                    return None
            return None

    decoded: dict[int, tuple] = {}

    # ---- incremental ordered stitch (rank 0) ----
    # The walk advances as far as the gathered windows allow after EVERY
    # window: consumed payloads are released at once, and the walked-past
    # bit position is broadcast so that later windows skip candidates the
    # chain already passed (payload false positives) and stop once the
    # final footer is consumed.
    out_parts: list[bytes] = []
    walk = {"pos_byte": 0, "pos": -1, "s_crc": 0, "level": 0, "in_stream": False, "done": False}

    def advance_walk(limit_bit):
        """Stitch forward until done, or until the next needed block lies
        past ``limit_bit`` (not gathered yet; None: no limit, decode locally
        whatever is missing)."""
        while not walk["done"]:
            if not walk["in_stream"]:
                pb = walk["pos_byte"]
                if pb + 4 > len(data) or data[pb: pb + 3] != STREAM_MAGIC:
                    walk["done"] = True
                    break
                level = data[pb + 3] - 0x30
                if not 1 <= level <= 9:
                    raise ValueError("invalid block size digit")
                walk["level"] = level
                walk["pos"] = pb * 8 + 32
                walk["s_crc"] = 0
                walk["in_stream"] = True
            pos = walk["pos"]
            br = BitReader(data)
            br.pos = pos
            tag = br.read(48)
            if tag == FOOTER_MAGIC:
                stored = br.read(32)
                if stored != walk["s_crc"]:
                    raise ValueError(
                        f"stream CRC mismatch: stream says {stored:#010x}, "
                        f"got {walk['s_crc']:#010x}"
                    )
                walk["pos_byte"] = (br.pos + 7) // 8
                walk["in_stream"] = False
                continue
            if tag != BLOCK_MAGIC:
                raise ValueError("invalid block header magic")
            hit = decoded.get(pos)
            if hit is not None and hit[4] > walk["level"]:
                # pre-decoded under a looser output cap than this stream's
                # level (the mislevel retry): re-decode at the true level,
                # so that an oversized block raises as the serial decoder's
                hit = None
            if hit is None:
                if limit_bit is not None and pos > limit_bit:
                    return  # a later window brings this block
                hit = (*native.decode_block_native(arr, pos + 48, walk["level"]), walk["level"])
            else:
                decoded.pop(pos, None)  # consumed: release the payload
            raw, end_bit, blk_crc, actual, _ = hit
            if int(actual) != int(blk_crc):
                raise ValueError(
                    f"block CRC mismatch: stream says {int(blk_crc):#010x}, "
                    f"got {int(actual):#010x}"
                )
            walk["s_crc"] = stream_crc_fold(walk["s_crc"], int(blk_crc))
            out_parts.append(np.asarray(raw).tobytes())
            walk["pos"] = int(end_bit)

    if nproc == 1:
        mine = list(range(len(candidates)))
        if mine:
            with ThreadPoolExecutor(min(32, len(mine))) as ex:
                for i, res in zip(mine, ex.map(try_decode, mine)):
                    if res is not None:
                        decoded[candidates[i]] = res
        advance_walk(None)
        return b"".join(out_parts)

    def broadcast_state(walk_err) -> tuple[int, int]:
        """Rank 0's walked-past bit and flag (0 go on, 1 done, 2 the walk
        failed), on every rank."""
        state = torch.zeros(2, dtype=torch.int64)
        if pid == 0:
            wp = max(walk["pos"] if walk["in_stream"] else walk["pos_byte"] * 8, 0)
            state[0] = wp
            state[1] = 2 if walk_err is not None else int(walk["done"])
        dist.broadcast(state, 0)
        return int(state[0]), int(state[1])

    def fail_together(walk_err):
        """The walk failed on rank 0: every rank raises."""
        if walk_err is not None:
            raise walk_err
        raise ValueError("decompress_multihost: the stream failed to decode on rank 0")

    # Candidates go in WINDOWS so that a process holds one window of decoded
    # blocks at a time; payloads travel flat-packed by the agreed transport
    # (only rank 0 stitches). Window default: 8 candidates a process.
    win = max(1, int(os.environ.get("TPUBZ_MULTIHOST_WINDOW", "8")))
    walked_past = 0  # broadcast after each window: skip candidates below
    ex = ThreadPoolExecutor(min(32, win))
    try:
        for w0 in range(0, len(candidates), win * nproc):
            win_ids = list(range(w0, min(w0 + win * nproc, len(candidates))))
            mine = [i for i in win_ids
                    if (i - w0) % nproc == pid and candidates[i] >= walked_past]
            local: dict[int, tuple] = {}
            for i, res in zip(mine, ex.map(try_decode, mine)):
                if res is not None:
                    local[candidates[i]] = res
            # manifest: (candidate + 1, end bit, stored CRC, computed CRC,
            # raw bytes, level used) a row; an all-zero row is an empty slot
            meta = np.zeros((win, 6), np.int64)
            for j, c in enumerate(sorted(local)):
                raw, end_bit, blk_crc, actual, used_lvl = local[c]
                meta[j] = (c + 1, end_bit, blk_crc, actual, raw.size, used_lvl)
            all_meta = _allgather(meta)
            flat_sizes = [int(all_meta[p, :, 4][all_meta[p, :, 0] > 0].sum())
                          for p in range(nproc)]
            if any(flat_sizes):
                flat = (np.concatenate([np.asarray(local[c][0]) for c in sorted(local)])
                        if local else np.zeros(0, np.uint8))
                flats = _gather_bytes_to_zero(f"tpubz_torch/dec/{_kv_seq[0]}/{w0}", flat,
                                              flat_sizes, pid, nproc, use_kv)
                if pid == 0:
                    for p in range(nproc):
                        off = 0
                        for row in all_meta[p]:
                            if row[0] == 0:
                                continue
                            c, end_bit, blk_crc, actual, size, used_lvl = (int(v) for v in row)
                            decoded[c - 1] = (flats[p][off: off + size], end_bit, blk_crc,
                                              actual, used_lvl)
                            off += size
            # incremental stitch and the walk-state broadcast. A stitch
            # failure (a corrupt stream: CRC or magic errors) must NOT raise
            # on rank 0 alone: the others are already waiting in this
            # broadcast or the next window's all-gather and would hang. The
            # error rides the flag, and every rank raises together.
            walk_err = None
            if pid == 0:
                try:
                    advance_walk(candidates[win_ids[-1]])
                except (ValueError, EOFError) as e:
                    walk_err = e
            walked_past, flag = broadcast_state(walk_err)
            if flag == 2:
                fail_together(walk_err)
            if flag == 1:
                break
    finally:
        ex.shutdown(wait=False)

    # the rest of the walk (blocks no window brought), under the same rule
    walk_err = None
    if pid == 0:
        try:
            advance_walk(None)
        except (ValueError, EOFError) as e:
            walk_err = e
    if broadcast_state(walk_err)[1] == 2:
        fail_together(walk_err)
    return b"".join(out_parts) if pid == 0 else None

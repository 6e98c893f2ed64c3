"""Device block encoder: BWT -> MTF -> RLE2 on one torch device.

The counterpart of ``tpubz/block/encode.py:DeviceBlockEncoder``. ``transform``
copies an RLE1 block to the device once, pads it there and runs the three
transforms; ``fetch`` brings back what the host emission needs, as
``tpubz.block.encode.materialize`` returns it. ``transform_bwt`` and
``fetch_bwt`` are the bwt-only stage: the device runs the suffix sort and the
host gets the key and the last column. Huffman refinement and bit emission
run in the port's native engine (``block/emit.py``), or, through
``encode_block_devrefine``, the refinement's per-group costs and frequencies
and the payload's packing run on the device and only the tree builds, the
selector MTF and the headers on the host (tpubz's device refine, an entry
point that no route takes, as in tpubz).

The fetches come in two halves so that the thread launching device work
never waits for a copy: ``fetch_async`` / ``fetch_bwt_async`` enqueue the
device-to-host copies on the current CUDA stream, non-blocking, into pinned
host tensors and record an event; ``.result()`` on what they return waits
for that event, on whichever thread calls it. On a CPU device the copies are
the tensors themselves.

The compact transfer form of tpubz's symbol rows (a byte a symbol and a
sidecar of the rare symbols >= 256, ``kernels/compact.py``) is fetched by the
multi-process path (``dist/multihost.py``), and ``uncompact_syms`` here is
its one host decoder, as in tpubz. The one-block path fetches the symbols as
int16. The TPU relay and compile machinery of the JAX encoder (persistent
compile cache, staged jits, warm stamps) has no counterpart here: PyTorch
runs eagerly and the card sits on PCIe.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..format.constants import BLOCK_MAGIC, MAX_ALPHA_SIZE, MAX_GROUPS, group_count_for, huffman_iters
from ..hostref.bitio import BitAccum
from ..hostref.huffman import c_init_tables, huffman_emit_headers, mtf_selectors
from ..kernels.compact import HI_CAP  # noqa: F401 (the sidecar's capacity, as tpubz's)
from ..kernels.huffman_dev import chunk_hist, nsel_cap, pack_payload, refine_pass
from ..kernels.mtf import CHUNK as MTF_CHUNK
from ..kernels.mtf import mtf_ranks
from ..kernels.rle2 import rle2_encode
from ..kernels.suffix_sort import bwt_forward
from ..native import code_lengths_native
from .emit import emit_block


def block_n(level: int) -> int:
    """Padded device block length: level * 100k rounded up to the chunk.
    Declared here, not imported (tpubz.block.encode imports jax); the tests
    hold it and MTF_CHUNK equal to tpubz's."""
    raw = level * 100_000
    return (raw + MTF_CHUNK - 1) // MTF_CHUNK * MTF_CHUNK


def resolve_device(device) -> torch.device:
    """The device asked for. A CUDA device without a usable card raises:
    the port never carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch.cuda.is_available() is False"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def uncompact_syms(syms_u8: np.ndarray, hi_packed: np.ndarray, hc: int) -> np.ndarray:
    """Invert the compact transfer form (``kernels/compact.py``): the u8
    stream back to uint16 symbols with the sidecar's symbols >= 256 patched
    in. The one host decoder of the ``(pos << 1) | (sym - 256)`` contract,
    as ``tpubz/block/encode.py:uncompact_syms`` is tpubz's. The caller
    fetches the full row instead when the sidecar overflowed (hc > HI_CAP)."""
    s = syms_u8.astype(np.uint16)
    if hc:
        packed = hi_packed[:hc]
        s[packed >> 1] = 256 + (packed & 1)
    return s


def _small_vector(key, rle2_len, freqs, used) -> torch.Tensor:
    """The scalars, frequencies and used map of a transform result as one
    int64 vector, to travel as one copy: [key, rle2_len, freqs[258], used[256]]."""
    return torch.cat((key.reshape(1).to(torch.int64), rle2_len.reshape(1).to(torch.int64),
                      freqs.to(torch.int64), used.to(torch.int64)))


def host_copies(device: torch.device, *tensors):
    """(host tensors, event): pinned non-blocking copies on the current
    stream and the event after them; on the CPU the tensors, no event."""
    if device.type == "cpu":
        return tensors, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def payload_tables(sel, codes, lens, tc: int, alpha: int, out_len: int, device):
    """A block's final selectors, codes and lengths as ``pack_payload`` takes
    them, on ``device``: sel int8[nsel_cap(out_len)], codes and lens
    int32[6, 258], zero past the block's selectors, tables and symbols."""
    sel_pad = np.zeros(nsel_cap(out_len), np.int8)
    sel_pad[: sel.size] = sel
    codes_pad = np.zeros((MAX_GROUPS, MAX_ALPHA_SIZE), np.int32)
    codes_pad[:tc, :alpha] = codes[:tc, :alpha]
    lens_pad = np.zeros((MAX_GROUPS, MAX_ALPHA_SIZE), np.int32)
    lens_pad[:tc, :alpha] = lens[:tc, :alpha]
    return tuple(torch.from_numpy(a).to(device) for a in (sel_pad, codes_pad, lens_pad))


class Pending:
    """Host copies in flight: ``result()`` waits for their event (none on a
    CPU device) and returns ``finish()``."""

    def __init__(self, event, finish):
        self._event = event
        self._finish = finish

    def result(self):
        if self._event is not None:
            self._event.synchronize()  # releases the GIL while it waits
        return self._finish()


class DeviceBlockEncoder:
    """Encodes RLE1 blocks through the torch transform chain on ``device``."""

    def __init__(self, level: int, device="cuda"):
        if not 1 <= level <= 9:
            raise ValueError("level must be 1..9")
        self.level = level
        self.device = resolve_device(device)
        self.N = block_n(level)
        # the stream the scheduler's dispatcher launches on: one per encoder,
        # since the caching allocator reuses freed device memory only on the
        # stream it was allocated on
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def upload(self, rle1_block: np.ndarray) -> torch.Tensor:
        """The block on the device, zero-padded to N: uint8[N]."""
        n = int(rle1_block.size)
        if n > self.N:
            raise ValueError(f"block of {n} bytes exceeds N={self.N}")
        data = torch.zeros(self.N, dtype=torch.uint8, device=self.device)
        # np.require copies only a read-only view, which torch cannot wrap
        data[:n].copy_(torch.from_numpy(np.require(rle1_block, np.uint8, "CW")))
        return data

    def transform(self, rle1_block: np.ndarray):
        """Device tensors (key, syms, rle2_len, freqs, used) of one block."""
        n = int(rle1_block.size)
        key, last = bwt_forward(self.upload(rle1_block), n)
        ranks, used = mtf_ranks(last, n, MTF_CHUNK)
        eob = used.sum() + 1
        syms, rle2_len, freqs = rle2_encode(ranks, n, eob)
        return key, syms, rle2_len, freqs, used

    def transform_bwt(self, rle1_block: np.ndarray):
        """The bwt-only stage: (key 0-d int64, last uint8[N], n) on the
        device, the upload and the suffix sort only."""
        n = int(rle1_block.size)
        key, last = bwt_forward(self.upload(rle1_block), n)
        return key, last, n

    def fetch_async(self, out) -> Pending:
        """Start the host copy of a transform result; ``.result()`` is
        ``fetch``'s tuple. The scalars, freqs and used map travel as one
        int64 vector and the symbols (<= 258) as int16: two copies."""
        key, syms, rle2_len, freqs, used = out
        small = _small_vector(key, rle2_len, freqs, used)
        (h_small, h_syms), event = host_copies(self.device, small, syms.to(torch.int16))

        def finish():
            s = h_small.numpy()
            rl = int(s[1])
            return (
                int(s[0]),
                h_syms[:rl].numpy().view(np.uint16),
                rl,
                s[2:260].copy(),
                s[260:] != 0,
            )

        return Pending(event, finish)

    def fetch(self, out):
        """Host copy of a transform result: (key int, syms uint16[rle2_len],
        rle2_len int, freqs int64[258], used bool[256]), EOB at rle2_len-1."""
        return self.fetch_async(out).result()

    def fetch_bwt_async(self, out) -> Pending:
        """Start the host copy of a ``transform_bwt`` result; ``.result()``
        is ``fetch_bwt``'s pair."""
        key, last, n = out
        (h_key, h_last), event = host_copies(self.device, key.view(1), last)
        return Pending(event, lambda: (int(h_key[0]), h_last[:n].numpy()))

    def fetch_bwt(self, out):
        """(key int, last uint8[n]) of a ``transform_bwt`` result."""
        return self.fetch_bwt_async(out).result()

    emit_block = staticmethod(emit_block)

    def encode_block(self, rle1_block: np.ndarray, crc: int):
        """One block's packed bits (a ``BitAccum``)."""
        return self.emit_block(*self.fetch(self.transform(rle1_block)), crc)

    def _fetch_now(self, *tensors) -> list[np.ndarray]:
        """The tensors on the host as numpy arrays: pinned copies behind one
        event, waited for."""
        host, event = host_copies(self.device, *tensors)
        return Pending(event, lambda: [h.numpy() for h in host]).result()

    def _on_stream(self):
        """Work on the encoder's stream, after what the caller's stream has
        enqueued (the transform's outputs); nothing on a CPU device."""
        if self.stream is None:
            return contextlib.nullcontext()
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self.stream)

    def devrefine_tables(self, hist: torch.Tensor, rle2_len: int, freqs: np.ndarray,
                         alpha: int):
        """The refinement of one block with its per-group costs and
        frequencies on the device: C bzip2's initial tables, then passes of
        ``refine_pass``, each followed on the host by the code lengths of
        the pass's frequencies (the native tree builds) and the exact size
        of what the block would emit; the smallest snapshot wins, and the
        passes stop after the fourth at the first that does not shrink it.
        The order of ``refine.cpp`` and of tpubz's ``encode_block_devrefine``.

        Returns (selectors int64[nsel], lengths int64[6, 258], rfreq
        int64[6, 258], table count, passes run). Each pass fetches its
        selectors and frequencies into pinned host buffers behind one event."""
        tc = group_count_for(rle2_len)
        nsel = nsel_cap(rle2_len)
        lens = c_init_tables(freqs.astype(np.int64), tc, alpha)
        best = None
        stale = 0
        passes = 0
        for it in range(huffman_iters()):
            lens_d = torch.from_numpy(lens.astype(np.int32)).to(self.device)
            sel_d, rfreq_d = refine_pass(hist, lens_d, tc)
            sel, rfreq = (a.astype(np.int64) for a in self._fetch_now(sel_d[:nsel], rfreq_d))
            passes += 1
            for t in range(tc):
                lens[t, :alpha] = code_lengths_native(rfreq[t], alpha)
            # the exact bits of this snapshot: the payload as rfreq x the new
            # lengths, the unary selectors, the length deltas, the origins
            payload = int((rfreq[:tc, :alpha] * lens[:tc, :alpha]).sum())
            sel_bits = int(mtf_selectors(sel).sum()) + nsel
            dl = int(np.abs(np.diff(lens[:tc, :alpha], axis=1)).sum())
            bits = payload + sel_bits + dl * 2 + tc * (alpha + 5)
            if best is None or bits < best[0]:
                best = (bits, sel, lens.copy(), rfreq)
                stale = 0
            else:
                stale += 1
            if it >= 3 and stale >= 1:
                break
        _, sel, lens, rfreq = best
        return sel, lens, rfreq, tc, passes

    def encode_block_devrefine(self, trans_out, crc: int, hist: torch.Tensor | None = None):
        """One block's packed bits (a ``BitAccum``) from a ``transform``
        result, with the refinement's per-group costs and frequencies and
        the payload's packing on the device (``kernels/huffman_dev.py``).
        The bytes equal ``emit_block``'s on the fetched result.

        trans_out: (key, syms, rle2_len, freqs, used) on the device, the
        one-block transform's or a row of the batched one's. ``hist``: the
        block's ``chunk_hist``, when the caller built it (for a batch's rows
        in one ``chunk_hist_batch`` launch, as tpubz's transform hands its
        encoder trans_out[8]); else it is built here. Only the scalars, the
        frequencies and the used map, each pass's selectors and frequencies
        and the payload's words cross to the host. A payload whose bit
        count on the device differs from the host's raises RuntimeError."""
        key_d, syms_d, rle2_len_d, freqs_d, used_d = trans_out[:5]
        with self._on_stream():
            if hist is None:
                hist = chunk_hist(syms_d, rle2_len_d)
            (small,) = self._fetch_now(_small_vector(key_d, rle2_len_d, freqs_d, used_d))
            key, rle2_len = int(small[0]), int(small[1])
            freqs, used = small[2:260], small[260:] != 0
            alpha = int(used.sum()) + 2
            sel, lens, rfreq, tc, _ = self.devrefine_tables(hist, rle2_len, freqs, alpha)
            payload_bits = int((rfreq[:tc, :alpha] * lens[:tc, :alpha]).sum())
            acc = BitAccum()
            acc.put(BLOCK_MAGIC, 48)
            acc.put(crc, 32)
            acc.put(0, 1)
            acc.put(key, 24)
            codes = huffman_emit_headers(acc, used, sel, lens[:, :alpha], tc)
            tables = payload_tables(sel, codes, lens, tc, alpha, syms_d.shape[0], self.device)
            words_d, total_d = pack_payload(syms_d, rle2_len_d, *tables)
            # the words the payload fills, no more
            words, total = self._fetch_now(words_d[: (payload_bits + 31) // 32],
                                           total_d.reshape(1))
            words, total = words.view(np.uint32), int(total[0])
        if total != payload_bits:
            raise RuntimeError(f"the payload packed on the device has {total} bits, the "
                               f"refinement counted {payload_bits}")
        acc.put_words(words, payload_bits)
        return acc

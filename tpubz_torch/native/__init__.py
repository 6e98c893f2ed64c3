"""The port's native (C++) host engine, built at first use and loaded with ctypes.

The six sources here are the host engine of ``tpubz/native`` (RLE1 scan, SA-IS
BWT with MTF/RLE2, Huffman refinement and block emission, bit packing, block
decode, magic scan, CRC). g++ compiles them into
``tpubz_torch/_build/libtpubz_torch_native.so`` on the first call of a
process that needs them; the library is rebuilt when a source is newer than
it. The C symbols keep their ``tpubz_*`` names; this is a library of its own,
opened through its own ``ctypes.CDLL`` handle.

There is no second engine behind it: when g++ is missing or the build
fails, ``get_lib`` raises RuntimeError with the compiler's message.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ["refine.cpp", "rle1.cpp", "decode.cpp", "pack.cpp", "bwt.cpp", "emit.cpp"]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libtpubz_torch_native.so")
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
# (restype, argtypes) of every entry point the port calls; every pointer is
# c_void_p, so ctypes never cuts one to 32 bits
SIGNATURES = {
    "tpubz_rle1_split": (_I64, [_P, _I64, _I64, _P, _P, _P, _I64]),
    "tpubz_pack_bits": (_I64, [_P, _P, _I64, _P, _I64, _P]),
    "tpubz_block_crc": (_U32, [_P, _I64]),
    "tpubz_mtf_rle2": (_I64, [_P, _I64, _P, _P, _P]),
    "tpubz_block_transform": (_I64, [_P, _I64, _P, _P, _P, _P]),
    "tpubz_emit_block": (_I64, [_I32, _U32, _P, _I64, _P, _I32, _P, _I64, _P]),
    "tpubz_decode_block": (_I64, [_P, _I64, _I64, _I32, _P, _I64, _P, _P, _P]),
    "tpubz_find_magic": (_I64, [_P, _I64, _U64, _P, _I64]),
    "tpubz_find_magic2": (None, [_P, _I64, _U64, _U64, _P, _I64, _P, _P, _I64, _P]),
    "tpubz_code_lengths": (None, [_P, _I32, _P]),
    "tpubz_mtf_selectors": (None, [_P, _I64, _P]),
}

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return [os.path.join(_HERE, s) for s in SOURCES]


def build() -> str:
    """Compile the sources with g++ unless the library is newer than every
    one of them. Processes that build at once take turns on a lock file;
    the library is renamed into place whole. Raises RuntimeError when g++
    is missing or fails."""
    srcs = sources()
    stamp = max(os.path.getmtime(s) for s in srcs)

    def fresh() -> bool:
        return os.path.exists(LIB_PATH) and os.path.getmtime(LIB_PATH) >= stamp

    if fresh():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():  # another process built it while this one waited
            return LIB_PATH
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, *srcs, "-o", tmp],
                                  capture_output=True, text=True, timeout=600)
        except FileNotFoundError as e:
            os.unlink(tmp)
            raise RuntimeError("g++ not found: the port's host engine needs it") from e
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed with exit code {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on the first call of the process."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(build())
                for name, (restype, argtypes) in SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.restype = restype
                    fn.argtypes = argtypes
                _lib = lib
    return _lib


def rle1_split_native(data: np.ndarray, budget: int):
    """RLE1-encode and split into blocks: (rle1_out, [(out_lo, out_hi,
    in_lo, in_hi), ...])."""
    arr = np.ascontiguousarray(data, dtype=np.uint8)
    n = arr.size
    # worst case: runs of exactly 4 expand 4 -> 5 bytes
    out = np.empty(n + n // 4 + 16, dtype=np.uint8)
    out_len = np.zeros(1, dtype=np.int64)
    # blocks can close up to 5 bytes short of the budget (segment granularity)
    cap = max(4, out.size // max(budget - 5, 1) + 8)
    blocks = np.zeros((cap, 4), dtype=np.int64)
    nb = get_lib().tpubz_rle1_split(arr.ctypes.data, n, budget, out.ctypes.data,
                                    out_len.ctypes.data, blocks.ctypes.data, cap)
    if nb > cap:
        raise RuntimeError("rle1 block capacity underestimated")
    return out[: int(out_len[0])], [tuple(int(x) for x in row) for row in blocks[:nb]]


def rle1_split_window(arr: np.ndarray, start: int, end: int, budget: int,
                      out: np.ndarray, out_base: int):
    """Scan arr[start:end) with the RLE1 splitter, writing at
    out[out_base:]. Returns (blocks, out_len), blocks in window-local
    coordinates. The scanner takes ``end`` as the end of the input, so for
    end < arr.size the caller drops the blocks whose cuts could see the
    boundary and scans again from the last one it keeps (cuts are
    segment-aligned, so a scan re-entered at a true block boundary gives
    the full scan's bytes)."""
    cap = max(4, (out.size - out_base) // max(budget - 5, 1) + 8)
    blocks = np.zeros((cap, 4), dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    nb = get_lib().tpubz_rle1_split(arr.ctypes.data + start, end - start, budget,
                                    out.ctypes.data + out_base, out_len.ctypes.data,
                                    blocks.ctypes.data, cap)
    if nb > cap:
        raise RuntimeError("rle1 block capacity underestimated")
    return [tuple(int(x) for x in row) for row in blocks[:nb]], int(out_len[0])


def code_lengths_native(freqs: np.ndarray, alpha: int) -> np.ndarray:
    """C bzip2's code lengths of one table from its symbol frequencies
    (17-bit cap, weights flattened and the tree built again while a code is
    longer): int64[alpha]."""
    f = np.ascontiguousarray(freqs[:alpha], dtype=np.int64)
    out = np.zeros(alpha, dtype=np.int32)
    get_lib().tpubz_code_lengths(f.ctypes.data, alpha, out.ctypes.data)
    return out.astype(np.int64)


def mtf_selectors_native(selectors: np.ndarray) -> np.ndarray:
    """The move-to-front indices of a block's selectors: int64[nsel]."""
    sel = np.ascontiguousarray(selectors, dtype=np.int32)
    out = np.zeros(sel.size, dtype=np.int32)
    get_lib().tpubz_mtf_selectors(sel.ctypes.data, sel.size, out.ctypes.data)
    return out.astype(np.int64)


def pack_bits_native(vals: np.ndarray, bits: np.ndarray) -> bytes:
    """Pack (value, bit length) fields MSB-first, zero-padded to a byte."""
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    bits = np.ascontiguousarray(bits, dtype=np.int64)
    cap = int(bits.sum()) // 8 + 16
    out = np.empty(cap, dtype=np.uint8)
    total = np.zeros(1, dtype=np.int64)
    nbytes = get_lib().tpubz_pack_bits(vals.ctypes.data, bits.ctypes.data, vals.size,
                                       out.ctypes.data, cap, total.ctypes.data)
    if nbytes < 0:
        raise RuntimeError("pack capacity underestimated")
    return out[:nbytes].tobytes()


def block_crc_native(arr: np.ndarray) -> int:
    """CRC-32/BZIP2 (slice-by-8)."""
    a = np.ascontiguousarray(arr, dtype=np.uint8)
    return int(get_lib().tpubz_block_crc(a.ctypes.data, a.size))


def mtf_rle2_native(last: np.ndarray):
    """MTF + RLE2 over a BWT last column in one GIL-free call: (rle2
    uint16, freqs uint32[258], used bool[256])."""
    arr = np.ascontiguousarray(last, dtype=np.uint8)
    out = np.empty(arr.size + 8, dtype=np.uint16)
    freqs = np.zeros(258, dtype=np.uint32)
    used = np.zeros(256, dtype=np.uint8)
    rl = get_lib().tpubz_mtf_rle2(arr.ctypes.data, arr.size, out.ctypes.data,
                                  freqs.ctypes.data, used.ctypes.data)
    if rl < 0:
        raise RuntimeError(f"tpubz_mtf_rle2 failed ({rl})")
    return out[:rl], freqs, used.astype(bool)


def block_transform_native(block: np.ndarray):
    """BWT + MTF + RLE2 of one block in one GIL-free call: (key, rle2
    uint16, freqs uint32[258], used bool[256])."""
    arr = np.ascontiguousarray(block, dtype=np.uint8)
    out = np.empty(arr.size + 8, dtype=np.uint16)
    freqs = np.zeros(258, dtype=np.uint32)
    used = np.zeros(256, dtype=np.uint8)
    key = np.zeros(1, dtype=np.int32)
    rl = get_lib().tpubz_block_transform(arr.ctypes.data, arr.size, out.ctypes.data,
                                         freqs.ctypes.data, used.ctypes.data,
                                         key.ctypes.data)
    if rl < 0:
        raise RuntimeError(f"tpubz_block_transform failed ({rl})")
    return int(key[0]), out[:rl], freqs, used.astype(bool)


def emit_block_native(key: int, crc: int, syms: np.ndarray, used: np.ndarray,
                      iters: int):
    """Refinement, headers, payload and packing of one block in one
    GIL-free call: (packed bytes, bit length)."""
    s = np.ascontiguousarray(syms, dtype=np.uint16)
    u = np.ascontiguousarray(used, dtype=np.uint8)
    cap = int(s.size) * 20 // 8 + 8192
    out = np.empty(cap, dtype=np.uint8)
    tb = np.zeros(1, dtype=np.int64)
    n = get_lib().tpubz_emit_block(int(key), int(crc) & 0xFFFFFFFF, s.ctypes.data, s.size,
                                   u.ctypes.data, int(iters), out.ctypes.data, cap,
                                   tb.ctypes.data)
    if n < 0:
        raise RuntimeError(f"tpubz_emit_block failed ({n})")
    return out[:n].tobytes(), int(tb[0])


_DECODE_ERRORS = {
    -1: "bitstream exhausted (truncated block)",
    -2: "invalid BWT key pointer",
    -3: "invalid Huffman table count",
    -4: "selector out of range",
    -5: "invalid code length",
    -6: "invalid Huffman code in payload",
    -7: "RLE2 output exceeds block size",
    -8: "zero-run bomb in RLE2 stream",
    -9: "RLE1 expansion exceeds output capacity",
    -10: "ran out of selectors before EOB",
}


def decode_block_native(data: np.ndarray, start_bit: int, level: int):
    """Decode one block starting right after its 48-bit magic: (raw bytes
    ndarray, end_bit, the block CRC the stream stores, the CRC computed).
    Raises ValueError on a corrupt block. ``data`` is the whole stream,
    contiguous uint8.

    The first attempt uses a 2x buffer and only a block that overflows it
    retries at the RLE1 worst case (52x), so many decodes in flight do not
    each touch a 46 MB buffer."""
    end_bit = np.zeros(1, dtype=np.int64)
    blk_crc = np.zeros(1, dtype=np.uint32)
    comp_crc = np.zeros(1, dtype=np.uint32)
    lib = get_lib()
    rc = -9
    for cap in (level * 100_000 * 2 + 65536, level * 100_000 * 52 + 1024):
        out = np.empty(cap, dtype=np.uint8)
        rc = lib.tpubz_decode_block(data.ctypes.data, data.size * 8, start_bit, level,
                                    out.ctypes.data, cap, end_bit.ctypes.data,
                                    blk_crc.ctypes.data, comp_crc.ctypes.data)
        if rc != -9:
            break
    if rc < 0:
        raise ValueError(_DECODE_ERRORS.get(int(rc), f"block decode failed ({rc})"))
    return out[:rc].copy(), int(end_bit[0]), int(blk_crc[0]), int(comp_crc[0])


def find_magic_native(data: np.ndarray, magic: int) -> np.ndarray:
    """Every bit offset of the 48-bit magic in data."""
    cap = max(1024, data.size // 1000)
    while True:
        out = np.zeros(cap, dtype=np.int64)
        n = get_lib().tpubz_find_magic(data.ctypes.data, data.size, magic,
                                       out.ctypes.data, cap)
        if n < cap:
            return out[:n]
        cap *= 8


def _find_magic2_range(data: np.ndarray, magic1: int, magic2: int):
    cap = max(1024, data.size // 1000)
    while True:
        out1 = np.zeros(cap, dtype=np.int64)
        out2 = np.zeros(cap, dtype=np.int64)
        n1 = np.zeros(1, dtype=np.int64)
        n2 = np.zeros(1, dtype=np.int64)
        get_lib().tpubz_find_magic2(data.ctypes.data, data.size, magic1, magic2,
                                    out1.ctypes.data, cap, n1.ctypes.data,
                                    out2.ctypes.data, cap, n2.ctypes.data)
        if n1[0] <= cap and n2[0] <= cap:
            return out1[: int(n1[0])], out2[: int(n2[0])]
        cap *= 8


_CHUNK = 1 << 21  # bytes per scan chunk of find_magic2_native


def find_magic2_native(data: np.ndarray, magic1: int, magic2: int):
    """Bit offsets of two 48-bit magics in one pass: (offsets1, offsets2).

    Large inputs scan in chunks on threads (the scan releases the GIL):
    each chunk covers [s, e) plus a 7-byte overlap, so a window across the
    boundary belongs to the left chunk, and each chunk keeps its hits below
    e - s; the lists join in order with no duplicates."""
    n = data.size
    if n <= _CHUNK + (_CHUNK >> 2):
        return _find_magic2_range(data, magic1, magic2)
    from concurrent.futures import ThreadPoolExecutor

    def one(s):
        e = min(s + _CHUNK, n)
        h1, h2 = _find_magic2_range(data[s: min(e + 7, n)], magic1, magic2)
        lim = 8 * (e - s)
        return h1[h1 < lim] + 8 * s, h2[h2 < lim] + 8 * s

    starts = list(range(0, n, _CHUNK))
    with ThreadPoolExecutor(min(8, len(starts))) as ex:
        parts = list(ex.map(one, starts))
    return np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts])

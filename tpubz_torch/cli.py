"""bzip2-compatible command line of the port: ``python -m tpubz_torch``.

The counterpart of ``tpubz/cli.py``, with its flags, parsed by
``tpubz.cli.parse_args``, and its file semantics (delete inputs on success
unless -k, refuse to overwrite without -f, -t decodes and checks CRCs,
invoked-as bunzip2/bzcat, stdin to stdout when no file is named). Encoding
runs on the port's scheduler with device blocks on the device given to
``run`` ("cuda" from ``main``); ``--host-engine`` runs tpubz's native CPU
engine alone. Decoding is tpubz's host decoder. ``--profile=DIR`` writes a
``torch.profiler`` trace.
"""
from __future__ import annotations

import os
import sys

from tpubz.cli import _decompress_fn, _log, _setup_logging, parse_args

PROG = "tpubz_torch"


def run(argv: list[str], prog: str = PROG, *, device="cuda") -> int:
    o = parse_args(argv, prog)
    _setup_logging(o)
    dev = None if o.engine == "host" else device
    if o.profile:
        from .stream.api import profiled

        with profiled(o.profile, dev or "cpu"):
            return _run(o, dev)
    return _run(o, dev)


def _refuse(out_name: str) -> None:
    print(f"{PROG}: output file {out_name} already exists (use -f to overwrite)",
          file=sys.stderr)


def _run(o, dev) -> int:
    """tpubz's ``_run`` with the port's encoders: ``dev`` None means the CPU
    engine alone."""
    from .stream import api
    from .stream.files import compress_file, compress_stream, decompress_file, decompress_stream

    if o.iterations is not None:
        from tpubz.format.constants import set_huffman_iters

        set_huffman_iters(o.iterations)
    decompress = _decompress_fn(o.trace_bits) if o.mode in ("unzip", "test") else None

    def compress(data: bytes) -> bytes:
        if dev is None:
            return api.compress_cpu(data, o.level)
        return api.compress(data, o.level, device=dev)

    if not o.files:
        # stdin/stdout on the bounded-memory streaming paths
        if o.mode == "zip":
            compress_stream(sys.stdin.buffer, sys.stdout.buffer, o.level, device=dev)
        elif o.mode == "unzip":
            if o.trace_bits:
                # the traced scalar decoder needs the whole buffer
                sys.stdout.buffer.write(decompress(sys.stdin.buffer.read()))
            else:
                decompress_stream(sys.stdin.buffer, sys.stdout.buffer)
        else:
            decompress(sys.stdin.buffer.read())
            _log(o, 1, "stdin: ok")
        return 0

    rc = 0
    for fname in o.files:
        try:
            if (
                o.mode in ("zip", "unzip")
                and not o.stdout
                and not (o.trace_bits and o.mode == "unzip")
            ):
                # streaming paths: bounded memory for files of any size
                if o.mode == "zip":
                    out_name = fname + ".bz2"
                else:
                    out_name = fname[:-4] if fname.endswith(".bz2") else fname + ".out"
                if os.path.exists(out_name) and not o.force:
                    _refuse(out_name)
                    rc = 1
                    continue
                try:
                    if o.mode == "zip":
                        compress_file(fname, out_name, o.level, device=dev)
                    else:
                        decompress_file(fname, out_name)
                except BaseException:
                    # no partial output on failure, as C bzip2
                    try:
                        os.unlink(out_name)
                    except OSError:
                        pass
                    raise
                _log(o, 1, f"{fname} -> {out_name}")
                if not o.keep:
                    os.unlink(fname)
                continue
            with open(fname, "rb") as f:
                data = f.read()
            if o.mode == "zip":
                out = compress(data)
                out_name = fname + ".bz2"
            elif o.mode == "unzip":
                out = decompress(data)
                out_name = fname[:-4] if fname.endswith(".bz2") else fname + ".out"
            else:
                decompress(data)
                _log(o, 1, f"{fname}: ok")
                continue
            if o.stdout:
                sys.stdout.buffer.write(out)
            else:
                if os.path.exists(out_name) and not o.force:
                    _refuse(out_name)
                    rc = 1
                    continue
                with open(out_name, "wb") as f:
                    f.write(out)
                _log(o, 1, f"{fname} -> {out_name}")
                if not o.keep:
                    os.unlink(fname)
        except FileNotFoundError:
            print(f"{PROG}: can't open {fname}", file=sys.stderr)
            rc = 1
        except (ValueError, EOFError) as e:
            print(f"{PROG}: {fname}: {e}", file=sys.stderr)
            rc = 2
    return rc


def main():
    raise SystemExit(run(sys.argv[1:], sys.argv[0], device="cuda"))


if __name__ == "__main__":
    main()

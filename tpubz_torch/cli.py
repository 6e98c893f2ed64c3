"""bzip2-compatible command line of the port: ``python -m tpubz_torch``.

The counterpart of ``tpubz/cli.py``: its flags (combined short flags,
``-1..-9``, ``--fast``/``--best``, bunzip2/tpunzip and bzcat/tpcat by the
program name, stdin to stdout when no file is named) and C bzip2's file
semantics (inputs deleted on success unless -k, no overwrite without -f, -t
decodes and checks the CRCs). Encoding runs on the port's scheduler with
device blocks on the device given to ``run`` ("cuda" from ``main``);
``--host-engine`` runs the native CPU engine alone. Decoding is the port's
host decoder; with ``--trace-bits`` the scalar decoder
(``hostref/stream.py``) decodes the whole buffer and logs the bit position
of every header field and symbol. ``--profile=DIR`` writes a
``torch.profiler`` trace; ``--iterations=N`` sets the port's Huffman
refinement count.
"""
from __future__ import annotations

import logging
import os
import sys

PROG = "tpubz_torch"
VERSION = "0.1.0"
LICENSE = f"""{PROG} — the bzip2 codec of tpubz on PyTorch and CUDA.
Implements the bzip2 stream format of Julian Seward's bzip2.
This software is provided as-is, without warranty."""

HELP = f"""usage: {PROG} [flags and input files in any order]

   -h --help           print this message
   -d --decompress     force decompression
   -z --compress       force compression
   -k --keep           keep (don't delete) input files
   -f --force          overwrite existing output files
   -t --test           test compressed file integrity
   -c --stdout         output to standard out
   -q --quiet          suppress noncritical error messages
   -v --verbose        be verbose (a 2nd -v gives more)
   -L --license        display software version & license
   -V --version        display software version & license
   -s --small          accepted; the same engine runs
   -1 .. -9            set block size to 100k .. 900k
   --fast              alias for -1
   --best              alias for -9
   --iterations=N      Huffman refinement passes (default 8, min 4;
                       more passes can only shrink output)
   --workfactor=N      accepted (0-250) for bzip2's flag surface; unused
   --host-engine       compress on the native CPU engine alone
   --device-engine     compress with device blocks (the default)
   --profile=DIR       write a torch.profiler trace of the run to DIR
   --trace-bits        decode through the scalar reference decoder with
                       a bit-position log line for every header field
                       and decoded symbol (format debugging)

   If invoked as `bunzip2' or `tpunzip', default action is to decompress.
              as `bzcat' or `tpcat', default action is to decompress to stdout.

   If no file names are given, {PROG} compresses or decompresses
   from standard input to standard output. You can combine
   short flags, so `-v -4' means the same as -v4 or -4v, &c."""


class Opts:
    def __init__(self):
        self.mode = "zip"  # zip | unzip | test
        self.level = 9
        self.keep = False
        self.force = False
        self.stdout = False
        self.quiet = False
        self.small = False
        self.verbosity = 0
        self.files: list[str] = []
        self.engine = "device"  # device | host
        self.iterations: int | None = None
        self.profile: str | None = None
        self.trace_bits = False
        self.workfactor: int | None = None  # parsed, unused


_LONG_FLAGS = {
    "--help": "h", "--decompress": "d", "--compress": "z", "--keep": "k",
    "--force": "f", "--test": "t", "--stdout": "c", "--quiet": "q",
    "--verbose": "v", "--license": "L", "--version": "V", "--small": "s",
    "--fast": "1", "--best": "9",
}


def _int_value(arg: str) -> int:
    try:
        return int(arg.split("=", 1)[1])
    except ValueError:
        raise SystemExit(f"{PROG}: bad value in {arg} (see --help)") from None


def parse_args(argv: list[str], prog: str = PROG) -> Opts:
    o = Opts()
    base = os.path.basename(prog)
    if base.startswith(("bunzip2", "tpunzip")):
        o.mode = "unzip"
    elif base.startswith(("bzcat", "tpcat")):
        o.mode = "unzip"
        o.stdout = True

    def short(ch: str):
        if ch == "h":
            print(HELP)
            raise SystemExit(0)
        if ch in "LV":
            print(f"{PROG} {VERSION}\n{LICENSE}")
            raise SystemExit(0)
        if ch in "123456789":
            o.level = int(ch)
            return
        switches = {"d": ("mode", "unzip"), "z": ("mode", "zip"), "t": ("mode", "test"),
                    "k": ("keep", True), "f": ("force", True), "c": ("stdout", True),
                    "q": ("quiet", True), "s": ("small", True)}
        if ch == "v":
            o.verbosity += 1
        elif ch in switches:
            setattr(o, *switches[ch])
        else:
            raise SystemExit(f"{PROG}: bad flag -{ch} (see --help)")

    for arg in argv:
        if arg.startswith("--"):
            if arg.startswith("--iterations="):
                o.iterations = _int_value(arg)
            elif arg.startswith("--profile="):
                o.profile = arg.split("=", 1)[1]
            elif arg == "--trace-bits":
                o.trace_bits = True
            elif arg.startswith("--workfactor="):
                o.workfactor = _int_value(arg)
                if not 0 <= o.workfactor <= 250:
                    raise SystemExit(f"{PROG}: workfactor must be 0..250 (see --help)")
            elif arg == "--host-engine":
                o.engine = "host"
            elif arg == "--device-engine":
                o.engine = "device"
            elif arg in _LONG_FLAGS:
                short(_LONG_FLAGS[arg])
            else:
                raise SystemExit(f"{PROG}: bad flag {arg} (see --help)")
        elif arg.startswith("-") and len(arg) > 1:
            for ch in arg[1:]:
                short(ch)
        else:
            o.files.append(arg)
    return o


def _log(o: Opts, level: int, msg: str) -> None:
    if o.verbosity >= level and not o.quiet:
        print(msg, file=sys.stderr)


def _setup_logging(o: Opts) -> None:
    """-v..-vvvvv map to log levels of the ``tpubz_torch`` logger;
    --trace-bits sets DEBUG."""
    level = (
        logging.DEBUG if o.trace_bits
        else logging.ERROR if o.verbosity == 0 or o.quiet
        else logging.WARNING if o.verbosity == 1
        else logging.INFO if o.verbosity in (2, 3)
        else logging.DEBUG
    )
    logging.basicConfig(stream=sys.stderr, level=level, format=f"{PROG}: %(message)s")
    logging.getLogger("tpubz_torch").setLevel(level)


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
    """The files or stdin through the port's codecs: ``dev`` None means the
    CPU engine alone."""
    from .format.constants import set_huffman_iters
    from .stream import api
    from .stream.files import compress_file, compress_stream, decompress_file, decompress_stream

    if o.iterations is not None:
        set_huffman_iters(o.iterations)
    if o.trace_bits:
        from .hostref.stream import decompress as scalar

        def decompress(data: bytes) -> bytes:
            return scalar(data, trace=True)
    else:
        from .stream.decode import decompress
    # the traced scalar decoder takes the whole buffer, so the streaming
    # decode paths stay out of its way; compression keeps them
    stream_unzip = o.mode == "unzip" and not o.trace_bits

    def compress(data: bytes) -> bytes:
        if dev is None:
            return api.compress_cpu(data, o.level)
        return api.compress(data, o.level, device=dev)

    if not o.files:
        # stdin/stdout on the bounded-memory streaming paths
        if o.mode == "zip":
            compress_stream(sys.stdin.buffer, sys.stdout.buffer, o.level, device=dev)
        elif stream_unzip:
            decompress_stream(sys.stdin.buffer, sys.stdout.buffer)
        elif o.mode == "unzip":
            sys.stdout.buffer.write(decompress(sys.stdin.buffer.read()))
        else:
            decompress(sys.stdin.buffer.read())
            _log(o, 1, "stdin: ok")
        return 0

    rc = 0
    for fname in o.files:
        try:
            if (o.mode == "zip" or stream_unzip) and not o.stdout:
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

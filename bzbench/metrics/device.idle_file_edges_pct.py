"""device.idle_file_edges_pct: the share of the traced span in which the
card is idle, no ``dispatch`` span is open, and the caller is in a file's
``stream.setup``, ``stream.fill`` or ``stream.finish`` or between files (no
``stream`` span open), in % (``bzbench/spans.py:idle_split``)."""
from bzbench import spans


def read(run):
    shares = spans.idle_shares(run)
    return None if shares is None else shares["file_edges"]

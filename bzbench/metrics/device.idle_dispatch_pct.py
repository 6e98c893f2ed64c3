"""device.idle_dispatch_pct: the share of the traced span in which the card
is idle while a ``dispatch`` span is open (the dispatcher's host work holds
the next block back), in % (``bzbench/spans.py:idle_split``)."""
from bzbench import spans


def read(run):
    shares = spans.idle_shares(run)
    return None if shares is None else shares["dispatch"]

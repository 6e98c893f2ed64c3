"""stream.setup_ms: the median over the window's files of the port's
``stream.setup`` span (a ``compress`` call's entry to its first request for
a block: the device, the RLE1 feed's start, the settings, the routing
profile, the pools), in ms."""
from bzbench import spans


def read(run):
    return spans.median_ms(spans.ms(s) for s in spans.named(run, "stream.setup"))

"""stream.finish_ms: the median over the window's files of the port's
``stream.finish`` span (the caller's request after the last block to the
call's return: the routing profile's update, the pools' shutdown, the
footer), in ms."""
from bzbench import spans


def read(run):
    return spans.median_ms(spans.ms(s) for s in spans.named(run, "stream.finish"))

"""dispatch.launch_ms: the mean over the window's device blocks of the
``dispatch`` span's self time (the span less its upload and copies: the
BWT library call and the MTF and RLE2 enqueues), in ms."""
from bzbench import spans


def read(run):
    return spans.mean_ms(spans.self_ms(run, "dispatch"))

"""stream.fill_ms: the median over the window's files of each file's summed
``stream.fill`` spans (the caller's waits for the next block from the RLE1
scan), in ms."""
from bzbench import spans


def read(run):
    return spans.median_ms(spans.per_stream_ms(run, "stream.fill"))

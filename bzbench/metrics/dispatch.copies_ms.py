"""dispatch.copies_ms: the mean over the window's device blocks of the
``dispatch.copies`` span (``fetch_async``: the small vector, the pinned
buffers, the two copies and the event enqueued), in ms."""
from bzbench import spans


def read(run):
    return spans.mean_ms(spans.ms(s) for s in spans.named(run, "dispatch.copies"))

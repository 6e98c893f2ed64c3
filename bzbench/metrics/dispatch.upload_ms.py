"""dispatch.upload_ms: the mean over the window's device blocks of the
``dispatch.upload`` span (``DeviceBlockEncoder.upload``: the padded block's
allocation and its copy to the card), in ms."""
from bzbench import spans


def read(run):
    return spans.mean_ms(spans.ms(s) for s in spans.named(run, "dispatch.upload"))

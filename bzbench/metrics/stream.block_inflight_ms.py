"""stream.block_inflight_ms: the median over the window's device blocks of
dispatch to emitted, as the stream scheduler records them
(``tpubz_torch.stream.api.last_stream_events``), in ms."""
import statistics


def read(run):
    if not run.blocks:
        return None
    return 1000.0 * statistics.median(b - a for a, b in run.blocks)

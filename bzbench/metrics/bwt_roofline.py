"""bwt_roofline: the least time of a BWT call over its device time, in %.
The least time counts what any algorithm needs: the block's n bytes read,
its n-byte last column and 8-byte key written, over the card's HBM
bandwidth, by the mean block of the window (``bwt_forward_async``'s n,
wrapped). The device time is the mean call's span in the profiler's
timeline of the traced files, from its ``bwt_setup`` kernel to its
``bwt_last_column`` kernel, its graph's rounds between them."""
from bzbench.peaks import HBM_BYTES_PER_S


def read(run):
    peak = HBM_BYTES_PER_S.get(run.device_kind)
    if run.probe is None or peak is None or run.timeline is None:
        return None
    n = run.probe.mean_size("bwt")
    secs, calls = run.timeline.bwt_s(*run.traced_span)
    if n is None or not calls or secs <= 0:
        return None
    return 100.0 * ((2 * n + 8) / peak) / (secs / calls)

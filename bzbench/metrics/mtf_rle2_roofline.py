"""mtf_rle2_roofline: the least time of MTF and RLE2 on the card over their
device time, in %. The least time: a block's n bytes of last column read, 2
bytes a RLE2 symbol and 258 four-byte frequencies written, over the card's
HBM bandwidth, by the mean block of the window (``bwt_forward_async``'s n
and ``emit_block``'s RLE2 length, wrapped). The device time: the
kernels of ``mtf_ranks`` (``mtf_group_last``, ``mtf_group_prefix``,
``mtf_chunk_ranks``) and of ``rle2_encode_used`` (``rle2_onepass``) in the
profiler's timeline of the traced files, a block's share of it by the
``rle2_onepass`` launches. Nothing to read on the bwt stage."""
from bzbench.peaks import HBM_BYTES_PER_S

KERNELS = ("mtf_group_last", "mtf_group_prefix", "mtf_chunk_ranks", "rle2_onepass")


def read(run):
    peak = HBM_BYTES_PER_S.get(run.device_kind)
    if run.probe is None or peak is None or run.timeline is None:
        return None
    n, syms = run.probe.mean_size("bwt"), run.probe.mean_size("emit")
    secs, launches = run.timeline.kernel_s(*run.traced_span, KERNELS)
    if n is None or syms is None or not launches["rle2_onepass"] or secs <= 0:
        return None
    block_bytes = n + 2 * syms + 258 * 4
    return 100.0 * (block_bytes / peak) / (secs / launches["rle2_onepass"])

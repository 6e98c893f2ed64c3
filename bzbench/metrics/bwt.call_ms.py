"""bwt.call_ms: the mean over the window's BWT calls of their time on the
card, as the card's clock gave it (``%globaltimer`` at the start of
``bwt_setup`` and at the end of ``bwt_last_column``, the ``fetch.wait``
span's ``bwt_device_ns``), in ms: every call of the window, where the
profiler's BWT spans cover about a second."""
from bzbench import spans


def read(run):
    ns = [s.attrs.get("bwt_device_ns") for s in spans.named(run, "fetch.wait")]
    return spans.mean_ms(v * 1e-6 for v in ns if v)

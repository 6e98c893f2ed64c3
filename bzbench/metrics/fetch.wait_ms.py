"""fetch.wait_ms: the mean over the window's device blocks of the
``fetch.wait`` span (a fetch thread's wait on the block's copy event and
its BWT call's finish), in ms."""
from bzbench import spans


def read(run):
    return spans.mean_ms(spans.ms(s) for s in spans.named(run, "fetch.wait"))

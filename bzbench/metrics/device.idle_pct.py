"""device.idle_pct: the share of the traced window (a few whole files, the
gaps between them included) that lies outside every kernel, copy and set
interval of ``torch.profiler``'s timeline and every BWT call's span, in %."""


def read(run):
    if not run.busy_s or not run.traced_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_s)

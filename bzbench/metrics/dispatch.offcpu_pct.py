"""dispatch.offcpu_pct: 100 x (1 - the dispatcher thread's CPU time over
its wall time), summed over the window's ``dispatch`` spans: the share of
the dispatcher's time spent off the CPU (waiting for the interpreter lock,
blocked in the driver, or descheduled), in %."""
from bzbench import spans


def read(run):
    ds = spans.named(run, "dispatch")
    wall = sum(s.end_ns - s.start_ns for s in ds)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(s.cpu_ns for s in ds) / wall)

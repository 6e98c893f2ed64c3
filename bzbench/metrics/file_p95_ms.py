"""file_p95_ms: the 95th percentile (nearest rank) of the wall time of every
file in the window, from the call to the returned bytes (host clock). In a
traced run the files that overlap the profiler's sessions
(``run.profiled``, their reading included) are left out: a session slows
the host while it records and is read, and its few files would sit in the
tail."""
import math


def read(run):
    lo, hi = run.profiled or (math.inf, -math.inf)
    times = sorted(f[2] - f[1] for f in run.files if f[2] < lo or f[1] > hi)
    if not times:
        return None
    return 1000.0 * times[math.ceil(0.95 * len(times)) - 1]

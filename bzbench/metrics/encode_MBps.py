"""encode_MBps: input bytes of every file finished in the window, over the
window's whole time (host clock), in MB (10^6 bytes) a second."""


def read(run):
    done = sum(f[3] for f in run.files if f[4])
    return done / run.window_s / 1e6 if run.window_s > 0 and done else None

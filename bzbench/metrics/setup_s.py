"""setup_s: the process's first statement to the window's start (host
clock): imports, the libraries' load (their build on a checkout's first
run), the pool of files and the warm-up file."""


def read(run):
    return run.setup_s

"""tpubz's native library for the port's tests that compare with it.

``tpubz.native`` builds its library in place at first use, and its build is
not locked: every test worker of a fresh checkout runs g++ onto the same
file. A worker whose ctypes load meets a half-written library marks the
library failed for good, and ``get_lib()`` returns None from then on. The
fixture ``tpubz_native`` takes a file lock under the pytest temporary root
(shared by the workers of one run), waits for the concurrent build to
finish by loading again until a load succeeds, with ``_LIB`` and
``_LIB_FAILED`` reset through a monkeypatch, and fails with a clear message
only when no load under the lock succeeds. The fixture is session-scoped
and its monkeypatch is undone only when the session ends, so a recovered
library stays loaded for every later test of the worker, those that reach
``tpubz.native`` without the fixture included. ``tpubz/`` is not edited.

    from torch_native_guard import tpubz_native  # noqa: F401 (a fixture)
"""
import fcntl
import time

import pytest

from tpubz import native as tnative

# g++ builds the library in seconds; a load still failing after this long
# under the lock is not a race
WAIT_S = 180.0
POLL_S = 0.5


def load_tpubz_native(lock_path, monkeypatch, wait_s=WAIT_S, poll_s=POLL_S):
    """tpubz.native with its library loaded, or pytest.fail."""
    if tnative.get_lib() is not None:
        return tnative
    with open(lock_path, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        deadline = time.monotonic() + wait_s
        while True:
            monkeypatch.setattr(tnative, "_LIB", None)
            monkeypatch.setattr(tnative, "_LIB_FAILED", False)
            if tnative.get_lib() is not None:
                return tnative
            if time.monotonic() >= deadline:
                pytest.fail(f"tpubz.native's library did not load under {lock_path} "
                            f"within {wait_s} s: g++ failed or the library is broken")
            time.sleep(poll_s)


@pytest.fixture(scope="session")
def tpubz_native(tmp_path_factory):
    """tpubz.native, its library loaded for the rest of the session (see
    the module's doc)."""
    root = tmp_path_factory.getbasetemp().parent  # shared by the workers of a run
    with pytest.MonkeyPatch.context() as monkeypatch:
        yield load_tpubz_native(root / "tpubz_native.lock", monkeypatch)

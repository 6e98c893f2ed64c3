"""The port's measured routing profile.

The counterpart of ``tpubz/stream/rigprofile.py``: the stream scheduler
trains it at the end of every device stream and reads it at the start of
the next. The fields and their EMA folding are tpubz's (``cpu_block_s``,
and per stage ``dev_cadence_s`` and ``host_leg_s``); so is the model that
picks a stage from them, ``choose_stage``, imported unchanged.

The file describes this host and its card, so it lives apart from tpubz's
TPU-rig profile: ``$TPUBZ_TORCH_CACHE/tpubz_torch_rig_profile.json``, the
directory defaulting to ``~/.cache/tpubz_torch``. tpubz's profile under
``TPUBZ_JAX_CACHE`` is never read or written here. An unwritable directory
costs only the training.
"""
from __future__ import annotations

import json
import os
import threading
import time

from tpubz.stream.rigprofile import _EMA, choose_stage  # noqa: F401 (re-exported)

_LOCK = threading.Lock()
_CACHE: dict | None = None


def path() -> str:
    cache_dir = os.environ.get("TPUBZ_TORCH_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "tpubz_torch"
    )
    return os.path.join(cache_dir, "tpubz_torch_rig_profile.json")


def _read() -> dict:
    try:
        with open(path()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def load() -> dict:
    """The persisted profile (memoized; {} when none exists yet)."""
    global _CACHE
    with _LOCK:
        if _CACHE is None:
            _CACHE = _read()
        return dict(_CACHE)


def _fold(dst: dict, src: dict) -> None:
    """EMA of each positive leaf into dst; a sample 5x away from the stored
    value is a new operating point and moves it at weight 0.7."""
    for k, v in src.items():
        if isinstance(v, dict):
            _fold(dst.setdefault(k, {}), v)
        elif v and v > 0:
            old = dst.get(k)
            if not isinstance(old, (int, float)) or old <= 0:
                dst[k] = v
            else:
                w = _EMA if old / 5 <= v <= old * 5 else 0.7
                dst[k] = (1 - w) * old + w * v


def update(**samples: float | dict) -> None:
    """Fold fresh measurements into the profile and persist it."""
    global _CACHE
    with _LOCK:
        if _CACHE is None:
            _CACHE = _read()
        _fold(_CACHE, samples)
        _CACHE["updated_at"] = time.time()
        target = path()
        try:
            os.makedirs(os.path.dirname(target), exist_ok=True)
            tmp = target + ".tmp"
            with open(tmp, "w") as f:
                json.dump(_CACHE, f)
            os.replace(tmp, target)
        except OSError:
            pass


def reset_memo() -> None:
    """Drop the in-process memo (tests; a new TPUBZ_TORCH_CACHE)."""
    global _CACHE
    with _LOCK:
        _CACHE = None

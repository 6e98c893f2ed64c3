"""The port's measured routing profile.

The counterpart of ``tpubz/stream/rigprofile.py``: the stream scheduler
trains it at the end of every device stream and reads it at the start of
the next. Its fields are ``cpu_block_s`` (one native CPU block), and per
stage ``dev_cadence_s`` (the device's pipelined cadence per block) and
``host_leg_s`` (the host work a device block still costs), each folded in
as an EMA; ``choose_stage`` picks a stage from them.

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

_EMA = 0.3  # update weight: recent streams dominate, one outlier does not

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


def choose_stage(profile: dict, workers: int, eff_cores: int) -> str | None:
    """The device stage ("bwt" or "full") the measurements favour, or None
    until both stages have a cadence and a host leg.

    A route sustains rate_r = min(1/c_r, C/h_r) blocks/s, with c_r its
    device cadence, h_r the host seconds it still costs per device block
    and C the usable cores: a busy host caps the route at C/h_r however
    fast the card is. With a CPU pool, the cores left over run whole CPU
    blocks of H seconds each:

        total_r = rate_r + max(0, C - h_r * rate_r) / H     [blocks/s]

    A fast host favours "bwt" (a short host leg, a faster device stage); a
    busy host favours "full", which moves MTF and RLE2 onto the card.
    """
    cad = profile.get("dev_cadence_s", {})
    leg = profile.get("host_leg_s", {})
    H = profile.get("cpu_block_s")
    routes = [s for s in ("bwt", "full") if cad.get(s) and leg.get(s) is not None]
    if len(routes) < 2:
        return None
    C = max(1, eff_cores)

    def score(s: str) -> float:
        c, h = float(cad[s]), float(leg.get(s) or 0.0)
        rate = min(1.0 / c, C / h) if h > 0 else 1.0 / c
        if workers > 0 and H:
            return rate + max(0.0, C - h * rate) / float(H)
        return rate

    return max(routes, key=score)

"""Logging / debug-dump tier (the av_log analog).

The reference routes all diagnostics through ``av_log`` with per-object
class names and levels (libavutil/log.c), plus debug dump classes gated
by ``FF_DEBUG_*`` flags (e.g. ``FF_DEBUG_PICT_INFO`` dumps the parsed
global header, ffv1dec.c:620-634).  This module provides the same two
tiers for the framework:

* leveled logging: ``log(level, component, msg)`` with the standard
  quiet/error/warning/info/verbose/debug ladder, default threshold
  ``info``, override via ``FFV1_LOGLEVEL``
* debug classes: ``debug_enabled(cls)`` gates expensive dumps; enable
  with a comma list in ``FFV1_DEBUG`` (e.g. ``FFV1_DEBUG=timing,pict``).
  ``timing`` is used by the device pipeline to print per-phase stage times
  (the -benchmark_all analog, ffmpeg.c:611-622).

Kept dependency-free and cheap when disabled (one dict lookup).
"""
from __future__ import annotations

import os
import sys
import time

QUIET, ERROR, WARNING, INFO, VERBOSE, DEBUG = -8, 16, 24, 32, 40, 48

_NAMES = {"quiet": QUIET, "error": ERROR, "warning": WARNING,
          "info": INFO, "verbose": VERBOSE, "debug": DEBUG}

_level = _NAMES.get(os.environ.get("FFV1_LOGLEVEL", "info"), INFO)
_debug = {c for c in os.environ.get("FFV1_DEBUG", "").split(",") if c}


def set_level(level):
    global _level
    _level = _NAMES.get(level, level)


def log(level: int, component: str, msg: str) -> None:
    if level <= _level:
        print(f"[{component}] {msg}", file=sys.stderr, flush=True)


def debug_enabled(cls: str) -> bool:
    return cls in _debug


_phase_acc = None     # label -> [ms, ...] when accumulation is on


def collect_phases(on: bool = True) -> None:
    """Start/stop accumulating phase_timer durations (bench.py uses
    this to publish the per-phase breakdown in its JSON artifact)."""
    global _phase_acc
    _phase_acc = {} if on else None


def phase_stats() -> dict:
    """{label: {n, median_ms, total_ms}} for the current accumulation."""
    out = {}
    for k, v in (_phase_acc or {}).items():
        s = sorted(v)
        out[k] = dict(n=len(v), median_ms=round(s[len(s) // 2], 1),
                      total_ms=round(sum(v), 1))
    return out


class phase_timer:
    """Context manager that logs ``<label>: N ms`` when the ``timing``
    debug class is enabled and/or accumulates for phase_stats();
    zero overhead otherwise."""

    __slots__ = ("component", "label", "t0")

    def __init__(self, component: str, label: str):
        self.component = component
        self.label = label

    def __enter__(self):
        self.t0 = time.time() if ("timing" in _debug or
                                  _phase_acc is not None) else None
        return self

    def __exit__(self, *exc):
        if self.t0 is not None:
            ms = (time.time() - self.t0) * 1000
            if "timing" in _debug:
                log(INFO, self.component, f"{self.label}: {ms:.0f} ms")
            if _phase_acc is not None:
                _phase_acc.setdefault(
                    f"{self.component}.{self.label}", []).append(ms)
        return False

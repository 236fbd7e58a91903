"""Optional ``torch.profiler`` hooks, gated by the ``PROFILE_DIR`` config key.

The span tracer times HOST stages (queue/pack/device-wait/collect); what it
cannot see is where the device time itself goes.  When a profile directory
is configured (``obs.configure(profile_dir=...)``), wave launches are
bracketed with ``torch.profiler.record_function`` so each serve wave shows
up as one named range in the captured trace, and :func:`start`/:func:`stop`
drive the capture itself (CPU activity, plus CUDA activity when a card is
present); :func:`stop` writes a Chrome trace into the directory.

Everything here is a no-op when no directory is configured, and a refused
capture returns False instead of raising: observability must never be the
thing that crashes serving.
"""
from __future__ import annotations

import contextlib
import os
from typing import Optional

# process-global profile directory; None = all hooks are no-ops
_PROFILE_DIR: Optional[str] = None
_PROF = None
_N_TRACES = 0


def configure(profile_dir: Optional[str]) -> None:
    global _PROFILE_DIR
    _PROFILE_DIR = profile_dir


def profile_dir() -> Optional[str]:
    return _PROFILE_DIR


def active() -> bool:
    """True while a device trace capture is running."""
    return _PROF is not None


def start() -> bool:
    """Begin a trace capture into the configured directory.  Returns False
    (no-op) when unconfigured, already active, or refused by the profiler."""
    global _PROF
    if _PROFILE_DIR is None or _PROF is not None:
        return False
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except RuntimeError:
        return False
    _PROF = prof
    return True


def stop() -> bool:
    """End the capture and write ``trace_<pid>_<n>.json`` (Chrome format)
    into the profile directory."""
    global _PROF, _N_TRACES
    if _PROF is None:
        return False
    prof, _PROF = _PROF, None
    try:
        prof.stop()
        os.makedirs(_PROFILE_DIR, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            _PROFILE_DIR, f"trace_{os.getpid()}_{_N_TRACES}.json"))
    except (RuntimeError, OSError):
        return False
    _N_TRACES += 1
    return True


def step(name: str, num: int):
    """Context manager bracketing one wave launch as a profiler range.

    ``with profiler.step("serve_wave", seq): dec = evaluate(...)`` — shows
    up as ``serve_wave#<seq>`` in the captured trace.  Returns a
    nullcontext unless a profile directory is configured (the hot path
    pays one global read).
    """
    if _PROFILE_DIR is None:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(f"{name}#{num}")

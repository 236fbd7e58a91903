"""Deterministic fault injection: named failure points for the robustness gate.

Production code marks its failure points with ``faults.fire("site.name")``
— a no-op unless a test has armed that site.  Tests arm a site with a hit
index, run the workload, and observe the recovery path:

    from repro_torch.testing import faults

    faults.reset()
    faults.arm("engine.swap")                       # fire on the 1st hit
    with pytest.raises(faults.InjectedFault):
        engine.swap_bank(new_bank)
    faults.reset()

Semantics:

  * ``arm(site, at_hit=n)`` — the site raises :class:`InjectedFault` on the
    n-th time execution reaches it (1-based), then disarms.  Arming by hit
    index is what makes "kill at EVERY wave boundary" a parametrized loop
    instead of a flaky sleep-and-signal dance;
  * ``arm(site, action=fn)`` — instead of raising, call ``fn(**ctx)`` at
    the site (still exactly once, at ``at_hit``).  Used to interleave a
    concurrent operation at a precise point — e.g. submit a batch in the
    middle of a wave dispatch;
  * :class:`InjectedFault` subclasses ``BaseException`` (like
    ``KeyboardInterrupt``), so no ``except Exception`` recovery path can
    swallow it — the workload dies as abruptly as a SIGKILL would, leaving
    whatever partial state it had built.  The point is to test recovery
    from the debris, not from a tidy unwind.

Known sites (grep ``faults.fire`` for the authoritative list):

  engine.submit                admission entry                (ctx: rows)
  engine.begin_step            wave about to dispatch
  engine.swap                  bank hot swap entry
  trainer.wave.start           a training wave begins         (ctx: wave)
  trainer.wave.solved          a wave solved, not yet saved   (ctx: wave)
  checkpoint.save.*            pre_shard, post_shard, pre_rename,
                               post_rename, post_latest       (ctx: step)
  checkpoint.restore.mid       payload read, not yet returned (ctx: step)

The registry is process-global and NOT thread-safe by design: the tier-1
fault suite is single-threaded, and a lock on the ``fire`` fast path would
tax every production call for a test-only feature.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional


class InjectedFault(BaseException):
    """Raised at an armed fault site.  BaseException on purpose: it must
    escape ``except Exception`` recovery code the way a hard kill would."""

    def __init__(self, site: str, hit: int):
        super().__init__(f"injected fault at {site!r} (hit {hit})")
        self.site = site
        self.hit = hit


@dataclasses.dataclass
class _Armed:
    at_hit: int
    action: Optional[Callable[..., Any]]


_ARMED: Dict[str, _Armed] = {}
_HITS: Dict[str, int] = {}


def reset() -> None:
    """Disarm every site and zero the hit counters."""
    _ARMED.clear()
    _HITS.clear()


def arm(site: str, at_hit: int = 1,
        action: Optional[Callable[..., Any]] = None) -> None:
    """Arm ``site`` to fire on its ``at_hit``-th visit (1-based).

    Default firing raises :class:`InjectedFault`; an ``action`` callable is
    invoked instead (with the site's context kwargs) and may itself raise.
    Each site disarms after firing once — re-arm for repeated faults.
    """
    assert at_hit >= 1, at_hit
    _ARMED[site] = _Armed(at_hit=at_hit, action=action)


def disarm(site: str) -> None:
    _ARMED.pop(site, None)


def hits(site: str) -> int:
    """How many times execution has reached ``site`` since ``reset()``.
    Counted only while at least one site is armed (zero-overhead default)."""
    return _HITS.get(site, 0)


def active() -> bool:
    return bool(_ARMED)


def fire(site: str, **ctx: Any) -> None:
    """Mark a fault point.  No-op unless something is armed."""
    if not _ARMED:
        return
    hit = _HITS.get(site, 0) + 1
    _HITS[site] = hit
    armed = _ARMED.get(site)
    if armed is None or hit != armed.at_hit:
        return
    del _ARMED[site]
    if armed.action is not None:
        armed.action(**ctx)
        return
    raise InjectedFault(site, hit)


class armed:
    """Context manager: arm on enter, full ``reset()`` on exit.

        with faults.armed("trainer.wave.start", at_hit=2):
            ...
    """

    def __init__(self, site: str, at_hit: int = 1,
                 action: Optional[Callable[..., Any]] = None):
        self._args = (site, at_hit, action)

    def __enter__(self) -> "armed":
        arm(self._args[0], self._args[1], self._args[2])
        return self

    def __exit__(self, *exc) -> None:
        reset()

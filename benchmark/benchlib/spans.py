"""The program's own spans, read over a run's window: caster_dta_torch keeps
every span of the process in a ring (utils/profiling.py ``RING``: name,
start, end and an int value, on ``time.perf_counter``'s clock, the window's
clock). Each reader returns None where the program keeps no ring (a program
older than its spans), where the ring overwrote part of the range it reads,
where the cell is of another runner, or where the range holds none of the
spans it needs."""
from __future__ import annotations

import numpy as np


def _ring():
    try:
        from caster_dta_torch.utils import profiling
    except ImportError:
        return None
    return getattr(profiling, "RING", None)


def records(ctx, runner=None, setup: bool = False):
    """(name, start s, end s, value) of the program's spans that lie in the
    window, by start, or with ``setup`` those that end before the window
    starts; None as the module says (``runner`` None: a cell of any)."""
    ring = _ring()
    if ring is None or ctx.window_t0 is None or ctx.window_t1 is None or (
            runner is not None and ctx.cell.mix["runner"] != runner):
        return None
    lo, hi = (None, ctx.window_t0) if setup else (ctx.window_t0, ctx.window_t1)
    if ring.lost(lo):
        return None
    return ring.records(lo, hi)


def mean_ms(spans, name: str):
    """Mean milliseconds of the spans called ``name``."""
    d = [e - s for n, s, e, _ in spans or () if n == name]
    return float(np.mean(d) * 1e3) if d else None


def total_s(spans, names):
    """Seconds of the spans called one of ``names``, summed."""
    d = [e - s for n, s, e, _ in spans or () if n in names]
    return float(np.sum(d)) if d else None


def values_per(spans, summed, per: str):
    """The values of the spans called one of ``summed``, summed, over the
    count of those called ``per``; None where a summed span carries no
    count (a negative value: the work ran eagerly)."""
    vals = [v for n, _, _, v in spans or () if n in summed]
    count = sum(n == per for n, *_ in spans or ())
    if not count or not vals or min(vals) < 0:
        return None
    return sum(vals) / count


def gaps_ms(spans, end: str, start: str, skip=()):
    """Mean milliseconds from each span called ``end`` to the start of the
    next span called ``start``, leaving out the gaps before the ``start``
    spans whose numbers (0: the first) ``skip`` holds."""
    gaps, last, k = [], None, -1
    for n, s, e, _ in spans or ():
        if n == end:
            last = e
        elif n == start:
            k += 1
            if last is not None and k not in skip:
                gaps.append(s - last)
            last = None
    return float(np.mean(gaps) * 1e3) if gaps else None

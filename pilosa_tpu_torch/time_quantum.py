"""Time-quantum views (ref: time.go:28-184; counterpart of
pilosa_tpu/time_quantum.py, whose logic this copies unchanged).

A frame's time quantum is a subset-string of "YMDH". Each SetBit with a
timestamp also writes one view per enabled unit (``standard_2017``,
``standard_201708``, ...); a time-range query unions the minimal set of
views covering [start, end): walk up from fine units to aligned
boundaries, then down from coarse units (ViewsByTimeRange time.go:112-184).
"""
from datetime import datetime, timedelta

VALID_UNITS = "YMDH"


def validate_quantum(q):
    q = (q or "").upper()
    if any(c not in VALID_UNITS for c in q):
        raise ValueError(f"invalid time quantum: {q}")
    # Units must be contiguous from coarse to fine, e.g. "YM", "MD", not "YD".
    if q and q not in "YMDH"[VALID_UNITS.index(q[0]):VALID_UNITS.index(q[0]) + len(q)]:
        raise ValueError(f"invalid time quantum: {q}")
    return q


def view_by_time_unit(name, t, unit):
    """standard_2006 / 200601 / 20060102 / 2006010215 (ref: time.go:83-97)."""
    if unit == "Y":
        return f"{name}_{t.year:04d}"
    if unit == "M":
        return f"{name}_{t.year:04d}{t.month:02d}"
    if unit == "D":
        return f"{name}_{t.year:04d}{t.month:02d}{t.day:02d}"
    if unit == "H":
        return f"{name}_{t.year:04d}{t.month:02d}{t.day:02d}{t.hour:02d}"
    raise ValueError(f"invalid time unit: {unit}")


def views_by_time(name, t, quantum):
    """One view per enabled unit (ref: time.go:99-110)."""
    return [view_by_time_unit(name, t, u) for u in quantum]


def _next_year(t):
    return datetime(t.year + 1, 1, 1)


def _next_month(t):
    return datetime(t.year + (t.month == 12), t.month % 12 + 1, 1)


def _next_day(t):
    return (datetime(t.year, t.month, t.day) + timedelta(days=1))


def views_by_time_range(name, start, end, quantum):
    """Minimal view cover of [start, end) (ref: time.go:112-184)."""
    has = {u: u in quantum for u in VALID_UNITS}
    t = start
    results = []

    # Walk up from smallest units until aligned with the next-larger unit.
    if has["H"] or has["D"] or has["M"]:
        while t < end:
            if has["H"]:
                if not _next_day(t) <= end:
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t += timedelta(hours=1)
                    continue
            if has["D"]:
                if not _next_month(t) <= end:
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t = _next_day(t)
                    continue
            if has["M"]:
                if not _next_year(t) <= end:
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _next_month(t)
                    continue
            break

    # Walk back down from largest to smallest.
    while t < end:
        if has["Y"] and _next_year(t) <= end:
            results.append(view_by_time_unit(name, t, "Y"))
            t = _next_year(t)
        elif has["M"] and _next_month(t) <= end:
            results.append(view_by_time_unit(name, t, "M"))
            t = _next_month(t)
        elif has["D"] and _next_day(t) <= end:
            results.append(view_by_time_unit(name, t, "D"))
            t = _next_day(t)
        elif has["H"]:
            results.append(view_by_time_unit(name, t, "H"))
            t += timedelta(hours=1)
        else:
            break

    return results

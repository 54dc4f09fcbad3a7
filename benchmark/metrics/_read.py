"""Helpers the metric readers share: fields of the run's record and of
its traced segment (``trace.reduce``); None where there is nothing to read."""

def _t(rec, key):
    t = rec.get("trace")
    return None if t is None else t.get(key)


def _ms(v):
    return None if v is None else 1e3 * v


def _idle(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _roof(rec, kernel):
    t = rec.get("trace")
    return None if t is None else t["roofline"].get(kernel)

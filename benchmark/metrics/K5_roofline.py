"""K5: the roofline bound of its calls over its device time."""

from benchmark.metrics._read import _roof


def read(rec):
    return _roof(rec, "K5")

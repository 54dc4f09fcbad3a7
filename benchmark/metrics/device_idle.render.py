"""Share of the traced segment in which no operation ran on the device."""

from benchmark.metrics._read import _idle


def read(rec):
    return _idle(rec)

"""Device kernels, copies and memsets per frame in the traced segment."""

from benchmark.metrics._read import _t


def read(rec):
    return _t(rec, "launches_per_unit")

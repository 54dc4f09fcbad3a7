"""K2 (and K2', one CUDA kernel): the roofline bound of its calls over
its device time in the traced segment, in per cent."""

from benchmark.metrics._read import _roof


def read(rec):
    return _roof(rec, "K2")

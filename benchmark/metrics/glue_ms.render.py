"""Device ms per frame outside the program's own kernels (resize products,
casts, copies, cuDNN convolutions) in the traced segment."""

from benchmark.metrics._read import _t, _ms


def read(rec):
    return _ms(_t(rec, "glue_s_per_unit"))

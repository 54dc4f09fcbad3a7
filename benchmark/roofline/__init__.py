"""One module per kernel: ``NAMES`` (substrings of its device kernels'
names) and ``bound_s(call)``, the least time the H100 could take for one
call: the larger of its operations over the peak of its inputs' type and
its bytes over the memory's rate.  Each input and output byte is counted
once, weights once; scratch that a kernel writes and reads back is not."""

ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8, "int8": 1,
         "uint8": 1}


def esize(spec) -> int:
    return ESIZE[spec["dtype"]]


def numel(spec) -> int:
    n = 1
    for s in spec["shape"]:
        n *= s
    return n

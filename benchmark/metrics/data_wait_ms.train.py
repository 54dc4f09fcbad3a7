"""The host's time to take the next batch from the device cache, mean per
step over the run's untraced window."""


def read(rec):
    return rec.get("data_wait_ms")

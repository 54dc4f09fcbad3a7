"""The host's time inside ``render_u8`` (which returns once the frame is
queued), mean per frame over the run's untraced window."""


def read(rec):
    return rec.get("host_enqueue_ms")

"""Host milliseconds a CUDA graph capture over the window, its warm-ups
included, after the drain of the steps queued before it:
``Trainer.events["capture_ms"]`` over ``events["capture"]``.  None where
the window captured nothing or the program does not time its captures."""


def read(record: dict):
    ev = record["window"]["events"]
    if not ev.get("capture") or "capture_ms" not in ev:
        return None
    return ev["capture_ms"] / ev["capture"]

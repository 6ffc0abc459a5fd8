"""Device milliseconds a graphed step in its shade stage, projection and SH
(``shade``): the window's ``stage_shade_ms`` over ``stage_samples``
(``Trainer.events``, from the stage events inside the CUDA graph).  None
where the program keeps no stage events."""


def read(record: dict):
    ev = record["window"]["events"]
    n = ev.get("stage_samples")
    if not n or "stage_shade_ms" not in ev:
        return None
    return ev["stage_shade_ms"] / n

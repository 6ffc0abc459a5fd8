"""Device milliseconds a graphed step over the window, from the program's
own stage events inside its CUDA graph (``Trainer.events``): the sum of
the ``stage_*_ms`` over ``stage_samples``, one replay sampled at each log
point.  None where the program keeps no stage events."""


def read(record: dict):
    ev = record["window"]["events"]
    n = ev.get("stage_samples")
    if not n:
        return None
    return sum(v for k, v in ev.items()
               if k.startswith("stage_") and k.endswith("_ms")) / n

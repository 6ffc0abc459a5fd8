"""Device milliseconds a graphed step from its loss mark to where the
compositing's gradient has reached the per-Gaussian attribute rows: the
loss's backward, K3 and the rows' scatter-add, a part of ``backward_ms``.
The window's ``nested_raster_bwd_ms`` over ``stage_samples``
(``Trainer.events``, from an event node inside the CUDA graph).  None
where the program keeps no such stage, or its replays recorded none."""


def read(record: dict):
    ev = record["window"]["events"]
    n = ev.get("stage_samples")
    if not n or not ev.get("nested_raster_bwd_ms"):
        return None
    return ev["nested_raster_bwd_ms"] / n

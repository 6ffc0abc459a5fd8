"""Host milliseconds a step that the training loop spends on work other
than fetching, dispatching and reading steps: the window's refine,
growth, opacity reset, log point and checkpoint spans and its captures
(``Trainer.events``: ``host_<span>_ms`` and ``capture_ms``) over its
steps.  Reads are left out: in a device-bound loop their wait is the
drain of work the device is doing.  None where the program keeps no
spans."""

STALLS = ("host_refine_ms", "host_grow_ms", "host_reset_ms", "host_log_ms",
          "host_ckpt_ms", "capture_ms")


def read(record: dict):
    w = record["window"]
    ev = w["events"]
    if not w["steps"] or not all(k in ev for k in STALLS):
        return None
    return sum(ev[k] for k in STALLS) / w["steps"]

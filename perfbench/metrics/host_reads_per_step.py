"""The training loop's waits for the device a step: every read back to the
host and every stream synchronisation in ``Trainer.run``, the refine and
the captures (``Trainer.events["host_reads"]``), over the window's steps.
None where the program does not count them."""


def read(record: dict):
    w = record["window"]
    if not w["steps"] or "host_reads" not in w["events"]:
        return None
    return w["events"]["host_reads"] / w["steps"]

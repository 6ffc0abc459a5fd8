"""Device milliseconds a step: the device time of every operation the
profiler saw over the profiled period after the window, over its steps."""


def read(record: dict):
    steps = record.get("profiled_steps")
    if not steps:
        return None
    return 1e3 * sum(record["device_s"].values()) / steps

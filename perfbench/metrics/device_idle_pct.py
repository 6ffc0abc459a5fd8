"""The device's idle share of the measured window, which runs without the
profiler: 1 − (device seconds a step, from the profiled period after the
window, × the window's steps ÷ the window's wall seconds), in percent.
Sound where every step of the window does the work of the profiled one
(the polish cells replay one graph on one state); the profiler's own gaps
are outside the window.  Clock noise between the two periods can take it
a little under 0 where the device is never idle."""


def read(record: dict):
    steps = record.get("profiled_steps")
    if not steps:
        return None
    step_s = sum(record["device_s"].values()) / steps
    w = record["window"]
    return 100.0 * (1.0 - step_s * w["steps"] / w["seconds"])

"""Milliseconds a refine: the measured window's ``refine_state`` calls and
the capacity growths before them, each timed by the benchmark's span
(synchronised before and after), over the refines.  The profiled period
after the window is left out."""


def read(record: dict):
    spans = record.get("spans", {})
    refines = spans.get("refine_state", [])
    if not refines:
        return None
    return (sum(refines) + sum(spans.get("grow_state", []))) / len(refines)

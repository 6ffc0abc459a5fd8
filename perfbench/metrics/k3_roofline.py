"""K3 (the compositing backward, ``composite_bwd*`` kernels): its least
seconds for the entries and pairs the profiled steps needed
(``perfbench/counts``) over its device seconds, in percent."""


def read(record: dict):
    work = record.get("work")
    t = sum(s for n, s in record.get("device_s", {}).items()
            if "composite_bwd" in n)
    if not work or t <= 0:
        return None
    return 100.0 * work["k3_bound_s"] / t

"""The profiled steps' useful fp32 operations (``perfbench/counts``: K2's
and K3's needed pairs, projection, SH and Adam per live Gaussian, the loss
and SSIM per pixel) over the profiled period's wall seconds and the card's
fp32 peak, in percent."""
from perfbench import counts


def read(record: dict):
    work = record.get("work")
    if not work or not record.get("traced_s"):
        return None
    return 100.0 * work["ops"] / record["traced_s"] / counts.PEAK_FP32

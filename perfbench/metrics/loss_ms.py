"""Device milliseconds a graphed step in its loss stage, L1, SSIM and the
depth term (``compute_losses``): the window's ``stage_loss_ms`` over
``stage_samples`` (``Trainer.events``, from the stage events inside the
CUDA graph).  None where the program keeps no stage events."""


def read(record: dict):
    ev = record["window"]["events"]
    n = ev.get("stage_samples")
    if not n or "stage_loss_ms" not in ev:
        return None
    return ev["stage_loss_ms"] / n

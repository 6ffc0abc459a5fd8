"""Device milliseconds a graphed step in its backward stage,
``torch.autograd.grad``: K3, the rows' scatter-add, the SSIM and
projection backward: the window's ``stage_backward_ms`` over
``stage_samples`` (``Trainer.events``, from the stage events inside the
CUDA graph).  None where the program keeps no stage events."""


def read(record: dict):
    ev = record["window"]["events"]
    n = ev.get("stage_samples")
    if not n or "stage_backward_ms" not in ev:
        return None
    return ev["stage_backward_ms"] / n

from touchgs_torch.eval.metrics import (  # noqa: F401
    eval_metrics,
    lpips_distance,
    psnr,
)
from touchgs_torch.eval.runner import evaluate_scene, compute_averages  # noqa: F401

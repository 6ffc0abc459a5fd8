"""The step's tail, SH evaluation with its gradient and the fused Adam, in
other memory layouts, timed on the card (port of ``tools/exp_tail.py``).

The SH colours and the Adam update work on (C, 3), (C, 4) and (C, 15, 3)
tensors.  Candidates:

- SH: the port's ``ops.sh.eval_sh`` on the (C, K, 3) per-coefficient
  layout (``sh_old``) against a channel-major evaluation, (3, K, C)
  coefficients times a (K, C) basis with a band mask (``sh_new``), forward
  plus the gradient with respect to ``sh_dc`` and ``sh_rest`` of the sum;
  the largest difference of the two gradients is printed as the parity;
- Adam: the port's ``FusedAdam.step``, per leaf (``adam_old``), against the
  same update on flat 1-D views of each leaf (``adam_flat``, with the JAX
  tool's learning rates), on gradients of ones.

The state is ``init_random(100000, capacity 131072, SH degree 3)``; view
directions are unit vectors from ``default_rng(0)``.

    python -m touchgs_torch.tools.exp_tail [--iters N]

It needs a CUDA card and exits with status 1 without one.  Every time comes
from ``utils.profiling.measure`` (CUDA events); a row that raises prints
``FAILED`` with its reason.  The computing functions take tensors on any
device, so that the tests drive them on the CPU at a small size.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from touchgs_torch.config import OptimConfig
from touchgs_torch.ops.sh import _C0, _C1, _C2, _C3, eval_sh
from touchgs_torch.tools.exp_common import (CAPACITY, N_GAUSSIANS,
                                            bench_params, iters_arg,
                                            needs_card)
from touchgs_torch.train.optim import PARAM_GROUPS, FusedAdam
from touchgs_torch.utils.profiling import card, timed_row

ITERS = 20
# the JAX tool's learning rates of its flat update (tools/exp_tail.py:108-109)
ADAM_LRS = {"means": 1e-3, "quats": 1e-3, "log_scales": 5e-3,
            "logit_opacities": 5e-2, "sh_dc": 2.5e-3, "sh_rest": 1.25e-4}
B1, B2 = 0.9, 0.999


def tail_inputs(device="cuda", n: int = N_GAUSSIANS, capacity: int = CAPACITY,
                seed: int = 0) -> dict:
    """The state's parameters, its SH bands and unit view directions."""
    params = bench_params(str(device), n, capacity)
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(capacity, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dict(params=params, dc=params.sh_dc, rest=params.sh_rest,
                dirs=torch.as_tensor(dirs, device=device))


def basis_rows(x, y, z) -> list:
    """The 16 real SH basis functions of degree ≤ 3 at (x, y, z), each a
    (C,) row (``tools/exp_tail2.py:71-84``)."""
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return [torch.full_like(x, _C0),
            -_C1 * y, _C1 * z, -_C1 * x,
            _C2[0] * xy, _C2[1] * yz, _C2[2] * (2.0 * zz - xx - yy),
            _C2[3] * xz, _C2[4] * (xx - yy),
            _C3[0] * y * (3.0 * xx - yy), _C3[1] * xy * z,
            _C3[2] * y * (4.0 * zz - xx - yy),
            _C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            _C3[4] * x * (4.0 * zz - xx - yy),
            _C3[5] * z * (xx - yy), _C3[6] * x * (xx - 3.0 * yy)]


def eval_sh_old(dc, rest, d):
    """(C, 3): the port's ``eval_sh`` at degree 3 on (C, K, 3)."""
    return eval_sh(torch.cat([dc[:, None, :], rest], dim=1), d, 3, 3)


def eval_sh_cm(dc, rest, d, active_degree: int = 3):
    """(C, 3) channel-major: (3, K, C) coefficients times the (K, C) basis,
    bands past ``active_degree`` masked (``tools/exp_tail.py:61-89``)."""
    shT = torch.cat([dc[:, None, :], rest], dim=1).permute(2, 1, 0)
    dT = d.T
    B = torch.stack(basis_rows(dT[0], dT[1], dT[2]))          # (K, C)
    band = torch.tensor([0] + [1] * 3 + [2] * 5 + [3] * 7, device=d.device)
    mask = (band <= active_degree).to(B.dtype)
    return torch.sum(shT * (B * mask[:, None])[None], dim=1).T


def eval_sh_2d(dc, rest, d):
    """(C, 3) from the (48, C) transpose of the flattened coefficients, all
    arithmetic on (C,) rows (``tools/exp_tail2.py:86-98``)."""
    T = torch.cat([dc[:, None, :], rest], dim=1).reshape(-1, 48).T
    B = basis_rows(d[:, 0], d[:, 1], d[:, 2])
    outs = []
    for ch in range(3):
        acc = B[0] * T[ch]
        for k in range(1, 16):
            acc = acc + B[k] * T[3 * k + ch]
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def sh_grad(evaluate, dc, rest, d) -> tuple:
    """The gradient of Σ evaluate(dc, rest, d) with respect to dc and rest."""
    dc = dc.detach().requires_grad_(True)
    rest = rest.detach().requires_grad_(True)
    return torch.autograd.grad(evaluate(dc, rest, d).sum(), (dc, rest))


def sh_parity(evaluate, x: dict) -> float:
    a = sh_grad(eval_sh_old, x["dc"], x["rest"], x["dirs"])
    b = sh_grad(evaluate, x["dc"], x["rest"], x["dirs"])
    return max(float((a[0] - b[0]).abs().max()),
               float((a[1] - b[1]).abs().max()))


def adam_state(params) -> tuple:
    """(diff params, gradients of ones, a fresh ``FusedAdam`` and state)."""
    diff = {g: getattr(params, g).detach().clone() for g in PARAM_GROUPS}
    grads = {k: torch.ones_like(v) for k, v in diff.items()}
    opt = FusedAdam(OptimConfig())
    return diff, grads, opt, opt.init(diff)


def adam_flat(params: dict, grads: dict, state, lrs: dict,
              eps: float = OptimConfig().eps, b1: float = B1,
              b2: float = B2) -> None:
    """Adam with optax's bias correction on flat 1-D views of each leaf,
    in place (``tools/exp_tail.py:101-123``)."""
    state.count += 1
    c = state.count.float()
    bc1 = 1.0 - torch.pow(torch.full_like(c, b1), c)
    bc2 = 1.0 - torch.pow(torch.full_like(c, b2), c)
    for k, g in grads.items():
        g1 = g.reshape(-1)
        m = state.mu[k].view(-1).copy_(b1 * state.mu[k].view(-1)
                                       + (1.0 - b1) * g1)
        v = state.nu[k].view(-1).copy_(b2 * state.nu[k].view(-1)
                                       + (1.0 - b2) * (g1 * g1))
        params[k].view(-1).add_((-lrs[k]) * (m / bc1)
                                / (torch.sqrt(v / bc2) + eps))


def main(argv=None, out: dict | None = None) -> int:
    """Exit status 1 without a card; ``out`` receives the rows."""
    argv = sys.argv[1:] if argv is None else argv
    if not needs_card("exp_tail"):
        return 1
    print(card(), flush=True)
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    iters = iters_arg(argv, ITERS)
    x = tail_inputs()
    times: dict = {"sh parity max err": sh_parity(eval_sh_cm, x)}
    print(f"sh parity max err: {times['sh parity max err']:.2e}", flush=True)
    args = (x["dc"], x["rest"], x["dirs"])
    timed_row(times, "sh_old", sh_grad, eval_sh_old, *args, iters=iters,
              width=10)
    timed_row(times, "sh_new", sh_grad, eval_sh_cm, *args, iters=iters,
              width=10)
    diff, grads, opt, state = adam_state(x["params"])
    timed_row(times, "adam_old", opt.step, diff, grads, state, iters=iters,
              width=10)
    diff, grads, opt, state = adam_state(x["params"])
    timed_row(times, "adam_flat", adam_flat, diff, grads, state, ADAM_LRS,
              iters=iters, width=10)
    if out is not None:
        out["rows"] = times
    return 0


if __name__ == "__main__":
    sys.exit(main())

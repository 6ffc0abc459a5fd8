"""The depth-supervised Gaussian-splatting model (port of
``touchgs_tpu/models/splatfacto.py``).

`render` produces RGB + expected depth + accumulation for one camera;
`compute_losses` adds the photometric loss (L1 + SSIM) and the depth term:

- ``SIMPLE_LOSS``: masked L1 between rendered and target depth;
- ``DEPTH_UNCERTAINTY_WEIGHTED_LOSS``: the residual weighted by the
  per-pixel uncertainty σ with strength ``uncertainty_weight``, in the form
  ``DepthLossConfig.uncertainty_form`` names ("inv", "inv_sq" or "exp").

The screen-space positional gradient that densification needs is the
gradient of the loss with respect to an explicit zero ``means2d_offset``.

On the card, through the tile kernels and with a camera that takes no
gradient, `render` shades with ``ops.shade``'s two kernels
(``shade_packed``: projection, SH and the packed attribute table in one
pass, its VJP in one more); elsewhere, and where the camera takes a
gradient (the SO3xR3 pose step, whose camera gradient is a sum over all
Gaussians), it runs `shade`, the op chain, with autograd.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from touchgs_torch.config import DepthLossConfig, DepthLossType, ModelConfig
from touchgs_torch.data.cameras import Camera
from touchgs_torch.models.gaussians import GaussianParams
from touchgs_torch.ops.projection import (
    ProjectedGaussians,
    project_gaussians,
    view_directions,
)
from touchgs_torch.ops.rasterize_cuda import rasterize_cuda
from touchgs_torch.ops.rasterize_ref import RenderOutput, rasterize_dense
from touchgs_torch.ops.rasterize_tiled import rasterize_tiled
from touchgs_torch.ops.sh import eval_sh
from touchgs_torch.ops.shade import shade_packed
from touchgs_torch.ops.ssim import ssim_cm
from touchgs_torch.utils import telemetry


def shade(
    params: GaussianParams,
    camera: Camera,
    cfg: ModelConfig,
    active_sh_degree: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
) -> tuple:
    """What `render` hands its rasterizer: (projected, colors, opacities,
    background) of one view."""
    opacities = params.opacities()
    proj = project_gaussians(
        params.means, params.quats, params.scales(),
        camera.w2c, camera.fx, camera.fy, camera.cx, camera.cy,
        camera.width, camera.height, cfg.rasterize,
        extra_valid=params.alive,
        # culling radii only (ceil'd, so no gradient): keep the binning
        # side-path out of the autograd graph
        opacities=opacities.detach(),
    )
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)

    cam_origin = camera.c2w[:3, 3]
    dirs = view_directions(params.means, cam_origin)
    colors = torch.clamp(
        eval_sh(params.sh_coeffs(), dirs, cfg.sh_degree, active_sh_degree) + 0.5,
        min=0.0,
    )
    bg = (background if background is not None
          else _background(cfg.background, params.means.device))
    return proj, colors, opacities, bg


# (colour, device) -> the configured background on that device, uploaded
# once: a step that runs as a CUDA graph may copy nothing from the host, and
# a graph keeps reading the tensor it captured, so entries are never dropped
_BACKGROUNDS: dict = {}


def _background(colour: tuple, device: torch.device) -> torch.Tensor:
    key = (tuple(colour), device)
    bg = _BACKGROUNDS.get(key)
    if bg is None:
        bg = _BACKGROUNDS[key] = torch.tensor(colour, dtype=torch.float32,
                                              device=device)
    return bg


def _fused_shade(params: GaussianParams, camera: Camera) -> bool:
    """Whether `render` shades through ``ops.shade``'s kernels: the state
    is on the card and the camera takes no gradient (a per-Gaussian
    kernel does not sum the camera's)."""
    return params.means.is_cuda and not any(
        t.requires_grad for t in (camera.c2w, camera.fx, camera.fy,
                                  camera.cx, camera.cy))


def render(
    params: GaussianParams,
    camera: Camera,
    cfg: ModelConfig,
    active_sh_degree: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    use_dense: bool = False,
    k_tile: Optional[int] = None,
    tile_shards: int = 0,
    mesh=None,
) -> tuple[RenderOutput, ProjectedGaussians]:
    """Render one view. Returns (outputs, projected) — `projected` feeds the
    densification statistics (radii, validity).  With a ``mesh``
    (``parallel.mesh.Mesh``), ``params`` are this rank's rows of a
    row-sharded capacity: projection and SH run on them, the rasterizer
    gathers what it needs, and the image comes back whole on every rank;
    ``projected`` stays this rank's rows."""
    rcfg = cfg.rasterize
    if k_tile is None:
        k_tile = rcfg.k_tile
    attrs = None
    if rcfg.use_pallas and not use_dense and _fused_shade(params, camera):
        proj, attrs = shade_packed(params, camera, cfg, active_sh_degree,
                                   means2d_offset, dead_rows=mesh is None)
        colors = opacities = None
        bg = (background if background is not None
              else _background(cfg.background, params.means.device))
    else:
        proj, colors, opacities, bg = shade(params, camera, cfg,
                                            active_sh_degree, background,
                                            means2d_offset)
    telemetry.mark("shade")
    if use_dense:
        if mesh is not None:
            raise ValueError("the dense oracle renders one process's rows: "
                             "pass mesh=None")
        out = rasterize_dense(
            proj, colors, opacities, camera.width, camera.height, rcfg,
            background=bg,
        )
    elif rcfg.use_pallas:
        out = rasterize_cuda(
            proj, colors, opacities, camera.width, camera.height, rcfg,
            background=bg, k_tile=k_tile, k_chunk=rcfg.k_chunk,
            tile_shards=tile_shards, mesh=mesh, attrs=attrs,
        )
    else:
        # the scan path takes k_tile but not k_chunk, as in the JAX package
        out = rasterize_tiled(
            proj, colors, opacities, camera.width, camera.height, rcfg,
            background=bg, k_tile=k_tile, tile_shards=tile_shards,
            mesh=mesh,
        )
    telemetry.mark("composite")
    return out, proj


# last sufficient eval k_tile per (capacity, width, height): frames after
# the first start at the proven cap instead of re-escalating
_LOSSLESS_K: dict = {}


def render_lossless(
    params: GaussianParams,
    camera: Camera,
    cfg: ModelConfig,
    active_sh_degree: Optional[int] = None,
    background: Optional[torch.Tensor] = None,
    max_k_tile: int = 8192,
) -> RenderOutput:
    """Render with an escalating per-tile cap until nothing is truncated.

    Training tolerates (and monitors) k_tile truncation; evaluation must
    not.  Doubles k_tile until the truncation telemetry reads zero; the
    sufficient cap is remembered per capacity and resolution.
    """
    key = (params.capacity, camera.width, camera.height)
    k = max(cfg.rasterize.k_tile, _LOSSLESS_K.get(key, 0))
    while True:
        with torch.no_grad():
            out, _ = render(params, camera, cfg,
                            active_sh_degree=active_sh_degree,
                            background=background, k_tile=k)
        if (out.lossy_tiles is None or k >= max_k_tile
                or int(out.lossy_tiles) == 0):
            _LOSSLESS_K[key] = k
            return out
        k = min(k * 2, max_k_tile)


class LossOutput(NamedTuple):
    total: torch.Tensor
    rgb_l1: torch.Tensor
    ssim_loss: torch.Tensor
    depth_loss: torch.Tensor
    psnr: torch.Tensor


def depth_supervision_loss(
    rendered_depth: torch.Tensor,   # (H, W)
    target_depth: torch.Tensor,     # (H, W), 0 = no supervision
    uncertainty: Optional[torch.Tensor],  # (H, W) sigma, or None
    cfg: DepthLossConfig,
) -> torch.Tensor:
    valid = target_depth > 0
    residual = torch.abs(rendered_depth - target_depth)
    if (
        cfg.depth_loss_type is DepthLossType.DEPTH_UNCERTAINTY_WEIGHTED_LOSS
        and uncertainty is not None
    ):
        if cfg.uncertainty_form == "inv":
            w = 1.0 / (1.0 + cfg.uncertainty_weight * uncertainty)
        elif cfg.uncertainty_form == "exp":
            w = torch.exp(-cfg.uncertainty_weight * uncertainty)
        elif cfg.uncertainty_form == "inv_sq":
            w = 1.0 / (1.0 + cfg.uncertainty_weight * uncertainty**2)
        else:
            # the JAX package treats any other value as "inv_sq"; the port
            # rejects it (a deliberate deviation, ROADMAP.md C5)
            raise ValueError(
                f"unknown uncertainty_form {cfg.uncertainty_form!r}: "
                f"want 'inv', 'inv_sq' or 'exp'")
        residual = residual * w
    residual = torch.where(valid, residual, torch.zeros_like(residual))
    denom = torch.clamp(valid.sum(), min=1)
    return residual.sum() / denom


def compute_losses(
    out: RenderOutput,
    image: torch.Tensor,                  # (H, W, 3)
    depth: Optional[torch.Tensor],        # (H, W) or None
    uncertainty: Optional[torch.Tensor],  # (H, W) or None
    depth_cfg: DepthLossConfig,
    ssim_lambda: float = 0.2,
) -> LossOutput:
    rgb_cm = out.rgb.permute(2, 0, 1)
    img_cm = image.permute(2, 0, 1)
    l1 = torch.mean(torch.abs(rgb_cm - img_cm))
    s = ssim_cm(rgb_cm, img_cm)
    ssim_loss = 1.0 - s
    rgb_total = (1.0 - ssim_lambda) * l1 + ssim_lambda * ssim_loss
    if depth is not None:
        d_loss = depth_supervision_loss(out.depth, depth, uncertainty,
                                        depth_cfg)
    else:
        d_loss = torch.zeros((), device=out.rgb.device)
    total = rgb_total + depth_cfg.depth_loss_mult * d_loss
    mse = torch.mean((rgb_cm - img_cm) ** 2)
    psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-10))
    return LossOutput(total=total, rgb_l1=l1, ssim_loss=ssim_loss,
                      depth_loss=d_loss, psnr=psnr)

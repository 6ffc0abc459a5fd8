"""Faithful Depth Anything (DINOv2 backbone + DPT neck/head) in PyTorch
(port of ``touchgs_tpu/vision/depth_anything.py``).

The architecture of HuggingFace ``DepthAnythingForDepthEstimation``
(depth-anything-small), on a ported checkpoint's flat npz
(`dpt.PortedNet`).  The forward is the JAX package's, in NCHW:

- DINOv2 backbone: patch-14 conv → [CLS] + pos-embed (``jax.image.resize``
  bicubic off the native grid, `utils.resize`) → pre-LN blocks with
  LayerScale; taps are the selected block outputs through the backbone's
  final layernorm.
- Reassemble: CLS dropped (no readout projection) → 1×1 projection →
  resize (ConvT ×4, ConvT ×2, identity, 3×3 stride-2 conv).
- Neck: fusion deepest → finest, each layer upsampled to the next tap's
  size (align_corners=True).
- Head: 3×3 conv → bilinear to (ph·14, pw·14) → 3×3 conv → ReLU → 1×1 conv
  → ReLU (relative) or sigmoid·max_depth (metric).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F

from touchgs_torch.utils.resize import resize
from touchgs_torch.vision.dpt import (
    PortedNet,
    attention,
    conv,
    layernorm,
    linear,
    patch_embed,
    reassemble_resize,
    residual_unit,
    resize_bilinear,
    to_image,
    tokens_to_map,
)


@dataclasses.dataclass(frozen=True)
class DepthAnythingArch:
    """Mirrors transformers.DepthAnythingConfig (+ its Dinov2 backbone)."""

    hidden_size: int = 384            # dinov2-small
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: int = 4
    patch_size: int = 14
    image_size: int = 518             # pos-embed native size
    out_indices: Sequence[int] = (9, 10, 11, 12)   # 1-based stages (0 = stem)
    reassemble_hidden_size: int = 384
    neck_hidden_sizes: Sequence[int] = (48, 96, 192, 384)
    reassemble_factors: Sequence[float] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 64
    head_hidden_size: int = 32
    depth_estimation_type: str = "relative"
    max_depth: float = 1.0
    layer_norm_eps: float = 1e-6


DEPTH_ANYTHING_SMALL = DepthAnythingArch()


def _dinov2_block(x, p, prefix, arch: DepthAnythingArch):
    h = layernorm(x, p, f"{prefix}.norm1", arch.layer_norm_eps)
    a = f"{prefix}.attention.attention"
    ctx = attention(linear(h, p, f"{a}.query"), linear(h, p, f"{a}.key"),
                    linear(h, p, f"{a}.value"), arch.num_heads)
    ctx = linear(ctx, p, f"{prefix}.attention.output.dense")
    x = x + ctx * p[f"{prefix}.layer_scale1.lambda1"]
    h = layernorm(x, p, f"{prefix}.norm2", arch.layer_norm_eps)
    h = F.gelu(linear(h, p, f"{prefix}.mlp.fc1"))
    h = linear(h, p, f"{prefix}.mlp.fc2")
    return x + h * p[f"{prefix}.layer_scale2.lambda1"]


def _dinov2_pos_embed(p, ph, pw, arch: DepthAnythingArch):
    """The position embeddings resized to (ph, pw) as the JAX package does
    it, ``jax.image.resize(..., "bicubic")`` (`utils.resize`)."""
    pos = p["backbone.embeddings.position_embeddings"]  # (1, 1+g*g, D)
    g = arch.image_size // arch.patch_size
    cls_pos, grid = pos[:, :1], pos[:, 1:]
    if (ph, pw) != (g, g):
        grid = grid.reshape(g, g, -1)
        grid = resize(grid, (ph, pw, grid.shape[-1]), "bicubic")
        grid = grid.reshape(1, ph * pw, -1)
    return torch.cat([cls_pos, grid], dim=1)


def depth_anything_forward(p: dict, rgb: torch.Tensor,
                           arch: DepthAnythingArch = DEPTH_ANYTHING_SMALL
                           ) -> torch.Tensor:
    """(H, W, 3) preprocessed image → (H, W) predicted depth; H, W
    multiples of ``arch.patch_size``."""
    x, ph, pw = patch_embed(rgb, p, "backbone.embeddings.patch_embeddings."
                            "projection", arch.patch_size)
    cls = p["backbone.embeddings.cls_token"].expand(1, 1, arch.hidden_size)
    x = torch.cat([cls, x], dim=1) + _dinov2_pos_embed(p, ph, pw, arch)

    # stages are 1-based over block outputs (stage 0 = the embeddings)
    taps = [x] if 0 in arch.out_indices else []
    for i in range(arch.num_layers):
        x = _dinov2_block(x, p, f"backbone.encoder.layer.{i}", arch)
        if (i + 1) in arch.out_indices:
            taps.append(x)

    feats = []
    for i, t in enumerate(taps):
        t = layernorm(t, p, "backbone.layernorm", arch.layer_norm_eps)
        h = tokens_to_map(t[:, 1:], ph, pw)
        h = conv(h, p, f"neck.reassemble_stage.layers.{i}.projection")
        h = reassemble_resize(h, p, i, arch.reassemble_factors[i])
        feats.append(conv(h, p, f"neck.convs.{i}"))

    # fusion, deepest → finest; each layer upsamples to the NEXT tap's
    # size (the last one by 2), align_corners=True
    rev = feats[::-1]
    fused = None
    for j, f in enumerate(rev):
        prefix = f"neck.fusion_stage.layers.{j}"
        if fused is None:
            fused = f
        else:
            f = resize_bilinear(f, fused.shape[2], fused.shape[3],
                                align_corners=False)
            fused = fused + residual_unit(f, p, f"{prefix}.residual_layer1")
        fused = residual_unit(fused, p, f"{prefix}.residual_layer2")
        if j + 1 < len(rev):
            oh, ow = rev[j + 1].shape[2:]
        else:
            oh, ow = fused.shape[2] * 2, fused.shape[3] * 2
        fused = resize_bilinear(fused, oh, ow, align_corners=True)
        fused = conv(fused, p, f"{prefix}.projection")

    y = conv(fused, p, "head.conv1")
    y = resize_bilinear(y, ph * arch.patch_size, pw * arch.patch_size,
                        align_corners=True)
    y = torch.relu(conv(y, p, "head.conv2"))
    y = conv(y, p, "head.conv3")
    if arch.depth_estimation_type == "metric":
        y = torch.sigmoid(y) * arch.max_depth
    else:
        y = torch.relu(y)
    return y[0, 0]


def arch_from_params(params: dict) -> DepthAnythingArch:
    """The arch of a ported param dict in the file's layouts (any
    Depth-Anything size)."""
    d = params["backbone.embeddings.cls_token"].shape[-1]
    n_layers = 1 + max(
        int(k.split(".")[3]) for k in params
        if k.startswith("backbone.encoder.layer."))
    patch = params[
        "backbone.embeddings.patch_embeddings.projection.weight"].shape[0]
    n_tokens = params["backbone.embeddings.position_embeddings"].shape[1] - 1
    image_size = int(round(n_tokens ** 0.5)) * patch
    neck = tuple(
        params[f"neck.reassemble_stage.layers.{i}.projection.weight"].shape[-1]
        for i in range(4))
    fusion = params["neck.convs.0.weight"].shape[-1]
    head_hidden = params["head.conv2.weight"].shape[-1]
    mlp_ratio = (params["backbone.encoder.layer.0.mlp.fc1.weight"].shape[-1]
                 // d)
    # HF conversion taps the last four blocks for every size
    out_indices = tuple(range(n_layers - 3, n_layers + 1))
    heads = max(1, d // 64)
    return DepthAnythingArch(
        hidden_size=d, num_layers=n_layers, num_heads=heads,
        mlp_ratio=mlp_ratio, patch_size=patch, image_size=image_size,
        out_indices=out_indices, reassemble_hidden_size=d,
        neck_hidden_sizes=neck, fusion_hidden_size=fusion,
        head_hidden_size=head_hidden)


def preprocess(rgb, size: int = 518, device=None) -> torch.Tensor:
    """Depth-Anything image processor: resize (multiple of 14), 1/255,
    ImageNet mean/std normalization."""
    s = (size // 14) * 14
    img = to_image(rgb, device).permute(2, 0, 1)[None]
    img = resize_bilinear(img, s, s, align_corners=False)[0].permute(1, 2, 0)
    mean = torch.tensor([0.485, 0.456, 0.406], device=img.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=img.device)
    return (img - mean) / std


class DepthAnything(PortedNet):
    """DepthAnythingForDepthEstimation: ``model(img)`` with img from
    `preprocess`."""

    arch_from_params = staticmethod(arch_from_params)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return depth_anything_forward(self.params(), rgb, self.arch)

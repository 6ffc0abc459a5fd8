"""Faithful ZoeDepth (BEiT backbone + metric-bins head(s)) in PyTorch (port
of ``touchgs_tpu/vision/zoedepth.py``).

The architecture of HuggingFace ``ZoeDepthForDepthEstimation`` (ZoeD_N,
ZoeD_NK), on a ported checkpoint's flat npz (`dpt.PortedNet`).  The forward
is the JAX package's, in NCHW (bins on the channel axis):

- BEiT backbone: patch-16 conv → [CLS] (no absolute pos-embed) → pre-LN
  blocks with a per-layer relative position bias (its table bilinearly
  resized off the native window), q/v-only biases, LayerScale; taps are raw
  block outputs.
- DPT neck (readout 'project'), fusion with align_corners=True; the
  pre-fusion bottleneck is the coarsest conv feature.
- Relative head → (relative depth, features).
- Metric bins: seed bins (softplus or normed), attractors
  (``_inv_attractor`` with HF's fixed α = 300, γ = 2), the conditional
  log-binomial softmax, depth = Σ pᵢ·cᵢ.  The NK variant's two heads are
  routed per image by the patch transformer's domain logits: an argmax on
  the host (`ZoeDepth.forward`), one sync an image.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from touchgs_torch.eval.lpips_vgg import fp32
from touchgs_torch.vision.dpt import (
    PortedNet,
    attention,
    conv,
    layernorm,
    linear,
    patch_embed,
    readout_project,
    reassemble_resize,
    residual_unit,
    resize_bilinear,
    to_image,
)


@dataclasses.dataclass(frozen=True)
class BinConfig:
    name: str = "nyu"
    n_bins: int = 64
    min_depth: float = 1e-3
    max_depth: float = 10.0


@dataclasses.dataclass(frozen=True)
class ZoeDepthArch:
    """Mirrors transformers.ZoeDepthConfig (+ its BEiT backbone)."""

    # backbone (BEiT)
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 384                 # native rel-pos window basis
    backbone_out_indices: Sequence[int] = (6, 12, 18, 24)  # 1-based stages
    layer_norm_eps: float = 1e-12
    # neck / heads
    neck_hidden_sizes: Sequence[int] = (96, 192, 384, 768)
    reassemble_factors: Sequence[float] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    bottleneck_features: int = 256
    num_relative_features: int = 32
    add_projection: bool = False
    # metric bins
    bin_centers_type: str = "softplus"    # released ckpts; "normed" supported
    num_attractors: Sequence[int] = (16, 8, 4, 1)
    attractor_kind: str = "mean"
    bin_configurations: Sequence[BinConfig] = (BinConfig(),)
    min_temp: float = 0.0212
    max_temp: float = 50.0
    patch_transformer_heads: int = 4      # NK domain classifier


ZOEDEPTH_NYU = ZoeDepthArch()
ZOEDEPTH_NK = ZoeDepthArch(bin_configurations=(
    BinConfig("nyu", 64, 1e-3, 10.0), BinConfig("kitti", 64, 1e-3, 80.0)))


# ---------------------------------------------------------------- BEiT ----

@functools.lru_cache(maxsize=8)
def _rel_pos_index_on(wh: int, ww: int, device: torch.device) -> torch.Tensor:
    """`_rel_pos_index` flattened, on ``device`` once (every layer reads
    it)."""
    return torch.as_tensor(_rel_pos_index(wh, ww).reshape(-1), device=device)


@functools.lru_cache(maxsize=8)
def _rel_pos_index(wh: int, ww: int) -> np.ndarray:
    """BeitRelativePositionBias.generate_relative_position_index (numpy,
    static per window size)."""
    num_rel = (2 * wh - 1) * (2 * ww - 1) + 3
    grid = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = grid.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]          # (2, N, N)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    area = wh * ww
    index = np.zeros((area + 1, area + 1), np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, :] = num_rel - 3
    index[:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index


def _rel_pos_bias(p, prefix, arch: ZoeDepthArch, wh: int, ww: int):
    """(1, heads, N+1, N+1) relative position bias for window (wh, ww),
    table-resized off the native window when sizes differ."""
    table = p[f"{prefix}.relative_position_bias_table"]  # (num_rel_old, H)
    g = arch.image_size // arch.patch_size
    old_h, old_w = 2 * g - 1, 2 * g - 1
    new_h, new_w = 2 * wh - 1, 2 * ww - 1
    if (new_h, new_w) != (old_h, old_w):
        sub = table[: old_h * old_w]
        # the HF code reshapes with (width, height) order, kept verbatim
        sub = sub.reshape(1, old_w, old_h, -1).permute(0, 3, 1, 2)
        sub = resize_bilinear(sub, new_h, new_w, align_corners=False)
        sub = sub.permute(0, 2, 3, 1).reshape(new_h * new_w, -1)
        table = torch.cat([sub, table[old_h * old_w:]], dim=0)
    index = _rel_pos_index_on(wh, ww, table.device)
    bias = table[index].reshape(wh * ww + 1, wh * ww + 1, -1)
    return bias.permute(2, 0, 1)[None]


def _beit_block(x, p, prefix, arch: ZoeDepthArch, rel_bias):
    h = layernorm(x, p, f"{prefix}.layernorm_before", arch.layer_norm_eps)
    a = f"{prefix}.attention.attention"
    # BEiT quirk: the key projection has no bias
    ctx = attention(linear(h, p, f"{a}.query"), linear(h, p, f"{a}.key"),
                    linear(h, p, f"{a}.value"), arch.num_heads, rel_bias)
    ctx = linear(ctx, p, f"{prefix}.attention.output.dense")
    x = x + ctx * p[f"{prefix}.lambda_1"]
    h = layernorm(x, p, f"{prefix}.layernorm_after", arch.layer_norm_eps)
    h = F.gelu(linear(h, p, f"{prefix}.intermediate.dense"))
    h = linear(h, p, f"{prefix}.output.dense")
    return x + h * p[f"{prefix}.lambda_2"]


def beit_backbone(p, rgb, arch: ZoeDepthArch):
    """(H, W, 3) → list of 4 tap sequences (1, N+1, D), ph, pw."""
    x, ph, pw = patch_embed(rgb, p, "backbone.embeddings.patch_embeddings."
                            "projection", arch.patch_size)
    cls = p["backbone.embeddings.cls_token"].expand(1, 1, arch.hidden_size)
    x = torch.cat([cls, x], dim=1)
    taps = [x] if 0 in arch.backbone_out_indices else []
    for i in range(arch.num_layers):
        prefix = f"backbone.encoder.layer.{i}"
        rel = _rel_pos_bias(
            p, f"{prefix}.attention.attention.relative_position_bias",
            arch, ph, pw)
        x = _beit_block(x, p, prefix, arch, rel)
        if (i + 1) in arch.backbone_out_indices:
            taps.append(x)
    return taps, ph, pw


# ---------------------------------------------------------------- neck ----

def neck(p, taps, ph, pw, arch: ZoeDepthArch):
    """(fused list deepest→finest, bottleneck conv feature)."""
    feats = []
    for i, t in enumerate(taps):
        h = readout_project(t, p, i, ph, pw)
        h = conv(h, p, f"neck.reassemble_stage.layers.{i}.projection")
        h = reassemble_resize(h, p, i, arch.reassemble_factors[i])
        feats.append(conv(h, p, f"neck.convs.{i}"))

    fused_list = []
    fused = None
    for j, f in enumerate(feats[::-1]):
        prefix = f"neck.fusion_stage.layers.{j}"
        if fused is None:
            fused = f
        else:
            f = resize_bilinear(f, fused.shape[2], fused.shape[3],
                                align_corners=False)
            fused = fused + residual_unit(f, p, f"{prefix}.residual_layer1")
        fused = residual_unit(fused, p, f"{prefix}.residual_layer2")
        fused = resize_bilinear(fused, fused.shape[2] * 2,
                                fused.shape[3] * 2, align_corners=True)
        fused = conv(fused, p, f"{prefix}.projection")
        fused_list.append(fused)
    return fused_list, feats[-1]


def _relative_head(p, fused_list, arch: ZoeDepthArch):
    x = fused_list[-1]
    if arch.add_projection:
        x = torch.relu(conv(x, p, "relative_head.projection"))
    x = conv(x, p, "relative_head.conv1")
    x = resize_bilinear(x, x.shape[2] * 2, x.shape[3] * 2, align_corners=True)
    x = torch.relu(conv(x, p, "relative_head.conv2"))
    features = x
    x = torch.relu(conv(x, p, "relative_head.conv3"))
    return x[:, 0], features


# --------------------------------------------------------- metric bins ----

def _mlp_conv(x, p, prefix):
    return conv(torch.relu(conv(x, p, f"{prefix}.conv1")), p, f"{prefix}.conv2")


def _inv_attractor(dx, alpha: float = 300.0, gamma: int = 2):
    # HF calls inv_attractor with its DEFAULTS (α=300, γ=2) regardless of the
    # config values, kept verbatim for checkpoint compatibility
    return dx / (1 + alpha * dx ** gamma)


def _seed_bins(p, x, prefix, arch: ZoeDepthArch, bc: BinConfig):
    h = conv(torch.relu(conv(x, p, f"{prefix}.conv1")), p, f"{prefix}.conv2")
    if arch.bin_centers_type == "normed":
        centers = torch.relu(h) + 1e-3
        widths_n = centers / centers.sum(dim=1, keepdim=True)
        widths = (bc.max_depth - bc.min_depth) * widths_n
        widths = F.pad(widths, (0, 0, 0, 0, 1, 0), value=bc.min_depth)
        edges = torch.cumsum(widths, dim=1)
        centers = 0.5 * (edges[:, :-1] + edges[:, 1:])
        return widths_n, centers
    centers = F.softplus(h)
    return centers, centers


def _attractor(p, x, prev_bin, prev_embedding, prefix, arch: ZoeDepthArch,
               bc: BinConfig):
    """One attractor layer (bins on the channel axis)."""
    if prev_embedding is not None:
        prev_embedding = resize_bilinear(prev_embedding, x.shape[2],
                                         x.shape[3], align_corners=True)
        x = x + prev_embedding
    h = conv(torch.relu(conv(x, p, f"{prefix}.conv1")), p, f"{prefix}.conv2")
    n, c, height, width = h.shape
    prev_bin = resize_bilinear(prev_bin, height, width, align_corners=True)

    if arch.bin_centers_type == "normed":
        a = torch.relu(h) + 1e-3
        attractors = a.reshape(n, c // 2, 2, height, width)[:, :, 0]  # the HF-preserved bug
    else:
        attractors = F.softplus(h)
    delta = _inv_attractor(attractors[:, :, None] - prev_bin[:, None, :])
    delta = (delta.mean(dim=1) if arch.attractor_kind == "mean"
             else delta.sum(dim=1))
    if arch.bin_centers_type == "normed":
        new_normed = prev_bin + delta
        centers = (bc.max_depth - bc.min_depth) * new_normed + bc.min_depth
        centers = torch.sort(centers, dim=1).values
        return new_normed, torch.clamp(centers, bc.min_depth, bc.max_depth)
    new_centers = prev_bin + delta
    return new_centers, new_centers


@functools.lru_cache(maxsize=8)
def _log_binomial_row(n_classes: int, device: torch.device):
    """(k, the Stirling log-binomial row), (1, K, 1, 1) each: a static
    constant, in numpy f32 as the JAX package computes it."""
    k_idx = np.arange(n_classes, dtype=np.float32)
    n = np.float32(n_classes - 1) + np.float32(1e-7)
    k = k_idx + np.float32(1e-7)
    lb = (n * np.log(n) - k * np.log(k)
          - (n - k) * np.log(n - k + np.float32(1e-7)))
    return tuple(torch.as_tensor(a, device=device)[None, :, None, None]
                 for a in (k_idx, lb))


def _log_binomial_softmax(probabilities, temperature, n_classes):
    """LogBinomialSoftmax.forward, over the bins of (n, K, h, w)."""
    eps = 1e-4
    p1 = torch.clamp(probabilities, eps, 1.0)
    p0 = torch.clamp(1.0 - probabilities, eps, 1.0)
    k_idx, lb = _log_binomial_row(n_classes, probabilities.device)
    y = (lb + k_idx * torch.log(p1[:, None])
         + (float(n_classes - 1) - k_idx) * torch.log(p0[:, None]))
    return torch.softmax(y / temperature[:, None], dim=1)


def _conditional_log_binomial(p, main, condition, prefix,
                              arch: ZoeDepthArch, n_bins):
    h = F.gelu(conv(torch.cat([main, condition], dim=1), p, f"{prefix}.mlp.0"))
    h = F.softplus(conv(h, p, f"{prefix}.mlp.2"))
    pr = h[:, :2] + 1e-4
    prob = pr[:, 0] / (pr[:, 0] + pr[:, 1])
    tm = h[:, 2:] + 1e-4
    temp = tm[:, 0] / (tm[:, 0] + tm[:, 1])
    temp = (arch.max_temp - arch.min_temp) * temp + arch.min_temp
    return _log_binomial_softmax(prob, temp, n_bins)


def _metric_bins(p, prefix, x, fused_list, rel_features, relative_depth,
                 arch: ZoeDepthArch, bc: BinConfig, multi: bool):
    """Seed → attractors → conditional log-binomial.  ``prefix`` names the
    NK head's per-configuration submodules; the single head also conditions
    on the relative depth map."""
    seed_name = (f"metric_head.seed_bin_regressors.{prefix}" if multi
                 else "metric_head.seed_bin_regressor")
    _, seed_centers = _seed_bins(p, x, seed_name, arch, bc)
    if arch.bin_centers_type == "normed":
        prev_bin = (seed_centers - bc.min_depth) / (bc.max_depth
                                                    - bc.min_depth)
    else:
        prev_bin = seed_centers
    prev_embedding = _mlp_conv(x, p, "metric_head.seed_projector")

    centers = prev_bin
    embedding = prev_embedding
    for i, feature in enumerate(fused_list):
        embedding = _mlp_conv(feature, p, f"metric_head.projectors.{i}")
        attr_name = (f"metric_head.attractors.{prefix}.{i}" if multi
                     else f"metric_head.attractors.{i}")
        prev_bin, centers = _attractor(p, embedding, prev_bin,
                                       prev_embedding, attr_name, arch, bc)
        prev_embedding = embedding

    last = rel_features
    if not multi:
        rc = resize_bilinear(relative_depth[:, None], last.shape[2],
                             last.shape[3], align_corners=True)
        last = torch.cat([last, rc], dim=1)

    embedding = resize_bilinear(embedding, last.shape[2], last.shape[3],
                                align_corners=True)
    clb_name = (f"metric_head.conditional_log_binomial.{prefix}" if multi
                else "metric_head.conditional_log_binomial")
    probs = _conditional_log_binomial(p, last, embedding, clb_name, arch,
                                      bc.n_bins)
    centers = resize_bilinear(centers, probs.shape[2], probs.shape[3],
                              align_corners=True)
    return (probs * centers).sum(dim=1)


# ------------------------------------------------- NK domain classifier ----

def _patch_transformer(p, x, arch: ZoeDepthArch):
    """ZoeDepthPatchTransformerEncoder → (1, L+1, D) embeddings."""
    emb = conv(x, p, "metric_head.patch_transformer.embedding_convPxP")
    n, d = emb.shape[:2]
    emb = emb.flatten(2).transpose(1, 2)
    # extra leading zero token (F.pad(..., (1, 0)) on the sequence axis)
    emb = torch.cat([emb.new_zeros(n, 1, d), emb], dim=1)
    L = emb.shape[1]
    pos = torch.arange(L, dtype=torch.float32, device=emb.device)[:, None]
    idx = torch.arange(0, d, 2, dtype=torch.float32, device=emb.device)[None]
    pe = pos * torch.exp(idx * np.float32(-np.log(10000.0) / d))
    emb = emb + torch.cat([torch.sin(pe), torch.cos(pe)], dim=1)[None]

    heads_p = "metric_head.patch_transformer.transformer_encoder"
    for i in range(4):     # HF hardcodes 4 iterations
        prefix = f"{heads_p}.{i}"
        a = f"{prefix}.self_attn"
        ctx = attention(linear(emb, p, f"{a}.query"),
                        linear(emb, p, f"{a}.key"),
                        linear(emb, p, f"{a}.value"),
                        arch.patch_transformer_heads)
        ctx = linear(ctx, p, f"{a}.out_proj")
        emb = layernorm(emb + ctx, p, f"{prefix}.norm1", 1e-5)
        h2 = linear(torch.relu(linear(emb, p, f"{prefix}.linear1")), p,
                    f"{prefix}.linear2")
        emb = layernorm(emb + h2, p, f"{prefix}.norm2", 1e-5)
    return emb


def classify_domain(p, bottleneck, arch: ZoeDepthArch):
    """NK head: domain logits (1, n_configurations)."""
    x = conv(bottleneck, p, "metric_head.conv2")
    emb = _patch_transformer(p, x, arch)[:, 0]
    h = torch.relu(linear(emb, p, "metric_head.mlp_classifier.linear1"))
    return linear(h, p, "metric_head.mlp_classifier.linear2")


# ------------------------------------------------------------- forward ----

def zoedepth_forward(p: dict, rgb: torch.Tensor,
                     arch: ZoeDepthArch = ZOEDEPTH_NYU,
                     bin_config_name: str | None = None) -> torch.Tensor:
    """(H, W, 3) preprocessed image → (H', W') metric depth.  For the NK
    arch ``bin_config_name`` picks the head ("nyu"/"kitti"; default the
    first)."""
    taps, ph, pw = beit_backbone(p, rgb, arch)
    fused_list, bottleneck = neck(p, taps, ph, pw, arch)
    return _metric_depth(p, fused_list, bottleneck, arch, bin_config_name)


def _metric_depth(p, fused_list, bottleneck, arch: ZoeDepthArch,
                  bin_config_name):
    relative_depth, rel_features = _relative_head(p, fused_list, arch)
    multi = len(arch.bin_configurations) > 1
    names = [b.name for b in arch.bin_configurations]
    name = bin_config_name or names[0]
    bc = arch.bin_configurations[names.index(name)]
    x = conv(bottleneck, p, "metric_head.conv2")
    depth = _metric_bins(p, name if multi else "", x, fused_list,
                         rel_features, relative_depth, arch, bc, multi=multi)
    return depth[0]


def preprocess(rgb, size: int | tuple[int, int] = (384, 512),
               device=None) -> torch.Tensor:
    """ZoeDepthImageProcessor: 1/255, mean=std=0.5, resized to multiples
    of 32 (bilinear, align_corners=False)."""
    if isinstance(size, int):
        size = (size, size)
    h = (size[0] // 32) * 32
    w = (size[1] // 32) * 32
    img = to_image(rgb, device).permute(2, 0, 1)[None]
    img = resize_bilinear(img, h, w, align_corners=False)[0]
    return ((img - 0.5) / 0.5).permute(1, 2, 0)


def arch_from_params(params: dict) -> ZoeDepthArch:
    """The backbone/head dims of a ported checkpoint in the file's layouts."""
    d = params["backbone.embeddings.cls_token"].shape[-1]
    n_layers = 1 + max(
        int(k.split(".")[3]) for k in params
        if k.startswith("backbone.encoder.layer."))
    inter = params["backbone.encoder.layer.0.intermediate.dense.weight"
                   ].shape[-1]
    patch = params["backbone.embeddings.patch_embeddings.projection.weight"
                   ].shape[0]
    table = params["backbone.encoder.layer.0.attention.attention."
                   "relative_position_bias.relative_position_bias_table"]
    g = (int(round((table.shape[0] - 3) ** 0.5)) + 1) // 2
    heads = table.shape[-1]  # (num_relative_distance, num_heads)
    neck_sizes = tuple(
        params[f"neck.reassemble_stage.layers.{i}.projection.weight"
               ].shape[-1] for i in range(4))
    fusion = params["neck.convs.0.weight"].shape[-1]
    multi = any(k.startswith("metric_head.seed_bin_regressors.")
                for k in params)
    step = n_layers // 4
    taps = tuple(step * (i + 1) for i in range(4))
    if multi:
        # n_bins per configuration from the seed regressors' output convs;
        # min/max depth are the released NK values (nyu 10 m, kitti 80 m)
        bins = tuple(dataclasses.replace(
            bc, n_bins=params[
                f"metric_head.seed_bin_regressors.{bc.name}.conv2.weight"
            ].shape[-1])
            for bc in ZOEDEPTH_NK.bin_configurations)
    else:
        nb = params["metric_head.seed_bin_regressor.conv2.weight"].shape[-1]
        bins = (dataclasses.replace(ZOEDEPTH_NYU.bin_configurations[0],
                                    n_bins=nb),)
    return ZoeDepthArch(
        hidden_size=d, num_layers=n_layers, num_heads=heads,
        intermediate_size=inter, patch_size=patch, image_size=g * patch,
        backbone_out_indices=taps, neck_hidden_sizes=neck_sizes,
        fusion_hidden_size=fusion, bin_configurations=bins)


class ZoeDepth(PortedNet):
    """ZoeDepthForDepthEstimation: ``model(img)`` with img from
    `preprocess`; the NK arch routes by `classify_domain`'s argmax, read on
    the host, unless ``bin_config_name`` is given."""

    arch_from_params = staticmethod(arch_from_params)

    def route(self, rgb: torch.Tensor) -> torch.Tensor:
        """The NK domain logits (n_configurations,) of one image."""
        p = self.params()
        with fp32(), torch.no_grad():
            taps, ph, pw = beit_backbone(p, rgb, self.arch)
            _, bottleneck = neck(p, taps, ph, pw, self.arch)
            return classify_domain(p, bottleneck, self.arch)[0]

    def forward(self, rgb: torch.Tensor,
                bin_config_name: str | None = None) -> torch.Tensor:
        p = self.params()
        taps, ph, pw = beit_backbone(p, rgb, self.arch)
        fused_list, bottleneck = neck(p, taps, ph, pw, self.arch)
        configs = self.arch.bin_configurations
        if len(configs) > 1 and bin_config_name is None:
            logits = classify_domain(p, bottleneck, self.arch)[0]
            bin_config_name = configs[int(torch.argmax(logits))].name
        return _metric_depth(p, fused_list, bottleneck, self.arch,
                             bin_config_name)

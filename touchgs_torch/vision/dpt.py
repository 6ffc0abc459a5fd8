"""Faithful DPT (Dense Prediction Transformer) depth model in PyTorch (port
of ``touchgs_tpu/vision/dpt.py``).

The architecture of HuggingFace ``DPTForDepthEstimation`` (Intel/dpt-large),
so a checkpoint ported by ``tools/port_weights.py`` loads as it is: a flat
npz keyed by the torch ``state_dict`` names, in the JAX package's layouts
(conv HWIO, linear (in, out)).  `PortedNet` turns them back into PyTorch's
layouts and holds them as parameters under those names.  The forward is
the JAX package's, in NCHW:

- ViT backbone: patch conv → [CLS] + pos-embed (bilinear off the native
  grid) → pre-LN blocks (LayerNorm eps 1e-12, exact GELU); taps are raw
  block outputs.
- Reassemble per tap: readout projection, 1×1 projection, resize (ConvT ×4,
  ConvT ×2, identity, 3×3 stride-2 conv with XLA's SAME padding, `conv`).
- Neck and fusion deepest → finest, ×2 bilinear (align_corners=True).
- Head: 3×3 conv → ×2 → 3×3 conv → ReLU → 1×1 conv → ReLU.

Attention is a matmul, a softmax and a matmul, as the JAX package writes
it.  `PortedNet.__call__` runs in full float32 (``eval.lpips_vgg.fp32``):
TF32 stays off on the card whatever the caller set (ROADMAP.md C1).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from touchgs_torch.eval.lpips_vgg import fp32


@dataclasses.dataclass(frozen=True)
class DPTArch:
    """Mirrors transformers.DPTConfig (ViT variant, readout_type='project')."""

    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 16
    image_size: int = 384           # pos-embed native size
    backbone_out_indices: Sequence[int] = (5, 11, 17, 23)
    neck_hidden_sizes: Sequence[int] = (256, 512, 1024, 1024)
    reassemble_factors: Sequence[float] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    layer_norm_eps: float = 1e-12


DPT_LARGE = DPTArch()


# ------------------------------------------------------------ weights ----

def torch_layout(name: str, arr: np.ndarray) -> np.ndarray:
    """Undo ``tools/port_weights.py::port_state_dict`` for one tensor: a 4-D
    ``.weight`` (HWIO, or (kh, kw, O, I) for a ConvTranspose) back to
    (O, I, kh, kw) resp. (I, O, kh, kw), a 2-D one from (in, out) to
    (out, in); everything else as it is."""
    if name.endswith(".weight"):
        if arr.ndim == 4:
            return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
        if arr.ndim == 2:
            return np.ascontiguousarray(arr.T)
    return arr


def load_ported_npz(path) -> dict:
    """A ported checkpoint (``tools/port_weights.py`` output) as numpy
    arrays in the file's layouts; `arch_from_params` reads them there."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


class PortedNet(nn.Module):
    """A ported checkpoint as ``nn.Parameter`` s named by the torch
    ``state_dict`` keys (a tree of plain modules, one per dotted prefix),
    in PyTorch's layouts, with no gradient (a linear weight as the
    transposed view of the file's (in, out) array: no copy, and F.linear
    reads either layout).  Subclasses give ``forward`` over the flat dict
    `params`."""

    def __init__(self, params: Mapping[str, np.ndarray], arch):
        super().__init__()
        self.arch = arch
        for name, arr in params.items():
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, nn.Module())
                mod = getattr(mod, part)
            arr = np.asarray(arr, np.float32)
            if name.endswith(".weight") and arr.ndim == 2:
                t = torch.from_numpy(arr).T
            else:
                t = torch.from_numpy(torch_layout(name, arr))
            mod.register_parameter(leaf, nn.Parameter(t, requires_grad=False))

    @classmethod
    def from_npz(cls, path, arch=None):
        params = load_ported_npz(path)
        return cls(params, arch if arch is not None
                   else cls.arch_from_params(params))

    def params(self) -> dict:
        return dict(self.named_parameters())

    def __call__(self, *args, **kwargs):
        with fp32(), torch.no_grad():
            return super().__call__(*args, **kwargs)


# ---------------------------------------------------------------- ops ----

def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool) -> torch.Tensor:
    """torch ``F.interpolate(mode='bilinear')`` on NCHW, which the JAX
    package's ``_resize_bilinear`` reproduces."""
    if x.shape[2:] == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=align_corners)


def conv(x: torch.Tensor, p: dict, name: str, stride: int = 1,
         padding: str = "SAME") -> torch.Tensor:
    """NCHW conv with XLA's padding: "VALID", or "SAME", whose total pad
    max((ceil(n / s) − 1)·s + k − n, 0) splits with the smaller half first,
    so a stride-2 3×3 pads (0, 1) on an even size, where ``conv2d(
    padding=1)`` would pad (1, 1) (ROADMAP.md C25).

    A stride-1 k×k (odd k > 1) is unfold + one matmul: in float32, cuDNN
    ran DPT-Large's 3×3 head conv at 192² as 33,024 GEMV launches with a
    17.6 GiB peak, 136 to 294 ms on an H100 against 0.85 ms unfolded
    (ROADMAP.md C27, PERF.md §6)."""
    w = p[f"{name}.weight"]
    b = p.get(f"{name}.bias")
    k = w.shape[2]
    if padding == "SAME" and stride == 1 and k > 1 and k % 2 == 1:
        return unfold_conv(x, w, b)
    return conv2d_xla(x, w, b, stride, padding)


def unfold_conv(x: torch.Tensor, w: torch.Tensor, b) -> torch.Tensor:
    """A stride-1 k×k conv (odd k) with SAME padding as unfold + one
    matmul."""
    n, c, h, wd = x.shape
    k = w.shape[2]
    cols = F.unfold(x, k, padding=k // 2)             # (n, c·k·k, h·w)
    y = (w.reshape(w.shape[0], -1) @ cols).reshape(n, -1, h, wd)
    return y if b is None else y + b[:, None, None]


def conv2d_xla(x: torch.Tensor, w: torch.Tensor, b, stride: int = 1,
               padding: str = "SAME") -> torch.Tensor:
    """``F.conv2d`` padded as XLA pads "SAME" (see `conv`), or "VALID"."""
    if padding == "SAME":
        pads = []
        for n, k in ((x.shape[3], w.shape[3]), (x.shape[2], w.shape[2])):
            total = max((-(-n // stride) - 1) * stride + k - n, 0)
            pads += [total // 2, total - total // 2]
        if pads[0] == pads[1] and pads[2] == pads[3]:
            return F.conv2d(x, w, b, stride=stride, padding=(pads[2], pads[0]))
        x = F.pad(x, pads)
    return F.conv2d(x, w, b, stride=stride)


def conv_transpose(x: torch.Tensor, p: dict, name: str,
                   factor: int) -> torch.Tensor:
    """``ConvTranspose2d(k=stride=factor, padding=0)``."""
    return F.conv_transpose2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                              stride=factor)


def linear(x: torch.Tensor, p: dict, name: str) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p.get(f"{name}.bias"))


def layernorm(x: torch.Tensor, p: dict, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              num_heads: int, bias=None) -> torch.Tensor:
    """(n, t, d) projections → (n, t, d) context: matmul, softmax, matmul."""
    n, t, d = q.shape
    hd = d // num_heads

    def split(a):
        return a.reshape(n, t, num_heads, hd).transpose(1, 2)

    scores = split(q) @ split(k).transpose(-1, -2) / math.sqrt(hd)
    if bias is not None:
        scores = scores + bias
    ctx = torch.softmax(scores, dim=-1) @ split(v)
    return ctx.transpose(1, 2).reshape(n, t, d)


def tokens_to_map(tokens: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """(1, ph·pw, D) → (1, D, ph, pw)."""
    return tokens.transpose(1, 2).reshape(1, -1, ph, pw)


def patch_embed(rgb: torch.Tensor, p: dict, name: str, patch: int):
    """(H, W, 3) → (1, ph·pw, D) tokens, ph, pw."""
    x = conv(rgb.permute(2, 0, 1)[None], p, name, stride=patch,
             padding="VALID")
    return x.flatten(2).transpose(1, 2), x.shape[2], x.shape[3]


def reassemble_resize(h: torch.Tensor, p: dict, i: int,
                      factor: float) -> torch.Tensor:
    name = f"neck.reassemble_stage.layers.{i}.resize"
    if factor > 1:
        return conv_transpose(h, p, name, int(factor))
    if factor < 1:
        return conv(h, p, name, stride=int(round(1 / factor)))
    return h


def residual_unit(x: torch.Tensor, p: dict, prefix: str) -> torch.Tensor:
    """Pre-activation residual layer: ReLU→conv1→ReLU→conv2, plus input."""
    h = conv(torch.relu(x), p, f"{prefix}.convolution1")
    h = conv(torch.relu(h), p, f"{prefix}.convolution2")
    return x + h


# ------------------------------------------------------------ forward ----

def _vit_block(x, p, prefix, arch: DPTArch):
    h = layernorm(x, p, f"{prefix}.layernorm_before", arch.layer_norm_eps)
    a = f"{prefix}.attention.attention"
    ctx = attention(linear(h, p, f"{a}.query"), linear(h, p, f"{a}.key"),
                    linear(h, p, f"{a}.value"), arch.num_heads)
    x = x + linear(ctx, p, f"{prefix}.attention.output.dense")
    h = layernorm(x, p, f"{prefix}.layernorm_after", arch.layer_norm_eps)
    h = F.gelu(linear(h, p, f"{prefix}.intermediate.dense"))
    return x + linear(h, p, f"{prefix}.output.dense")


def _pos_embed(p, ph, pw, arch: DPTArch):
    """The native-grid position embeddings, bilinear to (ph, pw)
    (align_corners=False)."""
    pos = p["dpt.embeddings.position_embeddings"]  # (1, 1+g*g, D)
    g = arch.image_size // arch.patch_size
    cls_pos, grid = pos[:, :1], pos[:, 1:]
    if (ph, pw) != (g, g):
        grid = resize_bilinear(tokens_to_map(grid, g, g), ph, pw,
                               align_corners=False)
        grid = grid.flatten(2).transpose(1, 2)
    return torch.cat([cls_pos, grid], dim=1)


def readout_project(t, p, i, ph, pw):
    """[tokens ‖ CLS] → Linear → GELU → (1, D, ph, pw)."""
    cls_tok, tokens = t[:, :1], t[:, 1:]
    h = torch.cat([tokens, cls_tok.expand_as(tokens)], dim=-1)
    h = F.gelu(linear(h, p, f"neck.reassemble_stage.readout_projects.{i}.0"))
    return tokens_to_map(h, ph, pw)


def dpt_forward(p: dict, rgb: torch.Tensor,
                arch: DPTArch = DPT_LARGE) -> torch.Tensor:
    """(H, W, 3) preprocessed image → (H', W') predicted depth; H, W
    multiples of ``arch.patch_size``."""
    x, ph, pw = patch_embed(rgb, p, "dpt.embeddings.patch_embeddings."
                            "projection", arch.patch_size)
    cls = p["dpt.embeddings.cls_token"].expand(1, 1, arch.hidden_size)
    x = torch.cat([cls, x], dim=1) + _pos_embed(p, ph, pw, arch)

    taps = []
    for i in range(arch.num_layers):
        x = _vit_block(x, p, f"dpt.encoder.layer.{i}", arch)
        if i in arch.backbone_out_indices:
            taps.append(x)

    feats = []
    for i, t in enumerate(taps):
        h = readout_project(t, p, i, ph, pw)
        h = conv(h, p, f"neck.reassemble_stage.layers.{i}.projection")
        h = reassemble_resize(h, p, i, arch.reassemble_factors[i])
        feats.append(conv(h, p, f"neck.convs.{i}"))

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

    y = conv(fused, p, "head.head.0")
    y = resize_bilinear(y, y.shape[2] * 2, y.shape[3] * 2, align_corners=True)
    y = torch.relu(conv(y, p, "head.head.2"))
    y = torch.relu(conv(y, p, "head.head.4"))
    return y[0, 0]


def to_image(rgb, device) -> torch.Tensor:
    """An (H, W, 3) uint8 or float image as float32 on ``device``, scaled
    by 1/255 when its maximum exceeds 1.5 (read on the host)."""
    img = torch.as_tensor(np.asarray(rgb, np.float32), device=device)
    if float(np.max(rgb)) > 1.5:
        img = img / 255.0
    return img


def preprocess(rgb, size: int = 384, device=None) -> torch.Tensor:
    """DPTImageProcessor equivalent: resize to (size, size), scale 1/255,
    normalize mean=std=0.5."""
    img = to_image(rgb, device).permute(2, 0, 1)[None]
    img = resize_bilinear(img, size, size, align_corners=False)[0]
    return ((img - 0.5) / 0.5).permute(1, 2, 0)


def arch_from_params(params: dict) -> DPTArch:
    """The DPTArch of a ported param dict in the file's layouts (so any DPT
    size loads)."""
    d = params["dpt.embeddings.cls_token"].shape[-1]
    n_layers = 1 + max(
        int(k.split(".")[3]) for k in params if k.startswith("dpt.encoder.layer.")
    )
    inter = params["dpt.encoder.layer.0.intermediate.dense.weight"].shape[-1]
    patch = params["dpt.embeddings.patch_embeddings.projection.weight"].shape[0]
    n_tokens = params["dpt.embeddings.position_embeddings"].shape[1] - 1
    image_size = int(round(n_tokens ** 0.5)) * patch
    neck = tuple(
        params[f"neck.reassemble_stage.layers.{i}.projection.weight"].shape[-1]
        for i in range(4)
    )
    fusion = params["neck.convs.0.weight"].shape[-1]
    # taps: evenly spaced (HF convention for the ViT backbone sizes)
    step = n_layers // 4
    taps = tuple(step * (i + 1) - 1 for i in range(4))
    if n_layers == 24:
        taps = (5, 11, 17, 23)  # dpt-large's published indices
    # heads: smallest divisor giving head_dim 64 where possible
    heads = max(1, d // 64)
    return DPTArch(hidden_size=d, num_layers=n_layers, num_heads=heads,
                   intermediate_size=inter, patch_size=patch,
                   image_size=image_size, backbone_out_indices=taps,
                   neck_hidden_sizes=neck, fusion_hidden_size=fusion)


class DPT(PortedNet):
    """DPTForDepthEstimation: ``model(img)`` with img from `preprocess`."""

    arch_from_params = staticmethod(arch_from_params)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return dpt_forward(self.params(), rgb, self.arch)

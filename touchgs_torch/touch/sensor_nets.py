"""DenseTact sensor inference nets in PyTorch, tactile image → depth / force
(port of ``touchgs_tpu/touch/sensor_nets.py``).

- `TouchDepthNet`: tactile RGB → per-pixel depth in [0, 255] like
  ``getDepth`` (``Img2Depth/img2depthforce.py:23-29``); a compact stand-in.
  With a ported checkpoint `DenseTactSensor` runs the faithful DenseNet-161
  encoder-decoder instead (`touch.densetact_nets.DenseDepth`).
- `ForceNet`: tactile RGB → 6-DoF wrench in [0, 1], denormalized by
  ``getForce``'s ranges (:31-39); a compact stand-in for the faithful
  ``DenseNet_Force`` (`touch.densetact_nets.DenseNetForce`).
- `normalize_tactile`: ``transform_image`` (:13-21), /255 when the image
  is in [0, 255], then the ImageNet mean and std.

The compact nets keep flax's defaults, which are not PyTorch's: SAME
convolutions (a stride-2 3×3 pads (0, 1) on an even size, ROADMAP.md C25),
GroupNorm and LayerNorm eps 1e-6, the tanh GELU, multi-head attention with
the query scaled by 1/√head_dim, and ``jax.image.resize`` (`utils.resize`,
C24).  Without weights they are drawn from a ``torch.Generator`` seeded
with ``seed``, with flax's initializers, not from flax's ``PRNGKey(seed)``
(ROADMAP.md C28); `load_flax_params` carries a flax parameter tree (as
numpy) across.  `DenseTactSensor` runs on the card unless the caller
passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from touchgs_torch.eval.lpips_vgg import fp32
from touchgs_torch.touch import densetact_nets as dt
from touchgs_torch.utils.resize import resize
from touchgs_torch.vision import dpt
from touchgs_torch.vision.monodepth import _Block, _from_flax

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# getForce denormalization constants (img2depthforce.py:35-37)
FORCE_RESIDUAL = np.array([5.5, 5.5, 11.0, 0.25, 0.25, 0.05], np.float32)
FORCE_RANGE = np.array([11.0, 11.0, 14.0, 0.5, 0.5, 0.1], np.float32)


def normalize_tactile(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB in [0, 255] or [0, 1] → ImageNet-normalized; the
    /255 applies to an image whose maximum exceeds 1.5 (a ``torch.where``,
    each image of a batch on its own)."""
    img = img.to(torch.float32)
    big = img.amax(dim=(-3, -2, -1), keepdim=True) > 1.5
    img = torch.where(big, img / 255.0, img)
    mean = torch.as_tensor(_IMAGENET_MEAN, device=img.device)
    std = torch.as_tensor(_IMAGENET_STD, device=img.device)
    return (img - mean) / std


def _conv(x: torch.Tensor, m: nn.Conv2d, stride: int = 1) -> torch.Tensor:
    """flax ``nn.Conv`` (SAME) with ``m``'s weights (`vision.dpt.conv`)."""
    return dpt.conv(x, {"c.weight": m.weight, "c.bias": m.bias}, "c", stride)


def _batched(img: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """(H, W, 3) or (B, H, W, 3) → normalized NCHW, and whether it was one
    image."""
    single = img.ndim == 3
    x = normalize_tactile(img[None] if single else img)
    return x.permute(0, 3, 1, 2), single


class _DenseBlock(nn.Module):
    """flax ``_DenseBlock``: ``layers`` × (GroupNorm(8) → ReLU → 3×3 conv
    of ``growth`` channels, concatenated)."""

    def __init__(self, cin: int, growth: int, layers: int = 3):
        super().__init__()
        self.norms = nn.ModuleList([nn.GroupNorm(8, cin + i * growth,
                                                 eps=1e-6)
                                    for i in range(layers)])
        self.convs = nn.ModuleList([nn.Conv2d(cin + i * growth, growth, 3)
                                    for i in range(layers)])

    def forward(self, x):
        for norm, conv in zip(self.norms, self.convs):
            x = torch.cat([x, _conv(torch.relu(norm(x)), conv)], dim=1)
        return x


class TouchDepthNet(nn.Module):
    """Tactile RGB (H, W, 3) or (B, H, W, 3) → depth (H, W) / (B, H, W) in
    [0, 255].  ``conv[i]`` is flax's ``Conv_i``: 0-3 the stride-2 encoder,
    4-7 the decoder, 8 and 9 the head; ``blocks[i]`` is ``_DenseBlock_i``."""

    def __init__(self, base: int = 32):
        super().__init__()
        widths = (base, base * 2, base * 4, base * 8)
        enc, blocks, c = [], [], 3
        for w in widths:
            enc.append(nn.Conv2d(c, w, 3))
            blocks.append(_DenseBlock(w, w // 4))
            c = w + 3 * (w // 4)
        skips = [w + 3 * (w // 4) for w in widths]
        dec = []
        for w, s in zip(reversed(widths), reversed(skips)):
            dec.append(nn.Conv2d(c + s, w, 3))
            c = w
        self.conv = nn.ModuleList(enc + dec + [nn.Conv2d(c, base, 3),
                                               nn.Conv2d(base, 1, 1)])
        self.blocks = nn.ModuleList(blocks)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x, single = _batched(img)
        B, _, H, W = x.shape
        skips = []
        for i, block in enumerate(self.blocks):
            x = block(_conv(x, self.conv[i], stride=2))
            skips.append(x)
        for j, s in enumerate(reversed(skips)):
            x = resize(x, (B, x.shape[1]) + tuple(s.shape[2:]), "bilinear")
            x = torch.relu(_conv(torch.cat([x, s], dim=1), self.conv[4 + j]))
        x = resize(x, (B, x.shape[1], H, W), "bilinear")
        x = torch.relu(_conv(x, self.conv[8]))
        out = torch.sigmoid(_conv(x, self.conv[9])[:, 0]) * 255.0
        return out[0] if single else out


class ForceNet(nn.Module):
    """Tactile RGB → normalized 6-vector in [0, 1] (`denormalize_force`):
    four stride-2 convs with tanh GELU, ``blocks`` attention blocks over the
    tokens, a global pool, Dense → GELU → Dense → sigmoid."""

    def __init__(self, dim: int = 128, blocks: int = 4, heads: int = 4):
        super().__init__()
        self.conv = nn.ModuleList([nn.Conv2d(3 if i == 0 else dim, dim, 3)
                                   for i in range(4)])
        self.blocks = nn.ModuleList([_Block(dim, heads)
                                     for _ in range(blocks)])
        self.head = nn.ModuleList([nn.Linear(dim, dim), nn.Linear(dim, 6)])

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x, single = _batched(img)
        for conv in self.conv:
            x = F.gelu(_conv(x, conv, stride=2), approximate="tanh")
        t = x.flatten(2).transpose(1, 2)
        for block in self.blocks:
            t = block(t)
        t = F.gelu(self.head[0](t.mean(dim=1)), approximate="tanh")
        out = torch.sigmoid(self.head[1](t))
        return out[0] if single else out


def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initializers drawn from ``generator``: every kernel
    lecun-normal (truncated at 2σ, fan-in = its inputs), biases 0, norms
    (1, 0)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2:
                std = (1.0 / p[0].numel()) ** 0.5 / .87962566103423978
                nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
            elif name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.zero_()
    return model


# flax name → (the port's name, layout), per net
_DEPTH_NAMES = (
    (r"params/Conv_(\d+)/kernel", r"conv.\1.weight", "conv"),
    (r"params/Conv_(\d+)/bias", r"conv.\1.bias", None),
    (r"params/_DenseBlock_(\d+)/GroupNorm_(\d+)/scale",
     r"blocks.\1.norms.\2.weight", None),
    (r"params/_DenseBlock_(\d+)/GroupNorm_(\d+)/bias",
     r"blocks.\1.norms.\2.bias", None),
    (r"params/_DenseBlock_(\d+)/Conv_(\d+)/kernel",
     r"blocks.\1.convs.\2.weight", "conv"),
    (r"params/_DenseBlock_(\d+)/Conv_(\d+)/bias", r"blocks.\1.convs.\2.bias",
     None),
)
_ATT = r"params/_AttnBlock_(\d+)/MultiHeadDotProductAttention_0"
_FORCE_NAMES = (
    (r"params/Conv_(\d+)/kernel", r"conv.\1.weight", "conv"),
    (r"params/Conv_(\d+)/bias", r"conv.\1.bias", None),
    (r"params/_AttnBlock_(\d+)/LayerNorm_(\d)/scale",
     r"blocks.\1.norm.\2.weight", None),
    (r"params/_AttnBlock_(\d+)/LayerNorm_(\d)/bias", r"blocks.\1.norm.\2.bias",
     None),
    (_ATT + r"/(query|key|value)/kernel", r"blocks.\1.\2.weight", "qkv"),
    (_ATT + r"/(query|key|value)/bias", r"blocks.\1.\2.bias", "flat"),
    (_ATT + r"/out/kernel", r"blocks.\1.out.weight", "out"),
    (_ATT + r"/out/bias", r"blocks.\1.out.bias", None),
    # flax names the block's Dense layers in the order they are built: the
    # outer Dense(dim) is Dense_0, the inner Dense(4·dim) Dense_1
    (r"params/_AttnBlock_(\d+)/Dense_0/kernel", r"blocks.\1.dense.1.weight",
     "dense"),
    (r"params/_AttnBlock_(\d+)/Dense_0/bias", r"blocks.\1.dense.1.bias", None),
    (r"params/_AttnBlock_(\d+)/Dense_1/kernel", r"blocks.\1.dense.0.weight",
     "dense"),
    (r"params/_AttnBlock_(\d+)/Dense_1/bias", r"blocks.\1.dense.0.bias", None),
    (r"params/Dense_(\d)/kernel", r"head.\1.weight", "dense"),
    (r"params/Dense_(\d)/bias", r"head.\1.bias", None),
)


def flatten_tree(tree: Mapping, prefix: str = "") -> dict:
    """A nested dict of arrays → {'a/b/c': array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def load_flax_params(model: nn.Module, tree: Mapping,
                     names: tuple | None = None) -> nn.Module:
    """Copy a flax parameter tree (nested dicts of numpy arrays, as
    ``flax.linen.Module.init`` returns them) into ``model``, each leaf by its
    flax name; every parameter of the model must be given."""
    if names is None:
        names = {TouchDepthNet: _DEPTH_NAMES, ForceNet: _FORCE_NAMES}[
            type(model)]
    own = dict(model.named_parameters())
    seen = set()
    with torch.no_grad():
        for key, arr in flatten_tree(tree).items():
            for pattern, repl, layout in names:
                if re.fullmatch(pattern, key):
                    name = re.sub(pattern, repl, key)
                    break
            else:
                raise KeyError(f"no parameter for flax leaf {key}")
            a = np.array(_from_flax(layout, arr), np.float32)
            if a.shape != tuple(own[name].shape):
                raise ValueError(f"{key} has shape {a.shape}, {name} "
                                 f"{tuple(own[name].shape)}")
            own[name].copy_(torch.from_numpy(a))
            seen.add(name)
    missing = set(own) - seen
    if missing:
        raise KeyError(f"the tree lacks {sorted(missing)}")
    return model


def denormalize_force(pred: torch.Tensor) -> torch.Tensor:
    """``getForce``: normalized [0, 1] → N / Nm."""
    return (pred * torch.as_tensor(FORCE_RANGE, device=pred.device)
            - torch.as_tensor(FORCE_RESIDUAL, device=pred.device))


def resolve_device(device) -> torch.device:
    """``cuda`` unless the caller names a device; a CUDA device raises
    without a GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


@dataclasses.dataclass
class DenseTactSensor:
    """Runtime wrapper: the per-sensor calibration remap and both nets
    (``RunCamera``, cam_ros.py): `rectify` applies the pixel-index remap
    (cam_ros.py:64-65, 230-250), then depth and force inference.  A
    weights file whose keys hold ``encoder.densenet.features.conv0.weight``
    runs the faithful net; otherwise the compact nets, random from
    ``seed``."""

    input_size: int = 640
    seed: int = 0
    calib_index: Optional[np.ndarray] = None  # flat remap indices
    depth_weights: Optional[str] = None  # ported DenseDepth npz
    force_weights: Optional[str] = None  # ported DenseNet_Force npz
    device: Optional[str | torch.device] = None  # cuda unless given

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._faithful_depth = bool(
            self.depth_weights and self._is_ported(self.depth_weights))
        self._faithful_force = bool(
            self.force_weights and self._is_ported(self.force_weights))
        g = torch.Generator().manual_seed(self.seed)
        if self._faithful_depth:
            self.depth_net = dt.DenseDepth.from_npz(self.depth_weights)
        else:
            self.depth_net = flax_init_(TouchDepthNet(), g)
        if self._faithful_force:
            self.force_net = dt.DenseNetForce.from_npz(self.force_weights)
        else:
            self.force_net = flax_init_(ForceNet(), g)
        self.depth_net = self.depth_net.to(self.device).eval()
        self.force_net = self.force_net.to(self.device).eval()

    @staticmethod
    def _is_ported(path) -> bool:
        try:
            with np.load(path) as data:
                return dt.DEPTH_KEY in data.files
        except (OSError, ValueError):
            return False

    def rectify(self, raw: np.ndarray) -> np.ndarray:
        """Mask-index fisheye rectification + crop (rectifyimg contract)."""
        if self.calib_index is None:
            return raw
        flat = raw.reshape(-1, raw.shape[-1])
        out = flat[self.calib_index.ravel()]
        side = int(np.sqrt(self.calib_index.size))
        return out.reshape(side, side, raw.shape[-1])

    def _image(self, img: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img, np.float32), device=self.device)

    def depth(self, img: np.ndarray) -> torch.Tensor:
        """The depth net's float output on the device."""
        x = self._image(img)
        with fp32(), torch.no_grad():
            if self._faithful_depth:
                # cam_ros.py:113: DenseDepth(max_depth=256) on the
                # transform_image-normalized image
                return self.depth_net(normalize_tactile(x))
            return self.depth_net(x)

    def force(self, img: np.ndarray) -> torch.Tensor:
        """The force net's normalized 6-vector on the device."""
        x = self._image(img)
        with fp32(), torch.no_grad():
            if self._faithful_force:
                return self.force_net(normalize_tactile(x))
            return self.force_net(x)

    def get_depth(self, img: np.ndarray) -> np.ndarray:
        """uint8 depth image in [0, 255] (getDepth contract; truncated)."""
        return np.uint8(np.clip(self.depth(img).cpu().numpy(), 0, 255))

    def get_force(self, img: np.ndarray) -> np.ndarray:
        """6-DoF wrench [Fx, Fy, Fz, Tx, Ty, Tz] in N / Nm."""
        return denormalize_force(self.force(img)).cpu().numpy()

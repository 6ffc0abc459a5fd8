"""Monocular depth estimation: the compact DPT trunk and the pipeline
interface (port of ``touchgs_tpu/vision/monodepth.py``).

``VisualPipeline`` keeps the reference's model switch (``model_type`` in
{'dpt', 'zoe', 'depth_anything'}, ``run_zoe_depth.py:146-159``) behind one
interface and writes uint16-mm PNGs named after the RGB files, through the
port's own PNG codec (``data/png.py``; ROADMAP.md C22).  A ported
checkpoint's npz picks the faithful net by its keys (`_detect_ported`);
without one every ``model_type`` falls back to `DPTDepthModel`, the
compact trunk, random or loaded from the JAX package's flax npz
(`load_npz_weights`).  Alignment to metric depth happens downstream in
``touch.fusion.align_vision_depth``.

The trunk keeps flax's defaults: tanh GELU, LayerNorm eps 1e-6, SAME
convolutions, and ``jax.image.resize`` (`utils.resize`).  Its random
weights come from a ``torch.Generator`` seeded with ``seed``, not from
flax's ``PRNGKey(seed)``, so without a weights file the two packages'
random trunks differ (ROADMAP.md C23).  The pipeline runs on the card
unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from touchgs_torch.data.depth_io import write_depth_mm
from touchgs_torch.data.png import read_rgb
from touchgs_torch.eval.lpips_vgg import fp32
from touchgs_torch.utils.resize import resize
from touchgs_torch.vision.dpt import attention, conv, to_image


class _Block(nn.Module):
    """flax ``_Block``: LN → multi-head attention → LN → Dense·4 → tanh
    GELU → Dense, both residual."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm = nn.ModuleList([nn.LayerNorm(dim, eps=1e-6)
                                   for _ in range(2)])
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.dense = nn.ModuleList([nn.Linear(dim, 4 * dim),
                                    nn.Linear(4 * dim, dim)])

    def forward(self, x):
        h = self.norm[0](x)
        ctx = attention(self.query(h), self.key(h), self.value(h), self.heads)
        x = x + self.out(ctx)
        h = self.dense[0](self.norm[1](x))
        return x + self.dense[1](F.gelu(h, approximate="tanh"))


class DPTDepthModel(nn.Module):
    """Compact DPT: ViT encoder with 4 tap points + fusion decoder.  The
    conv at flax index i is ``conv[i]`` (``Conv_0`` the patch embedding,
    ``Conv_1``-``Conv_4`` the reassembly, ``Conv_5``-``Conv_10`` the fusion,
    ``Conv_11``, ``Conv_12`` the head); ``image_size`` fixes the number of
    position embeddings, as flax's init does."""

    def __init__(self, patch: int = 16, dim: int = 192, depth_blocks: int = 8,
                 heads: int = 3, features: int = 96,
                 image_size: tuple[int, int] = (384, 384)):
        super().__init__()
        self.patch, self.features = patch, features
        n_tokens = (image_size[0] // patch) * (image_size[1] // patch)
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, dim))
        self.blocks = nn.ModuleList([_Block(dim, heads)
                                     for _ in range(depth_blocks)])
        shapes = ([(dim, 3, patch)] + [(features, dim, 3)] * 4
                  + [(features, features, 3)] * 6
                  + [(features // 2, features, 3), (1, features // 2, 1)])
        self.conv = nn.ModuleList([nn.Conv2d(i, o, k) for o, i, k in shapes])

    def init_random(self, seed: int = 0) -> "DPTDepthModel":
        """flax's initializers, drawn from a seeded ``torch.Generator``:
        kernels lecun-normal (truncated at 2σ), biases 0, LayerNorms (1, 0),
        the position embeddings N(0, 0.02)."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name == "pos_embed":
                    p.normal_(0.0, 0.02, generator=g)
                elif ".norm." in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith("weight"):
                    std = (1.0 / p[0].numel()) ** 0.5 / .87962566103423978
                    nn.init.trunc_normal_(p, 0.0, std, -2 * std, 2 * std,
                                          generator=g)
                else:
                    p.zero_()
        return self

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) in [0, 1] → (H, W) depth ≥ 0."""
        H, W, _ = rgb.shape
        P, Fh = self.patch, self.features
        p = dict(self.named_parameters())
        x = conv(rgb.permute(2, 0, 1)[None], p, "conv.0", stride=P)
        ph, pw = x.shape[2:]
        x = x.flatten(2).transpose(1, 2) + self.pos_embed

        taps = []
        tap_every = max(1, len(self.blocks) // 4)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if (i + 1) % tap_every == 0 and len(taps) < 4:
                taps.append(x)
        while len(taps) < 4:
            taps.append(x)

        # reassemble: tokens → spatial maps at 4 scales
        feats = []
        for i, t in enumerate(taps):
            f = conv(t.transpose(1, 2).reshape(1, -1, ph, pw), p,
                     f"conv.{1 + i}")
            scale = 2 ** (3 - i)
            feats.append(resize(f, (1, Fh, ph * 8 // scale, pw * 8 // scale),
                                "bilinear"))

        # fusion decoder with residual conv units
        y = feats[3]
        for j, i in enumerate((2, 1, 0)):
            y = resize(y, feats[i].shape, "bilinear") + feats[i]
            h = torch.relu(conv(torch.relu(y), p, f"conv.{5 + 2 * j}"))
            y = y + conv(h, p, f"conv.{6 + 2 * j}")

        y = resize(y, (1, Fh, H, W), "bilinear")
        y = torch.relu(conv(y, p, "conv.11"))
        return torch.relu(conv(y, p, "conv.12")[0, 0])


# flax name of each trunk leaf → (the port's name, layout from flax's)
_FLAX_NAMES = (
    (r"params/Conv_(\d+)/kernel", r"conv.\1.weight", "conv"),
    (r"params/Conv_(\d+)/bias", r"conv.\1.bias", None),
    (r"params/pos_embed", "pos_embed", None),
    (r"params/_Block_(\d+)/LayerNorm_(\d)/scale", r"blocks.\1.norm.\2.weight",
     None),
    (r"params/_Block_(\d+)/LayerNorm_(\d)/bias", r"blocks.\1.norm.\2.bias",
     None),
    (r"params/_Block_(\d+)/MultiHeadDotProductAttention_0/(query|key|value)"
     r"/kernel", r"blocks.\1.\2.weight", "qkv"),
    (r"params/_Block_(\d+)/MultiHeadDotProductAttention_0/(query|key|value)"
     r"/bias", r"blocks.\1.\2.bias", "flat"),
    (r"params/_Block_(\d+)/MultiHeadDotProductAttention_0/out/kernel",
     r"blocks.\1.out.weight", "out"),
    (r"params/_Block_(\d+)/MultiHeadDotProductAttention_0/out/bias",
     r"blocks.\1.out.bias", None),
    (r"params/_Block_(\d+)/Dense_(\d)/kernel", r"blocks.\1.dense.\2.weight",
     "dense"),
    (r"params/_Block_(\d+)/Dense_(\d)/bias", r"blocks.\1.dense.\2.bias",
     None),
)


def _from_flax(layout, a: np.ndarray) -> np.ndarray:
    if layout == "conv":                 # HWIO → OIHW
        return a.transpose(3, 2, 0, 1)
    if layout == "qkv":                  # (dim, heads, hd) → (heads·hd, dim)
        return a.reshape(a.shape[0], -1).T
    if layout == "flat":                 # (heads, hd) → (heads·hd,)
        return a.reshape(-1)
    if layout == "out":                  # (heads, hd, dim) → (dim, heads·hd)
        return a.reshape(-1, a.shape[-1]).T
    if layout == "dense":                # (in, out) → (out, in)
        return a.T
    return a


def _to_flax(layout, t: np.ndarray, heads: int) -> np.ndarray:
    if layout == "conv":
        return t.transpose(2, 3, 1, 0)
    if layout == "qkv":
        return t.T.reshape(t.shape[1], heads, -1)
    if layout == "flat":
        return t.reshape(heads, -1)
    if layout == "out":
        return t.T.reshape(heads, -1, t.shape[0])
    if layout == "dense":
        return t.T
    return t


def _map_name(flax_name: str):
    for pattern, repl, layout in _FLAX_NAMES:
        if re.fullmatch(pattern, flax_name):
            return re.sub(pattern, repl, flax_name), layout
    return None, None


def load_npz_weights(model: DPTDepthModel, path: str | Path) -> DPTDepthModel:
    """Load the JAX package's flat trunk npz (``save_npz_weights``:
    '/'-joined flax names) into ``model``, each leaf by its flax name and
    index (``Conv_10`` is conv[10], not the third in sorted order); leaves
    the file lacks keep their values, names the trunk lacks are ignored,
    as in the JAX package."""
    own = dict(model.named_parameters())
    with np.load(path) as data, torch.no_grad():
        for key in data.files:
            name, layout = _map_name(key)
            if name is None or name not in own:
                continue
            arr = np.ascontiguousarray(_from_flax(layout, data[key]))
            if arr.shape != tuple(own[name].shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, the "
                                 f"trunk's {name} {tuple(own[name].shape)}")
            own[name].copy_(torch.from_numpy(arr))
    return model


def save_npz_weights(model: DPTDepthModel, path: str | Path) -> None:
    """The trunk as the JAX package's flat npz (flax names, flax layouts)."""
    heads = model.blocks[0].heads
    own = {k: v.detach().cpu().numpy() for k, v in model.named_parameters()}
    flat = {}
    for key in _flax_keys(model):
        name, layout = _map_name(key)
        flat[key] = np.ascontiguousarray(_to_flax(layout, own[name], heads))
    np.savez(path, **flat)


def _flax_keys(model: DPTDepthModel) -> list:
    keys = ["params/pos_embed"]
    for i in range(len(model.conv)):
        keys += [f"params/Conv_{i}/kernel", f"params/Conv_{i}/bias"]
    for b in range(len(model.blocks)):
        pre = f"params/_Block_{b}"
        for k in range(2):
            keys += [f"{pre}/LayerNorm_{k}/scale", f"{pre}/LayerNorm_{k}/bias",
                     f"{pre}/Dense_{k}/kernel", f"{pre}/Dense_{k}/bias"]
        for m in ("query", "key", "value", "out"):
            keys += [f"{pre}/MultiHeadDotProductAttention_0/{m}/kernel",
                     f"{pre}/MultiHeadDotProductAttention_0/{m}/bias"]
    return keys


@dataclasses.dataclass
class VisualPipeline:
    """run_zoe_depth.py `VisualPipeline` equivalent: one interface over the
    monocular-depth model zoo, batch prediction to uint16-mm PNGs."""

    model_type: str = "dpt"   # 'dpt' | 'zoe' | 'depth_anything'
    image_size: tuple[int, int] = (384, 384)  # model input (H, W)
    weights_path: Optional[str] = None
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.model_type not in ("dpt", "zoe", "depth_anything"):
            raise ValueError(f"unknown model_type {self.model_type!r}")
        self.device = torch.device(self.device)
        self._faithful = False
        kind = (self._detect_ported(self.weights_path) if self.weights_path
                else None)
        if kind is not None:
            from touchgs_torch.vision import depth_anything, dpt, zoedepth

            module = {"dpt": dpt, "zoedepth": zoedepth,
                      "depth_anything": depth_anything}[kind]
            net = {"dpt": dpt.DPT, "zoedepth": zoedepth.ZoeDepth,
                   "depth_anything": depth_anything.DepthAnything}[kind]
            self.model = net.from_npz(self.weights_path).to(self.device)
            self._faithful = True
            self._dpt_preprocess = module.preprocess
            return
        # fallback: compact trunk, random or npz-pytree weights; all three
        # model_types share it when no ported checkpoint is supplied
        self.model = DPTDepthModel(image_size=self.image_size).init_random(
            self.seed)
        if self.weights_path:
            load_npz_weights(self.model, self.weights_path)
        self.model = self.model.to(self.device)

    @staticmethod
    def _detect_ported(path) -> str | None:
        """Classify a ported npz by its torch state_dict keys."""
        try:
            with np.load(path) as data:
                files = set(data.files)
        except Exception:
            return None
        if "dpt.embeddings.cls_token" in files:
            return "dpt"
        if any(k.startswith("metric_head.") for k in files):
            return "zoedepth"
        if "backbone.embeddings.cls_token" in files and any(
                k.startswith("neck.reassemble_stage.") for k in files):
            return "depth_anything"
        return None

    def predict_depth(self, rgb: np.ndarray) -> np.ndarray:
        """(H, W, 3) uint8/float image → (H, W) float32 depth (model units;
        metric alignment happens in fusion)."""
        orig_h, orig_w = rgb.shape[:2]
        with fp32(), torch.no_grad():
            if self._faithful:
                img = self._dpt_preprocess(rgb, size=max(self.image_size),
                                           device=self.device)
            else:
                mh, mw = self.image_size
                img = resize(to_image(rgb, self.device), (mh, mw, 3),
                             "bilinear")
            depth = self.model(img)
            depth = resize(depth, (orig_h, orig_w), "bicubic")
        return torch.clamp(depth, min=0.0).cpu().numpy()

    def predict(self, image_dir: str | Path, output_dir: str | Path) -> None:
        """Directory batch prediction (run_zoe_depth.py:93-116 contract):
        writes `<output_dir>/<rgb_name>.png` uint16-mm depth per image."""
        image_dir = Path(image_dir)
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        for img_path in sorted(image_dir.iterdir()):
            if img_path.suffix.lower() not in (".png", ".jpg", ".jpeg"):
                continue
            depth = self.predict_depth(read_rgb(img_path))
            write_depth_mm(output_dir / f"{img_path.stem}.png", depth)

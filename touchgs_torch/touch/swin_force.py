"""Faithful SwinV2 force-net trunk (STForce) in PyTorch (port of
``touchgs_tpu/touch/swin_force.py``).

The reference's vendored SwinTransformerV2 + force head
(``Img2Depth/networks/swin_transformer_force.py``, configured at
``networks/STForce.py:40-86``: embed 192, depths [2, 2, 18, 2], heads
[6, 12, 24, 48], window 20, img 640; head Linear 1000→500→6).  The params
are the flat torch ``state_dict`` names under ``backbone.`` and
``force_head.``, loaded from the ported npz by `vision.dpt.PortedNet`.

Kept as the JAX package has them:

- res-post-norm blocks, ``x + norm1(attn(x))`` then ``x + norm2(mlp(x))``;
- cosine attention, the norms clamped at 1e-12, times
  ``exp(min(logit_scale, log 100))``;
- the continuous position bias ``16·sigmoid(cpb_mlp(table))[index]``;
- q and v biases, a zero k bias;
- the −100 SW-MSA mask, ``torch.roll`` for ``jnp.roll``, and no shift (and
  the window clipped) where ``min(H, W) <= window``;
- PatchMerging's V2 order (reduction, then norm); exact (erf) GELU.

Design: the bias table ``16·sigmoid(cpb_mlp(table))`` depends only on the
weights, so `STForce` computes it once per block when it is built (the nets
run without gradient) and gathers it by the index in each forward; the
functional `swin_v2_forward` computes it every call, as the JAX code does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from touchgs_torch.vision import dpt


@dataclasses.dataclass(frozen=True)
class SwinArch:
    """``STForce.py:56-69`` backbone_cfg (num_classes 1000)."""

    img_size: int = 640
    patch_size: int = 4
    embed_dim: int = 192
    depths: Sequence[int] = (2, 2, 18, 2)
    num_heads: Sequence[int] = (6, 12, 24, 48)
    window_size: int = 20
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    ln_eps: float = 1e-5


STFORCE_SWIN = SwinArch()


def _coords_table(wh: int, ww: int) -> np.ndarray:
    """Log-spaced relative-coords table (``:96-111``), ((2wh−1)(2ww−1), 2)."""
    h = np.arange(-(wh - 1), wh, dtype=np.float32)
    w = np.arange(-(ww - 1), ww, dtype=np.float32)
    t = np.stack(np.meshgrid(h, w, indexing="ij"), axis=-1)
    t[..., 0] /= wh - 1
    t[..., 1] /= ww - 1
    t *= 8
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8)
    return t.reshape(-1, 2)


def _rel_position_index(wh: int, ww: int) -> np.ndarray:
    """(``:114-125``) (N, N) indices into the table."""
    ch, cw = np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")
    c = np.stack([ch.ravel(), cw.ravel()])
    rel = (c[:, :, None] - c[:, None, :]).transpose(1, 2, 0)
    rel[..., 0] += wh - 1
    rel[..., 1] += ww - 1
    rel[..., 0] *= 2 * ww - 1
    return rel.sum(-1)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws·ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(wins: torch.Tensor, ws: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    B = wins.shape[0] // ((H // ws) * (W // ws))
    x = wins.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def sw_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """The SW-MSA additive mask (``:243-266``), (nW, N, N) float32."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wss in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wss, :] = cnt
            cnt += 1
    wins = window_partition(torch.from_numpy(img), ws).numpy()[..., 0]
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def bias_table(p: dict, name: str, ws: int) -> torch.Tensor:
    """``16·sigmoid(cpb_mlp(coords table))``, (T, heads)."""
    w1 = p[f"{name}.cpb_mlp.0.weight"]
    # the numpy table is float64, cast as jnp.asarray casts it
    table = torch.from_numpy(_coords_table(ws, ws).astype(np.float32)).to(
        w1.device)
    h1 = torch.relu(dpt.linear(table, p, f"{name}.cpb_mlp.0"))
    return 16.0 * torch.sigmoid(dpt.linear(h1, p, f"{name}.cpb_mlp.2"))


def window_attention(x, p, name, num_heads, table, index, mask=None):
    """(``:139-178``); x: (B·nW, N, C); ``table`` from `bias_table`,
    ``index`` the flat (N·N,) position index, ``mask`` (nW, N, N)."""
    B_, N, C = x.shape
    hd = C // num_heads
    q_bias = p[f"{name}.q_bias"]
    v_bias = p[f"{name}.v_bias"]
    qkv_bias = torch.cat([q_bias, torch.zeros_like(v_bias), v_bias])
    qkv = F.linear(x, p[f"{name}.qkv.weight"], qkv_bias)
    qkv = qkv.reshape(B_, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    qn = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                         min=1e-12)
    kn = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True),
                         min=1e-12)
    attn = qn @ kn.transpose(-1, -2)
    logit_scale = torch.exp(torch.clamp(p[f"{name}.logit_scale"],
                                        max=math.log(1.0 / 0.01)))
    attn = attn * logit_scale
    rpb = table[index].reshape(N, N, num_heads).permute(2, 0, 1)
    attn = attn + rpb[None]
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.reshape(B_ // nW, nW, num_heads, N, N) + mask[:, None]
        attn = attn.reshape(B_, num_heads, N, N)
    attn = torch.softmax(attn, dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(B_, N, C)
    return dpt.linear(out, p, f"{name}.proj")


def block_window(H: int, W: int, ws: int, shift: int) -> tuple:
    """(window, shift) of a block at H×W (``:226-229``)."""
    if min(H, W) <= ws:
        return min(H, W), 0
    return ws, shift


def swin_block(x, p, name, H, W, num_heads, ws, shift, eps, table, index,
               mask):
    """SwinTransformerBlock (``:268-304``), res-post-norm; ``ws`` and
    ``shift`` already through `block_window`."""
    B, L, C = x.shape
    shortcut = x
    x = x.reshape(B, H, W, C)
    if shift > 0:
        x = torch.roll(x, (-shift, -shift), dims=(1, 2))
    wins = window_attention(window_partition(x, ws), p, f"{name}.attn",
                            num_heads, table, index, mask)
    x = window_reverse(wins, ws, H, W)
    if shift > 0:
        x = torch.roll(x, (shift, shift), dims=(1, 2))
    x = shortcut + dpt.layernorm(x.reshape(B, L, C), p, f"{name}.norm1", eps)
    h = F.gelu(dpt.linear(x, p, f"{name}.mlp.fc1"))
    h = dpt.linear(h, p, f"{name}.mlp.fc2")
    return x + dpt.layernorm(h, p, f"{name}.norm2", eps)


def patch_merging(x, p, name, H, W, eps):
    """(``:333-361``): 2×2 space-to-depth → reduction → norm."""
    B, L, C = x.shape
    x = x.reshape(B, H, W, C)
    x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                   x[:, 1::2, 1::2]], dim=-1)
    x = x.reshape(B, (H // 2) * (W // 2), 4 * C)
    x = F.linear(x, p[f"{name}.reduction.weight"])
    return dpt.layernorm(x, p, f"{name}.norm", eps)


def stages(arch: SwinArch):
    """(stage, block, name, H, W, heads, window, shift) of every block."""
    h = w = arch.img_size // arch.patch_size
    for li, depth in enumerate(arch.depths):
        for bi in range(depth):
            shift = 0 if bi % 2 == 0 else arch.window_size // 2
            ws, shift = block_window(h, w, arch.window_size, shift)
            yield (li, bi, f"layers.{li}.blocks.{bi}", h, w,
                   arch.num_heads[li], ws, shift)
        if li < len(arch.depths) - 1:
            h, w = h // 2, w // 2


def swin_v2_forward(p: dict, rgb: torch.Tensor, arch: SwinArch = STFORCE_SWIN,
                    prefix="backbone", tables=None,
                    windows=None) -> torch.Tensor:
    """SwinTransformerV2.forward (``:629-645``): a preprocessed (H, W, 3)
    image → (num_classes,) logits.  ``tables`` ({block name: bias table})
    and ``windows`` ({(H, W, ws, shift): (index, mask)}) are what `STForce`
    caches; without them every one is computed here."""
    eps = arch.ln_eps
    dev = rgb.device
    x = F.conv2d(rgb.permute(2, 0, 1)[None],
                 p[f"{prefix}.patch_embed.proj.weight"],
                 p[f"{prefix}.patch_embed.proj.bias"], stride=arch.patch_size)
    x = x.flatten(2).transpose(1, 2)
    if f"{prefix}.patch_embed.norm.weight" in p:
        x = dpt.layernorm(x, p, f"{prefix}.patch_embed.norm", eps)
    prev = 0
    for li, _, name, h, w, heads, ws, shift in stages(arch):
        if li != prev:
            x = patch_merging(x, p, f"{prefix}.layers.{prev}.downsample",
                              2 * h, 2 * w, eps)
            prev = li
        name = f"{prefix}.{name}"
        table = (tables[name] if tables is not None
                 else bias_table(p, f"{name}.attn", ws))
        index, mask = (windows[(h, w, ws, shift)] if windows is not None
                       else window_buffers(h, w, ws, shift, dev))
        x = swin_block(x, p, name, h, w, heads, ws, shift, eps, table, index,
                       mask)
    x = dpt.layernorm(x, p, f"{prefix}.norm", eps)
    return dpt.linear(x.mean(dim=1), p, f"{prefix}.head")[0]


def window_buffers(h: int, w: int, ws: int, shift: int, device=None):
    """The flat position index and the SW-MSA mask (None without a shift)
    of a block at h×w."""
    index = torch.from_numpy(_rel_position_index(ws, ws).reshape(-1)).to(
        device)
    mask = (torch.from_numpy(sw_mask(h, w, ws, shift)).to(device)
            if shift > 0 else None)
    return index, mask


def stforce_forward(p: dict, rgb: torch.Tensor, arch: SwinArch = STFORCE_SWIN,
                    tables=None, windows=None) -> torch.Tensor:
    """STForce.forward (``:114-122``): backbone logits → fc2(fc1(x))."""
    logits = swin_v2_forward(p, rgb, arch, tables=tables,
                             windows=windows)[None]
    h = dpt.linear(logits, p, "force_head.fc1")
    return dpt.linear(h, p, "force_head.fc2")[0]


def arch_from_params(params: dict, img_size: int = 640,
                     window_size: int = 20) -> SwinArch:
    """The SwinArch of a ported STForce param dict (file layouts); the
    image and window sizes are not in the weights."""
    pw = params["backbone.patch_embed.proj.weight"]
    depths, heads = [], []
    for li in range(16):
        blocks = {int(k.split(".")[4]) for k in params
                  if k.startswith(f"backbone.layers.{li}.blocks.")}
        if not blocks:
            break
        depths.append(max(blocks) + 1)
        heads.append(params[f"backbone.layers.{li}.blocks.0.attn."
                            "logit_scale"].shape[0])
    return SwinArch(img_size=img_size, patch_size=pw.shape[0],
                    embed_dim=pw.shape[-1], depths=tuple(depths),
                    num_heads=tuple(heads), window_size=window_size,
                    num_classes=params["backbone.head.weight"].shape[-1])


class STForce(dpt.PortedNet):
    """STForce on a ported npz: ``model(img)`` → the raw 6-vector.  The
    bias tables, the position indices and the masks are buffers, made once
    here and moved with the module."""

    arch_from_params = staticmethod(arch_from_params)

    def __init__(self, params, arch: SwinArch):
        super().__init__(params, arch)
        p = self.params()
        self._table_of, self._window_of = {}, {}
        with torch.no_grad():
            for _, _, name, h, w, _, ws, shift in stages(arch):
                key = f"backbone.{name}"
                self._table_of[key] = f"table_{len(self._table_of)}"
                self.register_buffer(self._table_of[key],
                                     bias_table(p, f"{key}.attn", ws),
                                     persistent=False)
                if (h, w, ws, shift) not in self._window_of:
                    i = self._window_of[(h, w, ws, shift)] = len(
                        self._window_of)
                    index, mask = window_buffers(h, w, ws, shift)
                    self.register_buffer(f"index_{i}", index,
                                         persistent=False)
                    self.register_buffer(f"mask_{i}", mask, persistent=False)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        tables = {k: getattr(self, v) for k, v in self._table_of.items()}
        windows = {k: (getattr(self, f"index_{i}"), getattr(self, f"mask_{i}"))
                   for k, i in self._window_of.items()}
        return stforce_forward(self.params(), rgb, self.arch, tables, windows)

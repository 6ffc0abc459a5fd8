"""Faithful DenseTact v2 inference nets in PyTorch (port of
``touchgs_tpu/touch/densetact_nets.py``).

The reference's deployed sensor nets (``cam_ros.py:113,125``):

- ``DenseDepth``: DenseNet-161 encoder + skip-connection decoder
  (``Img2Depth/networks/DenseNet.py:443-572``), tactile RGB 640×640 →
  depth, ``sigmoid × max_depth`` (max_depth 256).
- ``DenseNet_Force``: the DenseNet-161 classifier (1000 logits) + ForceHead,
  Linear 1000→500→6 with no activations (``networks/STForce.py:123-143``).

Both read a flat dict keyed by the torch ``state_dict`` names; the npz that
``tools/port_weights.py`` writes (conv HWIO, linear (in, out)) loads
through `vision.dpt.PortedNet`, which holds it in PyTorch's layouts.  The
forwards are the JAX package's in NCHW: conv0 7×7 stride 2 padded (3, 3),
BatchNorm in inference mode (eps 1e-5), max-pool 3×3/2 padded with −inf,
2×2 average pools VALID; the decoder's 1×1 ``conv2`` after a 1-pixel pad
(a reference quirk: the map grows by 2 px), its upsamples bilinear with
``align_corners=True``, the DispHead's ×2 with ``align_corners=False``.

``init_dense_depth_params`` / ``init_densenet_force_params`` draw from
``np.random.default_rng(seed)`` in the JAX package's order and layouts, so
their arrays equal the JAX package's bit for bit and one npz serves both.

DenseNet-161: init 96 features, growth 48, blocks (6, 12, 36, 24), bn_size
4; the decoder's taps are feature maps [3, 4, 6, 8, 11] of ``[x, conv0,
norm0, relu0, pool0, db1, tr1, db2, tr2, db3, tr3, db4, norm5]``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from touchgs_torch.vision import dpt

_BN_EPS = 1e-5
DENSENET161 = dict(init_features=96, growth=48, blocks=(6, 12, 36, 24),
                   bn_size=4)
DEPTH_KEY = "encoder.densenet.features.conv0.weight"


# the stride-1 3×3 convs that cuDNN ran faster in float32 than unfold +
# matmul on an H100 at 640² (chip_smoke.py phase 4f's conv table, PERF.md
# §6), as (in channels, out channels, height, width): the dense layers at
# 160², 80² and 20² (0.70-0.75x) and the decoder's at 320² (0.67-0.88x);
# at 40² cuDNN took 2.9x as long, and at 160² the decoder's 372 → 138 took
# 176 ms as GEMV launches against 1.05 unfolded (ROADMAP.md C33)
CUDNN_3X3: frozenset = frozenset({
    (192, 48, 160, 160), (192, 48, 80, 80), (192, 48, 20, 20),
    (234, 69, 320, 320), (69, 69, 320, 320), (69, 1, 320, 320),
    (1, 1, 320, 320)})


def conv(x: torch.Tensor, p: dict, name: str, stride: int = 1,
         padding: str = "SAME") -> torch.Tensor:
    """A convolution with XLA's padding: a stride-1 3×3 as unfold + one
    matmul (`vision.dpt.unfold_conv`, ROADMAP.md C27) unless its shape is
    in `CUDNN_3X3`, the rest through ``F.conv2d``."""
    w = p[f"{name}.weight"]
    b = p.get(f"{name}.bias")
    shape = (x.shape[1], w.shape[0]) + tuple(x.shape[2:])
    if (stride == 1 and padding == "SAME" and w.shape[2] == 3
            and shape not in CUDNN_3X3):
        return dpt.unfold_conv(x, w, b)
    return dpt.conv2d_xla(x, w, b, stride, padding)


def _bn(x, p, name):
    return F.batch_norm(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                        p[f"{name}.weight"], p[f"{name}.bias"], False, 0.0,
                        _BN_EPS)


def densenet161_features(p: dict, x: torch.Tensor, prefix="encoder.densenet",
                         cfg=DENSENET161) -> list:
    """torchvision densenet161 ``.features`` on an NCHW batch → the
    reference Encoder's 13 feature maps (``DenseNet.py:447-456``)."""
    f = f"{prefix}.features"
    maps = [x]
    x = F.conv2d(x, p[f"{f}.conv0.weight"], p.get(f"{f}.conv0.bias"),
                 stride=2, padding=3)
    maps.append(x)
    x = _bn(x, p, f"{f}.norm0")
    maps.append(x)
    x = torch.relu(x)
    maps.append(x)
    x = F.max_pool2d(x, 3, 2, padding=1)
    maps.append(x)
    n_blocks = len(cfg["blocks"])
    for bi, n_layers in enumerate(cfg["blocks"], start=1):
        blk = f"{f}.denseblock{bi}"
        for li in range(1, n_layers + 1):
            lay = f"{blk}.denselayer{li}"
            h = conv(torch.relu(_bn(x, p, f"{lay}.norm1")), p,
                     f"{lay}.conv1")                              # 1×1
            h = conv(torch.relu(_bn(h, p, f"{lay}.norm2")), p,
                     f"{lay}.conv2")                              # 3×3
            x = torch.cat([x, h], dim=1)
        maps.append(x)
        if bi < n_blocks:
            tr = f"{f}.transition{bi}"
            x = conv(torch.relu(_bn(x, p, f"{tr}.norm")), p, f"{tr}.conv")
            x = F.avg_pool2d(x, 2)
            maps.append(x)
    maps.append(_bn(x, p, f"{f}.norm5"))
    return maps


def densenet161_classify(p: dict, x: torch.Tensor, prefix="encoder.densenet",
                         cfg=DENSENET161) -> torch.Tensor:
    """The full torchvision densenet161 forward → (N, 1000) logits."""
    h = torch.relu(densenet161_features(p, x, prefix, cfg)[-1])
    return dpt.linear(h.mean(dim=(2, 3)), p, f"{prefix}.classifier")


def _upsample_block(p, name, x, skip):
    """Decoder Upsample (``DenseNet.py:459-487``): bilinear to the skip's
    size (align_corners=True), concat, convA → LeakyReLU(0.2) → convB →
    LeakyReLU(0.2)."""
    x = dpt.resize_bilinear(x, skip.shape[2], skip.shape[3],
                            align_corners=True)
    x = torch.cat([x, skip], dim=1)
    x = F.leaky_relu(conv(x, p, f"{name}.convA"), 0.2)
    return F.leaky_relu(conv(x, p, f"{name}.convB"), 0.2)


def dense_depth_forward(p: dict, rgb: torch.Tensor, max_depth: float = 256.0,
                        cfg=DENSENET161) -> torch.Tensor:
    """DenseDepth: a preprocessed (H, W, 3) image → (H', W') depth
    (``DenseNet.py:489-531,553-572``)."""
    maps = densenet161_features(p, rgb.permute(2, 0, 1)[None], cfg=cfg)
    b0, b1, b2, b3, b4 = (maps[3], maps[4], maps[6], maps[8], maps[11])
    x = F.conv2d(F.pad(b4, (1, 1, 1, 1)), p["decoder.conv2.weight"],
                 p["decoder.conv2.bias"])
    x = _upsample_block(p, "decoder.upsample1", x, b3)
    x = _upsample_block(p, "decoder.upsample2", x, b2)
    x = _upsample_block(p, "decoder.upsample3", x, b1)
    x = _upsample_block(p, "decoder.upsample4", x, b0)
    x = conv(x, p, "decoder.conv3")
    x = torch.sigmoid(conv(x, p, "decoder.dispheader.conv1"))
    x = dpt.resize_bilinear(x, x.shape[2] * 2, x.shape[3] * 2,
                            align_corners=False)
    return x[0, 0] * max_depth


def densenet_force_forward(p: dict, rgb: torch.Tensor,
                           cfg=DENSENET161) -> torch.Tensor:
    """DenseNet_Force: a preprocessed (H, W, 3) image → the raw 6-vector
    (``STForce.py:123-143``: logits → fc2(fc1(x)), no activations)."""
    logits = densenet161_classify(p, rgb.permute(2, 0, 1)[None], cfg=cfg)
    h = dpt.linear(logits, p, "force_head.fc1")
    return dpt.linear(h, p, "force_head.fc2")[0]


def arch_from_params(params: dict) -> dict:
    """The DenseNet configuration of a ported param dict (file layouts)."""
    f = "encoder.densenet.features"
    blocks = []
    while True:
        block = f"{f}.denseblock{len(blocks) + 1}.denselayer"
        layers = [int(k[len(block):].split(".")[0]) for k in params
                  if k.startswith(block)]
        if not layers:
            break
        blocks.append(max(layers))
    conv1 = params[f"{f}.denseblock1.denselayer1.conv1.weight"]
    growth = params[f"{f}.denseblock1.denselayer1.conv2.weight"].shape[-1]
    return dict(init_features=params[f"{f}.conv0.weight"].shape[-1],
                growth=growth, blocks=tuple(blocks),
                bn_size=conv1.shape[-1] // growth)


class DenseDepth(dpt.PortedNet):
    """``DenseDepth(max_depth=256)``: ``model(img)`` with img the
    transform_image-normalized (H, W, 3) tensor."""

    arch_from_params = staticmethod(arch_from_params)
    max_depth = 256.0

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return dense_depth_forward(self.params(), rgb, self.max_depth,
                                   self.arch)


class DenseNetForce(dpt.PortedNet):
    """``DenseNet_Force``: ``model(img)`` → the raw 6-vector."""

    arch_from_params = staticmethod(arch_from_params)

    def forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return densenet_force_forward(self.params(), rgb, self.arch)


# ---------------------------------------------------------------- init


def _init_densenet161_params(rng, prefix="encoder.densenet", cfg=DENSENET161,
                             in_ch=3):
    """Random params of the DenseNet trunk in the file's layouts, drawn in
    the JAX package's order (``_init_densenet161_params``)."""
    p = {}

    def conv_w(name, cin, cout, k):
        fan = cin * k * k
        p[f"{name}.weight"] = rng.normal(
            0, np.sqrt(2.0 / fan), (k, k, cin, cout)).astype(np.float32)

    def bn(name, c):
        p[f"{name}.weight"] = np.ones((c,), np.float32)
        p[f"{name}.bias"] = np.zeros((c,), np.float32)
        p[f"{name}.running_mean"] = np.zeros((c,), np.float32)
        p[f"{name}.running_var"] = np.ones((c,), np.float32)

    f = f"{prefix}.features"
    init, growth, bn_size = cfg["init_features"], cfg["growth"], cfg["bn_size"]
    conv_w(f"{f}.conv0", in_ch, init, 7)
    bn(f"{f}.norm0", init)
    c = init
    for bi, n_layers in enumerate(cfg["blocks"], start=1):
        for li in range(1, n_layers + 1):
            lay = f"{f}.denseblock{bi}.denselayer{li}"
            bn(f"{lay}.norm1", c)
            conv_w(f"{lay}.conv1", c, bn_size * growth, 1)
            bn(f"{lay}.norm2", bn_size * growth)
            conv_w(f"{lay}.conv2", bn_size * growth, growth, 3)
            c += growth
        if bi < len(cfg["blocks"]):
            tr = f"{f}.transition{bi}"
            bn(f"{tr}.norm", c)
            conv_w(f"{tr}.conv", c, c // 2, 1)
            c //= 2
    bn(f"{f}.norm5", c)
    p[f"{prefix}.classifier.weight"] = rng.normal(
        0, 0.01, (c, 1000)).astype(np.float32)
    p[f"{prefix}.classifier.bias"] = np.zeros((1000,), np.float32)
    return p, c


def decoder_skip_channels(cfg=DENSENET161) -> list:
    """Widths of the taps the decoder concatenates: [transition2,
    transition1, pool0, relu0] (384/192/96/96 for densenet161)."""
    c = cfg["init_features"]
    trans = []
    for bi, n in enumerate(cfg["blocks"], start=1):
        c += n * cfg["growth"]
        if bi < len(cfg["blocks"]):
            c //= 2
            trans.append(c)
    return [trans[1], trans[0], cfg["init_features"], cfg["init_features"]]


def init_dense_depth_params(seed=0, cfg=DENSENET161) -> dict:
    """DenseDepth's random params as numpy, in the file's layouts."""
    rng = np.random.default_rng(seed)
    p, num_features = _init_densenet161_params(rng, cfg=cfg)
    features = num_features // 2
    cin = features
    for i, (div, skip) in enumerate(zip((1, 2, 4, 8),
                                        decoder_skip_channels(cfg)), start=1):
        cout = features // (div * 2)
        up = f"decoder.upsample{i}"
        for cname, ci in ((f"{up}.convA", features // div + skip),
                          (f"{up}.convB", cout)):
            p[f"{cname}.weight"] = rng.normal(
                0, np.sqrt(2.0 / (ci * 9)), (3, 3, ci, cout)).astype(
                    np.float32)
            p[f"{cname}.bias"] = np.zeros((cout,), np.float32)
        cin = cout
    for name, ci, co, k in (("decoder.conv2", num_features, features, 1),
                            ("decoder.conv3", cin, 1, 3),
                            ("decoder.dispheader.conv1", 1, 1, 3)):
        p[f"{name}.weight"] = rng.normal(
            0, np.sqrt(2.0 / (ci * k * k)), (k, k, ci, co)).astype(np.float32)
        p[f"{name}.bias"] = np.zeros((co,), np.float32)
    return p


def init_densenet_force_params(seed=0, cfg=DENSENET161) -> dict:
    """DenseNet_Force's random params as numpy, in the file's layouts."""
    rng = np.random.default_rng(seed)
    p, _ = _init_densenet161_params(rng, cfg=cfg)
    p["force_head.fc1.weight"] = rng.normal(0, 0.01, (1000, 500)).astype(
        np.float32)
    p["force_head.fc1.bias"] = np.zeros((500,), np.float32)
    p["force_head.fc2.weight"] = rng.normal(0, 0.01, (500, 6)).astype(
        np.float32)
    p["force_head.fc2.bias"] = np.zeros((6,), np.float32)
    return p

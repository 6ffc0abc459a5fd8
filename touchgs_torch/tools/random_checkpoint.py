"""Random-weight checkpoints of the monocular-depth nets and the DenseTact
sensor nets, written as ``tools/port_weights.py`` writes a real one.

No pretrained checkpoint is in the repository, so the nets run at their
published widths on weights drawn from a seed: ``ported_shapes`` lists
every tensor a checkpoint of the arch holds (its torch ``state_dict``
names, in the ported layouts: conv HWIO, ConvTranspose (kh, kw, O, I),
linear (in, out)), and ``random_checkpoint`` draws them so that the
activations stay of order one through the depth of the net: weights
of variance 1/fan_in, biases and embeddings of standard deviation 0.02
(uniform draws, a tenth of the normal draws' time at 340M parameters),
LayerNorms (1, 0), LayerScales 0.1, SwinV2's logit scales log 10 (its
own init).  DenseDepth and DenseNet_Force come from
``touch.densetact_nets.init_*_params``, whose numpy draws equal the JAX
package's bit for bit.  The real loader (``vision.dpt.PortedNet.from_npz``,
``VisualPipeline``, ``touch.sensor_nets.DenseTactSensor``) reads the
file, so a real checkpoint's npz takes its place with no change.

    python -m touchgs_torch.tools.random_checkpoint zoe_n OUT.npz [--seed S]
    python -m touchgs_torch.tools.random_checkpoint densetact_depth OUT.npz
"""
from __future__ import annotations

import argparse

import numpy as np

from touchgs_torch.touch import densetact_nets as dt
from touchgs_torch.touch.swin_force import STFORCE_SWIN
from touchgs_torch.vision.depth_anything import DEPTH_ANYTHING_SMALL
from touchgs_torch.vision.dpt import DPT_LARGE
from touchgs_torch.vision.zoedepth import ZOEDEPTH_NK, ZOEDEPTH_NYU

# the nets at their published widths
ARCHS = {"dpt": ("dpt", DPT_LARGE), "zoe_n": ("zoedepth", ZOEDEPTH_NYU),
         "zoe_nk": ("zoedepth", ZOEDEPTH_NK),
         "depth_anything": ("depth_anything", DEPTH_ANYTHING_SMALL)}
# the DenseTact sensor nets at theirs (640² input, cam_ros.py:113,125)
SENSOR_ARCHS = {"densetact_depth": ("densetact_depth", dt.DENSENET161),
                "densetact_force": ("densetact_force", dt.DENSENET161),
                "stforce": ("stforce", STFORCE_SWIN)}
# the DenseTact nets' own draws (``np.random.default_rng(seed)``)
DENSETACT_INIT = {"densetact_depth": dt.init_dense_depth_params,
                  "densetact_force": dt.init_densenet_force_params}
# ZoeD_NK's patch transformer (HF hardcodes its classifier's 128 inputs)
PATCH_HIDDEN, PATCH_INTERMEDIATE, PATCH_LAYERS = 128, 1024, 4


class _Shapes(dict):
    def lin(self, name, i, o, bias=True):
        self[f"{name}.weight"] = (i, o)
        if bias:
            self[f"{name}.bias"] = (o,)

    def conv(self, name, k, i, o, bias=True):
        self[f"{name}.weight"] = (k, k, i, o)
        if bias:
            self[f"{name}.bias"] = (o,)

    def norm(self, name, d):
        self[f"{name}.weight"] = (d,)
        self[f"{name}.bias"] = (d,)

    def patch_embed(self, prefix, patch, d):
        self[f"{prefix}.cls_token"] = (1, 1, d)
        self.conv(f"{prefix}.patch_embeddings.projection", patch, 3, d)

    def neck(self, a, d, readout: bool):
        fh = a.fusion_hidden_size
        for i, (n, f) in enumerate(zip(a.neck_hidden_sizes,
                                       a.reassemble_factors)):
            pre = f"neck.reassemble_stage.layers.{i}"
            self.conv(f"{pre}.projection", 1, d, n)
            if f > 1:
                self[f"{pre}.resize.weight"] = (int(f), int(f), n, n)
                self[f"{pre}.resize.bias"] = (n,)
            elif f < 1:
                self.conv(f"{pre}.resize", 3, n, n)
            if readout:
                self.lin(f"neck.reassemble_stage.readout_projects.{i}.0",
                         2 * d, d)
            self.conv(f"neck.convs.{i}", 3, n, fh, bias=False)
        for j in range(len(a.neck_hidden_sizes)):
            pre = f"neck.fusion_stage.layers.{j}"
            self.conv(f"{pre}.projection", 1, fh, fh)
            for r in (1, 2):
                for c in (1, 2):
                    self.conv(f"{pre}.residual_layer{r}.convolution{c}", 3,
                              fh, fh)


def _dpt(a) -> _Shapes:
    s, d = _Shapes(), a.hidden_size
    s.patch_embed("dpt.embeddings", a.patch_size, d)
    g = a.image_size // a.patch_size
    s["dpt.embeddings.position_embeddings"] = (1, 1 + g * g, d)
    for i in range(a.num_layers):
        pre = f"dpt.encoder.layer.{i}"
        for m in ("query", "key", "value"):
            s.lin(f"{pre}.attention.attention.{m}", d, d)
        s.lin(f"{pre}.attention.output.dense", d, d)
        s.lin(f"{pre}.intermediate.dense", d, a.intermediate_size)
        s.lin(f"{pre}.output.dense", a.intermediate_size, d)
        s.norm(f"{pre}.layernorm_before", d)
        s.norm(f"{pre}.layernorm_after", d)
    s.norm("dpt.layernorm", d)
    s.neck(a, d, readout=True)
    fh = a.fusion_hidden_size
    s.conv("head.head.0", 3, fh, fh // 2)
    s.conv("head.head.2", 3, fh // 2, 32)
    s.conv("head.head.4", 1, 32, 1)
    return s


def _zoedepth(a, bin_embedding: int = 128) -> _Shapes:
    s, d = _Shapes(), a.hidden_size
    s.patch_embed("backbone.embeddings", a.patch_size, d)
    g = a.image_size // a.patch_size
    for i in range(a.num_layers):
        pre = f"backbone.encoder.layer.{i}"
        s[f"{pre}.lambda_1"] = s[f"{pre}.lambda_2"] = (d,)
        att = f"{pre}.attention.attention"
        s.lin(f"{att}.query", d, d)
        s.lin(f"{att}.key", d, d, bias=False)
        s.lin(f"{att}.value", d, d)
        s[f"{att}.relative_position_bias.relative_position_bias_table"] = (
            (2 * g - 1) ** 2 + 3, a.num_heads)
        s.lin(f"{pre}.attention.output.dense", d, d)
        s.lin(f"{pre}.intermediate.dense", d, a.intermediate_size)
        s.lin(f"{pre}.output.dense", a.intermediate_size, d)
        s.norm(f"{pre}.layernorm_before", d)
        s.norm(f"{pre}.layernorm_after", d)
    s.neck(a, d, readout=True)
    fh, rel, bn = (a.fusion_hidden_size, a.num_relative_features,
                   a.bottleneck_features)
    s.conv("relative_head.conv1", 3, fh, fh // 2)
    s.conv("relative_head.conv2", 3, fh // 2, rel)
    s.conv("relative_head.conv3", 1, rel, 1)
    s.conv("metric_head.conv2", 1, fh, bn)
    names = [b.name for b in a.bin_configurations]
    normed = a.bin_centers_type == "normed"
    if len(names) == 1:
        nb = a.bin_configurations[0].n_bins
        s.conv("metric_head.seed_bin_regressor.conv1", 1, bn, 256)
        s.conv("metric_head.seed_bin_regressor.conv2", 1, 256, nb)
        mlp = 128
        for i, n_attr in enumerate(a.num_attractors):
            pre = f"metric_head.attractors.{i}"
            s.conv(f"{pre}.conv1", 1, bin_embedding, bin_embedding)
            s.conv(f"{pre}.conv2", 1, bin_embedding,
                   2 * n_attr if normed else n_attr)
        clb_in, factor, clbs = rel + 1 + bin_embedding, 2, [""]
    else:
        mlp = bin_embedding // 2
        pt = "metric_head.patch_transformer"
        s.conv(f"{pt}.embedding_convPxP", 1, bn, PATCH_HIDDEN)
        for i in range(PATCH_LAYERS):
            pre = f"{pt}.transformer_encoder.{i}"
            for m in ("query", "key", "value", "out_proj"):
                s.lin(f"{pre}.self_attn.{m}", PATCH_HIDDEN, PATCH_HIDDEN)
            s.lin(f"{pre}.linear1", PATCH_HIDDEN, PATCH_INTERMEDIATE)
            s.lin(f"{pre}.linear2", PATCH_INTERMEDIATE, PATCH_HIDDEN)
            s.norm(f"{pre}.norm1", PATCH_HIDDEN)
            s.norm(f"{pre}.norm2", PATCH_HIDDEN)
        s.lin("metric_head.mlp_classifier.linear1", PATCH_HIDDEN, 128)
        s.lin("metric_head.mlp_classifier.linear2", 128, len(names))
        for bc in a.bin_configurations:
            pre = f"metric_head.seed_bin_regressors.{bc.name}"
            s.conv(f"{pre}.conv1", 1, bn, mlp)
            s.conv(f"{pre}.conv2", 1, mlp, bc.n_bins)
            for i in range(len(a.num_attractors)):
                pre = f"metric_head.attractors.{bc.name}.{i}"
                s.conv(f"{pre}.conv1", 1, bin_embedding, bin_embedding)
                s.conv(f"{pre}.conv2", 1, bin_embedding, 16)
        clb_in, factor, clbs = rel + bin_embedding, 4, [f".{n}" for n in names]
    s.conv("metric_head.seed_projector.conv1", 1, bn, mlp)
    s.conv("metric_head.seed_projector.conv2", 1, mlp, bin_embedding)
    for i in range(len(a.num_attractors)):
        s.conv(f"metric_head.projectors.{i}.conv1", 1, fh, mlp)
        s.conv(f"metric_head.projectors.{i}.conv2", 1, mlp, bin_embedding)
    for clb in clbs:
        pre = f"metric_head.conditional_log_binomial{clb}.mlp"
        s.conv(f"{pre}.0", 1, clb_in, clb_in // factor)
        s.conv(f"{pre}.2", 1, clb_in // factor, 4)
    return s


def _depth_anything(a) -> _Shapes:
    s, d = _Shapes(), a.hidden_size
    s.patch_embed("backbone.embeddings", a.patch_size, d)
    g = a.image_size // a.patch_size
    s["backbone.embeddings.mask_token"] = (1, d)
    s["backbone.embeddings.position_embeddings"] = (1, 1 + g * g, d)
    for i in range(a.num_layers):
        pre = f"backbone.encoder.layer.{i}"
        s.norm(f"{pre}.norm1", d)
        for m in ("query", "key", "value"):
            s.lin(f"{pre}.attention.attention.{m}", d, d)
        s.lin(f"{pre}.attention.output.dense", d, d)
        s[f"{pre}.layer_scale1.lambda1"] = (d,)
        s.norm(f"{pre}.norm2", d)
        s.lin(f"{pre}.mlp.fc1", d, d * a.mlp_ratio)
        s.lin(f"{pre}.mlp.fc2", d * a.mlp_ratio, d)
        s[f"{pre}.layer_scale2.lambda1"] = (d,)
    s.norm("backbone.layernorm", d)
    s.neck(a, a.reassemble_hidden_size, readout=False)
    fh = a.fusion_hidden_size
    s.conv("head.conv1", 3, fh, fh // 2)
    s.conv("head.conv2", 3, fh // 2, a.head_hidden_size)
    s.conv("head.conv3", 1, a.head_hidden_size, 1)
    return s


def _densenet(cfg, s: _Shapes, prefix="encoder.densenet") -> int:
    """The DenseNet trunk and its classifier; returns its width."""
    f = f"{prefix}.features"

    def bn(name, c):
        s.norm(name, c)
        s[f"{name}.running_mean"] = s[f"{name}.running_var"] = (c,)

    s.conv(f"{f}.conv0", 7, 3, cfg["init_features"], bias=False)
    bn(f"{f}.norm0", cfg["init_features"])
    c, inner = cfg["init_features"], cfg["bn_size"] * cfg["growth"]
    for bi, n_layers in enumerate(cfg["blocks"], start=1):
        for li in range(1, n_layers + 1):
            lay = f"{f}.denseblock{bi}.denselayer{li}"
            bn(f"{lay}.norm1", c)
            s.conv(f"{lay}.conv1", 1, c, inner, bias=False)
            bn(f"{lay}.norm2", inner)
            s.conv(f"{lay}.conv2", 3, inner, cfg["growth"], bias=False)
            c += cfg["growth"]
        if bi < len(cfg["blocks"]):
            bn(f"{f}.transition{bi}.norm", c)
            s.conv(f"{f}.transition{bi}.conv", 1, c, c // 2, bias=False)
            c //= 2
    bn(f"{f}.norm5", c)
    s.lin(f"{prefix}.classifier", c, 1000)
    return c


def _densetact_depth(cfg) -> _Shapes:
    s = _Shapes()
    num_features = _densenet(cfg, s)
    features = cin = num_features // 2
    for i, (div, skip) in enumerate(zip((1, 2, 4, 8),
                                        dt.decoder_skip_channels(cfg)), 1):
        cout = features // (div * 2)
        s.conv(f"decoder.upsample{i}.convA", 3, features // div + skip, cout)
        s.conv(f"decoder.upsample{i}.convB", 3, cout, cout)
        cin = cout
    s.conv("decoder.conv2", 1, num_features, features)
    s.conv("decoder.conv3", 3, cin, 1)
    s.conv("decoder.dispheader.conv1", 3, 1, 1)
    return s


def _densetact_force(cfg) -> _Shapes:
    s = _Shapes()
    _densenet(cfg, s)
    s.lin("force_head.fc1", 1000, 500)
    s.lin("force_head.fc2", 500, 6)
    return s


def _stforce(a) -> _Shapes:
    """STForce: the SwinV2 backbone's tensors that its forward reads (a
    real checkpoint also holds its buffers: coords tables, position
    indices, masks) and the force head."""
    s, b = _Shapes(), "backbone"
    s.conv(f"{b}.patch_embed.proj", a.patch_size, 3, a.embed_dim)
    s.norm(f"{b}.patch_embed.norm", a.embed_dim)
    d = a.embed_dim
    for li, (depth, heads) in enumerate(zip(a.depths, a.num_heads)):
        for bi in range(depth):
            pre = f"{b}.layers.{li}.blocks.{bi}"
            s[f"{pre}.attn.logit_scale"] = (heads, 1, 1)
            s[f"{pre}.attn.q_bias"] = s[f"{pre}.attn.v_bias"] = (d,)
            s.lin(f"{pre}.attn.qkv", d, 3 * d, bias=False)
            s.lin(f"{pre}.attn.proj", d, d)
            s.lin(f"{pre}.attn.cpb_mlp.0", 2, 512)
            s.lin(f"{pre}.attn.cpb_mlp.2", 512, heads, bias=False)
            s.norm(f"{pre}.norm1", d)
            s.lin(f"{pre}.mlp.fc1", d, int(d * a.mlp_ratio))
            s.lin(f"{pre}.mlp.fc2", int(d * a.mlp_ratio), d)
            s.norm(f"{pre}.norm2", d)
        if li < len(a.depths) - 1:
            s.lin(f"{b}.layers.{li}.downsample.reduction", 4 * d, 2 * d,
                  bias=False)
            s.norm(f"{b}.layers.{li}.downsample.norm", 2 * d)
            d *= 2
    s.norm(f"{b}.norm", d)
    s.lin(f"{b}.head", d, a.num_classes)
    s.lin("force_head.fc1", a.num_classes, 500)
    s.lin("force_head.fc2", 500, 6)
    return s


def ported_shapes(kind: str, arch) -> dict:
    """{torch state_dict name: shape in the ported layout} of a checkpoint
    of ``kind`` ("dpt", "zoedepth", "depth_anything", "densetact_depth",
    "densetact_force" or "stforce") at ``arch``."""
    return dict({"dpt": _dpt, "zoedepth": _zoedepth,
                 "depth_anything": _depth_anything,
                 "densetact_depth": _densetact_depth,
                 "densetact_force": _densetact_force,
                 "stforce": _stforce}[kind](arch))


def random_checkpoint(kind: str, arch, seed: int = 0) -> dict:
    """{name: float32 array} drawn from ``np.random.default_rng(seed)``."""
    if kind in DENSETACT_INIT:
        return DENSETACT_INIT[kind](seed, arch)
    rng = np.random.default_rng(seed)

    def uniform(shape, std):
        """Uniform on ±std·√3 (variance std²)."""
        a = rng.random(shape, np.float32)
        a -= 0.5
        a *= np.float32(2 * np.sqrt(3.0) * std)
        return a

    out = {}
    for name, shape in ported_shapes(kind, arch).items():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith(".weight") and len(shape) in (2, 4):
            # fan-in: (in, out) linear, HWIO conv, or (kh, kw, O, I) for a
            # ConvTranspose (k = stride, so each output sees I inputs)
            convt = ".resize." in name and shape[0] in (2, 4)
            fan_in = (shape[0] if len(shape) == 2 else shape[3] if convt
                      else shape[0] * shape[1] * shape[2])
            a = uniform(shape, 1 / np.sqrt(fan_in))
        elif "norm" in name.rsplit(".", 2)[-2] and leaf == "weight":
            a = np.ones(shape, np.float32)
        elif "norm" in name.rsplit(".", 2)[-2]:
            a = np.zeros(shape, np.float32)
        elif leaf.startswith("lambda"):
            a = np.full(shape, 0.1, np.float32)
        elif leaf == "logit_scale":
            a = np.full(shape, np.log(10.0), np.float32)
        else:
            a = uniform(shape, 0.02)
        out[name] = a
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    nets = {**ARCHS, **SENSOR_ARCHS}
    p.add_argument("net", choices=sorted(nets))
    p.add_argument("out")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    kind, arch = nets[args.net]
    np.savez(args.out, **random_checkpoint(kind, arch, args.seed))


if __name__ == "__main__":
    main()

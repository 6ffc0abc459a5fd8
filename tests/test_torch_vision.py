"""The monocular-depth nets (``touchgs_torch/vision``) against the JAX
package's (``touchgs_tpu/vision``) on the same ported npz and the same
images from numpy seeds, at the JAX tests' tiny configs.

The weights are transformers' tiny models through ``port_state_dict``, as
the JAX tests build them, redrawn at order one (`_order_one`): with
transformers' own init the depth maps are about 1e-8, so any tolerance
would pass them.  The tolerances are stated in each test against the
output's scale; the port and the JAX package read within 1e-5 of it
(float32 sums in another order)."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from tests.test_depth_anything import _tiny_da
from tests.test_port_weights import _tiny_dpt
from tests.test_zoedepth import _tiny_zoe_nk, _tiny_zoe_single
from tools.port_weights import port_state_dict
from touchgs_tpu.vision import depth_anything as jda
from touchgs_tpu.vision import dpt as jdpt
from touchgs_tpu.vision import monodepth as jmono
from touchgs_tpu.vision import zoedepth as jzoe
from touchgs_torch.data.png import read_png, write_png
from touchgs_torch.tools import random_checkpoint as rck
from touchgs_torch.vision import depth_anything as tda
from touchgs_torch.vision import dpt as tdpt
from touchgs_torch.vision import monodepth as tmono
from touchgs_torch.vision import zoedepth as tzoe


# the JAX forwards, compiled once per arch (op by op they take seconds)
J_DPT = jax.jit(jdpt.dpt_forward, static_argnums=2)
J_ZOE = jax.jit(jzoe.zoedepth_forward, static_argnums=(2, 3))
J_DA = jax.jit(jda.depth_anything_forward, static_argnums=2)


@functools.partial(jax.jit, static_argnums=2)
def j_logits(params, img, arch):
    taps, ph, pw = jzoe._beit_backbone(params, img[None], arch)
    _, bottleneck = jzoe._neck(params, taps, ph, pw, arch)
    return jzoe.classify_domain(params, bottleneck, arch)[0]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for this module (ROADMAP.md C18:
    the suite's workers share the cores); restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _order_one(model, seed):
    """Redraw every parameter from a seeded generator so activations stay
    of order one: weights N(0, 1/fan_in), LayerNorm weights 1 + N(0, 0.1²),
    everything else N(0, 0.1²)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim >= 2 and name.endswith("weight"):
                p.copy_(torch.randn(p.shape, generator=g)
                        / np.sqrt(p[0].numel()))
            else:
                norm = "norm" in name and name.endswith("weight")
                p.copy_(torch.randn(p.shape, generator=g) * 0.1 + norm)
    return model


def _image(shape, seed):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _close(out, ref, rel):
    """max |out − ref| within ``rel`` of the output's scale."""
    scale = float(np.abs(ref).max())
    assert scale > 0.1, scale
    err = float(np.abs(np.asarray(out) - np.asarray(ref)).max())
    assert err <= rel * scale, (err, scale)
    return err


@pytest.fixture(scope="module")
def dpt_net():
    model, arch = _tiny_dpt()
    params = port_state_dict(_order_one(model, 0).state_dict())
    return model, arch, params, tdpt.DPT(params, arch)


@pytest.fixture(scope="module")
def zoe_nets():
    nets = {}
    for name, (make, kw) in {"single": (_tiny_zoe_single, {}),
                             "nk": (_tiny_zoe_nk, {}),
                             "normed": (_tiny_zoe_nk,
                                        {"bin_centers_type": "normed"})
                             }.items():
        model, arch = make(**kw)
        params = port_state_dict(_order_one(model, 1).state_dict())
        nets[name] = (model, arch, params, tzoe.ZoeDepth(params, arch))
    return nets


@pytest.fixture(scope="module")
def da_nets():
    nets = {}
    for name, kw in {"relative": {}, "metric": {
            "depth_estimation_type": "metric", "max_depth": 20.0}}.items():
        model, arch = _tiny_da(**kw)
        params = port_state_dict(_order_one(model, 2).state_dict())
        nets[name] = (model, arch, params, tda.DepthAnything(params, arch))
    return nets


# ------------------------------------------------------------------ DPT --

@pytest.mark.parametrize("size", [64, 96], ids=["native", "non_native"])
def test_dpt_matches_jax(dpt_net, size):
    """DPT at its native 64² and at 96² (both even 16-px patch grids, where
    the stride-2 reassembly pads (0, 1)): within 1e-5 of the output's
    scale (measured 2.5e-6 and 3.6e-6)."""
    _, arch, params, net = dpt_net
    img = _image((size, size, 3), size)
    out = net(torch.from_numpy(img))
    ref = J_DPT(params, img, arch)
    assert out.shape == (size, size)
    _close(out.numpy(), ref, 1e-5)


def test_state_dict_names_are_the_checkpoints(dpt_net):
    """The port's parameters carry the torch ``state_dict`` names in
    PyTorch's layouts: the tiny model's own state_dict loads into it."""
    model, _, params, net = dpt_net
    sd = model.state_dict()
    assert set(net.state_dict()) == set(params) == set(sd)
    for name, t in net.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[name].numpy())


def test_same_padding_is_xla_s():
    """``conv`` with "SAME" against ``lax.conv_general_dilated``, stride 2,
    3×3, at an even (pads (0, 1)) and an odd size (pads (1, 1)); a
    ``conv2d(padding=1)`` misses the even case (ROADMAP.md C25)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)
    p = {"c.weight": torch.from_numpy(tdpt.torch_layout("c.weight", w))}
    for n in (4, 5):
        x = rng.normal(size=(1, n, n, 4)).astype(np.float32)
        ref = np.asarray(jax.lax.conv_general_dilated(
            x, w, (2, 2), "SAME", dimension_numbers=("NHWC", "HWIO",
                                                     "NHWC")))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        out = tdpt.conv(xt, p, "c", stride=2).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)
        sym = torch.nn.functional.conv2d(xt, p["c.weight"], stride=2,
                                         padding=1).permute(0, 2, 3, 1)
        assert (np.abs(sym.numpy() - ref).max() > 0.1) == (n % 2 == 0)


@pytest.mark.parametrize("net,size", [("dpt", 64), ("zoe", 64),
                                      ("depth_anything", 56)])
def test_reference_departs_from_transformers_at_even_grids(
        request, monkeypatch, net, size):
    """A finding in the reference (ROADMAP.md C25): at order-one weights the
    JAX package's nets, and so the port, depart from transformers' at an
    even patch grid (4x4 here) by more than 1% of the depth's scale,
    because XLA's SAME pads the stride-2 reassembly conv (0, 1) where
    ``nn.Conv2d(padding=1)`` pads (1, 1).  With that one conv padded as
    torch pads it, the port reads transformers' depth within 1e-5 of the
    scale."""
    model, arch, params, port_net = {
        "dpt": lambda: request.getfixturevalue("dpt_net"),
        "zoe": lambda: request.getfixturevalue("zoe_nets")["single"],
        "depth_anything": lambda: request.getfixturevalue(
            "da_nets")["relative"]}[net]()
    img = torch.from_numpy(_image((size, size, 3), size))
    with torch.no_grad():
        hf = model(img.permute(2, 0, 1)[None]).predicted_depth[0].numpy()
    port = port_net(img).numpy()
    print(f"{net}: |port - transformers| {np.abs(port - hf).max():.3e} of "
          f"{np.abs(hf).max():.3e}")
    assert np.abs(port - hf).max() > 0.01 * np.abs(hf).max()
    conv = tdpt.conv

    def torch_padded(x, p, name, stride=1, padding="SAME"):
        if stride == 2:
            return torch.nn.functional.conv2d(
                x, p[f"{name}.weight"], p.get(f"{name}.bias"), stride=2,
                padding=1)
        return conv(x, p, name, stride, padding)

    monkeypatch.setattr(tdpt, "conv", torch_padded)
    _close(port_net(img).numpy(), hf, 1e-5)


# ------------------------------------------------------------- ZoeDepth --

@pytest.mark.parametrize("shape", [(64, 64, 3), (96, 64, 3)],
                         ids=["native", "non_native"])
def test_zoedepth_single_head_matches_jax(zoe_nets, shape):
    """ZoeD_N's head, at the native window and at 96x64 (the relative
    position tables resized): within 1e-5 of the scale (measured 3.4e-7)."""
    _, arch, params, net = zoe_nets["single"]
    img = _image(shape, 3)
    _close(net(torch.from_numpy(img)).numpy(),
           J_ZOE(params, img, arch, None), 1e-5)


def test_zoedepth_nk_route_and_logits(zoe_nets):
    """ZoeD_NK: the domain logits within 1e-5, the same head picked by the
    host argmax, and the routed depth within 1e-5 of the scale; both heads
    also forced by name."""
    _, arch, params, net = zoe_nets["nk"]
    for seed in (4, 5):
        img = _image((64, 96, 3), seed)
        ref_logits = np.asarray(j_logits(params, img, arch))
        logits = net.route(torch.from_numpy(img)).numpy()
        np.testing.assert_allclose(logits, ref_logits, rtol=0, atol=1e-5)
        name = arch.bin_configurations[int(np.argmax(ref_logits))].name
        _close(net(torch.from_numpy(img)).numpy(),
               J_ZOE(params, img, arch, name),
               1e-5)
        for bc in arch.bin_configurations:
            _close(net(torch.from_numpy(img), bin_config_name=bc.name).numpy(),
                   J_ZOE(params, img, arch, bc.name), 1e-5)


def test_zoedepth_normed_bins_match_jax(zoe_nets):
    """The 'normed' bin centres (sorted, clipped; the HF-preserved attractor
    indexing) on both heads: within 1e-5 of the scale (measured 4e-7)."""
    _, arch, params, net = zoe_nets["normed"]
    img = _image((64, 64, 3), 6)
    for bc in arch.bin_configurations:
        _close(net(torch.from_numpy(img), bin_config_name=bc.name).numpy(),
               J_ZOE(params, img, arch, bc.name), 1e-5)


# ------------------------------------------------------- Depth Anything --

@pytest.mark.parametrize("name,size", [("relative", 56), ("relative", 84),
                                       ("metric", 56)],
                         ids=["relative", "non_native", "metric"])
def test_depth_anything_matches_jax(da_nets, name, size):
    """Relative and metric heads at the native 56², and 84² (the position
    embeddings through the port's ``jax.image.resize`` bicubic): within
    1e-5 of the scale (measured 8e-7 to 1.3e-6)."""
    _, arch, params, net = da_nets[name]
    img = _image((size, size, 3), size + 7)
    out = net(torch.from_numpy(img)).numpy()
    _close(out, J_DA(params, img, arch), 1e-5)
    if name == "metric":
        assert (out >= 0).all() and (out <= 20.0).all()


def test_arch_from_params_matches_jax(dpt_net, zoe_nets, da_nets):
    pairs = [(tdpt, jdpt, dpt_net[2]), (tda, jda, da_nets["relative"][2])]
    pairs += [(tzoe, jzoe, zoe_nets[k][2]) for k in ("single", "nk")]
    for port, ref, params in pairs:
        got = dataclasses.asdict(port.arch_from_params(params))
        want = dataclasses.asdict(ref.arch_from_params(params))
        assert json.dumps(got, default=list) == json.dumps(want,
                                                           default=list)


# ------------------------------------------------------- the trunk ------

@pytest.fixture(scope="module")
def small_trunk(tmp_path_factory):
    """The JAX package's compact trunk at dim 32 (91 leaves), initialised
    by flax and saved with its ``save_npz_weights``."""
    model = jmono.DPTDepthModel(dim=32, depth_blocks=4, heads=2, features=16)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((64, 64, 3)))
    path = tmp_path_factory.mktemp("trunk") / "trunk.npz"
    jmono.save_npz_weights(params, path)
    net = tmono.DPTDepthModel(dim=32, depth_blocks=4, heads=2, features=16,
                              image_size=(64, 64)).init_random(1)
    tmono.load_npz_weights(net, path)
    return model, params, path, net


def test_compact_trunk_matches_flax(small_trunk):
    """The trunk on flax's own params (tanh GELU, LayerNorm eps 1e-6, the
    attention kernels' (dim, heads, head_dim) layout, jax.image.resize):
    within 1e-5 of the scale (measured 8.5e-7)."""
    model, params, _, net = small_trunk
    assert len(jax.tree_util.tree_leaves(params)) == 91
    assert sum(1 for _ in net.parameters()) == 91
    img = np.random.default_rng(7).uniform(0, 1, (64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        out = net(torch.from_numpy(img)).numpy()
    _close(out, model.apply(params, jnp.asarray(img)), 1e-5)


def test_trunk_npz_round_trip(small_trunk, tmp_path):
    """Each flax leaf lands by its index (``Conv_10`` is conv[10], which a
    mapping by sorted name would put third), and the port's
    ``save_npz_weights`` writes the JAX package's file back exactly, which
    the JAX package's loader reads."""
    _, params, path, net = small_trunk
    k10 = np.asarray(params["params"]["Conv_10"]["kernel"])
    np.testing.assert_array_equal(net.conv[10].weight.detach().numpy(),
                                  k10.transpose(3, 2, 0, 1))
    out = tmp_path / "back.npz"
    tmono.save_npz_weights(net, out)
    with np.load(path) as a, np.load(out) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jmono.load_npz_weights(params, out)
    for x, y in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# ------------------------------------------------------ the pipeline ----

@pytest.fixture(scope="module")
def npz_files(tmp_path_factory, dpt_net, zoe_nets, da_nets):
    """One ported npz of each net, a default-size trunk npz saved by the
    JAX package, and a file that is no npz."""
    root = tmp_path_factory.mktemp("npz")
    files = {}
    for kind, params in (("dpt", dpt_net[2]),
                         ("zoedepth", zoe_nets["single"][2]),
                         ("depth_anything", da_nets["relative"][2])):
        files[kind] = root / f"{kind}.npz"
        np.savez(files[kind], **params)
    files["trunk"] = root / "trunk.npz"
    jmono.save_npz_weights(jax.jit(jmono.DPTDepthModel().init)(
        jax.random.PRNGKey(3), jnp.zeros((384, 384, 3))), files["trunk"])
    files["none"] = root / "none.npz"
    files["none"].write_bytes(b"not an npz")
    return files


@pytest.fixture(scope="module")
def jax_trunk(npz_files):
    """The JAX package's pipeline on the trunk npz (its flax init is slow)."""
    return jmono.VisualPipeline(weights_path=str(npz_files["trunk"]))


@pytest.mark.parametrize("kind", ["dpt", "zoedepth", "depth_anything",
                                  "trunk", "none"])
def test_detect_ported(npz_files, kind):
    got = tmono.VisualPipeline._detect_ported(npz_files[kind])
    assert got == jmono.VisualPipeline._detect_ported(npz_files[kind])
    assert got == (kind if kind in ("dpt", "zoedepth", "depth_anything")
                   else None)


@pytest.mark.parametrize("kind", ["dpt", "zoedepth", "depth_anything",
                                  "trunk"])
def test_predict_depth_matches_jax(npz_files, jax_trunk, kind):
    """``VisualPipeline.predict_depth`` on a 100x72 uint8 image, each net's
    preprocess, the net and the bicubic resize back: within 1e-5 of the
    scale (measured 1.2e-6 for the trunk at 384²)."""
    size = {"depth_anything": (56, 56), "trunk": (384, 384)}.get(kind,
                                                                 (64, 64))
    path = str(npz_files[kind])
    port = tmono.VisualPipeline(model_type="zoe", image_size=size,
                                weights_path=path, device="cpu")
    ref = jax_trunk if kind == "trunk" else jmono.VisualPipeline(
        model_type="zoe", image_size=size, weights_path=path)
    assert port._faithful == ref._faithful == (kind != "trunk")
    rgb = np.random.default_rng(8).integers(0, 255, (72, 100, 3),
                                            dtype=np.uint8)
    out = port.predict_depth(rgb)
    assert out.shape == (72, 100) and out.dtype == np.float32
    assert np.isfinite(out).all() and (out >= 0).all()
    _close(out, ref.predict_depth(rgb), 1e-5)


def test_predict_writes_jax_s_pngs(npz_files, jax_trunk, tmp_path):
    """``predict`` over a directory (PNGs read by the port's codec): the
    uint16-mm files equal the JAX package's within 1 mm, the truncating
    cast of depths that agree to about 1e-5 m."""
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(9)
    for i in range(3):
        write_png(imgs / f"frame_{i:05d}.png",
                  rng.integers(0, 255, (60, 80, 3), dtype=np.uint8))
    (imgs / "notes.txt").write_text("skipped")
    path = str(npz_files["trunk"])
    tmono.VisualPipeline(weights_path=path, device="cpu").predict(
        imgs, tmp_path / "port")
    jax_trunk.predict(imgs, tmp_path / "jax")
    names = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == [f"frame_{i:05d}.png" for i in range(3)]
    for name in names:
        a = read_png(tmp_path / "port" / name).astype(np.int64)
        b = read_png(tmp_path / "jax" / name).astype(np.int64)
        assert a.shape == (60, 80) and (a > 0).mean() > 0.5
        assert np.abs(a - b).max() <= 1, name


def test_pipeline_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        tmono.VisualPipeline()
    with pytest.raises(ValueError, match="model_type"):
        tmono.VisualPipeline(model_type="midas", device="cpu")


# ------------------------------------------------- random checkpoints ---

@pytest.mark.parametrize("net", sorted(rck.ARCHS))
def test_random_checkpoint_has_the_published_tensors(net):
    """``ported_shapes`` at the published widths equals transformers' own
    model of that size, built on the meta device (no memory), name for
    name and shape for shape in the ported layouts."""
    from transformers import (DepthAnythingConfig,
                              DepthAnythingForDepthEstimation, Dinov2Config,
                              DPTConfig, DPTForDepthEstimation,
                              ZoeDepthConfig, ZoeDepthForDepthEstimation)

    if net == "dpt":
        model = DPTForDepthEstimation, DPTConfig(
            hidden_size=1024, num_hidden_layers=24, num_attention_heads=16,
            intermediate_size=4096, image_size=384, patch_size=16,
            backbone_out_indices=[5, 11, 17, 23],
            neck_hidden_sizes=[256, 512, 1024, 1024],
            fusion_hidden_size=256, readout_type="project")
    elif net == "depth_anything":
        model = DepthAnythingForDepthEstimation, DepthAnythingConfig(
            backbone_config=Dinov2Config(
                image_size=518, patch_size=14, hidden_size=384,
                num_hidden_layers=12, num_attention_heads=6, mlp_ratio=4,
                out_indices=[9, 10, 11, 12], apply_layernorm=True,
                reshape_hidden_states=False),
            patch_size=14, reassemble_hidden_size=384,
            neck_hidden_sizes=[48, 96, 192, 384], fusion_hidden_size=64,
            head_hidden_size=32)
    elif net == "zoe_n":
        model = ZoeDepthForDepthEstimation, ZoeDepthConfig()
    else:
        model = ZoeDepthForDepthEstimation, ZoeDepthConfig(
            bin_configurations=[dataclasses.asdict(b) for b in
                                tzoe.ZOEDEPTH_NK.bin_configurations],
            num_patch_transformer_layers=4, patch_transformer_hidden_size=128,
            patch_transformer_intermediate_size=1024,
            patch_transformer_num_attention_heads=4)
    with torch.device("meta"):
        hf = model[0](model[1]).state_dict()
    want = {}
    for k, v in hf.items():
        s = tuple(v.shape)
        if k.endswith(".weight") and len(s) == 4:
            s = (s[2], s[3], s[1], s[0])
        elif k.endswith(".weight") and len(s) == 2:
            s = s[::-1]
        want[k] = s
    kind, arch = rck.ARCHS[net]
    assert rck.ported_shapes(kind, arch) == want


def test_random_checkpoint_runs_both_packages(tmp_path):
    """A random ZoeD_NK checkpoint at narrow widths, through the npz and the
    real loader: the same route and depth as the JAX package (within 1e-5
    of the scale), and a depth that varies over the image."""
    arch = tzoe.ZoeDepthArch(
        hidden_size=64, num_layers=4, num_heads=2, intermediate_size=128,
        image_size=64, backbone_out_indices=(1, 2, 3, 4),
        neck_hidden_sizes=(16, 32, 64, 64), fusion_hidden_size=32,
        bottleneck_features=32, num_relative_features=8,
        bin_configurations=tzoe.ZOEDEPTH_NK.bin_configurations)
    path = tmp_path / "nk.npz"
    np.savez(path, **rck.random_checkpoint("zoedepth", arch, seed=0))
    net = tzoe.ZoeDepth.from_npz(path, arch)
    params = jdpt.load_ported_npz(path)
    jarch = jzoe.ZoeDepthArch(**{
        f.name: getattr(arch, f.name) for f in dataclasses.fields(arch)
        if f.name != "bin_configurations"}, bin_configurations=tuple(
            jzoe.BinConfig(**dataclasses.asdict(b))
            for b in arch.bin_configurations))
    img = _image((64, 96, 3), 10)
    name = arch.bin_configurations[int(torch.argmax(net.route(
        torch.from_numpy(img))))].name
    out = net(torch.from_numpy(img)).numpy()
    _close(out, J_ZOE(params, img, jarch, name), 1e-5)
    assert out.std() > 1e-3 * out.mean() > 0

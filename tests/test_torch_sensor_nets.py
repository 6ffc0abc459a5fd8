"""The DenseTact sensor nets and their losses (``touchgs_torch/touch``:
``losses``, the faithful DenseNet and SwinV2 nets, the compact nets)
against the JAX package's (``touchgs_tpu/touch``), on the CPU, on the same
inputs from numpy seeds.  The sensor, its loop and the train steps are in
``tests/test_torch_sensor.py``.

The faithful nets read one npz in both packages (at the JAX tests' TINY
DenseNet and a small SwinV2 with a shifted block); the compact nets share
flax's parameters through ``load_flax_params``.  Tolerances: outputs within
1e-5 of their range, losses rtol 1e-5, gradients atol 5e-6, unless a test
states another with its measurement.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from touchgs_tpu.touch import densetact_nets as jdt
from touchgs_tpu.touch import losses as jl
from touchgs_tpu.touch import sensor_nets as jsn
from touchgs_tpu.touch import swin_force as jsw
from touchgs_torch.tools import random_checkpoint as rck
from touchgs_torch.touch import densetact_nets as tdt
from touchgs_torch.touch import losses as tl
from touchgs_torch.touch import sensor_nets as tsn
from touchgs_torch.touch import swin_force as tsw

TINY = dict(init_features=16, growth=8, blocks=(2, 2, 2, 2), bn_size=2)
# a small SwinV2: stage 0 at 16x16 with window 8 (block 1 shifted, with its
# mask), stage 1 at 8x8, where the resolution equals the window (no shift)
SMALL_SWIN = dict(img_size=64, patch_size=4, embed_dim=24, depths=(2, 2),
                  num_heads=(2, 4), window_size=8, num_classes=10)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for this module (ROADMAP.md C18),
    restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def assert_close_range(out, ref, tol=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(float(np.ptp(ref)), 1e-30)
    err = float(np.abs(out - ref).max()) / scale
    assert err <= tol, f"{err:.3e} of the range {scale:.3e}"


# ------------------------------------------------------------- losses --

@pytest.fixture(scope="module")
def depth_pair():
    rng = np.random.default_rng(0)
    gt = rng.uniform(0.5, 3.0, (2, 32, 32)).astype(np.float32)
    pred = (gt * rng.uniform(0.8, 1.2, gt.shape)).astype(np.float32)
    return gt, pred, gt > 1.0          # the mask drops about a fifth


SCALAR_LOSSES = {
    "silog_masked": lambda m, p, g, k: m.silog_loss(p, g, k,
                                                    variance_focus=0.85),
    "silog": lambda m, p, g, k: m.silog_loss(p, g),
    "rmslog_masked": lambda m, p, g, k: m.rmslog_loss(p, g, k),
    "rmslog": lambda m, p, g, k: m.rmslog_loss(p, g),
    "rmse": lambda m, p, g, k: m.rmse_loss(p, g),
    "ssim_32x32": lambda m, p, g, k: m.densetact_ssim(p, g),
    "ssim_7x9": lambda m, p, g, k: m.densetact_ssim(p[..., :7, :9],
                                                    g[..., :7, :9]),
    "gradient": lambda m, p, g, k: m.gradient_loss(g, p),
    "densetact_depth": lambda m, p, g, k: m.densetact_depth_loss(p, g),
}


@pytest.mark.parametrize("name", sorted(SCALAR_LOSSES))
def test_loss_matches_jax(depth_pair, name):
    gt, pred, mask = depth_pair
    fn = SCALAR_LOSSES[name]
    ref = float(fn(jl, jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask)))
    out = float(fn(tl, t(pred), t(gt), torch.from_numpy(mask)))
    np.testing.assert_allclose(out, ref, rtol=1e-5)


def test_ssim_window_smaller_than_map_is_clipped(depth_pair):
    """At 7x9 the window is 7 wide (``min(11, H, W)``), and a map equal to
    itself scores 1."""
    gt, _, _ = depth_pair
    small = t(gt[..., :7, :9])
    assert tl._gaussian_window(min(11, 7, 9), 1.5).shape == (7,)
    np.testing.assert_allclose(float(tl.densetact_ssim(small, small)), 1.0,
                               rtol=1e-5)


def test_image_gradients_match_jax(depth_pair):
    gt, _, _ = depth_pair
    for out, ref in zip(tl.image_gradients(t(gt)),
                        jl.image_gradients(jnp.asarray(gt))):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("which", ["depth", "force"])
def test_error_metrics_match_jax(depth_pair, which):
    gt, pred, _ = depth_pair
    if which == "force":
        rng = np.random.default_rng(1)
        gt = rng.normal(size=(5, 6)).astype(np.float32)
        pred = gt + rng.normal(0, 0.1, gt.shape).astype(np.float32)
    jfn = getattr(jl, f"compute_{which}_errors")
    tfn = getattr(tl, f"compute_{which}_errors")
    ref = jfn(jnp.asarray(gt), jnp.asarray(pred))
    out = tfn(t(gt), t(pred))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("name", ["densetact_depth", "silog_masked"])
def test_loss_gradient_matches_jax(depth_pair, name):
    gt, pred, mask = depth_pair
    fn = SCALAR_LOSSES[name]
    ref = jax.grad(lambda p: fn(jl, p, jnp.asarray(gt), jnp.asarray(mask)))(
        jnp.asarray(pred))
    p = t(pred).requires_grad_(True)
    fn(tl, p, t(gt), torch.from_numpy(mask)).backward()
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref), atol=5e-6)


# ------------------------------------------------------ faithful nets --

def _perturbed(params: dict, seed: int) -> dict:
    """The init's params with BatchNorm statistics, affine terms and biases
    redrawn (the init leaves them at 0 and 1, which would hide a swapped
    name), as numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in params.items():
        v = np.asarray(v)
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 2.0, v.shape)
        elif k.endswith(("running_mean", ".bias")):
            v = rng.normal(0, 0.2, v.shape)
        elif v.ndim == 1:                              # BatchNorm scale
            v = rng.uniform(0.5, 1.5, v.shape)
        out[k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def densetact_npz(tmp_path_factory):
    """TINY DenseDepth and DenseNet_Force as npz files, one each."""
    root = tmp_path_factory.mktemp("densetact")
    paths = {}
    for kind, init in (("depth", jdt.init_dense_depth_params),
                       ("force", jdt.init_densenet_force_params)):
        paths[kind] = root / f"{kind}.npz"
        np.savez(paths[kind], **_perturbed(init(seed=1, cfg=TINY), 2))
    return paths


def _image(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _jparams(path):
    with np.load(path) as data:
        return {k: jnp.asarray(data[k]) for k in data.files}


SIZES = [(64, 64), (67, 61)]


@pytest.mark.parametrize("size", SIZES)
def test_densenet_features_match_jax(densetact_npz, size):
    img = _image(size + (3,), 3)
    net = tdt.DenseDepth.from_npz(densetact_npz["depth"])
    assert net.arch == TINY
    with torch.no_grad():
        out = tdt.densenet161_features(net.params(), t(img).permute(2, 0, 1)
                                       [None], cfg=net.arch)
    ref = jdt.densenet161_features(_jparams(densetact_npz["depth"]),
                                   jnp.asarray(img)[None], cfg=TINY)
    assert len(out) == len(ref) == 13
    for o, r in zip(out, ref):
        assert_close_range(o.permute(0, 2, 3, 1).numpy(), r)


@pytest.mark.parametrize("size", SIZES)
def test_densenet_classify_matches_jax(densetact_npz, size):
    img = _image(size + (3,), 4)
    net = tdt.DenseNetForce.from_npz(densetact_npz["force"])
    with torch.no_grad():
        out = tdt.densenet161_classify(net.params(),
                                       t(img).permute(2, 0, 1)[None],
                                       cfg=net.arch)
    ref = jdt.densenet161_classify(_jparams(densetact_npz["force"]),
                                   jnp.asarray(img)[None], cfg=TINY)
    assert_close_range(out.numpy(), ref)


@pytest.mark.parametrize("size", SIZES)
def test_dense_depth_matches_jax(densetact_npz, size):
    img = _image(size + (3,), 5)
    out = tdt.DenseDepth.from_npz(densetact_npz["depth"])(t(img))
    ref = jdt.dense_depth_forward(_jparams(densetact_npz["depth"]),
                                  jnp.asarray(img), max_depth=256.0,
                                  cfg=TINY)
    assert out.shape == (2 * ((size[0] + 1) // 2), 2 * ((size[1] + 1) // 2))
    assert_close_range(out.numpy(), ref)


@pytest.mark.parametrize("size", SIZES)
def test_densenet_force_matches_jax(densetact_npz, size):
    img = _image(size + (3,), 6)
    out = tdt.DenseNetForce.from_npz(densetact_npz["force"])(t(img))
    ref = jdt.densenet_force_forward(_jparams(densetact_npz["force"]),
                                     jnp.asarray(img), cfg=TINY)
    assert out.shape == (6,)
    assert_close_range(out.numpy(), ref)


@pytest.mark.parametrize("kind,cfg", [("depth", TINY), ("force", TINY),
                                      ("depth", jdt.DENSENET161)])
def test_densenet_init_equals_jax_bit_for_bit(kind, cfg):
    jinit = getattr(jdt, {"depth": "init_dense_depth_params",
                          "force": "init_densenet_force_params"}[kind])
    tinit = getattr(tdt, {"depth": "init_dense_depth_params",
                          "force": "init_densenet_force_params"}[kind])
    ref, out = jinit(seed=7, cfg=cfg), tinit(seed=7, cfg=cfg)
    assert list(out) == list(ref)
    for k in ref:
        assert out[k].dtype == np.float32
        np.testing.assert_array_equal(out[k], np.asarray(ref[k]), err_msg=k)
    assert tdt.decoder_skip_channels(cfg) == jdt.decoder_skip_channels(cfg)


@pytest.mark.parametrize("kind", ["densetact_depth", "densetact_force"])
@pytest.mark.parametrize("cfg", [TINY, jdt.DENSENET161],
                         ids=["tiny", "densenet161"])
def test_densetact_checkpoint_shapes_match_jax_init(kind, cfg):
    """``random_checkpoint``'s list of names and shapes (written apart from
    the init) is the JAX init's, and its draws are the JAX init's."""
    init = {"densetact_depth": jdt.init_dense_depth_params,
            "densetact_force": jdt.init_densenet_force_params}[kind]
    ref = init(seed=0, cfg=cfg)
    shapes = rck.ported_shapes(kind, cfg)
    assert shapes == {k: tuple(v.shape) for k, v in ref.items()}
    if cfg is TINY:
        ck = rck.random_checkpoint(kind, cfg, 0)
        for k in ref:
            np.testing.assert_array_equal(ck[k], np.asarray(ref[k]))


# --------------------------------------------------------------- swin --

class _Reads(dict):
    """A dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, k):
        self.read.add(k)
        return super().__getitem__(k)

    def get(self, k, default=None):
        if k in self:
            self.read.add(k)
        return super().get(k, default)


@pytest.fixture(scope="module")
def swin_params():
    """A random STForce checkpoint at SMALL_SWIN, with the logit scales,
    biases and norms redrawn so every term moves the output."""
    arch = jsw.SwinArch(**SMALL_SWIN)
    params = rck.random_checkpoint("stforce", tsw.SwinArch(**SMALL_SWIN), 3)
    rng = np.random.default_rng(4)
    for k, v in params.items():
        if k.endswith("logit_scale"):
            params[k] = rng.uniform(0.5, 5.5, v.shape).astype(np.float32)
        elif v.ndim == 1:
            params[k] = (v + rng.normal(0, 0.2, v.shape)).astype(np.float32)
    return arch, params


def test_stforce_checkpoint_is_what_the_jax_forward_reads(swin_params):
    """Every tensor ``random_checkpoint("stforce")`` lists is read by the
    JAX package's ``stforce_forward``, and it reads nothing else."""
    arch, params = swin_params
    reads = _Reads({k: jnp.asarray(v) for k, v in params.items()})
    jsw.stforce_forward(reads, jnp.zeros((64, 64, 3)), arch)
    assert reads.read == set(params)
    full = rck.ported_shapes("stforce", tsw.STFORCE_SWIN)
    assert full["backbone.layers.2.blocks.17.attn.cpb_mlp.2.weight"] == (
        512, 24)
    assert full["backbone.head.weight"] == (1536, 1000)
    assert tsw.arch_from_params({k: np.broadcast_to(np.float32(0), v)
                                 for k, v in full.items()}) == tsw.STFORCE_SWIN


def test_swin_tables_and_mask_equal_jax():
    np.testing.assert_array_equal(tsw._coords_table(8, 8),
                                  jsw._coords_table(8, 8))
    np.testing.assert_array_equal(tsw._rel_position_index(8, 8),
                                  jsw._rel_position_index(8, 8))
    np.testing.assert_array_equal(tsw.sw_mask(16, 16, 8, 4),
                                  np.asarray(jsw._sw_mask(16, 16, 8, 4)))
    blocks = list(tsw.stages(tsw.SwinArch(**SMALL_SWIN)))
    assert [(b[3], b[6], b[7]) for b in blocks] == [
        (16, 8, 0), (16, 8, 4), (8, 8, 0), (8, 8, 0)]
    # at 640² the last stage is 20x20 with window 20: no shift
    last = list(tsw.stages(tsw.STFORCE_SWIN))[-1]
    assert (last[3], last[6], last[7]) == (20, 20, 0)


def test_swin_v2_forward_matches_jax(swin_params):
    arch, params = swin_params
    img = _image((64, 64, 3), 8)
    net = tsw.STForce(params, tsw.SwinArch(**SMALL_SWIN))
    with torch.no_grad():
        out = tsw.swin_v2_forward(net.params(), t(img), net.arch)
    ref = jsw.swin_v2_forward({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(img), arch)
    assert out.shape == (10,)
    assert_close_range(out.numpy(), ref)


def test_stforce_matches_jax(swin_params, tmp_path):
    """STForce loaded from an npz (cached bias tables and masks) against
    the JAX package's forward on the same file."""
    arch, params = swin_params
    np.savez(tmp_path / "stforce.npz", **params)
    net = tsw.STForce.from_npz(tmp_path / "stforce.npz")
    assert net.arch == tsw.SwinArch(**{**SMALL_SWIN, "img_size": 640,
                                       "window_size": 20})
    net = tsw.STForce.from_npz(tmp_path / "stforce.npz",
                               tsw.SwinArch(**SMALL_SWIN))
    img = _image((64, 64, 3), 9)
    out = net(t(img))
    ref = jsw.stforce_forward({k: jnp.asarray(v) for k, v in params.items()},
                              jnp.asarray(img), arch)
    assert_close_range(out.numpy(), ref)


# -------------------------------------------------------- compact nets --

def _flax_params(net, seed):
    """flax's init (jitted, at 16x16: the parameters do not depend on the
    size), every 1-D leaf (biases, norm scales) redrawn to order one, as
    numpy."""
    p = jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.zeros((16, 16, 3)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.3, a.shape)).astype(
            np.float32) if a.ndim == 1 else np.asarray(a), p)


@pytest.fixture(scope="module")
def compact():
    """{name: (flax net, its parameters, the port's net carrying them)}."""
    out = {}
    for i, (name, jnet, tnet) in enumerate((
            ("depth", jsn.TouchDepthNet(), tsn.TouchDepthNet()),
            ("force", jsn.ForceNet(), tsn.ForceNet()))):
        params = _flax_params(jnet, i)
        out[name] = (jnet, params, tsn.load_flax_params(tnet, params))
    return out


@pytest.mark.parametrize("size", [(64, 64), (45, 37)])
@pytest.mark.parametrize("name", ["depth", "force"])
def test_compact_net_matches_flax(compact, name, size):
    jnet, params, tnet = compact[name]
    img = np.random.default_rng(10).integers(0, 256, size + (3,)).astype(
        np.float32)
    ref = jax.jit(jnet.apply)(params, img)
    with torch.no_grad():
        out = tnet(t(img))
    assert_close_range(out.numpy(), ref)


def test_load_flax_params_needs_every_leaf(compact):
    _, params, _ = compact["force"]
    params = jax.tree.map(lambda a: a, params)
    del params["params"]["Dense_1"]
    with pytest.raises(KeyError, match="lacks"):
        tsn.load_flax_params(tsn.ForceNet(), params)


@pytest.mark.parametrize("scale", [255, 1])
def test_normalize_tactile_matches_jax(scale):
    img = np.random.default_rng(11).integers(0, 256, (2, 9, 7, 3))
    img = (img if scale == 255 else img / 255.0).astype(np.float32)
    ref = np.stack([jsn.normalize_tactile(im) for im in img])
    np.testing.assert_allclose(tsn.normalize_tactile(t(img)).numpy(), ref,
                               atol=1e-6)
    np.testing.assert_allclose(tsn.normalize_tactile(t(img[0])).numpy(),
                               ref[0], atol=1e-6)


def test_denormalize_force_matches_jax():
    pred = np.random.default_rng(12).uniform(0, 1, 6).astype(np.float32)
    np.testing.assert_allclose(tsn.denormalize_force(t(pred)).numpy(),
                               np.asarray(jsn.denormalize_force(pred)),
                               atol=1e-6)

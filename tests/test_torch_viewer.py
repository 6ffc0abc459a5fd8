"""The port's live viewer (``touchgs_torch/viewer/``) against the JAX
package's (``touchgs_tpu/viewer/``) on the CPU.

The orbit cameras are compared exactly; the routes and their error codes
on a server over a fixed render callable; a ``/render`` frame of the
port's server on a port ``Trainer`` whose state is carried across from a
JAX ``Trainer`` (``state_from_numpy``) against the JAX server's frame on
that JAX trainer, decoded, within 1/255 at every pixel in each mode; and a
frame served while ``Trainer.run(viewer=...)`` trains, which must come
from the snapshot published at the previous log point."""
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import touchgs_tpu.config as jcfg
import touchgs_torch.config as tcfg
from touchgs_tpu.data.cameras import Cameras as JCameras
from touchgs_tpu.data.scene import Scene as JScene
from touchgs_tpu.train import trainer as jtr
from touchgs_tpu.viewer import ViewerServer as JViewer
from touchgs_tpu.viewer import orbit_c2w as j_orbit
from touchgs_torch.data.cameras import Camera, Cameras as TCameras
from touchgs_torch.data.png import decode_png
from touchgs_torch.data.scene import Scene as TScene
from touchgs_torch.models.splatfacto import render as t_render
from touchgs_torch.train import trainer as ttr
from touchgs_torch.viewer import ViewerServer, orbit_c2w
from touchgs_torch.viewer.server import frame_bytes

from tests.test_torch_train import _cfg, _leaves, _scene, _scene_arrays

FRAME = dict(theta=0.4, phi=0.35, radius=2.6, w=64, h=48)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """PyTorch on one intra-op thread for this module (several test
    workers share the cores); restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _query(mode, **kw):
    q = dict(FRAME, mode=mode, **kw)
    return "render?" + "&".join(f"{k}={v}" for k, v in q.items())


@pytest.mark.parametrize("theta,phi,radius,center", [
    (0.0, 0.3, 2.5, (0.0, 0.0, 0.0)),
    (0.7, -0.4, 1.2, (0.1, -0.2, 0.3)),
    (-2.9, 1.2, 4.0, (1.0, 2.0, -3.0)),
    (1.3, 1.6, 2.0, (0.0, 0.0, 0.0)),      # beyond the clip: φ = 1.55
    (2.2, -7.0, 3.0, (0.5, 0.0, 0.0)),     # beyond the clip: φ = −1.55
])
def test_orbit_c2w_matches_jax(theta, phi, radius, center):
    t = orbit_c2w(theta, phi, radius, center)
    assert t.dtype == np.float32
    np.testing.assert_array_equal(t, j_orbit(theta, phi, radius, center))
    if abs(phi) > 1.55:
        np.testing.assert_array_equal(
            t, orbit_c2w(theta, float(np.sign(phi)) * 1.55, radius, center))


@pytest.fixture(scope="module")
def fixed_viewer():
    """A server over a fixed render: half-red rgb, depth ramp, acc 1."""
    def render_fn(c2w, w, h):
        rgb = np.zeros((h, w, 3), np.float32)
        rgb[..., 0] = 0.5
        return {"rgb": rgb,
                "depth": np.linspace(1, 2, h * w, dtype=np.float32
                                     ).reshape(h, w),
                "acc": np.ones((h, w), np.float32)}

    srv = ViewerServer(render_fn=render_fn, port=0).start()
    yield srv
    srv.stop()


def test_routes_and_codes(fixed_viewer):
    v = fixed_viewer
    v.update_status(42, 0.125, 1000)
    code, ctype, body = _get(v.url + "state")
    assert (code, ctype) == (200, "application/json")
    assert json.loads(body) == {"step": 42, "loss": 0.125, "num_alive": 1000,
                                "training": True}
    code, ctype, body = _get(v.url)
    assert code == 200 and b"touchgs_torch viewer" in body
    code, ctype, png = _get(v.url + _query("rgb"))
    assert (code, ctype) == (200, "image/png")
    img = decode_png(png).pixels
    assert img.shape == (48, 64, 3) and (img[..., 0] == 127).all()
    for path, want in (("nowhere", 404), ("render?theta=abc", 400),
                       ("render?w=1.5", 400)):
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(v.url + path)
        assert e.value.code == want, path
    # sizes are clamped to [1, max_dim]
    _, _, png = _get(v.url + "render?w=4096&h=0")
    assert decode_png(png).pixels.shape == (1, 1024, 3)


def test_render_errors_are_500():
    def broken(c2w, w, h):
        raise RuntimeError("no device")

    with ViewerServer(render_fn=broken, port=0) as v:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(v.url + _query("rgb"))
    assert e.value.code == 500 and e.value.read() == b"no device"


@pytest.fixture(scope="module")
def trainers():
    """(JAX trainer, port trainer) on one scene through the tile kernels
    (Pallas in interpret mode; the kernels' plain versions), the port's
    state the JAX trainer's after 2 steps."""
    a = _scene_arrays()
    jt = jtr.Trainer(_scene(a, JCameras, JScene), _cfg(jcfg))
    jt.run(2)
    tt = ttr.Trainer(_scene(a, TCameras, TScene), _cfg(tcfg), device="cpu")
    tt.state = ttr.state_from_numpy(_leaves(jt.state), "cpu")
    return jt, tt


@pytest.mark.parametrize("mode", ["rgb", "depth", "acc"])
def test_frame_matches_jax_server(trainers, mode):
    jt, tt = trainers
    with JViewer(trainer=jt, port=0) as jv, ViewerServer(trainer=tt,
                                                         port=0) as tv:
        j = decode_png(_get(jv.url + _query(mode))[2]).pixels.astype(int)
        t = decode_png(_get(tv.url + _query(mode))[2]).pixels.astype(int)
    assert t.shape == j.shape == (48, 64, 3)
    assert np.ptp(t) > 50, "a blank frame"
    assert np.abs(t - j).max() <= 1, np.abs(t - j).max()


def test_live_frames_read_the_snapshot():
    """At step 1's log point the parameters have moved past the snapshot
    published at step 0; a frame served then renders the snapshot, which
    is a copy, not the trainer's tensors."""
    tt = ttr.Trainer(_scene(_scene_arrays(), TCameras, TScene), _cfg(tcfg),
                     device="cpu")
    seen = {}
    with ViewerServer(trainer=tt, port=0) as v:
        def log_fn(m):
            if m["step"] == 0:
                seen["means0"] = tt.state.params.means.clone()
            elif m["step"] == 1:
                snap = v._params_snapshot
                assert snap.means is not tt.state.params.means
                torch.testing.assert_close(snap.means, seen["means0"],
                                           rtol=0, atol=0, equal_nan=True)
                assert not torch.equal(tt.state.params.means.nan_to_num(),
                                       seen["means0"].nan_to_num())
                seen["png"] = _get(v.url + _query("rgb"))[2]
                seen["snap"] = snap
                seen["state"] = json.loads(_get(v.url + "state")[2])

        tt.run(3, log_fn=log_fn, viewer=v)
        assert v.status()["step"] == 2 and not v.status()["training"]
    assert seen["state"]["step"] == 0 and seen["state"]["training"]
    # the served frame is the snapshot's render, quantised as the server does
    c2w = orbit_c2w(FRAME["theta"], FRAME["phi"], FRAME["radius"])
    f = np.float32(0.8 * 64)
    cam = Camera(fx=torch.tensor(f), fy=torch.tensor(f),
                 cx=torch.tensor(np.float32(32)),
                 cy=torch.tensor(np.float32(24)), c2w=torch.tensor(c2w),
                 width=64, height=48)
    with torch.no_grad():
        out, _ = t_render(seen["snap"], cam, tt.cfg.model,
                          active_sh_degree=tt.cfg.model.sh_degree)
    np.testing.assert_array_equal(decode_png(seen["png"]).pixels,
                                  frame_bytes({"rgb": out.rgb.numpy()}, "rgb"))

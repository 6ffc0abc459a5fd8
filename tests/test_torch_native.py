"""The native layer (``touchgs_torch/native``: the PNG/JPEG codec, the
threaded loader, the capture tools and the compliant arm) against the JAX
package's (``touchgs_tpu/native``), on the CPU, on inputs from numpy seeds.

Both libraries are loaded into this process: the port's from its own build
directory, the JAX package's built from its sources into a temporary
directory (so this file never races ``tests/test_native.py``'s build under
``touchgs_tpu/native/build/``).  Decodes, encodes and the arm are compared
exactly; the module skips only where ``g++``, ``make``, zlib or libjpeg is
missing.
"""
import ctypes
import io
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from touchgs_tpu.native import arm as jarm
from touchgs_tpu.native import loader as jloader
from touchgs_tpu.touch import sensor_loop as jsl
from touchgs_torch.data.png import read_png
from touchgs_torch.native import arm as tarm
from touchgs_torch.native import loader as tloader
from touchgs_torch.touch import sensor_loop as tsl

from tests.test_torch_sensor import sensors
from tests.test_torch_sensor_nets import one_torch_thread

__all__ = ["sensors", "one_torch_thread"]   # fixtures

ROOT = Path(__file__).resolve().parents[1]
JAX_DIR = ROOT / "touchgs_tpu" / "native"

# the guarded touch of tests/test_native.py: a yaw base and two pitch links
# (standard DH rows a, alpha, d, theta), pressed 3 cm into a plane at 5 N
ARM_DH = [[0.0, -np.pi / 2, 0.4, 0.0], [0.4, 0.0, 0.0, 0.0],
          [0.3, 0.0, 0.0, 0.0]]
ARM_MASS = [2.0, 1.5, 0.8]
ARM_COM = [[0.0, 0.0, 0.2], [0.2, 0.0, 0.0], [0.15, 0.0, 0.0]]
ARM_Q0 = [0.0, -0.4, 0.8]
ARM_K, ARM_D = [600.0] * 3 + [30.0] * 3, [50.0] * 3 + [3.0] * 3
ARM_STEPS, ARM_F_STOP = 12_000, 5.0


def guarded_touch(arm_module, steps: int = ARM_STEPS) -> dict:
    """The guarded touch with ``arm_module``'s ``CompliantArm`` and
    ``ArmSim`` (the port's or the JAX package's): approach along -z at
    5 cm/s onto a plane 3 cm below the tool until the contact force
    reaches ARM_F_STOP, then hold it.  Returns whether it was held after
    the last step, the contact force, and q after every step."""
    arm = arm_module.CompliantArm(ARM_DH, ARM_MASS, ARM_COM)
    z0 = float(arm.fk(ARM_Q0)[2, 3])
    sim = arm_module.ArmSim(arm, q0=ARM_Q0, plane_z=z0 - 0.03,
                            k_contact=2000.0)
    qs = np.empty((steps, len(ARM_Q0)))
    for i in range(steps):
        held = sim.step_guarded([0.0, 0.0, -1.0], speed=0.05,
                                f_stop=ARM_F_STOP, stiffness=ARM_K,
                                damping=ARM_D, dt=1e-3, tol_n=0.5)
        qs[i] = np.asarray(sim.state()[0])
    force = np.asarray(sim.contact_force())
    arm.close()
    return {"held": held, "force": force, "q": qs}
SOURCES = ("Makefile", "png_io.cpp", "png_io.h", "dataloader.cpp",
           "jpeg_decode.h", "arm_control.cpp", "arm_control.h",
           "v4l2_camera.h", "v4l2_capture.cpp", "sync_capture.cpp")


@pytest.fixture(scope="module", autouse=True)
def libs(tmp_path_factory):
    """(port, JAX) library handles.  Building the port's must succeed
    where the prerequisites are present."""
    missing = tloader.missing_prerequisites()
    if missing:
        pytest.skip(f"the native layer needs {missing}")
    lib = tloader._ensure_built()
    assert lib is not None, tloader._error
    build = tmp_path_factory.mktemp("jax_native")
    so = build / "libtouchgs_native.so"
    subprocess.run(["make", "-C", str(JAX_DIR), f"BUILD={build}", str(so)],
                   check=True, capture_output=True, timeout=300)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jloader, "_SO_PATH", so)
        mp.setattr(jloader, "_lib", None)
        mp.setattr(jloader, "_build_failed", False)
        jlib = jloader._ensure_built()
        assert jlib is not None
        u8 = ctypes.POINTER(ctypes.c_uint8)
        jlib.tgs_decode_jpeg.restype = ctypes.c_int
        jlib.tgs_decode_jpeg.argtypes = [u8, ctypes.c_long, u8,
                                         ctypes.c_long,
                                         ctypes.POINTER(ctypes.c_int)]
        yield lib, jlib


def _ptr(a: np.ndarray, ctype):
    """``a``'s data as a ``ctype`` pointer, which both libraries' argument
    types take."""
    return a.ctypes.data_as(ctypes.POINTER(ctype))


IMAGES = {
    "rgb8": lambda r: r.integers(0, 256, (37, 53, 3), dtype=np.uint8),
    "rgba8": lambda r: r.integers(0, 256, (19, 24, 4), dtype=np.uint8),
    "gray8": lambda r: r.integers(0, 256, (23, 17), dtype=np.uint8),
    "gray16": lambda r: r.integers(0, 65536, (24, 31), dtype=np.uint16),
}


def _write(tmp_path, kind: str, seed: int = 0) -> Path:
    """A PNG of ``kind`` from a seed, written by PIL (another encoder than
    both decoders')."""
    p = tmp_path / f"{kind}_{seed}.png"
    Image.fromarray(IMAGES[kind](np.random.default_rng(seed))).save(p)
    return p


@pytest.mark.parametrize("kind", list(IMAGES))
def test_decode_png_equals_jax(tmp_path, kind):
    """``decode_png`` bit for bit against the JAX package's, and against
    the samples as stored with the contract's division."""
    p = _write(tmp_path, kind)
    out = tloader.decode_png(p)
    ref = jloader.decode_png(p)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.device.type == "cpu" and out.is_contiguous()
    assert tuple(out.shape) == ref.shape and out.dim() == 3
    assert torch.equal(out, torch.from_numpy(ref))
    px = np.asarray(Image.open(p)).astype(np.float32)
    px = px / (1000.0 if kind == "gray16" else 255.0)
    np.testing.assert_array_equal(out.numpy().reshape(px.shape), px)


@pytest.mark.parametrize("kind", list(IMAGES))
def test_fallback_equals_native(tmp_path, monkeypatch, kind):
    """With the library forced off, ``decode_png`` decodes through
    ``data/png.py`` to the same tensor, and ``native_available`` says so;
    the loader and the arm raise."""
    p = _write(tmp_path, kind, seed=1)
    native = tloader.decode_png(p)
    assert tloader.native_available()
    monkeypatch.setattr(tloader, "_lib", None)
    monkeypatch.setattr(tloader, "_error", "forced off")
    assert not tloader.native_available() and not tarm.arm_available()
    out = tloader.decode_png(p)
    assert out.dtype == torch.float32 and torch.equal(out, native)
    with pytest.raises(RuntimeError, match="forced off"):
        tloader.NativeLoader([p])
    with pytest.raises(RuntimeError, match="forced off"):
        tarm.CompliantArm(ARM_DH)


def test_loader_out_of_order_equals_jax(tmp_path):
    """Prefetch everything, then ``get`` in a shuffled order: each tensor
    equal to the JAX loader's; a file that does not decode raises
    ``IOError`` in both, and so does a missing one."""
    kinds = list(IMAGES) * 2
    paths = [_write(tmp_path, k, seed=10 + i) for i, k in enumerate(kinds)]
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\nnot a png")
    paths += [bad, tmp_path / "missing.png"]
    order = np.random.default_rng(3).permutation(len(kinds))
    out, ref = tloader.NativeLoader(paths, 3), jloader.NativeLoader(paths, 3)
    assert len(out) == len(ref) == len(paths)
    for loader in (out, ref):
        for i in range(len(paths)):
            loader.prefetch(i)
    for i in order:
        got = out.get(int(i))
        assert torch.equal(got, torch.from_numpy(ref.get(int(i))))
        assert torch.equal(got, tloader.decode_png_plain(paths[i]))
    for i in (len(paths) - 2, len(paths) - 1):
        for loader in (out, ref):
            with pytest.raises(IOError):
                loader.get(i)
    with pytest.raises(IOError):
        tloader.decode_png(bad)
    out.close(), ref.close()
    out.close()                       # a second close does nothing


def test_jpeg_decode_equals_jax(libs):
    """``tgs_decode_jpeg`` of the port's library against the JAX
    package's, byte for byte, on a seeded JPEG; a malformed stream
    returns -2 in both."""
    lib, jlib = libs
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", quality=90)
    for data in (np.frombuffer(buf.getvalue(), np.uint8),
                 np.arange(100, dtype=np.uint8)):
        outs = []
        for handle in (lib, jlib):
            out = np.zeros(48 * 64 * 3, np.uint8)
            shape = (ctypes.c_int * 3)()
            n = handle.tgs_decode_jpeg(
                _ptr(data, ctypes.c_uint8), len(data),
                _ptr(out, ctypes.c_uint8), out.size, shape)
            outs.append((n, tuple(shape), out))
        assert outs[0][0] == outs[1][0] and outs[0][1] == outs[1][1]
        np.testing.assert_array_equal(outs[0][2], outs[1][2])
    assert outs[0][0] == -2


@pytest.mark.parametrize("kind", ["u16", "u8_gray", "u8_rgb", "u8_rgba"])
def test_encode_png_equals_jax(libs, tmp_path, kind):
    """``tgs_encode_png_u16`` and ``tgs_encode_png_u8`` write the same
    bytes from both libraries, and ``data/png.py`` reads them back."""
    lib, jlib = libs
    rng = np.random.default_rng(5)
    c = {"u16": 1, "u8_gray": 1, "u8_rgb": 3, "u8_rgba": 4}[kind]
    if kind == "u16":
        a = rng.integers(0, 65536, (16, 20), dtype=np.uint16)
    else:
        a = rng.integers(0, 256, (16, 20, c), dtype=np.uint8)
    files = []
    for name, handle in (("port", lib), ("jax", jlib)):
        p = tmp_path / f"{name}.png"
        if kind == "u16":
            rc = handle.tgs_encode_png_u16(str(p).encode(),
                                           _ptr(a, ctypes.c_uint16), 16, 20)
        else:
            rc = handle.tgs_encode_png_u8(str(p).encode(),
                                          _ptr(a, ctypes.c_uint8), 16, 20, c)
        assert rc == 0
        files.append(p.read_bytes())
    assert files[0] == files[1]
    np.testing.assert_array_equal(read_png(tmp_path / "port.png"),
                                  a if c > 1 or kind == "u16" else a[..., 0])


# ---------------------------------------------------------------- arm --

def _dh_chain(q: torch.Tensor):
    """Standard DH in torch: the tool pose, each joint's z axis and origin,
    and the links' centres of mass (the arm of ``guarded_touch``)."""
    T = torch.eye(4, dtype=torch.float64)
    zs, origins, coms = [T[:3, 2]], [T[:3, 3]], []
    for i, (a, alpha, d, theta0) in enumerate(ARM_DH):
        ct, st = torch.cos(theta0 + q[i]), torch.sin(theta0 + q[i])
        ca, sa = np.cos(alpha), np.sin(alpha)
        z, o = torch.zeros((), dtype=torch.float64), torch.ones(
            (), dtype=torch.float64)
        L = torch.stack([
            torch.stack([ct, -st * ca, st * sa, a * ct]),
            torch.stack([st, ct * ca, -ct * sa, a * st]),
            torch.stack([z, z + sa, z + ca, z + d]),
            torch.stack([z, z, z, o])])
        T = T @ L
        coms.append(T @ torch.tensor([*ARM_COM[i], 1.0], dtype=torch.float64))
        zs.append(T[:3, 2])
        origins.append(T[:3, 3])
    return T, zs, origins, coms


QS = np.random.default_rng(8).uniform(-1.5, 1.5, (4, 3))


@pytest.mark.parametrize("qi", range(len(QS)))
def test_arm_kinematics_equal_jax_and_a_torch_chain(qi):
    """``fk``, ``jacobian``, ``gravity`` and ``compliance_tau`` equal the
    JAX package's in float64, exactly, with a target pose that is not
    symmetric (so a row-major pass would differ); and they agree with a
    DH chain in torch: the Jacobian's linear rows with
    ``torch.autograd.functional.jacobian`` of the tool position, its
    angular rows with the joints' z axes, gravity with the gradient of the
    potential energy."""
    q = QS[qi]
    arm, ref = tarm.CompliantArm(ARM_DH, ARM_MASS, ARM_COM), jarm.CompliantArm(
        ARM_DH, ARM_MASS, ARM_COM)
    dq = np.random.default_rng(qi).normal(size=3)
    target = arm.fk(q + 0.2).numpy()
    assert not np.array_equal(target, target.T)
    stiff, damp = [400.0, 500.0, 600.0, 20.0, 25.0, 30.0], [40.0] * 3 + [2.0] * 3
    pairs = [(arm.fk(torch.tensor(q)), ref.fk(q)),
             (arm.jacobian(q), ref.jacobian(q)),
             (arm.gravity(list(q)), ref.gravity(q)),
             (arm.compliance_tau(q, dq, torch.tensor(target), stiff, damp),
              ref.compliance_tau(q, dq, target, stiff, damp))]
    for out, want in pairs:
        assert out.dtype == torch.float64 and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), want)

    qt = torch.tensor(q, dtype=torch.float64)
    T, zs, origins, _ = _dh_chain(qt)
    np.testing.assert_allclose(arm.fk(q).numpy(), T.numpy(), atol=1e-14)
    J = arm.jacobian(q).numpy()
    lin = torch.autograd.functional.jacobian(lambda x: _dh_chain(x)[0][:3, 3],
                                             qt)
    np.testing.assert_allclose(J[:3], lin.numpy(), atol=1e-13)
    np.testing.assert_allclose(J[3:], torch.stack(zs[:3], 1).numpy(),
                               atol=1e-14)
    x = qt.clone().requires_grad_(True)
    pe = sum(m * 9.81 * c[2] for m, c in zip(ARM_MASS, _dh_chain(x)[3]))
    (grad,) = torch.autograd.grad(pe, x)
    np.testing.assert_allclose(arm.gravity(q).numpy(), grad.numpy(),
                               atol=1e-12)
    arm.close(), ref.close()


def test_sim_trajectories_equal_jax():
    """A compliance move and the guarded touch (``guarded_touch``), step
    for step equal to the JAX package's simulator; the touch holds its
    force setpoint."""
    runs = []
    for mod in (tarm, jarm):
        arm = mod.CompliantArm(ARM_DH, ARM_MASS, ARM_COM)
        target = arm.fk([0.2, -0.6, 0.9])
        sim = mod.ArmSim(arm, q0=[0.0, -0.3, 0.5])
        traj = []
        for _ in range(600):
            sim.step_compliance(target, [400.0] * 3 + [20.0] * 3,
                                [40.0] * 3 + [2.0] * 3, dt=1e-3)
            traj.append(np.concatenate([np.asarray(x) for x in sim.state()]))
        runs.append(np.stack(traj))
        arm.close()
    np.testing.assert_array_equal(runs[0], runs[1])
    out, ref = guarded_touch(tarm), guarded_touch(jarm)
    np.testing.assert_array_equal(out["q"], ref["q"])
    np.testing.assert_array_equal(out["force"], ref["force"])
    assert out["held"] and ref["held"]
    assert abs(out["force"][2] - ARM_F_STOP) < 0.5


def test_arm_teardown_and_limits():
    """An arm closes its simulators before it frees itself (the C++ sim
    holds a raw pointer to it); closing twice is safe; 0 or 17 joints are
    rejected, and so is a pose of the wrong size."""
    arm = tarm.CompliantArm(ARM_DH)
    sims = [tarm.ArmSim(arm, [0.0, 0.1, 0.2]) for _ in range(2)]
    q, dq = sims[0].state()
    assert q.tolist() == [0.0, 0.1, 0.2] and dq.tolist() == [0.0] * 3
    arm.close()
    assert all(s._h is None for s in sims) and arm._h is None
    arm.close(), sims[0].close()
    for n in (0, 17):
        with pytest.raises(ValueError, match="n_joints"):
            tarm.CompliantArm([[1.0, 0.0, 0.0, 0.0]] * n)
    arm = tarm.CompliantArm(ARM_DH)
    with pytest.raises(ValueError, match="expected 16"):
        tarm.ArmSim(arm, [0.0] * 3).step_compliance(np.eye(3), ARM_K, ARM_D)
    with pytest.raises(ValueError, match="expected 3"):
        arm.fk([0.0, 0.0])


# -------------------------------------------------------------- tools --

def test_capture_tool_fails_gracefully():
    """``tgs_capture`` without a camera exits 1 with its message."""
    r = subprocess.run([str(tloader.tool("tgs_capture")), "--device",
                        "/dev/null", "--count", "1"], capture_output=True,
                       timeout=30)
    assert r.returncode == 1 and b"tgs_capture:" in r.stderr


def test_sync_capture_layout(tmp_path):
    """``tgs_sync_capture --sim 2`` with a pose feed on a Unix datagram
    socket: 4 snapshots a stream under one index, ``poses.csv`` and
    ``wrench.csv`` with a row each, a pose row from the feed (as
    ``tests/test_native.py`` checks the JAX build)."""
    import socket
    import time

    out, sock_path = tmp_path / "cap", str(tmp_path / "pose.sock")
    proc = subprocess.Popen(
        [str(tloader.tool("tgs_sync_capture")), "--out", str(out), "--sim",
         "2", "--auto-capture", "4", "--rate-hz", "20", "--pose-socket",
         sock_path], stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    with socket.socket(socket.AF_UNIX, socket.SOCK_DGRAM) as s:
        for _ in range(40):
            if Path(sock_path).exists():
                break
            time.sleep(0.05)
        for i in range(10):
            try:
                s.sendto(f"pose ee 0.1 0.2 {i} 0 0 0 1".encode(), sock_path)
                s.sendto(b"wrench 1 2 3 0.1 0.2 0.3", sock_path)
            except OSError:
                pass
            time.sleep(0.05)
    _, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err.decode()[-300:]
    for cam in ("imgs_cam0", "imgs_cam1"):
        frames = sorted(p.name for p in (out / cam).iterdir())
        assert frames == [f"frame_{i:05d}.png" for i in range(4)]
        assert read_png(out / cam / frames[0]).shape == (48, 64, 3)
    poses = (out / "poses.csv").read_text().strip().splitlines()
    wrench = (out / "wrench.csv").read_text().strip().splitlines()
    assert len(poses) == len(wrench) == 5
    assert poses[0] == "index,frame,x,y,z,qx,qy,qz,qw,stamp"
    assert any(",ee," in row for row in poses[1:])


def test_sim_capture_through_sensor_loop_equals_jax(sensors, tmp_path):
    """A ``tgs_sync_capture --sim 1`` capture replayed through the port's
    ``SensorLoop`` and the JAX package's, the compact nets' parameters
    carried across: every frame, the same rect PNGs, depth PNGs within one
    level (uint8 truncation), force.csv within 1e-5."""
    js, ts = sensors
    cap = tmp_path / "cap"
    r = subprocess.run(
        [str(tloader.tool("tgs_sync_capture")), "--out", str(cap), "--sim",
         "1", "--auto-capture", "4", "--rate-hz", "20"],
        stdin=subprocess.DEVNULL, capture_output=True, timeout=60)
    assert r.returncode == 0, r.stderr[-300:]
    src = cap / "imgs_cam0"
    assert tsl.SensorLoop(sensor=ts, out_dir=tmp_path / "port",
                          rate_hz=1000.0).run(tsl.DirectorySource(src)) == 4
    assert jsl.SensorLoop(sensor=js, out_dir=tmp_path / "jax",
                          rate_hz=1000.0).run(jsl.DirectorySource(src)) == 4
    for sub, tol in (("rect", 0), ("depth", 1)):
        names = sorted(p.name for p in (tmp_path / "port" / sub).iterdir())
        assert names == [f"frame_{i:05d}.png" for i in range(4)]
        for name in names:
            out = read_png(tmp_path / "port" / sub / name).astype(int)
            ref = read_png(tmp_path / "jax" / sub / name).astype(int)
            assert out.shape == ref.shape
            assert np.abs(out - ref).max() <= tol
    rows = [np.array([[float(v) for v in row.split(",")] for row in
                      (tmp_path / d / "force.csv").read_text().splitlines()[1:]])
            for d in ("port", "jax")]
    np.testing.assert_allclose(rows[0], rows[1], atol=1e-5)


# -------------------------------------------------------------- build --

@pytest.mark.parametrize("name", SOURCES)
def test_sources_are_the_jax_packages(name):
    """Each C++ source and the Makefile is the JAX package's file; the one
    difference allowed is a citation of the upstream reference, which the
    port gives from that repository's root (``data_collection/...``)
    where the JAX file names the directory it was checked out in."""
    ours = (ROOT / "touchgs_torch" / "native" / name).read_bytes()
    theirs = (JAX_DIR / name).read_bytes()
    assert ours == re.sub(rb"/[\w/.-]*/(?=data_collection/)", b"", theirs)


def test_build_writes_nothing_under_the_jax_package():
    """The port's build writes only under ``touchgs_torch/native/build/``:
    every file that ``make -n -B`` would write there, and the JAX
    package's tree unchanged by a build of every target."""
    def snapshot():
        return {p: p.stat().st_mtime_ns for p in (ROOT / "touchgs_tpu").rglob(
            "*") if p.is_file() and "__pycache__" not in p.parts
            and not p.is_relative_to(JAX_DIR / "build")}

    dry = subprocess.run(["make", "-n", "-B", "-C", str(tloader.NATIVE_DIR),
                          "all"], capture_output=True, text=True, check=True)
    written = re.findall(r"(?:-o|mkdir -p) (\S+)", dry.stdout)
    assert len(written) == 7, dry.stdout
    for path in written:
        assert (tloader.NATIVE_DIR / path).resolve().is_relative_to(
            tloader.BUILD_DIR), path
    before = snapshot()
    tloader.build()
    assert snapshot() == before
    for name in ("libtouchgs_native.so",) + tloader.TOOLS:
        assert (tloader.BUILD_DIR / name).is_file()


def test_both_libraries_in_one_process(libs, tmp_path):
    """The port's and the JAX package's libraries are two libraries in this
    process (``ctypes.CDLL`` opens each path ``RTLD_LOCAL``, and the
    Makefile sets no soname): both paths are mapped, and each handle
    decodes a file by itself."""
    lib, jlib = libs
    maps = Path("/proc/self/maps").read_text()
    assert str(tloader.SO_PATH) in maps and str(jloader._SO_PATH) in maps
    assert lib._handle != jlib._handle
    p = _write(tmp_path, "rgb8", seed=6)
    outs = []
    for handle in (lib, jlib):
        buf = np.empty(37 * 53 * 3, np.float32)
        shape = (ctypes.c_int * 3)()
        n = handle.tgs_decode_png(str(p).encode(), _ptr(buf, ctypes.c_float),
                                  buf.size, shape)
        assert n == buf.size and tuple(shape) == (37, 53, 3)
        outs.append(buf)
    np.testing.assert_array_equal(outs[0], outs[1])


def test_concurrent_first_builds(tmp_path):
    """Four processes build a fresh copy of the sources at once through
    ``loader.build`` (its lock on ``build/.lock``), then load and decode:
    each succeeds and decodes the file as `decode_png_plain` does."""
    src = tmp_path / "native"
    src.mkdir()
    for name in SOURCES:
        (src / name).write_bytes((tloader.NATIVE_DIR / name).read_bytes())
    png = _write(tmp_path, "gray16", seed=7)
    code = (
        "import sys\nfrom pathlib import Path\n"
        "from touchgs_torch.native import loader\n"
        "loader.NATIVE_DIR = Path(sys.argv[1])\n"
        "loader.BUILD_DIR = loader.NATIVE_DIR / 'build'\n"
        "loader.SO_PATH = loader.BUILD_DIR / 'libtouchgs_native.so'\n"
        "assert loader.native_available(), loader._error\n"
        "print(float(loader.decode_png(sys.argv[2]).sum()))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(src), str(png)],
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    want = float(tloader.decode_png_plain(png).sum())
    assert [float(o) for o, _ in outs] == [want] * 4
    assert (src / "build" / "libtouchgs_native.so").is_file()


def test_missing_prerequisites_are_named(monkeypatch):
    """Without ``g++`` or ``make`` on the path, each is named (what the card
    test of the capture tool skips with)."""
    assert tloader.missing_prerequisites() == []
    monkeypatch.setattr(tloader.shutil, "which", lambda tool: None)
    assert tloader.missing_prerequisites() == ["g++", "make"]
    with pytest.raises(ValueError, match="unknown native tool"):
        tloader.tool("tgs_other")

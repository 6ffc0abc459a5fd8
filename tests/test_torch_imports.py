"""The port's import rule: no module of ``touchgs_torch/``, nor
``chip_smoke.py`` or ``bench_torch.py``, imports JAX, flax, optax, orbax or the JAX package, not
even lazily inside a function, and PIL only in ``data/png.py``'s lazy path for files
that are not plain PNGs.  Each file is parsed with ``ast``; only the tests
import both packages."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "touchgs_tpu")
FILES = sorted(ROOT.glob("touchgs_torch/**/*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "bench_torch.py"]


def _imports(tree: ast.AST):
    """(line, module) of every import statement in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(tree: ast.AST) -> list:
    return [(line, mod) for line, mod in _imports(tree)
            if mod.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = _forbidden(ast.parse(path.read_text(), filename=str(path)))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_rule_catches_every_form():
    src = ("import jax\nimport jaxlib.xla_client\n"
           "from touchgs_tpu.ops import tiles\n"
           "def f():\n    import jax.numpy as jnp\n"
           "import numpy\nfrom . import sibling\n")
    assert [m for _, m in _forbidden(ast.parse(src))] == [
        "jax", "jaxlib.xla_client", "touchgs_tpu.ops", "jax.numpy"]


def test_files_found():
    assert len(FILES) > 20
    assert ROOT / "touchgs_torch" / "ops" / "rasterize_tiled.py" in FILES
    assert ROOT / "touchgs_torch" / "train" / "graphs.py" in FILES


TOUCH_SLICE = ("touch/__init__.py", "touch/uncertainty.py", "touch/fusion.py",
               "touch/pointcloud.py", "touch/gpis.py", "touch/calibration.py",
               "tools/train_hard_scene.py", "tools/exp_gpis_precision.py")


def test_touch_slice_files_found():
    for rel in TOUCH_SLICE:
        assert ROOT / "touchgs_torch" / rel in FILES, rel


def test_touch_slice_imports_without_jax():
    """The touch modules and the hard-scene tool import in a process where
    ``jax``, ``jaxlib`` and ``touchgs_tpu`` cannot be imported at all (an
    entry of None in ``sys.modules`` makes the import raise, also for a
    module a site hook imported first)."""
    mods = ["touchgs_torch." + rel[:-3].replace("/", ".").replace(
        ".__init__", "") for rel in TOUCH_SLICE]
    code = (
        "import importlib, sys\n"
        f"for name in list(sys.modules) + list({FORBIDDEN!r}):\n"
        f"    if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "        sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


SCENE_CLI_SLICE = ("cli.py", "data/png.py", "data/depth_io.py",
                   "data/splits.py", "data/undistort.py", "data/scene.py",
                   "data/realsense.py", "data/ply.py", "models/pose_opt.py",
                   "train/checkpoint.py", "train/trainer.py",
                   "tools/write_scene.py")


def test_scene_cli_slice_files_found():
    for rel in SCENE_CLI_SLICE:
        assert ROOT / "touchgs_torch" / rel in FILES, rel


def test_pil_only_in_png_lazy_path():
    """PIL is imported nowhere but inside ``data/png.py::_pil_open``."""
    for path in FILES:
        tree = ast.parse(path.read_text(), filename=str(path))
        pil = [line for line, mod in _imports(tree)
               if mod.split(".")[0] == "PIL"]
        if path == ROOT / "touchgs_torch" / "data" / "png.py":
            fn = next(n for n in ast.walk(tree) if isinstance(
                n, ast.FunctionDef) and n.name == "_pil_open")
            assert pil and all(fn.lineno <= line <= fn.end_lineno
                               for line in pil), pil
        else:
            assert not pil, (path, pil)


def test_scene_cli_slice_imports_without_jax_or_pil():
    """The slice's modules import, and the CLI parses, in a process where
    ``jax``, ``orbax``, ``touchgs_tpu`` and ``PIL`` cannot be imported."""
    blocked = FORBIDDEN + ("PIL",)
    mods = ["touchgs_torch." + rel[:-3].replace("/", ".")
            for rel in SCENE_CLI_SLICE]
    code = (
        "import importlib, sys\n"
        f"for name in list(sys.modules) + list({blocked!r}):\n"
        f"    if name.split('.')[0] in {blocked!r}:\n"
        "        sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from touchgs_torch import cli\n"
        "try:\n"
        "    cli.main(['--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {blocked!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120, capture_output=True)


VISION_CAPTURE_SLICE = (
    "vision/__init__.py", "vision/dpt.py", "vision/zoedepth.py",
    "vision/depth_anything.py", "vision/monodepth.py", "utils/resize.py",
    "tools/random_checkpoint.py", "tools/profile_vision.py", "data/colmap.py",
    "data/capture_convert.py", "data/capture_tools.py", "data/rosbag.py",
    "data/pc_depth.py", "data/meshing.py")


def test_vision_capture_slice_files_found():
    for rel in VISION_CAPTURE_SLICE:
        assert ROOT / "touchgs_torch" / rel in FILES, rel


def test_vision_capture_slice_imports_without_jax_or_pil():
    """The monocular-depth nets and the capture modules import, and the
    CLI's ``pipeline`` parses, in a process where ``jax``, ``orbax``,
    ``touchgs_tpu``, ``transformers`` and ``PIL`` cannot be imported."""
    blocked = FORBIDDEN + ("PIL", "transformers")
    mods = ["touchgs_torch." + rel[:-3].replace("/", ".").replace(
        ".__init__", "") for rel in VISION_CAPTURE_SLICE]
    code = (
        "import importlib, sys\n"
        f"for name in list(sys.modules) + list({blocked!r}):\n"
        f"    if name.split('.')[0] in {blocked!r}:\n"
        "        sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from touchgs_torch import cli\n"
        "try:\n"
        "    cli.main(['pipeline', '--help'])\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {blocked!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120, capture_output=True)


SENSOR_NERF_SLICE = (
    "touch/losses.py", "touch/densetact_nets.py", "touch/swin_force.py",
    "touch/sensor_nets.py", "touch/sensor_train.py", "touch/sensor_loop.py",
    "models/nerf.py")


def test_sensor_nerf_slice_files_found():
    for rel in SENSOR_NERF_SLICE:
        assert ROOT / "touchgs_torch" / rel in FILES, rel


def test_sensor_nerf_slice_imports_without_jax_or_pil():
    """The sensor stack and the NeRF import, and a sensor loop runs on the
    CPU, in a process where ``jax``, ``flax``, ``optax``, ``orbax``,
    ``touchgs_tpu`` and ``PIL`` cannot be imported."""
    blocked = FORBIDDEN + ("PIL",)
    mods = ["touchgs_torch." + rel[:-3].replace("/", ".")
            for rel in SENSOR_NERF_SLICE]
    code = (
        "import importlib, sys\n"
        f"for name in list(sys.modules) + list({blocked!r}):\n"
        f"    if name.split('.')[0] in {blocked!r}:\n"
        "        sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from touchgs_torch.touch import sensor_loop as sl\n"
        "sensor = sl.DenseTactSensor(device='cpu')\n"
        "assert sl.SensorLoop(sensor, rate_hz=1e3).run(\n"
        "    sl.SyntheticSource(size=32, n_frames=1)) == 1\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {blocked!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120, capture_output=True)


VIEWER_PARALLEL_SLICE = (
    "viewer/__init__.py", "viewer/server.py", "parallel/__init__.py",
    "parallel/mesh.py", "parallel/distributed.py", "parallel/multiscene.py",
    "parallel/sharded.py", "tools/train_multiscene_demo.py",
    "tools/scaling_bench.py")


def test_viewer_parallel_slice_files_found():
    for rel in VIEWER_PARALLEL_SLICE:
        assert ROOT / "touchgs_torch" / rel in FILES, rel


def test_viewer_parallel_slice_imports_without_jax_or_pil():
    """The viewer, the parallel package and their tools import, and a
    viewer serves a frame of a CPU trainer, in a process where ``jax``,
    ``orbax``, ``touchgs_tpu`` and ``PIL`` cannot be imported."""
    blocked = FORBIDDEN + ("PIL",)
    mods = ["touchgs_torch." + rel[:-3].replace("/", ".").replace(
        ".__init__", "") for rel in VIEWER_PARALLEL_SLICE]
    code = (
        "import importlib, sys, urllib.request\n"
        f"for name in list(sys.modules) + list({blocked!r}):\n"
        f"    if name.split('.')[0] in {blocked!r}:\n"
        "        sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import numpy as np\n"
        "from touchgs_torch.data.png import decode_png\n"
        "from touchgs_torch.viewer import ViewerServer\n"
        "def fn(c2w, w, h):\n"
        "    z = np.zeros((h, w), np.float32)\n"
        "    return {'rgb': np.ones((h, w, 3), np.float32), 'depth': z,"
        " 'acc': z}\n"
        "with ViewerServer(render_fn=fn, port=0) as v:\n"
        "    png = urllib.request.urlopen(v.url + 'render?w=8&h=4',"
        " timeout=30).read()\n"
        "assert (decode_png(png).pixels == 255).all()\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {blocked!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120, capture_output=True)


NATIVE_SLICE = ("native/__init__.py", "native/loader.py", "native/arm.py")
SUBPACKAGES = ("data", "models", "ops", "train", "utils", "vision", "eval",
               "touch", "parallel", "viewer", "native")


def test_native_slice_files_found():
    for rel in NATIVE_SLICE:
        assert ROOT / "touchgs_torch" / rel in FILES, rel


def test_native_slice_imports_without_jax_or_pil(tmp_path):
    """The native layer and every subpackage's re-exports import, and a PNG
    decodes through ``native.decode_png``, in a process where ``jax``,
    ``touchgs_tpu`` and ``PIL`` cannot be imported; importing builds
    nothing."""
    blocked = FORBIDDEN + ("PIL",)
    mods = ["touchgs_torch." + rel[:-3].replace("/", ".").replace(
        ".__init__", "") for rel in NATIVE_SLICE]
    code = (
        "import importlib, sys\n"
        f"for name in list(sys.modules) + list({blocked!r}):\n"
        f"    if name.split('.')[0] in {blocked!r}:\n"
        "        sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"for pkg in {SUBPACKAGES!r}:\n"
        "    importlib.import_module('touchgs_torch.' + pkg)\n"
        "import numpy as np\n"
        "from touchgs_torch.native import loader, decode_png\n"
        "assert loader._lib is None and loader._error is None\n"
        "from touchgs_torch.data.png import write_png\n"
        f"p = {str(tmp_path / 'g.png')!r}\n"
        "write_png(p, np.full((3, 5), 51, np.uint8))\n"
        "out = decode_png(p)\n"
        "assert out.shape == (3, 5, 1) and (out == 51 / 255).all()\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {blocked!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120, capture_output=True)


def test_bench_files_found():
    assert ROOT / "bench_torch.py" in FILES
    assert ROOT / "touchgs_torch" / "tools" / "pair_stats.py" in FILES


def test_bench_imports_without_jax():
    """``bench_torch.py`` builds its state and takes a step, its census
    runs and ``pair_stats`` prints its statistics, on the CPU at a tiny
    size, in a process where ``jax``, ``touchgs_tpu`` and ``PIL`` cannot be
    imported (``bench_torch`` imports the package lazily, as ``bench.py``
    does)."""
    blocked = FORBIDDEN + ("PIL",)
    code = (
        "import sys\n"
        f"for name in list(sys.modules) + list({blocked!r}):\n"
        f"    if name.split('.')[0] in {blocked!r}:\n"
        "        sys.modules[name] = None\n"
        "import bench_torch as b\n"
        "from touchgs_torch.tools import pair_stats\n"
        "cfg, state, step, cam, *batch = b.build_state_and_step("
        "'cpu', 32, 32, 50, 128)\n"
        "state, m = step(state, cam, *batch, 3)\n"
        "assert float(m['loss']) > 0\n"
        "assert b.census(cfg, state, cam)['total'] > 0\n"
        "assert pair_stats.main(64, 'cpu', 32, 32, 50, 128)['total'] > 0\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {blocked!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120, capture_output=True)

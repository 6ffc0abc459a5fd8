"""PLY import/export — 3DGS splat checkpoints and generic point clouds
(port of ``touchgs_tpu/data/ply.py``).

Capability parity with the reference's export surface: nerfstudio's
``ns-export gaussian-splat`` writes the INRIA 3DGS ``.ply`` layout consumed by
every public splat viewer, and the reference's offline tooling reads/writes
point-cloud ``.ply`` via Open3D (``data_preprocessing/vision/point_cloud/
read_point_cloud.py:399-483``; ``.gitattributes:1`` tracks
``*.ply.vis``).  This module implements both in pure numpy (no Open3D dependency),
binary little-endian.

3DGS vertex layout (one float32 per property):
  x y z nx ny nz f_dc_{0..2} f_rest_{0..3(K-1)-1} opacity scale_{0..2}
  rot_{0..3}
with ``f_rest`` channel-major (all K-1 coefficients of channel 0, then 1,
then 2), ``opacity`` as the logit, ``scale`` as log-scale, and ``rot`` as an
unnormalized wxyz quaternion — byte-compatible with the INRIA reference
implementation and gsplat viewers.  The JAX package reads this module's
splat files and this module reads the JAX package's: they are how trained
Gaussians cross between the packages.
"""
from __future__ import annotations

import io
from pathlib import Path

import numpy as np
import torch


def _read_header(f) -> tuple[list[tuple[str, str]], int, bool]:
    """Parse a PLY header → (vertex properties, vertex count, is_binary_le)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    props: list[tuple[str, str]] = []
    count = 0
    binary_le = False
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == b"format":
            binary_le = tok[1] == b"binary_little_endian"
            if not binary_le and tok[1] != b"ascii":
                raise ValueError(f"unsupported PLY format {tok[1]!r}")
        elif tok[0] == b"element":
            in_vertex = tok[1] == b"vertex"
            if in_vertex:
                count = int(tok[2])
        elif tok[0] == b"property" and in_vertex:
            if tok[1] == b"list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tok[2].decode(), tok[1].decode()))
        elif tok[0] == b"end_header":
            return props, count, binary_le


_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


def read_ply(path: str | Path) -> dict[str, np.ndarray]:
    """Read a PLY vertex element into {property_name: (N,) array}."""
    with open(path, "rb") as f:
        props, count, binary_le = _read_header(f)
        names = [n for n, _ in props]
        dtype = np.dtype([(n, _DTYPES[t]) for n, t in props])
        if binary_le:
            data = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                 count=count)
        else:
            rows = np.loadtxt(io.BytesIO(f.read()), max_rows=count, ndmin=2)
            data = np.zeros(count, dtype=dtype)
            for i, n in enumerate(names):
                data[n] = rows[:, i]
    return {n: np.ascontiguousarray(data[n]) for n in names}


def write_ply(path: str | Path, fields: dict[str, np.ndarray],
              dtypes: dict[str, str] | None = None) -> None:
    """Write named per-vertex arrays as binary little-endian PLY."""
    names = list(fields)
    n = len(next(iter(fields.values())))
    type_of = {}
    for name in names:
        t = (dtypes or {}).get(name, "float")
        type_of[name] = t
    dtype = np.dtype([(name, _DTYPES[type_of[name]]) for name in names])
    rec = np.zeros(n, dtype=dtype)
    for name in names:
        col = np.asarray(fields[name])
        if len(col) != n:
            raise ValueError(f"field {name} length {len(col)} != {n}")
        rec[name] = col
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property {type_of[name]} {name}" for name in names]
    header += ["end_header", ""]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(header).encode())
        f.write(rec.tobytes())


def write_pointcloud_ply(path: str | Path, points: np.ndarray,
                         colors: np.ndarray | None = None) -> None:
    """Generic xyz[+rgb] point-cloud PLY (Open3D-compatible).

    ``colors`` in [0, 1] floats or uint8; stored as uchar like Open3D does.
    """
    points = np.asarray(points, np.float32)
    fields = {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2]}
    dtypes = {}
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
        for i, c in enumerate("red green blue".split()):
            fields[c] = colors[:, i]
            dtypes[c] = "uchar"
    write_ply(path, fields, dtypes)


def read_pointcloud_ply(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """→ (points (N,3) float32, colors (N,3) float32 in [0,1] or None)."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=-1).astype(np.float32)
    if "red" in v:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=-1)
        if cols.dtype == np.uint8:
            cols = cols.astype(np.float32) / 255.0
        return pts, cols.astype(np.float32)
    return pts, None


def save_gaussians_ply(path: str | Path, params) -> int:
    """Export alive Gaussians in the standard 3DGS splat PLY layout.

    Returns the number of splats written.  ``params`` is a
    ``models.gaussians.GaussianParams`` on any device (copied to the host
    here).
    """
    def host(t, dtype=np.float32):
        return t.detach().cpu().numpy().astype(dtype, copy=False)

    alive = params.alive.detach().cpu().numpy().astype(bool)
    means = host(params.means)[alive]
    quats = host(params.quats)[alive]
    log_scales = host(params.log_scales)[alive]
    logit_op = host(params.logit_opacities)[alive]
    sh_dc = host(params.sh_dc)[alive]
    sh_rest = host(params.sh_rest)[alive]  # (n, K-1, 3)
    n, km1 = sh_rest.shape[0], sh_rest.shape[1]

    fields: dict[str, np.ndarray] = {
        "x": means[:, 0], "y": means[:, 1], "z": means[:, 2],
        "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    for c in range(3):
        fields[f"f_dc_{c}"] = sh_dc[:, c]
    # channel-major: all K-1 coeffs of channel 0, then 1, then 2
    rest_cm = np.transpose(sh_rest, (0, 2, 1)).reshape(n, 3 * km1)
    for j in range(3 * km1):
        fields[f"f_rest_{j}"] = rest_cm[:, j]
    fields["opacity"] = logit_op
    for j in range(3):
        fields[f"scale_{j}"] = log_scales[:, j]
    for j in range(4):
        fields[f"rot_{j}"] = quats[:, j]
    write_ply(path, fields)
    return n


def load_gaussians_ply(path: str | Path, capacity: int | None = None,
                       device: torch.device | str = "cuda"):
    """Load a 3DGS splat PLY into a fixed-capacity ``GaussianParams`` on
    ``device``.

    ``capacity`` defaults to the next power of two ≥ the splat count (room
    for densification).  SH degree is inferred from the f_rest count.
    """
    from touchgs_torch.models.gaussians import params_from_numpy

    v = read_ply(path)
    n = len(v["x"])
    means = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    n_rest = len([k for k in v if k.startswith("f_rest_")])
    km1 = n_rest // 3
    sh_dc = np.stack([v[f"f_dc_{c}"] for c in range(3)], -1).astype(np.float32)
    if km1:
        rest_cm = np.stack([v[f"f_rest_{j}"] for j in range(3 * km1)], -1)
        sh_rest = np.transpose(
            rest_cm.reshape(n, 3, km1), (0, 2, 1)).astype(np.float32)
    else:
        sh_rest = np.zeros((n, 0, 3), np.float32)
    log_scales = np.stack([v[f"scale_{j}"] for j in range(3)], -1).astype(np.float32)
    quats = np.stack([v[f"rot_{j}"] for j in range(4)], -1).astype(np.float32)
    logit_op = v["opacity"].astype(np.float32)

    if capacity is None:
        capacity = max(1, 1 << (n - 1).bit_length())
    if capacity < n:
        raise ValueError(f"capacity {capacity} < splat count {n}")

    def pad(a, fill=0.0):
        width = [(0, capacity - n)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, width, constant_values=fill)

    return params_from_numpy(dict(
        means=pad(means), quats=pad(quats), log_scales=pad(log_scales),
        logit_opacities=pad(logit_op), sh_dc=pad(sh_dc),
        sh_rest=np.ascontiguousarray(pad(sh_rest)),
        alive=pad(np.ones(n, bool), fill=False),
    ), device)

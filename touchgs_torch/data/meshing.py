"""Point-cloud → surface → offscreen depth rendering (port of
``touchgs_tpu/data/meshing.py``).

Capability-parity rebuild of the reference's Open3D pipeline at
``data_preprocessing/vision/point_cloud/read_point_cloud.py:399-483``
(estimate normals → Poisson surface reconstruction → offscreen depth
render).  Torch ops on the points' (or the camera's) device, except the
marching tetrahedra, which are numpy on the host as in the JAX package:

- ``estimate_normals`` — k-NN PCA normals (chunked brute-force distances,
  the k+1 nearest by ``topk``, the smallest eigenvector of each
  neighbourhood, oriented toward a viewpoint).
- ``poisson_indicator`` — the FFT Poisson solve: the oriented normal field
  splatted trilinearly onto a regular grid (``index_add_``), ∇²χ − sχ = ∇·V
  solved with ``torch.fft.fftn``/``ifftn``, the iso level the mean χ at the
  samples.
- ``marching_tetrahedra`` — zero-isosurface triangulation (6 tets/cell).
- ``render_mesh_depth`` — z-buffer depth: a capped pixel footprint per
  face, the barycentric inside-test, a scatter-min (``scatter_reduce``
  "amin", deterministic) into a flat buffer with one spare slot.
"""
from __future__ import annotations

import numpy as np
import torch


# ------------------------------------------------------------ normals

def estimate_normals(points, k: int = 16, viewpoint=None,
                     chunk: int = 1024) -> torch.Tensor:
    """k-NN PCA normals, oriented toward ``viewpoint`` (default centroid+z);
    (P, 3) float32 on the points' device (numpy points: the CPU)."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    n = len(pts)
    k = min(k, n - 1)
    normals = torch.empty_like(pts)
    for s in range(0, n, chunk):
        blk = pts[s:s + chunk]
        d2 = ((blk[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        idx = torch.topk(d2, k + 1, dim=1, largest=False).indices
        nb = pts[idx]                                  # (b, k+1, 3)
        nb = nb - nb.mean(dim=1, keepdim=True)
        cov = torch.einsum("bki,bkj->bij", nb, nb) / (k + 1)
        normals[s:s + chunk] = torch.linalg.eigh(cov)[1][:, :, 0]
    if viewpoint is None:
        viewpoint = pts.mean(0) + torch.tensor([0, 0, 10.0],
                                               device=pts.device)
    viewpoint = torch.as_tensor(viewpoint, dtype=torch.float32,
                                device=pts.device)
    flip = torch.einsum("ni,ni->n", viewpoint[None] - pts, normals) < 0
    return torch.where(flip[:, None], -normals, normals)


# ------------------------------------------------------- poisson solve

def poisson_indicator(points, normals, grid_res: int = 96, pad: float = 0.15,
                      screen: float = 1e-2):
    """FFT Poisson reconstruction → (grid (R,R,R), origin (3,), spacing,
    level), tensors on the points' device.

    Solves (∇² − screen)χ = ∇·V for the indicator-like field χ, where V is
    the normal field splatted onto the grid; the surface is χ = level with
    ``level`` = mean χ at the sample points."""
    pts = torch.as_tensor(points, dtype=torch.float32)
    nrm = torch.as_tensor(normals, dtype=torch.float32, device=pts.device)
    lo = pts.min(0).values
    hi = pts.max(0).values
    span = torch.max(hi - lo)
    origin = lo - pad * span
    spacing = (span * (1 + 2 * pad)) / (grid_res - 1)

    # trilinear scatter of the normal field
    g = (pts - origin) / spacing
    g0 = torch.floor(g).to(torch.int64)
    f = g - g0
    R = grid_res
    V = torch.zeros((R * R * R, 3), dtype=torch.float32, device=pts.device)
    for corner in range(8):
        d = torch.tensor([(corner >> 2) & 1, (corner >> 1) & 1, corner & 1],
                         device=pts.device)
        wgt = torch.prod(torch.where(d.bool(), f, 1 - f), dim=1)
        idx = torch.clamp(g0 + d, 0, R - 1)
        flat = (idx[:, 0] * R + idx[:, 1]) * R + idx[:, 2]
        V.index_add_(0, flat, wgt[:, None] * nrm)
    V = V.reshape(R, R, R, 3)

    # divergence via central differences
    def ddx(a, axis):
        return (torch.roll(a, -1, axis) - torch.roll(a, 1, axis)) / (
            2 * spacing)

    div = ddx(V[..., 0], 0) + ddx(V[..., 1], 1) + ddx(V[..., 2], 2)

    # spectral solve: χ̂ = div̂ / (−k² − screen)
    kx = torch.fft.fftfreq(R, device=pts.device) * 2 * np.pi / spacing
    k2 = (kx[:, None, None] ** 2 + kx[None, :, None] ** 2
          + kx[None, None, :] ** 2)
    chi = torch.fft.ifftn(torch.fft.fftn(div) / -(k2 + screen)).real

    # iso level = mean χ at the samples (Kazhdan's convention)
    gi = torch.clamp(torch.round(g).to(torch.int64), 0, R - 1)
    level = chi[gi[:, 0], gi[:, 1], gi[:, 2]].mean()
    return chi, origin, spacing, level


# --------------------------------------------------- marching tetrahedra

# 6 tetrahedra per cube (corner indices into the 8 cube corners)
_TETS = np.array([[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
                  [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int32)
_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)
# per 4-bit sign case: up to 2 triangles, as edge pairs (i, j) of the tet
_TET_EDGES = {
    0b0001: [[(0, 1), (0, 2), (0, 3)]],
    0b0010: [[(1, 0), (1, 3), (1, 2)]],
    0b0100: [[(2, 0), (2, 1), (2, 3)]],
    0b1000: [[(3, 0), (3, 2), (3, 1)]],
    0b0011: [[(0, 2), (1, 3), (0, 3)], [(0, 2), (1, 2), (1, 3)]],
    0b0101: [[(0, 1), (2, 3), (0, 3)], [(0, 1), (1, 2), (2, 3)]],
    0b0110: [[(1, 0), (2, 3), (1, 3)], [(1, 0), (2, 0), (2, 3)]],
}


def marching_tetrahedra(grid, level: float, origin, spacing):
    """Zero-isosurface of ``grid - level`` → (verts (V,3), faces (F,3)),
    numpy on the host."""
    vol = np.asarray(_host(grid), np.float32) - float(level)
    origin = np.asarray(_host(origin))
    R = vol.shape[0]
    cells = R - 1
    # corner values per cell: (cells³, 8)
    base = np.stack(np.meshgrid(np.arange(cells), np.arange(cells),
                                np.arange(cells), indexing="ij"),
                    axis=-1).reshape(-1, 3)
    cvals = np.stack([vol[base[:, 0] + c[0], base[:, 1] + c[1],
                          base[:, 2] + c[2]] for c in _CORNERS], axis=1)
    triangles = []  # list of (n, 3 verts, 3 xyz) blocks
    for tet in _TETS:
        tv = cvals[:, tet]                              # (C, 4)
        case = ((tv < 0) << np.arange(4)).sum(axis=1)
        case = np.where(case > 0b0111, case ^ 0b1111, case)  # sign symmetry
        for c, tris in _TET_EDGES.items():
            sel = np.nonzero(case == c)[0]
            if len(sel) == 0:
                continue
            for tri in tris:
                block = np.empty((len(sel), 3, 3), np.float32)
                for vi_idx, (i, j) in enumerate(tri):
                    vi = tv[sel, i]
                    vj = tv[sel, j]
                    denom = vi - vj
                    t = vi / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
                    pi = (base[sel] + _CORNERS[tet[i]]).astype(np.float32)
                    pj = (base[sel] + _CORNERS[tet[j]]).astype(np.float32)
                    block[:, vi_idx] = pi + t[:, None] * (pj - pi)
                triangles.append(block)
    if not triangles:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32))
    verts = np.concatenate(triangles).reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)
    verts = origin[None] + verts * float(spacing)
    return verts, faces


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


# ----------------------------------------------------- offscreen render

def render_mesh_depth(verts, faces, camera,
                      max_pixels_per_face: int = 64) -> torch.Tensor:
    """Z-buffer triangle depth render → (H, W) float32 (0 = no hit) on the
    camera's device.

    Static-shape rasterization: each face enumerates up to
    ``max_pixels_per_face`` pixels of its screen bbox (row-major), does the
    barycentric inside-test, and scatter-mins interpolated depth."""
    W, H = camera.width, camera.height
    dev = camera.c2w.device
    v = torch.as_tensor(verts, dtype=torch.float32, device=dev)
    f = torch.as_tensor(faces, dtype=torch.int64, device=dev)
    ones = torch.ones((v.shape[0], 1), dtype=v.dtype, device=dev)
    vc = (torch.cat([v, ones], dim=1) @ camera.w2c.to(v).T)[:, :3]
    z = vc[:, 2]
    x = vc[:, 0] / torch.clamp(z, min=1e-9) * camera.fx + camera.cx
    y = vc[:, 1] / torch.clamp(z, min=1e-9) * camera.fy + camera.cy
    tri_x, tri_y, tri_z = x[f], y[f], z[f]              # (F, 3)
    valid = torch.all(tri_z > 1e-6, dim=1)

    x0 = torch.clamp(torch.floor(tri_x.min(1).values), 0, W - 1).long()
    x1 = torch.clamp(torch.ceil(tri_x.max(1).values), 0, W - 1).long()
    y0 = torch.clamp(torch.floor(tri_y.min(1).values), 0, H - 1).long()
    y1 = torch.clamp(torch.ceil(tri_y.max(1).values), 0, H - 1).long()
    bw = x1 - x0 + 1
    k = torch.arange(max_pixels_per_face, device=dev)[None, :]
    px = x0[:, None] + k % bw[:, None]
    py = y0[:, None] + torch.div(k, bw[:, None], rounding_mode="floor")
    in_bbox = (px <= x1[:, None]) & (py <= y1[:, None]) & valid[:, None]

    cx = px.to(torch.float32) + 0.5
    cy = py.to(torch.float32) + 0.5
    ax, ay = tri_x[:, 0:1], tri_y[:, 0:1]
    bx, by = tri_x[:, 1:2], tri_y[:, 1:2]
    gx, gy = tri_x[:, 2:3], tri_y[:, 2:3]
    den = (by - gy) * (ax - gx) + (gx - bx) * (ay - gy)
    den = torch.where(den.abs() < 1e-12, torch.full_like(den, 1e-12), den)
    w0 = ((by - gy) * (cx - gx) + (gx - bx) * (cy - gy)) / den
    w1 = ((gy - ay) * (cx - gx) + (ax - gx) * (cy - gy)) / den
    w2 = 1.0 - w0 - w1
    inside = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6) & in_bbox
    pz = w0 * tri_z[:, 0:1] + w1 * tri_z[:, 1:2] + w2 * tri_z[:, 2:3]

    flat = torch.where(inside, py * W + px, torch.full_like(px, H * W))
    zbuf = torch.full((H * W + 1,), float("inf"), device=dev)
    zbuf.scatter_reduce_(0, flat.reshape(-1), torch.where(
        inside, pz, torch.full_like(pz, float("inf"))).reshape(-1), "amin")
    depth = zbuf[: H * W].reshape(H, W)
    return torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))


def point_cloud_to_depth_via_mesh(points, camera, normals=None,
                                  grid_res: int = 96,
                                  max_pixels_per_face: int = 64
                                  ) -> torch.Tensor:
    """The full read_point_cloud.py:399-483 pipeline in one call, on the
    camera's device."""
    dev = camera.c2w.device
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    if normals is None:
        normals = estimate_normals(pts, viewpoint=camera.c2w[:3, 3])
    chi, origin, spacing, level = poisson_indicator(pts, normals, grid_res)
    verts, faces = marching_tetrahedra(chi, float(level), origin,
                                       float(spacing))
    if len(faces) == 0:
        return torch.zeros((camera.height, camera.width), device=dev)
    return render_mesh_depth(verts, faces, camera,
                             max_pixels_per_face=max_pixels_per_face)

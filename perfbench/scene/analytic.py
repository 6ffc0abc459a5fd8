"""The benchmark's scene, made from ``--seed`` on the device: a textured
sphere (radius 0.5 at the origin) resting on a checkered ground plane
(z = −0.5, |x|, |y| ≤ 1.6), the geometry and texture of the port's scale
demo, ray-cast to RGB and camera-space depth at the configuration's size
and cameras.  Nothing is rendered by the program under test and nothing is
read from disk.

A configuration's ``scene`` section names the cameras (``ring``: a
hemisphere ring around the object; ``arc``: a hand-held arc in front of
it) and the depth the trainer is given (``true``: the ray-cast depth, as a
synthetic Blender scene has it; ``fused``: a touch/vision fusion, the
ray-cast depth with noise of a per-pixel σ that is small on touched
patches and grows with distance elsewhere, and σ as the uncertainty map).
The seed moves the cameras, the noise and the patches, not the sizes: every
seed renders the same number of views at the same resolution.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

SPHERE_R = 0.5
PLANE_Z = -0.5
PLANE_HALF = 1.6
LOOK_AT = (0.0, 0.0, -0.1)


def sphere_color(p: torch.Tensor) -> torch.Tensor:
    """Bands and dots on the sphere, (N, 3) for surface points (N, 3)."""
    u = torch.atan2(p[:, 1], p[:, 0])
    lat = torch.asin(torch.clamp(p[:, 2] / SPHERE_R, -1.0, 1.0))
    return torch.stack([0.5 + 0.45 * torch.sin(6 * u),
                        0.5 + 0.45 * torch.sin(8 * lat + 1.3),
                        0.5 + 0.45 * torch.sin(4 * u + 3 * lat)], dim=-1)


def plane_color(p: torch.Tensor) -> torch.Tensor:
    """A checkerboard of 0.4-unit squares, (N, 3) for plane points."""
    c = torch.remainder(torch.floor(p[:, 0] * 2.5)
                        + torch.floor(p[:, 1] * 2.5), 2.0)
    return torch.stack([0.2 + 0.6 * c, 0.25 + 0.5 * c, 0.3 + 0.4 * (1 - c)],
                       dim=-1)


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """(4, 4) OpenGL camera-to-world of a camera at ``eye`` looking at
    ``target`` with +Z up."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 0.0, 1.0]))
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def camera_poses(cam: dict, n: int, u: np.ndarray) -> np.ndarray:
    """(n, 4, 4) camera-to-world matrices of the configuration's path;
    ``u`` (n + 1, 4) uniform draws in [0, 1) place them."""
    target = np.array(LOOK_AT)
    poses = []
    if cam["path"] == "ring":
        phase = 2 * math.pi * u[n, 0] / n
        for i in range(n):
            az = 2 * math.pi * i / n + phase
            el = math.radians(cam["elevation_deg"][0] + (
                cam["elevation_deg"][1] - cam["elevation_deg"][0])
                * (0.5 + 0.5 * math.sin(2 * math.pi * 5 * i / n)))
            r = cam["radius"]
            eye = np.array([r * math.cos(el) * math.cos(az),
                            r * math.cos(el) * math.sin(az),
                            r * math.sin(el)])
            poses.append(look_at(eye, target))
    elif cam["path"] == "arc":
        base = 2 * math.pi * u[n, 0]
        lo, hi = (math.radians(a) for a in cam["azimuth_deg"])
        j = cam["jitter"]
        for i in range(n):
            az = base + lo + (hi - lo) * i / max(n - 1, 1)
            r = cam["radius"] + j * (2 * u[i, 0] - 1)
            eye = np.array([r * math.cos(az), r * math.sin(az),
                            cam["height"] + j * (2 * u[i, 1] - 1)])
            tgt = target + j * np.array([2 * u[i, 2] - 1, 2 * u[i, 3] - 1,
                                         0.0])
            poses.append(look_at(eye, tgt))
    else:
        raise ValueError(f"unknown camera path {cam['path']!r}")
    return np.stack(poses)


def intrinsics(cfg: dict) -> tuple:
    """(fx, fy, cx, cy) as float32 values of a configuration's scene."""
    s = cfg["scene"]
    cam = s["camera"]
    if "focal_frac" in cam:
        f = cam["focal_frac"] * s["width"]
        vals = (f, f, s["width"] / 2, s["height"] / 2)
    else:
        vals = (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    return tuple(float(np.float32(v)) for v in vals)


def ray_cast(c2w: torch.Tensor, fxy: tuple, width: int, height: int
             ) -> tuple:
    """(rgb (H, W, 3), depth (H, W), hit (H, W) bool) of one view: the
    nearest hit of each pixel-centre ray; depth is camera-space z (OpenCV
    +Z forward), 0 and black where the ray misses."""
    fx, fy, cx, cy = fxy
    dev = c2w.device
    v, u = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                          torch.arange(width, device=dev, dtype=torch.float32),
                          indexing="ij")
    d_cam = torch.stack([(u + 0.5 - cx) / fx, -(v + 0.5 - cy) / fy,
                         -torch.ones_like(u)], dim=-1)
    d = d_cam.reshape(-1, 3) @ c2w[:3, :3].T        # z_opencv = t
    o = c2w[:3, 3]
    inf = torch.full_like(d[:, 0], float("inf"))
    # sphere |o + t d|² = r²
    a = (d * d).sum(-1)
    b = 2 * (d @ o)
    c = float((o * o).sum()) - SPHERE_R ** 2
    disc = b * b - 4 * a * c
    t_s = (-b - torch.sqrt(torch.clamp(disc, min=0))) / (2 * a)
    t_s = torch.where((disc > 0) & (t_s > 0), t_s, inf)
    # plane z = PLANE_Z inside its square
    t_p = (PLANE_Z - o[2]) / d[:, 2]
    hit_p = o[:2] + t_p[:, None] * d[:, :2]
    in_p = (t_p > 0) & (hit_p.abs() <= PLANE_HALF).all(-1)
    t_p = torch.where(in_p, t_p, inf)
    t = torch.minimum(t_s, t_p)
    hit = torch.isfinite(t)
    p = o + torch.where(hit, t, torch.zeros_like(t))[:, None] * d
    rgb = torch.where((t_s <= t_p)[:, None], sphere_color(p), plane_color(p))
    rgb = torch.where(hit[:, None], rgb, torch.zeros_like(rgb))
    depth = torch.where(hit, t, torch.zeros_like(t))
    return (rgb.reshape(height, width, 3), depth.reshape(height, width),
            hit.reshape(height, width))


def fused_depth(depth, hit, g: torch.Generator, dcfg: dict) -> tuple:
    """(depth, σ): the ray-cast depth with Gaussian noise of σ, where σ is
    ``touch_sigma`` on ``touch_patches`` discs of ``touch_radius_px`` pixels
    centred on hit pixels and ``vision_sigma0 + vision_sigma2·z²``
    elsewhere.  Both 0 where the ray missed."""
    H, W = depth.shape
    dev = depth.device
    sigma = dcfg["vision_sigma0"] + dcfg["vision_sigma2"] * depth * depth
    n = dcfg["touch_patches"]
    flat_hit = hit.reshape(-1).float()
    centres = torch.multinomial(flat_hit + 1e-12, n, replacement=True,
                                generator=g)
    cy, cx = centres // W, centres % W
    yy = torch.arange(H, device=dev)[:, None, None]
    xx = torch.arange(W, device=dev)[None, :, None]
    r2 = dcfg["touch_radius_px"] ** 2
    touched = (((yy - cy) ** 2 + (xx - cx) ** 2) <= r2).any(-1)
    sigma = torch.where(touched, torch.full_like(sigma, dcfg["touch_sigma"]),
                        sigma)
    noise = torch.randn(depth.shape, generator=g, device=dev)
    d = torch.where(hit, torch.clamp(depth + sigma * noise, min=1e-3),
                    torch.zeros_like(depth))
    return d, torch.where(hit, sigma, torch.zeros_like(sigma))


@dataclasses.dataclass
class AnalyticScene:
    """The views on the host (numpy, as the program's ``Scene`` holds
    them) and the cameras; ``view`` puts one on a device for the
    reference."""

    width: int
    height: int
    fxy: tuple
    c2w: np.ndarray               # (N, 4, 4) float32, OpenGL
    images: np.ndarray            # (N, H, W, 3) float32
    depths: np.ndarray            # (N, H, W) float32, 0 = no target
    uncertainties: "np.ndarray | None"
    seed_points: np.ndarray       # (P, 3) float32
    seed_colors: np.ndarray       # (P, 3) float32 in [0, 1]

    def view(self, i: int, device) -> tuple:
        fx, fy, cx, cy = self.fxy
        cam = dict(fx=fx, fy=fy, cx=cx, cy=cy, width=self.width,
                   height=self.height,
                   c2w=torch.as_tensor(self.c2w[i], device=device))

        def up(a):
            return None if a is None else torch.as_tensor(a[i], device=device)

        return cam, dict(image=up(self.images), depth=up(self.depths),
                         unc=up(self.uncertainties))


def surface_points(n: int, g: torch.Generator, device,
                   sphere_fraction: float = 0.6) -> tuple:
    """(n, 3) points on the sphere (the first ``sphere_fraction``) and the
    plane (the rest), uniform on each, their texture colours, and how many
    lie on the sphere."""
    n_s = int(round(sphere_fraction * n))
    v = torch.randn((n_s, 3), generator=g, device=device)
    sph = SPHERE_R * v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    xy = (torch.rand((n - n_s, 2), generator=g, device=device) * 2 - 1) \
        * PLANE_HALF
    pl = torch.cat([xy, torch.full_like(xy[:, :1], PLANE_Z)], dim=-1)
    return (torch.cat([sph, pl]),
            torch.cat([sphere_color(sph), plane_color(pl)]), n_s)


def make_scene(cfg: dict, seed: int, device) -> AnalyticScene:
    """The configuration's views and touch seed points from ``seed``."""
    s = cfg["scene"]
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    n, W, H = s["views"], s["width"], s["height"]
    u = torch.rand((n + 1, 4), generator=g, device=device,
                   dtype=torch.float64).cpu().numpy()
    c2w = camera_poses(s["camera"], n, u).astype(np.float32)
    fxy = intrinsics(cfg)
    images = np.empty((n, H, W, 3), np.float32)
    depths = np.empty((n, H, W), np.float32)
    fused = s["depth"]["kind"] == "fused"
    uncs = np.empty((n, H, W), np.float32) if fused else None
    for i in range(n):
        rgb, depth, hit = ray_cast(torch.as_tensor(c2w[i], device=device),
                                   fxy, W, H)
        if fused:
            depth, sigma = fused_depth(depth, hit, g, s["depth"])
            uncs[i] = sigma.cpu().numpy()
        images[i] = rgb.cpu().numpy()
        depths[i] = depth.cpu().numpy()
    pts, cols, _ = surface_points(s["seed_points"], g, device)
    pts = pts + s["seed_noise"] * torch.randn(pts.shape, generator=g,
                                              device=device)
    cols = torch.clamp(cols + 0.05 * torch.randn(cols.shape, generator=g,
                                                 device=device), 0, 1)
    return AnalyticScene(W, H, fxy, c2w, images, depths, uncs,
                         pts.cpu().numpy().astype(np.float32),
                         cols.cpu().numpy().astype(np.float32))

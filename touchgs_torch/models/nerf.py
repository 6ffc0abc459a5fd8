"""Depth-supervised NeRF, the legacy ``tactile-nerf`` model family (port of
``touchgs_tpu/models/nerf.py``).

A nerfacto-class model after ``legacy/model_tactile.py`` and
``legacy/config_tactile.py``: a multiresolution hash-grid encoding, MLP
heads for density and colour, stratified + importance sampling, volume
rendering, and the tactile config's depth losses:

- ``DS_NERF``: the negative log-likelihood that ray termination lands
  within σ of the sensor depth (σ decays exponentially to a floor,
  ``legacy/model_tactile.py:249-256``);
- ``URF``: expected-depth L2 plus the line-of-sight terms;
- the Mip-NeRF 360 distortion regularizer.

Kept as the JAX package has them, and what differs by design:

- The hash is uint32 arithmetic that wraps: each ``cell · prime`` wraps mod
  2^32, their sum (not XOR) wraps, then ``% hash_size``.  2654435761 does
  not fit in int32, so the port computes in int64 with ``& 0xFFFFFFFF``
  after each product and after the sum; a negative cell (samples reach
  ``far`` = 6, outside the [−1, 1] box) wraps to 2^32 + v as JAX's
  ``astype(uint32)`` wraps it (ROADMAP.md C31).
- The levels' tables are one (levels, hash_size, features) parameter, and
  one gather reads every level's eight corners; the corners are summed in
  JAX's order.
- The stratified and importance uniforms come from a ``torch.Generator``,
  not ``jax.random`` (C30): `render_rays` and `NerfTrainer` take a
  generator, or the uniforms themselves (``uniforms=``,
  `NerfTrainer.draw_uniforms`), which is how the tests feed JAX's.
  The pixel draws stay ``np.random.default_rng(seed)``, as JAX's.
- The random init is flax's initializers drawn from the generator (C30);
  `load_flax_params` carries a flax ``HashGridMLP`` tree across.
- The coarse pass runs without autograd: its output reaches the loss only
  through the importance samples' integer indices, so no gradient flows
  through it in either package.

`NerfTrainer` runs on the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import enum
import re
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from touchgs_torch.data.cameras import Camera
from touchgs_torch.eval.lpips_vgg import fp32
from touchgs_torch.touch.sensor_nets import flax_init_, resolve_device

PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


class NerfDepthLossType(enum.Enum):
    DS_NERF = "DS_NERF"
    URF = "URF"


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    """Mirrors TactileNerfConfig (legacy/model_tactile.py:38-56) + trainer
    budget (legacy/config_tactile.py:26-35: 30k iters, 4096 rays/batch)."""

    num_levels: int = 8
    hash_size: int = 2**15
    features_per_level: int = 2
    base_res: int = 16
    max_res: int = 512
    mlp_width: int = 64
    num_coarse: int = 48
    num_fine: int = 48
    near: float = 0.05
    far: float = 6.0
    rays_per_batch: int = 4096
    depth_loss_mult: float = 1e-3
    depth_sigma: float = 0.01
    should_decay_sigma: bool = False
    starting_depth_sigma: float = 0.2
    sigma_decay_rate: float = 0.99985
    depth_loss_type: NerfDepthLossType = NerfDepthLossType.DS_NERF
    is_euclidean_depth: bool = False
    distortion_loss_mult: float = 0.002
    lr: float = 1e-2


def level_resolutions(cfg: NerfConfig) -> list:
    """Each level's grid resolution, ``int(base · growth^level)``."""
    growth = (cfg.max_res / cfg.base_res) ** (1 / max(cfg.num_levels - 1, 1))
    return [int(cfg.base_res * growth ** lvl) for lvl in range(cfg.num_levels)]


# the eight corners of a cell: bit k of the corner's number is its offset
# along axis k
CORNERS = np.array([[(c >> k) & 1 for k in range(3)] for c in range(8)],
                   np.int64)


def hash_index(cells: torch.Tensor, hash_size: int) -> torch.Tensor:
    """(..., 3) int64 cells → (...) table rows: the uint32 hash
    ``(Σ_k (cell_k · prime_k mod 2^32)) mod 2^32 mod hash_size``."""
    h = torch.zeros(cells.shape[:-1], dtype=torch.int64, device=cells.device)
    for k, prime in enumerate(PRIMES):
        h = h + ((cells[..., k] * prime) & _U32)
    return (h & _U32) % hash_size


def cell_corners(pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 3) grid positions → the (..., 8, 3) int64 corner cells and the
    (..., 8) trilinear weights, as the JAX package forms them."""
    p0 = torch.floor(pos)
    frac = pos - p0
    off = torch.as_tensor(CORNERS, device=pos.device)
    cells = p0.to(torch.int64)[..., None, :] + off
    f = frac[..., None, :]
    a = torch.where(off == 1, f, 1.0 - f)
    return cells, a[..., 0] * a[..., 1] * a[..., 2]


class HashGridMLP(nn.Module):
    """Hash-grid encoding + density/colour MLPs (instant-ngp style).
    ``dense[i]`` is flax's ``Dense_i``: 0-1 the trunk, 2 the density, 3 the
    geometry feature, 4-5 the colour head."""

    def __init__(self, cfg: NerfConfig):
        super().__init__()
        self.cfg = cfg
        self.resolutions = level_resolutions(cfg)
        L, T, Fl, W = (cfg.num_levels, cfg.hash_size, cfg.features_per_level,
                       cfg.mlp_width)
        self.tables = nn.Parameter(torch.zeros(L, T, Fl))
        self.dense = nn.ModuleList([
            nn.Linear(L * Fl, W), nn.Linear(W, W), nn.Linear(W, 1),
            nn.Linear(W, 15), nn.Linear(15 + 9, W), nn.Linear(W, 3)])

    def init_random(self, generator: torch.Generator) -> "HashGridMLP":
        """flax's initializers from ``generator``: the tables uniform on
        [0, 1e-4), kernels lecun-normal (truncated at 2σ), biases 0."""
        with torch.no_grad():
            self.tables.uniform_(0.0, 1e-4, generator=generator)
        flax_init_(self.dense, generator)
        return self

    def encode(self, xs: torch.Tensor) -> torch.Tensor:
        """(N, 3) positions in [0, 1] → (N, levels · features)."""
        c = self.cfg
        res = torch.tensor(self.resolutions, dtype=torch.float32,
                           device=xs.device)
        cells, w = cell_corners(xs[:, None, :] * res[:, None])  # (N, L, 8)
        level = torch.arange(c.num_levels, device=xs.device)[:, None]
        rows = hash_index(cells, c.hash_size) + level * c.hash_size
        feats = self.tables.reshape(-1, c.features_per_level)[rows]
        acc = w[..., 0, None] * feats[..., 0, :]
        for corner in range(1, 8):
            acc = acc + w[..., corner, None] * feats[..., corner, :]
        return acc.reshape(xs.shape[0], -1)

    def forward(self, x: torch.Tensor, d: torch.Tensor):
        """x: (R, S, 3) positions in [-1, 1]; d: (R, 3) unit view dirs →
        (density (R, S), rgb (R, S, 3))."""
        R, S, _ = x.shape
        h = self.encode((x.reshape(-1, 3) + 1.0) * 0.5)
        h = torch.relu(self.dense[1](torch.relu(self.dense[0](h))))
        density = F.softplus(self.dense[2](h)[..., 0] - 1.0)
        geo_feat = self.dense[3](h)
        dirs = d[:, None, :].expand(R, S, 3).reshape(-1, 3)
        denc = torch.cat([dirs, dirs ** 2, dirs[:, :1] * dirs[:, 1:2],
                          dirs[:, 1:2] * dirs[:, 2:3],
                          dirs[:, :1] * dirs[:, 2:3]], dim=-1)
        hc = torch.relu(self.dense[4](torch.cat([geo_feat, denc], dim=-1)))
        rgb = torch.sigmoid(self.dense[5](hc))
        return density.reshape(R, S), rgb.reshape(R, S, 3)


def load_flax_params(model: HashGridMLP, tree: Mapping) -> HashGridMLP:
    """Copy a flax ``HashGridMLP`` parameter tree (numpy leaves under
    ``params``) into ``model``: ``hash_l`` → ``tables[l]``, ``Dense_i`` →
    ``dense[i]`` (kernels transposed)."""
    params = tree["params"]
    with torch.no_grad():
        for key, leaf in params.items():
            m = re.fullmatch(r"hash_(\d+)", key)
            if m:
                model.tables[int(m.group(1))].copy_(
                    torch.from_numpy(np.array(leaf, np.float32)))
                continue
            lin = model.dense[int(re.fullmatch(r"Dense_(\d+)", key).group(1))]
            lin.weight.copy_(torch.from_numpy(np.array(leaf["kernel"],
                                                       np.float32).T))
            lin.bias.copy_(torch.from_numpy(np.array(leaf["bias"],
                                                     np.float32)))
    return model


class NerfRender(NamedTuple):
    rgb: torch.Tensor      # (R, 3)
    depth: torch.Tensor    # (R,)
    acc: torch.Tensor      # (R,)
    weights: torch.Tensor  # (R, S)
    ts: torch.Tensor       # (R, S) sample midpoints


def volume_render(density, rgb, ts, dirs_norm) -> NerfRender:
    """Quadrature volume rendering (R, S) → NerfRender."""
    deltas = torch.diff(ts, dim=-1)
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-density * deltas * dirs_norm[:, None])
    log1m = torch.log1p(-torch.clamp(alpha, 0.0, 0.999999))
    T = torch.exp(torch.cumsum(log1m, dim=-1) - log1m)
    w = T * alpha
    out_rgb = torch.sum(w[..., None] * rgb, dim=1)
    acc = torch.sum(w, dim=1)
    depth = torch.sum(w * ts, dim=1) / torch.clamp(acc, min=1e-10)
    return NerfRender(rgb=out_rgb, depth=depth, acc=acc, weights=w, ts=ts)


def sample_rays(camera: Camera, pixels: torch.Tensor):
    """(R, 2) pixel coords → (origins, unit dirs, dirs_norm); dirs_norm
    turns z-depth into euclidean distance (legacy/model_tactile.py:79-80)."""
    u = pixels[:, 0] + 0.5
    v = pixels[:, 1] + 0.5
    dir_cam = torch.stack([(u - camera.cx) / camera.fx,
                           (v - camera.cy) / camera.fy,
                           torch.ones_like(u)], dim=-1)
    flip = torch.tensor([1.0, -1.0, -1.0], device=camera.c2w.device)
    R_cv = camera.c2w[:3, :3] * flip
    dirs = dir_cam @ R_cv.T
    norm = torch.linalg.vector_norm(dirs, dim=-1)
    origins = camera.c2w[:3, 3].expand(dirs.shape)
    return origins, dirs / norm[:, None], norm


def linspace(start: float, stop: float, num: int, device=None):
    """``jnp.linspace`` in float32: ``start·(1 − s) + stop·s`` with
    ``s = i / (num − 1)``, the last point ``stop``."""
    s = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    start32 = torch.tensor(start, dtype=torch.float32, device=device)
    stop32 = torch.tensor(stop, dtype=torch.float32, device=device)
    return torch.cat([start32 * (1 - s) + stop32 * s, stop32[None]])


def draw_uniforms(cfg: NerfConfig, n_rays: int, generator: torch.Generator,
                  device=None, stratified: bool = True):
    """The stratified (R, num_coarse) uniforms of one `render_rays` call
    (None without stratification), then its importance (R, num_fine)
    ones."""
    def draw(n):
        return torch.rand((n_rays, n), generator=generator, device=device)

    return (draw(cfg.num_coarse) if stratified else None), draw(cfg.num_fine)


def render_rays(model: HashGridMLP, origins, dirs, cfg: NerfConfig,
                generator: Optional[torch.Generator] = None,
                stratified: bool = True, uniforms=None) -> NerfRender:
    """Coarse stratified + fine importance sampling through one field.
    ``uniforms`` (u (R, num_coarse), u2 (R, num_fine)) replace the
    generator's draws; without stratification the coarse samples sit at
    the bins' centres and u is not used."""
    R = origins.shape[0]
    if uniforms is None:
        uniforms = draw_uniforms(cfg, R, generator, origins.device,
                                 stratified)
    u, u2 = uniforms
    tbins = linspace(cfg.near, cfg.far, cfg.num_coarse + 1, origins.device)
    lo = tbins[:-1].expand(R, cfg.num_coarse)
    hi = tbins[1:].expand(R, cfg.num_coarse)
    ts = lo + (hi - lo) * (u if stratified else 0.5)
    ones = torch.ones((R,), device=origins.device)
    with torch.no_grad():
        pts = origins[:, None, :] + ts[..., None] * dirs[:, None, :]
        density, rgb = model(pts, dirs)
        coarse = volume_render(density, rgb, ts, ones)
        # importance-resample around the mass
        w = coarse.weights + 1e-5
        cdf = torch.cumsum(w, dim=-1)
        cdf = cdf / cdf[:, -1:]
        idx = torch.clamp(torch.searchsorted(cdf, u2.contiguous()), 0,
                          cfg.num_coarse - 1)
        t_fine = torch.gather(ts, -1, idx)
        all_ts = torch.sort(torch.cat([ts, t_fine], dim=-1), dim=-1).values
    pts = origins[:, None, :] + all_ts[..., None] * dirs[:, None, :]
    density, rgb = model(pts, dirs)
    return volume_render(density, rgb, all_ts, ones)


# --- depth losses (nerfstudio model_components.losses contracts) ------------

def _valid_mean(per_ray, valid):
    per_ray = torch.where(valid, per_ray, torch.zeros_like(per_ray))
    return per_ray.sum() / torch.clamp(valid.sum(), min=1)


def ds_nerf_depth_loss(weights, ts, termination_depth, sigma):
    """Depth-supervised NeRF: −log of a gaussian ray-termination likelihood,
    over the rays with a depth."""
    td = termination_depth[:, None]
    loss = (-torch.log(sigma * np.sqrt(2 * np.pi).astype(np.float32) + 1e-12)
            - 0.5 * ((ts - td) / sigma) ** 2)
    return _valid_mean(-torch.sum(weights * loss, dim=-1),
                       termination_depth > 0)


def urf_depth_loss(render: NerfRender, termination_depth, sigma):
    """Urban Radiance Fields: expected-depth L2 + line-of-sight terms."""
    expected = (render.depth - termination_depth) ** 2
    td = termination_depth[:, None]
    empty = (render.ts < td - sigma).to(torch.float32)
    near = torch.exp(-0.5 * ((render.ts - td) / sigma) ** 2)
    near = near / torch.clamp(near.sum(dim=-1, keepdim=True), min=1e-6)
    sight = (torch.sum(empty * render.weights ** 2, dim=-1)
             + torch.sum((render.weights - near) ** 2 * (1 - empty), dim=-1))
    return _valid_mean(expected + 0.1 * sight, termination_depth > 0)


def distortion_loss(weights, ts):
    """Mip-NeRF 360 distortion regularizer (the O(S) form)."""
    wm = weights * ts
    loss_bi = 2 * (wm * torch.cumsum(weights, dim=-1)
                   - weights * torch.cumsum(wm, dim=-1))
    deltas = torch.diff(ts, dim=-1, append=ts[:, -1:] + 1e-3)
    loss_uni = weights ** 2 * deltas / 3.0
    return torch.mean(torch.sum(loss_bi + loss_uni, dim=-1))


class NerfTrainer:
    """Ray-batch trainer for the tactile NeRF (legacy config budget).
    ``device=None`` means ``cuda``."""

    def __init__(self, scene, cfg: NerfConfig, seed: int = 0,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.scene = scene
        self.cfg = cfg
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        init = torch.Generator().manual_seed(seed)
        self.model = HashGridMLP(cfg).init_random(init).to(self.device)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=cfg.lr,
                                    eps=1e-8)
        self.sigma = torch.tensor(
            cfg.starting_depth_sigma if cfg.should_decay_sigma
            else cfg.depth_sigma, dtype=torch.float32, device=self.device)
        self.rng = np.random.default_rng(seed)
        self._cameras = {}

    def draw_uniforms(self):
        """This step's (u, u2), from the trainer's generator."""
        return draw_uniforms(self.cfg, self.cfg.rays_per_batch,
                             self.generator, self.device)

    def camera(self, view: int) -> Camera:
        if view not in self._cameras:
            self._cameras[view] = self.scene.cameras.at(view, self.device)
        return self._cameras[view]

    def step(self, camera: Camera, pixels, target_rgb, target_depth) -> dict:
        """One Adam step on a ray batch; returns the metrics as tensors."""
        cfg = self.cfg
        with fp32():
            origins, dirs, dirs_norm = sample_rays(camera, pixels)
            out = render_rays(self.model, origins, dirs, cfg,
                              uniforms=self.draw_uniforms())
            rgb_loss = torch.mean((out.rgb - target_rgb) ** 2)
            term = (target_depth if cfg.is_euclidean_depth
                    else target_depth * dirs_norm)
            if cfg.depth_loss_type is NerfDepthLossType.DS_NERF:
                d_loss = ds_nerf_depth_loss(out.weights, out.ts, term,
                                            self.sigma)
            else:
                d_loss = urf_depth_loss(out, term, self.sigma)
            dist = distortion_loss(out.weights, out.ts)
            total = (rgb_loss + cfg.depth_loss_mult * d_loss
                     + cfg.distortion_loss_mult * dist)
            self.opt.zero_grad(set_to_none=True)
            total.backward()
            self.opt.step()
        psnr = -10.0 * torch.log10(torch.clamp(rgb_loss.detach(), min=1e-10))
        return {"rgb_loss": rgb_loss.detach(), "depth_loss": d_loss.detach(),
                "distortion": dist.detach(), "psnr": psnr,
                "loss": total.detach()}

    def decay_sigma(self):
        if self.cfg.should_decay_sigma:
            # legacy/model_tactile.py:249-256, in float32
            self.sigma = torch.clamp(self.sigma * self.cfg.sigma_decay_rate,
                                     min=self.cfg.depth_sigma)

    def run(self, max_steps: int, log_every: int = 50, log_fn=None) -> dict:
        s = self.scene
        h, w = s.images.shape[1:3]
        R = self.cfg.rays_per_batch
        last = {}
        for i in range(max_steps):
            view = int(self.rng.choice(s.i_train))
            px = self.rng.integers(0, w, R)
            py = self.rng.integers(0, h, R)
            pixels = torch.as_tensor(np.stack([px, py], -1).astype(np.float32),
                                     device=self.device)
            rgb = torch.as_tensor(s.images[view][py, px], device=self.device)
            depth = (torch.as_tensor(s.depths[view][py, px],
                                     device=self.device)
                     if s.depths is not None
                     else torch.zeros((R,), device=self.device))
            metrics = self.step(self.camera(view), pixels, rgb, depth)
            self.decay_sigma()
            if i % log_every == 0 or i == max_steps - 1:
                last = {k: float(v) for k, v in metrics.items()}
                last["step"] = i
                if log_fn:
                    log_fn(last)
        return last

    def render_view(self, view: int, chunk: int = 8192) -> np.ndarray:
        """(H, W, 3) rgb of a view, unstratified; every chunk's importance
        uniforms from a generator seeded 0 (the JAX package's fixed key)."""
        cam = self.camera(view)
        h, w = cam.height, cam.width
        ys, xs = np.mgrid[0:h, 0:w]
        pixels = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
        outs = []
        with fp32(), torch.no_grad():
            for i in range(0, len(pixels), chunk):
                batch = torch.as_tensor(pixels[i:i + chunk],
                                        device=self.device)
                origins, dirs, _ = sample_rays(cam, batch)
                g = torch.Generator(device=self.device).manual_seed(0)
                out = render_rays(self.model, origins, dirs, self.cfg, g,
                                  stratified=False)
                outs.append(out.rgb.cpu().numpy())
        return np.concatenate(outs).reshape(h, w, 3)

"""Plain PyTorch reference of one Touch-GS view's render, written from the
method's equations: EWA projection, degree-3 spherical harmonics, tile
binning with a per-tile cap, and front-to-back compositing with the
tile-wide exit, differentiable by autograd.

It imports nothing of the program under test.  Every constant comes from
the configuration file (``perfbench/configs/<name>.json``, its ``train``
section), which states the values the program is run with:

- projection: pinhole with the Jacobian's view coordinates clamped to 1.3x
  the field of view, the 2D covariance dilated by ``eps2d``, a Gaussian
  culled behind ``near`` or with a degenerate covariance, its radius
  ``sigma_cutoff`` standard deviations of the larger eigenvalue, and its
  culling radius where its opacity falls under ``alpha_threshold``;
- binning: a Gaussian covers the tiles of its culling box, at most
  ``max_tiles_per_gaussian`` of them (a window centred on its mean, shaped
  like the box), minus the tiles whose rectangle lies beyond the culling
  radius; each tile's list is ordered by depth quantised to the bits left
  below the tile index, and holds its nearest ``k_tile`` entries;
- compositing: α = min(op·exp(−½ dᵀΣ⁻¹d), ``alpha_clip``), dropped under
  ``alpha_threshold``; a tile composites its list in chunks of ``k_chunk``
  entries and stops before chunk c once the largest transmittance of its
  pixels after chunk c − 2 is at most 1e-4 (the exit two chunks stale);
  depth is the α-weighted mean of the camera-space z.

A tile's pixels past the image edge are composited like any other (they
count in the exit's maximum) and cropped from the image.
"""
from __future__ import annotations

import torch

SAT_EPS = 1e-4   # the tile-wide exit's transmittance
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def world_to_camera(c2w: torch.Tensor) -> tuple:
    """(R, t) of the OpenCV world-to-camera map of an OpenGL camera-to-world
    matrix (the camera looks down −Z; OpenCV's +Z is forward)."""
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], device=c2w.device))
    r_c2w = c2w[:3, :3] @ flip
    R = r_c2w.T
    t = -(R @ c2w[:3, 3])
    return R, t


def rotation(q: torch.Tensor) -> torch.Tensor:
    """(N, 3, 3) rotations of (N, 4) wxyz quaternions, normalised first."""
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[0], 3, 3)


def project(means, quats, log_scales, opacities, alive, cam: dict,
            rc: dict) -> dict:
    """EWA projection of every Gaussian into ``cam`` (a dict of fx, fy, cx,
    cy as floats, c2w (4, 4), width, height).  Returns means2d (N, 2),
    conics (N, 3) = (a, b, c) of Σ⁻¹ = [[a, b], [b, c]], depths (N,),
    radii and cull radii (N,), zero where not valid, and valid (N,)."""
    fx, fy, cx, cy = cam["fx"], cam["fy"], cam["cx"], cam["cy"]
    W, H = cam["width"], cam["height"]
    R, t = world_to_camera(cam["c2w"])
    p = means @ R.T + t
    x, y, z = p.unbind(-1)
    zs = torch.where(z > rc["near"], z, torch.full_like(z, rc["near"]))

    # Σ_cam = R M Mᵀ Rᵀ with M = R_q diag(s)
    M = rotation(quats) * torch.exp(log_scales)[:, None, :]
    RM = R @ M
    cov = RM @ RM.transpose(1, 2)

    lim_x = 1.3 * 0.5 * W / fx
    lim_y = 1.3 * 0.5 * H / fy
    tx = torch.clamp(x / zs, -lim_x, lim_x) * zs
    ty = torch.clamp(y / zs, -lim_y, lim_y) * zs
    zero = torch.zeros_like(zs)
    J = torch.stack([
        torch.stack([fx / zs, zero, -fx * tx / (zs * zs)], -1),
        torch.stack([zero, fy / zs, -fy * ty / (zs * zs)], -1),
    ], dim=1)                                               # (N, 2, 3)
    cov2 = J @ cov @ J.transpose(1, 2)
    a = cov2[:, 0, 0] + rc["eps2d"]
    b = cov2[:, 0, 1]
    c = cov2[:, 1, 1] + rc["eps2d"]
    det = a * c - b * b
    det_s = torch.where(det > 1e-12, det, torch.full_like(det, 1e-12))
    conics = torch.stack([c / det_s, -b / det_s, a / det_s], dim=-1)
    means2d = torch.stack([fx * x / zs + cx, fy * y / zs + cy], dim=-1)

    with torch.no_grad():
        mid = 0.5 * (a + c)
        lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
        sig = torch.sqrt(lam)
        radius = torch.ceil(rc["sigma_cutoff"] * sig)
        cut = torch.sqrt(2.0 * torch.log(
            torch.clamp(opacities, min=1e-12) / rc["alpha_threshold"]))
        cull = torch.ceil(torch.clamp(cut, 0.0, rc["sigma_cutoff"]) * sig)
        mx, my = means2d[:, 0], means2d[:, 1]
        valid = ((z > rc["near"]) & (det > 1e-12)
                 & (mx + cull > 0) & (mx - cull < W)
                 & (my + cull > 0) & (my - cull < H)
                 & (cull > 0) & alive)
        radius = torch.where(valid, radius, torch.zeros_like(radius))
        cull = torch.where(valid, cull, torch.zeros_like(cull))
    return dict(means2d=means2d, conics=conics, depths=z, radii=radius,
                cull_radii=cull, valid=valid)


def sh_colors(sh: torch.Tensor, dirs: torch.Tensor, active: int
              ) -> torch.Tensor:
    """(N, 3) colours clamp(Σ_l≤active Y_l·k_l + 0.5, 0) of (N, 16, 3)
    coefficients along unit directions (N, 3)."""
    x, y, z = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    basis = [torch.full_like(x, SH_C0)]
    if active >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if active >= 2:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z,
                  SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if active >= 3:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
                  SH_C3[2] * y * (4 * zz - xx - yy),
                  SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                  SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
                  SH_C3[6] * x * (xx - 3 * yy)]
    Y = torch.cat(basis, dim=-1)                            # (N, k)
    col = torch.einsum("nk,nkc->nc", Y, sh[:, :Y.shape[1]])
    return torch.clamp(col + 0.5, min=0.0)


def tile_grid(width: int, height: int, rc: dict) -> tuple:
    th, tw = rc["tile_h"], rc["tile_w"]
    return -(-width // tw), -(-height // th)


def bin_tiles(proj: dict, width: int, height: int, rc: dict) -> tuple:
    """Each tile's list of Gaussians, nearest first, capped at the k_tile
    the program composites: ((n_tiles, K) int64 indices, −1 past a list's
    end; (n_tiles,) uncapped counts)."""
    th, tw = rc["tile_h"], rc["tile_w"]
    n_tx, n_ty = tile_grid(width, height, rc)
    n_tiles = n_tx * n_ty
    cap = rc["max_tiles_per_gaussian"]
    dev = proj["means2d"].device
    mx, my = proj["means2d"][:, 0].detach(), proj["means2d"][:, 1].detach()
    r = proj["cull_radii"]
    valid = proj["valid"]

    def tfloor(v, size, n):
        return torch.clamp(torch.floor(v / size), 0, n - 1).long()

    x0, x1 = tfloor(mx - r, tw, n_tx), tfloor(mx + r, tw, n_tx)
    y0, y1 = tfloor(my - r, th, n_ty), tfloor(my + r, th, n_ty)
    bw, bh = x1 - x0 + 1, y1 - y0 + 1
    # a box over the cap: a window of at most ``cap`` tiles, shaped like
    # the box and centred on the mean's tile, inside the box
    over = bw * bh > cap
    ww = torch.clamp(torch.round(torch.sqrt(
        cap * bw.float() / torch.clamp(bh.float(), min=1.0))).long(), 1, cap)
    ww = torch.minimum(ww, bw)
    wh = torch.minimum(cap // ww, bh)
    ww = torch.minimum(cap // wh, bw)
    wx0 = torch.minimum(torch.maximum(tfloor(mx, tw, n_tx) - ww // 2, x0),
                        x1 - ww + 1)
    wy0 = torch.minimum(torch.maximum(tfloor(my, th, n_ty) - wh // 2, y0),
                        y1 - wh + 1)
    x0, y0 = torch.where(over, wx0, x0), torch.where(over, wy0, y0)
    bw, bh = torch.where(over, ww, bw), torch.where(over, wh, bh)

    k = torch.arange(cap, device=dev)[None, :]
    tx = x0[:, None] + k % bw[:, None]
    ty = y0[:, None] + k // bw[:, None]
    ok = (k < (bw * bh)[:, None]) & valid[:, None]
    # the tile rectangle's closest point to the mean, within the radius
    rx0, ry0 = (tx * tw).float(), (ty * th).float()
    dx = mx[:, None] - torch.minimum(torch.maximum(mx[:, None], rx0),
                                     rx0 + tw)
    dy = my[:, None] - torch.minimum(torch.maximum(my[:, None], ry0),
                                     ry0 + th)
    ok &= dx * dx + dy * dy <= (r * r)[:, None]

    # depth quantised into the bits below the tile index
    bits = 31 - max(n_tiles, 1).bit_length()
    d = proj["depths"].detach()
    dmin = d[valid].min() if bool(valid.any()) else d.new_zeros(())
    dmax = d[valid].max() if bool(valid.any()) else d.new_ones(())
    scale = ((1 << bits) - 1) / torch.clamp(dmax - dmin, min=1e-9)
    q = torch.nan_to_num(torch.clamp((d - dmin) * scale, -2.0 ** 31,
                                     2.0 ** 31 - 256), nan=0.0)
    dq = torch.clamp(q.long(), 0, (1 << bits) - 1)

    tile = (ty * n_tx + tx)[ok]
    gauss = torch.arange(d.shape[0], device=dev)[:, None].expand_as(tx)[ok]
    key = (tile << bits) | dq[gauss]
    order = torch.argsort(key, stable=True)
    tile, gauss = tile[order], gauss[order]
    counts = torch.bincount(tile, minlength=n_tiles)
    starts = torch.cumsum(counts, 0) - counts
    K = rc["k_tile"]
    j = torch.arange(K, device=dev)[None, :]
    live = j < counts[:, None]
    pos = torch.where(live, starts[:, None] + j, torch.zeros_like(j))
    lists = torch.where(live, gauss[pos.clamp(max=max(len(gauss) - 1, 0))]
                        if len(gauss) else torch.zeros_like(pos),
                        torch.full_like(pos, -1))
    return lists, counts


def fit_k_tile(k_tile: int, k_chunk: int, n: int) -> int:
    """The cap the program composites: at most max(k_chunk, n), a multiple
    of k_chunk and of 128."""
    k = min(k_tile, max(k_chunk, n))
    k = -(-k // k_chunk) * k_chunk
    return -(-k // 128) * 128


def pixel_centres(tiles: torch.Tensor, n_tx: int, rc: dict) -> tuple:
    """(B, P) pixel-centre x and y of each tile's pixels, row-major."""
    th, tw = rc["tile_h"], rc["tile_w"]
    q = torch.arange(th * tw, device=tiles.device)
    px = (tiles % n_tx)[:, None] * tw + (q % tw)[None, :] + 0.5
    py = (tiles // n_tx)[:, None] * th + (q // tw)[None, :] + 0.5
    return px.float(), py.float()


def alphas(attr: torch.Tensor, lists: torch.Tensor, tiles: torch.Tensor,
           n_tx: int, rc: dict) -> tuple:
    """α (B, P, K) of each tile's list entries at its pixels, and the
    gathered entry attributes (B, K, 10) [mx, my, a, b, c, op, z, r, g, b];
    entries past a list's end have α = 0."""
    present = lists >= 0
    e = attr[lists.clamp(min=0)] * present[..., None]
    px, py = pixel_centres(tiles, n_tx, rc)
    dx = px[:, :, None] - e[:, None, :, 0]
    dy = py[:, :, None] - e[:, None, :, 1]
    power = (0.5 * (e[:, None, :, 2] * dx * dx + e[:, None, :, 4] * dy * dy)
             + e[:, None, :, 3] * dx * dy)
    a = torch.clamp(e[:, None, :, 5] * torch.exp(-power), max=rc["alpha_clip"])
    keep = (power >= 0) & (a >= rc["alpha_threshold"])
    return torch.where(keep, a, torch.zeros_like(a)), e


def live_entries(one_minus: torch.Tensor, counts: torch.Tensor,
                 rc: dict) -> torch.Tensor:
    """(B, K) bool: the entries of the chunks a tile composites.  Chunk c
    runs while c is under the list's chunk count and the largest
    transmittance of the tile's pixels after chunk c − 2 exceeds 1e-4."""
    with torch.no_grad():
        K = one_minus.shape[-1]
        kc = rc["k_chunk"]
        T = torch.cumprod(one_minus, dim=-1)
        m = T[..., kc - 1::kc].amax(dim=1)                 # (B, n_chunks)
        ones = torch.ones_like(m[:, :2])
        stale = torch.cat([ones, m[:, :-2]], dim=1)
        c = torch.arange(K // kc, device=m.device)[None, :]
        n_chunks = (torch.clamp(counts, max=K)[:, None] + kc - 1) // kc
        live = (c < n_chunks) & (stale > SAT_EPS)
        live = torch.cumprod(live.long(), dim=1).bool()
        return live.repeat_interleave(kc, dim=1)


def composite(attr: torch.Tensor, lists: torch.Tensor, counts: torch.Tensor,
              tiles: torch.Tensor, n_tx: int, rc: dict) -> torch.Tensor:
    """(B, 6, P) [R, G, B, D, A, T] of the tiles ``tiles`` (B,), their lists
    (B, K) and uncapped counts (B,)."""
    a, e = alphas(attr, lists, tiles, n_tx, rc)
    one_m = 1.0 - a
    live = live_entries(one_m, counts, rc)[:, None, :]
    one_m = torch.where(live, one_m, torch.ones_like(one_m))
    T_incl = torch.cumprod(one_m, dim=-1)
    T_excl = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl[..., :-1]],
                       dim=-1)
    w = torch.where(live, a, torch.zeros_like(a)) * T_excl
    vals = torch.stack([e[..., 7], e[..., 8], e[..., 9], e[..., 6]], dim=1)
    out = torch.einsum("bpk,bck->bcp", w, vals)
    return torch.cat([out, w.sum(-1)[:, None], T_incl[..., -1][:, None]],
                     dim=1)


def attributes(params: dict, cam: dict, rc: dict, active_sh: int) -> tuple:
    """The per-Gaussian compositing attributes (N, 10) [mx, my, a, b, c,
    op, z, r, g, b] of a view, and its projection."""
    op = torch.sigmoid(params["logit_opacities"])
    proj = project(params["means"], params["quats"], params["log_scales"],
                   op.detach(), params["alive"], cam, rc)
    d = params["means"] - cam["c2w"][:3, 3]
    dirs = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)
    sh = torch.cat([params["sh_dc"][:, None], params["sh_rest"]], dim=1)
    col = sh_colors(sh, dirs, active_sh)
    attr = torch.cat([proj["means2d"], proj["conics"], op[:, None],
                      proj["depths"][:, None], col], dim=-1)
    return attr, proj


def tile_blocks(n_tiles: int, block: int):
    for s in range(0, n_tiles, block):
        yield s, min(s + block, n_tiles)


def block_size(K: int, P: int, budget: int = 1 << 25) -> int:
    """Tiles a block so that one (B, P, K) tensor holds about ``budget``
    elements."""
    return max(1, budget // max(K * P, 1))


def render_stack(attr, lists, counts, width, height, rc: dict,
                 grad: bool = False) -> torch.Tensor:
    """(6, n_ty·th, n_tx·tw) stack [R, G, B, D, A, T] of the whole grid,
    composited in blocks of tiles."""
    n_tx, n_ty = tile_grid(width, height, rc)
    th, tw = rc["tile_h"], rc["tile_w"]
    n_tiles = n_tx * n_ty
    B = block_size(lists.shape[1], th * tw)
    outs = []
    with torch.set_grad_enabled(grad):
        for s, e in tile_blocks(n_tiles, B):
            tiles = torch.arange(s, e, device=attr.device)
            outs.append(composite(attr, lists[s:e], counts[s:e], tiles,
                                  n_tx, rc))
    return assemble(torch.cat(outs), n_tx, n_ty, th, tw)


def assemble(stack: torch.Tensor, n_tx: int, n_ty: int, th: int, tw: int
             ) -> torch.Tensor:
    """(n_tiles, C, P) → (C, n_ty·th, n_tx·tw)."""
    C = stack.shape[1]
    s = stack.reshape(n_ty, n_tx, C, th, tw).permute(2, 0, 3, 1, 4)
    return s.reshape(C, n_ty * th, n_tx * tw)


def unassemble(img: torch.Tensor, n_tx: int, n_ty: int, th: int, tw: int
               ) -> torch.Tensor:
    """(C, n_ty·th, n_tx·tw) → (n_tiles, C, P), the inverse of assemble."""
    C = img.shape[0]
    s = img.reshape(C, n_ty, th, n_tx, tw).permute(1, 3, 0, 2, 4)
    return s.reshape(n_ty * n_tx, C, th * tw)


def finish(stack: torch.Tensor, width: int, height: int,
           background: torch.Tensor) -> tuple:
    """rgb (H, W, 3) with the background behind, depth (H, W) normalised
    by the accumulated α, and α (H, W), cropped to the image."""
    s = stack[:, :height, :width]
    rgb = s[0:3].permute(1, 2, 0) + s[5][..., None] * background
    acc = s[4]
    depth = torch.where(acc > 1e-10, s[3] / torch.clamp(acc, min=1e-10),
                        torch.zeros_like(acc))
    return rgb, depth, acc


def needed_entries(attr, lists, counts, width, height, rc: dict
                   ) -> torch.Tensor:
    """(n_tiles,) entries each tile needs: those up to the one after which
    every pixel's transmittance is under 1e-4, or its whole capped list."""
    n_tx, n_ty = tile_grid(width, height, rc)
    th, tw = rc["tile_h"], rc["tile_w"]
    B = block_size(lists.shape[1], th * tw)
    out = []
    with torch.no_grad():
        for s, e in tile_blocks(n_tx * n_ty, B):
            tiles = torch.arange(s, e, device=attr.device)
            a, _ = alphas(attr, lists[s:e], tiles, n_tx, rc)
            Tmax = torch.cumprod(1.0 - a, dim=-1).amax(dim=1)   # (B, K)
            n_list = torch.clamp(counts[s:e], max=lists.shape[1])
            below = Tmax < SAT_EPS
            first = torch.where(below.any(-1), below.float().argmax(-1) + 1,
                                n_list)
            out.append(torch.minimum(first, n_list))
    return torch.cat(out)


def tile_pixels_in_image(width: int, height: int, rc: dict) -> torch.Tensor:
    """(n_tiles,) pixels of each tile inside the image."""
    n_tx, n_ty = tile_grid(width, height, rc)
    th, tw = rc["tile_h"], rc["tile_w"]
    cols = torch.clamp(width - torch.arange(n_tx) * tw, max=tw)
    rows = torch.clamp(height - torch.arange(n_ty) * th, max=th)
    return (rows[:, None] * cols[None, :]).reshape(-1)


"""The per-Gaussian shade stage of a render as one autograd function over
two fused kernels (``csrc/shade.cu``).

The shade stage turns the six parameter groups into what the tile kernels
read: the (C, 16) packed attribute rows ``[mx, my, ca~, cb~, cc~, op, z,
r, g, b, 0...]`` (``rasterize_cuda``'s layout, the conic columns carrying
log2(e)), and for binning means2d, depths, radii, cull radii and
validity.  ``splatfacto.shade`` and ``rasterize_cuda._attr_rows`` compute
it as a chain of PyTorch ops, differentiated by autograd; here it is:

- ``shade_fwd``: the whole stage in one pass, with the 512 dead rows that
  ``rasterize_cuda`` appends written as zeros when ``dead`` asks for them;
- ``shade_bwd``: its VJP, from the table's (C + dead, 16) gradient (what
  ``rasterize_cuda.scatter_rows`` returns) to each parameter group's
  gradient and the means2d offset's, the forward's intermediates
  recomputed rather than saved;
- ``_Shade``: the two as a ``torch.autograd.Function``, and
  ``shade_packed``, which ``splatfacto.render`` calls on the card.

Each wrapper dispatches on its tensors' device, as the other kernel
wrappers do: CUDA tensors launch the kernel, CPU tensors run the plain
version.  ``shade_fwd_plain`` is the op chain itself (``splatfacto.shade``
then ``_attr_rows``), which the forward kernel reproduces operation for
operation, so its radii, cull radii and validity equal the chain's.
``shade_bwd_plain`` is the analytic VJP the backward kernel computes,
written in PyTorch ops: autograd's masks (the near plane's and the det
guard's ``torch.where``, the Jacobian's and the colours' clamps, inclusive
at their limits, bands above the active degree) and zero rows wherever
the table's gradient is zero.  ``splatfacto.render`` on the CPU keeps the
op chain with autograd; ``_Shade`` on CPU tensors is for tests.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from touchgs_torch.config import ModelConfig
from touchgs_torch.ops import cuda_build
from touchgs_torch.ops import rasterize_cuda as rc
from touchgs_torch.ops import rasterize_plain as plain
from touchgs_torch.ops.cuda_build import check_tensor as _check
from touchgs_torch.ops.cuda_build import on_cuda as _on_cuda
from touchgs_torch.ops.projection import (ProjectedGaussians, _norm,
                                          _rotmat_elems, project_gaussians,
                                          view_directions)
from touchgs_torch.ops.sh import _C0, _C1, _C2, _C3, eval_sh, num_sh_bases

# the parameter groups the stage reads and differentiates, in order
GROUPS = ("means", "quats", "log_scales", "logit_opacities", "sh_dc",
          "sh_rest")
_LOG2E = rc._LOG2E


def _camera_tensors(camera, w2c) -> tuple:
    return (w2c, camera.c2w, camera.fx, camera.fy, camera.cx, camera.cy)


def _check_inputs(params: tuple, camera, w2c, cfg: ModelConfig,
                  active: int, alive=None, offset=None) -> tuple:
    """(C, bases past the DC band) after checking the inputs' types,
    shapes and layout and the active SH degree; raises ValueError."""
    C = params[0].shape[0]
    n_rest = num_sh_bases(cfg.sh_degree) - 1
    shapes = {"means": (C, 3), "quats": (C, 4), "log_scales": (C, 3),
              "logit_opacities": (C,), "sh_dc": (C, 3),
              "sh_rest": (C, n_rest, 3)}
    for name, t in zip(GROUPS, params):
        _check(t, name, torch.float32, shapes[name])
    if alive is not None:
        _check(alive, "alive", torch.bool, (C,))
    if offset is not None:
        _check(offset, "means2d_offset", torch.float32, (C, 2))
    _check(w2c, "w2c", torch.float32, (4, 4))
    _check(camera.c2w, "c2w", torch.float32, (4, 4))
    for name in ("fx", "fy", "cx", "cy"):
        _check(getattr(camera, name), name, torch.float32, ())
    if not 0 <= active <= cfg.sh_degree:
        raise ValueError(f"active SH degree {active}: want 0 to "
                         f"{cfg.sh_degree}")
    return C, n_rest


def shade_fwd_plain(params: tuple, alive, offset, camera, w2c,
                    cfg: ModelConfig, active: int, dead: int) -> tuple:
    """The op chain of ``splatfacto.shade`` and ``_attr_rows``: (table,
    means2d, depths, radii, cull_radii, valid), the table (C + dead, 16)
    with its last ``dead`` rows zero."""
    means, quats, log_scales, logit_opacities, sh_dc, sh_rest = params
    rcfg = cfg.rasterize
    opacities = torch.sigmoid(logit_opacities)
    proj = project_gaussians(
        means, quats, torch.exp(log_scales), w2c, camera.fx, camera.fy,
        camera.cx, camera.cy, camera.width, camera.height, rcfg,
        extra_valid=alive, opacities=opacities.detach())
    if offset is not None:
        proj = proj._replace(means2d=proj.means2d + offset)
    dirs = view_directions(means, camera.c2w[:3, 3])
    sh = torch.cat([sh_dc[:, None, :], sh_rest], dim=1)
    colors = torch.clamp(eval_sh(sh, dirs, cfg.sh_degree, active) + 0.5,
                         min=0.0)
    table = rc._attr_rows(proj, colors, opacities)
    if dead:
        table = torch.cat([table, table.new_zeros((dead, plain.A))])
    return (table, proj.means2d, proj.depths, proj.radii, proj.cull_radii,
            proj.valid)


def _sh_basis(dirs: torch.Tensor, n_rest: int, active: int) -> tuple:
    """Each basis function past the DC band (as ``eval_sh`` multiplies its
    coefficients) and its derivatives along x, y and z: four lists of
    ``n_rest`` (C,) columns, zero above the active degree."""
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    zero = torch.zeros_like(x)
    c1, c2, c3 = _C1, _C2, _C3
    rows = [  # (basis, d/dx, d/dy, d/dz)
        (-c1 * y, zero, zero - c1, zero),
        (c1 * z, zero, zero, zero + c1),
        (-c1 * x, zero - c1, zero, zero),
        (c2[0] * xy, c2[0] * y, c2[0] * x, zero),
        (c2[1] * yz, zero, c2[1] * z, c2[1] * y),
        (c2[2] * (2 * zz - xx - yy), -2 * c2[2] * x, -2 * c2[2] * y,
         4 * c2[2] * z),
        (c2[3] * xz, c2[3] * z, zero, c2[3] * x),
        (c2[4] * (xx - yy), 2 * c2[4] * x, -2 * c2[4] * y, zero),
        (c3[0] * y * (3 * xx - yy), c3[0] * 6 * xy, c3[0] * (3 * xx - 3 * yy),
         zero),
        (c3[1] * xy * z, c3[1] * yz, c3[1] * xz, c3[1] * xy),
        (c3[2] * y * (4 * zz - xx - yy), c3[2] * -2 * xy,
         c3[2] * (4 * zz - xx - 3 * yy), c3[2] * 8 * yz),
        (c3[3] * z * (2 * zz - 3 * xx - 3 * yy), c3[3] * -6 * xz,
         c3[3] * -6 * yz, c3[3] * (6 * zz - 3 * xx - 3 * yy)),
        (c3[4] * x * (4 * zz - xx - yy), c3[4] * (4 * zz - 3 * xx - yy),
         c3[4] * -2 * xy, c3[4] * 8 * xz),
        (c3[5] * z * (xx - yy), c3[5] * 2 * xz, c3[5] * -2 * yz,
         c3[5] * (xx - yy)),
        (c3[6] * x * (xx - 3 * yy), c3[6] * (3 * xx - 3 * yy),
         c3[6] * -6 * xy, zero),
    ]
    n_active = num_sh_bases(active) - 1
    rows = [r if b < n_active else (zero,) * 4
            for b, r in enumerate(rows[:n_rest])]
    return tuple(list(col) for col in zip(*rows)) if rows else ([],) * 4


def shade_bwd_plain(grad_table: torch.Tensor, params: tuple, camera, w2c,
                    cfg: ModelConfig, active: int) -> tuple:
    """The analytic VJP of ``shade_fwd_plain`` from the table's gradient
    (its first C rows read): the six groups' gradients and the means2d
    offset's, zero on every row whose incoming gradient is zero."""
    means, quats, log_scales, logit_opacities, sh_dc, sh_rest = params
    rcfg = cfg.rasterize
    C, n_rest = sh_rest.shape[0], sh_rest.shape[1]
    G = grad_table[:C, :plain.B + 1]
    live = (G != 0).any(dim=1)
    g = [G[:, k] for k in range(plain.B + 1)]
    W = [[w2c[i, j] for j in range(3)] for i in range(3)]
    fx, fy = camera.fx, camera.fy

    # the forward's intermediates, as project_gaussians computes them
    s = torch.exp(log_scales)
    op = torch.sigmoid(logit_opacities)
    m = [means[:, k] for k in range(3)]
    x, y, z = (W[i][0] * m[0] + W[i][1] * m[1] + W[i][2] * m[2] + w2c[i, 3]
               for i in range(3))
    front = z > rcfg.near
    zs = torch.where(front, z, torch.full_like(z, rcfg.near))
    nq = _norm(quats)[:, 0]
    den = nq + 1e-12
    qn = quats / den[:, None]
    R = _rotmat_elems(quats)
    M = [[W[r][0] * R[j] + W[r][1] * R[3 + j] + W[r][2] * R[6 + j]
          for j in range(3)] for r in range(3)]
    A = [[M[r][j] * s[:, j] for j in range(3)] for r in range(3)]
    cov = [[A[r][0] * A[t][0] + A[r][1] * A[t][1] + A[r][2] * A[t][2]
            for t in range(3)] for r in range(3)]
    lim_x = 1.3 * (0.5 * camera.width / fx)
    lim_y = 1.3 * (0.5 * camera.height / fy)
    u, v = x / zs, y / zs
    ucl = torch.clamp(u, -lim_x, lim_x)
    vcl = torch.clamp(v, -lim_y, lim_y)
    tx, ty = ucl * zs, vcl * zs
    iz = 1.0 / zs
    iz2 = iz * iz
    j00, j02 = fx * iz, -fx * tx * iz2
    j11, j12 = fy * iz, -fy * ty * iz2
    c00, c01, c02 = cov[0]
    c11, c12, c22 = cov[1][1], cov[1][2], cov[2][2]
    a = j00 * j00 * c00 + 2 * j00 * j02 * c02 + j02 * j02 * c22 + rcfg.eps2d
    b = j00 * (c01 * j11 + c02 * j12) + j02 * (c12 * j11 + c22 * j12)
    c = j11 * j11 * c11 + 2 * j11 * j12 * c12 + j12 * j12 * c22 + rcfg.eps2d
    det = a * c - b * b
    det_ok = det > 1e-12
    ds = torch.where(det_ok, det, torch.full_like(det, 1e-12))
    d = means - camera.c2w[:3, 3]
    nd = _norm(d)[:, 0]
    dd = nd + 1e-12
    dirs = d / dd[:, None]
    sh = torch.cat([sh_dc[:, None, :], sh_rest], dim=1)
    pre = eval_sh(sh, dirs, cfg.sh_degree, active) + 0.5

    # colours and SH
    gcol = torch.where(pre >= 0, G[:, plain.R:plain.B + 1],
                       torch.zeros_like(pre))
    g_dc = gcol * _C0
    basis, dbx, dby, dbz = _sh_basis(dirs, n_rest, active)
    g_rest = torch.stack([bk[:, None] * gcol for bk in basis], dim=1) \
        if n_rest else torch.zeros_like(sh_rest)
    dots = [(gcol * sh_rest[:, k]).sum(-1) for k in range(n_rest)]
    gdir = [sum((db[k] * dots[k] for k in range(n_rest)),
                torch.zeros_like(x)) for db in (dbx, dby, dbz)]
    gdot = gdir[0] * d[:, 0] + gdir[1] * d[:, 1] + gdir[2] * d[:, 2]
    gdd = -gdot / (dd * dd)
    gm = [gdir[j] / dd + d[:, j] * (gdd / nd) for j in range(3)]

    # the conic (c, -b, a) / det_safe and the det guard
    gA = g[plain.CA] * (0.5 * _LOG2E)
    gB = g[plain.CB] * _LOG2E
    gC = g[plain.CC] * (0.5 * _LOG2E)
    gdet = torch.where(det_ok, -(gA * c - gB * b + gC * a) / (ds * ds),
                       torch.zeros_like(ds))
    ga = gC / ds + gdet * c
    gb = -gB / ds - 2 * b * gdet
    gc = gA / ds + gdet * a
    # 2D covariance = J Σ Jᵀ (+ eps2d)
    gj00 = ga * (2 * j00 * c00 + 2 * j02 * c02) + gb * (c01 * j11 + c02 * j12)
    gj02 = ga * (2 * j00 * c02 + 2 * j02 * c22) + gb * (c12 * j11 + c22 * j12)
    gj11 = gc * (2 * j11 * c11 + 2 * j12 * c12) + gb * (j00 * c01 + j02 * c12)
    gj12 = gc * (2 * j11 * c12 + 2 * j12 * c22) + gb * (j00 * c02 + j02 * c22)
    gc00 = ga * j00 * j00
    gc01 = gb * j00 * j11
    gc02 = ga * 2 * j00 * j02 + gb * j00 * j12
    gc11 = gc * j11 * j11
    gc12 = gb * j02 * j11 + gc * 2 * j11 * j12
    gc22 = ga * j02 * j02 + gb * j02 * j12 + gc * j12 * j12
    # the Jacobian from 1/z and the clamped tx, ty; the mean fx x / z + cx
    giz2 = gj02 * (-fx * tx) + gj12 * (-fy * ty)
    giz = gj00 * fx + gj11 * fy + giz2 * 2 * iz
    gtx = gj02 * -fx * iz2
    gty = gj12 * -fy * iz2
    gu = torch.where((u >= -lim_x) & (u <= lim_x), gtx * zs,
                     torch.zeros_like(u))
    gv = torch.where((v >= -lim_y) & (v <= lim_y), gty * zs,
                     torch.zeros_like(v))
    gmx, gmy = g[plain.MX], g[plain.MY]
    gx = gu / zs + fx * (gmx / zs)
    gy = gv / zs + fy * (gmy / zs)
    gzs = (-giz * (iz * iz) + gtx * ucl + gty * vcl
           - (gu * x + gmx * (fx * x)) / (zs * zs)
           - (gv * y + gmy * (fy * y)) / (zs * zs))
    gz = g[plain.Z] + torch.where(front, gzs, torch.zeros_like(gzs))
    gm = [gm[j] + W[0][j] * gx + W[1][j] * gy + W[2][j] * gz
          for j in range(3)]

    # covariance = A Aᵀ, A = (W R) diag(s)
    gcv = [[gc00, gc01, gc02], [gc01, gc11, gc12], [gc02, gc12, gc22]]
    gs, gM = [0.0] * 3, [[None] * 3 for _ in range(3)]
    for r in range(3):
        for j in range(3):
            gAr = sum((2 if t == r else 1) * gcv[r][t] * A[t][j]
                      for t in range(3))
            gs[j] = gs[j] + gAr * M[r][j]
            gM[r][j] = gAr * s[:, j]
    gR = [W[0][t] * gM[0][j] + W[1][t] * gM[1][j] + W[2][t] * gM[2][j]
          for t in range(3) for j in range(3)]
    qw, qx, qy, qz = (qn[:, k] for k in range(4))
    gqn = torch.stack([
        2 * (-qz * gR[1] + qy * gR[2] + qz * gR[3] - qx * gR[5]
             - qy * gR[6] + qx * gR[7]),
        2 * (qy * gR[1] + qz * gR[2] + qy * gR[3] - 2 * qx * gR[4]
             - qw * gR[5] + qz * gR[6] + qw * gR[7] - 2 * qx * gR[8]),
        2 * (-2 * qy * gR[0] + qx * gR[1] + qw * gR[2] + qx * gR[3]
             + qz * gR[5] - qw * gR[6] + qz * gR[7] - 2 * qy * gR[8]),
        2 * (-2 * qz * gR[0] - qw * gR[1] + qx * gR[2] + qw * gR[3]
             - 2 * qz * gR[4] + qy * gR[5] + qx * gR[6] + qy * gR[7]),
    ], dim=-1)
    gden = -(gqn * quats).sum(-1) / (den * den)
    gq = gqn / den[:, None] + quats * (gden / nq)[:, None]

    grads = (torch.stack(gm, dim=-1), gq, torch.stack(gs, dim=-1) * s,
             g[plain.OP] * (1 - op) * op, g_dc, g_rest, G[:, :2])
    return tuple(torch.where(live.view((-1,) + (1,) * (t.dim() - 1)), t,
                             torch.zeros_like(t)) for t in grads)


def shade_fwd(params: tuple, alive, offset: Optional[torch.Tensor], camera,
              w2c, cfg: ModelConfig, active: int, dead: int) -> tuple:
    """The forward kernel: (table, means2d, depths, radii, cull_radii,
    valid) from the six groups ``params`` (``GROUPS``' order), ``alive``,
    the means2d ``offset`` or None, the camera with its world-to-camera
    ``w2c``; the table (C + dead, 16) with its last ``dead`` rows zero.
    CPU tensors take ``shade_fwd_plain``."""
    tensors = (*params, alive, *_camera_tensors(camera, w2c)) + (
        () if offset is None else (offset,))
    C, n_rest = _check_inputs(params, camera, w2c, cfg, active, alive,
                              offset)
    if not _on_cuda(*tensors):
        return shade_fwd_plain(params, alive, offset, camera, w2c, cfg,
                               active, dead)
    rcfg = cfg.rasterize
    dev = params[0].device
    table = torch.empty((C + dead, plain.A), dtype=torch.float32, device=dev)
    means2d = torch.empty((C, 2), dtype=torch.float32, device=dev)
    depths, radii, cull = (torch.empty((C,), dtype=torch.float32,
                                       device=dev) for _ in range(3))
    valid = torch.empty((C,), dtype=torch.bool, device=dev)
    cuda_build.launch(
        "shade_fwd", *(t.data_ptr() for t in params), alive.data_ptr(),
        None if offset is None else offset.data_ptr(),
        *(t.data_ptr() for t in _camera_tensors(camera, w2c)),
        table.data_ptr(), means2d.data_ptr(), depths.data_ptr(),
        radii.data_ptr(), cull.data_ptr(), valid.data_ptr(), C, dead,
        n_rest, active, camera.width, camera.height, rcfg.near, rcfg.eps2d,
        rcfg.sigma_cutoff,
        # the op chain's division by a Python number: PyTorch's CUDA
        # kernel multiplies by its reciprocal, taken in double
        1.0 / rcfg.alpha_threshold)
    return table, means2d, depths, radii, cull, valid


def shade_bwd(grad_table: torch.Tensor, params: tuple, camera, w2c,
              cfg: ModelConfig, active: int) -> tuple:
    """The backward kernel: the gradients of the six groups and of the
    means2d offset from the table's (C + dead, 16) gradient, contiguous
    and 16-byte aligned.  CPU tensors take ``shade_bwd_plain``."""
    C, n_rest = _check_inputs(params, camera, w2c, cfg, active)
    if grad_table.dim() != 2 or grad_table.shape[0] < C:
        raise ValueError(f"grad_table: want ({C} + dead, {plain.A}), got "
                         f"{tuple(grad_table.shape)}")
    _check(grad_table, "grad_table", torch.float32,
           (grad_table.shape[0], plain.A))
    if not _on_cuda(grad_table, *params, *_camera_tensors(camera, w2c)):
        return shade_bwd_plain(grad_table, params, camera, w2c, cfg, active)
    if grad_table.data_ptr() % 16:
        raise ValueError("grad_table: want a 16-byte aligned table, for its "
                         "float4 loads")
    grads = tuple(torch.empty_like(t) for t in params) + (
        params[0].new_empty((C, 2)),)
    cuda_build.launch("shade_bwd", grad_table.data_ptr(),
                      *(t.data_ptr() for t in params),
                      *(t.data_ptr() for t in _camera_tensors(camera, w2c)),
                      *(t.data_ptr() for t in grads), C, n_rest, active,
                      camera.width, camera.height, cfg.rasterize.near,
                      cfg.rasterize.eps2d)
    return grads


class _Shade(torch.autograd.Function):
    """``shade_fwd`` with ``shade_bwd`` as its backward: differentiable in
    the six groups and the means2d offset through the table alone; means2d,
    depths, radii, cull radii and validity are not differentiable."""

    @staticmethod
    def forward(ctx, means, quats, log_scales, logit_opacities, sh_dc,
                sh_rest, offset, alive, camera, w2c, cfg, active, dead):
        params = (means, quats, log_scales, logit_opacities, sh_dc, sh_rest)
        out = shade_fwd(params, alive, offset, camera, w2c, cfg, active,
                        dead)
        ctx.mark_non_differentiable(*out[1:])
        ctx.save_for_backward(*params)
        ctx.camera, ctx.w2c, ctx.cfg, ctx.active = camera, w2c, cfg, active
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_table, *_):
        grads = shade_bwd(grad_table.contiguous(), ctx.saved_tensors,
                          ctx.camera, ctx.w2c, ctx.cfg, ctx.active)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad)) + (
            None,) * 6


def shade_packed(params, camera, cfg: ModelConfig,
                 active_sh_degree: Optional[int] = None,
                 means2d_offset: Optional[torch.Tensor] = None,
                 dead_rows: bool = True) -> tuple:
    """(projected, table) of one view through ``_Shade``: the packed
    attribute table, differentiable in ``params``' six groups and
    ``means2d_offset``, followed by ``rasterize_cuda``'s 512 dead rows
    unless ``dead_rows`` is False (a mesh's rows, gathered before the dead
    rows are appended), and a ``ProjectedGaussians`` of the rest for
    binning and the densify statistics (``conics`` None: the table carries
    them)."""
    active = cfg.sh_degree if active_sh_degree is None else int(
        active_sh_degree)
    table, means2d, depths, radii, cull, valid = _Shade.apply(
        *(getattr(params, g).contiguous() for g in GROUPS), means2d_offset,
        params.alive, camera, camera.w2c, cfg, active,
        plain.DEAD_SPREAD if dead_rows else 0)
    return ProjectedGaussians(means2d=means2d, conics=None, depths=depths,
                              radii=radii, valid=valid,
                              cull_radii=cull), table

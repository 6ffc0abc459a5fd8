"""Capture post-processing tools: blur/similarity filtering + dataset resize
(port of ``touchgs_tpu/data/capture_tools.py``; numpy, as there, with the
images read and written by the port's PNG codec, ``data/png.py``).

- ``laplacian_blur_score`` / ``filter_blurry_dir`` — rebuild of
  ``data_collection/ros1/capturedata/scripts/filter_blurry.py:43-73``:
  Laplacian-variance blur detection (below threshold = blurry) and
  ring-buffer pairwise-PSNR near-duplicate detection (above threshold =
  redundant frame).
- ``resize_scene_images`` — the blender ``resize.py`` helper invoked at
  ``scripts/train_bunny_blender.sh:37-39`` (resize imgs to a square target,
  default 900×900, rescaling transforms.json intrinsics to match), with
  PIL's LANCZOS (``png.resize_lanczos``, byte for byte).  It rewrites PNGs
  only: a JPEG would need PIL's encoder, which the port does not carry
  (ROADMAP.md C22).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from touchgs_torch.data.png import decode_png, read_gray, resize_lanczos, write_png


def _laplacian(gray: np.ndarray) -> np.ndarray:
    """4-neighbor Laplacian (cv2.Laplacian kernel), replicate border."""
    p = np.pad(gray.astype(np.float64), 1, mode="edge")
    return (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
            - 4.0 * p[1:-1, 1:-1])


def laplacian_blur_score(image: np.ndarray) -> float:
    """Variance of the Laplacian of the grayscale image (higher = sharper)."""
    if image.ndim == 3:
        gray = image[..., :3] @ np.array([0.299, 0.587, 0.114])
    else:
        gray = image.astype(np.float64)
    return float(_laplacian(gray).var())


def pairwise_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """cv2.PSNR equivalent on uint8-range grayscale."""
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    if mse == 0:
        return 100.0
    return 10.0 * np.log10(255.0**2 / mse)


def filter_blurry_dir(
    image_dir: str | Path,
    blur_threshold: float = 150.0,
    similarity_threshold: float | None = 8.5,
    ring: int = 10,
) -> tuple[list[Path], list[Path]]:
    """Classify a capture directory.  Returns (keep, reject) path lists.

    Rejection reasons match the reference: Laplacian variance below
    ``blur_threshold`` (blurry), or mean pairwise PSNR over the last ``ring``
    frames above ``similarity_threshold`` (near-duplicate burst).
    """
    keep, reject = [], []
    buffer: list[np.ndarray] = []
    for p in sorted(Path(image_dir).iterdir()):
        if p.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        img = read_gray(p)
        if laplacian_blur_score(img) < blur_threshold:
            reject.append(p)
            continue
        if similarity_threshold is not None:
            if len(buffer) >= ring:
                buffer.pop(0)
            buffer.append(img)
            if len(buffer) == ring:
                total = 0.0
                n = 0
                for i in range(ring):
                    for j in range(i + 1, ring):
                        total += pairwise_psnr(buffer[i], buffer[j])
                        n += 1
                if total / n > similarity_threshold:
                    reject.append(p)
                    continue
        keep.append(p)
    return keep, reject


def resize_scene_images(
    scene_dir: str | Path,
    size: tuple[int, int] = (900, 900),
    image_dir: str = "imgs",
    transforms_name: str = "transforms.json",
) -> int:
    """Resize scene images in place and rescale intrinsics (the blender
    resize step, train_bunny_blender.sh:37-39).  Returns frames resized."""
    scene_dir = Path(scene_dir)
    img_dir = scene_dir / image_dir
    count = 0
    old_size = None
    for p in sorted(img_dir.iterdir()):
        if p.suffix.lower() not in (".png", ".jpg", ".jpeg"):
            continue
        if p.suffix.lower() != ".png":
            raise ValueError(f"{p}: the port rewrites PNG images only "
                             "(ROADMAP.md C22)")
        pixels, mode, _ = decode_png(p)
        if mode not in ("L", "LA", "RGB", "RGBA"):
            raise ValueError(f"{p}: LANCZOS of a {mode} PNG is not ported")
        old_size = (pixels.shape[1], pixels.shape[0])  # (w, h)
        write_png(p, resize_lanczos(pixels, *size))
        count += 1
    tf_path = scene_dir / transforms_name
    if tf_path.exists() and old_size is not None:
        meta = json.loads(tf_path.read_text())
        sx = size[0] / old_size[0]
        sy = size[1] / old_size[1]

        def rescale(d):
            for k, s in (("fl_x", sx), ("fl_y", sy), ("cx", sx), ("cy", sy)):
                if k in d:
                    d[k] = d[k] * s
            if "w" in d:
                d["w"] = size[0]
            if "h" in d:
                d["h"] = size[1]

        rescale(meta)
        for frame in meta.get("frames", []):
            rescale(frame)
        tf_path.write_text(json.dumps(meta, indent=4))
    return count

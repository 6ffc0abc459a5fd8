"""DenseTact live sensor loop, the RunCamera equivalent without ROS (port of
``touchgs_tpu/touch/sensor_loop.py``).

The reference's 30 Hz camera loop (``cam_ros.py:276-321``
``CAM_camerashow``; the ROS2 timer variant ``dtv2_cam_pub.py:120-127``):
per tick, grab a tactile frame → fisheye rectify (the per-sensor calib
index map, cam_ros.py:230-250) → the depth and force nets → publish.

Publishing without ROS topics: a run directory (``depth/frame_%05d.png``
uint8 like ``/RunCamera/imgDepth``, ``rect/frame_%05d.png``, ``force.csv``
rows like ``/RunCamera/force``) and an optional in-process callback.  PNGs
are read and written by the port's codec (``data/png.py``; a JPEG needs
PIL and raises, naming the file, where it is absent).  `SensorLoop.run`
keeps each frame's host time by stage on the loop (``frame_times``).

Frame sources: `DirectorySource` replays a capture directory (sorted
PNG/JPG) and `SyntheticSource` draws procedural frames with numpy, the same
as the JAX package's.
"""
from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np

from touchgs_torch.data.png import read_rgb, write_png
from touchgs_torch.touch.sensor_nets import DenseTactSensor


class SyntheticSource:
    """Procedural tactile-looking frames (a moving bump on a flat field)."""

    def __init__(self, size: int = 640, n_frames: int = 30, seed: int = 0):
        self.size = size
        self.n_frames = n_frames
        self.rng = np.random.default_rng(seed)

    def frames(self) -> Iterator[np.ndarray]:
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        for t in range(self.n_frames):
            cx = s / 2 + s / 4 * np.sin(t * 0.3)
            cy = s / 2 + s / 4 * np.cos(t * 0.3)
            bump = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2)
                            / (2 * (s / 12) ** 2)))
            img = np.stack([120 + 80 * bump, 100 + 60 * bump,
                            90 + 40 * bump], axis=-1)
            yield img.astype(np.uint8)


class DirectorySource:
    """Replay frames from a capture directory (sorted PNG/JPG)."""

    def __init__(self, path: str | Path):
        self.paths = sorted(
            p for p in Path(path).iterdir()
            if p.suffix.lower() in (".png", ".jpg", ".jpeg"))

    def frames(self) -> Iterator[np.ndarray]:
        for p in self.paths:
            yield read_rgb(p)


STAGES = ("rectify", "depth", "force", "publish")


@dataclasses.dataclass
class SensorLoop:
    """Grab → rectify → depth/force nets → publish, at ``rate_hz``."""

    sensor: DenseTactSensor
    out_dir: Optional[str | Path] = None
    rate_hz: float = 30.0             # cam_ros runs 30 Hz; ROS2 variant 25
    run_depth: bool = True            # ispos
    run_force: bool = True            # isforce
    on_frame: Optional[Callable[[int, dict], None]] = None
    # per frame: {stage: seconds} for `STAGES` and "total", filled by `run`
    frame_times: list = dataclasses.field(default_factory=list, init=False)

    def run(self, source) -> int:
        """Process every frame from ``source``; returns frames processed."""
        out = Path(self.out_dir) if self.out_dir else None
        force_rows = []
        if out:
            (out / "depth").mkdir(parents=True, exist_ok=True)
            (out / "rect").mkdir(parents=True, exist_ok=True)
        period = 1.0 / self.rate_hz
        self.frame_times = []
        n = 0
        for i, frame in enumerate(source.frames()):
            times = dict.fromkeys(STAGES, 0.0)
            t0 = last = time.perf_counter()

            def lap(stage):
                nonlocal last
                now = time.perf_counter()
                times[stage], last = now - last, now

            rect = self.sensor.rectify(frame)
            result = {"rect": rect}
            lap("rectify")
            if self.run_depth:
                result["depth"] = self.sensor.get_depth(rect)
                lap("depth")
            if self.run_force:
                result["force"] = self.sensor.get_force(rect)
                lap("force")
            if out:
                write_png(out / "rect" / f"frame_{i:05d}.png",
                          rect.astype(np.uint8))
                if "depth" in result:
                    write_png(out / "depth" / f"frame_{i:05d}.png",
                              result["depth"])
                if "force" in result:
                    force_rows.append(
                        f"{i}," + ",".join(f"{v:.6f}" for v in result["force"]))
            if self.on_frame:
                self.on_frame(i, result)
            lap("publish")
            n += 1
            times["total"] = dt = last - t0
            self.frame_times.append(times)
            if dt < period:
                time.sleep(period - dt)
        if out and force_rows:
            (out / "force.csv").write_text(
                "index,fx,fy,fz,tx,ty,tz\n" + "\n".join(force_rows) + "\n")
        return n

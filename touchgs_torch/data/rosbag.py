"""Minimal pure-Python ROS1 bag (v2.0) reader — capture extraction without ROS
(port of ``touchgs_tpu/data/rosbag.py``, with the images written by the
port's PNG codec, ``data/png.py``).

Rebuild of the reference's rosbag extraction tooling
(`data_collection/capturedata/kinova_capture/data_extract.py:38` pulls
images + tf out of recorded bags with the rosbag API).  This environment has
no ROS, so the bag container format is parsed directly:

- record framing: <4-byte header_len> <header> <4-byte data_len> <data>,
  header = concatenated <4-byte len><name=value> fields (ROS bag spec v2.0)
- op=0x07 connection records carry topic/type/md5 of each connection id
- op=0x05 chunk records hold the message stream (compression none or bz2)
- op=0x02 message-data records inside chunks reference a connection id

Only the two message types the capture pipeline records are deserialized,
by their fixed wire layout (no .msg parsing needed):

- ``sensor_msgs/Image``  → dict(stamp, frame_id, height, width, encoding,
  data as HxWxC uint8/uint16 numpy array)
- ``geometry_msgs/TransformStamped`` / ``tf2_msgs/TFMessage`` → dicts of
  (stamp, frame_id, child_frame_id, translation xyz, rotation wxyz)

Anything else is surfaced as raw bytes so callers can add decoders.
"""
from __future__ import annotations

import bz2
import struct
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from touchgs_torch.data.png import write_png

_MAGIC = b"#ROSBAG V2.0\n"


def _parse_header(buf: bytes) -> dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off:off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _records(buf: bytes) -> Iterator[tuple[dict[bytes, bytes], bytes]]:
    off = 0
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off:off + dlen]
        off += dlen
        yield header, data


def _read_string(buf: bytes, off: int) -> tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode("utf-8", "replace"), off + n


def _read_ros_header(buf: bytes, off: int) -> tuple[dict, int]:
    (seq,) = struct.unpack_from("<I", buf, off)
    off += 4
    sec, nsec = struct.unpack_from("<II", buf, off)
    off += 8
    frame_id, off = _read_string(buf, off)
    return {"seq": seq, "stamp": sec + nsec * 1e-9, "frame_id": frame_id}, off


_ENCODING_DTYPES = {
    "mono8": (np.uint8, 1), "8UC1": (np.uint8, 1),
    "mono16": (np.uint16, 1), "16UC1": (np.uint16, 1),
    "rgb8": (np.uint8, 3), "bgr8": (np.uint8, 3),
    "rgba8": (np.uint8, 4), "bgra8": (np.uint8, 4),
}


def _decode_image(data: bytes) -> dict:
    hdr, off = _read_ros_header(data, 0)
    height, width = struct.unpack_from("<II", data, off)
    off += 8
    encoding, off = _read_string(data, off)
    off += 1  # is_bigendian
    (step,) = struct.unpack_from("<I", data, off)
    off += 4
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    raw = data[off:off + dlen]
    dtype, channels = _ENCODING_DTYPES.get(encoding, (np.uint8, 1))
    img = np.frombuffer(raw, dtype=dtype)
    try:
        img = img.reshape(height, width, channels).squeeze()
    except ValueError:  # nonstandard row padding: keep flat
        pass
    if encoding.startswith("bgr"):
        img = img[..., [2, 1, 0] + ([3] if channels == 4 else [])]
    return {**hdr, "height": height, "width": width, "encoding": encoding,
            "data": img}


def _decode_transform_stamped(data: bytes, off: int = 0) -> tuple[dict, int]:
    hdr, off = _read_ros_header(data, off)
    child, off = _read_string(data, off)
    tx, ty, tz = struct.unpack_from("<ddd", data, off)
    off += 24
    qx, qy, qz, qw = struct.unpack_from("<dddd", data, off)
    off += 32
    return {**hdr, "child_frame_id": child,
            "translation": np.array([tx, ty, tz]),
            "rotation_wxyz": np.array([qw, qx, qy, qz])}, off


def _decode_tf_message(data: bytes) -> list[dict]:
    (n,) = struct.unpack_from("<I", data, 0)
    off = 4
    out = []
    for _ in range(n):
        tf, off = _decode_transform_stamped(data, off)
        out.append(tf)
    return out


_DECODERS = {
    "sensor_msgs/Image": _decode_image,
    "tf2_msgs/TFMessage": _decode_tf_message,
    "geometry_msgs/TransformStamped":
        lambda d: _decode_transform_stamped(d)[0],
}


class BagReader:
    """Iterate (topic, type, decoded_message) over a ROS1 v2.0 bag file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        raw = self.path.read_bytes()
        if not raw.startswith(_MAGIC):
            raise ValueError(f"{path}: not a ROSBAG V2.0 file")
        self._body = raw[len(_MAGIC):]
        self.connections: dict[int, dict] = {}
        self._scan_connections()

    def _scan_connections(self):
        for header, data in _records(self._body):
            op = header.get(b"op", b"")
            if op == b"\x07":
                conn = int.from_bytes(header[b"conn"], "little")
                sub = _parse_header(data)
                self.connections[conn] = {
                    "topic": header.get(b"topic", b"").decode(),
                    "type": sub.get(b"type", b"").decode(),
                }
            elif op == b"\x05":
                comp = header.get(b"compression", b"none")
                chunk = bz2.decompress(data) if comp == b"bz2" else data
                for h2, d2 in _records(chunk):
                    if h2.get(b"op") == b"\x07":
                        conn = int.from_bytes(h2[b"conn"], "little")
                        sub = _parse_header(d2)
                        self.connections.setdefault(conn, {
                            "topic": h2.get(b"topic", b"").decode(),
                            "type": sub.get(b"type", b"").decode(),
                        })

    def messages(
        self, topics: Optional[set[str]] = None
    ) -> Iterator[tuple[str, str, object]]:
        def emit(header, data):
            conn = int.from_bytes(header[b"conn"], "little")
            info = self.connections.get(conn, {"topic": "?", "type": "?"})
            if topics is not None and info["topic"] not in topics:
                return None
            decoder = _DECODERS.get(info["type"])
            msg = decoder(data) if decoder else data
            return info["topic"], info["type"], msg

        for header, data in _records(self._body):
            op = header.get(b"op", b"")
            if op == b"\x02":
                out = emit(header, data)
                if out:
                    yield out
            elif op == b"\x05":
                comp = header.get(b"compression", b"none")
                chunk = bz2.decompress(data) if comp == b"bz2" else data
                for h2, d2 in _records(chunk):
                    if h2.get(b"op") == b"\x02":
                        out = emit(h2, d2)
                        if out:
                            yield out


def extract_images_and_tf(
    bag_path: str | Path,
    image_topic: str,
    out_dir: str | Path,
    tf_topic: str = "/tf",
) -> dict:
    """data_extract.py parity: dump images as PNGs + tf poses as npy.

    Returns {"images": [paths], "transforms": [tf dicts]}.
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    reader = BagReader(bag_path)
    image_paths, transforms = [], []
    idx = 0
    for topic, mtype, msg in reader.messages({image_topic, tf_topic}):
        if topic == image_topic and isinstance(msg, dict) and "data" in msg:
            p = out / f"image_{idx:05d}.png"
            arr = msg["data"]
            # PIL's fromarray takes a flat array as one column
            write_png(p, arr[:, None] if arr.ndim == 1 else arr)
            image_paths.append(str(p))
            idx += 1
        elif topic == tf_topic:
            transforms.extend(msg if isinstance(msg, list) else [msg])
    if transforms:
        np.save(out / "tf_poses.npy",
                np.stack([np.concatenate([t["translation"],
                                          t["rotation_wxyz"]])
                          for t in transforms]))
    return {"images": image_paths, "transforms": transforms}

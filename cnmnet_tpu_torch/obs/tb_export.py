"""TensorBoard export of the JSONL event stream (``cnmnet_tpu/obs/tb_export.py``),
written at the wire level without TensorFlow.

Converts a ``MetricLogger`` run directory (``events.jsonl`` and
``images/<tag>/<step>.png``) into one ``events.out.tfevents.*`` file that
TensorBoard reads:

* framing: TFRecord, ``uint64 len | masked crc32c(len) | data | masked
  crc32c(data)``, crc32c = Castagnoli, mask = rot15 + 0xa282ead8;
* payload: ``Event`` protos (wall_time=1 double, step=2 varint,
  file_version=3 string, summary=5 message) carrying ``Summary.Value``
  (tag=1, simple_value=2 float, image=4, histo=5).

Scalars map 1:1. JSONL histograms keep summary statistics, not counts, so
they export as a 4-bucket sketch spanning (min, p5, p50, p95, max) with
5/45/45/5% mass. PNG dumps are embedded verbatim. The records are the
JAX package's byte for byte.

Usage: ``python -m cnmnet_tpu_torch.obs.tb_export <run_dir> [--out DIR]``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import struct
import time
from typing import Dict, Iterator, List, Tuple

# ---------------------------------------------------------------- crc32c

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- proto encoding

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_bytes(field: int, b: bytes) -> bytes:
    return _key(field, 2) + _varint(len(b)) + b


def _f_packed_doubles(field: int, vals) -> bytes:
    return _f_bytes(field, b"".join(struct.pack("<d", v) for v in vals))


def _summary_value(tag: str, body: bytes) -> bytes:
    return _f_bytes(1, _f_bytes(1, tag.encode()) + body)


def _event(wall_time: float, step: int, summary: bytes = b"",
           file_version: str = "") -> bytes:
    out = _f_double(1, wall_time) + _f_varint(2, int(step))
    if file_version:
        out += _f_bytes(3, file_version.encode())
    if summary:
        out += _f_bytes(5, summary)
    return out


# ------------------------------------------------------------ writing

class TFEventWriter:
    """Appends TFRecord-framed Event protos to an events.out.tfevents file."""

    def __init__(self, out_dir: str, suffix: str = "cnmnet"):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(
            out_dir, f"events.out.tfevents.{int(time.time())}.{suffix}"
        )
        self._f = open(self.path, "wb")
        self.write_event(_event(time.time(), 0, file_version="brain.Event:2"))

    def write_event(self, event: bytes) -> None:
        header = struct.pack("<Q", len(event))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(event)
        self._f.write(struct.pack("<I", _masked_crc(event)))

    def scalars(self, wall: float, step: int, values: Dict[str, float]) -> None:
        body = b"".join(
            _summary_value(tag, _f_float(2, float(v))) for tag, v in values.items()
        )
        self.write_event(_event(wall, step, body))

    def histogram_sketch(self, wall: float, step: int, tag: str,
                         stats: Dict[str, float]) -> None:
        lo, hi = stats["min"], stats["max"]
        # strictly increasing bucket edges (duplicate percentiles collapse
        # when the distribution is near-degenerate)
        edges = [stats["p5"], stats["p50"], stats["p95"], hi]
        for i in range(1, len(edges)):
            if edges[i] <= edges[i - 1]:
                edges[i] = edges[i - 1] + max(abs(edges[i - 1]), 1.0) * 1e-9
        counts = [5.0, 45.0, 45.0, 5.0]
        mean = stats["mean"]
        # sum_squares must encode the recorded variance — TB derives the
        # display std from sum/sum_squares, not the bucket sketch
        var = stats.get("std", 0.0) ** 2
        histo = (
            _f_double(1, lo)
            + _f_double(2, hi)
            + _f_double(3, 100.0)
            + _f_double(4, mean * 100.0)
            + _f_double(5, (var + mean * mean) * 100.0)
            + _f_packed_doubles(6, edges)
            + _f_packed_doubles(7, counts)
        )
        self.write_event(_event(wall, step, _summary_value(tag, _f_bytes(5, histo))))

    def image_png(self, wall: float, step: int, tag: str, png: bytes,
                  height: int, width: int) -> None:
        img = (
            _f_varint(1, height) + _f_varint(2, width) + _f_varint(3, 3)
            + _f_bytes(4, png)
        )
        self.write_event(_event(wall, step, _summary_value(tag, _f_bytes(4, img))))

    def close(self) -> None:
        self._f.close()


# ------------------------------------------------- reading (for tests/tools)

def read_records(path: str) -> Iterator[bytes]:
    """Yield raw Event payloads, verifying both CRCs."""
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                return
            (crc_h,) = struct.unpack("<I", f.read(4))
            if crc_h != _masked_crc(header):
                raise ValueError("corrupt record header crc")
            (n,) = struct.unpack("<Q", header)
            data = f.read(n)
            (crc_d,) = struct.unpack("<I", f.read(4))
            if crc_d != _masked_crc(data):
                raise ValueError("corrupt record data crc")
            yield data


def parse_proto(data: bytes) -> Dict[int, list]:
    """Minimal proto decoder: field number -> list of raw values."""
    out: Dict[int, list] = {}
    i = 0
    while i < len(data):
        tag = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            tag |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
        elif wire == 1:
            (v,) = struct.unpack("<d", data[i : i + 8])
            i += 8
        elif wire == 5:
            (v,) = struct.unpack("<f", data[i : i + 4])
            i += 4
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            v = data[i : i + ln]
            i += ln
        else:
            raise ValueError(f"unsupported wire type {wire}")
        out.setdefault(field, []).append(v)
    return out


# ---------------------------------------------------------- conversion

_SKIP_KEYS = {"step", "time", "type", "tag"}


def convert_run(run_dir: str, out_dir: str | None = None) -> str:
    """events.jsonl (+ images/) -> one tfevents file; returns its path."""
    out_dir = out_dir or run_dir
    jsonl = os.path.join(run_dir, "events.jsonl")
    writer = TFEventWriter(out_dir)
    n_scalar = n_hist = n_img = 0
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                wall = rec.get("time", 0.0)
                step = rec.get("step", 0)
                if rec.get("type") == "histogram":
                    writer.histogram_sketch(wall, step, rec["tag"], rec)
                    n_hist += 1
                else:
                    vals = {
                        k: v for k, v in rec.items()
                        if k not in _SKIP_KEYS and isinstance(v, (int, float))
                    }
                    if vals:
                        writer.scalars(wall, step, vals)
                        n_scalar += 1
    for png_path in sorted(glob.glob(os.path.join(run_dir, "images", "*", "*.png"))):
        tag = os.path.basename(os.path.dirname(png_path))
        m = re.match(r"(\d+)", os.path.basename(png_path))
        step = int(m.group(1)) if m else 0
        with open(png_path, "rb") as f:
            png = f.read()
        w, h = _png_size(png)
        writer.image_png(os.path.getmtime(png_path), step, tag, png, h, w)
        n_img += 1
    writer.close()
    print(
        f"wrote {writer.path}: {n_scalar} scalar events, {n_hist} histograms, "
        f"{n_img} images"
    )
    return writer.path


def _png_size(png: bytes) -> Tuple[int, int]:
    if png[:8] != b"\x89PNG\r\n\x1a\n" or png[12:16] != b"IHDR":
        return 0, 0
    w, h = struct.unpack(">II", png[16:24])
    return w, h


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("run_dir", help="MetricLogger run dir (contains events.jsonl)")
    p.add_argument("--out", default=None, help="output dir (default: run_dir)")
    args = p.parse_args(argv)
    convert_run(args.run_dir, args.out)


if __name__ == "__main__":
    main()

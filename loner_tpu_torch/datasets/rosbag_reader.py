"""A ROS1 bag (v2.0) reader in pure Python: PointCloud2 and TF, no ROS needed.

Counterpart of ``loner_tpu/datasets/rosbag_reader.py``, with what the ingest
path needs:

  * the container: the magic line, records with length-prefixed header fields,
    chunks (no compression or bz2; an lz4 chunk raises ``NotImplementedError``),
    connection records, message-data records inside chunks;
  * ``sensor_msgs/PointCloud2`` (header, fields, blob);
  * ``tf2_msgs/TFMessage`` of ``geometry_msgs/TransformStamped`` (ground truth
    recorded as /tf).

Format: the public ROS Bags/Format/2.0 specification. Decoded messages carry the
slice of the rospy message API a converter reads (``msg.fields[i].name/offset/
datatype``, ``msg.header.stamp.to_sec()``, ``msg.data``, ...). The port's
writer (``datasets/rosbag_writer.py``) shares no code with this reader, so round
trips test the format.
"""
from __future__ import annotations

import bz2
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

_MAGIC = b"#ROSBAG V2.0\n"

OP_MESSAGE_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    """A record header: sequence of <len u32><name=value> fields."""
    fields: Dict[bytes, bytes] = {}
    i = 0
    while i < len(buf):
        (flen,) = struct.unpack_from("<I", buf, i)
        i += 4
        entry = buf[i : i + flen]
        i += flen
        name, _, value = entry.partition(b"=")
        fields[name] = value
    return fields


def _read_record(f) -> Optional[Tuple[Dict[bytes, bytes], bytes]]:
    head_len = f.read(4)
    if len(head_len) < 4:
        return None
    (hlen,) = struct.unpack("<I", head_len)
    header = _parse_header(f.read(hlen))
    (dlen,) = struct.unpack("<I", f.read(4))
    data = f.read(dlen)
    return header, data


def _iter_subrecords(buf: bytes) -> Iterator[Tuple[Dict[bytes, bytes], bytes]]:
    i = 0
    n = len(buf)
    while i + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        header = _parse_header(buf[i : i + hlen])
        i += hlen
        (dlen,) = struct.unpack_from("<I", buf, i)
        i += 4
        data = buf[i : i + dlen]
        i += dlen
        yield header, data


# ---------------------------------------------------------------------------
# Message deserialization (little-endian ROS1 serialization)
# ---------------------------------------------------------------------------

class _Time:
    __slots__ = ("secs", "nsecs")

    def __init__(self, secs: int, nsecs: int) -> None:
        self.secs, self.nsecs = secs, nsecs

    def to_sec(self) -> float:
        return self.secs + self.nsecs * 1e-9


@dataclass
class Header:
    seq: int
    stamp: _Time
    frame_id: str


@dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int


@dataclass
class PointCloud2:
    header: Header
    height: int
    width: int
    fields: List[PointField]
    is_bigendian: bool
    point_step: int
    row_step: int
    data: bytes
    is_dense: bool


@dataclass
class Vector3:
    x: float
    y: float
    z: float


@dataclass
class Quaternion:
    x: float
    y: float
    z: float
    w: float


@dataclass
class Transform:
    translation: Vector3
    rotation: Quaternion


@dataclass
class TransformStamped:
    header: Header
    child_frame_id: str
    transform: Transform


@dataclass
class TFMessage:
    transforms: List[TransformStamped] = field(default_factory=list)


class _Cursor:
    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes) -> None:
        self.buf, self.i = buf, 0

    def u8(self) -> int:
        (v,) = struct.unpack_from("<B", self.buf, self.i)
        self.i += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.i)
        self.i += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.i)
        self.i += 8
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.i : self.i + n]
        self.i += n
        return s.decode("utf-8", errors="replace")

    def raw(self, n: int) -> bytes:
        b = self.buf[self.i : self.i + n]
        self.i += n
        return b

    def header(self) -> Header:
        seq = self.u32()
        stamp = _Time(self.u32(), self.u32())
        return Header(seq, stamp, self.string())


def _decode_pointcloud2(buf: bytes) -> PointCloud2:
    c = _Cursor(buf)
    header = c.header()
    height, width = c.u32(), c.u32()
    fields = [
        PointField(c.string(), c.u32(), c.u8(), c.u32()) for _ in range(c.u32())
    ]
    is_bigendian = bool(c.u8())
    point_step, row_step = c.u32(), c.u32()
    data = c.raw(c.u32())
    is_dense = bool(c.u8())
    return PointCloud2(
        header, height, width, fields, is_bigendian, point_step, row_step,
        data, is_dense,
    )


def _decode_tf(buf: bytes) -> TFMessage:
    c = _Cursor(buf)
    msg = TFMessage()
    for _ in range(c.u32()):
        header = c.header()
        child = c.string()
        trans = Vector3(c.f64(), c.f64(), c.f64())
        rot = Quaternion(c.f64(), c.f64(), c.f64(), c.f64())
        msg.transforms.append(
            TransformStamped(header, child, Transform(trans, rot))
        )
    return msg


_DECODERS = {
    "sensor_msgs/PointCloud2": _decode_pointcloud2,
    "tf2_msgs/TFMessage": _decode_tf,
    "tf/tfMessage": _decode_tf,  # same wire format
}


# ---------------------------------------------------------------------------
# Bag reader
# ---------------------------------------------------------------------------

@dataclass
class _Connection:
    conn_id: int
    topic: str
    msg_type: str


class Bag:
    """Sequential ROS1 v2.0 bag reader (mirrors rosbag.Bag's read_messages).

    Messages inside chunks are yielded in file order, which standard
    recorders write chronologically per chunk; like the reference's ingest
    loop we rely on per-scan timestamps downstream rather than global
    ordering guarantees.
    """

    def __init__(self, path: str) -> None:
        self._path = path
        self._file = open(path, "rb")
        magic = self._file.read(len(_MAGIC))
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a ROS1 v2.0 bag (magic {magic!r})")

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "Bag":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def read_messages(
        self, topics: Optional[List[str]] = None
    ) -> Iterator[Tuple[str, object, _Time]]:
        """Yield (topic, decoded_msg, receive_time). Undecodable message
        types on requested topics yield the raw bytes."""
        self._file.seek(len(_MAGIC))
        connections: Dict[int, _Connection] = {}
        want = set(topics) if topics else None

        def handle(header: Dict[bytes, bytes], data: bytes):
            op = header[b"op"][0]
            if op == OP_CONNECTION:
                conn_id = struct.unpack("<I", header[b"conn"])[0]
                conn_fields = _parse_header(data)
                topic = header.get(b"topic", conn_fields.get(b"topic", b"")).decode()
                msg_type = conn_fields.get(b"type", b"").decode()
                connections[conn_id] = _Connection(conn_id, topic, msg_type)
            elif op == OP_MESSAGE_DATA:
                conn_id = struct.unpack("<I", header[b"conn"])[0]
                secs, nsecs = struct.unpack("<II", header[b"time"])
                conn = connections.get(conn_id)
                if conn is None or (want and conn.topic not in want):
                    return None
                decoder = _DECODERS.get(conn.msg_type)
                msg = decoder(data) if decoder else data
                return conn.topic, msg, _Time(secs, nsecs)
            return None

        while True:
            rec = _read_record(self._file)
            if rec is None:
                break
            header, data = rec
            op = header[b"op"][0]
            if op == OP_CHUNK:
                compression = header.get(b"compression", b"none")
                if compression == b"bz2":
                    data = bz2.decompress(data)
                elif compression == b"lz4":
                    raise NotImplementedError(
                        "lz4-compressed bags are not supported; re-record "
                        "with --bz2 or uncompressed"
                    )
                for sub_header, sub_data in _iter_subrecords(data):
                    out = handle(sub_header, sub_data)
                    if out is not None:
                        yield out
            else:
                out = handle(header, data)
                if out is not None:
                    yield out


def bag_topics(path: str) -> Dict[str, str]:
    """{topic: message type} for every connection in the bag."""
    topics: Dict[str, str] = {}
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path}: not a ROS1 v2.0 bag")
        while True:
            rec = _read_record(f)
            if rec is None:
                break
            header, data = rec
            op = header[b"op"][0]
            records = (
                _iter_subrecords(
                    bz2.decompress(data)
                    if header.get(b"compression") == b"bz2"
                    else data
                )
                if op == OP_CHUNK
                else [(header, data)]
            )
            for sub_header, sub_data in records:
                if sub_header[b"op"][0] == OP_CONNECTION:
                    conn_fields = _parse_header(sub_data)
                    topic = sub_header.get(
                        b"topic", conn_fields.get(b"topic", b"")
                    ).decode()
                    topics[topic] = conn_fields.get(b"type", b"").decode()
    return topics

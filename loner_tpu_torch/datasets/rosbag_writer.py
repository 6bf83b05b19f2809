"""A ROS1 v2.0 bag writer: chunked, with no compression or bz2.

Counterpart of ``loner_tpu/datasets/rosbag_writer.py``: the magic line, a bag
header whose ``index_pos`` is patched on close, connection records inside the
first chunk and again in the index section, chunk records, IndexData (op 0x04)
and ChunkInfo (op 0x06) records. With the same message sequence it writes the
same bytes as the JAX package's writer. Real Ouster bags (Fusion Portable,
Newer College) come in this container, and ``datasets/synthetic_bag.py`` writes
drill bags with it.

The writer shares no code with the reader (``datasets/rosbag_reader.py``): each
side follows the public format specification, so round trips test the format
and not one implementation.
"""
from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = b"#ROSBAG V2.0\n"

OP_MESSAGE_DATA = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX_DATA = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


def _hfield(name: bytes, value: bytes) -> bytes:
    entry = name + b"=" + value
    return struct.pack("<I", len(entry)) + entry


def _record(fields: Dict[bytes, bytes], data: bytes) -> bytes:
    header = b"".join(_hfield(k, v) for k, v in fields.items())
    return struct.pack("<I", len(header)) + header + struct.pack("<I", len(data)) + data


def _time(t: float) -> Tuple[int, int]:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 1_000_000_000:  # round-up spill
        secs, nsecs = secs + 1, nsecs - 1_000_000_000
    return secs, nsecs


def ros_string(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def ros_header(seq: int, stamp: float, frame: str) -> bytes:
    secs, nsecs = _time(stamp)
    return struct.pack("<III", seq, secs, nsecs) + ros_string(frame)


# sensor_msgs/PointField datatype codes
UINT8, UINT16, UINT32 = 2, 4, 6
FLOAT32, FLOAT64 = 7, 8


def pointcloud2_bytes(
    stamp: float,
    frame: str,
    height: int,
    width: int,
    fields: List[Tuple[str, int, int]],
    point_step: int,
    blob: bytes,
    seq: int = 0,
) -> bytes:
    """Serialize sensor_msgs/PointCloud2. ``fields`` = (name, offset,
    datatype); ``blob`` must be height*width*point_step bytes."""
    assert len(blob) == height * width * point_step
    out = ros_header(seq, stamp, frame)
    out += struct.pack("<II", height, width)
    out += struct.pack("<I", len(fields))
    for name, off, dtype in fields:
        out += ros_string(name) + struct.pack("<IBI", off, dtype, 1)
    out += struct.pack("<B", 0)  # is_bigendian
    out += struct.pack("<II", point_step, point_step * width)
    out += struct.pack("<I", len(blob)) + blob
    out += struct.pack("<B", 1)  # is_dense
    return out


def tf_message_bytes(
    stamp: float, parent: str, child: str, xyz, quat_xyzw, seq: int = 0
) -> bytes:
    """Serialize tf2_msgs/TFMessage with one TransformStamped."""
    out = struct.pack("<I", 1)
    out += ros_header(seq, stamp, parent)
    out += ros_string(child)
    out += struct.pack("<3d", *[float(v) for v in xyz])
    out += struct.pack("<4d", *[float(v) for v in quat_xyzw])
    return out


@dataclass
class _ChunkState:
    buf: bytearray = field(default_factory=bytearray)
    count: int = 0
    start: Optional[float] = None
    end: Optional[float] = None
    # conn_id -> [(time, offset-in-uncompressed-chunk)]
    index: Dict[int, List[Tuple[float, int]]] = field(default_factory=dict)
    conn_counts: Dict[int, int] = field(default_factory=dict)


class BagWriter:
    """Streaming chunked writer: messages accumulate into an in-memory
    chunk, flushed (optionally bz2-compressed) when it exceeds
    ``chunk_bytes``. Close patches index_pos and appends the index
    section (connection + ChunkInfo records) like ``rosbag record``.
    """

    def __init__(self, path: str, compression: str = "none",
                 chunk_bytes: int = 4 * 1024 * 1024) -> None:
        assert compression in ("none", "bz2")
        self._f = open(path, "wb")
        self._compression = compression
        self._chunk_bytes = chunk_bytes
        self._connections: Dict[str, Tuple[int, str]] = {}
        self._conn_records: List[bytes] = []
        self._chunk = _ChunkState()
        self._chunk_infos: List[Tuple[int, _ChunkState]] = []  # (file_pos, state)
        self._closed = False
        self._f.write(_MAGIC)
        self._header_pos = self._f.tell()
        # Placeholder bag header; rewritten on close with real counts.
        self._f.write(self._bag_header_record(0, 0, 0))

    def _bag_header_record(self, index_pos: int, conn_count: int,
                           chunk_count: int) -> bytes:
        rec = _record(
            {
                b"op": bytes([OP_BAG_HEADER]),
                b"index_pos": struct.pack("<Q", index_pos),
                b"conn_count": struct.pack("<I", conn_count),
                b"chunk_count": struct.pack("<I", chunk_count),
            },
            b"",
        )
        # rosbag pads the header record to 4096 bytes of header space.
        pad = 4096 - (len(rec) - 8)
        fields = {
            b"op": bytes([OP_BAG_HEADER]),
            b"index_pos": struct.pack("<Q", index_pos),
            b"conn_count": struct.pack("<I", conn_count),
            b"chunk_count": struct.pack("<I", chunk_count),
        }
        header = b"".join(_hfield(k, v) for k, v in fields.items())
        data = b" " * max(0, pad)
        return (
            struct.pack("<I", len(header)) + header
            + struct.pack("<I", len(data)) + data
        )

    def _connection_record(self, conn_id: int, topic: str, msg_type: str) -> bytes:
        conn_header = (
            _hfield(b"topic", topic.encode())
            + _hfield(b"type", msg_type.encode())
            + _hfield(b"md5sum", b"0" * 32)
            + _hfield(b"message_definition", b"")
        )
        return _record(
            {
                b"op": bytes([OP_CONNECTION]),
                b"conn": struct.pack("<I", conn_id),
                b"topic": topic.encode(),
            },
            conn_header,
        )

    def add_connection(self, topic: str, msg_type: str) -> int:
        if topic in self._connections:
            return self._connections[topic][0]
        conn_id = len(self._connections)
        self._connections[topic] = (conn_id, msg_type)
        rec = self._connection_record(conn_id, topic, msg_type)
        self._conn_records.append(rec)
        # Connections live inside the chunk stream so a sequential reader
        # sees them before the messages that use them.
        self._chunk.buf += rec
        return conn_id

    def write(self, topic: str, payload: bytes, t: float) -> None:
        conn_id, _ = self._connections[topic]
        secs, nsecs = _time(t)
        st = self._chunk
        st.index.setdefault(conn_id, []).append((t, len(st.buf)))
        st.conn_counts[conn_id] = st.conn_counts.get(conn_id, 0) + 1
        st.buf += _record(
            {
                b"op": bytes([OP_MESSAGE_DATA]),
                b"conn": struct.pack("<I", conn_id),
                b"time": struct.pack("<II", secs, nsecs),
            },
            payload,
        )
        st.count += 1
        st.start = t if st.start is None else min(st.start, t)
        st.end = t if st.end is None else max(st.end, t)
        if len(st.buf) >= self._chunk_bytes:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        st = self._chunk
        if not st.buf:
            return
        raw = bytes(st.buf)
        data = bz2.compress(raw) if self._compression == "bz2" else raw
        pos = self._f.tell()
        self._f.write(
            _record(
                {
                    b"op": bytes([OP_CHUNK]),
                    b"compression": self._compression.encode(),
                    b"size": struct.pack("<I", len(raw)),
                },
                data,
            )
        )
        # IndexData records (op=0x04) follow each chunk, one per connection.
        for conn_id, entries in sorted(st.index.items()):
            blob = b"".join(
                struct.pack("<II", *_time(t)) + struct.pack("<I", off)
                for t, off in entries
            )
            self._f.write(
                _record(
                    {
                        b"op": bytes([OP_INDEX_DATA]),
                        b"ver": struct.pack("<I", 1),
                        b"conn": struct.pack("<I", conn_id),
                        b"count": struct.pack("<I", len(entries)),
                    },
                    blob,
                )
            )
        self._chunk_infos.append((pos, st))
        self._chunk = _ChunkState()
        # New chunks must re-declare connections for sequential readers
        # that only remember per-chunk state; harmless for ours (it keeps
        # a global map) and matches real recorders re-emitting them in
        # the index section.

    def close(self) -> None:
        if self._closed:
            return
        self._flush_chunk()
        index_pos = self._f.tell()
        # Index section: connection records then ChunkInfo records.
        for rec in self._conn_records:
            self._f.write(rec)
        for pos, st in self._chunk_infos:
            blob = b"".join(
                struct.pack("<II", conn_id, n)
                for conn_id, n in sorted(st.conn_counts.items())
            )
            self._f.write(
                _record(
                    {
                        b"op": bytes([OP_CHUNK_INFO]),
                        b"ver": struct.pack("<I", 1),
                        b"chunk_pos": struct.pack("<Q", pos),
                        b"start_time": struct.pack(
                            "<II", *_time(st.start or 0.0)
                        ),
                        b"end_time": struct.pack("<II", *_time(st.end or 0.0)),
                        b"count": struct.pack("<I", len(st.conn_counts)),
                    },
                    blob,
                )
            )
        # Patch the bag header with the real index_pos/counts.
        self._f.seek(self._header_pos)
        self._f.write(
            self._bag_header_record(
                index_pos, len(self._connections), len(self._chunk_infos)
            )
        )
        self._f.close()
        self._closed = True

    def __enter__(self) -> "BagWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Ouster-style PointCloud2 payloads
# ---------------------------------------------------------------------------

# Real ouster_ros driver layout: 48-byte stride, xyz f32 @0, intensity
# f32 @16, t u32(ns) @20, reflectivity u16 @24, ring u8 @26, ambient
# u16 @28 (older) / range u32 @28. The converter must skip the extras.
OUSTER_FIELDS = [
    ("x", 0, FLOAT32), ("y", 4, FLOAT32), ("z", 8, FLOAT32),
    ("intensity", 16, FLOAT32), ("t", 20, UINT32),
    ("reflectivity", 24, UINT16), ("ring", 26, UINT8), ("range", 28, UINT32),
]
OUSTER_POINT_STEP = 48


def ouster_blob(
    xyz: np.ndarray,
    t_ns: np.ndarray,
    intensity: Optional[np.ndarray] = None,
    ring: Optional[np.ndarray] = None,
    rng_mm: Optional[np.ndarray] = None,
) -> bytes:
    """Pack (N,3) xyz + per-point ns times into the 48-byte Ouster
    stride. Points with non-finite xyz are zeroed (dropped returns are
    zero rows in real driver output)."""
    n = xyz.shape[0]
    blob = np.zeros((n, OUSTER_POINT_STEP), np.uint8)
    xyz32 = np.nan_to_num(xyz.astype(np.float32), nan=0.0, posinf=0.0, neginf=0.0)
    blob[:, 0:12] = xyz32.view(np.uint8).reshape(n, 12)
    inten = (
        intensity.astype(np.float32)
        if intensity is not None
        else np.full(n, 100.0, np.float32)
    )
    blob[:, 16:20] = inten.view(np.uint8).reshape(n, 4)
    blob[:, 20:24] = t_ns.astype(np.uint32).view(np.uint8).reshape(n, 4)
    if ring is not None:
        blob[:, 26:27] = ring.astype(np.uint8).reshape(n, 1)
    if rng_mm is not None:
        blob[:, 28:32] = rng_mm.astype(np.uint32).view(np.uint8).reshape(n, 4)
    return blob.tobytes()

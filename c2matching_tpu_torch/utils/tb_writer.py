"""Scalar tensorboard event files without tensorboard.

The counterpart of the JAX package's ``init_tb_logger`` (tensorboardX's
``SummaryWriter``) for ``use_tb_logger: true``, on a host that has
neither tensorboard nor tensorboardX. ``SummaryWriter(log_dir)`` writes
``events.out.tfevents.<seconds>.<host>.<pid>`` under ``log_dir``: TFRecord
framing (the length, its masked CRC32C, the record, its masked CRC32C),
each record an ``Event`` proto encoded by hand. The first event holds
``file_version`` ``brain.Event:2``; ``add_scalar(tag, value, step)``
writes an event with ``wall_time``, ``step`` and a ``Summary`` of one
``Value`` with ``tag`` and ``simple_value`` (float32), which
tensorboard's scalar dashboard reads.
"""
import os
import os.path as osp
import socket
import struct
import time


def _crc32c_table():
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data):
    """CRC-32C (Castagnoli) of ``data``."""
    crc = 0xFFFFFFFF
    for byte in data:
        crc = _CRC_TABLE[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data):
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n):
    out = bytearray()
    n &= (1 << 64) - 1       # int64 fields encode negatives in 10 bytes
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _bytes_field(number, payload):
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def event(wall_time, step=0, file_version=None, tag=None, value=None):
    """An ``Event`` proto: wall_time (1, double), step (2, int64),
    file_version (3, string) or summary (5) of one Value with tag (1) and
    simple_value (2, float)."""
    out = bytes([1 << 3 | 1]) + struct.pack('<d', wall_time)
    if step:
        out += _varint(2 << 3) + _varint(int(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if tag is not None:
        summary_value = (_bytes_field(1, tag.encode())
                         + bytes([2 << 3 | 5]) + struct.pack('<f', value))
        out += _bytes_field(5, _bytes_field(1, summary_value))
    return out


def record(data):
    """One TFRecord: the length and its masked CRC, the data and its."""
    length = struct.pack('<Q', len(data))
    return (length + struct.pack('<I', masked_crc32c(length)) + data
            + struct.pack('<I', masked_crc32c(data)))


class SummaryWriter:
    """Scalar event writer with tensorboardX's ``add_scalar`` / ``flush``
    / ``close``."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = osp.join(
            log_dir, f'events.out.tfevents.{int(now)}.{socket.gethostname()}'
            f'.{os.getpid()}')
        self._file = open(self.path, 'wb')
        self._file.write(record(event(now, file_version='brain.Event:2')))
        self._file.flush()

    def add_scalar(self, tag, value, global_step=0):
        self._file.write(record(event(time.time(), global_step, tag=tag,
                                      value=float(value))))

    def flush(self):
        self._file.flush()

    def close(self):
        if not self._file.closed:
            self._file.close()

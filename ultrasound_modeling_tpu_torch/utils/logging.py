"""Metric logging of the port: ``MetricLogger``, copied from
``ultrasound_modeling_tpu/utils/logging.py`` with the scalar half of its
TensorBoard writer (``utils/tb_writer.py``), stdlib + numpy, so that the
port imports nothing of the JAX package.  The image panels are not copied:
the port's Trainer logs no images yet (ROADMAP Queue 1 item 6, "Out-of-core
data, image panels, profiling").

Scalars append to ``<dir>/scalars.jsonl`` as ``{"step": n, "time": t, ...}``
lines, go to a TensorBoard ``events.out.tfevents.*`` file beside it, and are
echoed to stdout.  The events file is hand-encoded Event protobufs in
TFRecord framing (length + masked CRC32C), the same bytes the original
writes.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Dict, Optional


def _crc_table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC32C (Castagnoli)."""
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    crc ^= 0xFFFFFFFF
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if not n:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint((number << 3) | wire) + payload


def _bytes_field(number: int, v: bytes) -> bytes:
    return _field(number, 2, _varint(len(v)) + v)


def _event(wall_time: float, rest: bytes) -> bytes:
    """Event {1: wall_time (double), ...}."""
    return _field(1, 1, struct.pack("<d", wall_time)) + rest


class EventWriter:
    """Append-only TensorBoard events file of scalars: Event {2: step,
    5: Summary {1: Value {1: tag, 2: simple_value (float)}}}."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}")
        self._fh = open(os.path.join(log_dir, fname), "ab")
        # Event.file_version is field 3
        self._write_record(_event(time.time(),
                                  _bytes_field(3, b"brain.Event:2")))

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._fh.write(header + struct.pack("<I", _masked_crc(header))
                       + payload + struct.pack("<I", _masked_crc(payload)))
        self._fh.flush()

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        for tag, v in values.items():
            value = (_bytes_field(1, tag.encode())
                     + _field(2, 5, struct.pack("<f", float(v))))
            self._write_record(_event(
                time.time(), _field(2, 0, _varint(step))
                + _bytes_field(5, _bytes_field(1, value))))

    def close(self) -> None:
        self._fh.close()


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, echo: bool = True,
                 tensorboard: bool = True):
        self.log_dir = log_dir
        self.echo = echo
        self._fh = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, "scalars.jsonl"), "a")
            if tensorboard:
                self._tb = EventWriter(log_dir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            # metric values only: the step/time keys would become junk
            # TensorBoard series
            self._tb.scalars(int(step),
                             {k: float(v) for k, v in values.items()})
        if self.echo:
            body = ", ".join(f"{k}={v:.5g}" for k, v in values.items())
            print(f"[step {step}] {body}")

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None

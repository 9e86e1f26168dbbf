"""Pure-Python TFRecord + tf.Example reader/writer.

Port of ddsp_tpu/data/tfrecord.py. Parses the TFRecord container format
(length-delimited records with CRC32C masks) and the tf.Example protobuf
wire format directly, so the training path has zero TensorFlow dependency
while remaining byte-compatible with datasets produced for the reference
(reference data.py:205-270, data_preparation/prepare_tfrecord_lib.py). A
file written here is byte-identical to the JAX package's for the same
examples.

Only the feature types the DDSP schema uses are supported: float_list,
int64_list, bytes_list.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; used for optional integrity checks and
# required when writing.
# ---------------------------------------------------------------------------
_CRC_TABLE = None


def _crc_table():
  global _CRC_TABLE
  if _CRC_TABLE is None:
    poly = 0x82F63B78
    table = []
    for n in range(256):
      crc = n
      for _ in range(8):
        crc = (crc >> 1) ^ (poly if crc & 1 else 0)
      table.append(crc)
    _CRC_TABLE = table
  return _CRC_TABLE


def crc32c(data: bytes) -> int:
  table = _crc_table()
  crc = 0xFFFFFFFF
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
  # Native C codec when available (ddsp_torch/native); pure Python fallback.
  from ddsp_torch import native  # pylint: disable=g-import-not-at-top
  masked = native.masked_crc(data)
  if masked is not None:
    return masked
  crc = crc32c(data)
  return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# TFRecord container
# ---------------------------------------------------------------------------
def read_records(path: str, verify_crc: bool = False) -> Iterator[bytes]:
  """Yield raw record payloads from a TFRecord file."""
  use_native = False
  if verify_crc:
    from ddsp_torch import native  # pylint: disable=g-import-not-at-top
    use_native = native.load_codec() is not None
  with open(path, 'rb') as f:
    while True:
      header = f.read(12)
      if len(header) < 12:
        return
      length, length_crc = struct.unpack('<QI', header)
      data = f.read(length)
      tail = f.read(4)
      if len(data) < length or len(tail) < 4:
        raise IOError(f'Truncated TFRecord in {path} (record of {length} '
                      f'bytes cut short)')
      if verify_crc:
        if use_native:
          # One native call checks both masked CRCs. Map each error code
          # to its own message (-1 is unreachable here because the
          # len(data)/len(tail) pre-check above already raised, but keep
          # the mapping honest for future callers).
          rc = native.check_record(header + data + tail)
          if rc == -1:
            raise IOError(f'Truncated TFRecord in {path} (record of '
                          f'{length} bytes cut short)')
          if rc == -2:
            raise IOError(f'Corrupt TFRecord length CRC in {path}')
          if rc is not None and rc < 0:
            raise IOError(f'Corrupt TFRecord data CRC in {path}')
          if rc is not None:
            yield data
            continue
        if _masked_crc(header[:8]) != length_crc:
          raise IOError(f'Corrupt TFRecord length CRC in {path}')
        data_crc = struct.unpack('<I', tail)[0]
        if _masked_crc(data) != data_crc:
          raise IOError(f'Corrupt TFRecord data CRC in {path}')
      yield data


def write_records(path: str, records: List[bytes]):
  """Write raw payloads as a TFRecord file."""
  from ddsp_torch import native  # pylint: disable=g-import-not-at-top
  use_native = native.load_codec() is not None
  with open(path, 'wb') as f:
    for data in records:
      if use_native:
        f.write(native.frame_record(data))
        continue
      header = struct.pack('<Q', len(data))
      f.write(header)
      f.write(struct.pack('<I', _masked_crc(header)))
      f.write(data)
      f.write(struct.pack('<I', _masked_crc(data)))


# ---------------------------------------------------------------------------
# Protobuf wire format (just what tf.Example needs)
# ---------------------------------------------------------------------------
def _read_varint(buf: bytes, pos: int):
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _write_varint(value: int) -> bytes:
  """Encode an unsigned (or two's-complement int64) protobuf varint."""
  if value < 0:
    # Protobuf encodes negative int64 as 10-byte two's complement.
    value &= 0xFFFFFFFFFFFFFFFF
  out = bytearray()
  while True:
    bits = value & 0x7F
    value >>= 7
    if value:
      out.append(bits | 0x80)
    else:
      out.append(bits)
      return bytes(out)


def _iter_fields(buf: bytes):
  """Yield (field_number, wire_type, value_bytes_or_int) over a message."""
  pos = 0
  n = len(buf)
  while pos < n:
    tag, pos = _read_varint(buf, pos)
    field, wire = tag >> 3, tag & 7
    if wire == 0:  # varint
      value, pos = _read_varint(buf, pos)
    elif wire == 2:  # length-delimited
      length, pos = _read_varint(buf, pos)
      value = buf[pos:pos + length]
      pos += length
    elif wire == 5:  # 32-bit
      value = buf[pos:pos + 4]
      pos += 4
    elif wire == 1:  # 64-bit
      value = buf[pos:pos + 8]
      pos += 8
    else:
      raise ValueError(f'Unsupported wire type {wire}')
    yield field, wire, value


def _parse_float_list(buf: bytes) -> np.ndarray:
  """FloatList: field 1, packed or repeated float."""
  values = []
  for field, wire, value in _iter_fields(buf):
    if field == 1:
      if wire == 2:  # packed
        values.append(np.frombuffer(value, dtype='<f4'))
      elif wire == 5:
        values.append(np.frombuffer(value, dtype='<f4'))
  if not values:
    return np.zeros((0,), np.float32)
  return np.concatenate([np.atleast_1d(v) for v in values])


def _decode_int64(value: int) -> int:
  """Two's-complement decode of a varint-read unsigned value."""
  return value - (1 << 64) if value >= (1 << 63) else value


def _parse_int64_list(buf: bytes) -> np.ndarray:
  values = []
  pos = 0
  for field, wire, value in _iter_fields(buf):
    if field == 1:
      if wire == 0:
        values.append(_decode_int64(value))
      elif wire == 2:  # packed varints
        p = 0
        while p < len(value):
          v, p = _read_varint(value, p)
          values.append(_decode_int64(v))
  return np.asarray(values, np.int64)


def _parse_bytes_list(buf: bytes) -> List[bytes]:
  return [value for field, wire, value in _iter_fields(buf) if field == 1]


def parse_example(record: bytes) -> Dict[str, Any]:
  """Parse a serialized tf.Example into {name: np.ndarray or list[bytes]}.

  Example: {features: Features{feature: map<string, Feature>}}
  Features: field 1 = repeated map entry (key=1 string, value=2 Feature)
  Feature: oneof bytes_list=1 / float_list=2 / int64_list=3
  """
  features: Dict[str, Any] = {}
  for field, _, value in _iter_fields(record):
    if field != 1:  # Example.features
      continue
    for f2, _, entry in _iter_fields(value):
      if f2 != 1:  # Features.feature map entry
        continue
      key = None
      feature_buf = None
      for f3, _, v3 in _iter_fields(entry):
        if f3 == 1:
          key = v3.decode('utf-8')
        elif f3 == 2:
          feature_buf = v3
      if key is None or feature_buf is None:
        continue
      for f4, _, v4 in _iter_fields(feature_buf):
        if f4 == 1:
          features[key] = _parse_bytes_list(v4)
        elif f4 == 2:
          features[key] = _parse_float_list(v4)
        elif f4 == 3:
          features[key] = _parse_int64_list(v4)
  return features


def read_examples(path: str) -> Iterator[Dict[str, Any]]:
  """Yield parsed tf.Examples from a TFRecord file."""
  for record in read_records(path):
    yield parse_example(record)


# ---------------------------------------------------------------------------
# Writing (for dataset preparation and tests)
# ---------------------------------------------------------------------------
def _tag(field: int, wire: int) -> bytes:
  return _write_varint((field << 3) | wire)


def _length_delimited(field: int, payload: bytes) -> bytes:
  return _tag(field, 2) + _write_varint(len(payload)) + payload


def serialize_example(features: Dict[str, Any]) -> bytes:
  """Serialize {name: float array | int array | list[bytes]} to tf.Example."""
  parts = []
  for key, value in features.items():
    if isinstance(value, (list, tuple)) and value and isinstance(
        value[0], (bytes, str)):
      items = b''.join(
          _length_delimited(1, v.encode() if isinstance(v, str) else v)
          for v in value)
      feature = _length_delimited(1, items)
    else:
      arr = np.asarray(value)
      if np.issubdtype(arr.dtype, np.integer):
        payload = b''.join(_write_varint(int(v)) for v in arr.ravel())
        feature = _length_delimited(3, _length_delimited(1, payload))
      else:
        payload = arr.ravel().astype('<f4').tobytes()
        feature = _length_delimited(2, _length_delimited(1, payload))
    entry = _length_delimited(1, key.encode('utf-8')) + _length_delimited(
        2, feature)
    parts.append(_length_delimited(1, entry))
  return _length_delimited(1, b''.join(parts))


def write_examples(path: str, examples: List[Dict[str, Any]]):
  """Write feature dicts as a TFRecord of tf.Examples."""
  write_records(path, [serialize_example(e) for e in examples])

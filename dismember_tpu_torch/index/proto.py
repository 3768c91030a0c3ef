"""Minimal proto3 wire-format codec for the reference's persistence schemas.

Copy of ``dismember_tpu/index/proto.py`` for the tree and mapping files, byte-compatible
with the reference's scalapb-generated encodings of:
- tdm/src/main/protobuf/tree.proto      (IdCodePair, IdCodePart, TreeMeta, Node)
- tdm/src/main/protobuf/store_kv.proto  (KVItem)
- deep-retrieval's item_mapping.proto    (Path, Item, ItemSet)

Hand-rolled (no protoc build step): the schemas are tiny and stable.  Proto3
rules honored: default-valued scalar fields are omitted on encode; repeated
scalars are packed; unknown fields are skipped on decode.
"""

from __future__ import annotations

import dataclasses
import struct


# -------------------------- wire primitives --------------------------------


def _write_varint(buf: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's complement, 10 bytes
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    return result, pos


def _write_tag(buf: bytearray, field: int, wtype: int) -> None:
    _write_varint(buf, (field << 3) | wtype)


def _write_len_delim(buf: bytearray, field: int, payload: bytes) -> None:
    _write_tag(buf, field, 2)
    _write_varint(buf, len(payload))
    buf.extend(payload)


def _write_float(buf: bytearray, field: int, value: float) -> None:
    _write_tag(buf, field, 5)
    buf.extend(struct.pack("<f", value))


def _skip_field(data: bytes, pos: int, wtype: int) -> int:
    if wtype == 0:
        _, pos = _read_varint(data, pos)
    elif wtype == 1:
        pos += 8
    elif wtype == 2:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wtype == 5:
        pos += 4
    else:
        raise ValueError(f"unsupported wire type {wtype}")
    return pos


def _iter_fields(data: bytes):
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wtype = tag >> 3, tag & 7
        if wtype == 0:
            value, pos = _read_varint(data, pos)
        elif wtype == 1:
            value = data[pos : pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(data, pos)
            value = data[pos : pos + ln]
            pos += ln
        elif wtype == 5:
            value = data[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield field, wtype, value


def _signed32(v: int) -> int:
    v &= (1 << 64) - 1
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


# ------------------------------ messages -----------------------------------


@dataclasses.dataclass
class Node:
    """tree.proto ``Node`` (note the reference's ``probality`` spelling)."""

    id: int = 0
    probality: float = 0.0
    leaf_cate_id: int = 0
    is_leaf: bool = False
    embed_vec: list[float] = dataclasses.field(default_factory=list)
    data: bytes = b""

    def encode(self) -> bytes:
        buf = bytearray()
        if self.id:
            _write_tag(buf, 1, 0)
            _write_varint(buf, self.id & 0xFFFFFFFF if self.id < 0 else self.id)
        if self.probality != 0.0:
            _write_float(buf, 2, self.probality)
        if self.leaf_cate_id:
            _write_tag(buf, 3, 0)
            _write_varint(buf, self.leaf_cate_id)
        if self.is_leaf:
            _write_tag(buf, 4, 0)
            _write_varint(buf, 1)
        if self.embed_vec:
            payload = struct.pack(f"<{len(self.embed_vec)}f", *self.embed_vec)
            _write_len_delim(buf, 5, payload)
        if self.data:
            _write_len_delim(buf, 6, self.data)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Node":
        out = cls()
        for field, wtype, value in _iter_fields(data):
            if field == 1 and wtype == 0:
                out.id = _signed32(value)
            elif field == 2 and wtype == 5:
                out.probality = struct.unpack("<f", value)[0]
            elif field == 3 and wtype == 0:
                out.leaf_cate_id = _signed32(value)
            elif field == 4 and wtype == 0:
                out.is_leaf = bool(value)
            elif field == 5 and wtype == 2:
                n = len(value) // 4
                out.embed_vec = list(struct.unpack(f"<{n}f", value))
            elif field == 5 and wtype == 5:
                out.embed_vec.append(struct.unpack("<f", value)[0])
            elif field == 6 and wtype == 2:
                out.data = value
        return out


@dataclasses.dataclass
class KVItem:
    key: bytes = b""
    value: bytes = b""

    def encode(self) -> bytes:
        buf = bytearray()
        if self.key:
            _write_len_delim(buf, 1, self.key)
        if self.value:
            _write_len_delim(buf, 2, self.value)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "KVItem":
        out = cls()
        for field, wtype, value in _iter_fields(data):
            if field == 1 and wtype == 2:
                out.key = value
            elif field == 2 and wtype == 2:
                out.value = value
        return out


@dataclasses.dataclass
class IdCodePair:
    id: int = 0
    code: int = 0

    def encode(self) -> bytes:
        buf = bytearray()
        if self.id:
            _write_tag(buf, 1, 0)
            _write_varint(buf, self.id)
        if self.code:
            _write_tag(buf, 2, 0)
            _write_varint(buf, self.code)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "IdCodePair":
        out = cls()
        for field, wtype, value in _iter_fields(data):
            if field == 1 and wtype == 0:
                out.id = _signed32(value)
            elif field == 2 and wtype == 0:
                out.code = _signed32(value)
        return out


@dataclasses.dataclass
class IdCodePart:
    part_id: bytes = b""
    id_code_list: list[IdCodePair] = dataclasses.field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        if self.part_id:
            _write_len_delim(buf, 1, self.part_id)
        for pair in self.id_code_list:
            _write_len_delim(buf, 2, pair.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "IdCodePart":
        out = cls()
        for field, wtype, value in _iter_fields(data):
            if field == 1 and wtype == 2:
                out.part_id = value
            elif field == 2 and wtype == 2:
                out.id_code_list.append(IdCodePair.decode(value))
        return out


@dataclasses.dataclass
class TreeMeta:
    max_level: int = 0
    id_code_part: list[bytes] = dataclasses.field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        if self.max_level:
            _write_tag(buf, 1, 0)
            _write_varint(buf, self.max_level)
        for part in self.id_code_part:
            _write_len_delim(buf, 2, part)
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "TreeMeta":
        out = cls()
        for field, wtype, value in _iter_fields(data):
            if field == 1 and wtype == 0:
                out.max_level = _signed32(value)
            elif field == 2 and wtype == 2:
                out.id_code_part.append(value)
        return out


# item_mapping.proto ---------------------------------------------------------


@dataclasses.dataclass
class Path:
    index: list[int] = dataclasses.field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        if self.index:
            payload = bytearray()
            for v in self.index:
                _write_varint(payload, v)
            _write_len_delim(buf, 1, bytes(payload))
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Path":
        out = cls()
        for field, wtype, value in _iter_fields(data):
            if field == 1 and wtype == 2:
                pos = 0
                while pos < len(value):
                    v, pos = _read_varint(value, pos)
                    out.index.append(_signed32(v))
            elif field == 1 and wtype == 0:
                out.index.append(_signed32(value))
        return out


@dataclasses.dataclass
class Item:
    item: int = 0
    id: int = 0
    paths: list[Path] = dataclasses.field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        if self.item:
            _write_tag(buf, 1, 0)
            _write_varint(buf, self.item)
        if self.id:
            _write_tag(buf, 2, 0)
            _write_varint(buf, self.id)
        for p in self.paths:
            _write_len_delim(buf, 3, p.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "Item":
        out = cls()
        for field, wtype, value in _iter_fields(data):
            if field == 1 and wtype == 0:
                out.item = _signed32(value)
            elif field == 2 and wtype == 0:
                out.id = _signed32(value)
            elif field == 3 and wtype == 2:
                out.paths.append(Path.decode(value))
        return out


@dataclasses.dataclass
class ItemSet:
    items: list[Item] = dataclasses.field(default_factory=list)

    def encode(self) -> bytes:
        buf = bytearray()
        for it in self.items:
            _write_len_delim(buf, 1, it.encode())
        return bytes(buf)

    @classmethod
    def decode(cls, data: bytes) -> "ItemSet":
        out = cls()
        for field, wtype, value in _iter_fields(data):
            if field == 1 and wtype == 2:
                out.items.append(Item.decode(value))
        return out

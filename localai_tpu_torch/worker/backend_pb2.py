"""The messages of the worker contract, with protobuf's bytes on the wire.

Port of ``localai_tpu/worker/backend_pb2.py`` (``protoc --python_out`` of
``localai_tpu/worker/backend.proto``) on the standard library: the card's
machine has no ``google.protobuf``. Each of the 34 messages is a dataclass
with the proto's field names and defaults; ``SCHEMA`` holds its field
numbers and types. ``SerializeToString()`` writes proto3's wire format,
byte for byte what protobuf writes with ``deterministic=True``:

  * int32, int64, uint32, uint64, bool and enums as plain varints (a
    negative int32 or enum, such as ``StatusResponse.ERROR``, as a
    10-byte varint); float as 4 little-endian bytes, double as 8;
  * repeated scalars packed; strings, bytes, sub-messages and each
    repeated element of those length-delimited;
  * a field that holds its default is omitted, unless it is a proto3
    ``optional`` field that is set (``None`` is unset): the sampling
    fields of ``PredictOptions``, ``SoundGenerationRequest.duration`` /
    ``temperature`` and ``GenerateImageRequest.cfg_scale``. A float is
    omitted when its float32 bits are all zero (``-0.0`` is written);
  * each map entry is a sub-message holding its key (1) and value (2),
    both always written, in the order protobuf's upb runtime writes under
    ``deterministic=True``: int32 keys by descending unsigned value,
    string keys by ascending bytes with a longer key before its own
    prefix.

``FromString()`` skips unknown fields, takes packed and unpacked repeated
scalars alike, keeps the last of a repeated singular scalar, merges a
repeated singular sub-message and raises :class:`DecodeError` on
malformed input.
"""

from __future__ import annotations

import dataclasses
import functools
import struct
from typing import Any, ClassVar

# (name, number, type[, "repeated" | "optional" | "map:<key>:<value>"]);
# a message-typed field names its message as its type
SCHEMA: dict[str, tuple] = {
    "HealthMessage": (),
    "Reply": (("message", 1, "bytes"), ("tokens", 2, "int32"),
              ("prompt_tokens", 3, "int32"), ("finish_reason", 4, "string"),
              ("timing_prompt_processing", 5, "double"),
              ("timing_token_generation", 6, "double")),
    "Result": (("message", 1, "string"), ("success", 2, "bool")),
    "ModelOptions": (("model", 1, "string"), ("config_yaml", 2, "string"),
                     ("model_path", 3, "string"),
                     ("context_size", 4, "int32"), ("seed", 5, "int32")),
    "PredictOptions": (
        ("prompt", 1, "string"), ("tokens", 2, "int32", "repeated"),
        ("max_tokens", 3, "int32"),
        ("temperature", 4, "float", "optional"),
        ("top_k", 5, "int32", "optional"),
        ("top_p", 6, "float", "optional"),
        ("min_p", 7, "float", "optional"),
        ("repeat_penalty", 8, "float", "optional"),
        ("presence_penalty", 9, "float", "optional"),
        ("frequency_penalty", 10, "float", "optional"),
        ("seed", 11, "int32", "optional"),
        ("stop", 12, "string", "repeated"), ("ignore_eos", 13, "bool"),
        ("logit_bias", 14, "LogitBiasEntry", "map:int32:float"),
        ("constraint_schema", 15, "string"),
        ("constraint_regex", 16, "string"),
        ("correlation_id", 17, "string"), ("add_bos", 18, "bool"),
        ("stream", 19, "bool")),
    "PrefixChunk": (("transfer_id", 1, "string"), ("seq", 2, "int32"),
                    ("data", 3, "bytes"), ("last", 4, "bool"),
                    ("tokens", 5, "int32", "repeated"),
                    ("n_tokens", 6, "int32")),
    "TelemetryRequest": (("trace_id", 1, "string"), ("since", 2, "double"),
                         ("limit", 3, "int32"), ("recent", 4, "int32")),
    "TelemetryResponse": (("json", 1, "string"),),
    "EmbeddingRequest": (("text", 1, "string"),
                         ("tokens", 2, "int32", "repeated")),
    "EmbeddingResult": (("embeddings", 1, "float", "repeated"),),
    "TokenizationRequest": (("text", 1, "string"), ("add_bos", 2, "bool")),
    "TokenizationResponse": (("length", 1, "int32"),
                             ("tokens", 2, "int32", "repeated")),
    "StatusResponse": (("state", 1, "enum"),
                       ("memory", 2, "MemoryEntry", "map:string:uint64")),
    "MetricsRequest": (),
    "MetricsResponse": (("json", 1, "string"),),
    "TTSRequest": (("text", 1, "string"), ("model", 2, "string"),
                   ("voice", 3, "string"), ("language", 4, "string"),
                   ("dst", 5, "string")),
    "SoundGenerationRequest": (
        ("text", 1, "string"), ("model", 2, "string"),
        ("duration", 3, "float", "optional"),
        ("temperature", 4, "float", "optional"), ("dst", 5, "string")),
    "AudioResult": (("success", 1, "bool"), ("audio", 2, "bytes"),
                    ("message", 3, "string")),
    "TranscriptRequest": (("path", 1, "string"), ("audio", 2, "bytes"),
                          ("language", 3, "string"),
                          ("translate", 4, "bool"),
                          ("threads", 5, "uint32")),
    "TranscriptSegment": (("id", 1, "int32"), ("start", 2, "int64"),
                          ("end", 3, "int64"), ("text", 4, "string"),
                          ("tokens", 5, "int32", "repeated")),
    "TranscriptResult": (("segments", 1, "TranscriptSegment", "repeated"),
                         ("text", 2, "string")),
    "GenerateImageRequest": (
        ("height", 1, "int32"), ("width", 2, "int32"), ("step", 3, "int32"),
        ("seed", 4, "int32"), ("positive_prompt", 5, "string"),
        ("negative_prompt", 6, "string"), ("dst", 7, "string"),
        ("cfg_scale", 8, "float", "optional")),
    "ImageResult": (("success", 1, "bool"), ("image", 2, "bytes"),
                    ("message", 3, "string")),
    "RerankRequest": (("query", 1, "string"),
                      ("documents", 2, "string", "repeated"),
                      ("top_n", 3, "int32")),
    "RerankScore": (("index", 1, "int32"), ("relevance_score", 2, "float"),
                    ("text", 3, "string")),
    "RerankResult": (("results", 1, "RerankScore", "repeated"),),
    "StoresKey": (("floats", 1, "float", "repeated"),),
    "StoresValue": (("bytes", 1, "bytes"),),
    "StoresSetOptions": (("keys", 1, "StoresKey", "repeated"),
                         ("values", 2, "StoresValue", "repeated")),
    "StoresDeleteOptions": (("keys", 1, "StoresKey", "repeated"),),
    "StoresGetOptions": (("keys", 1, "StoresKey", "repeated"),),
    "StoresGetResult": (("keys", 1, "StoresKey", "repeated"),
                        ("values", 2, "StoresValue", "repeated")),
    "StoresFindOptions": (("key", 1, "StoresKey"), ("top_k", 2, "int32")),
    "StoresFindResult": (("keys", 1, "StoresKey", "repeated"),
                         ("values", 2, "StoresValue", "repeated"),
                         ("similarities", 3, "float", "repeated")),
}

# the two map fields' entry messages, nested as protobuf nests them
# (``PredictOptions.LogitBiasEntry``); a map field writes every entry's
# key and value, the entry message alone omits defaults as any message
MAP_ENTRIES: dict[str, tuple] = {
    "PredictOptions.LogitBiasEntry": (("key", 1, "int32"),
                                      ("value", 2, "float")),
    "StatusResponse.MemoryEntry": (("key", 1, "string"),
                                   ("value", 2, "uint64")),
}

_VARINT = {"int32", "int64", "uint32", "uint64", "bool", "enum"}
_RANGE = {"int32": (-(1 << 31), 1 << 31), "enum": (-(1 << 31), 1 << 31),
          "int64": (-(1 << 63), 1 << 63), "uint32": (0, 1 << 32),
          "uint64": (0, 1 << 64)}
_DEFAULT = {"bytes": b"", "string": "", "bool": False, "float": 0.0,
            "double": 0.0}
_MASK64 = (1 << 64) - 1


class DecodeError(ValueError):
    """Bytes that are not a message of the expected type."""


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    number: int
    type: str               # a scalar type, or the message's name
    label: str = ""         # "", "repeated", "optional" or "map"
    key: str = ""           # map fields: key and value types
    value: str = ""

    @property
    def is_message(self) -> bool:
        return self.type in SCHEMA

    @property
    def packed(self) -> bool:
        return self.label == "repeated" and self.type in _VARINT | {
            "float", "double"}


def _field(spec: tuple) -> Field:
    name, number, typ, *label = spec
    label = label[0] if label else ""
    if label.startswith("map:"):
        _, key, value = label.split(":")
        return Field(name, number, typ, "map", key, value)
    return Field(name, number, typ, label)


# -- encoding ------------------------------------------------------------


def _varint(v: int) -> bytes:
    v &= _MASK64
    out = bytearray()
    while v > 0x7F:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _f32(x: float) -> bytes:
    try:
        return struct.pack("<f", x)
    except OverflowError:   # beyond float32: protobuf stores +-inf
        return struct.pack("<f", float("inf") if x > 0 else float("-inf"))


def _scalar(typ: str, v: Any) -> bytes:
    """One value's bytes, without its tag."""
    if typ in _RANGE:
        lo, hi = _RANGE[typ]
        v = int(v)
        if not lo <= v < hi:
            raise ValueError(f"value {v} out of range for {typ}")
        return _varint(v)
    if typ == "bool":
        return b"\x01" if v else b"\x00"
    if typ == "float":
        return _f32(float(v))
    if typ == "double":
        return struct.pack("<d", float(v))
    if typ == "string":
        data = v.encode("utf-8")
        return _varint(len(data)) + data
    if typ == "bytes":
        data = bytes(v)
        return _varint(len(data)) + data
    raise TypeError(f"unknown scalar type {typ}")


def _wire_type(typ: str) -> int:
    if typ in _VARINT:
        return 0
    return {"double": 1, "float": 5}.get(typ, 2)


def _tag(number: int, wire_type: int) -> bytes:
    return _varint(number << 3 | wire_type)


def _is_default(typ: str, v: Any) -> bool:
    if typ == "float":
        return _f32(float(v)) == b"\x00\x00\x00\x00"
    if typ == "double":
        return struct.pack("<d", float(v)) == b"\x00" * 8
    if typ in _RANGE:
        return int(v) == 0
    return v == _DEFAULT[typ]


def _string_order(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    if a[:n] != b[:n]:
        return -1 if a[:n] < b[:n] else 1
    return len(b) - len(a)          # the longer key first


def _map_items(f: Field, mapping: dict) -> list:
    if f.key == "string":
        keys = sorted(mapping, key=functools.cmp_to_key(
            lambda a, b: _string_order(a.encode("utf-8"),
                                       b.encode("utf-8"))))
    else:
        keys = sorted(mapping, key=lambda k: -(int(k) & 0xFFFFFFFF))
    return [(k, mapping[k]) for k in keys]


def _encode(msg: "Message") -> bytes:
    out = []
    for f in msg.FIELDS:
        v = getattr(msg, f.name)
        if f.label == "map":
            for k, val in _map_items(f, v):
                entry = (_tag(1, _wire_type(f.key)) + _scalar(f.key, k)
                         + _tag(2, _wire_type(f.value))
                         + _scalar(f.value, val))
                out.append(_tag(f.number, 2) + _varint(len(entry)) + entry)
        elif f.label == "repeated":
            if not v:
                continue
            if f.packed:
                payload = b"".join(_scalar(f.type, x) for x in v)
                out.append(_tag(f.number, 2) + _varint(len(payload))
                           + payload)
            elif f.is_message:
                for x in v:
                    sub = x.SerializeToString()
                    out.append(_tag(f.number, 2) + _varint(len(sub)) + sub)
            else:
                for x in v:
                    out.append(_tag(f.number, 2) + _scalar(f.type, x))
        elif f.is_message:
            if v is not None:
                sub = v.SerializeToString()
                out.append(_tag(f.number, 2) + _varint(len(sub)) + sub)
        elif v is None:
            if f.label != "optional":
                raise ValueError(f"{type(msg).__name__}.{f.name} is None")
        elif f.label == "optional" or not _is_default(f.type, v):
            out.append(_tag(f.number, _wire_type(f.type))
                       + _scalar(f.type, v))
    return b"".join(out)


# -- decoding ------------------------------------------------------------


def _read_varint(data, i: int) -> tuple[int, int]:
    shift = v = 0
    while True:
        if i >= len(data) or shift > 63:
            raise DecodeError("truncated or overlong varint")
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v & _MASK64, i
        shift += 7


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _from_varint(typ: str, v: int) -> Any:
    if typ in ("int32", "enum"):
        return _signed(v, 32)
    if typ == "int64":
        return _signed(v, 64)
    if typ == "uint32":
        return v & 0xFFFFFFFF
    if typ == "bool":
        return v != 0
    return v                         # uint64


def _read_value(typ: str, wire_type: int, data, i: int) -> tuple[Any, int]:
    """One scalar of ``typ`` sent with ``wire_type``."""
    if wire_type != _wire_type(typ):
        raise DecodeError(f"wire type {wire_type} for a {typ} field")
    if wire_type == 0:
        v, i = _read_varint(data, i)
        return _from_varint(typ, v), i
    if wire_type == 5:
        if i + 4 > len(data):
            raise DecodeError("truncated float")
        return struct.unpack_from("<f", data, i)[0], i + 4
    if wire_type == 1:
        if i + 8 > len(data):
            raise DecodeError("truncated double")
        return struct.unpack_from("<d", data, i)[0], i + 8
    raw, i = _read_delimited(data, i)
    if typ == "string":
        try:
            return raw.decode("utf-8"), i
        except UnicodeDecodeError as e:
            raise DecodeError(f"invalid UTF-8 in a string field: {e}") \
                from None
    return raw, i


def _read_delimited(data, i: int) -> tuple[bytes, int]:
    n, i = _read_varint(data, i)
    if i + n > len(data):
        raise DecodeError("truncated length-delimited field")
    return bytes(data[i:i + n]), i + n


def _skip(wire_type: int, data, i: int) -> int:
    if wire_type == 0:
        return _read_varint(data, i)[1]
    if wire_type == 1:
        i += 8
    elif wire_type == 5:
        i += 4
    elif wire_type == 2:
        return _read_delimited(data, i)[1]
    else:
        raise DecodeError(f"unsupported wire type {wire_type}")
    if i > len(data):
        raise DecodeError("truncated field")
    return i


def _decode_entry(f: Field, raw: bytes) -> tuple:
    key, value = _default(f.key), _default(f.value)
    i = 0
    while i < len(raw):
        tag, i = _read_varint(raw, i)
        number, wt = tag >> 3, tag & 7
        if number == 1 and wt == _wire_type(f.key):
            key, i = _read_value(f.key, wt, raw, i)
        elif number == 2 and wt == _wire_type(f.value):
            value, i = _read_value(f.value, wt, raw, i)
        else:
            i = _skip(wt, raw, i)
    return key, value


def _decode(cls: type, data) -> "Message":
    kw: dict = {}
    subs: dict = {}          # singular sub-messages: their merged bytes
    by_number = {f.number: f for f in cls.FIELDS}
    i = 0
    while i < len(data):
        tag, i = _read_varint(data, i)
        number, wt = tag >> 3, tag & 7
        if number == 0:
            raise DecodeError("field number 0")
        f = by_number.get(number)
        if f is None:
            i = _skip(wt, data, i)
        elif f.label == "map":
            if wt != 2:
                raise DecodeError(f"wire type {wt} for map {f.name}")
            raw, i = _read_delimited(data, i)
            k, v = _decode_entry(f, raw)
            kw.setdefault(f.name, {})[k] = v
        elif f.is_message:
            if wt != 2:
                raise DecodeError(f"wire type {wt} for message {f.name}")
            raw, i = _read_delimited(data, i)
            if f.label == "repeated":
                kw.setdefault(f.name, []).append(
                    MESSAGES[f.type].FromString(raw))
            else:
                subs[f.name] = subs.get(f.name, b"") + raw
        elif f.label == "repeated":
            out = kw.setdefault(f.name, [])
            if f.packed and wt == 2:
                raw, i = _read_delimited(data, i)
                j, native = 0, _wire_type(f.type)
                while j < len(raw):
                    v, j = _read_value(f.type, native, raw, j)
                    out.append(v)
            else:
                v, i = _read_value(f.type, wt, data, i)
                out.append(v)
        else:
            kw[f.name], i = _read_value(f.type, wt, data, i)
    for name, raw in subs.items():
        kw[name] = MESSAGES[by_name(cls, name).type].FromString(raw)
    return cls(**kw)


def by_name(cls: type, name: str) -> Field:
    return next(f for f in cls.FIELDS if f.name == name)


def _default(typ: str) -> Any:
    return 0 if typ in _RANGE else _DEFAULT.get(typ)


# -- the message classes --------------------------------------------------


class Message:
    """Base of every message: the proto3 codec over ``FIELDS``."""

    FIELDS: ClassVar[tuple] = ()

    def SerializeToString(self, deterministic: bool = True) -> bytes:  # noqa: N802
        """The message's proto3 bytes (always the deterministic order)."""
        return _encode(self)

    @classmethod
    def FromString(cls, data: bytes) -> "Message":  # noqa: N802
        try:
            return _decode(cls, memoryview(data).cast("B"))
        except (IndexError, struct.error) as e:
            raise DecodeError(f"malformed {cls.__name__}: {e}") from None


def _make(name: str, specs: tuple) -> type:
    fields = tuple(_field(s) for s in specs)
    attrs = []
    for f in fields:
        if f.label == "map":
            attrs.append((f.name, dict, dataclasses.field(
                default_factory=dict)))
        elif f.label == "repeated":
            attrs.append((f.name, list, dataclasses.field(
                default_factory=list)))
        elif f.is_message or f.label == "optional":
            attrs.append((f.name, Any, None))
        else:
            attrs.append((f.name, type(_default(f.type)), _default(f.type)))
    cls = dataclasses.make_dataclass(name, attrs, bases=(Message,),
                                     namespace={"FIELDS": fields,
                                                "__module__": __name__})
    cls.__doc__ = f"``backend.proto``'s ``{name}``."
    return cls


MESSAGES: dict[str, type] = {name: _make(name, specs)
                             for name, specs in SCHEMA.items()}
for _path, _specs in MAP_ENTRIES.items():
    _outer, _entry = _path.split(".")
    setattr(MESSAGES[_outer], _entry, _make(_entry, _specs))

# StatusResponse.State (proto3 enums are open: any int32 decodes)
for _state, _value in (("UNINITIALIZED", 0), ("BUSY", 1), ("READY", 2),
                       ("ERROR", -1)):
    setattr(MESSAGES["StatusResponse"], _state, _value)

HealthMessage = MESSAGES["HealthMessage"]
Reply = MESSAGES["Reply"]
Result = MESSAGES["Result"]
ModelOptions = MESSAGES["ModelOptions"]
PredictOptions = MESSAGES["PredictOptions"]
PrefixChunk = MESSAGES["PrefixChunk"]
TelemetryRequest = MESSAGES["TelemetryRequest"]
TelemetryResponse = MESSAGES["TelemetryResponse"]
EmbeddingRequest = MESSAGES["EmbeddingRequest"]
EmbeddingResult = MESSAGES["EmbeddingResult"]
TokenizationRequest = MESSAGES["TokenizationRequest"]
TokenizationResponse = MESSAGES["TokenizationResponse"]
StatusResponse = MESSAGES["StatusResponse"]
MetricsRequest = MESSAGES["MetricsRequest"]
MetricsResponse = MESSAGES["MetricsResponse"]
TTSRequest = MESSAGES["TTSRequest"]
SoundGenerationRequest = MESSAGES["SoundGenerationRequest"]
AudioResult = MESSAGES["AudioResult"]
TranscriptRequest = MESSAGES["TranscriptRequest"]
TranscriptSegment = MESSAGES["TranscriptSegment"]
TranscriptResult = MESSAGES["TranscriptResult"]
GenerateImageRequest = MESSAGES["GenerateImageRequest"]
ImageResult = MESSAGES["ImageResult"]
RerankRequest = MESSAGES["RerankRequest"]
RerankScore = MESSAGES["RerankScore"]
RerankResult = MESSAGES["RerankResult"]
StoresKey = MESSAGES["StoresKey"]
StoresValue = MESSAGES["StoresValue"]
StoresSetOptions = MESSAGES["StoresSetOptions"]
StoresDeleteOptions = MESSAGES["StoresDeleteOptions"]
StoresGetOptions = MESSAGES["StoresGetOptions"]
StoresGetResult = MESSAGES["StoresGetResult"]
StoresFindOptions = MESSAGES["StoresFindOptions"]
StoresFindResult = MESSAGES["StoresFindResult"]

"""The port's worker messages against protobuf's, byte for byte.

For each of the 34 messages of the worker contract and its two map
entries, hypothesis draws field values (negative int32s, the ``ERROR = -1``
enum, unset and set optional fields, empty repeated fields, +-0.0,
infinities, doubles that round to float32, non-ASCII strings) and holds:

  * the port's ``SerializeToString()`` equal to the JAX package's
    generated ``backend_pb2`` message's ``SerializeToString(
    deterministic=True)``;
  * each side's decoding of the other's bytes to the same fields.

Fixed cases cover packed and unpacked repeated scalars, unknown fields,
repeated singular fields and malformed bytes, and the port's method table
equals the JAX package's by name, kind and types.
"""

import math
import struct

import pytest

pytest.importorskip("torch")
pytest.importorskip("google.protobuf")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from localai_tpu.worker import backend_pb2 as jpb  # noqa: E402
from localai_tpu_torch.worker import backend_pb2 as pb  # noqa: E402
from localai_tpu_torch.worker import rpc  # noqa: E402

# (port class, protobuf class) of every message and map entry
PAIRS = {name: (pb.MESSAGES[name], getattr(jpb, name))
         for name in pb.SCHEMA}
for _path in pb.MAP_ENTRIES:
    _outer, _entry = _path.split(".")
    PAIRS[_path] = (getattr(pb.MESSAGES[_outer], _entry),
                    getattr(getattr(jpb, _outer), _entry))

_INT_RANGE = {"int32": (-(1 << 31), (1 << 31) - 1),
              "int64": (-(1 << 63), (1 << 63) - 1),
              "uint32": (0, (1 << 32) - 1), "uint64": (0, (1 << 64) - 1)}


def _scalar(typ: str):
    if typ in _INT_RANGE:
        lo, hi = _INT_RANGE[typ]
        return st.one_of(st.integers(lo, hi), st.sampled_from(
            [v for v in (0, 1, -1, 127, 128, lo, hi) if lo <= v <= hi]))
    if typ == "enum":
        # the declared states, ERROR = -1 among them, and open values
        return st.one_of(st.sampled_from([0, 1, 2, -1]),
                         st.integers(-(1 << 31), (1 << 31) - 1))
    if typ == "bool":
        return st.booleans()
    if typ == "float":
        # float32 values, +-0, +-inf, and doubles that round (or
        # overflow) to float32
        return st.one_of(st.floats(width=32, allow_nan=False),
                         st.floats(allow_nan=False),
                         st.sampled_from([0.0, -0.0, math.inf, -math.inf,
                                          1e-46, -1e-46, 1e39, 0.1]))
    if typ == "double":
        return st.one_of(st.floats(allow_nan=False),
                         st.sampled_from([0.0, -0.0, math.inf, -math.inf]))
    if typ == "string":
        return st.one_of(st.text(max_size=12),
                         st.sampled_from(["", "é", "日本語", "a\x00b",
                                          "\U0001f600"]))
    if typ == "bytes":
        return st.binary(max_size=16)
    raise AssertionError(typ)


def _message(cls):
    """A strategy of ``cls`` instances (port messages)."""
    fields = {}
    for f in cls.FIELDS:
        if f.label == "map":
            fields[f.name] = st.dictionaries(_scalar(f.key),
                                             _scalar(f.value), max_size=4)
        elif f.is_message:
            sub = _message(pb.MESSAGES[f.type])
            fields[f.name] = (st.lists(sub, max_size=3)
                              if f.label == "repeated"
                              else st.none() | sub)
        elif f.label == "repeated":
            fields[f.name] = st.lists(_scalar(f.type), max_size=5)
        elif f.label == "optional":
            fields[f.name] = st.none() | _scalar(f.type)
        else:
            fields[f.name] = _scalar(f.type)
    return st.builds(cls, **fields)


def _to_protobuf(msg, jcls):
    """The protobuf message with ``msg``'s field values."""
    out = jcls()
    for f in msg.FIELDS:
        v = getattr(msg, f.name)
        if f.label == "map":
            getattr(out, f.name).update(v)
        elif f.is_message:
            jsub = getattr(jpb, f.type)
            if f.label == "repeated":
                getattr(out, f.name).extend(_to_protobuf(x, jsub) for x in v)
            elif v is not None:
                getattr(out, f.name).CopyFrom(_to_protobuf(v, jsub))
        elif f.label == "repeated":
            getattr(out, f.name).extend(v)
        elif v is not None:
            setattr(out, f.name, v)
    return out


def _plain(v):
    """Floats by their bits (so -0.0 and 0.0 differ), lists and dicts
    element by element."""
    if isinstance(v, float):
        return ("f", struct.pack("<d", v))
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, dict):
        return {_plain(k): _plain(x) for k, x in v.items()}
    return v


def _port_fields(msg) -> dict:
    """The port message's fields as nested plain values."""
    out = {}
    for f in msg.FIELDS:
        v = getattr(msg, f.name)
        if f.is_message and f.label == "repeated":
            v = [_port_fields(x) for x in v]
        elif f.is_message and v is not None:
            v = _port_fields(v)
        out[f.name] = v
    return out


def _protobuf_fields(msg) -> dict:
    """The protobuf message's fields alike (None for an unset optional or
    sub-message)."""
    out = {}
    for f in msg.DESCRIPTOR.fields:
        v = getattr(msg, f.name)
        if f.message_type is not None and \
                f.message_type.GetOptions().map_entry:
            v = dict(v)
        elif f.message_type is not None and f.is_repeated:
            v = [_protobuf_fields(x) for x in v]
        elif f.message_type is not None:
            v = _protobuf_fields(v) if msg.HasField(f.name) else None
        elif f.is_repeated:
            v = list(v)
        elif f.has_presence and not msg.HasField(f.name):
            v = None
        out[f.name] = v
    return out


def _float32(v):
    """What protobuf keeps of a float field: the float32 nearest (or +-inf
    beyond float32's range)."""
    try:
        return struct.unpack("<f", struct.pack("<f", v))[0]
    except OverflowError:
        return math.copysign(math.inf, v)


NAMES = sorted(PAIRS)


def test_every_message_and_map_entry_is_covered():
    assert len(pb.SCHEMA) == 34 == len(jpb.DESCRIPTOR.message_types_by_name)
    assert set(pb.SCHEMA) == set(jpb.DESCRIPTOR.message_types_by_name)
    assert len(PAIRS) == 36


@pytest.mark.parametrize("name", NAMES)
def test_fields_are_the_descriptors(name):
    """Names, numbers and order of the proto's fields; proto3 optional
    fields are those the descriptor gives presence."""
    cls, jcls = PAIRS[name]
    jfields = jcls.DESCRIPTOR.fields
    assert [(f.name, f.number) for f in cls.FIELDS] == [
        (f.name, f.number) for f in jfields]
    for f, jf in zip(cls.FIELDS, jfields):
        optional = jf.has_presence and jf.message_type is None
        assert (f.label == "optional") == optional, f.name
        assert (f.label in ("repeated", "map")) == jf.is_repeated, f.name


@pytest.mark.parametrize("name", NAMES)
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_bytes_equal_protobuf(name, data):
    cls, jcls = PAIRS[name]
    msg = data.draw(_message(cls))
    assert msg.SerializeToString() == _to_protobuf(msg, jcls) \
        .SerializeToString(deterministic=True)


@pytest.mark.parametrize("name", NAMES)
@settings(max_examples=40, deadline=None)
@given(data=st.data())
def test_each_side_decodes_the_other(name, data):
    cls, jcls = PAIRS[name]
    msg = data.draw(_message(cls))
    jmsg = _to_protobuf(msg, jcls)
    from_protobuf = cls.FromString(jmsg.SerializeToString(deterministic=True))
    from_port = jcls.FromString(msg.SerializeToString())
    assert _plain(_port_fields(from_protobuf)) \
        == _plain(_protobuf_fields(from_port)) \
        == _plain(_protobuf_fields(jmsg))


def test_known_encodings():
    # a negative int32 and ERROR = -1 are 10-byte varints
    assert pb.Reply(tokens=-1).SerializeToString() == \
        b"\x10" + b"\xff" * 9 + b"\x01"
    assert pb.StatusResponse(state=pb.StatusResponse.ERROR) \
        .SerializeToString() == b"\x08" + b"\xff" * 9 + b"\x01"
    # a set optional field holding its default is written; unset is not
    assert pb.PredictOptions(temperature=0.0).SerializeToString() == \
        b"\x25\x00\x00\x00\x00"
    assert pb.PredictOptions().SerializeToString() == b""
    # -0.0 is written, 0.0 omitted; a double that rounds to float32 zero
    assert pb.RerankScore(relevance_score=-0.0).SerializeToString() == \
        b"\x15\x00\x00\x00\x80"
    assert pb.RerankScore(relevance_score=1e-46).SerializeToString() == b""
    assert pb.RerankScore(relevance_score=1e39).SerializeToString() == \
        b"\x15\x00\x00\x80\x7f"
    # packed repeated scalars
    assert pb.EmbeddingRequest(tokens=[1, 300]).SerializeToString() == \
        b"\x12\x03\x01\xac\x02"
    # an empty sub-message that is set is written
    assert pb.StoresFindOptions(key=pb.StoresKey()).SerializeToString() \
        == b"\x0a\x00"


def test_decoder_takes_unpacked_repeated_and_skips_unknown_fields():
    # tokens (2) unpacked twice and packed once; an unknown varint (99),
    # fixed64 (98), fixed32 (97) and length-delimited (96) field
    data = (b"\x10\x01\x10\x02\x12\x02\x03\x04"
            + b"\x98\x06\x05" + b"\x91\x06" + b"\x00" * 8
            + b"\x8d\x06" + b"\x00" * 4 + b"\x82\x06\x02hi"
            + b"\x0a\x01a")
    got = pb.PredictOptions.FromString(data)
    assert got.tokens == [1, 2, 3, 4] and got.prompt == "a"
    assert list(jpb.PredictOptions.FromString(data).tokens) == [1, 2, 3, 4]


def test_decoder_keeps_the_last_scalar_and_merges_sub_messages():
    # top_k twice (the last wins) and key twice (merged: the repeated
    # floats append)
    k1 = pb.StoresKey(floats=[1.0]).SerializeToString()
    k2 = pb.StoresKey(floats=[2.0]).SerializeToString()
    data = (b"\x10\x01\x10\x05" + b"\x0a" + bytes([len(k1)]) + k1
            + b"\x0a" + bytes([len(k2)]) + k2)
    got = pb.StoresFindOptions.FromString(data)
    want = jpb.StoresFindOptions.FromString(data)
    assert got.top_k == want.top_k == 5
    assert got.key.floats == list(want.key.floats) == [1.0, 2.0]


@pytest.mark.parametrize("data", [
    b"\x0a\x05ab",                # truncated length-delimited field
    b"\x10\xff\xff",              # truncated varint
    b"\x22\x02\xff\xfe",          # a string field holding invalid UTF-8
    b"\x2d\x00\x00",              # truncated fixed32
], ids=["truncated-bytes", "truncated-varint", "bad-utf8",
        "truncated-fixed32"])
def test_malformed_bytes_are_refused(data):
    with pytest.raises(pb.DecodeError):
        pb.Reply.FromString(data)


def test_map_entry_order_is_protobufs():
    """int32 keys by descending unsigned value, string keys by ascending
    bytes with a longer key before its prefix (protobuf's upb runtime
    under deterministic=True)."""
    keys = [0, 1, -1, (1 << 31) - 1, -(1 << 31), 100, -100, 300]
    opts = pb.PredictOptions(logit_bias={k: 1.0 for k in keys})
    jopts = jpb.PredictOptions()
    jopts.logit_bias.update({k: 1.0 for k in keys})
    assert opts.SerializeToString() == jopts.SerializeToString(
        deterministic=True)
    names = ["b", "a", "ab", "B", "é", "", " z"]
    st_ = pb.StatusResponse(memory={k: 1 for k in names})
    jst = jpb.StatusResponse()
    jst.memory.update({k: 1 for k in names})
    assert st_.SerializeToString() == jst.SerializeToString(
        deterministic=True)


def test_float_fields_decode_to_float32():
    for v in (0.1, 1e39, -1e-46, 3.4028235e38):
        got = pb.RerankScore.FromString(
            pb.RerankScore(relevance_score=v).SerializeToString())
        assert struct.pack("<d", got.relevance_score) == struct.pack(
            "<d", _float32(v))


def test_method_table_equals_the_jax_package():
    from localai_tpu.worker import rpc as jrpc

    assert rpc.SERVICE == jrpc.SERVICE
    assert list(rpc.METHODS) == list(jrpc.METHODS)
    for name, (kind, req_t, resp_t) in rpc.METHODS.items():
        jkind, jreq, jresp = jrpc.METHODS[name]
        assert (kind, req_t.__name__, resp_t.__name__) == (
            jkind, jreq.__name__, jresp.__name__), name
    assert rpc.TRACE_ID_METADATA_KEY == jrpc.TRACE_ID_METADATA_KEY
    assert rpc.TENANT_METADATA_KEY == jrpc.TENANT_METADATA_KEY
    assert rpc.trace_metadata("t") == jrpc.trace_metadata("t")
    assert rpc.tenant_metadata("") == jrpc.tenant_metadata("") == ()


def test_status_codes_are_grpcs():
    grpc = pytest.importorskip("grpc")
    for code in grpc.StatusCode:
        assert rpc.StatusCode[code.name] == code.value[0]

"""Wire-protocol versioning for every control-plane handshake.

Role of the reference's protobuf IDL version discipline (ray:
src/ray/protobuf/ — schema evolution gives version-skew safety): this
runtime speaks framed pickled tuples, so skew safety comes from an
explicit protocol version carried in EVERY hello — head registration
(daemons, clients), intra-node worker attach, and the peer object
plane. A listener that sees a different version (or a malformed hello)
rejects the dial with a clear error instead of failing later on a shape
mismatch deep inside a message handler.

The handshake layer speaks the proto3 ``Hello``/``Reject`` envelopes of
the reference's ``wire.proto``. The port encodes and decodes those two
messages itself (``_encode``/``_decode`` below: varint and
length-delimited fields, proto3 defaults omitted, unknown fields
skipped), so it needs no protobuf runtime; its bytes equal the
reference's generated code's ``SerializeToString`` for the same fields.
"""

from __future__ import annotations

import pickle
from typing import Optional, Tuple

# v1: unversioned wire; v2: versioned tuple hellos; v3: proto3
# Hello/Reject envelopes. v3 acceptors parse v2 tuple hellos and reject
# them with a clear error.
PROTOCOL_VERSION = 3


def make_hello(*fields) -> tuple:
    """A versioned tuple hello: ("hello", PROTOCOL_VERSION, *fields) (the
    v2 wire; split_hello parses it back)."""
    return ("hello", PROTOCOL_VERSION) + fields


def split_hello(hello) -> Tuple[Optional[int], tuple]:
    """(version, fields) of a received tuple hello (the v2 wire, and
    the unversioned one before it: parsed so a listener rejects them
    with a clear error).

    Version is None for malformed or pre-versioned senders (their
    first field is never an int)."""
    if not (isinstance(hello, tuple) and hello and hello[0] == "hello"):
        return None, ()
    if (len(hello) == 3 and hello[2] in ("task", "ctrl")
            and isinstance(hello[1], int)):
        # the unversioned intra-node worker hello was
        # ("hello", <int worker_num>, kind): the int is a worker number,
        # not a version
        return None, tuple(hello[1:])
    if len(hello) >= 2 and isinstance(hello[1], int) \
            and not isinstance(hello[1], bool):
        return hello[1], tuple(hello[2:])
    return None, tuple(hello[1:])


def mismatch_error(listener: str, version: Optional[int]) -> tuple:
    """The rejection reply a listener sends before closing the dial."""
    got = "an unversioned (pre-v2) hello" if version is None \
        else f"protocol v{version}"
    return ("error",
            f"protocol version mismatch: {listener} speaks "
            f"v{PROTOCOL_VERSION}, peer sent {got}; run one "
            "ray_tpu_torch version on every node and client")


# ----------------------------------------------------------------------
# proto3 envelopes: message ray_tpu.wire.Hello { uint32 protocol_version
# = 1; string role = 2; uint32 worker_num = 3; string kind = 4; string
# client_id = 5; bytes payload = 6; } and message ray_tpu.wire.Reject {
# string reason = 1; uint32 speaker_version = 2; }
# ----------------------------------------------------------------------

# field number -> (name, "u32" | "str" | "bytes")
_HELLO = {1: ("protocol_version", "u32"), 2: ("role", "str"),
          3: ("worker_num", "u32"), 4: ("kind", "str"),
          5: ("client_id", "str"), 6: ("payload", "bytes")}
_REJECT = {1: ("reason", "str"), 2: ("speaker_version", "u32")}


class DecodeError(ValueError):
    pass


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode(schema: dict, values: dict) -> bytes:
    """proto3 SerializeToString: fields in number order, defaults
    (0, "", b"") left out."""
    out = bytearray()
    for num in sorted(schema):
        name, kind = schema[num]
        v = values.get(name)
        if not v:
            continue
        if kind == "u32":
            v = int(v)
            if not 0 <= v < 1 << 32:
                raise ValueError(f"{name}={v} is out of uint32 range")
            out += _varint(num << 3) + _varint(v)
        else:
            data = v.encode("utf-8") if kind == "str" else bytes(v)
            out += _varint(num << 3 | 2) + _varint(len(data)) + data
    return bytes(out)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    n = shift = 0
    while True:
        if i >= len(buf):
            raise DecodeError("truncated varint")
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7
        if shift >= 70:
            raise DecodeError("varint too long")


def _decode(schema: dict, buf: bytes) -> dict:
    """proto3 ParseFromString into a dict of every field (defaults for
    the absent ones). Unknown fields are skipped; the last occurrence of
    a field wins; a uint32 keeps its low 32 bits."""
    out = {name: (0 if kind == "u32" else "" if kind == "str" else b"")
           for name, kind in schema.values()}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wt = key >> 3, key & 7
        if num == 0:
            raise DecodeError("field number 0")
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v, i = buf[i:i + 8], i + 8
        elif wt == 5:
            v, i = buf[i:i + 4], i + 4
        elif wt == 2:
            n, i = _read_varint(buf, i)
            v, i = buf[i:i + n], i + n
        else:
            raise DecodeError(f"wire type {wt}")
        if i > len(buf):
            raise DecodeError("truncated field")
        field = schema.get(num)
        if field is None:
            continue  # unknown field
        name, kind = field
        if kind == "u32":
            if wt != 0:
                raise DecodeError(f"{name}: wire type {wt}")
            out[name] = v & 0xFFFFFFFF
        else:
            if wt != 2:
                raise DecodeError(f"{name}: wire type {wt}")
            if kind == "str":
                try:
                    out[name] = bytes(v).decode("utf-8")
                except UnicodeDecodeError as e:
                    raise DecodeError(f"{name}: invalid UTF-8") from e
            else:
                out[name] = bytes(v)
    return out


def make_wire_hello(role: str, *fields) -> bytes:
    """Schema'd hello bytes (ray_tpu.wire.Hello). The caller states the
    role: "worker" (fields: num, kind), "client" (fields: client_id), or
    any daemon role or token (fields ride ``payload`` pickled, the
    single-language extras behind a language-neutral envelope)."""
    values = {"protocol_version": PROTOCOL_VERSION, "role": role}
    if role == "worker":
        values["worker_num"], values["kind"] = fields
    elif role == "client":
        (values["client_id"],) = fields
    elif fields:
        values["payload"] = pickle.dumps(tuple(fields))
    return _encode(_HELLO, values)


def split_any_hello(msg) -> Tuple[Optional[int], tuple]:
    """(version, tuple-shaped fields) from a proto-bytes hello or a
    tuple hello: every acceptor destructures the same field tuples
    either way. Garbage gives (None, ())."""
    if isinstance(msg, (bytes, bytearray)):
        try:
            hello = _decode(_HELLO, bytes(msg))
        except DecodeError:
            return None, ()
        if not hello["role"]:
            return None, ()
        try:
            if hello["role"] == "worker":
                fields: tuple = (hello["worker_num"], hello["kind"])
            elif hello["role"] == "client":
                fields = ("client", hello["client_id"])
            elif hello["payload"]:
                fields = (hello["role"],) + tuple(
                    pickle.loads(hello["payload"]))
            else:
                fields = (hello["role"],)
        except Exception:  # noqa: BLE001 (torn payload)
            return None, ()
        return hello["protocol_version"], fields
    return split_hello(msg)


def proto_reject(reason: str) -> bytes:
    """Schema'd rejection bytes: ray_tpu.wire.Reject."""
    return _encode(_REJECT, {"reason": reason,
                             "speaker_version": PROTOCOL_VERSION})


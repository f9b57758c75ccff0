"""Wire codec for the shard-host RPC transport.

Messages are plain dicts (method name, params, numpy arrays) encoded to
one byte frame. Preferred encoding is **msgpack** with an extension hook
for numpy arrays (dtype + shape + raw little-endian bytes — zero-parse
on the receiving side); when msgpack is not installed the codec degrades
to **JSON** with base64-packed array payloads. Both sides of a
connection negotiate nothing: every frame is self-describing (first byte
tags the codec), so a msgpack controller can talk to a JSON worker and
vice versa.

Framing (the length prefix) is owned by the transport layer
(:mod:`repro_torch.service.rpc.transport` rides
``multiprocessing.connection``'s length-prefixed byte frames); this
module only turns objects into bytes and back.
"""
from __future__ import annotations

import base64
import json
from typing import Any

import numpy as np

try:                                    # baked into the image; but the
    import msgpack                      # codec must survive without it
except Exception:                       # pragma: no cover - env dependent
    msgpack = None

__all__ = ["encode", "decode", "codec_name"]

_TAG_MSGPACK = b"M"
_TAG_JSON = b"J"

_ND_KEY = "__nd__"


def codec_name() -> str:
    """Which codec :func:`encode` will use (``msgpack`` or ``json``)."""
    return "msgpack" if msgpack is not None else "json"


def _nd_pack(a: np.ndarray) -> dict:
    a = np.ascontiguousarray(a)
    return {_ND_KEY: True, "dtype": a.dtype.str, "shape": list(a.shape),
            "data": a.tobytes()}


def _nd_unpack(d: dict) -> np.ndarray:
    a = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"]))
    return a.reshape(d["shape"]).copy()  # writable, owns its memory


def _msgpack_default(obj):
    if isinstance(obj, np.ndarray):
        return _nd_pack(obj)
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    if isinstance(obj, tuple):
        return list(obj)
    raise TypeError(f"unencodable type {type(obj).__name__}")


def _msgpack_hook(d):
    if d.get(_ND_KEY):
        return _nd_unpack(d)
    return d


class _JsonEncoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.ndarray):
            p = _nd_pack(obj)
            p["data"] = base64.b64encode(p["data"]).decode("ascii")
            return p
        if isinstance(obj, (np.integer, np.floating, np.bool_)):
            return obj.item()
        if isinstance(obj, bytes):
            return {"__b64__": base64.b64encode(obj).decode("ascii")}
        return super().default(obj)


def _json_hook(d):
    if d.get(_ND_KEY):
        d = dict(d, data=base64.b64decode(d["data"]))
        return _nd_unpack(d)
    if "__b64__" in d:
        return base64.b64decode(d["__b64__"])
    return d


def encode(msg: Any) -> bytes:
    """One message -> one tagged byte frame."""
    if msgpack is not None:
        return _TAG_MSGPACK + msgpack.packb(
            msg, default=_msgpack_default, use_bin_type=True)
    return _TAG_JSON + json.dumps(msg, cls=_JsonEncoder).encode("utf-8")


def decode(frame: bytes) -> Any:
    """One tagged byte frame -> the message it encodes."""
    tag, body = frame[:1], frame[1:]
    if tag == _TAG_MSGPACK:
        if msgpack is None:
            raise RuntimeError(
                "received a msgpack frame but msgpack is not importable")
        return msgpack.unpackb(body, object_hook=_msgpack_hook, raw=False,
                               strict_map_key=False)
    if tag == _TAG_JSON:
        return json.loads(body.decode("utf-8"), object_hook=_json_hook)
    raise ValueError(f"unknown wire codec tag {tag!r}")

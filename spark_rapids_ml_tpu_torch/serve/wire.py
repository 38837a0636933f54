"""Binary columnar wire format for the serving front end.

The port's copy of the JAX package's ``serve/wire.py``, byte for byte the
same frames, so a client of either package's server speaks to the other.
The binary format is the alternative to the JSON text protocol: a fixed
24-byte header plus the rows as one contiguous row-major payload, so a
request parse is a header unpack + a zero-copy ``np.frombuffer`` view
instead of a ``float()`` construction per value.

Request layout (little-endian)::

    offset  size  field
    0       4     magic  b"SMLW"
    4       1     format version (currently 1)
    5       1     dtype code (1=f32, 2=f64, 3=i32, 4=i64)
    6       2     flags (reserved, 0)
    8       4     n_rows      (u32)
    12      4     n_features  (u32)
    16      2     model_ref length in bytes (u16, utf-8)
    18      2     reserved (0)
    20      4     deadline_ms (u32; 0 = no deadline)
    24      —     model_ref bytes, then the (n_rows × n_features)
                  row-major payload (n_rows·n_features·itemsize bytes)

Response layout: ``magic | version | dtype | flags | n_rows | n_cols``
(16 bytes) + the row-major payload; ``n_cols == 0`` marks a 1-D output
(labels / binary probabilities).

Negotiation: a request IS binary when its ``Content-Type`` is
``application/x-sparkml-columnar``; the response is binary when the
client's ``Accept`` asks for it (or, absent an ``Accept``, mirrors the
request format). Tenant and priority stay HEADER-borne (``X-Tenant`` /
``X-Priority``) so the server's pre-parse fast shed works on binary
traffic too: that path never reads the body.

Every decoder — the binary one AND the JSON one — records its parse
latency into the ``sparkml_serve_parse_seconds{format}`` quantile
summary; ``serve/server.py`` decodes request bodies only through this
module.

Malformed binary bodies (bad magic, wrong version, unknown dtype,
truncated payload, size mismatch) raise ``WireError`` carrying the HTTP
status to reply with (400 for corrupt frames, 415 for unsupported
version/dtype) and a ``reason`` label; they are counted under the
distinct ``error="bad_wire"`` metric label. The server reads the full
``Content-Length`` body BEFORE decoding, so a malformed frame never
desyncs a keep-alive connection.
"""

from __future__ import annotations

import json
import struct
import time
from typing import Dict, Optional

import numpy as np

from spark_rapids_ml_tpu_torch.obs.metrics import get_registry

MAGIC = b"SMLW"
WIRE_VERSION = 1
BINARY_CONTENT_TYPE = "application/x-sparkml-columnar"
JSON_CONTENT_TYPE = "application/json"

_REQ_HEADER = struct.Struct("<4sBBHIIHHI")   # 24 bytes
_RESP_HEADER = struct.Struct("<4sBBHII")     # 16 bytes

DTYPE_CODES: Dict[int, np.dtype] = {
    1: np.dtype(np.float32),
    2: np.dtype(np.float64),
    3: np.dtype(np.int32),
    4: np.dtype(np.int64),
}
_CODE_FOR_DTYPE = {v: k for k, v in DTYPE_CODES.items()}

PARSE_SUMMARY = "sparkml_serve_parse_seconds"
_PARSE_QUANTILES = (0.5, 0.95, 0.99)


class WireError(ValueError):
    """A request body this module refuses to decode.

    ``reason`` is the bounded metric label (``bad_magic`` /
    ``bad_version`` / ``bad_dtype`` / ``truncated`` / ``size_mismatch``
    / ``bad_header`` / ``bad_json``); ``status`` the HTTP status the
    server replies with (400 corrupt, 415 unsupported); ``kind`` which
    decoder raised (``binary`` bodies are counted under the distinct
    ``error="bad_wire"`` label, ``json`` keeps the plain bad-request
    semantics)."""

    def __init__(self, message: str, *, reason: str, status: int = 400,
                 kind: str = "binary"):
        super().__init__(message)
        self.reason = reason
        self.status = status
        self.kind = kind


class DecodedRequest:
    """One decoded predict request, format-agnostic: what
    ``serve/server.py`` hands to the engine. ``tenant`` / ``priority``
    come from a JSON body's fields; binary frames carry none (the
    ``X-Tenant`` / ``X-Priority`` headers do, and headers win)."""

    __slots__ = ("model", "rows", "deadline_ms", "tenant", "priority",
                 "binary")

    def __init__(self, model: str, rows: np.ndarray,
                 deadline_ms: Optional[float] = None,
                 tenant: Optional[str] = None,
                 priority: Optional[str] = None,
                 binary: bool = False):
        self.model = model
        self.rows = rows
        self.deadline_ms = deadline_ms
        self.tenant = tenant
        self.priority = priority
        self.binary = binary


def _parse_summary():
    return get_registry().summary(
        PARSE_SUMMARY,
        "request-body parse latency by wire format (the protocol cost "
        "the binary columnar format exists to cut)", ("format",),
        quantiles=_PARSE_QUANTILES,
    )


def _count_bad_wire(reason: str) -> None:
    reg = get_registry()
    reg.counter(
        "sparkml_serve_errors_total",
        "serving errors by type: batch failures (exception class), "
        "worker crashes/wedges, breaker rejections", ("model", "error"),
    ).inc(model="(wire)", error="bad_wire")
    reg.counter(
        "sparkml_serve_wire_errors_total",
        "malformed binary wire bodies by reason", ("reason",),
    ).inc(reason=reason)


# -- encoding (clients: example, bench, tests) -------------------------------


def encode_request(model: str, rows, *, dtype=None,
                   deadline_ms: Optional[float] = None) -> bytes:
    """One binary request body for ``POST /predict`` (client side)."""
    matrix = np.asarray(rows)
    if matrix.ndim == 1:
        matrix = matrix[None, :]
    if dtype is not None:
        matrix = matrix.astype(dtype, copy=False)
    matrix = np.ascontiguousarray(matrix)
    code = _CODE_FOR_DTYPE.get(matrix.dtype)
    if code is None:
        raise ValueError(f"unsupported wire dtype {matrix.dtype}")
    ref = model.encode("utf-8")
    header = _REQ_HEADER.pack(
        MAGIC, WIRE_VERSION, code, 0,
        int(matrix.shape[0]), int(matrix.shape[1]),
        len(ref), 0,
        int(deadline_ms) if deadline_ms else 0,
    )
    return header + ref + matrix.tobytes()


def encode_response(outputs) -> bytes:
    """One binary response body (server side): header + row-major
    payload; 1-D outputs (labels, binary probabilities) carry
    ``n_cols == 0``."""
    out = np.ascontiguousarray(np.asarray(outputs))
    code = _CODE_FOR_DTYPE.get(out.dtype)
    if code is None:
        # whatever exotic dtype a model emitted, the wire carries f64 —
        # same as the JSON path's float serialization
        out = out.astype(np.float64)
        code = _CODE_FOR_DTYPE[out.dtype]
    n_rows = int(out.shape[0]) if out.ndim else 1
    n_cols = int(out.shape[1]) if out.ndim > 1 else 0
    header = _RESP_HEADER.pack(MAGIC, WIRE_VERSION, code, 0,
                               n_rows, n_cols)
    return header + out.tobytes()


def decode_response(body: bytes) -> np.ndarray:
    """Client-side decode of a binary response body."""
    if len(body) < _RESP_HEADER.size:
        raise WireError("response shorter than its header",
                        reason="truncated")
    magic, version, code, _flags, n_rows, n_cols = _RESP_HEADER.unpack(
        body[:_RESP_HEADER.size])
    if magic != MAGIC:
        raise WireError("bad response magic", reason="bad_magic")
    if version != WIRE_VERSION:
        raise WireError(f"unsupported wire version {version}",
                        reason="bad_version", status=415)
    dtype = DTYPE_CODES.get(code)
    if dtype is None:
        raise WireError(f"unknown dtype code {code}",
                        reason="bad_dtype", status=415)
    payload = body[_RESP_HEADER.size:]
    count = n_rows * (n_cols or 1)
    if len(payload) != count * dtype.itemsize:
        raise WireError("response payload size mismatch",
                        reason="size_mismatch")
    out = np.frombuffer(payload, dtype=dtype)
    return out.reshape(n_rows, n_cols) if n_cols else out


# -- decoding (the server's ONLY body-parse path) ----------------------------


def decode_request(body: bytes) -> DecodedRequest:
    """Decode one binary request body, validating every frame field.

    Raises ``WireError`` (counted under ``error="bad_wire"`` with a
    per-reason series) for bad magic, unsupported version, unknown
    dtype, a truncated payload, or a header/payload size mismatch —
    the caller replies 400/415 and, having already read the full body,
    keeps the connection in sync. Records the parse latency under
    ``sparkml_serve_parse_seconds{format="binary"}``.
    """
    t0 = time.perf_counter()
    if len(body) < _REQ_HEADER.size:
        _count_bad_wire("truncated")
        raise WireError(
            f"body of {len(body)} bytes is shorter than the "
            f"{_REQ_HEADER.size}-byte wire header", reason="truncated")
    (magic, version, code, _flags, n_rows, n_features,
     model_len, _reserved, deadline_ms) = _REQ_HEADER.unpack(
        body[:_REQ_HEADER.size])
    if magic != MAGIC:
        _count_bad_wire("bad_magic")
        raise WireError(f"bad wire magic {magic!r} (expected {MAGIC!r})",
                        reason="bad_magic")
    if version != WIRE_VERSION:
        _count_bad_wire("bad_version")
        raise WireError(
            f"unsupported wire version {version} (this server speaks "
            f"{WIRE_VERSION})", reason="bad_version", status=415)
    dtype = DTYPE_CODES.get(code)
    if dtype is None:
        _count_bad_wire("bad_dtype")
        raise WireError(f"unknown wire dtype code {code}",
                        reason="bad_dtype", status=415)
    if n_rows == 0 or n_features == 0:
        _count_bad_wire("bad_header")
        raise WireError(
            f"degenerate shape ({n_rows}, {n_features}) in wire header",
            reason="bad_header")
    offset = _REQ_HEADER.size + model_len
    if len(body) < offset:
        _count_bad_wire("truncated")
        raise WireError("body truncated inside the model ref",
                        reason="truncated")
    try:
        model = body[_REQ_HEADER.size:offset].decode("utf-8")
    except UnicodeDecodeError:
        _count_bad_wire("bad_header")
        raise WireError("model ref is not valid utf-8",
                        reason="bad_header") from None
    expected = n_rows * n_features * dtype.itemsize
    payload = body[offset:]
    if len(payload) < expected:
        _count_bad_wire("truncated")
        raise WireError(
            f"payload truncated: header claims {n_rows}×{n_features} "
            f"{dtype.name} rows ({expected} bytes), body carries "
            f"{len(payload)}", reason="truncated")
    if len(payload) > expected:
        _count_bad_wire("size_mismatch")
        raise WireError(
            f"payload size mismatch: {len(payload) - expected} trailing "
            "bytes after the declared rows", reason="size_mismatch")
    rows = np.frombuffer(payload, dtype=dtype).reshape(n_rows, n_features)
    out = DecodedRequest(
        model=model, rows=rows,
        deadline_ms=float(deadline_ms) if deadline_ms else None,
        binary=True,
    )
    _parse_summary().observe(time.perf_counter() - t0, format="binary")
    return out


def decode_json_request(body: bytes) -> DecodedRequest:
    """Decode one JSON request body (the text protocol), through
    the same parse-latency accounting as the binary path so the two
    formats are comparable on one metric. Malformed JSON raises
    ``WireError(kind="json")`` — the server keeps its historical
    ``bad request`` 400 semantics for those."""
    t0 = time.perf_counter()
    try:
        payload = json.loads(body)
        model = payload["model"]
        rows = np.asarray(payload["rows"], dtype=np.float64)
        deadline_ms = payload.get("deadline_ms")
        tenant = payload.get("tenant")
        priority = payload.get("priority")
    except (KeyError, TypeError, ValueError) as exc:
        raise WireError(f"{exc}", reason="bad_json", kind="json") from exc
    out = DecodedRequest(model=model, rows=rows, deadline_ms=deadline_ms,
                         tenant=tenant, priority=priority, binary=False)
    _parse_summary().observe(time.perf_counter() - t0, format="json")
    return out


def is_binary_content_type(content_type: Optional[str]) -> bool:
    return bool(content_type) and content_type.split(";")[0].strip() \
        .lower() == BINARY_CONTENT_TYPE


def decode_body(body: bytes,
                content_type: Optional[str]) -> DecodedRequest:
    """THE server body-parse entry point: dispatch on the negotiated
    ``Content-Type`` — binary columnar when the client sent it, the JSON
    text protocol otherwise."""
    if is_binary_content_type(content_type):
        return decode_request(body)
    return decode_json_request(body)


def wants_binary_response(accept: Optional[str],
                          request_was_binary: bool) -> bool:
    """Response-format negotiation: an explicit ``Accept`` wins; absent
    one — or with only the no-preference ``*/*`` many HTTP stacks
    (requests, curl) add by default — the response mirrors the request
    format, so a binary client is never handed JSON it cannot decode."""
    if accept:
        lowered = accept.lower()
        if BINARY_CONTENT_TYPE in lowered:
            return True
        if "application/json" in lowered:
            return False
    return request_was_binary


__all__ = [
    "BINARY_CONTENT_TYPE",
    "DecodedRequest",
    "DTYPE_CODES",
    "JSON_CONTENT_TYPE",
    "MAGIC",
    "PARSE_SUMMARY",
    "WIRE_VERSION",
    "WireError",
    "decode_body",
    "decode_json_request",
    "decode_request",
    "decode_response",
    "encode_request",
    "encode_response",
    "is_binary_content_type",
    "wants_binary_response",
]

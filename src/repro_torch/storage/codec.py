"""Block codecs for the storage data plane (wire + at-rest compression).

The socket transport moves every payload block as ``header {shape,
dtype} + raw little-endian buffer``.  This module adds the optional
compression layer on top of that frame format: a block is encoded into
``(meta, buf)`` where ``meta`` extends the raw array header with a
``codec`` tag (absent for raw — the legacy wire format, byte-for-byte),
and decoded back by dispatching on that tag.  Because every encoded
block is self-describing, mixed fleets interoperate: an old client never
sends a ``codec`` tag and an old server never emits one, and both sides
fall back to raw.

Codecs (``WIRE_CODECS``):

  * ``raw``  — identity; the legacy format.
  * ``zlib`` — lossless DEFLATE over the raw buffer.  The right choice
    for uint8/int label tiles and masks (mostly-constant runs compress
    10x+); bit-exact for every dtype.
  * ``bf16`` — lossy: float32/float64 cast to bfloat16 on the wire and
    cast back on decode (2x/4x fewer bytes).  Non-float payloads (label
    maps, masks, bools) fall back to ``zlib`` — lossy modes must never
    corrupt discrete data.
  * ``int8`` — lossy: float32/float64 quantized to int8 with a
    per-block max-abs scale (the ``train/compression.py`` idiom), 4x/8x
    fewer bytes.  Non-float payloads fall back to ``zlib``.

``Encoded`` is the at-rest form: a server started with at-rest
compression keeps the losslessly-compressed blob resident instead of the
decoded array (capacity saving), decodes lazily for plain clients, and
passes the blob straight through to codec-negotiated clients.
"""
from __future__ import annotations

import dataclasses
import zlib
from fnmatch import fnmatchcase
from typing import Mapping

import numpy as np

WIRE_CODECS = ("raw", "zlib", "bf16", "int8")

# lossy modes only ever touch these dtypes; everything else (labels,
# masks, counts) silently degrades to lossless zlib
_LOSSY_DTYPES = (np.float32, np.float64)

_ZLIB_LEVEL = 1  # speed over ratio: label tiles still compress 10x+


def check_codec(name):
    """Normalize a codec spec.

    A plain name: ``None``/``"raw"`` -> ``None`` (plain wire), anything
    else must be a member of :data:`WIRE_CODECS`.

    A mapping is a PER-KEY override table — glob patterns over region
    keys (``{"labels/*": "zlib", "feat/*": "bf16"}``) mapped to codec
    names, matched first-hit-wins in insertion order by
    :func:`resolve_codec`; an explicit ``None``/``"raw"`` value forces
    plain wire for its pattern.  The normalized mapping is returned with
    every codec name validated.
    """
    if isinstance(name, Mapping):
        out = {}
        for pattern, codec in name.items():
            if not isinstance(pattern, str) or not pattern:
                raise ValueError(f"wire_codec pattern must be a non-empty str, got {pattern!r}")
            out[pattern] = check_codec(codec) if not isinstance(codec, Mapping) else _reject(codec)
        return out
    if name is None or name == "raw":
        return None
    if name not in WIRE_CODECS:
        raise ValueError(f"unknown wire codec {name!r} (want one of {WIRE_CODECS})")
    return name


def _reject(codec):
    raise ValueError(f"nested wire_codec mapping {codec!r} is not allowed")


def codec_names(spec) -> list[str]:
    """The distinct non-raw codec names a spec can emit — what the
    connection negotiation must ask the server to support."""
    if isinstance(spec, Mapping):
        return sorted({c for c in spec.values() if c is not None})
    return [] if spec in (None, "raw") else [spec]


def resolve_codec(spec, key) -> str | None:
    """The codec a (possibly per-key) spec picks for ``key``.

    ``key`` is anything with ``namespace``/``name`` attributes (a
    ``RegionKey``) or a plain string.  Mapping specs match each glob
    pattern — in insertion order, first hit wins — against
    ``"namespace/name"``, then the bare ``name``, then the bare
    ``namespace``; no hit means plain wire (raw is the safe default for
    keys the override table never anticipated).
    """
    if not isinstance(spec, Mapping):
        return check_codec(spec)
    ns = getattr(key, "namespace", None)
    name = getattr(key, "name", None)
    if ns is None and name is None:
        candidates = [str(key)]
    else:
        candidates = [f"{ns}/{name}", str(name), str(ns)]
    for pattern, codec in spec.items():
        if any(fnmatchcase(c, pattern) for c in candidates):
            return check_codec(codec)
    return None


def _dtype_from_str(name: str) -> np.dtype:
    try:
        return np.dtype(name)
    except TypeError:
        # jax extended dtypes (bfloat16, float8_*) register with ml_dtypes
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, name))


def raw_nbytes(meta: dict) -> int:
    """Decoded payload size implied by an array header."""
    n = 1
    for s in meta["shape"]:
        n *= int(s)
    return n * _dtype_from_str(meta["dtype"]).itemsize


def encode_array(arr: np.ndarray) -> tuple[dict, memoryview]:
    """(meta, buffer): raw C-order bytes + {shape, dtype} — no pickling."""
    arr = np.ascontiguousarray(arr)
    meta = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
    if not arr.nbytes:
        return meta, memoryview(b"")
    try:
        return meta, arr.data.cast("B")  # zero-copy
    except ValueError:
        # extended dtypes (bfloat16, float8_*) refuse the buffer protocol
        return meta, memoryview(arr.tobytes())


def decode_array(meta: dict, payload) -> np.ndarray:
    dt = _dtype_from_str(meta["dtype"])
    return np.frombuffer(payload, dtype=dt).reshape(tuple(meta["shape"]))


def encode_block(arr: np.ndarray, codec: str | None) -> tuple[dict, memoryview]:
    """Encode one block for the wire.

    Returns ``(meta, buf)``; ``meta`` is the raw array header plus a
    ``codec`` tag when the payload is actually transformed (raw output
    carries no tag, so it is byte-identical to the legacy format and old
    decoders keep working).  Empty blocks always go raw: there is
    nothing to save and zlib headers would *add* bytes.
    """
    codec = check_codec(codec)
    meta, buf = encode_array(arr)
    if codec is None or not buf.nbytes:
        return meta, buf
    if codec in ("bf16", "int8") and arr.dtype.type in _LOSSY_DTYPES:
        if codec == "bf16":
            import ml_dtypes

            small = np.ascontiguousarray(arr).astype(ml_dtypes.bfloat16)
            meta = dict(meta, codec="bf16")
            return meta, memoryview(small.tobytes())
        absmax = float(np.max(np.abs(arr))) if arr.size else 0.0
        scale = max(absmax, 1e-12) / 127.0
        q = np.clip(np.round(np.asarray(arr, np.float64) / scale), -127, 127)
        meta = dict(meta, codec="int8", scale=scale)
        return meta, memoryview(np.ascontiguousarray(q.astype(np.int8)).data.cast("B"))
    # zlib for explicit "zlib" and as the lossless fallback of lossy modes
    blob = zlib.compress(bytes(buf), _ZLIB_LEVEL)
    if len(blob) >= buf.nbytes:
        return meta, buf  # incompressible: raw is strictly better
    meta = dict(meta, codec="zlib")
    return meta, memoryview(blob)


def decode_block(meta: dict, payload) -> np.ndarray:
    """Decode one self-describing block (raw when no ``codec`` tag)."""
    codec = meta.get("codec")
    if codec is None:
        return decode_array(meta, payload)
    if codec == "zlib":
        return decode_array(meta, zlib.decompress(bytes(payload)))
    shape = tuple(meta["shape"])
    dt = _dtype_from_str(meta["dtype"])
    if codec == "bf16":
        import ml_dtypes

        return np.frombuffer(payload, dtype=ml_dtypes.bfloat16).reshape(shape).astype(dt)
    if codec == "int8":
        q = np.frombuffer(payload, dtype=np.int8).reshape(shape)
        return (q.astype(np.float64) * float(meta["scale"])).astype(dt)
    raise ValueError(f"unknown codec tag {codec!r} in block header")


def is_lossless(meta: dict) -> bool:
    """True when the encoded payload reproduces the block bit-exact —
    the precondition for keeping it as the at-rest resident form."""
    return meta.get("codec") in (None, "zlib")


@dataclasses.dataclass
class Encoded:
    """An at-rest compressed block: the wire blob + its array header.

    Storage servers keep these resident instead of decoded arrays when
    at-rest compression is on (``meta`` must be lossless — enforce with
    :func:`is_lossless` before storing).  ``nbytes`` is the RESIDENT
    size, which is what ``payload_bytes`` capacity accounting should
    see; ``raw_nbytes`` is the decoded size.
    """

    meta: dict
    data: bytes

    @property
    def nbytes(self) -> int:
        return len(self.data)

    @property
    def raw_nbytes(self) -> int:
        return raw_nbytes(self.meta)

    def decode(self) -> np.ndarray:
        return decode_block(self.meta, self.data)

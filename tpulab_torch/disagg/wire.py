"""KV-snapshot wire format: the serialized form of a host-tier entry (the
port of ``tpulab/disagg/wire.py``, byte for byte the same blob for the
same payload).

A shipment is one finished prefill's KV pages — the ``(L, n_pages, 2, S,
Hkv, D)`` page-granular snapshot the host tier holds — plus what a decode
replica needs to admit the request without prefilling: the prompt
digest, the covered length, and the first token (picked on the prefill
replica, so the decode replica never fetches prefill logits).

Layout (all little-endian)::

    b"TPKV" | version u16 | header_len u32 | header (JSON, utf-8)
           | payload_crc32 u32 | payload (C-contiguous tensor bytes)

The JSON header carries ``dtype`` (tpulab's numpy name: ``"float32"``,
``"bfloat16"``, ``"float16"``, ``"float8_e4m3fn"``, ``"float8_e5m2"``),
``shape``, ``page_size``, ``length``, ``digest`` (hex), ``first_token``
and optional extras, sorted by key — so a decode replica with a DIFFERENT pool
geometry rejects the shipment (:class:`WireFormatError`) instead of
scattering foreign bytes into its pool.  The CRC32 covers the payload: a
corrupted shipment is detected at import, never promoted into a lane.

Every rejection here is recoverable: the decode replica simply prefills
locally, exactly as if no shipment had arrived.
"""

from __future__ import annotations

import hashlib
import json
import struct
import zlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

MAGIC = b"TPKV"
VERSION = 1

_HEAD = struct.Struct("<HI")   # version, header_len
_CRC = struct.Struct("<I")

#: tpulab's numpy dtype names <-> torch dtypes (the port's own table: the
#: card's machine has no ml_dtypes, so bf16 never passes through numpy)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn,
          "float8_e5m2": torch.float8_e5m2}
_NAMES = {dt: name for name, dt in DTYPES.items()}


class WireFormatError(ValueError):
    """The shipment cannot be admitted: bad magic, unknown version,
    malformed header, geometry mismatch, or payload corruption.  Callers
    treat it as a LOST shipment (degrade to local prefill), never as a
    reason to touch the pool."""


def prompt_digest(prompt) -> bytes:
    """The shipment identity: a 16-byte blake2b over the prompt's int32
    token bytes — the same digest family the prefix cache keys on."""
    raw = np.ascontiguousarray(np.asarray(prompt, np.int32).reshape(-1))
    return hashlib.blake2b(raw.tobytes(), digest_size=16).digest()


def serialize_snapshot(tensor: torch.Tensor, *, digest: bytes, length: int,
                       page_size: int, first_token: int,
                       extras: Dict[str, Any] = None) -> bytes:
    """Wire-encode one host-tier KV snapshot (module docstring layout).

    ``tensor`` is the page-granular snapshot ``(L, n, 2, S, Hkv, D)`` on
    the host; ``length`` the token positions it covers; ``first_token``
    the prefill replica's first-token pick (emitted as index 0
    downstream)."""
    if tensor.dtype not in _NAMES:
        raise WireFormatError(f"no wire name for dtype {tensor.dtype}")
    tensor = tensor.detach().to("cpu").contiguous()
    header = {
        "dtype": _NAMES[tensor.dtype],
        "shape": [int(d) for d in tensor.shape],
        "page_size": int(page_size),
        "length": int(length),
        "digest": bytes(digest).hex(),
        "first_token": int(first_token),
    }
    if extras:
        header.update(extras)
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    payload = tensor.reshape(-1).view(torch.uint8).numpy().tobytes()
    return b"".join([MAGIC, _HEAD.pack(VERSION, len(hdr)), hdr,
                     _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF), payload])


def deserialize_snapshot(blob: bytes) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Decode a shipment -> ``(tensor, header)``, the tensor a fresh CPU
    tensor.  Raises :class:`WireFormatError` on anything that would admit
    garbage: bad magic, version skew, truncation, or a CRC mismatch."""
    blob = bytes(blob)
    base = len(MAGIC) + _HEAD.size
    if len(blob) < base or blob[:len(MAGIC)] != MAGIC:
        raise WireFormatError("not a KV shipment (bad magic)")
    version, hdr_len = _HEAD.unpack_from(blob, len(MAGIC))
    if version != VERSION:
        raise WireFormatError(
            f"shipment version {version} != {VERSION} (mismatched "
            "replicas must reject, not corrupt)")
    if len(blob) < base + hdr_len + _CRC.size:
        raise WireFormatError("truncated shipment header")
    try:
        header = json.loads(blob[base:base + hdr_len].decode("utf-8"))
        dtype = DTYPES[header["dtype"]]
        shape = tuple(int(d) for d in header["shape"])
        header["digest"] = bytes.fromhex(header["digest"])
    except Exception as e:  # noqa: BLE001 - malformed header = reject
        raise WireFormatError(f"malformed shipment header: {e!r}") from e
    (crc,) = _CRC.unpack_from(blob, base + hdr_len)
    payload = blob[base + hdr_len + _CRC.size:]
    itemsize = torch.empty((), dtype=dtype).element_size()
    want = int(np.prod(shape)) * itemsize if shape else itemsize
    if len(payload) != want:
        raise WireFormatError(
            f"payload size {len(payload)} != header-declared {want}")
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise WireFormatError("shipment payload corrupt (CRC mismatch)")
    flat = torch.frombuffer(bytearray(payload), dtype=torch.uint8)
    return flat.view(dtype).reshape(shape), header

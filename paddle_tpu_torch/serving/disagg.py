"""Disaggregated prefill/decode serving: the KV page shipment wire format
(port of ``paddle_tpu/serving/disagg.py``).

A prefill replica runs the prompt pass and ships the finished KV pages
(``DecodeEngine.submit_prefill``); a decode replica installs them and
runs the generation steps. The format is the reference's byte for byte,
so a shipment packed by either package unpacks in the other (version 1,
zlib.crc32 over the raw array bytes):

    b"PTKV" | u8 version | u32 header_len | header JSON | payload

The header carries page_size / n_pages / tokens / dtype, the payload
layout (layer names in order, shapes), a CRC for each page of each layer
and the CRC of the shipped first-token logits row. ``unpack_shipment``
checks every CRC and raises ``ShipmentCRCError`` on any mismatch
(``disagg.crc_rejects``): a corrupt shipment is rejected, never served.

``fetch_prefill`` pulls a shipment over HTTP (``POST /v1/prefill``) from a
prefill replica or from the cluster router, which forwards it to a ready
prefill-tier member; ``DecodeEngine._admit_shipped`` installs it.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, Sequence

import numpy as np

from ..core import telemetry

MAGIC = b"PTKV"
VERSION = 1


class ShipmentError(ValueError):
    """Malformed or mismatched KV page shipment."""


class ShipmentCRCError(ShipmentError):
    """A shipped page's CRC did not verify: the shipment is corrupt."""


def _crc(a: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF


def pack_shipment(tokens: Sequence[int], page_size: int,
                  layer_pages: Dict[str, np.ndarray],
                  logits_row: np.ndarray) -> bytes:
    """Serialize one prompt's finished KV pages and first-token logits.
    ``layer_pages``: pool feed name -> [n_pages, page_size, kv_dim] host
    array (the prompt's pages, in page-table order)."""
    names = sorted(layer_pages)
    if not names:
        raise ShipmentError("shipment needs at least one layer")
    first = layer_pages[names[0]]
    n_pages = int(first.shape[0])
    logits_row = np.asarray(logits_row)
    header: Dict[str, Any] = {
        "page_size": int(page_size),
        "n_pages": n_pages,
        "kv_dim": int(first.shape[2]),
        "dtype": str(first.dtype),
        "tokens": [int(t) for t in np.asarray(tokens).reshape(-1)],
        "layers": names,
        "page_crcs": {},
        "logits_dtype": str(logits_row.dtype),
        "logits_len": int(logits_row.size),
        "logits_crc": _crc(logits_row),
    }
    payload = bytearray()
    for name in names:
        arr = np.ascontiguousarray(layer_pages[name])
        if arr.shape != first.shape or arr.dtype != first.dtype:
            raise ShipmentError(
                f"layer {name} shape/dtype {arr.shape}/{arr.dtype} "
                f"disagrees with {first.shape}/{first.dtype}")
        header["page_crcs"][name] = [_crc(arr[p]) for p in range(n_pages)]
        payload += arr.tobytes()
    payload += np.ascontiguousarray(logits_row).tobytes()
    hdr = json.dumps(header, sort_keys=True).encode("utf-8")
    return (MAGIC + struct.pack("<BI", VERSION, len(hdr)) + hdr +
            bytes(payload))


def unpack_shipment(blob: bytes) -> Dict[str, Any]:
    """Parse and CRC-check a shipment: {page_size, n_pages, tokens,
    layers: {name: [n_pages, P, kv_dim] array}, logits}. Raises
    ShipmentCRCError (counted as ``disagg.crc_rejects``) on any page or
    logits CRC mismatch, ShipmentError on malformed framing."""
    if len(blob) < len(MAGIC) + 5 or blob[:len(MAGIC)] != MAGIC:
        raise ShipmentError("not a KV page shipment (bad magic)")
    ver, hdr_len = struct.unpack_from("<BI", blob, len(MAGIC))
    if ver != VERSION:
        raise ShipmentError(f"unsupported shipment version {ver} "
                            f"(this build speaks {VERSION})")
    off = len(MAGIC) + 5
    try:
        header = json.loads(blob[off:off + hdr_len].decode("utf-8"))
    except Exception as e:
        raise ShipmentError(f"unreadable shipment header: {e!r}")
    off += hdr_len
    n_pages = int(header["n_pages"])
    shape = (n_pages, int(header["page_size"]), int(header["kv_dim"]))
    dtype = np.dtype(header["dtype"])
    per_layer = int(np.prod(shape)) * dtype.itemsize
    layers: Dict[str, np.ndarray] = {}
    for name in header["layers"]:
        raw = blob[off:off + per_layer]
        if len(raw) != per_layer:
            raise ShipmentError(f"truncated shipment payload at {name}")
        arr = np.frombuffer(raw, dtype=dtype).reshape(shape)
        crcs = header["page_crcs"][name]
        for p in range(n_pages):
            if _crc(arr[p]) != int(crcs[p]):
                telemetry.counter_add("disagg.crc_rejects", 1)
                raise ShipmentCRCError(
                    f"CRC mismatch on shipped page {p} of {name}: "
                    f"rejecting the shipment")
        layers[name] = arr
        off += per_layer
    ldtype = np.dtype(header["logits_dtype"])
    llen = int(header["logits_len"])
    raw = blob[off:off + llen * ldtype.itemsize]
    if len(raw) != llen * ldtype.itemsize:
        raise ShipmentError("truncated shipment logits")
    logits = np.frombuffer(raw, dtype=ldtype).reshape(llen)
    if _crc(logits) != int(header["logits_crc"]):
        telemetry.counter_add("disagg.crc_rejects", 1)
        raise ShipmentCRCError("CRC mismatch on shipped logits: "
                               "rejecting the shipment")
    return {"page_size": int(header["page_size"]), "n_pages": n_pages,
            "tokens": [int(t) for t in header["tokens"]],
            "layers": layers, "logits": logits}


def fetch_prefill(url: str, prompt: np.ndarray,
                  timeout: float = 30.0) -> bytes:
    """POST the prompt to ``/v1/prefill`` and return the raw shipment bytes
    (an HTTP error status raises ShipmentError; a connection failure
    raises OSError).

    ``url`` may point at a prefill replica or at the cluster router, which
    forwards to a live prefill-tier member (``router.prefill_forwards``),
    so prefill-tier membership changes stay invisible to decode replicas.
    A path in ``url`` is kept as a prefix (``http://router:8080/v1/prefill``
    works); a bare host:port gets ``/v1/prefill`` appended."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlparse(url)
    path = u.path.rstrip("/")
    if not path.endswith("/v1/prefill"):
        path = path + "/v1/prefill"
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=timeout)
    try:
        body = json.dumps(
            {"prompt": [int(t) for t in np.asarray(prompt).reshape(-1)]}
        ).encode("utf-8")
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise ShipmentError(
                f"prefill tier {url} answered {resp.status}: "
                f"{data[:200]!r}")
        return data
    finally:
        conn.close()

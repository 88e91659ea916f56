"""`.safetensors` files read and written with numpy alone.

The card's host may not have the `safetensors` package, so the port reads
HF weights (HuBERT, the TWIST base LM) and writes its HF export with this
module. The format: an 8-byte little-endian header length, a JSON header
mapping each tensor's name to its dtype, shape and byte range, then the
tensors' bytes back to back.
"""
from __future__ import annotations

import json
from typing import Mapping, Optional

import numpy as np

_DTYPES = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "I64": np.int64,
           "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8, "BOOL": np.bool_}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_safetensors(path: str) -> dict:
    """A `.safetensors` file as name -> numpy array (bf16 is widened to
    float32, which holds every bf16 value exactly); the arrays are views of
    one buffer read from the file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = bytearray(f.read())     # writable, so the arrays are too
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        lo, hi = info["data_offsets"]
        raw = data[lo:hi]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
            arr = bits.view(np.float32)
        else:
            arr = np.frombuffer(raw, _DTYPES[info["dtype"]])
        out[name] = arr.reshape(info["shape"])
    return out


def write_safetensors(path: str, tensors: Mapping[str, np.ndarray],
                      metadata: Optional[Mapping[str, str]] = None):
    """Write name -> numpy array as a `.safetensors` file, tensors in name
    order. Each array is written in C order; the header is padded with
    blanks to a multiple of 8 bytes, as the safetensors package does."""
    header, chunks, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = dict(metadata)
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        raw = arr.tobytes()
        header[name] = {"dtype": _NAMES[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for raw in chunks:
            f.write(raw)

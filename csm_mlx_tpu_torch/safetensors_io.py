"""A small pure-Python reader and writer of the safetensors format.

The machine with the card has no `safetensors` package, so the port reads
and writes the files itself. The format: an 8-byte little-endian length N,
N bytes of a JSON header mapping each tensor's name to its "dtype",
"shape" and "data_offsets" [begin, end) (relative to the end of the
header; an optional "__metadata__" maps strings to strings), then the raw
little-endian bytes of the tensors. The writer pads the header with spaces
to a multiple of 8 bytes and lays the tensors out in name order, as the
`safetensors` package accepts and writes them.
"""

from __future__ import annotations

import json
import struct
import sys
from typing import Dict, Optional

import torch

DTYPES = {
    "F32": torch.float32,
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "I8": torch.int8,
    "I32": torch.int32,
    "U8": torch.uint8,
}
_CODES = {v: k for k, v in DTYPES.items()}

if sys.byteorder != "little":
    raise ImportError("safetensors_io reads and writes little-endian hosts only")


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (name -> tensor of a type in DTYPES) to `path`. Each
    tensor's bytes go to the file from its own (host) memory, one tensor
    at a time: no copy of the whole file is held, and the writes run
    without the interpreter lock."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name in sorted(tensors):
        t = tensors[name]
        if t.dtype not in _CODES:
            raise ValueError(f"{name}: dtype {t.dtype} is not one of "
                             f"{sorted(_CODES.values(), key=str)}")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in sorted(tensors):
            t = tensors[name].detach().to("cpu").contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def load_file(path: str, device: torch.device | str = "cpu"
              ) -> Dict[str, torch.Tensor]:
    """Read every tensor of a safetensors file onto `device`."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: not a safetensors file (too short)")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} past the end of the file")
    header = json.loads(data[8:8 + n].decode())
    buf = memoryview(data)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}; "
                             f"this reader takes {sorted(DTYPES)}")
        dtype = DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        count = 1
        for s in shape:
            count *= s
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: {name} spans {end - begin} bytes, "
                             f"not {count} x {dtype}")
        raw = bytearray(buf[begin:end])
        t = (torch.frombuffer(raw, dtype=dtype, count=count) if count
             else torch.empty((0,), dtype=dtype))
        out[name] = t.reshape(shape).to(device)
    return out

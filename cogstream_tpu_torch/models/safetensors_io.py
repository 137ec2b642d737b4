"""A reader and writer of the safetensors format, with no dependency
beyond numpy and torch.

The format: an 8-byte little-endian header length ``n``, a JSON header
of ``n`` bytes (``{name: {"dtype", "shape", "data_offsets": [begin,
end]}}`` plus an optional ``"__metadata__"`` map of strings, padded
with spaces to a multiple of 8), then the raw little-endian buffers,
offsets counted from the end of the header.

The writer lays a file out as the ``safetensors`` package does
(tensors sorted by dtype, widest first, then by name; compact JSON;
the same padding), so its files are byte-identical to the package's
for the same tensors (tests/test_torch_checkpoint.py holds them to it).
The reader maps each tensor's bytes on its own with ``numpy.memmap``
(copy-on-write) and returns a tensor over the mapped pages, which are
unmapped when the tensor is dropped. A loader that copies each tensor
to its device and drops it before the next holds one tensor's pages in
host memory at a time, and no copy of them. bf16 has no numpy dtype:
it is read as uint16 and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

# safetensors dtype name -> (numpy storage dtype, torch dtype)
DTYPES = {
    "BOOL": (np.bool_, torch.bool),
    "U8": (np.uint8, torch.uint8),
    "I8": (np.int8, torch.int8),
    "I16": (np.int16, torch.int16),
    "U16": (np.uint16, torch.uint16),
    "F16": (np.float16, torch.float16),
    "BF16": (np.uint16, torch.bfloat16),
    "I32": (np.int32, torch.int32),
    "U32": (np.uint32, torch.uint32),
    "F32": (np.float32, torch.float32),
    "F64": (np.float64, torch.float64),
    "I64": (np.int64, torch.int64),
    "U64": (np.uint64, torch.uint64),
}
# the package's dtype order (its Dtype enum, by alignment); the writer
# emits the widest dtype first
_RANK = {name: i for i, name in enumerate(DTYPES)}
_NAME = {tdt: name for name, (_, tdt) in DTYPES.items()}


def _header(tensors: Mapping[str, torch.Tensor],
            metadata: Optional[Dict[str, str]]):
    order = sorted(tensors, key=lambda k: (-_RANK[_dtype_name(tensors[k])], k))
    head: Dict[str, object] = {}
    if metadata is not None:
        head["__metadata__"] = dict(metadata)
    offset = 0
    for name in order:
        t = tensors[name]
        size = t.numel() * t.element_size()
        head[name] = {"dtype": _dtype_name(t), "shape": list(t.shape),
                      "data_offsets": [offset, offset + size]}
        offset += size
    raw = json.dumps(head, separators=(",", ":"),
                     ensure_ascii=False).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    return order, raw


def _dtype_name(t: torch.Tensor) -> str:
    try:
        return _NAME[t.dtype]
    except KeyError:
        raise ValueError(f"safetensors has no dtype for {t.dtype}") from None


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (on any device; each is copied to the host on
    its own when its bytes are written) to ``path``, through a temporary
    file renamed into place."""
    order, raw = _header(tensors, metadata)
    tmp = path + ".part"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for name in order:
                t = tensors[name].detach()
                if t.numel():
                    f.write(t.reshape(-1).contiguous().cpu()
                            .view(torch.uint8).numpy())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class SafeTensorsFile:
    """One safetensors file, read one tensor at a time."""

    def __init__(self, path: str):
        self.path = path
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file")
            (n,) = struct.unpack("<Q", head)
            if n > size - 8:
                raise ValueError(f"{path}: header length {n} beyond the "
                                 f"file ({size} bytes)")
            header = json.loads(f.read(n).decode("utf-8"))
        self.metadata = header.pop("__metadata__", None)
        self.entries: Dict[str, dict] = header
        self._data_len = size - 8 - n
        self._offset = 8 + n
        for name, e in header.items():
            begin, end = e["data_offsets"]
            if e["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has unsupported dtype "
                                 f"{e['dtype']}")
            item = np.dtype(DTYPES[e["dtype"]][0]).itemsize
            if (not 0 <= begin <= end <= self._data_len
                    or end - begin != item * int(np.prod(e["shape"]))):
                raise ValueError(f"{path}: {name} has offsets {begin, end} "
                                 f"that do not fit {e['dtype']} "
                                 f"{e['shape']}")

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name``: a CPU tensor of its stored dtype over the
        file's mapped pages. Writes to it stay private (copy-on-write);
        the mapping lives as long as the tensor."""
        e = self.entries[name]
        np_dt, torch_dt = DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        if end == begin:
            return torch.empty(e["shape"], dtype=torch_dt)
        mapped = np.memmap(self.path, dtype=np_dt, mode="c",
                           offset=self._offset + begin,
                           shape=((end - begin) // np.dtype(np_dt).itemsize,))
        out = torch.from_numpy(mapped.reshape(e["shape"]))
        return out.view(torch_dt) if torch_dt != out.dtype else out


class CheckpointReader(Mapping):
    """name → CPU tensor over an HF checkpoint directory: the shards of
    ``model.safetensors.index.json``, or the single
    ``model.safetensors``. Each lookup maps exactly one tensor of its
    shard (:meth:`SafeTensorsFile.get`); nothing is cached."""

    INDEX = "model.safetensors.index.json"
    SINGLE = "model.safetensors"

    def __init__(self, model_dir: str):
        self.dir = model_dir
        self._files: Dict[str, SafeTensorsFile] = {}
        index = os.path.join(model_dir, self.INDEX)
        if os.path.exists(index):
            with open(index) as f:
                self._map = dict(json.load(f)["weight_map"])
        else:
            self._map = {name: self.SINGLE
                         for name in self._file(self.SINGLE).keys()}

    def _file(self, shard: str) -> SafeTensorsFile:
        if shard not in self._files:
            self._files[shard] = SafeTensorsFile(
                os.path.join(self.dir, shard))
        return self._files[shard]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._file(self._map[name]).get(name)

    def __contains__(self, name) -> bool:
        return name in self._map

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def __len__(self) -> int:
        return len(self._map)

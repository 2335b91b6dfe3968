"""Minimal MosaicML-Streaming (MDS) shard format reader/writer.

The reference's second data source is MDS-on-GCS via the
``mosaicml-streaming`` package (reference: data/datasets.py:159-182,
tools/mds_tool.py). That package isn't bundled here, so this module
implements the MDS v2 on-disk format directly:

- ``index.json``: ``{"version": 2, "shards": [<shard meta>, ...]}`` where
  each shard meta carries ``column_names`` / ``column_encodings`` /
  ``column_sizes`` / ``raw_data.basename`` / ``samples``.
- ``shard.NNNNN.mds``: ``[uint32 n][uint32 offsets (n+1, absolute)][data]``;
  each sample is ``[uint32 sizes of variable-width columns][column bytes]``.

Which is what ``streaming.MDSWriter`` produces (no compression/hashing), so
shards written here load with the real package and vice versa for the
standard encodings (str, bytes, int, uint32, float32/64, json, pkl, and
fixed ``ndarray:<dtype>:<shape>``). The self-describing ``ndarray`` encoding
uses a repo-specific JSON header and is NOT byte-compatible with
mosaicml-streaming's binary ndarray header — use the fixed form for interop.
Remote (gs://, s3://) paths use ``streaming.StreamingDataset`` when the
package is importable and fail with a clear message otherwise; local
directories always work through the in-repo reader.

Supported encodings: str, bytes, int (int64-le), uint32-le, float32/float64,
json, pkl, and ndarray:<dtype>:<shape> (fixed) / ndarray (self-describing).
"""

from __future__ import annotations

import json
import os
import pickle
import random
import struct
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

INDEX_BASENAME = "index.json"


# -- column encodings ---------------------------------------------------------


def _encode(encoding: str, value: Any) -> bytes:
    if encoding == "str":
        return str(value).encode("utf-8")
    if encoding == "bytes":
        return bytes(value)
    if encoding == "int":
        return struct.pack("<q", int(value))
    if encoding == "uint32":
        return struct.pack("<I", int(value))
    if encoding == "float32":
        return struct.pack("<f", float(value))
    if encoding == "float64":
        return struct.pack("<d", float(value))
    if encoding == "json":
        return json.dumps(value, ensure_ascii=False).encode("utf-8")
    if encoding == "pkl":
        return pickle.dumps(value)
    if encoding.startswith("ndarray:"):
        _, dtype, *shape = encoding.split(":")
        if not shape:
            raise ValueError(
                "ndarray:<dtype> without a shape would silently flatten on "
                "decode; use ndarray:<dtype>:<d0,d1,...> or the "
                "self-describing 'ndarray' encoding"
            )
        arr = np.ascontiguousarray(np.asarray(value, dtype=dtype))
        want = tuple(int(s) for s in shape[0].split(","))
        assert arr.shape == want, (arr.shape, want)
        return arr.tobytes()
    if encoding == "ndarray":
        arr = np.ascontiguousarray(np.asarray(value))
        header = json.dumps(
            {"dtype": str(arr.dtype), "shape": list(arr.shape)}
        ).encode("utf-8")
        return struct.pack("<I", len(header)) + header + arr.tobytes()
    raise ValueError(f"unsupported MDS encoding {encoding!r}")


def _decode(encoding: str, data: bytes) -> Any:
    if encoding == "str":
        return data.decode("utf-8")
    if encoding == "bytes":
        return data
    if encoding == "int":
        return struct.unpack("<q", data)[0]
    if encoding == "uint32":
        return struct.unpack("<I", data)[0]
    if encoding == "float32":
        return struct.unpack("<f", data)[0]
    if encoding == "float64":
        return struct.unpack("<d", data)[0]
    if encoding == "json":
        return json.loads(data.decode("utf-8"))
    if encoding == "pkl":
        return pickle.loads(data)
    if encoding.startswith("ndarray:"):
        _, dtype, *shape = encoding.split(":")
        arr = np.frombuffer(data, dtype=dtype)
        if shape:
            arr = arr.reshape(tuple(int(s) for s in shape[0].split(",")))
        return arr
    if encoding == "ndarray":
        (hlen,) = struct.unpack("<I", data[:4])
        header = json.loads(data[4 : 4 + hlen].decode("utf-8"))
        return np.frombuffer(
            data[4 + hlen :], dtype=header["dtype"]
        ).reshape(header["shape"])
    raise ValueError(f"unsupported MDS encoding {encoding!r}")


def _fixed_size(encoding: str) -> Optional[int]:
    """Byte width of fixed-size encodings; None = variable."""
    if encoding == "int":
        return 8
    if encoding == "uint32":
        return 4
    if encoding == "float32":
        return 4
    if encoding == "float64":
        return 8
    if encoding.startswith("ndarray:"):
        parts = encoding.split(":")
        if len(parts) == 3:
            n = int(np.prod([int(s) for s in parts[2].split(",")]))
            return n * np.dtype(parts[1]).itemsize
    return None


# -- writer --------------------------------------------------------------------


class MDSWriter:
    """Write MDS shards compatible with ``streaming.MDSWriter`` (no
    compression / hashing)."""

    def __init__(
        self,
        out_dir: str,
        columns: Dict[str, str],
        *,
        size_limit: int = 1 << 26,
    ):
        self.out_dir = out_dir
        self.columns = dict(columns)
        self.size_limit = size_limit
        self._names = list(columns)
        self._encodings = [columns[n] for n in self._names]
        self._sizes = [_fixed_size(e) for e in self._encodings]
        self._samples: List[bytes] = []
        self._bytes = 0
        self._shards: List[Dict[str, Any]] = []
        os.makedirs(out_dir, exist_ok=True)

    def write(self, sample: Dict[str, Any]) -> None:
        sizes = []
        blobs = []
        for name, enc, fixed in zip(self._names, self._encodings, self._sizes):
            blob = _encode(enc, sample[name])
            if fixed is None:
                sizes.append(len(blob))
            elif len(blob) != fixed:
                raise ValueError(
                    f"column {name}: {len(blob)} bytes != fixed {fixed}"
                )
            blobs.append(blob)
        encoded = np.asarray(sizes, np.uint32).tobytes() + b"".join(blobs)
        self._samples.append(encoded)
        self._bytes += len(encoded)
        if self._bytes >= self.size_limit:
            self._flush_shard()

    def _flush_shard(self) -> None:
        if not self._samples:
            return
        n = len(self._samples)
        lens = np.asarray([0] + [len(s) for s in self._samples], np.uint32)
        offsets = lens.cumsum().astype(np.uint32)
        offsets += 4 + offsets.nbytes
        payload = (
            struct.pack("<I", n) + offsets.tobytes() + b"".join(self._samples)
        )
        basename = f"shard.{len(self._shards):05}.mds"
        with open(os.path.join(self.out_dir, basename), "wb") as f:
            f.write(payload)
        self._shards.append(
            {
                "column_encodings": self._encodings,
                "column_names": self._names,
                "column_sizes": self._sizes,
                "compression": None,
                "format": "mds",
                "hashes": [],
                "raw_data": {
                    "basename": basename,
                    "bytes": len(payload),
                    "hashes": {},
                },
                "samples": n,
                "size_limit": self.size_limit,
                "version": 2,
                "zip_data": None,
            }
        )
        self._samples = []
        self._bytes = 0

    def finish(self) -> str:
        self._flush_shard()
        with open(os.path.join(self.out_dir, INDEX_BASENAME), "w") as f:
            json.dump({"version": 2, "shards": self._shards}, f)
        return self.out_dir

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.finish()


# -- reader --------------------------------------------------------------------


class _Shard:
    def __init__(self, directory: str, meta: Dict[str, Any]):
        self.path = os.path.join(directory, meta["raw_data"]["basename"])
        self.meta = meta
        self.samples = int(meta["samples"])
        self._offsets: Optional[np.ndarray] = None

    def _load_offsets(self) -> np.ndarray:
        if self._offsets is None:
            with open(self.path, "rb") as f:
                (n,) = struct.unpack("<I", f.read(4))
                assert n == self.samples, (n, self.samples)
                self._offsets = np.frombuffer(
                    f.read(4 * (n + 1)), np.uint32
                )
        return self._offsets

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        offsets = self._load_offsets()
        start, end = int(offsets[idx]), int(offsets[idx + 1])
        with open(self.path, "rb") as f:
            f.seek(start)
            data = f.read(end - start)
        meta = self.meta
        names = meta["column_names"]
        encodings = meta["column_encodings"]
        fixed = meta["column_sizes"]
        n_var = sum(1 for s in fixed if s is None)
        var_sizes = np.frombuffer(data[: 4 * n_var], np.uint32)
        pos = 4 * n_var
        out: Dict[str, Any] = {}
        vi = 0
        for name, enc, size in zip(names, encodings, fixed):
            if size is None:
                size = int(var_sizes[vi])
                vi += 1
            out[name] = _decode(enc, data[pos : pos + size])
            pos += size
        return out


class LocalMDSDataset:
    """Random-access + iterable view over a local MDS directory
    (drop-in for ``streaming.StreamingDataset`` on local data)."""

    def __init__(
        self,
        local: str,
        *,
        shuffle: bool = False,
        shuffle_seed: int = 42,
        split: Optional[str] = None,
    ):
        directory = os.path.join(local, split) if split else local
        index_path = os.path.join(directory, INDEX_BASENAME)
        if not os.path.isfile(index_path):
            raise FileNotFoundError(f"no MDS index at {index_path}")
        with open(index_path) as f:
            index = json.load(f)
        self.shards = [_Shard(directory, m) for m in index["shards"]]
        self.shuffle = shuffle
        self.shuffle_seed = shuffle_seed
        self._epoch = 0
        self._cum = np.cumsum([0] + [s.samples for s in self.shards])

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        shard_i = int(np.searchsorted(self._cum, idx, side="right") - 1)
        return self.shards[shard_i][idx - int(self._cum[shard_i])]

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        order = list(range(len(self)))
        if self.shuffle:
            # fresh permutation per epoch (StreamingDataset semantics):
            # fixed seed + epoch counter, so runs are reproducible but
            # epochs differ
            random.Random(self.shuffle_seed * 1_000_003 + self._epoch).shuffle(order)
            self._epoch += 1
        for i in order:
            yield self[i]


def load_mds_dataset(
    path: str,
    *,
    split: Optional[str] = None,
    shuffle: bool = False,
    shuffle_seed: int = 42,
    local_cache: Optional[str] = None,
    batch_size: int = 1,
):
    """MDS dataset from a local dir or remote (gs://, s3://) URL.

    Remote URLs require the ``mosaicml-streaming`` package (reference:
    datasets.py:159-182); local directories use the in-repo reader."""
    is_remote = "://" in path
    if is_remote:
        try:
            from streaming import StreamingDataset
        except ImportError as e:
            raise ImportError(
                "remote MDS streaming requires mosaicml-streaming "
                f"(pip install mosaicml-streaming) for {path}"
            ) from e
        import tempfile

        local = local_cache or os.path.join(
            tempfile.gettempdir(),
            "mds_" + path.replace("://", "_").replace("/", "_"),
        )
        return StreamingDataset(
            remote=path,
            local=local,
            split=split,
            batch_size=batch_size,
            shuffle=shuffle,
            shuffle_seed=shuffle_seed,
        )
    return LocalMDSDataset(
        path, split=split, shuffle=shuffle, shuffle_seed=shuffle_seed
    )

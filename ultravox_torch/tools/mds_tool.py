"""HF → MosaicML-MDS conversion (reference: tools/mds_tool.py).

Converts an HF dataset into MDS shards for high-throughput streaming.
Local output uses the in-repo shard writer (``data/mds.py`` — format
compatible with ``streaming.MDSWriter`` without compression); remote
(gs://, s3://) output or compression requires ``mosaicml-streaming``.
"""

from __future__ import annotations

import argparse
from typing import Optional


def convert_to_mds(
    dataset,
    out_dir: str,
    audio_column: str = "audio",
    compression: Optional[str] = None,
) -> str:
    import numpy as np

    from ultravox_torch.data.sample import SAMPLE_RATE, audio_to_wav_bytes

    columns = {}
    first = dataset[0]
    for key, value in first.items():
        if key == audio_column:
            columns[key] = "bytes"
        elif isinstance(value, str):
            columns[key] = "str"
        elif isinstance(value, bool):
            columns[key] = "json"
        elif isinstance(value, int):
            columns[key] = "int"
        else:
            columns[key] = "json"

    remote = "://" in out_dir
    if remote or compression:
        try:
            from streaming import MDSWriter
        except ImportError as e:
            raise ImportError(
                "remote/compressed MDS output requires mosaicml-streaming: "
                "pip install mosaicml-streaming"
            ) from e

        writer = MDSWriter(out=out_dir, columns=columns, compression=compression)
    else:
        from ultravox_torch.data.mds import MDSWriter as LocalWriter

        writer = LocalWriter(out_dir, columns)

    with writer as w:
        for row in dataset:
            out = {}
            for key, value in row.items():
                if key == audio_column and isinstance(value, dict):
                    arr = np.asarray(value["array"], dtype=np.float32)
                    sr = int(value.get("sampling_rate", SAMPLE_RATE))
                    out[key] = audio_to_wav_bytes(arr, sr)
                else:
                    out[key] = value
            w.write(out)
    return out_dir


def main():
    from ultravox_torch.data.datasets import _load_hf_dataset

    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--subset", default=None)
    parser.add_argument("--split", default="train")
    parser.add_argument("--out", required=True, help="local dir or gs:// url")
    parser.add_argument("--audio_column", default="audio")
    parser.add_argument("--compression", default=None)
    args = parser.parse_args()
    ds = _load_hf_dataset(args.dataset, args.subset, split=args.split, streaming=False)
    print(convert_to_mds(ds, args.out, args.audio_column, args.compression))


if __name__ == "__main__":
    main()

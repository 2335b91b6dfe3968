"""Pre-download model weights before a multi-host job starts
(reference: training/helpers/prefetch_weights.py:31-88 — parallel
snapshot_download before torchrun spawns).

Run it once per host (or on a shared filesystem) before launching
training, so every process finds the checkpoints locally: ``python -m
ultravox_torch.training.prefetch_weights --models <hub id> ...``. Local
paths (starting with ``/``) are skipped; ``huggingface_hub`` is imported
at the first download.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import logging
from typing import List, Optional

from ultravox_torch.utils.retry import retry

logger = logging.getLogger(__name__)


@retry(max_attempts=5)
def _download(model_id: str, cache_dir: Optional[str] = None) -> str:
    from huggingface_hub import snapshot_download

    return snapshot_download(model_id, cache_dir=cache_dir)


def download_weights(
    model_ids: List[str], cache_dir: Optional[str] = None
) -> List[str]:
    todo = [m for m in model_ids if m and not m.startswith("/")]
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        return list(pool.map(lambda m: _download(m, cache_dir), todo))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--models", nargs="+", required=True)
    parser.add_argument("--cache_dir", default=None)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    for path in download_weights(args.models, args.cache_dir):
        print(path)


if __name__ == "__main__":
    main()

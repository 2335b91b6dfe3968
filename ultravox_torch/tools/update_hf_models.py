"""Sync standalone model code + config updates into published HF repos.

Counterpart of the reference's tools/update_hf_models.py:1-147: discovers
the account's published ultravox repos, uploads the standalone torch model
code (``ultravox_torch/hub``, kept there as ``<name>.py.txt`` and uploaded
as ``<name>.py``: ultravox_config.py, ultravox_model.py,
ultravox_processing.py, ultravox_tokenizer.py, ultravox_pipeline.py) so
every repo keeps loading with ``trust_remote_code`` as the code evolves,
and applies config.json changes (auto_map entries are always kept in sync;
arbitrary ``key=value`` overrides via --config_changes, e.g.
``torch_dtype=bfloat16``).

The HfApi is injectable for offline tests; every mutation goes through ONE
``create_commit`` per repo so a sync is atomic per repo.

CLI: ``python -m ultravox_torch.tools.update_hf_models --author <org>
--dry_run`` (``huggingface_hub`` and a token, e.g. ``HF_TOKEN``, at run
time).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence

from ultravox_torch import hub

logger = logging.getLogger(__name__)


def discover_repos(
    api, *, query: str = "ultravox-", author: Optional[str] = None,
    public_only: bool = True,
) -> List[str]:
    """Repo ids matching the query (reference: list_models w/ stable sort,
    update_hf_models.py:55-63)."""
    models = api.list_models(
        search=query, author=author, sort="created_at", direction=None
    )
    out = []
    for m in models:
        if public_only and getattr(m, "private", False):
            continue
        out.append(m.id if hasattr(m, "id") else str(m))
    return out


def updated_config_bytes(
    api, repo_id: str, config_changes: Sequence[str], tmp_dir: str
) -> bytes:
    """Download the repo's config.json, apply key=value changes, and keep
    the auto_map pointed at the synced code files."""
    path = api.hf_hub_download(
        repo_id=repo_id, filename="config.json", local_dir=tmp_dir
    )
    with open(path) as f:
        config: Dict[str, Any] = json.load(f)
    for change in config_changes:
        key, _, value = change.partition("=")
        try:
            value = json.loads(value)
        except json.JSONDecodeError:
            pass
        config[key.strip()] = value
    config["auto_map"] = dict(hub.AUTO_MAP)
    return json.dumps(config, indent=2).encode()


def sync_repo(
    api,
    repo_id: str,
    *,
    config_changes: Sequence[str] = (),
    commit_message: str = "Update model code",
    dry_run: bool = False,
) -> List[str]:
    """Upload the hub code files + updated config.json in one commit.
    Returns the in-repo paths touched."""
    from huggingface_hub import CommitOperationAdd

    operations = [
        CommitOperationAdd(
            path_in_repo=fname,
            path_or_fileobj=os.path.join(hub.HUB_CODE_DIR, fname + hub.STORED_SUFFIX),
        )
        for fname in hub.HUB_CODE_FILES
    ]
    with tempfile.TemporaryDirectory() as tmp:
        operations.append(
            CommitOperationAdd(
                path_in_repo="config.json",
                path_or_fileobj=updated_config_bytes(
                    api, repo_id, config_changes, tmp
                ),
            )
        )
        touched = [op.path_in_repo for op in operations]
        if dry_run:
            logger.info("DRY RUN %s: would update %s", repo_id, touched)
            return touched
        api.create_commit(
            repo_id=repo_id,
            operations=operations,
            commit_message=commit_message,
        )
    logger.info("updated %s: %s", repo_id, touched)
    return touched


def main(argv: Optional[List[str]] = None, api=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--repos", nargs="*", default=None,
        help="explicit repo ids (default: discover via --query/--author)",
    )
    parser.add_argument("--query", default="ultravox-")
    parser.add_argument("--author", default=None)
    parser.add_argument("--include_private", action="store_true")
    parser.add_argument(
        "--config_changes", nargs="*", default=[],
        help='key=value updates applied to each repo config.json',
    )
    parser.add_argument("--commit_message", default="Update model code")
    parser.add_argument("--dry_run", action="store_true")
    args = parser.parse_args(argv)

    if api is None:
        from huggingface_hub import HfApi

        api = HfApi()
    repos = args.repos
    if not repos:
        repos = discover_repos(
            api, query=args.query, author=args.author,
            public_only=not args.include_private,
        )
    for repo in repos:
        sync_repo(
            api, repo,
            config_changes=args.config_changes,
            commit_message=args.commit_message,
            dry_run=args.dry_run,
        )
    return repos


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()

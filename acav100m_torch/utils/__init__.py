from .braceexpand import braceexpand
from .shards import node_selection, worker_selection, plan_shards, get_length
from .manifests import get_run_info, get_run_id, write_run_manifest, read_run_manifests

__all__ = [
    "braceexpand",
    "node_selection",
    "worker_selection",
    "plan_shards",
    "get_length",
    "get_run_info",
    "get_run_id",
    "write_run_manifest",
    "read_run_manifests",
]

"""Tiny shapes at which the cells run on the CPU in the tests."""

import time

from benchmark import harness

TINY = {
    "extract.fp32.decoded": {
        "config": {"extract": {"num_frames": 8, "size": 32, "duration": 2, "batch_size": 2}},
        "traffic": {"distinct_clips": 3, "shards": 2, "members_per_shard": 3,
                    "warmup_members": 2, "check_rows": 2}},
    "cluster.fp32.k32": {
        "config": {"cluster": {"batch_size": 16, "ncentroids": 4}},
        "traffic": {"shards": 2, "rows_per_shard": 40}},
    "select.fp32.batch_mi": {"traffic": {"shards": 2, "rows_per_shard": 60}},
}
TINY["extract.bf16.decoded"] = TINY["extract.fp32.decoded"]


def run_tiny(workload, seed=2 ** 31 + 12345, trace=False, hook=None, overrides=None,
             cuda=False):
    """One run at tiny shapes: on the CPU, or on the card with ``cuda``."""
    ov = harness.merge(TINY[workload], overrides)
    return harness.run_cell(workload, seed, 0.5, trace, time.perf_counter(),
                            require_cuda=cuda, overrides=ov, stage_hook=hook)

"""A cell, a traffic mix and a per-layer metric are added by adding files
and entries alone: a throwaway copy of the benchmark gains them and runs
the new cell without a line of the harness edited."""

import json
import shutil
import time

from benchmark import harness
from benchmark.tests.common import TINY


def test_throwaway_cell_from_files(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(harness.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    # a new mix: a smaller pool
    mix = json.loads((bench / "traffic" / "assignment_shards.json").read_text())
    mix.update(shards=2, rows_per_shard=50)
    (bench / "traffic" / "assignment_small.json").write_text(json.dumps(mix))
    (bench / "workloads" / "select.fp32.small.json").write_text(
        (bench / "workloads" / "select.fp32.batch_mi.json").read_text())
    spec["workloads"].append({"name": "select.fp32.small", "config": "sf8x8r50_vggish.fp32",
                              "traffic": "assignment_small", "chips": 1, "why": "a test"})
    # a new per-layer metric, read by its own file
    (bench / "metrics" / "select.calls.py").write_text("def read(run):\n    return run.calls\n")
    spec["per_layer"].append({"name": "select.calls", "unit": "calls", "better": "higher",
                              "source": "program_counter", "layer": "stage-6 compute",
                              "moves": "select_clips_per_s", "workloads": ["select.fp32.small"]})
    for m in spec["end_to_end"]:
        if m["name"] == "select_clips_per_s":
            m["workloads"].append("select.fp32.small")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.setattr(harness, "BENCH", bench)
    for trace in (False, True):
        result = harness.run_cell("select.fp32.small", 77, 0.2, trace, time.perf_counter(),
                                  require_cuda=False, overrides=TINY["select.fp32.batch_mi"])
        assert result["correct"], result["checks"]
        want = {"select.calls"} if trace else {"select_clips_per_s", "setup_s"}
        assert want <= set(result["metrics"])

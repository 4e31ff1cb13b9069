"""The benchmark's driver: one run of one cell.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json`` names a configuration (``configs/<config>.json``) and a
traffic mix (``traffic/<traffic>.json``); the mix names the stage whose
window loop and plain reference live in ``stages/<stage>.py``; the cell's
comparison limits are in ``workloads/<cell>.json``; each metric is read by
``metrics/<metric>.py``. Adding a cell, a configuration, a mix or a metric
is adding files and entries, never editing one. ``pending.json`` holds
cells (and their metrics) kept out of ``BENCHMARK.json``, which still run
by name.

A run: set-up (the stage makes its traffic and weights from the seed and
warms up at the cell's shapes), then whole calls of the stage's entry for
``--seconds`` (under ``torch.profiler`` with ``--trace 1``), then the
program's state is freed, the plain reference judges the window's outputs,
and one JSON line is printed last on standard output.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# whole top-level module names that may not be loaded once the window has
# closed (the port's name begins with the JAX package's, so compare whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "acav100m_tpu")


class RunError(Exception):
    """A run that must end without a result line."""


def load_module(path: Path, name: Optional[str] = None):
    spec = importlib.util.spec_from_file_location(name or f"portbench_{path.stem}", path)
    if spec is None:
        raise RunError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


def merge(base: Dict, over: Optional[Dict]) -> Dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = dict(base)
    for key, val in (over or {}).items():
        out[key] = merge(out[key], val) if isinstance(val, dict) and isinstance(
            out.get(key), dict) else val
    return out


def dotted(tree: Dict, prefix: str = "") -> Dict:
    """Nested overrides -> the program's dotted keys (a nested dict given
    to its ``build_config`` would replace the whole group)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(dotted(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = val
    return out


def subseed(seed: int, label: str) -> int:
    """A 31-bit seed for one use (``label``) derived from the run's seed,
    which may be wider than 32 bits."""
    import zlib

    return (int(seed) * 1000003 + zlib.crc32(label.encode())) % (2 ** 31 - 1)


def applies(metric: Dict, cell: Dict, e2e_names: List[str]) -> bool:
    if "workloads" in metric:
        return cell["name"] in metric["workloads"]
    if "moves" in metric:  # a per-layer metric: every cell reporting what it moves
        return metric["moves"] in e2e_names
    return True


def read_spec() -> Dict:
    """``BENCHMARK.json`` with the cells and metrics of ``pending.json``
    that it does not name: cells kept out of the benchmark, which still run
    by name (and are tested) until a later benchmark takes them up."""
    spec = read_json(ROOT / "BENCHMARK.json")
    pending = BENCH / "pending.json"
    if pending.is_file():
        extra = read_json(pending)
        for group in ("workloads", "end_to_end", "per_layer"):
            names = {entry["name"] for entry in spec[group]}
            spec[group] = spec[group] + [e for e in extra[group] if e["name"] not in names]
    return spec


def load_cell(workload: str, overrides: Optional[Dict] = None) -> SimpleNamespace:
    """The cell's entry, configuration, traffic mix, limits and metrics, by
    name. ``overrides`` (tests and the control) replace keys of the
    configuration (``config``), the mix (``traffic``) or the limits."""
    overrides = overrides or {}
    spec = read_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"no workload {workload!r} in BENCHMARK.json or pending.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = merge(read_json(ROOT / configs[cell["config"]]["file"]), overrides.get("config"))
    traffic = merge(read_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
                    overrides.get("traffic"))
    limits = merge(read_json(BENCH / "workloads" / f"{workload}.json")["limits"],
                   overrides.get("limits"))
    e2e = [m for m in spec["end_to_end"] if applies(m, cell, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in spec["per_layer"] if applies(m, cell, e2e_names)]
    return SimpleNamespace(cell=cell, config=config, traffic=traffic, limits=limits,
                           end_to_end=e2e, per_layer=per_layer)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout:
    the port's kernels already build into ``build/``."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def work_dir(workload: str) -> Path:
    """The run's scratch under ``TMPDIR`` (emptied at the start and at the
    end of a run)."""
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    path = base / "portbench" / workload
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def device_info(torch, chips: int, cuda: bool) -> Dict:
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, require_cuda: bool = True,
             overrides: Optional[Dict] = None, stage_hook=None) -> Dict:
    """One run of ``workload``; returns the result line's object.

    ``require_cuda=False`` (the CPU tests) skips the look for a card and runs
    the program on the CPU. ``stage_hook(stage)`` runs after set-up, before
    the window (the tests plant faults with it)."""
    set_cache_dirs()
    spec = load_cell(workload, overrides)
    chips = int(spec.cell["chips"])
    import torch

    if require_cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        raise RunError(f"{workload} needs {chips} CUDA device(s); "
                       f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cuda = require_cuda
    device = torch.device("cuda:0" if cuda else "cpu")
    stage_mod = load_module(BENCH / "stages" / f"{spec.traffic['stage']}.py")
    work = work_dir(workload)
    ctx = SimpleNamespace(config=spec.config, traffic=spec.traffic, limits=spec.limits,
                          seed=int(seed), work=work, device=device, cuda=cuda,
                          subseed=lambda label: subseed(seed, label))
    stage = stage_mod.Stage(ctx)
    try:
        stage.setup()
        if stage_hook is not None:
            stage_hook(stage)
        # the traffic written at set-up reaches the disk in set-up, not as
        # writeback during the window
        os.sync()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start

        tracemod = load_module(BENCH / "tracing.py") if trace else None
        prof, remove_spans = contextlib.nullcontext(), (lambda: None)
        if trace:
            from torch.profiler import ProfilerActivity, profile

            remove_spans = tracemod.install_spans(stage.spans())
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
        calls = 0
        with prof:
            t0 = time.perf_counter()
            while True:
                stage.call(calls)
                calls += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        remove_spans()
        device = device_info(torch, chips, cuda)

        units, attempted = stage.count_units(calls)
        run = SimpleNamespace(setup_s=setup_s, window_s=window_s, calls=calls, units=units,
                              config=spec.config, traffic=spec.traffic,
                              info=stage.layer_info(calls), bench=BENCH,
                              counts=lambda name: load_module(BENCH / "counts" / f"{name}.py"))
        breakdown = None
        if trace:
            timeline = tracemod.Timeline(prof, window_s)
            run.timeline = timeline
            device["busy_s"] = timeline.busy_s
            device["window_s"] = window_s
            breakdown = timeline.breakdown()
            metrics = spec.per_layer
        else:
            metrics = spec.end_to_end
        values = {}
        for m in metrics:
            reader = load_module(BENCH / "metrics" / f"{m['name']}.py")
            value = reader.read(run)
            if value is not None:
                values[m["name"]] = {"value": value, "unit": m["unit"]}

        stage.release()
        checks = stage.check(calls)
    finally:
        stage.close()
        shutil.rmtree(work, ignore_errors=True)
    correct = all(c[1] is not None and math.isfinite(c[1]) and c[1] <= c[2]
                  for c in checks)
    result = {"correct": correct, "attempted": attempted, "failed": attempted - units,
              "metrics": values, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start)
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded after the window: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

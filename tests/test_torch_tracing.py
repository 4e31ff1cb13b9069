"""The port's spans and counters (``acav100m_torch.tracing``): off by
default, on under a running ``torch.profiler`` profile or ``enabled()``,
stamped on the profiler's clock, and recorded by stages 4 and 6 where their
work happens."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from acav100m_torch import cli as tcli
from acav100m_torch import tracing
from acav100m_torch.pipeline import feature_extraction as tfe
from acav100m_torch.pipeline import subset_selection as tss
from acav100m_torch.utils.io import dump_pickle
from acav100m_torch.utils.manifests import write_run_manifest

torch.set_num_threads(1)


def _names(records):
    return {s.name for s in records}


def test_off_records_nothing():
    with tracing.enabled():
        tracing.count("before")
    with tracing.span("span.test.off", unit=1) as s:
        tracing.count("test.off")
    assert s is None
    assert tracing.on() is False
    # what the last window recorded stays until tracing turns on again
    assert tracing.counters() == {"before": 1} and tracing.spans() == []


def test_on_under_a_profile_and_inside_enabled_each_turn_emptying_both():
    with tracing.enabled():
        assert tracing.on()
        with tracing.span("span.test.first"):
            tracing.count("test.n", 2)
        with tracing.enabled():  # nested: already on, nothing emptied
            tracing.count("test.n")
    assert _names(tracing.spans()) == {"span.test.first"}
    assert tracing.counters() == {"test.n": 3}
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.on()  # torch.autograd.profiler._is_profiler_enabled
        with tracing.span("span.test.profiled"):
            tracing.count("test.m")
    assert not tracing.on()
    assert _names(tracing.spans()) == {"span.test.profiled"}
    assert tracing.counters() == {"test.m": 1}
    with tracing.enabled():
        assert tracing.spans() == [] and tracing.counters() == {}


def test_threads_parents_units_and_self_time():
    def feed():
        with tracing.span("span.test.load", unit=7):
            with tracing.span("span.test.decode"):
                time.sleep(0.002)

    with tracing.enabled():
        with tracing.span("span.test.batch", unit=7, shard="a"):
            with tracing.span("span.test.wait"):
                worker = threading.Thread(target=feed)
                worker.start()
                worker.join(timeout=10)
            with tracing.span("span.test.rows"):
                time.sleep(0.003)
            time.sleep(0.004)
        with tracing.span("span.test.tail"):
            pass
    assert not worker.is_alive()
    by = {s.name: s for s in tracing.spans()}
    batch, wait, rows, decode = (by[f"span.test.{n}"] for n in ("batch", "wait", "rows", "decode"))
    assert batch.parent is None and batch.attrs == {"shard": "a"}
    assert wait.parent == batch.id and rows.parent == batch.id
    assert decode.parent == by["span.test.load"].id and by["span.test.load"].parent is None
    assert decode.thread != batch.thread == wait.thread
    assert {s.unit for s in (batch, wait, rows, decode)} == {7}
    assert by["span.test.tail"].unit is None
    assert batch.start_ns <= wait.start_ns <= decode.start_ns <= decode.end_ns <= wait.end_ns
    assert wait.end_ns <= rows.start_ns <= rows.end_ns <= batch.end_ns
    children = (wait.end_ns - wait.start_ns) + (rows.end_ns - rows.start_ns)
    assert tracing.self_ns("span.test.batch") == batch.end_ns - batch.start_ns - children
    assert tracing.self_ns("span.test.batch") >= 4e6
    assert tracing.total_ns("span.test.decode") == decode.end_ns - decode.start_ns


def test_counts_and_spans_from_many_threads_are_all_kept():
    """More threads than cores, switching often: no count or span is lost."""
    import os
    import sys

    threads, rounds = 2 * (os.cpu_count() or 2), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.enabled():
            def work():
                for _ in range(rounds):
                    with tracing.span("span.test.many"):
                        tracing.count("test.many")

            pool = [threading.Thread(target=work) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in pool)
    assert tracing.counters() == {"test.many": threads * rounds}
    records = tracing.spans()
    assert len(records) == threads * rounds == len({s.id for s in records})
    assert all(s.parent is None for s in records)


def test_spans_lie_on_the_profilers_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("span.test.clock"):
            time.sleep(0.002)
    mine = next(s for s in tracing.spans() if s.name == "span.test.clock")
    event = next(e for e in prof.profiler.kineto_results.events()
                 if e.name() == "span.test.clock")
    assert abs(mine.start_ns - event.start_ns()) < 1_000_000
    end = event.start_ns() + event.duration_ns()
    assert abs(mine.end_ns - end) < 1_000_000


EXTRACT_SPANS = {f"span.extract.{n}" for n in (
    "setup", "batch", "feed_wait", "forward", "to_host", "rows", "save_cache", "save_output",
    "finish", "load", "decode", "prepare", "collate", "stage")}


def test_extraction_records_its_spans_and_the_bytes_its_saves_wrote(tmp_path, monkeypatch):
    tcli.main(["fixtures", str(tmp_path / "clips"), "--size=16"])
    cfg = tfe.get_config({"data.media.path": f"{tmp_path}/clips/shard-{{000000..000001}}.tar",
                          "data.output.path": str(tmp_path / "out"), "data.batch_size": 4,
                          "data.media.num_frames": 8, "computation.device": "cpu",
                          "log_period": 0})
    written = []  # (path, size) after each save
    save = tfe.save_shard_cache

    def measured(*args, **kwargs):
        path = save(*args, **kwargs)
        written.append((path, path.stat().st_size))
        return path

    monkeypatch.setattr(tfe, "save_shard_cache", measured)
    with tracing.enabled():
        saved = tfe.run_extraction(cfg)
    records, counts = tracing.spans(), tracing.counters()
    assert EXTRACT_SPANS <= _names(records)
    batches = [s for s in records if s.name == "span.extract.batch"]
    # the last batch span holds the wait that found the loader ended
    assert counts["extract.batches"] == len(batches) - 1 == len(written) == 2
    assert counts["extract.clips"] == 8
    # the bytes each save added to its file
    sizes, added = {}, 0
    for path, size in written:
        added += size - sizes.get(path, 0)
        sizes[path] = size
    assert counts["extract.cache_bytes"] == added > 0
    assert counts["extract.output_bytes"] == sum(p.stat().st_size for p in saved)
    # batch n's feed-thread spans carry the main thread's unit n
    main = batches[0].thread
    for n in (0, 1):
        feed = {s.name for s in records if s.unit == n and s.thread != main}
        assert {"span.extract.load", "span.extract.decode", "span.extract.collate",
                "span.extract.stage"} <= feed
    # every stretch of the main thread from entry to return is in some span
    tops = sorted((s.start_ns, s.end_ns) for s in records
                  if s.thread == main and s.parent is None)
    assert tops[0][1] <= tops[1][0]
    gaps = [b[0] - a[1] for a, b in zip(tops, tops[1:])]
    assert max(gaps) < 5e7, gaps


def _write_assignments(root, shards=2, rows=40, c=8):
    rng = np.random.RandomState(0)
    paths = []
    (root / "meta").mkdir(parents=True)
    for si in range(shards):
        shard, out, meta = f"shard-{si:06d}", [], []
        for ci in range(rows):
            a = rng.randint(0, c, 10)
            fname = f"clip_{si:03d}_{ci:03d}.npz"
            out.append({"filename": fname, "shard_name": shard, "shard_size": rows,
                        "audio_assignments": [{"model_key": "layer_vggish", "array": {
                            f"layer_{i}": int(a[i]) for i in range(5)}}],
                        "video_assignments": [{"model_key": "layer_slowfast", "array": {
                            f"layer_{i}": int(a[5 + i]) for i in range(5)}}]})
            meta.append({"filename": fname, "id": f"v{si}{ci:03d}", "segment": [0.0, 10.0]})
        paths.append(dump_pickle(out, root / "clusters" / f"{shard}.pkl"))
        (root / "meta" / f"{shard}.json").write_text(json.dumps(meta))
    write_run_manifest(root / "clusters", paths)


def test_selection_counts_two_host_reads_an_iteration_at_unchanged_output(tmp_path):
    _write_assignments(tmp_path)

    def select(name):
        cfg = tss.get_config({"data.path": f"{tmp_path}/clusters/shard-{{000000..000001}}.pkl",
                              "data.output.path": str(tmp_path / name / "output.csv"),
                              "data.meta.path": str(tmp_path / "meta"),
                              "computation.device": "cpu", "subset.ratio": 0.3})
        path, count = tss.run(cfg)
        return path.read_bytes(), count

    plain = select("plain")
    folded = []
    run_greedy = tss.BatchGreedySelector.run_greedy

    def recording(self, *args, **kwargs):
        out = run_greedy(self, *args, **kwargs)
        folded.append(len(self.folded_ids))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tss.BatchGreedySelector, "run_greedy", recording)
        with tracing.enabled():
            traced = select("traced")
    assert traced == plain and plain[1] == 24
    counts = tracing.counters()
    assert counts["select.iterations"] == 6
    assert counts["select.host_reads"] == 2 * counts["select.iterations"]
    assert counts["select.picks"] == sum(folded) == 24
    records = tracing.spans()
    iterations = [s for s in records if s.name == "span.select.iteration"]
    assert [s.unit for s in iterations] == list(range(6))
    for name in ("shuffle", "dispatch", "read_picks", "bookkeeping"):
        inner = [s for s in records if s.name == f"span.select.{name}"]
        assert [s.unit for s in inner] == list(range(6))
        assert {s.parent for s in inner} == {s.id for s in iterations}
    assert {f"span.select.{n}" for n in ("load", "format_rows", "build_selector", "start",
                                         "rows", "save_csv")} <= _names(records)

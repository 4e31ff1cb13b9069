"""The extraction's append-only ``_cache.pkl``: after every save the file is
one pickle of the shard's rows so far, which ``pickle.load`` and the JAX
package's ``load_shard_caches`` read; a save pickles only the rows since
the shard's last one, a shard without new rows is not written, a cache the
run did not write is rewritten whole once, and a finished shard's cache
becomes its ``.pkl``. The models are exact stand-ins, so rows compare
bit for bit across runs."""

import io
import json
import pickle
import tarfile

import numpy as np
import pytest

from acav100m_tpu.utils import io as jio
from acav100m_torch import cli as tcli
from acav100m_torch import tracing
from acav100m_torch.pipeline import feature_extraction as tfe
from acav100m_torch.utils import io as tio

from .torch_fake_models import fake_models

SHARDS = ("shard-000000", "shard-000001")


def assert_same_rows(got, want):
    assert [r["filename"] for r in got] == [r["filename"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["shard_name"], g["shard_size"]) == (w["shard_name"], w["shard_size"])
        for side in ("audio_features", "video_features"):
            assert len(g[side]) == len(w[side])
            for gf, wf in zip(g[side], w[side]):
                assert {k: v for k, v in gf.items() if k != "array"} == \
                    {k: v for k, v in wf.items() if k != "array"}
                assert list(gf["array"]) == list(wf["array"])
                for layer, arr in wf["array"].items():
                    np.testing.assert_array_equal(gf["array"][layer], arr)


@pytest.fixture
def clips(tmp_path):
    tcli.write_fixtures(tmp_path / "clips", num_shards=2, clips_per_shard=7, size=16)
    return tmp_path / "clips"


def extract(clips, out, **extra):
    cfg = tfe.get_config({"data.media.path": f"{clips}/shard-{{000000..000001}}.tar",
                          "data.output.path": str(out), "data.batch_size": 3,
                          "data.media.num_frames": 4, "computation.device": "cpu",
                          "log_period": 0, **extra})
    with tracing.enabled():
        saved = tfe.run_extraction(cfg, models=fake_models())
    return saved, tracing.counters()


@pytest.fixture
def saves(monkeypatch):
    """Each save of the extraction as (shard, rows passed, file size), after
    checking that it kept the file's bytes but its STOP, and that both
    packages' readers load the file as those rows."""
    seen = []
    before = {}
    save = tfe.save_shard_cache

    def checked(rows, out_dir, shard_name, **kwargs):
        path = save(rows, out_dir, shard_name, **kwargs)
        data = path.read_bytes()
        assert data.startswith(before.get(path, b".")[:-1])
        before[path] = data
        with open(path, "rb") as f:
            assert_same_rows(pickle.load(f), rows)
        caches, skips = jio.load_shard_caches(out_dir, [f"{shard_name}.tar"])
        assert_same_rows(caches[shard_name], rows)
        assert skips[shard_name] == [r["filename"] for r in rows]
        seen.append((shard_name, len(rows), path.stat().st_size))
        return path

    monkeypatch.setattr(tfe, "save_shard_cache", checked)
    return seen


def by_shard(seen, index):
    return {s: [x[index] for x in seen if x[0] == s] for s in SHARDS}


def test_every_save_appends_to_one_pickle_of_the_rows_so_far(clips, tmp_path, saves):
    saved, counts = extract(clips, tmp_path / "out")
    # batches of 3 over 7 + 7 clips: the third batch holds both shards' rows
    assert by_shard(saves, 1) == {"shard-000000": [3, 6, 7], "shard-000001": [2, 5, 7]}
    sizes = by_shard(saves, 2)
    assert all(a < b for s in SHARDS for a, b in zip(sizes[s], sizes[s][1:]))
    assert counts.get("extract.cache_rewrites", 0) == 0
    assert counts["extract.cache_appends"] == len(saves) == 6
    assert counts["extract.cache_bytes"] == sum(sizes[s][-1] for s in SHARDS)
    # the finished shards: each cache renamed into place, none left behind
    assert sorted(p.name for p in saved) == [f"{s}.pkl" for s in SHARDS]
    assert not list((tmp_path / "out").glob("*_cache.pkl"))
    for path, size in zip(saved, (sizes[s][-1] for s in SHARDS)):
        assert path.stat().st_size == size
        rows = tio.load_pickle(path)
        assert [r["filename"] for r in rows] == [
            f"clip_{path.stem[-1:].zfill(3)}_{c:03d}.npz" for c in range(7)]
    assert counts["extract.output_bytes"] == sum(p.stat().st_size for p in saved)


def test_a_shard_without_new_rows_is_not_written(clips, tmp_path, saves):
    # shard 0 gains a member that does not decode: it never completes
    with tarfile.open(clips / "shard-000000.tar", "a") as tf:
        info = tarfile.TarInfo("clip_000_007.npz")
        info.size = 4
        tf.addfile(info, io.BytesIO(b"junk"))
    meta_path = clips / "shard-000000.json"
    meta = json.loads(meta_path.read_text())
    meta_path.write_text(json.dumps(meta + [dict(meta[0], filename="clip_000_007.npz")]))
    saved, counts = extract(clips, tmp_path / "out")
    # shard 0's rows stop growing in the third batch; later batches leave its file
    assert by_shard(saves, 1) == {"shard-000000": [3, 6, 7], "shard-000001": [2, 5, 7]}
    assert [s[0] for s in saves] == ["shard-000000"] * 2 + list(SHARDS) + ["shard-000001"] * 2
    assert [p.name for p in saved] == ["shard-000001.pkl"]
    held = tio.load_pickle(tmp_path / "out" / "shard-000000_cache.pkl")
    assert [r["filename"] for r in held] == [f"clip_000_{c:03d}.npz" for c in range(7)]
    assert counts.get("extract.cache_rewrites", 0) == 0


def test_save_cache_every_appends_the_rows_since_the_last_save(clips, tmp_path, saves):
    saved, counts = extract(clips, tmp_path / "out", **{"data.batch_size": 1,
                                                         "acav.save_cache_every": 3})
    # 14 batches of one clip: saves after batches 3, 6, 9, 12; each shard's
    # last rows go onto its cache as it is renamed into place
    assert by_shard(saves, 1) == {"shard-000000": [3, 6], "shard-000001": [2, 5]}
    assert counts["extract.cache_appends"] == 4
    assert not list((tmp_path / "out").glob("*_cache.pkl"))
    for path in saved:
        assert len(tio.load_pickle(path)) == 7


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_resumes_from_a_cache_it_did_not_write(clips, tmp_path, writer, monkeypatch):
    full, _ = extract(clips, tmp_path / "full")
    want = {p.stem: tio.load_pickle(p) for p in full}
    out = tmp_path / "resumed"
    out.mkdir()
    first = want["shard-000000"][:4]
    if writer == "jax":
        jio.save_shard_cache(first, out, "shard-000000")
    else:  # the port's own appended cache, left by an earlier run
        tio.save_shard_cache(first[:2], out, "shard-000000")
        tio.save_shard_cache(first, out, "shard-000000", appended=2)
    seen = []
    save = tfe.save_shard_cache

    def recorded(rows, out_dir, shard_name, **kwargs):
        seen.append((shard_name, len(rows), kwargs.get("appended", 0)))
        return save(rows, out_dir, shard_name, **kwargs)

    monkeypatch.setattr(tfe, "save_shard_cache", recorded)
    saved, counts = extract(clips, out)
    # the resumed shard's first save rewrites its cache whole, then appends
    assert seen[0] == ("shard-000000", 7, 0)
    assert counts["extract.cache_rewrites"] == 1
    assert counts["extract.cache_appends"] == len(seen) - 1
    assert not list(out.glob("*_cache.pkl"))
    for path in saved:
        assert_same_rows(tio.load_pickle(path), want[path.stem])


def test_a_finished_shard_takes_its_appended_cache_or_a_whole_dump(tmp_path):
    rows = [tio.make_feature_row(f"c{i}.npz", "shard-000000", 5, [
        {"model_key": "layer_slowfast", "extractor_name": "FakeVid", "dataset": "synthetic",
         "array": [np.full(3, i, np.float32), np.arange(i, dtype=np.float32)]}], [])
        for i in range(5)]
    tio.save_shard_cache(rows[:1], tmp_path / "a", "shard-000000")
    tio.save_shard_cache(rows[:3], tmp_path / "a", "shard-000000", appended=1)
    path = tio.save_shard_output(rows, tmp_path / "a", "shard-000000", final=True, cached=3)
    assert_same_rows(tio.load_pickle(path), rows)
    tio.save_shard_cache(rows[:3], tmp_path / "b", "shard-000000")
    path = tio.save_shard_output(rows, tmp_path / "b", "shard-000000", final=True)
    assert_same_rows(tio.load_pickle(path), rows)
    for d in ("a", "b"):
        assert not (tmp_path / d / "shard-000000_cache.pkl").exists()
    # an append refuses a file that does not end a pickle
    (tmp_path / "c").mkdir()
    (tmp_path / "c" / "shard-000000_cache.pkl").write_bytes(b"\x80\x03]q\x00")
    with pytest.raises(ValueError, match="STOP"):
        tio.save_shard_cache(rows, tmp_path / "c", "shard-000000", appended=1)

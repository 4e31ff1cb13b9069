"""The port's pooled decode workers: ``make_loader(num_workers=2)`` delivers
the clips that the JAX package's in-process loader delivers, bit for bit,
over npz and mp4 shards; a worker hard-killed mid-shard has its shards
requeued and every clip arrives exactly once, also when it dies in the
middle of a message; skip lists hold in the workers. Each test runs under its own time limit, so a hung worker fails
the test instead of stalling the run."""

import functools
import io
import json
import tarfile
import warnings

import numpy as np
import pytest

from acav100m_tpu.data import tar_dataset as jtd
from acav100m_tpu.data import video as jvideo
from acav100m_torch import cli as tcli
from acav100m_torch.data import native_av as tav
from acav100m_torch.data import tar_dataset as ttd
from acav100m_torch.data import video as tvideo
from acav100m_torch.data.meta import load_metadata

from .torch_workers import crash_once_decoder, die_holding_queue_lock

LIMIT_S = 120  # seconds a test, read by tests/time_limit.py


def write_mp4_shards(root, num_shards=2, clips_per_shard=3, size=32):
    rng = np.random.RandomState(0)
    for si in range(num_shards):
        meta = []
        with tarfile.open(root / f"shard-{si:06d}.tar", "w") as tf:
            for ci in range(clips_per_shard):
                frames = rng.randint(0, 255, (24, size, size, 3)).astype(np.uint8)
                t = np.arange(3 * 16000) / 16000
                audio = (0.3 * np.sin(2 * np.pi * (200 + 50 * ci) * t)).astype(np.float32)
                path = root / "clip.mp4"
                assert tav.encode_mp4(path, frames, fps=8.0, audio=audio, sample_rate=16000)
                data = path.read_bytes()
                fname = f"clip_{si:03d}_{ci:03d}.mp4"
                info = tarfile.TarInfo(fname)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
                meta.append({"filename": fname, "id": f"v{si}{ci}", "segment": [0.0, 3.0]})
        (root / f"shard-{si:06d}.json").write_text(json.dumps(meta))


def by_name(loader):
    out = {}
    for batch in loader:
        for i, real in enumerate(batch["batch_mask"]):
            if real:
                name = batch["filename"][i]
                assert name not in out, f"{name} delivered twice"
                out[name] = {k: batch[k][i] for k in ("frames", "audio", "valid_samples",
                                                      "shard_name", "shard_size")}
    return out


@pytest.mark.parametrize("kind", ["npz", "mp4"])
def test_pooled_matches_in_process(kind, tmp_path):
    if kind == "npz":
        tcli.write_fixtures(tmp_path, num_shards=3, clips_per_shard=3, size=16)
        decoders = (tvideo.decode_npz, jvideo.decode_npz)
    else:
        if not tav.available():
            pytest.skip("FFmpeg's libraries or g++ are missing")
        write_mp4_shards(tmp_path)
        kw = dict(size=16, sample_rate=16000, sample_frames=8)
        decoders = (tvideo.get_decoder("native", **kw), jvideo.get_decoder("native", **kw))
    shards = sorted(tmp_path.glob("shard-*.tar"))
    metas, _ = load_metadata(shards)
    prepare = [functools.partial(mod.prepare_clip, num_frames=8, duration=3.0)
               for mod in (tvideo, jvideo)]
    want = by_name(jtd.make_loader(shards, metas, 2, decoder=decoders[1], prepare=prepare[1]))
    serial = by_name(ttd.make_loader(shards, metas, 2, decoder=decoders[0], prepare=prepare[0]))
    pooled = by_name(ttd.make_loader(shards, metas, 2, decoder=decoders[0], prepare=prepare[0],
                                     num_workers=2, buffer_samples=4))
    assert len(want) == sum(len(m) for m in metas.values())
    for got in (serial, pooled):
        assert set(got) == set(want)
        for name, sample in want.items():
            for key, val in sample.items():
                np.testing.assert_array_equal(got[name][key], val, err_msg=f"{name} {key}")


def test_killed_worker_shards_are_requeued(tmp_path):
    tcli.write_fixtures(tmp_path, num_shards=4, clips_per_shard=6, size=16)
    shards = sorted(tmp_path.glob("shard-*.tar"))
    metas, _ = load_metadata(shards)
    expected = {row["filename"] for m in metas.values() for row in m.values()}
    assert len(expected) == 24
    decoder = functools.partial(crash_once_decoder, marker_path=str(tmp_path / "crashed"),
                                crash_after=3)
    loader = ttd.make_loader(shards, metas, batch_size=4, decoder=decoder, prefetch=0,
                             num_workers=2, buffer_samples=8)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        seen = [fn for batch in loader
                for fn, real in zip(batch["filename"], batch["batch_mask"]) if real]
    assert (tmp_path / "crashed").exists(), "the crash never happened"
    assert sorted(seen) == sorted(expected), "clips lost or delivered twice"
    assert any("requeuing" in str(w.message) for w in caught)


def test_worker_killed_holding_its_queue_lock_stalls_no_other(tmp_path):
    """A worker killed while a queue's write lock is taken (its feeder thread
    mid-write) and in the middle of a message down its pipe must not block
    the consumer or the other workers: each writes to a pipe of its own,
    whose cut message reads as its end, so every clip still arrives exactly
    once."""
    tcli.write_fixtures(tmp_path, num_shards=4, clips_per_shard=6, size=16)
    shards = sorted(tmp_path.glob("shard-*.tar"))
    metas, _ = load_metadata(shards)
    expected = {row["filename"] for m in metas.values() for row in m.values()}
    decoder = functools.partial(die_holding_queue_lock, marker_path=str(tmp_path / "crashed"),
                                crash_after=3)
    loader = ttd.make_loader(shards, metas, batch_size=4, decoder=decoder, prefetch=0,
                             num_workers=2, buffer_samples=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        seen = [fn for batch in loader
                for fn, real in zip(batch["filename"], batch["batch_mask"]) if real]
    assert (tmp_path / "crashed").exists(), "the crash never happened"
    assert sorted(seen) == sorted(expected), "clips lost or delivered twice"


def test_skip_lists_hold_in_workers(tmp_path):
    tcli.write_fixtures(tmp_path, num_shards=2, clips_per_shard=4, size=16)
    shards = sorted(tmp_path.glob("shard-*.tar"))
    metas, _ = load_metadata(shards)
    skip = {"shard-000000": ["clip_000_001.npz", "clip_000_003.npz"],
            "shard-000001": ["clip_001_000.npz"]}
    got = by_name(ttd.make_loader(shards, metas, 3, skip_lists=skip, num_workers=2))
    want = by_name(jtd.make_loader(shards, metas, 3, skip_lists=skip))
    assert set(got) == set(want) and len(got) == 5
    assert not set(got) & {f for names in skip.values() for f in names}


@pytest.mark.parametrize("n", [4, 2])
def test_collate_writes_each_sample_once_as_np_stack_would(n):
    """``collate`` gives ``np.stack``'s values and dtypes, zero padding
    included, in the very arrays its allocator handed out (here full of
    junk, as pinned blocks taken again are)."""
    rng = np.random.RandomState(n)
    samples = [{"filename": f"c{i}.npz", "shard_name": "s", "shard_size": n,
                "frames": rng.randint(0, 255, (3, 4, 4, 3)).astype(np.uint8),
                "audio": rng.randn(10).astype(np.float32), "valid_samples": 7 + i}
               for i in range(n)]
    given = []

    def junk(shape, dtype):
        given.append(np.full(shape, 7, dtype))
        return given[-1]

    for empty in (np.empty, junk):
        batch = ttd.collate(samples, 4, empty)
        assert list(batch["batch_mask"]) == [True] * n + [False] * (4 - n)
        for key in ("frames", "audio", "valid_samples"):
            arrs = [np.asarray(s[key]) for s in samples]
            want = np.stack(arrs + [np.zeros_like(arrs[0])] * (4 - n))
            assert batch[key].dtype == want.dtype
            np.testing.assert_array_equal(batch[key], want)
    assert all(batch[k] is a for k, a in zip(("frames", "audio", "valid_samples"), given))
    with pytest.raises(ValueError, match="shapes"):
        ttd.collate(samples + [dict(samples[0], audio=np.zeros(3, np.float32))], 8)


@pytest.mark.parametrize("frames_in", [8, 12])
def test_prepare_clip_keeps_all_frames_uncopied(frames_in):
    """Where uniform sampling keeps every frame (indices ``0..T-1``), the
    prepared clip holds the decoded frames themselves; either way the
    frames are the JAX package's gather."""
    rng = np.random.RandomState(frames_in)
    decoded = {"frames": rng.randint(0, 255, (frames_in, 4, 4, 3)).astype(np.uint8),
               "audio": rng.randn(16000).astype(np.float32), "sample_rate": 16000,
               "video_fps": 8.0}
    got = tvideo.prepare_clip(decoded, num_frames=8, duration=1.0, skip_shorter_seconds=0.5)
    want = jvideo.prepare_clip(decoded, num_frames=8, duration=1.0, skip_shorter_seconds=0.5)
    np.testing.assert_array_equal(got["frames"], want["frames"])
    np.testing.assert_array_equal(
        got["frames"], decoded["frames"][np.linspace(0, frames_in - 1, 8).astype(np.int64)])
    assert (got["frames"] is decoded["frames"]) == (frames_in == 8)


def test_pooled_samples_are_collated_from_their_segment():
    """A pooled sample's arrays view its shared-memory segment, whose name
    is gone once received; ``batched`` closes it after the collate."""
    from multiprocessing import shared_memory

    sample = {"filename": "c.npz", "shard_name": "s", "shard_size": 1,
              "frames": np.arange(96, dtype=np.uint8).reshape(2, 4, 4, 3),
              "audio": np.linspace(0, 1, 10, dtype=np.float32), "valid_samples": 10}
    payload = ttd._sample_to_shm(sample)
    got = ttd._sample_from_shm(payload)
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=payload["shm"])
    segment = got["_shm"]
    assert np.shares_memory(got["frames"], np.ndarray(
        (segment.size,), np.uint8, buffer=segment.buf))
    (batch,) = ttd.batched([got], 2)
    assert "_shm" not in got and "frames" not in got
    for key in ("frames", "audio", "valid_samples"):
        np.testing.assert_array_equal(batch[key][0], sample[key])

"""Stages 1-3 of the port (``filter``, ``download``, ``segment``) and the
stage 3 -> 4 bundling against the JAX package on the same local inputs:
byte-equal filtered tsvs (the heuristic language detector with keyword
csvs, and the ``.ftz`` reader on a tiny fastText model this file writes),
the same downloaded files, the same clip boundaries and clip files from
``segment_video`` (``ArrayVideoBackend``, and the native FFmpeg backend
where FFmpeg's libraries build), the same shard jsons and tar members, and
the three CLI verbs end to end. These stages are host work: nothing here
touches a card."""

import json
import random
import struct
import tarfile

import numpy as np
import pytest

from acav100m_tpu import cli as jcli
from acav100m_tpu.data import native_av as jav
from acav100m_tpu.pipeline import bundling as jb
from acav100m_tpu.pipeline import clip_segmentation as jcs
from acav100m_tpu.pipeline import fasttext_ftz as jftz
from acav100m_tpu.pipeline import metadata_filtering as jmf
from acav100m_tpu.pipeline import video_download as jvd
from acav100m_torch import cli as tcli
from acav100m_torch.data import native_av as tav
from acav100m_torch.pipeline import bundling as tb
from acav100m_torch.pipeline import clip_segmentation as tcs
from acav100m_torch.pipeline import fasttext_ftz as tftz
from acav100m_torch.pipeline import metadata_filtering as tmf
from acav100m_torch.pipeline import video_download as tvd

from .test_stages123 import make_row, three_scene_video

ROWS = [
    make_row(vid="ok_en_01", title="the quick brown fox and the friendly dog"),
    make_row(vid="ok_es_002", title="el perro y el gato en la casa que es"),
    make_row(vid="short_0003", title="the fox and the dog", duration=5),
    make_row(vid="long_00004", title="the fox and the dog", duration=900),
    make_row(vid="gaming_cat", category="Gaming", title="the fine video of all"),
    make_row(vid="kw_gaming5", title="the best minecraft video of the year"),
    make_row(vid="kw_tutor06", title="the great piano tutorials of the year"),
    make_row(vid="music_art7", category="Music", title="the song by vevo for you"),
    make_row(vid="kw_custom8", title="the very fine unboxing of the year"),
    make_row(vid="zh_text009", title="这是中文文本的测试内容这是中文"),
    make_row(vid="ja_text010", title="これは日本語のテキストです"),
    make_row(vid="ok_url_011", title="the fox http://spam.example.com/x and the dog"),
    "not a tsv row",
]


def _keywords(root):
    root.mkdir(parents=True, exist_ok=True)
    (root / "gaming_keywords.csv").write_text("keyword\nminecraft\nlets,play\nunboxing\n")
    (root / "tutorial_keywords.csv").write_text("keyword\ntutori\nhow,to\n")
    (root / "artist_keywords.csv").write_text("keyword\nvevo\n")
    return root


def _write_ftz(path, dim=4, bucket=64, seed=0):
    """A tiny supervised, hierarchical-softmax, quantized-input fastText
    model in the layout ``fasttext_ftz`` parses (version 12)."""
    rng = np.random.RandomState(seed)
    words = [("the", 9, 0), ("el", 7, 0), ("la", 5, 0), ("</s>", 3, 0)]
    labels = [("__label__en", 30, 1), ("__label__es", 20, 1), ("__label__ja", 10, 1)]
    prune = {h: i for i, h in enumerate(range(0, bucket, 3))}
    out = bytearray(struct.pack("<2i", 793712314, 12))
    # dim ws epoch minCount neg wordNgrams loss=hs model=supervised bucket minn maxn lrUpdateRate
    out += struct.pack("<12i", dim, 5, 5, 1, 5, 1, 1, 3, bucket, 2, 3, 100)
    out += struct.pack("<d", 1e-4)
    entries = words + labels
    out += struct.pack("<3i", len(entries), len(words), len(labels))
    out += struct.pack("<2q", 100, len(prune))
    for word, count, kind in entries:
        out += word.encode() + b"\x00" + struct.pack("<q", count) + bytes([kind])
    for h, i in prune.items():
        out += struct.pack("<2i", h, i)
    m, nsubq, dsub = len(words) + len(prune), dim // 2, 2
    out += bytes([1, 1])  # quantized input, with a norm quantizer
    out += struct.pack("<2q", m, dim) + struct.pack("<i", m * nsubq)
    out += rng.randint(0, 256, m * nsubq).astype(np.uint8).tobytes()
    out += struct.pack("<4i", dim, nsubq, dsub, dsub)
    out += rng.randn(dim * 256).astype(np.float32).tobytes()
    out += rng.randint(0, 256, m).astype(np.uint8).tobytes()
    out += struct.pack("<4i", 1, 1, 1, 1) + rng.uniform(0.5, 2, 256).astype(np.float32).tobytes()
    out += bytes([0]) + struct.pack("<2q", len(labels) - 1, dim)
    out += rng.randn((len(labels) - 1) * dim).astype(np.float32).tobytes()
    path.write_bytes(bytes(out))
    return path


def test_ftz_reader_matches_jax(tmp_path):
    path = _write_ftz(tmp_path / "tiny.ftz")
    jm, tm = jftz.load_model(path), tftz.load_model(path)
    assert tm.labels == jm.labels == ["__label__en", "__label__es", "__label__ja"]
    np.testing.assert_array_equal(tm.input_rows, jm.input_rows)
    for text in ("the fox", "el perro y la casa", "これは", "", "zzz qqq", "the el la"):
        (jl, jp), (tl, tp) = jm.predict(text, k=3), tm.predict(text, k=3)
        assert tl == jl
        np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("keywords,ftz", [(False, False), (True, False), (True, True)],
                         ids=["defaults", "keyword_csvs", "keyword_csvs_ftz"])
def test_run_file_byte_equal_to_jax(tmp_path, keywords, ftz):
    tsv = tmp_path / "in.tsv"
    tsv.write_text("\n".join(ROWS) + "\n")
    kw = str(_keywords(tmp_path / "kw")) if keywords else None
    model = str(_write_ftz(tmp_path / "tiny.ftz")) if ftz else None
    want = jmf.run_file(tsv, tmp_path / "jax.tsv", keywords_dir=kw, fasttext_model=model)
    got = tmf.run_file(tsv, tmp_path / "port.tsv", keywords_dir=kw, fasttext_model=model)
    assert got == want and want[1] == len(ROWS)
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    assert tmf.test_each(tsv, kw, model) == jmf.test_each(tsv, kw, model)
    if not ftz:
        assert 0 < want[0] < len(ROWS)


def test_run_download_matches_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for vid in ("vid1", "vid3"):
        (src / f"{vid}.mp4").write_bytes(vid.encode() * 10)
    tsv = tmp_path / "f.tsv"
    tsv.write_text("".join(f"https://www.youtube.com/watch?v={v}\t{{}}\n"
                           for v in ("vid1", "vid2", "vid3", "vid1")))
    for _ in range(2):  # the second run skips what exists
        assert (tvd.run_download(tsv, tmp_path / "port", source_dir=src)
                == jvd.run_download(tsv, tmp_path / "jax", source_dir=src) == (2, 3))
    for name in ("vid1.mp4", "vid3.mp4"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["vid1.mp4", "vid3.mp4"]


@pytest.mark.parametrize("sampling,calc_sum", [("diversity_greedy", False), ("diversity", False),
                                               ("diversity", True), ("random", False),
                                               ("random_then_diversity", False)])
def test_segment_video_array_backend_matches_jax(tmp_path, sampling, calc_sum):
    frames, fps = three_scene_video(fps=2, secs=(15, 12, 14, 11, 13, 12, 15))
    out = {}
    for tag, mod in (("jax", jcs), ("port", tcs)):
        clips, paths = mod.segment_video(
            mod.ArrayVideoBackend(frames, fps), tmp_path / tag, "vid", num_clips=3,
            sampling=sampling, calc_diversity_with_sum=calc_sum,
            clip_duration_threshold=(30.0,), rng=random.Random(7))
        out[tag] = clips, [p.split("/")[-1] for p in paths]
    assert out["port"] == out["jax"] and len(out["port"][0]) == 3
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for name in names:
        np.testing.assert_array_equal(np.load(tmp_path / "port" / name),
                                      np.load(tmp_path / "jax" / name))


def _scene_mp4(path, seconds=(15, 14, 16, 12), fps=4.0, size=32, seed=0):
    """Constant-colour scenes (a little noise) with hard cuts, encoded as
    mpeg4 by the port's native encoder."""
    rng = np.random.RandomState(seed)
    scenes = [np.full((int(fps * s), size, size, 3), 30 + 90 * i, np.uint8)
              + rng.randint(0, 4, (int(fps * s), size, size, 3)).astype(np.uint8)
              for i, s in enumerate(seconds)]
    assert tav.encode_mp4(path, np.concatenate(scenes), fps=fps)
    return path


@pytest.fixture
def native():
    if not (tav.available() and jav.available()):
        pytest.skip("FFmpeg's libraries are not available to build native/avio.cc")


def test_segment_video_native_backend_matches_jax(tmp_path, native):
    src = _scene_mp4(tmp_path / "video.mp4")
    jbk, tbk = jcs.NativeAvVideoBackend(src), tcs.NativeAvVideoBackend(src)
    assert tbk.duration() == jbk.duration()
    assert tbk.detect_shots(10.0) == jbk.detect_shots(10.0)
    assert len(tbk.detect_shots(10.0)[0]) == 3
    out = {}
    for tag, mod, backend in (("jax", jcs, jbk), ("port", tcs, tbk)):
        clips, paths = mod.segment_video(backend, tmp_path / tag, "video", num_clips=3,
                                         clip_duration_threshold=(30.0,),
                                         rng=random.Random(98052))
        out[tag] = clips, [p.split("/")[-1] for p in paths]
    assert out["port"] == out["jax"] and len(out["port"][0]) == 3
    for name in out["jax"][1]:
        got, want = (tav.decode(path=tmp_path / tag / name, size=0, sample_rate=0)["frames"]
                     for tag in ("port", "jax"))
        assert got.shape[0] > 0
        np.testing.assert_array_equal(got, want)


def test_bundle_shards_and_check_output_match_jax(tmp_path):
    clips = tmp_path / "clips"
    clips.mkdir()
    for i, name in enumerate(["b_vid_020.mp4", "a_vid_000.mp4", "a_vid_013.mp4",
                              "c_001.mp4", "plain.mp4"]):
        (clips / name).write_bytes(bytes([i]) * (100 + i))
    paths = list(clips.glob("*.mp4"))
    got = tb.bundle_shards(paths, tmp_path / "port", shard_size=2, start_index=3)
    want = jb.bundle_shards(paths, tmp_path / "jax", shard_size=2, start_index=3)
    assert [p.name for p in got] == [p.name for p in want] == [
        "shard-000003.tar", "shard-000004.tar", "shard-000005.tar"]
    for t, j in zip(got, want):
        assert (t.with_suffix(".json").read_text() == j.with_suffix(".json").read_text())
        with tarfile.open(t) as tt, tarfile.open(j) as jt:
            assert tt.getnames() == jt.getnames()
            for name in jt.getnames():
                assert tt.extractfile(name).read() == jt.extractfile(name).read()
    assert json.loads(got[0].with_suffix(".json").read_text())[0] == {
        "filename": "a_vid_000.mp4", "id": "a_vid", "segment": [0.0, 10.0]}
    from acav100m_torch.utils.io import dump_pickle

    dump_pickle([{"filename": "a_vid_000.mp4"}, {"filename": "zzz.mp4"}],
                tmp_path / "port" / "shard-000003.pkl")
    assert tb.check_output(tmp_path / "port") == jb.check_output(tmp_path / "port")
    assert not tb.check_output(tmp_path / "port")["ok"]


def test_cli_stages_1_to_3_end_to_end(tmp_path, capsys):
    """filter -> download --source_dir -> segment through both CLIs on the
    same local inputs: the same filtered tsv, downloads and clips."""
    tsv = tmp_path / "in.tsv"
    tsv.write_text("\n".join(ROWS) + "\n")
    kw = _keywords(tmp_path / "kw")
    src = tmp_path / "src"
    src.mkdir()
    native = jav.available() and tav.available()
    for i, vid in enumerate(("ok_en_01", "ok_es_002")):  # the rows the filter keeps
        if native:
            _scene_mp4(src / f"{vid}.mp4", seed=i)
        else:
            (src / f"{vid}.mp4").write_bytes(vid.encode())
    for tag, cli in (("jax", jcli), ("port", tcli)):
        root = tmp_path / tag
        root.mkdir()
        cli.main(["filter", str(tsv), str(root / "filtered.tsv"), f"--keywords_dir={kw}"])
        cli.main(["download", str(root / "filtered.tsv"), str(root / "raw"),
                  f"--source_dir={src}"])
        if native:
            cli.main(["segment", str(root / "raw"), str(root / "clips"), "--backend=native",
                      "--num_clips=2", "--seed=5"])
    printed = capsys.readouterr().out
    assert "Done. " in printed and "downloaded 2/" in printed
    port, jax_ = tmp_path / "port", tmp_path / "jax"
    assert (port / "filtered.tsv").read_bytes() == (jax_ / "filtered.tsv").read_bytes()
    assert sorted(p.name for p in (port / "raw").iterdir()) == ["ok_en_01.mp4", "ok_es_002.mp4"]
    for name in ("ok_en_01.mp4", "ok_es_002.mp4"):
        assert (port / "raw" / name).read_bytes() == (jax_ / "raw" / name).read_bytes()
    if native:
        names = sorted(p.name for p in (jax_ / "clips").iterdir())
        assert len(names) == 4 and sorted(p.name for p in (port / "clips").iterdir()) == names


def test_cli_segment_defaults_match_jax():
    def defaults(cli):
        parser_args = []

        class Capture(SystemExit):
            pass

        def fake(args):
            parser_args.append(vars(args))
            raise Capture()

        from unittest import mock

        with mock.patch.object(cli, "cmd_segment", fake), \
                mock.patch.object(cli, "cmd_filter", fake), \
                mock.patch.object(cli, "cmd_download", fake):
            for argv in (["segment", "v", "o"], ["filter", "a", "b"], ["download", "t", "o"]):
                with pytest.raises(Capture):
                    cli.main(argv)
        return [{k: v for k, v in a.items() if k != "fn"} for a in parser_args]

    assert defaults(tcli) == defaults(jcli)

"""The port's clip decoders against the JAX package's on the same mp4 bytes
(mpeg4 video and AAC audio written by the port's ``native_av.encode_mp4``):
bit-equal frames and audio from the native FFmpeg decoder, with and without
decode-side sampling, equal ``prepare_clip`` outputs, the same ``auto``
choice and failure behaviour, and the native tar index against ``tarfile``."""

import io
import tarfile

import numpy as np
import pytest

from acav100m_tpu.data import native_av as jav
from acav100m_tpu.data import native_tar as jtar
from acav100m_tpu.data import video as jvideo
from acav100m_torch.data import native_av as tav
from acav100m_torch.data import native_build
from acav100m_torch.data import native_tar as ttar
from acav100m_torch.data import video as tvideo

SIZE, FPS, SECONDS, SR = 64, 8.0, 5, 44100


def frames_and_tone(n, size, freq, sr, seconds):
    """A moving gradient that survives lossy mpeg4, and a tone."""
    t = np.arange(n)[:, None, None]
    y = np.arange(size)[None, :, None]
    x = np.arange(int(size * 1.5))[None, None, :]
    r = 127 + 100 * np.sin(2 * np.pi * (x + 3 * t) / size)
    g = 127 + 100 * np.cos(2 * np.pi * (y + 2 * t) / size)
    b = 127 + 100 * np.sin(2 * np.pi * (x + y - t) / size)
    frames = np.stack([np.broadcast_to(c, (n, size, x.shape[-1])) for c in (r, g, b)],
                      axis=-1).astype(np.uint8)
    ts = np.arange(int(sr * seconds)) / sr
    return frames, (0.5 * np.sin(2 * np.pi * freq * ts)).astype(np.float32)


@pytest.fixture(scope="module")
def mp4(tmp_path_factory):
    if not (tav.available() and jav.available()):
        pytest.skip("FFmpeg's libraries or g++ are missing: native/avio.cc does not build")
    path = tmp_path_factory.mktemp("decode") / "clip.mp4"
    # 96x64 frames: the decoder scales the short side and crops the long one
    frames, audio = frames_and_tone(int(FPS * SECONDS), SIZE, 440.0, SR, SECONDS)
    assert tav.encode_mp4(path, frames, fps=FPS, audio=audio, sample_rate=SR)
    return path


def test_port_builds_into_build_dir():
    lib = native_build.build_library("tario")
    if lib is None:
        pytest.skip("no C++ compiler")
    assert lib.parent == native_build.BUILD_DIR and lib.name.startswith("libtario-")
    assert native_build.build_library("tario") == lib  # cached by hash


@pytest.mark.parametrize("sample_frames", [0, 8])
def test_native_decoder_bit_equal(mp4, sample_frames):
    data = mp4.read_bytes()
    kw = dict(size=SIZE, sample_rate=16000, sample_frames=sample_frames)
    want = jvideo.NativeAvDecoder(**kw)(data)
    got = tvideo.NativeAvDecoder(**kw)(data)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["frames"], want["frames"])
    np.testing.assert_array_equal(got["audio"], want["audio"])
    assert got["audio"].dtype == np.float32 and got["frames"].dtype == np.uint8
    assert got["frames"].shape[1:] == (SIZE, SIZE, 3)
    assert got["frames"].shape[0] == (sample_frames or int(FPS * SECONDS))
    assert (got["video_fps"], got["sample_rate"]) == (want["video_fps"], want["sample_rate"])
    raw_t, raw_j = (m.decode(data=data, size=SIZE, sample_frames=sample_frames)
                    for m in (tav, jav))
    for key in ("duration", "video_fps", "audio_start", "sample_rate"):
        assert raw_t[key] == raw_j[key], key
    np.testing.assert_array_equal(raw_t["frame_times"], raw_j["frame_times"])
    # prepare_clip: the sampled frames and 16 kHz audio padded to 10 s
    pt, pj = tvideo.prepare_clip(got, num_frames=8), jvideo.prepare_clip(want, num_frames=8)
    assert pt.keys() == pj.keys() and pt["valid_samples"] == pj["valid_samples"]
    for key in ("frames", "audio"):
        np.testing.assert_array_equal(pt[key], pj[key])


def test_buffer_decode_equals_file_decode(mp4):
    from_file = tav.decode(path=mp4, size=SIZE)
    from_buf = tav.decode(data=mp4.read_bytes(), size=SIZE)
    np.testing.assert_array_equal(from_file["frames"], from_buf["frames"])
    np.testing.assert_array_equal(from_file["audio"], from_buf["audio"])
    np.testing.assert_array_equal(tvideo.NativeAvDecoder(size=SIZE).decode_path(mp4)["frames"],
                                  from_file["frames"])


def test_garbage_and_auto(mp4):
    garbage = b"not a video" * 100
    assert tvideo.NativeAvDecoder(size=SIZE)(garbage) is None
    assert jvideo.NativeAvDecoder(size=SIZE)(garbage) is None
    kw = dict(size=SIZE, sample_rate=16000, sample_frames=8)
    for mod in (tvideo, jvideo):
        dec = mod.get_decoder("auto", **kw)
        assert type(dec).__name__ == "NativeAvDecoder"
        assert (dec.size, dec.sample_rate, dec.sample_frames) == (SIZE, 16000, 8)
        assert mod.get_decoder("npz") is mod.decode_npz
    with pytest.raises(ValueError):
        tvideo.get_decoder("pyav")


def test_native_decoder_raises_without_library(mp4, monkeypatch):
    """Where native/avio.cc cannot build, the port's decoder raises (the
    loader then warns and skips the clip); the JAX package's returns None."""
    monkeypatch.setattr(tav, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native FFmpeg library"):
        tvideo.NativeAvDecoder(size=SIZE)(mp4.read_bytes())
    assert not tvideo.NativeAvDecoder().available


def test_ffmpeg_cli_without_binary_raises_in_both(mp4):
    for mod in (tvideo, jvideo):
        dec = mod.get_decoder("ffmpeg", size=SIZE)
        dec.ffmpeg = None
        assert not dec.available
        with pytest.raises(RuntimeError, match="ffmpeg"):
            dec(mp4.read_bytes())
    for s in ("30000/1001", "25", "0/0"):
        assert tvideo.eval_fraction(s) == jvideo.eval_fraction(s)


def test_opencv_decoder_bit_equal(mp4):
    pytest.importorskip("cv2")
    data = mp4.read_bytes()
    want = jvideo.OpenCVVideoDecoder(size=SIZE)(data)
    got = tvideo.OpenCVVideoDecoder(size=SIZE)(data)
    assert got is not None and set(got) == set(want)
    for key in ("frames", "audio"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["video_fps"] == want["video_fps"]
    assert tvideo.OpenCVVideoDecoder(size=SIZE, audio_policy="drop")(data) is None
    assert tvideo.OpenCVVideoDecoder(size=SIZE)(b"garbage") is None


def test_native_tar_index_matches_tarfile(tmp_path):
    if not ttar.available():
        pytest.skip("no C++ compiler")
    path = tmp_path / "shard.tar"
    rng = np.random.RandomState(0)
    with tarfile.open(path, "w") as tf:
        for i, n in enumerate((0, 1, 511, 512, 513, 70000)):
            data = rng.bytes(n)
            info = tarfile.TarInfo(f"dir/member_{i:02d}{'_' * 90 if i == 5 else ''}.bin")
            info.size = n
            tf.addfile(info, io.BytesIO(data))
    with tarfile.open(path) as tf:
        want = [(m.name, m.offset_data, m.size) for m in tf if m.isfile()]
        data = {m.name: tf.extractfile(m).read() for m in tf if m.isfile()}
    index = ttar.index_tar(path)
    assert index == want == jtar.index_tar(path)
    for name, offset, size in index:
        assert ttar.read_member(path, offset, size) == data[name]
    from acav100m_torch.data.tar_dataset import TarShardDataset

    assert list(TarShardDataset._iter_members(path)) == list(data.items())

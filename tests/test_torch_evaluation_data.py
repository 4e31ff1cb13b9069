"""The port's evaluation data, meters, config and CLI against the JAX
package's: meters and json stat lines, the 80 x 128 log-mel, pretrain
batches from tar shards, the classification dataset's memberships and test
views, the split and fold protocols, ``fixtures --labels`` and the
``evaluate`` verb end to end on the CPU (pretrain, resume, linear eval)."""

import json
import shutil
import time
import zipfile

import numpy as np
import pytest
import torch

from acav100m_tpu import cli as jcli
from acav100m_tpu.data.meta import load_metadata as j_load_metadata
from acav100m_tpu.evaluation import config as jc
from acav100m_tpu.evaluation import data as jd
from acav100m_tpu.evaluation import train as jt
from acav100m_tpu.utils import profiling as jp
from acav100m_torch import cli as tcli
from acav100m_torch.data.meta import load_metadata as t_load_metadata
from acav100m_torch.evaluation import config as tc
from acav100m_torch.evaluation import data as td
from acav100m_torch.evaluation import train as tt
from acav100m_torch.utils import profiling as tp

torch.set_num_threads(1)

LOGMEL_TOL = 1e-4  # absolute, log-mel units


def test_meters_and_json_stat_lines_match_jax(tmp_path):
    values = np.random.RandomState(0).randn(23, 2)
    lines = []
    for mod in (jp, tp):
        meters, scalar = mod.Meters(window_size=5), mod.ScalarMeter(7)
        out = tmp_path / f"{mod.__name__}.jsonl"
        for i, (a, b) in enumerate(values):
            meters.add(loss=a, acc=b)
            scalar.add_value(a)
            if i % 4 == 3:
                mod.log_json_stats({"_type": "train_iter", "step": i, **meters.snapshot(),
                                    **meters.medians()}, out)
        mod.log_json_stats({"_type": "train_done", **meters.global_avgs(),
                            "median": scalar.get_win_median(),
                            "avg": scalar.get_win_avg()}, out)
        lines.append(out.read_text())
    assert lines[0] == lines[1] and lines[0].count("\n") == 6
    assert tp.get_open_fds() > 0
    timer = tp.IterTimer(window_size=3)
    assert timer.tick() >= 0 and timer.mean >= 0
    writer = tp.TensorBoardWriter(None)
    writer.add_scalars({"x": 1.0}, step=0)
    writer.close()
    with tp.device_trace(None):
        pass
    with tp.device_trace(tmp_path / "trace"):
        torch.ones(4).sum()
    assert (tmp_path / "trace" / "trace.json").is_file()


def test_logmel_80x128_matches_jax():
    rng = np.random.RandomState(1)
    for n in (32000, 20000):  # 2 s, and a short window padded to 128 frames
        audio = (0.3 * rng.randn(n)).astype(np.float32)
        want, got = jd.audio_logmel_80x128(audio), td.audio_logmel_80x128(audio)
        assert got.shape == want.shape == (80, 128) and got.dtype == np.float32
        assert np.abs(got - want).max() <= LOGMEL_TOL


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_shards")
    tcli.write_fixtures(root, num_shards=2, clips_per_shard=3, size=40, seed=2)
    return sorted(root.glob("shard-*.tar"))


def test_pretrain_batches_match_jax(shards):
    got = list(td.pretrain_batches(shards, t_load_metadata(shards)[0], 2,
                                   np.random.RandomState(3), num_frames=4, crop=32))
    want = list(jd.pretrain_batches(shards, j_load_metadata(shards)[0], 2,
                                    np.random.RandomState(3), num_frames=4, crop=32))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["visual"].shape == (2, 4, 32, 32, 3) and g["visual"].dtype == np.uint8
        assert np.array_equal(g["visual"], w["visual"])
        assert g["audio"].shape == (2, 80, 128, 1) and g["audio"].dtype == np.float32
        assert np.abs(g["audio"] - w["audio"]).max() <= LOGMEL_TOL


def write_protocol_dataset(root, n=10, size=24):
    """npz clips with every membership: flat ``split``, UCF101-style
    ``splits`` and ESC-50-style ``fold``."""
    rng = np.random.RandomState(4)
    items = []
    for i in range(n):
        fname = f"clip{i}.npz"
        np.savez(root / fname, frames=rng.randint(0, 255, (6 + i % 3, size, size, 3))
                 .astype(np.uint8), audio=rng.randn(16000 + 4000 * (i % 2)).astype(np.float32),
                 sample_rate=16000, video_fps=3.0)
        items.append({"file": fname, "label": i % 3, "split": "train" if i < 7 else "test",
                      "splits": {str(s): "test" if (i + s) % 4 == 0 else "train"
                                 for s in (1, 2, 3)},
                      "fold": 1 + i % 5})
    (root / "labels.json").write_text(json.dumps({"classes": ["a", "b", "c"],
                                                  "items": items}))
    return root


@pytest.mark.parametrize("membership", [{}, {"split_id": 2}, {"fold": 3}],
                         ids=["flat", "splits", "folds"])
def test_classification_dataset_matches_jax(tmp_path, membership):
    root = write_protocol_dataset(tmp_path)
    for split, kw in (("train", {}), ("test", {"num_ensemble_views": 3,
                                               "num_spatial_crops": 3})):
        ds_t = td.ClipClassificationDataset(root, split, **kw, **membership)
        ds_j = jd.ClipClassificationDataset(root, split, **kw, **membership)
        assert ds_t.items == ds_j.items and len(ds_t) > 0
        got = list(ds_t.examples(np.random.RandomState(5), num_frames=4, crop=16))
        want = list(ds_j.examples(np.random.RandomState(5), num_frames=4, crop=16))
        assert len(got) == len(want) == len(ds_t) * (1 if split == "train" else 9)
        for g, w in zip(got, want):
            assert (g["label"], g["video_index"]) == (w["label"], w["video_index"])
            assert np.array_equal(g["visual"], w["visual"])
            assert np.abs(g["audio_logmel"] - w["audio_logmel"]).max() <= LOGMEL_TOL


def _recorder(calls):
    """A stand-in ``linear_eval`` that drains its batches and scores the
    labels it saw, so both packages' protocol runs can be compared."""

    def linear_eval(backbone, train_batches, test_batches, num_classes, **kw):
        train, test = list(train_batches), list(test_batches)
        calls.append((num_classes, train, test))
        seen = np.concatenate([b["label"] for b in test])
        return {"top1": float(seen.sum()), "top5": float(len(seen))}

    return linear_eval


@pytest.mark.parametrize("protocol", ["splits", "folds"])
def test_run_protocol_matches_jax(tmp_path, monkeypatch, protocol):
    root = write_protocol_dataset(tmp_path)
    ckpt = tmp_path / "ckpt.pkl"
    ckpt.write_bytes(__import__("pickle").dumps({"params": {}, "batch_stats": {}}))
    overrides = {"task": "linear_eval", "data.path": str(root), "data.batch_size": "3",
                 "data.num_frames": "4", "data.crop": "16", "eval.protocol": protocol,
                 "eval.num_steps": "4", "checkpoint.pretrained": str(ckpt)}
    calls_t, calls_j = [], []
    monkeypatch.setattr(tt, "linear_eval", _recorder(calls_t))
    monkeypatch.setattr(jt, "linear_eval", _recorder(calls_j))
    got = tc.run_task(tc.load_config(None, {**overrides, "computation.device": "cpu"}))
    want = jc.run_task(jc.load_config(None, overrides))
    assert got == want and len(got["per_run"]) == (3 if protocol == "splits" else 5)
    assert len(calls_t) == len(calls_j)
    for (nt, trt, tet), (nj, trj, tej) in zip(calls_t, calls_j):
        assert nt == nj == 3
        for bt, bj in zip(trt + tet, trj + tej):
            assert np.array_equal(bt["visual"], bj["visual"])
            assert np.array_equal(bt["label"], bj["label"])
            assert np.array_equal(bt["video_index"], bj["video_index"])
            assert np.abs(bt["audio"] - bj["audio"]).max() <= LOGMEL_TOL


def test_fixtures_labels_writes_the_jax_verbs_bytes(tmp_path, monkeypatch):
    # np.savez stamps each zip member with the current time: hold it still
    frozen = time.localtime(1_700_000_000)
    monkeypatch.setattr(zipfile, "time", type("T", (), {
        "time": staticmethod(lambda: 1_700_000_000.0),
        "localtime": staticmethod(lambda *_: frozen)}))
    args = ["--num_shards=2", "--clips_per_shard=3", "--size=24", "--labels"]
    tcli.main(["fixtures", str(tmp_path / "t"), *args])
    jcli.main(["fixtures", str(tmp_path / "j"), *args])
    names = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*")
                   if p.is_file())
    assert len(names) == 2 * 2 + 6 + 1  # shards and metas, 6 clips, labels.json
    assert names == sorted(p.relative_to(tmp_path / "t") for p in
                           (tmp_path / "t").rglob("*") if p.is_file())
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


def run_evaluate(capsys, *args):
    tcli.main(["evaluate", *args])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture
def run(tmp_path):
    """A checkpoint directory removed after the test: two full-width
    checkpoints with AdamW's moments take 1.4 GB."""
    yield tmp_path / "run"
    shutil.rmtree(tmp_path / "run", ignore_errors=True)


def test_evaluate_verb_pretrains_resumes_and_scores_on_the_cpu(tmp_path, run, capsys):
    """``fixtures --labels`` -> ``evaluate --cfg configs/acav_pretrain.yaml``
    (2 steps at full width, 4 frames of 32^2) -> the same to 3 steps, which
    resumes at step 2 -> ``evaluate task=linear_eval`` on ``classify/`` with
    cached features: top-1 above 60% (the JAX package's gate,
    ``tests/test_evaluation.py``)."""
    tcli.main(["fixtures", str(tmp_path / "clips"), "--size=32", "--labels"])
    capsys.readouterr()
    common = [f"data.path={tmp_path}/clips/shard-{{000000..000001}}.tar",
              "data.batch_size=2", "data.num_frames=4", "data.crop=32",
              "train.save_period=1", "train.log_every=1", f"checkpoint.dir={run}",
              "computation.device=cpu"]
    out = run_evaluate(capsys, "--cfg", "configs/acav_pretrain.yaml", *common,
                       "train.num_steps=2")
    assert out == {"task": "pretrain", "steps": 2}
    out = run_evaluate(capsys, "--cfg", "configs/acav_pretrain.yaml", *common,
                       "train.num_steps=3")
    assert out == {"task": "pretrain", "steps": 3}
    lines = [json.loads(x) for x in (run / "stats.jsonl").read_text().splitlines()]
    iters = [x for x in lines if x["_type"] == "train_iter"]
    assert [x["step"] for x in iters] == [1, 2, 3]  # the second run resumed at 2
    assert set(iters[0]) == {"_type", "step", "loss", "acc", "loss_median", "loss_avg",
                             "lr", "iter_s", "time"}
    assert all(np.isfinite(x["loss"]) for x in iters)
    assert [x["_type"] for x in lines].count("train_done") == 2
    assert {"loss_global", "acc_global"} <= set(lines[-1])
    assert (run / "step_latest.ckpt").is_file() and (run / "epoch_latest.ckpt").is_file()
    out = run_evaluate(capsys, "task=linear_eval", f"data.path={tmp_path}/clips/classify",
                       "data.batch_size=4", "data.num_frames=4", "data.crop=32",
                       f"checkpoint.pretrained={run}/epoch_latest.ckpt",
                       "eval.mode=multimodal", "eval.num_steps=30", "eval.base_lr=0.05",
                       "eval.cache_features=true", "computation.device=cpu")
    assert set(out) == {"task", "top1", "top5"}
    assert out["top1"] > 60.0 and out["top5"] == 100.0


def test_evaluate_rejects_unknown_keys_and_needs_a_card_by_default(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("solver:\n  lr: 1.0\n")
    with pytest.raises(KeyError):
        tc.load_config(cfg)
    with pytest.raises(KeyError):
        tcli.main(["evaluate", "train.no_such_key=1"])
    loaded = tc.load_config("configs/esc50_linear.yaml", {"eval.num_steps": "7"})
    assert (loaded.task, loaded.eval.mode, loaded.eval.num_steps) == ("linear_eval", "audio", 7)
    assert loaded.computation.device == "cuda"
    (tmp_path / "c.json").write_text(json.dumps({"train": {"num_steps": 5}}))
    assert tc.load_config(tmp_path / "c.json").train.num_steps == 5
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["evaluate", "--cfg", "configs/acav_pretrain.yaml",
                   f"data.path={tmp_path}/none.tar"])


def test_chip_smoke_pretrain_config_is_the_yaml_files():
    """``chip_smoke.py`` path H hands ``configs/acav_pretrain.yaml``'s values
    to ``evaluate`` as JSON (no PyYAML on the card's machine)."""
    import yaml

    import chip_smoke

    with open("configs/acav_pretrain.yaml") as f:
        assert chip_smoke.H_PRETRAIN == yaml.safe_load(f)

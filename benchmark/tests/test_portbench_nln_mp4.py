"""The cells of SLOWFAST_NLN_8x8_R50 (``extract.nln.bf16.decoded``) and of mp4
shards (``extract.fp32.mp4``) at tiny shapes on the CPU: each run comes out
correct against its plain reference in float32 with limits far below the
cells' own, the non-local cell's control and its program without the blocks
fail, and the non-local count holds the arithmetic done by hand."""

import time

import pytest

from benchmark import control, harness

TINY = {
    "extract.nln.bf16.decoded": {
        "config": {"extract": {"num_frames": 8, "size": 32, "duration": 2, "batch_size": 2}},
        "traffic": {"distinct_clips": 3, "shards": 2, "members_per_shard": 3,
                    "warmup_members": 2, "check_rows": 2, "calibration_clips": 3}},
    "extract.fp32.mp4": {
        "config": {"extract": {"num_frames": 8, "size": 32, "duration": 2, "batch_size": 2}},
        "traffic": {"distinct_clips": 2, "width": 64, "height": 48, "shards": 2,
                    "members_per_shard": 3, "warmup_members": 2, "check_rows": 2,
                    "encode_threads": 2, "num_workers": 2}},
}
FLOAT32 = {"config": {"computation": {"dtype": "float32"}}}
SEED = 2 ** 31 + 4321


def run(workload, trace=False, overrides=None, hook=None):
    ov = harness.merge(TINY[workload], overrides)
    return harness.run_cell(workload, SEED, 0.3, trace, time.perf_counter(),
                            require_cuda=False, overrides=ov, stage_hook=hook)


@pytest.mark.parametrize("workload,overrides,limits", [
    # float32 on the CPU: the program's sums in other orders than the
    # reference's (the cheaper association of the non-local core)
    ("extract.nln.bf16.decoded", FLOAT32,
     {"tap_rms.slowfast": 1e-4, "tap_err.vggish": 1e-5}),
    ("extract.fp32.mp4", {}, {"tap_err.slowfast": 1e-5, "tap_err.vggish": 1e-5}),
])
def test_new_cell_meets_reference_on_cpu(workload, overrides, limits, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))  # a run's scratch of its own
    for trace in (False, True):
        result = run(workload, trace, harness.merge(overrides, {"limits": limits}))
        assert result["correct"], result["checks"]
        assert result["failed"] == 0 and result["attempted"] > 0
        assert list(result)[-1] == "checks"
        want = {"extract.feed_wait_ms_per_batch"} if trace else {"extract_clips_per_s",
                                                                 "setup_s"}
        assert want <= set(result["metrics"])


def test_mp4_cell_extracts_one_shard_a_call(tmp_path, monkeypatch):
    """A call hands the program one shard and asks for the traffic's
    workers; the program decodes a single shard in-process."""
    from acav100m_torch.data import tar_dataset
    from acav100m_torch.pipeline import feature_extraction as fe

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    loaders = []
    make_loader = fe.make_loader

    def recorded(shard_paths, *args, **kwargs):
        loaders.append((len(shard_paths), kwargs.get("num_workers")))
        return make_loader(shard_paths, *args, **kwargs)

    monkeypatch.setattr(fe, "make_loader", recorded)
    monkeypatch.setattr(tar_dataset, "_pooled_stream", None)  # never started
    result = run("extract.fp32.mp4", overrides={
        "limits": {"tap_err.slowfast": 1e-5, "tap_err.vggish": 1e-5}})
    assert result["correct"], result["checks"]
    calls = len(loaders) - 1  # the warm-up's call aside
    assert calls > 0 and result["attempted"] == calls * 3 and result["failed"] == 0
    assert set(loaders) == {(1, 2)}


def test_nln_cell_fails_without_the_blocks_and_under_its_control(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    without = run("extract.nln.bf16.decoded", overrides=harness.merge(FLOAT32, {
        "config": {"models": {"layer_slowfast_nln": {"nonlocal": {
            "location": [[], [], [], []]}}}}}))
    assert not without["correct"]
    assert without["checks"]["tap_rms.slowfast"]["value"] > 100 * 1e-4
    overrides, hooks = control.mode_setup("extract.nln.bf16.decoded", "control")
    result = run("extract.nln.bf16.decoded", overrides=overrides,
                 hook=lambda stage: [h(stage) for h in hooks])
    assert not result["correct"]


def test_nonlocal_counts():
    counts = harness.load_module(harness.BENCH / "counts" / "nonlocal.py")
    blocks = counts.blocks(32, 256)
    assert blocks == [(8192, 2048, 256)] * 2 + [(2048, 512, 512)] * 3
    # the published order: 17.2 GFLOP a block at res3, 40.8 in all
    assert counts.published_core_flops(8192, 2048, 256) == 4 * 8192 * 2048 * 256
    assert sum(counts.published_core_flops(*b) for b in blocks) == pytest.approx(40.80e9,
                                                                                 rel=1e-3)
    # the cheaper order: 13 times fewer at res3
    assert counts.core_flops(8192, 2048, 256) == 2 * 256 * 256 * (2048 + 8192)
    assert counts.published_core_flops(*blocks[0]) / counts.core_flops(*blocks[0]) == 12.8
    # bytes: theta, phi, g and y once in bf16, 0.335 GB a batch of 32 at res3
    assert 32 * counts.core_bytes(*blocks[0], 2) == 2 * 32 * 256 * (2 * 8192 + 2 * 2048)
    # a batch's least time: 100 us a res3 block and 50 a res4 block (bytes)
    assert counts.ideal_seconds(32, 32, 256, 2, 989e12, 3.35e12) == pytest.approx(
        2 * 335.5e6 / 3.35e12 + 3 * 167.8e6 / 3.35e12, rel=1e-3)
    # SlowFast's 131.42 GFLOP, the four convs' 26.8 and the cores' 6.7
    assert counts.slowfast_nln(32, 256) == pytest.approx((131.42 + 26.84 + 6.71) * 1e9,
                                                         rel=1e-3)

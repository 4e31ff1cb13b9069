"""Operation and byte counts against arithmetic done by hand."""

import pytest

from benchmark.counts import k1, k2, model_flops


def test_k2_stage_work():
    # block 0: a 80x64, b 9x64x64, c 64x256, projection 80x256; blocks 1-2:
    # a 256x64, b 9x64x64, c 64x256
    per_pixel = (80 * 64 + 9 * 64 * 64 + 64 * 256 + 80 * 256) + 2 * (
        256 * 64 + 9 * 64 * 64 + 64 * 256)
    assert k2.macs_per_pixel() == per_pixel == 218112
    assert k2.flops(32, 64) == 2 * 32 * 64 * 64 * per_pixel  # 57.18 GFLOP
    assert k2.flops(256, 64) == pytest.approx(457.4e9, rel=1e-3)  # a batch of 32 clips
    # float32: 256 frames in (80 ch) and out (256 ch) at 4 bytes, plus weights
    act = 256 * 64 * 64 * (80 + 256) * 4
    assert act < k2.bytes_moved(256, 64, 4) < act + 4 * 1e6
    # at the card's rates the stage is bound by its operations
    t = k2.ideal_seconds(256, 64, 4, 495e12, 3.35e12)
    assert t == pytest.approx(k2.flops(256, 64) / 495e12)


def test_k1_step_work():
    dims = [88, 352, 704, 1408, 2304, 64, 128, 256, 512, 128]
    assert sum(dims) == 5944
    assert k1.bytes_moved(1024, dims, 32) == 4 * (1024 * 5944 + 2 * 32 * 5944 + 2 * 32 * 10
                                                   + 1024 * 10)
    assert k1.flops(1024, dims, 32) == 2 * 1024 * 32 * 5944 + 1024 * 5944
    # bound by its bytes: about 7.8 us at 3.35 TB/s
    assert k1.ideal_seconds(1024, dims, 32, 495e12, 3.35e12) == pytest.approx(7.8e-6, rel=0.02)


def test_model_flops():
    # PySlowFast publishes SLOWFAST_8x8_R50 at 65.71 GFLOPs (multiply-adds) a view
    assert model_flops.slowfast(32, 256) / 2 == pytest.approx(65.71e9, rel=1e-3)
    # VGGish on 10 examples of 96x64: six 3x3 convs, then 12288-4096-4096-128
    convs = [(1, 64, 96 * 64), (64, 128, 48 * 32), (128, 256, 24 * 16), (256, 256, 24 * 16),
             (256, 512, 12 * 8), (512, 512, 12 * 8)]
    macs = sum(9 * ci * co * px for ci, co, px in convs)
    macs += 12288 * 4096 + 4096 * 4096 + 4096 * 128
    assert model_flops.vggish(10) == 2 * 10 * macs

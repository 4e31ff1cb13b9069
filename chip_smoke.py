"""Smoke run of the PyTorch/CUDA port (``acav100m_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. build the hand-written kernels from ``acav100m_torch/csrc`` (one nvcc
   per source, started together) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the main paths'
   shapes (TF32 off), and time kernel, plain version and library yardstick
   with CUDA events around back-to-back calls; K2 in both forms, float32
   and bfloat16;
3. main path A through the port's CLI: ``fixtures`` (2 shards x 8 clips,
   32 frames of 256x256) -> ``extract`` (SlowFast 8x8 R50 + VGGish at full
   width, float32, seeded random weights) -> ``cluster`` -> ``select``;
   then path A-bf16 on the same clips, in the JAX package's headline
   configuration (``computation.dtype=bfloat16
   computation.fast_block=[4,4,4,4,4]``): ``extract`` -> ``cluster`` ->
   ``select``, its taps held against path A's;
4. main path C, stage 4 on published checkpoints with pooled decode
   workers: SlowFast 8x8 R50 written as a caffe2 ``.pkl`` (the published
   SLOWFAST_8x8_R50 form) and VGGish as a torchvggish ``.pth``, both through
   ``convert`` (its npz loads to the same state dicts); ``extract`` of
   2 shards x 8 clips with ``computation.num_workers=2``, then with 0
   (taps within 1e-4 clip by clip), then ``cluster`` -> ``select``; the
   host's decode time per clip, a batch's staging copies, the loader's and
   extract's clips/s with 0 and 2 workers and the card's busy share of
   extract. The card's machine has no
   FFmpeg development libraries, so ``native/avio.cc`` does not build there
   and path C's clips are npz (32 frames of 256x256, 10 s of 44.1 kHz audio
   that the workers resample); the mp4 decoders are held against the JAX
   package by the CPU tests. OpenCV's decode time of a 10 s 640x360 mp4 is
   printed beside them where ``cv2`` imports;
5. main path B at production widths: ``cluster`` (K=32, B=1024) ->
   ``select`` on 2 shards x 1024 synthetic feature rows;
6. path D, the rest of stage 6 on path B's outputs (V=2048 clips, 10
   clusterings of K=32, so P=45 cluster pairs): D1 chunk mode
   (``chunk_size=1``) and ``reduce`` of its cache csvs; D2 ``select`` with
   ``measure_name`` mem_mi, mi, ami and nmi in float32 (ms per greedy step,
   peak device memory); D3 every full-table scorer in float64 on the card
   against the same code on the CPU, and full MI against the incremental
   score; D4 ``compare_measures`` and ``compare_dtypes``; D5 contrastive
   selection on path B's feature pkls, its scores on the card against the
   CPU's (TF32 off), and ``merge_contrastive_csvs``. Stage 6 has no
   hand-written kernel: path D launches none;
7. path E, data parallelism (``acav100m_torch.runtime``) on path B's and
   D's inputs: E1 path B's cluster training through a one-rank NCCL group,
   bit-equal to path B's, with one all-reduce of the deltas and one
   sharded step timed; then 2 spawned ranks sharing ``cuda:0`` over gloo
   (NCCL refuses two ranks on one device): E2 post-warmup cluster steps of
   2 x 1024 rows against one rank's step on the 2048 rows, E3 the
   selectors (``batch_mi``, ``mi`` and ``ami`` full-table, float64) against
   one rank's picks, E4 equalized extraction of 3 npz shards x 4 clips
   against a one-rank run. With more than one card, E1 and E2 run again
   over NCCL on ``min(count, 4)`` cards.

Then one JSON line of per-kernel results and, last, the device JSON line.
Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits at once and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import hashlib
import io
import json
import math
import multiprocessing
import pickle
import shutil
import socket
import subprocess
import sys
import tarfile
import time
from pathlib import Path

import numpy as np
import torch

from acav100m_torch import cli, runtime
from acav100m_torch.ablate_k1 import COLD_SETS, TAP_DIMS, k1_inputs
from acav100m_torch.models import init_weights, zoo
from acav100m_torch.models.slowfast import LayerSlowFast, ResBlock
from acav100m_torch.models.vggish import LayerVggish
from acav100m_torch.ops import cuda_build
from acav100m_torch.ops.bottleneck_kernel import fused_stage, fused_stage_bf16, fused_stage_ref
from acav100m_torch.ops.kmeans_kernel import (
    discounted_distances,
    fused_assign_update,
    fused_assign_update_ref,
)
from acav100m_torch.ops import mi
from acav100m_torch.pipeline import contrastive_selection as cs
from acav100m_torch.pipeline import feature_extraction as fe
from acav100m_torch.pipeline import subset_selection as ss
from acav100m_torch.profiling import card, device_busy, time_cold_ms, time_ms
from acav100m_torch.utils.io import dump_pickle, load_pickle, make_feature_row

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TF32_TENSOR_FLOPS = 495e12  # dense TF32 on the tensor cores
BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores
AUDIO_DIMS = [64, 128, 256, 512, 128]
VIDEO_DIMS = [88, 352, 704, 1408, 2304]
KERNELS = [
    ("kmeans_assign_update", fused_assign_update,
     "acav100m_tpu/ops/pallas/kmeans_kernel.py:85"),
    ("bottleneck_stage", fused_stage,
     "acav100m_tpu/ops/pallas/bottleneck_kernel.py:116"),
    ("bottleneck_stage_bf16", fused_stage_bf16,
     "acav100m_tpu/ops/pallas/bottleneck_kernel.py:116"),
]
HEADLINE = ["computation.dtype=bfloat16", "computation.fast_block=[4,4,4,4,4]"]
N_PER_SHARD = 1024  # path B's feature rows a shard; path D selects from them


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bound(nbytes: float, flops: float, rate: float):
    """Least time in ms for the bytes at the memory rate and the operations
    at ``rate``, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def reset_counts() -> None:
    for _, fn, _ in KERNELS:
        fn.launches = 0


def counts():
    return {name: fn.launches for name, fn, _ in KERNELS}


# -- phase 2: kernels against their plain versions --------------------------------

def check_k1(gen: torch.Generator) -> dict:
    """K1 at the shapes both main paths give it: path B's K=32, B=1024 (timed)
    and its ragged B=1000, and path A's K=4, B=4 (one tile, one partial);
    rows and centers zero past each of the ten taps' widths, which K1 is
    told (``dims``), as ``train_step`` tells it."""
    result = {}
    dims = TAP_DIMS
    # (k, b, samples seen): the threshold (seen / k)**0.7 past warmup, with
    # counts drawn below twice it, marks about half the centers underused
    for k, b, seen in ((32, 1024, 20000), (32, 1000, 20000), (4, 4, 48)):
        args = k1_inputs(gen, k, b, dims, seen=seen)
        centers, cnt, batch, threshold = args
        m, _, d = centers.shape
        underused = int((cnt < threshold).sum())
        check(0 < underused < m * k, f"K1 at K={k} B={b}: some centers underused")
        best, c_add, deltas, mean = out = fused_assign_update(*args, dims=dims)
        again = fused_assign_update(*args, dims=dims)
        padded = fused_assign_update(*args)
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(out, again)),
              f"K1 at K={k} B={b}: two launches bitwise equal")
        check(all(torch.equal(u, v) for u, v in zip(out, padded)),
              f"K1 at K={k} B={b}: the same bytes with dims as on the padded input")
        best_p, _, _, mean_p = fused_assign_update_ref(*args)
        dist = discounted_distances(centers, cnt, batch, threshold)
        two = dist.topk(2, dim=-1, largest=False).values
        decisive = (two[..., 1] - two[..., 0]) > 1e-4 * two[..., 0].abs()
        flips = int(((best != best_p) & decisive).sum())
        onehot = torch.nn.functional.one_hot(best.long(), k).float()
        own_counts = onehot.sum(1)
        own_deltas = torch.bmm(onehot.transpose(1, 2), batch)
        err_c = float((c_add - own_counts).abs().max() / own_counts.abs().max())
        abs_d = float((deltas - own_deltas).abs().max())
        err_d = abs_d / float(own_deltas.abs().max())
        err_m = float(((mean - mean_p).abs() / mean_p.abs()).max())
        log(f"K1 K={k} B={b}: best differs on {flips} of {int(decisive.sum())} decisive "
            f"rows ({int((best != best_p).sum())} of {m * b} in all); counts rel err "
            f"{err_c:.2e}, deltas rel err {err_d:.2e}, mean min-dist rel err {err_m:.2e}; "
            f"{underused} of {m * k} centers underused; two launches bitwise equal, and "
            f"equal to the launch without dims")
        check(flips == 0, f"K1 argmin at K={k} B={b}")
        check(err_c <= 1e-4 and err_d <= 1e-4 and err_m <= 1e-4, f"K1 sums at K={k} B={b}")
        if (k, b) == (32, 1024):
            sets = [args] + [k1_inputs(gen, k, b, dims) for _ in range(COLD_SETS - 1)]
            with_dims = [a + (dims,) for a in sets]
            # each call a CUDA graph replay: a call's host work (about
            # 0.06 ms) outlasts the kernel, so eager calls would time the host
            warm = time_cold_ms(fused_assign_update, with_dims[:1], graph=True)
            cold = time_cold_ms(fused_assign_update, with_dims, graph=True)
            cold_padded = time_cold_ms(fused_assign_update, sets, graph=True)
            eager = time_cold_ms(fused_assign_update, with_dims)
            plain = time_ms(lambda: fused_assign_update_ref(*args))
            real = sum(dims)
            # rows and centers over the real columns, all of deltas, counts
            # in and out, best, the means
            nbytes = 4 * (b * real + k * real + m * k * d + 2 * m * k + m * b + m)
            padded_bytes = 4 * (m * b * d + 2 * m * k * d + 2 * m * k + m * b + m)
            # 3xTF32 issues three TF32 products for each fp32 one
            bound_ms, bound_by = bound(nbytes, 3 * 2 * b * k * real, TF32_TENSOR_FLOPS)
            padded_ms, _ = bound(padded_bytes, 3 * 2 * m * b * k * d, TF32_TENSOR_FLOPS)
            result = dict(max_abs_err=abs_d, ms=cold, plain_ms=plain, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
            log(f"K1 at M={m} K={k} D={d} B={b}, real widths {real} of {m * d} columns: "
                f"{cold:.4f} ms with a cold L2 (calls rotate over {COLD_SETS} input sets, "
                f"{COLD_SETS * 4 * (b + k) * real / 1e6:.0f} MB of real columns), "
                f"{warm:.4f} ms warm (the same inputs each call), {cold_padded:.4f} ms cold "
                f"without dims, all as graph replays; {eager:.4f} ms cold as eager calls; "
                f"plain {plain:.4f} ms; bound {bound_ms:.4f} ms over the real columns "
                f"({bound_by}), {padded_ms:.4f} ms padded; no single library call "
                f"computes it")
    return result


def random_blocks(cin, stride, gen, n_blocks=3, inner=64, cout=256):
    """Canonical kt=1 bottleneck blocks with random weights and BN
    statistics; every gamma, the final one of each block included, is
    non-zero so the residual branch is checked."""
    blocks = []
    for i in range(n_blocks):
        blk = ResBlock(cin if i == 0 else cout, cout, inner, 1, stride if i == 0 else 1)
        init_weights(blk, gen)
        for mod in blk.modules():
            if isinstance(mod, torch.nn.BatchNorm3d):
                c = mod.num_features
                mod.weight.data = torch.rand(c, generator=gen) + 0.5
                mod.bias.data = 0.1 * torch.randn(c, generator=gen)
                mod.running_mean.data = 0.1 * torch.randn(c, generator=gen)
                mod.running_var.data = torch.rand(c, generator=gen) + 0.5
        blocks.append(blk.cuda().eval())
    return blocks


def check_k2(gen: torch.Generator) -> dict:
    result = {}
    for clips, t, hw, stride in ((4, 8, 64, 1), (2, 2, 10, 2)):
        n, cin = clips * t, 80
        blocks = random_blocks(cin, stride, gen)
        with torch.no_grad():
            folded = [blk.folded() for blk in blocks]
            x = torch.randn((n, hw, hw, cin), generator=gen).cuda()
            out = fused_stage(x, folded, stride)
            torch.cuda.synchronize()
            ref = fused_stage_ref(x, folded, stride)
            xc = x.reshape(clips, t, hw, hw, cin).permute(0, 4, 1, 2, 3).contiguous()

            def canonical():
                h = xc
                for blk in blocks:
                    h = blk(h)
                return h

            can = canonical().permute(0, 2, 3, 4, 1).reshape(out.shape)
            scale = float(ref.abs().max())
            err = float((out - ref).abs().max()) / scale
            err_can = float((out - can).abs().max()) / scale
            log(f"K2 {n} frames {hw}x{hw} stride {stride}: max err {err:.2e} vs plain, "
                f"{err_can:.2e} vs canonical cuDNN stage (relative to max |y| {scale:.3f})")
            check(err <= 1e-5 and err_can <= 1e-3, f"K2 at {hw}x{hw} stride {stride}")
            if stride == 1:
                ms = time_ms(lambda: fused_stage(x, folded, stride))
                plain = time_ms(lambda: fused_stage_ref(x, folded, stride))
                library = time_ms(canonical)
                px = n * hw * hw
                flops = sum(2 * px * v.numel() for blk in folded
                            for key, v in blk.items() if key.endswith("w"))
                nbytes = 4 * (x.numel() + out.numel()
                              + sum(v.numel() for blk in folded for v in blk.values()))
                # 3xTF32 issues three TF32 products for each fp32 one
                bound_ms, bound_by = bound(nbytes, 3 * flops, TF32_TENSOR_FLOPS)
                result = dict(max_abs_err=float((out - ref).abs().max()), ms=ms,
                              plain_ms=plain, bound_ms=bound_ms, bound_by=bound_by,
                              library_ms=library)
                log(f"K2 s2_slow at {n} frames (4 clips) 64x64, 80->256: {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, canonical cuDNN stage {library:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by})")
    return result


def to_bf16(blocks):
    """K2's bf16 form of float32 folded blocks: weight matrices in bf16,
    biases float32, as the model's ``ResStage`` hands them over."""
    return [{k: v.to(torch.bfloat16) if v.dim() > 1 else v for k, v in blk.items()}
            for blk in blocks]


def check_k2_bf16(gen: torch.Generator) -> dict:
    """K2's bf16 form at the path's shape and at stride 2, against its bf16
    plain version on the same inputs, and against the float32 form on the
    same bf16-representable inputs."""
    result = {}
    for clips, t, hw, stride in ((4, 8, 64, 1), (2, 2, 10, 2)):
        n, cin = clips * t, 80
        blocks = random_blocks(cin, stride, gen)
        with torch.no_grad():
            folded = to_bf16([blk.folded() for blk in blocks])
            x = torch.randn((n, hw, hw, cin), generator=gen).cuda().to(torch.bfloat16)
            out = fused_stage_bf16(x, folded, stride)
            again = fused_stage_bf16(x, folded, stride)
            torch.cuda.synchronize()
            ref = fused_stage_ref(x, folded, stride)
            # the float32 form on the same values, widened
            f32 = fused_stage(x.float(), [{k: v.float() for k, v in blk.items()}
                                          for blk in folded], stride)
            lib_blocks = [copy.deepcopy(blk).to(torch.bfloat16) for blk in blocks]
            xc = x.reshape(clips, t, hw, hw, cin).permute(0, 4, 1, 2, 3).contiguous()

            def canonical():
                h = xc
                for blk in lib_blocks:
                    h = blk(h)
                return h

            can = canonical().permute(0, 2, 3, 4, 1).reshape(out.shape)
            scale = float(ref.float().abs().max())
            diff = (out.float() - ref.float()).abs()
            err, mean = float(diff.max()) / scale, float(diff.mean()) / scale
            err_f32 = float((out.float() - f32).abs().max()) / scale
            err_can = float((out.float() - can.float()).abs().max()) / scale
            same = torch.equal(out, again)
            log(f"K2-bf16 {n} frames {hw}x{hw} stride {stride}: max err {err:.2e}, mean err "
                f"{mean:.2e} vs bf16 plain; {err_f32:.2e} vs the float32 form; {err_can:.2e} "
                f"vs canonical cuDNN stage in bf16 (relative to max |y| {scale:.3f}); two "
                f"launches bitwise equal: {same}")
            check(err <= 1.6e-2 and mean <= 1e-3, f"K2-bf16 at {hw}x{hw} stride {stride}")
            check(same, f"K2-bf16 at {hw}x{hw} stride {stride}: two launches bitwise equal")
            check(err_f32 <= 3e-2, f"K2-bf16 vs float32 K2 at {hw}x{hw} stride {stride}")
            check(err_can <= 5e-2, f"K2-bf16 vs canonical bf16 stage at {hw}x{hw}")
            if stride == 1:
                ms = time_ms(lambda: fused_stage_bf16(x, folded, stride))
                plain = time_ms(lambda: fused_stage_ref(x, folded, stride))
                library = time_ms(canonical)
                px = n * hw * hw
                flops = sum(2 * px * v.numel() for blk in folded
                            for key, v in blk.items() if key.endswith("w"))
                nbytes = (2 * (x.numel() + out.numel())
                          + sum(v.numel() * v.element_size()
                                for blk in folded for v in blk.values()))
                bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
                result = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=plain,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=library)
                log(f"K2-bf16 s2_slow at {n} frames (4 clips) 64x64, 80->256: {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, canonical cuDNN stage in bf16 {library:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
                    f"{nbytes / 1e6:.1f} MB)")
    return result


# -- phases 3 and 4: the main path -------------------------------------------------

def run_stage(verb, *args) -> float:
    t0 = time.time()
    cli.main([verb, *args])
    torch.cuda.synchronize()
    return time.time() - t0


def check_features(feats: Path, n_rows: int) -> dict:
    """Checks the feature pkls (row count, tap dims, float32, finite);
    returns {(filename, side, layer): array}."""
    rows = [r for p in sorted(feats.glob("shard-*.pkl")) for r in load_pickle(p)]
    check(len(rows) == n_rows, f"{n_rows} feature rows, got {len(rows)}")
    taps = {}
    for row in rows:
        for side, dims in (("audio_features", AUDIO_DIMS), ("video_features", VIDEO_DIMS)):
            arrs = row[side][0]["array"]
            got = [arrs[f"layer_{i}"].shape[-1] for i in range(5)]
            check(got == dims, f"{side} dims {got}")
            check(all(a.dtype == np.float32 for a in arrs.values()), f"{side} float32")
            check(all(np.isfinite(a).all() for a in arrs.values()), f"{side} finite")
            for layer, a in arrs.items():
                taps[row["filename"], side, layer] = a
    return taps


def csv_rows(path: Path) -> int:
    return len(path.read_text().splitlines())


def check_model_paths(clips: Path, gen: torch.Generator) -> None:
    """The full-width SlowFast on two fixture clips: the K2 route against
    the canonical cuDNN route, same random weights with non-zero BN gammas
    (TF32 off)."""
    from acav100m_torch.data.tar_dataset import TarShardDataset, collate
    from acav100m_torch.data.meta import load_metadata

    shard = str(clips / "shard-000000.tar")
    metas, _ = load_metadata([shard])
    samples = []
    for s in TarShardDataset([shard], metas):
        samples.append(s)
        if len(samples) == 2:
            break
    frames = torch.from_numpy(collate(samples, 2)["frames"]).cuda()
    fused, canon = LayerSlowFast(pallas_stages=True), LayerSlowFast(pallas_stages=False)
    init_weights(fused, gen)
    for mod in fused.modules():
        if isinstance(mod, torch.nn.BatchNorm3d):
            mod.weight.data = torch.rand(mod.num_features, generator=gen) + 0.5
    canon.load_state_dict(fused.state_dict())
    fused.cuda().eval()
    canon.cuda().eval()
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            t_f, t_c = fused(frames), canon(frames)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(t_f, t_c)]
    log("SlowFast taps, K2 route vs canonical route on 2 fixture clips, rel err "
        + ", ".join(f"{e:.2e}" for e in errs))
    check(max(errs) <= 1e-3, "SlowFast K2 route vs canonical route")


def main_path_a(gen: torch.Generator):
    """Path A in float32; returns its launches and its taps."""
    clips, feats = WORK / "a" / "clips", WORK / "a" / "features"
    clus, out_csv = WORK / "a" / "clusters", WORK / "a" / "output.csv"
    n_clips = 16
    t0 = time.time()
    cli.main(["fixtures", str(clips), "--num_shards=2", "--clips_per_shard=8",
              "--size=256"])
    t_fix = time.time() - t0
    spec = "shard-{000000..000001}"
    reset_counts()
    t_ext = run_stage("extract", f"data.media.path={clips}/{spec}.tar",
                      f"data.output.path={feats}", "data.batch_size=4")
    after_extract = counts()
    taps = check_features(feats, n_clips)
    # 16 clips in batches of 4 give 4 steps an epoch, 16 steps over 4 epochs.
    # Warmup is initial_rounds * k = 10 * 4 = 40 samples, so steps 1-10
    # assign at random and K1 runs from step 11 on.
    t_clu = run_stage("cluster", f"data.path={feats}/{spec}.pkl",
                      f"data.output.path={clus}", "data.batch_size=4",
                      "clustering.ncentroids=4", "clustering.epochs=4")
    after_cluster = counts()
    t_sel = run_stage("select", f"data.path={clus}/{spec}.pkl",
                      f"data.output.path={out_csv}", f"data.meta.path={clips}")
    launches = counts()
    rows, want = csv_rows(out_csv), round(0.2 * n_clips)
    log(f"path A: fixtures {t_fix:.2f} s; extract {t_ext:.2f} s "
        f"({n_clips / t_ext:.2f} clips/s); cluster {t_clu:.2f} s; select {t_sel:.2f} s; "
        f"extract+cluster+select {n_clips / (t_ext + t_clu + t_sel):.2f} clips/s; "
        f"{rows} csv rows (want {want}); launches {launches}")
    check(rows == want, f"output.csv rows {rows} != {want}")
    check(after_extract["bottleneck_stage"] > 0, "K2 launched by extract")
    check(after_extract["bottleneck_stage_bf16"] == 0, "K2-bf16 not launched in float32")
    check(after_cluster["kmeans_assign_update"] > 0, "K1 launched by cluster")
    check_model_paths(clips, gen)
    return launches, taps


def main_path_a_bf16(f32_taps: dict) -> dict:
    """Path A-bf16: path A's clips through extract in the JAX package's
    headline configuration (bf16, fast_block [4,4,4,4,4]; the same seeded
    float32 weights), then cluster and select on its float32 pkls. Each bf16
    tap is held against path A's float32 tap of the same clips within 5e-2 of
    the tap's max over the clips (the CPU tests measure 1.6e-3 to 7.6e-3 at
    their small size; path A's convs run in TF32)."""
    clips, feats = WORK / "a" / "clips", WORK / "a_bf16" / "features"
    clus, out_csv = WORK / "a_bf16" / "clusters", WORK / "a_bf16" / "output.csv"
    n_clips = 16
    spec = "shard-{000000..000001}"
    reset_counts()
    t_ext = run_stage("extract", f"data.media.path={clips}/{spec}.tar",
                      f"data.output.path={feats}", "data.batch_size=4", *HEADLINE)
    after_extract = counts()
    taps = check_features(feats, n_clips)
    t_clu = run_stage("cluster", f"data.path={feats}/{spec}.pkl",
                      f"data.output.path={clus}", "data.batch_size=4",
                      "clustering.ncentroids=4", "clustering.epochs=4")
    t_sel = run_stage("select", f"data.path={clus}/{spec}.pkl",
                      f"data.output.path={out_csv}", f"data.meta.path={clips}")
    launches = counts()
    rows, want = csv_rows(out_csv), round(0.2 * n_clips)
    check(set(taps) == set(f32_taps), "path A-bf16 rows and taps as path A's")
    errs = {}
    for side in ("audio_features", "video_features"):
        for i in range(5):
            keys = [k for k in taps if k[1:] == (side, f"layer_{i}")]
            got = np.stack([taps[k] for k in keys])
            want_f32 = np.stack([f32_taps[k] for k in keys])
            errs[side.split("_")[0], i] = float(np.abs(got - want_f32).max()
                                                / np.abs(want_f32).max())
    log(f"path A-bf16 ({' '.join(HEADLINE)}): extract {t_ext:.2f} s "
        f"({n_clips / t_ext:.2f} clips/s); cluster {t_clu:.2f} s; select {t_sel:.2f} s; "
        f"{rows} csv rows (want {want}); launches {launches}")
    log("path A-bf16 taps vs path A's float32 taps, max err over the tap's max: "
        + ", ".join(f"{side}[{i}] {e:.2e}" for (side, i), e in errs.items()))
    check(rows == want, f"path A-bf16 output.csv rows {rows} != {want}")
    check(after_extract["bottleneck_stage_bf16"] > 0, "K2-bf16 launched by bf16 extract")
    check(after_extract["bottleneck_stage"] == 0, "float32 K2 not launched by bf16 extract")
    check(max(errs.values()) <= 5e-2, "path A-bf16 taps within 5e-2 of path A's")
    return launches


def write_npz_shards(root: Path, n_shards: int = 2, per_shard: int = 8) -> int:
    """Path C's clips: npz in the form a decoder hands over for a 10 s clip
    (32 frames of 256x256, 3.2 fps) with 10 s of 44.1 kHz audio, a tone of
    its own a clip, which ``prepare_clip`` resamples to 16 kHz."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(1)
    t = np.arange(441000) / 44100.0
    for si in range(n_shards):
        meta = []
        with tarfile.open(root / f"shard-{si:06d}.tar", "w") as tf:
            for ci in range(per_shard):
                k = si * per_shard + ci
                frames = rng.randint(0, 60, (32, 256, 256, 3)).astype(np.uint8)
                frames[..., k % 3] += np.uint8(100 + 8 * k)
                audio = (0.4 * np.sin(2 * np.pi * (200.0 + 40 * k) * t)
                         + 0.02 * rng.randn(t.size)).astype(np.float32)
                buf = io.BytesIO()
                np.savez(buf, frames=frames, audio=audio, sample_rate=44100, video_fps=3.2)
                fname = f"clip_{si:03d}_{ci:03d}.npz"
                info = tarfile.TarInfo(fname)
                info.size = buf.getbuffer().nbytes
                buf.seek(0)
                tf.addfile(info, buf)
                meta.append({"filename": fname, "id": f"vid{k:06d}",
                             "segment": [float(ci), float(ci) + 10.0]})
        (root / f"shard-{si:06d}.json").write_text(json.dumps(meta))
    return n_shards * per_shard


def write_checkpoints(root: Path, gen: torch.Generator):
    """Seeded full-width weights in the published checkpoint forms: SlowFast
    as a caffe2 ``.pkl`` (latin1 pickle of ``{'blobs': ...}``, non-zero BN
    gammas), VGGish as a torchvggish ``.pth``. Returns the two paths and
    the state dicts written."""
    sf, vg = LayerSlowFast(), LayerVggish()
    init_weights(sf, gen)
    init_weights(vg, gen)
    with torch.no_grad():
        for mod in sf.modules():
            if isinstance(mod, torch.nn.BatchNorm3d):
                c = mod.num_features
                mod.weight.copy_(torch.rand(c, generator=gen) + 0.5)
                mod.bias.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(c, generator=gen))
                mod.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
        for name, p in vg.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.01 * torch.randn(p.shape, generator=gen))
    sf_sd, vg_sd = sf.state_dict(), vg.state_dict()
    blobs = {zoo.pyslowfast_to_caffe2_name(k): v.numpy() for k, v in sf_sd.items()
             if not k.endswith("num_batches_tracked")}
    check(None not in blobs, "every SlowFast parameter has a caffe2 name")
    root.mkdir(parents=True, exist_ok=True)
    pkl, pth = root / "SLOWFAST_8x8_R50.pkl", root / "vggish.pth"
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": blobs}, f, protocol=2)
    torch.save(vg_sd, pth)
    return pkl, pth, sf_sd, vg_sd


def check_converted_weights(pkl: Path, pth: Path, sf_sd: dict, vg_sd: dict) -> None:
    """``convert`` on both checkpoints; the npz it writes, the checkpoint
    itself and the weights written load to bit-equal state dicts."""
    npz = {"slowfast": pkl.with_suffix(".npz"), "vggish": pth.with_suffix(".npz")}
    cli.main(["convert", "slowfast", str(pkl), str(npz["slowfast"])])
    cli.main(["convert", "vggish", str(pth), str(npz["vggish"])])

    def loaded(sf_file, vg_file):
        cfg = fe.get_config({"computation.device": "cpu", "data.media.path": "-",
                             "weights.slowfast_file": str(sf_file),
                             "weights.vggish_file": str(vg_file)})
        models = fe.build_models(cfg)
        return models["layer_slowfast"].state_dict(), models["layer_vggish"].state_dict()

    t0 = time.time()
    from_ckpt = loaded(pkl, pth)
    t_load = time.time() - t0
    from_npz = loaded(npz["slowfast"], npz["vggish"])
    for got, again, want in zip(from_ckpt, from_npz, (sf_sd, vg_sd)):
        check(got.keys() == want.keys() == again.keys(), "checkpoint keys")
        check(all(torch.equal(got[k], want[k]) and torch.equal(again[k], want[k])
                  for k in want), "checkpoint, its npz and the weights written bit-equal")
    log(f"path C weights: caffe2 .pkl ({pkl.stat().st_size / 1e6:.1f} MB, {len(sf_sd)} "
        f"SlowFast tensors) and torchvggish .pth ({pth.stat().st_size / 1e6:.1f} MB) load "
        f"in {t_load:.2f} s on the host; convert's npz, the checkpoints and the weights "
        f"written give bit-equal state dicts")


def decode_ms_per_clip(shard: Path) -> None:
    """The host's decode and ``prepare_clip`` time per clip, in-process on
    one core, over one shard's clips; and OpenCV's decode of a 10 s 640x360
    25 fps mp4 (its bundled FFmpeg, video only) where ``cv2`` imports."""
    from acav100m_torch.data.tar_dataset import TarShardDataset
    from acav100m_torch.data.video import OpenCVVideoDecoder, decode_npz, prepare_clip

    members = list(TarShardDataset._iter_members(shard))
    t_dec, t_prep = [], []
    for _, data in members:
        t0 = time.perf_counter()
        dec = decode_npz(data)
        t1 = time.perf_counter()
        prepare_clip(dec, num_frames=32, duration=10.0, skip_shorter_seconds=2.5)
        t_prep.append((time.perf_counter() - t1) * 1e3)
        t_dec.append((t1 - t0) * 1e3)
    log(f"path C host decode, in-process, one core, {len(members)} clips: npz decode "
        f"{np.median(t_dec):.2f} ms and prepare_clip (32 of 32 frames; 44.1 -> 16 kHz "
        f"resample) {np.median(t_prep):.2f} ms per clip (medians)")
    try:
        import cv2
    except ImportError:
        log("OpenCV decode of a 640x360 mp4: not measured (no cv2)")
        return
    path = shard.parent / "opencv_640x360.mp4"
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (640, 360))
    # a smooth texture panning one pixel a frame, so the bit rate is a
    # video's, not noise's
    y, x = np.mgrid[0:360, 0:640 + 250]
    base = np.stack([127 + 100 * np.sin(2 * np.pi * (x / 97 + c * y / 131)) for c in (1, 2, 3)],
                    axis=-1).astype(np.uint8)
    for i in range(250):
        writer.write(np.ascontiguousarray(base[:, i:i + 640]))
    writer.release()
    dec = OpenCVVideoDecoder(size=256)
    data = path.read_bytes()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = dec(data)
        times.append((time.perf_counter() - t0) * 1e3)
    check(out is not None and out["frames"].shape == (250, 256, 256, 3), "OpenCV decode")
    log(f"path C host decode, OpenCV {cv2.__version__}, one 10 s 640x360 25 fps mpeg4 clip "
        f"({len(data) / 1e6:.2f} MB) to 250 frames of 256x256: {np.median(times):.1f} ms "
        f"(median of 3; every frame scaled; no audio)")


def staging_ms(shard: Path) -> dict:
    """A batch's host copies between a worker's decode and the card, each
    the median of 5: into shared memory (in the worker), out of it (in the
    loader), the stack into a batch, and ``_stage``'s pin and copy to the
    card (to its event)."""
    from acav100m_torch.data.meta import load_metadata
    from acav100m_torch.data.tar_dataset import (
        TarShardDataset, _sample_from_shm, _sample_to_shm, collate)
    from acav100m_torch.data.video import prepare_clip

    metas, _ = load_metadata([shard])
    prepare = functools.partial(prepare_clip, num_frames=32, duration=10.0,
                                skip_shorter_seconds=2.5)
    samples = []
    for sample in TarShardDataset([shard], metas, prepare=prepare):
        samples.append(sample)
        if len(samples) == 4:
            break
    stream = torch.cuda.Stream()
    device = torch.device("cuda")

    def med(fn, reps=5):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    def stage():
        fe._stage(batch, device, stream)["_dev"][1].synchronize()

    made = []
    t_to = med(lambda: made.append([_sample_to_shm(s) for s in samples]))
    t_from = med(lambda: [_sample_from_shm(p) for p in made.pop()])
    t_stack = med(lambda: collate(samples, 4))
    batch = collate(samples, 4)
    t_stage = med(stage)
    mb = sum(v.nbytes for v in batch.values() if isinstance(v, np.ndarray)) / 1e6
    log(f"path C staging of one batch of 4 clips ({mb:.1f} MB), medians of 5: into shared "
        f"memory {t_to:.2f} ms (in the workers), out of it {t_from:.2f} ms, stack "
        f"{t_stack:.2f} ms, pin and copy to the card {t_stage:.2f} ms")
    return batch


def slot_dependence(models: dict, batch: dict) -> float:
    """The largest change of a clip's taps, relative to the tap's max, when
    its batch of 4 is reversed: how much a clip's slot in the batch moves
    its taps on the card (pooled workers deliver clips in another order)."""
    extract = fe.make_extract_fn(models)
    dev = [torch.from_numpy(batch[k]).cuda() for k in ("frames", "audio", "valid_samples")]
    fwd, rev = extract(*dev), extract(*[t.flip(0) for t in dev])
    return max(float((a - b.flip(0)).abs().max() / a.abs().max())
               for name in fwd for a, b in zip(fwd[name], rev[name]))


# run as ``python -c``: a spawned worker then imports no main script, as
# under ``python -m acav100m_torch``; one started from a script imports the
# script again (here: torch and the whole port) before it decodes
LOADER_RATE = r"""
import functools, json, sys, time
from pathlib import Path
import scipy.signal  # imported before the clock starts, as by any earlier clip
from acav100m_torch.data.meta import load_metadata
from acav100m_torch.data.tar_dataset import make_loader
from acav100m_torch.data.video import decode_npz, prepare_clip

shards = sorted(Path(sys.argv[1]).glob("shard-*.tar"))
metas, _ = load_metadata(shards)
prepare = functools.partial(prepare_clip, num_frames=32, duration=10.0, skip_shorter_seconds=2.5)
out = {}
for workers in (0, 2):
    t0 = time.time()
    n, first = 0, None
    for batch in make_loader(shards, metas, 4, decoder=decode_npz, prepare=prepare,
                             num_workers=workers):
        first = time.time() - t0 if first is None else first
        n += int(batch["batch_mask"].sum())
    out[workers] = [n, time.time() - t0, first]
print(json.dumps(out))
"""


def loader_rates(clips: Path) -> dict:
    """The loader alone (no model, no torch) over path C's shards, with 0
    and 2 workers: {workers: (clips, seconds, seconds to the first batch)}."""
    out = subprocess.run([sys.executable, "-c", LOADER_RATE, str(clips)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    check(out.returncode == 0, f"loader rate: {out.stderr[-2000:]}")
    return {int(k): v for k, v in json.loads(out.stdout.strip().splitlines()[-1]).items()}


def main_path_c(gen: torch.Generator) -> dict:
    """Path C; returns its launches."""
    root = WORK / "c"
    clips, out_csv = root / "clips", root / "output.csv"
    n_clips = write_npz_shards(clips)
    pkl, pth, sf_sd, vg_sd = write_checkpoints(root / "weights", gen)
    check_converted_weights(pkl, pth, sf_sd, vg_sd)
    decode_ms_per_clip(clips / "shard-000000.tar")
    batch = staging_ms(clips / "shard-000000.tar")
    spec = "shard-{000000..000001}"
    common = [f"data.media.path={clips}/{spec}.tar", "data.batch_size=4", "data.decoder=npz",
              f"weights.slowfast_file={pkl}", f"weights.vggish_file={pth}"]
    t0 = time.time()
    models = fe.build_models(fe.get_config({"data.media.path": "-", **dict(
        a.split("=", 1) for a in common if a.startswith("weights."))}))
    torch.cuda.synchronize()
    t_build = time.time() - t0
    err_slot = slot_dependence(models, batch)
    del models
    reset_counts()
    t_pool = run_stage("extract", *common, f"data.output.path={root}/pooled",
                       "computation.num_workers=2")
    after_extract = counts()
    t_serial, kernels, copies = device_busy(lambda: cli.main(
        ["extract", *common, f"data.output.path={root}/serial", "computation.num_workers=0"]))
    run_stage("extract", *common, f"data.output.path={root}/serial2", "computation.num_workers=0")
    pooled = check_features(root / "pooled", n_clips)
    serial = check_features(root / "serial", n_clips)
    serial2 = check_features(root / "serial2", n_clips)
    check(set(pooled) == set(serial), "path C: the same clips and taps with 0 and 2 workers")

    def max_err(got, want):
        return max(float(np.abs(got[k] - want[k]).max() / max(np.abs(want[k]).max(), 1e-30))
                   for k in want)

    err, err_repeat = max_err(pooled, serial), max_err(serial2, serial)
    load = loader_rates(clips)
    reset_counts()
    t_clu = run_stage("cluster", f"data.path={root}/pooled/{spec}.pkl",
                      f"data.output.path={root}/clusters", "data.batch_size=4",
                      "clustering.ncentroids=4", "clustering.epochs=4")
    after_cluster = counts()
    t_sel = run_stage("select", f"data.path={root}/clusters/{spec}.pkl",
                      f"data.output.path={out_csv}", f"data.meta.path={clips}")
    rows, want = csv_rows(out_csv), round(0.2 * n_clips)
    log(f"path C: extract {t_pool:.2f} s with 2 workers ({n_clips / t_pool:.2f} clips/s; the "
        f"workers import this script again), {t_serial:.2f} s with 0 ({n_clips / t_serial:.2f} "
        f"clips/s), each with model build and checkpoint loading ({t_build:.2f} s on the "
        f"card alone); taps with 2 workers differ from those with 0 by at most {err:.2e} of "
        f"the tap's max, two runs with 0 workers by {err_repeat:.2e}, a batch and its "
        f"reversal by {err_slot:.2e}; "
        f"cluster {t_clu:.2f} s; select {t_sel:.2f} s; {rows} csv rows (want {want}); "
        f"launches: extract {after_extract}, cluster {after_cluster}")
    log("path C, the loader alone in a python -c process (no model, no torch): "
        + "; ".join(f"{w} workers {n / t:.2f} clips/s ({n} clips in {t:.2f} s, first batch "
                    f"after {first:.2f} s)" for w, (n, t, first) in sorted(load.items())))
    log(f"path C, the extract with 0 workers under torch.profiler (device activity): kernels "
        f"{kernels:.3f} s, copies {copies:.3f} s: the card busy {100 * kernels / t_serial:.1f}% "
        f"of its {t_serial:.2f} s wall, {100 * kernels / t_pool:.1f}% of the 2-worker run's "
        f"{t_pool:.2f} s; {card()}")
    check(err <= 1e-4, "path C taps with 2 workers within 1e-4 of those with 0")
    check(rows == want, f"path C output.csv rows {rows} != {want}")
    check(after_extract["bottleneck_stage"] > 0, "K2 launched by path C's extract")
    check(after_cluster["kmeans_assign_update"] > 0, "K1 launched by path C's cluster")
    return {name: after_extract[name] + after_cluster[name] for name in after_extract}


def main_path_b() -> dict:
    feats, clus = WORK / "b" / "features", WORK / "b" / "clusters"
    out_csv = WORK / "b" / "output.csv"
    rng = np.random.RandomState(0)
    n_per_shard, n_shards = N_PER_SHARD, 2
    for si in range(n_shards):
        rows = []
        for ci in range(n_per_shard):
            per_model = [
                {"model_key": key, "extractor_name": name, "dataset": ds,
                 "array": [np.abs(rng.randn(d)).astype(np.float32) for d in dims]}
                for key, name, ds, dims in (
                    ("layer_vggish", "VGGish", "YouTube-8M", AUDIO_DIMS),
                    ("layer_slowfast", "SLOWFAST_8x8_R50", "kinetics-400", VIDEO_DIMS))
            ]
            rows.append(make_feature_row(f"clip_{si:03d}_{ci:04d}.npz",
                                         f"shard-{si:06d}", n_per_shard, per_model,
                                         ["layer_vggish"]))
        dump_pickle(rows, feats / f"shard-{si:06d}.pkl")
    spec = "shard-{000000..000001}"
    reset_counts()
    # defaults: K=32, B=1024, 2 epochs of 2 steps; warmup is 10 * 32 = 320
    # samples, so step 1 assigns at random and steps 2-4 run K1
    t_clu = run_stage("cluster", f"data.path={feats}/{spec}.pkl",
                      f"data.output.path={clus}")
    t_sel = run_stage("select", f"data.path={clus}/{spec}.pkl",
                      f"data.output.path={out_csv}")
    launches = counts()
    rows, want = csv_rows(out_csv), round(0.2 * n_shards * n_per_shard)
    log(f"path B: cluster {t_clu:.2f} s; select {t_sel:.2f} s; {rows} csv rows "
        f"(want {want}); launches {launches}")
    check(rows == want, f"output.csv rows {rows} != {want}")
    check(launches["kmeans_assign_update"] == 3, "K1 launched on steps 2-4")
    cluster_step_breakdown(feats / "shard-000000.pkl")
    return launches


def cluster_step_breakdown(shard: Path) -> None:
    """Where one post-warmup cluster step of path B goes: the host's
    ``stack_batch`` of 1024 rows into the padded (10, 1024, 2304) batch,
    its copy to the card, K1 on it (eager calls, as ``train_step`` makes
    them), and the whole ``train_step``; each the median of 5 runs."""
    from acav100m_torch.ops import kmeans
    from acav100m_torch.pipeline import clustering

    rows = load_pickle(shard)[:1024]
    types, dims = clustering.discover_types([shard])
    dmax = max(dims)
    stacked = clustering.stack_batch(rows, types, dmax)
    batch = torch.from_numpy(stacked).cuda()
    state = kmeans.init_state(dims, 32, generator=torch.Generator().manual_seed(0),
                              device=batch.device)
    state.count = 10 * 32 * 2  # past warmup: the step goes through K1
    threshold = (state.count / 32) ** 0.7
    t_stack = host_ms(lambda: clustering.stack_batch(rows, types, dmax))
    t_h2d = host_ms(lambda: torch.from_numpy(stacked).cuda())
    t_k1 = time_ms(lambda: fused_assign_update(state.centers, state.counts, batch, threshold,
                                               dims=state.dims))
    t_step = host_ms(lambda: kmeans.train_step(state, batch, 0.01))
    log(f"path B, one cluster step (B={len(rows)}, K=32, {len(dims)} clusterings, "
        f"{stacked.nbytes / 1e6:.1f} MB padded batch): stack_batch on the host "
        f"{t_stack:.3f} ms, H2D copy {t_h2d:.3f} ms, K1 {t_k1:.4f} ms, train_step "
        f"{t_step:.3f} ms; {card()}")


# -- phase 6: path D, the rest of stage 6 --------------------------------------

SPEC = "shard-{000000..000001}"
GREEDY_MEASURES = ("mem_mi", "mi", "ami", "nmi")


def path_b_partition():
    """Path B's one partition of assignments: (V x D matrix, filenames,
    pairs, C, the start index ``select`` draws)."""
    partitions = ss.load_partitions_data(ss.expand_shard_paths(
        f"{WORK}/b/clusters/{SPEC}.pkl"))
    check(len(partitions) == 1, "path B's assignments are one partition")
    (rows,) = partitions.values()
    a, _, filenames, types = ss.format_rows(rows)
    combos = ss.get_cluster_pairing(types, "combination")
    candidates = np.arange(len(a))
    np.random.RandomState(0).shuffle(candidates)
    return a, filenames, combos, int(a.max()) + 1, int(candidates[0])


def path_d1_chunks(root: Path) -> None:
    """Chunk mode, one shard a chunk, then ``reduce`` of its caches."""
    out = root / "chunks" / "output.csv"
    cfg = ss.get_config({"data.path": f"{WORK}/b/clusters/{SPEC}.pkl",
                         "data.output.path": str(out), "chunk_size": 1})
    trace = []
    t0 = time.time()
    _, count = ss.run_chunks(cfg, _trace=trace)
    t_all = time.time() - t0
    caches = sorted((root / "chunks" / "caches").glob("cache_*"))
    reduced = root / "chunks" / "reduced.csv"
    run_stage("reduce", str(reduced), *map(str, caches))
    events = {(e, i): t for e, i, t in trace}
    per_chunk = [events["select_done", i] - events["select_start", i] for i in range(2)]
    log(f"path D1, select chunk_size=1 (2 chunks of {N_PER_SHARD} clips, batch_mi): {t_all:.2f} s, "
        f"select per chunk {per_chunk[0]:.3f} / {per_chunk[1]:.3f} s; {len(caches)} cache "
        f"csvs, {count} rows; reduce's merge byte-equal to output.csv: "
        f"{reduced.read_bytes() == out.read_bytes()}")
    check(len(caches) == 2, "chunk mode writes 2 cache csvs")
    want = 2 * round(0.2 * N_PER_SHARD)
    check(count == csv_rows(out) == want, f"chunk mode output.csv rows {count} != {want}")
    check(reduced.read_bytes() == out.read_bytes(), "reduce's merge equals output.csv")


def path_d2_measures(root: Path, a, filenames, combos, ncentroids: int, start: int) -> None:
    """``select`` with each whole-pool measure in float32 through the CLI,
    then the same selector's greedy loop alone in float32 and float64 for
    its step times and peak device memory."""
    steps = round(0.2 * len(a)) - 2
    for measure in GREEDY_MEASURES:
        out = root / f"select_{measure}.csv"
        torch.cuda.reset_peak_memory_stats()
        t_sel = run_stage("select", f"data.path={WORK}/b/clusters/{SPEC}.pkl",
                          f"data.output.path={out}", f"measure_name={measure}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        rows = csv_rows(out)
        kind = "mi" if measure == "mem_mi" else measure
        loops = []
        for dtype in ("float32", "float64"):
            torch.cuda.reset_peak_memory_stats()
            sel = mi.GreedySelector(a, combos, ncentroids, kind=kind, dtype=dtype,
                                    scorer="mem" if measure == "mem_mi" else "full",
                                    device="cuda")
            picks, gains, lapse, _ = sel.run_greedy(steps + 2, [start], fold_start=False)
            loops.append(f"{dtype} {1e3 * np.median(lapse):.3f} ms median, "
                         f"{1e3 * np.mean(lapse):.3f} mean, peak "
                         f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
            check(len(lapse) == steps and all(math.isfinite(g) for g in gains),
                  f"select {measure} in {dtype}: {steps} steps, finite gains")
            if dtype == "float32":
                same = {line.split(",")[1] for line in out.read_text().splitlines()} == {
                    filenames[i] for i in picks}
                # the card's busy share of the first 100 steps, traced apart
                sel = mi.GreedySelector(a, combos, ncentroids, kind=kind,
                                        scorer="mem" if measure == "mem_mi" else "full",
                                        device="cuda")
                wall, busy, _ = device_busy(lambda: sel.run_greedy(102, [start],
                                                                   fold_start=False))
                loops.append(f"traced 100 steps: the card busy {1e3 * busy / 100:.3f} ms a "
                             f"step, {100 * busy / wall:.1f}% of the wall")
        log(f"path D2, select measure_name={measure} float32 at V={len(a)}, "
            f"P={len(combos)}, C={ncentroids}: {t_sel:.2f} s, {rows} rows (want {steps + 1}), "
            f"peak device memory {peak:.3f} GiB, the same clips as the loop below in "
            f"float32: {same}; greedy step over {steps} steps: " + "; ".join(loops))
        check(rows == steps + 1, f"select {measure}: {steps + 1} rows")


def path_d3_scorers(a, combos, ncentroids: int, start: int) -> None:
    """Every full-table scorer in float64 on one cache (start + 20 folded
    picks): all 2048 candidates on the card, the first 256 on the CPU."""
    sel = mi.GreedySelector(a, combos, ncentroids, scorer="mem", dtype="float64",
                            device="cuda")
    sel.run_greedy(22, [start])
    cache, pairs = sel.cache, sel.pairs_all
    cpu_cache = {k: v.cpu() for k, v in cache.items()}
    cache32 = {k: v.float() for k, v in cache.items()}
    n_cpu = 256
    errs = []
    for kind in mi._SCORE_FNS:
        card = mi.score_candidates_full(cache, pairs, ncentroids, kind)
        t0 = time.time()
        cpu = mi.score_candidates_full(cpu_cache, pairs[:n_cpu].cpu(), ncentroids, kind)
        t_cpu = time.time() - t0
        s32 = mi.score_candidates_full(cache32, pairs, ncentroids, kind).double()
        scale = float(card.abs().max())
        err = float((card[:n_cpu].cpu() - cpu).abs().max()) / scale
        err32 = float((s32 - card).abs().max()) / scale
        errs.append(f"{kind} {err:.2e} (float32 {err32:.2e}; CPU {t_cpu:.2f} s)")
        check(torch.isfinite(card).all() and err <= 1e-9, f"{kind} scores: card vs CPU")
    full = mi.score_candidates_full(cache, pairs, ncentroids, "mi")
    mem = mi.score_candidates_mem(cache, sel.stats, pairs, ncentroids)
    err_mem = float((full - mem).abs().max() / full.abs().max())
    log(f"path D3, float64 scores of {len(a)} candidates on the card against the first "
        f"{n_cpu} on the CPU, relative to the largest |score| (float32 on the card against "
        f"float64): " + "; ".join(errs) + f"; full MI against the incremental score "
        f"{err_mem:.2e}")
    check(err_mem <= 1e-9, "full-table MI vs the incremental score in float64")


def path_d4_compare(a, combos, ncentroids: int) -> None:
    cfg = ss.get_config({"data.path": f"{WORK}/b/clusters/{SPEC}.pkl"})
    t0 = time.time()
    report = ss.compare_measures(cfg)
    t_measures = time.time() - t0
    t0 = time.time()
    dtypes = ss.compare_dtypes(a, combos, ncentroids, subset_size=round(0.2 * len(a)))
    t_dtypes = time.time() - t0
    log(f"path D4, compare_measures (mi full vs mem_mi, float32, {t_measures:.2f} s): "
        f"{json.dumps(report['partitions'])}")
    log(f"path D4, compare_dtypes at V={len(a)} (batch_mi, float32 vs float64, "
        f"{t_dtypes:.2f} s): {json.dumps(dtypes)}")
    (part,) = report["partitions"].values()
    check(math.isfinite(part["max_gain_diff"]), "compare_measures report")
    check(dtypes["rounds"] > 0 and math.isfinite(dtypes["max_gain_diff"]),
          "compare_dtypes report")


def path_d5_contrastive(root: Path) -> None:
    """Contrastive selection on path B's feature pkls, then the probe
    trained again on the card and on the CPU from the same initial
    parameters (TF32 off), and ``merge_contrastive_csvs`` on a score csv."""
    shards = sorted((WORK / "b" / "features").glob("shard-*.pkl"))
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    out, count = cs.run_contrastive_selection(shards, root / "contrastive.csv")
    t_run = time.time() - t0
    want = round(0.2 * 2 * N_PER_SHARD)
    check(count == csv_rows(out) == want, f"contrastive selection rows {count}")
    video, audio, metas = cs.load_penultimate_features(shards)
    check(video.shape == (2 * N_PER_SHARD, 2304) and audio.shape == (2 * N_PER_SHARD, 128),
          "probe features")
    steps = 3 * math.ceil(len(video) / 128)
    torch.cuda.synchronize()
    t0 = time.time()
    probe = cs.train_probe(video, audio, device="cuda")
    torch.cuda.synchronize()
    t_card = time.time() - t0
    _, busy, _ = device_busy(lambda: cs.train_probe(video, audio, device="cuda"))
    t0 = time.time()
    probe_cpu = cs.train_probe(video, audio, device="cpu")
    t_cpu = time.time() - t0
    scores, scores_cpu = (cs.alignment_scores(p, video, audio) for p in (probe, probe_cpu))
    err = float(np.abs(scores - scores_cpu).max() / np.abs(scores_cpu).max())
    score_csv = root / "contrastive_scores.csv"
    with open(score_csv, "w") as f:
        for m, sc in zip(metas, scores):
            f.write(f"{m['shard_name']},{m['filename']},{float(sc)!r}\n")
    merged, n_merged = cs.merge_contrastive_csvs([score_csv], root / "contrastive_merged.csv")
    kept = [line.split(",") for line in merged.read_text().splitlines()]
    selected = {line.split(",")[1] for line in out.read_text().splitlines()}
    same = len(selected & {row[1] for row in kept})
    log(f"path D5, contrastive selection of {len(video)} clips (video 2304-d, audio 128-d; "
        f"3 epochs of batch 128, {steps} steps): run_contrastive_selection {t_run:.2f} s, "
        f"{count} rows; train_probe on the card {t_card:.3f} s ({1e3 * t_card / steps:.3f} ms "
        f"a step; the card busy {1e3 * busy / steps:.3f} ms a step under torch.profiler), "
        f"on the CPU {t_cpu:.2f} s; card scores vs the CPU's {err:.2e} of the "
        f"largest |score|; merge_contrastive_csvs kept {n_merged} rows, {same} of them "
        f"the ones run_contrastive_selection kept")
    check(np.isfinite(scores).all() and err <= 1e-4, "contrastive scores: card vs CPU")
    check(n_merged == len(kept) == want and all(math.isfinite(float(r[2])) for r in kept),
          f"merged contrastive csv: {want} rows of finite scores")


def main_path_d() -> None:
    """Path D on path B's assignments and features."""
    root = WORK / "d"
    a, filenames, combos, ncentroids, start = path_b_partition()
    reset_counts()
    path_d1_chunks(root)
    path_d2_measures(root, a, filenames, combos, ncentroids, start)
    path_d3_scorers(a, combos, ncentroids, start)
    path_d4_compare(a, combos, ncentroids)
    path_d5_contrastive(root)
    log(f"path D launches {counts()} (stage 6 has no hand-written kernel); {card()}")


# -- phase 7: path E, data parallelism across processes ------------------------------

E_STEPS = 3  # E2's post-warmup steps
E_GREEDY_STEPS = 64  # E3's full-table greedy steps
E_RANK_LIMIT_S = 600


def free_address() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def path_b_cache() -> Path:
    return WORK / "b" / "clusters" / f"cache_epoch_1_{SPEC}.pkl"


def host_ms(fn, reps: int = 5) -> float:
    """Median host time of ``fn()`` ended by a device synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def global_rows() -> np.ndarray:
    """Path B's 2048 feature rows stacked into the padded (10, 2048, 2304)
    batch, shard 0 first."""
    from acav100m_torch.pipeline import clustering

    shards = [WORK / "b" / "features" / f"shard-{si:06d}.pkl" for si in range(2)]
    types, dims = clustering.discover_types(shards)
    rows = [r for p in shards for r in load_pickle(p)]
    return clustering.stack_batch(rows, types, max(dims))


def path_e1_nccl_one_rank() -> dict:
    """Path B's cluster training again through a one-rank NCCL group: the
    state must be bit-equal to path B's; then one all-reduce of the deltas
    and one sharded step, timed."""
    from acav100m_torch.ops import kmeans
    from acav100m_torch.pipeline import clustering

    group = runtime.initialize_runtime(free_address(), 1, 0, device="cuda:0")
    try:
        check(group.backend == "nccl", "E1 runs over NCCL")
        cfg = clustering.get_config({"data.path": f"{WORK}/b/features/{SPEC}.pkl",
                                     "data.output.path": str(WORK / "e" / "clusters")})
        reset_counts()
        t0 = time.time()
        state, _, _ = clustering.train_clusters(cfg, group)
        t_train = time.time() - t0
        launches = counts()
        want, _, _ = clustering.load_centroids(path_b_cache())
        written, _, _ = clustering.load_centroids(WORK / "e" / "clusters" / path_b_cache().name)
        same = all(torch.equal(getattr(s, f).cpu(), getattr(want, f))
                   for s in (state, written) for f in ("centers", "counts", "fallback"))
        check(same and state.count == written.count == want.count,
              "E1: the one-rank NCCL state bit-equal to path B's")
        check(launches["kmeans_assign_update"] == 3, "E1: K1 launched on steps 2-4")
        deltas = torch.randn(tuple(state.centers.shape), device=group.device)
        t_reduce = time_ms(lambda: runtime.all_reduce_sum(deltas, group))
        batch = torch.from_numpy(global_rows()[:, :N_PER_SHARD]).to(group.device)
        t_step = host_ms(lambda: kmeans.train_step(state, batch, 0.01, group=group))
        log(f"path E1, cluster (path B's config) through a one-rank NCCL group: {t_train:.2f} s, "
            f"state and cache_epoch_1 bit-equal to path B's; one all-reduce of the "
            f"{deltas.numel() * 4 / 1e6:.2f} MB deltas {t_reduce:.4f} ms (CUDA events, median of "
            f"20); one sharded train_step of {N_PER_SHARD} rows {t_step:.3f} ms (host, median of "
            f"5); launches {launches}; {card()}")
        return launches
    finally:
        runtime.shutdown_runtime(group)


def e2_rank(group, root: Path) -> dict:
    """Post-warmup cluster steps from path B's state, this rank on its
    slice of path B's 2048 rows; K1's assignments of them at each step."""
    from acav100m_torch.ops import kmeans
    from acav100m_torch.pipeline import clustering

    state, _, _ = clustering.load_centroids(path_b_cache(), group.device)
    stacked = global_rows()
    per = stacked.shape[1] // group.world_size
    local = torch.from_numpy(np.ascontiguousarray(
        stacked[:, group.rank * per:(group.rank + 1) * per])).to(group.device)
    launches = dict.fromkeys(counts(), 0)
    times = []
    for i in range(E_STEPS):
        threshold = kmeans._threshold(state.count, state.centers.shape[1], 0.7)
        # the check's reference: K1's assignments, outside the counted window
        best = fused_assign_update(state.centers, state.counts, local, threshold,
                                   dims=state.dims)[0]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        state, _ = kmeans.train_step(state, local, 0.01, group=group)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        for name, n in counts().items():
            launches[name] += n
        np.savez(root / f"e2_rank{group.rank}_step{i}.npz", best=best.cpu().numpy(),
                 centers=state.centers.cpu().numpy(), counts=state.counts.cpu().numpy())
    deltas = torch.randn(tuple(state.centers.shape), device=group.device)
    t_reduce = host_ms(lambda: runtime.all_reduce_sum(deltas, group), reps=20)
    return {"count": state.count, "step_ms": times, "all_reduce_ms": t_reduce,
            "launches": launches}


def e2_check(results: list, root: Path) -> None:
    """The ranks' steps against one rank's step on all 2048 rows: K1's
    assignments equal on every row without a 1e-4 near-tie; while every row
    agrees, counts equal and centers within 1e-5 of their max; the ranks'
    states bit-identical to each other."""
    from acav100m_torch.ops import kmeans
    from acav100m_torch.pipeline import clustering

    world = len(results)
    for r in results:
        check(r["launches"]["kmeans_assign_update"] == E_STEPS,
              f"E2: K1 launched once a step on every rank ({r['launches']})")
    state, _, _ = clustering.load_centroids(path_b_cache(), "cuda")
    batch = torch.from_numpy(global_rows()).cuda()
    agree = True
    for i in range(E_STEPS):
        k = state.centers.shape[1]
        threshold = kmeans._threshold(state.count, k, 0.7)
        # comparison launches, not counted
        want_best = fused_assign_update(state.centers, state.counts, batch, threshold,
                                        dims=state.dims)[0]
        dist = discounted_distances(state.centers, state.counts, batch, threshold)
        two = dist.topk(2, dim=-1, largest=False).values
        decisive = ((two[..., 1] - two[..., 0]) > 1e-4 * two[..., 0].abs()).cpu().numpy()
        state, _ = kmeans.train_step(state, batch, 0.01)
        ranks = [np.load(root / f"e2_rank{r}_step{i}.npz") for r in range(world)]
        best = np.concatenate([r["best"] for r in ranks], axis=1)
        differ = best != want_best.cpu().numpy()
        flips, near = int((differ & decisive).sum()), int((differ & ~decisive).sum())
        check(flips == 0, f"E2 step {i}: K1's assignments on decisive rows")
        for r in ranks[1:]:
            check(all(np.array_equal(r[f], ranks[0][f]) for f in ("centers", "counts")),
                  f"E2 step {i}: every rank holds the same state")
        agree = agree and near == 0
        if agree:
            want_c = state.centers.cpu().numpy()
            err = float(np.abs(ranks[0]["centers"] - want_c).max() / np.abs(want_c).max())
            check(np.array_equal(ranks[0]["counts"], state.counts.cpu().numpy()),
                  f"E2 step {i}: counts equal")
            check(err <= 1e-5, f"E2 step {i}: centers within 1e-5 of their max ({err:.2e})")
            log(f"path E2 step {i}: assignments equal on all {best.size} rows, counts equal, "
                f"centers within {err:.2e} of their max")
        else:
            log(f"path E2 step {i}: {near} near-tie rows assigned otherwise; counts and "
                f"centers not compared from here on")
    check(all(r["count"] == state.count for r in results), "E2: count advanced by 2048 a step")


def e3_rank(group) -> dict:
    """Path D's selectors with the candidates split over the ranks."""
    a, _, combos, ncentroids, start = path_b_partition()
    out = {}
    rng = np.random.RandomState(0)
    rng.shuffle(np.arange(len(a)))
    sel = mi.BatchGreedySelector(a, combos, ncentroids, batch_size=20, selection_size=4,
                                 rng=rng, dtype="float64", group=group)
    picks, gains, lapse, _ = sel.run_greedy(round(0.2 * len(a)), [start])
    out["batch_mi"] = {"picks": picks, "gains": gains, "ms": 1e3 * float(np.median(lapse))}
    for kind in ("mi", "ami"):
        torch.cuda.reset_peak_memory_stats(group.device)
        sel = mi.GreedySelector(a, combos, ncentroids, kind=kind, scorer="full",
                                dtype="float64", group=group)
        picks, gains, lapse, _ = sel.run_greedy(E_GREEDY_STEPS + 2, [start], fold_start=False)
        out[kind] = {"picks": picks, "gains": gains, "ms": 1e3 * float(np.median(lapse)),
                     "peak_gib": torch.cuda.max_memory_allocated(group.device) / 2**30}
    return out


def e3_check(results: list) -> None:
    """Each rank's picks against the single-rank card run's: equal, or where
    they part, both picks maxima within 1e-12 (float64); the full-table
    picks replayed through the single-rank scorer, each a maximum within
    1e-12 of the step's best."""
    a, _, combos, ncentroids, start = path_b_partition()
    for r in results[1:]:
        check(all(r[k]["picks"] == results[0][k]["picks"] and r[k]["gains"] == results[0][k]["gains"]
                  for k in r), "E3: every rank picks the same")
    got = results[0]
    rng = np.random.RandomState(0)
    rng.shuffle(np.arange(len(a)))
    sel = mi.BatchGreedySelector(a, combos, ncentroids, batch_size=20, selection_size=4,
                                 rng=rng, dtype="float64", device="cuda")
    picks, gains, lapse, _ = sel.run_greedy(round(0.2 * len(a)), [start])
    lines = []
    same = 0
    for i in range(0, len(picks), 4):
        if picks[i:i + 4] == got["batch_mi"]["picks"][i:i + 4]:
            same += len(picks[i:i + 4])
            continue
        check(np.allclose(sorted(gains[i:i + 4]), sorted(got["batch_mi"]["gains"][i:i + 4]),
                          rtol=0, atol=1e-12), "E3 batch_mi: differing winners tie")
        break
    lines.append(f"batch_mi {same} of {len(picks)} picks equal before any difference, "
                 f"{got['batch_mi']['ms']:.3f} ms a round (single rank "
                 f"{1e3 * np.median(lapse):.3f})")
    for kind in ("mi", "ami"):
        torch.cuda.reset_peak_memory_stats()
        single = mi.GreedySelector(a, combos, ncentroids, kind=kind, scorer="full",
                                   dtype="float64", device="cuda")
        picks, _, lapse, _ = single.run_greedy(E_GREEDY_STEPS + 2, [start], fold_start=False)
        peak = torch.cuda.max_memory_allocated() / 2**30
        replay = mi.GreedySelector(a, combos, ncentroids, kind=kind, scorer="full",
                                   dtype="float64", device="cuda")
        replay.active[start] = False
        worst = 0.0
        for pick in got[kind]["picks"][1:]:
            scores = replay.scores()
            scores[~replay.active] = -np.inf
            worst = max(worst, float(scores.max() - scores[pick]))
            replay.add_samples([pick])
        n_same = next((i for i, (u, v) in enumerate(zip(picks, got[kind]["picks"]))
                       if u != v), len(picks))
        check(worst <= 1e-12, f"E3 {kind}: every pick a maximum within 1e-12")
        lines.append(f"{kind} {n_same} of {len(picks)} picks equal, every pick a maximum "
                     f"within {worst:.1e}, {got[kind]['ms']:.3f} ms a step (single rank "
                     f"{1e3 * np.median(lapse):.3f}), peak {got[kind]['peak_gib']:.3f} GiB a "
                     f"rank (single rank {peak:.3f})")
    log(f"path E3, selectors at V={len(a)}, P={len(combos)}, C={ncentroids} in float64, "
        f"{len(results)} ranks against one: " + "; ".join(lines))


def e4_rank(group) -> dict:
    """Equalized extraction of path E's clips over the ranks."""
    root = WORK / "e"
    cfg = fe.get_config({"data.media.path": f"{root}/clips/shard-{{000000..000002}}.tar",
                         "data.output.path": str(root / "features_ranks"),
                         "data.batch_size": 4, "computation.equalize_length": True})
    models = fe.build_models(cfg, group.device)
    forwards = []
    models["layer_slowfast"].register_forward_hook(lambda *_: forwards.append(1))
    log_lines = io.StringIO()
    reset_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(log_lines):  # one "iter N" line a step
        saved = fe.run_extraction(cfg, models=models, group=group)
    seconds = time.time() - t0
    steps = sum("] iter " in line for line in log_lines.getvalue().splitlines())
    return {"steps": steps, "forwards": len(forwards),
            "saved": sorted(Path(p).name for p in saved), "seconds": seconds,
            "launches": counts()}


def e4_check(results: list, root: Path) -> None:
    """Equal step counts, every shard once, taps within 1e-4 of a one-rank
    run's."""
    cfg = fe.get_config({"data.media.path": f"{root}/clips/shard-{{000000..000002}}.tar",
                         "data.output.path": str(root / "features_one"), "data.batch_size": 4})
    t0 = time.time()
    fe.run_extraction(cfg)
    t_one = time.time() - t0
    check(len({r["steps"] for r in results}) == 1, "E4: every rank steps the same number of times")
    check(sum(r["forwards"] for r in results) == 3,
          f"E4: the models run on the 3 real batches only, no pad ({results})")
    saved = sorted(n for r in results for n in r["saved"])
    check(saved == [f"shard-{i:06d}.pkl" for i in range(3)],
          f"E4: every shard saved once ({[r['saved'] for r in results]})")
    one = check_features(root / "features_one", 12)
    ranks = check_features(root / "features_ranks", 12)
    check(set(one) == set(ranks), "E4: the same clips and taps")
    err = max(float(np.abs(ranks[k] - one[k]).max() / max(np.abs(one[k]).max(), 1e-30))
              for k in one)
    check(err <= 1e-4, f"E4: taps within 1e-4 of the one-rank run's ({err:.2e})")
    for r in results:
        check(r["launches"]["bottleneck_stage"] > 0, "E4: K2 launched on every rank")
    log(f"path E4, equalized extraction of 3 shards x 4 clips over {len(results)} ranks: "
        f"steps {[r['steps'] for r in results]}, model forwards "
        f"{[r['forwards'] for r in results]}, K2 launches "
        f"{[r['launches']['bottleneck_stage'] for r in results]}, "
        f"{[round(r['seconds'], 2) for r in results]} s a rank (model build not included); "
        f"one rank {t_one:.2f} s (model build included); taps within {err:.2e} of the "
        f"one-rank run's")


def path_e_rank(rank: int, world: int, address: str, backend: str, device: str,
                scenarios, root: str) -> None:
    """One rank of path E (a spawned process): joins the group, runs the
    scenarios, writes its results."""
    root = Path(root)
    group = runtime.initialize_runtime(address, world, rank, device=device, backend=backend,
                                       timeout_s=E_RANK_LIMIT_S)
    out = {}
    try:
        if "e1" in scenarios:
            from acav100m_torch.pipeline import clustering

            cfg = clustering.get_config({"data.path": f"{WORK}/b/features/{SPEC}.pkl",
                                         "data.output.path": str(root / "clusters_ranks")})
            state, _, _ = clustering.train_clusters(cfg, group)
            out["e1"] = {"sha256": hashlib.sha256(state.centers.cpu().numpy().tobytes()
                                                  + state.counts.cpu().numpy().tobytes()
                                                  ).hexdigest(), "count": state.count}
        if "e2" in scenarios:
            out["e2"] = e2_rank(group, root)
        if "e3" in scenarios:
            out["e3"] = e3_rank(group)
        if "e4" in scenarios:
            out["e4"] = e4_rank(group)
    finally:
        runtime.shutdown_runtime(group)
    (root / f"rank{rank}.json").write_text(json.dumps(out))


def spawn_ranks(world: int, backend: str, devices, scenarios, root: Path) -> list:
    """``world`` spawned ranks of ``path_e_rank``; fails on a rank's exit code
    or past the limit, and returns each rank's results."""
    root.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    address = free_address()
    procs = [ctx.Process(target=path_e_rank, args=(r, world, address, backend, devices[r],
                                                     list(scenarios), str(root)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + E_RANK_LIMIT_S
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.time()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    check(not alive, f"path E ranks within {E_RANK_LIMIT_S} s")
    check(all(p.exitcode == 0 for p in procs),
          f"path E ranks exit codes {[p.exitcode for p in procs]}")
    return [json.loads((root / f"rank{r}.json").read_text()) for r in range(world)]


def main_path_e() -> dict:
    """Path E on path B's feature pkls and assignments; returns its launches."""
    root = WORK / "e"
    launches = path_e1_nccl_one_rank()
    write_npz_shards(root / "clips", n_shards=3, per_shard=4)
    t0 = time.time()
    results = spawn_ranks(2, "gloo", ["cuda:0", "cuda:0"], ("e2", "e3", "e4"), root / "gloo")
    log(f"path E, 2 ranks sharing cuda:0 over gloo: {time.time() - t0:.1f} s from spawn to "
        f"exit")
    e2 = [r["e2"] for r in results]
    log(f"path E2, {E_STEPS} post-warmup cluster steps of 2 x {N_PER_SHARD} rows over gloo "
        f"(both ranks on cuda:0): ms a step {[[round(t, 3) for t in r['step_ms']] for r in e2]}, "
        f"one all-reduce of the deltas {[round(r['all_reduce_ms'], 3) for r in e2]} ms "
        f"(host, median of 20); {card()}")
    e2_check(e2, root / "gloo")
    e3_check([r["e3"] for r in results])
    e4_check([r["e4"] for r in results], root)
    for r in results:
        for part in ("e2", "e4"):
            for name, n in r[part]["launches"].items():
                launches[name] += n
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        world = min(n_cards, 4)
        results = spawn_ranks(world, "nccl", [f"cuda:{r}" for r in range(world)], ("e1", "e2"),
                              root / "nccl")
        check(len({json.dumps(r["e1"]) for r in results}) == 1,
              "E1 over NCCL: every rank holds the same state")
        e2_check([r["e2"] for r in results], root / "nccl")
        log(f"path E over NCCL, {world} ranks on {world} cards: E1 states equal; E2 ms a step "
            f"{[[round(t, 3) for t in r['e2']['step_ms']] for r in results]}, all-reduce "
            f"{[round(r['e2']['all_reduce_ms'], 3) for r in results]} ms")
        for r in results:
            for name, n in r["e2"]["launches"].items():
                launches[name] += n
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(WORK, ignore_errors=True)
    # phase 1
    t0 = time.time()
    cuda_build.build([name for name, _, _ in KERNELS])
    log(f"built {len(KERNELS)} kernels in {time.time() - t0:.1f} s: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in cuda_build.build_seconds.items()))
    log(card())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    # phase 2, TF32 off for the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    results = {"kmeans_assign_update": check_k1(gen), "bottleneck_stage": check_k2(gen),
               "bottleneck_stage_bf16": check_k2_bf16(gen)}
    # phase 3: the default precision again (cuDNN convs in TF32)
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.time()
    launches, f32_taps = main_path_a(gen)
    log(f"path A total {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["bottleneck_stage_bf16"] = main_path_a_bf16(f32_taps)["bottleneck_stage_bf16"]
    log(f"path A-bf16 total {time.time() - t0:.1f} s")
    t0 = time.time()
    for name, n in main_path_c(gen).items():
        launches[name] += n
    log(f"path C total {time.time() - t0:.1f} s")
    main_path_b()
    t0 = time.time()
    main_path_d()
    log(f"path D total {time.time() - t0:.1f} s")
    t0 = time.time()
    for name, n in main_path_e().items():
        launches[name] += n
    log(f"path E total {time.time() - t0:.1f} s")
    shutil.rmtree(WORK, ignore_errors=True)
    kernels = []
    for name, _, replaces in KERNELS:
        kernels.append({"name": name, "route": "cuda",
                        "source": f"acav100m_torch/csrc/{name}.cu",
                        "replaces": replaces, "launches": launches[name],
                        **results[name]})
        check(launches[name] > 0, f"{name} launched on the main path")
        check(all(math.isfinite(v) for v in (results[name]["ms"],
                                             results[name]["plain_ms"])), name)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

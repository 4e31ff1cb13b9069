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
4. main path B at production widths: ``cluster`` (K=32, B=1024) ->
   ``select`` on 2 shards x 1024 synthetic feature rows.

Then one JSON line of per-kernel results and, last, the device JSON line.
Any failed check raises, so the script exits non-zero. Without a CUDA
device it exits at once and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from acav100m_torch import cli
from acav100m_torch.ablate_k1 import COLD_SETS, TAP_DIMS, k1_inputs
from acav100m_torch.models import init_weights
from acav100m_torch.models.slowfast import LayerSlowFast, ResBlock
from acav100m_torch.ops import cuda_build
from acav100m_torch.ops.bottleneck_kernel import fused_stage, fused_stage_bf16, fused_stage_ref
from acav100m_torch.ops.kmeans_kernel import (
    discounted_distances,
    fused_assign_update,
    fused_assign_update_ref,
)
from acav100m_torch.profiling import card, time_cold_ms, time_ms
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


def main_path_b() -> dict:
    feats, clus = WORK / "b" / "features", WORK / "b" / "clusters"
    out_csv = WORK / "b" / "output.csv"
    rng = np.random.RandomState(0)
    n_per_shard, n_shards = 1024, 2
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

    def host_ms(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

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
    main_path_b()
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

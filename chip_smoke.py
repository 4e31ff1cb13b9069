"""Smoke run of the PyTorch/CUDA port (``acav100m_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. build the hand-written kernels from ``acav100m_torch/csrc`` (one nvcc
   per source, started together) and print the card's name and power limit;
2. hold each kernel against its plain PyTorch version at the main paths'
   shapes (TF32 off), and time kernel, plain version and library yardstick
   with CUDA events around back-to-back calls; K2 in both forms, float32
   and bfloat16; the non-local core's kernel at ``res3``'s and ``res4``'s
   shapes (batch 32), beside two cuBLAS ``bmm`` calls; stage 6's fused
   greedy step at ``select.fp32.batch_mi``'s shapes (V 32000, P 45, C 32,
   B 20, k 4) against its plain twin, and its time beside the eager chain's;
   the conv epilogue at the 93 shapes of one SlowFast forward (batch 32) in
   float32 and bf16, bit for bit against its twin;
3. main path A through the port's CLI: ``fixtures`` (2 shards x 8 clips,
   32 frames of 256x256) -> ``extract`` (SlowFast 8x8 R50 + VGGish at full
   width, float32, seeded random weights) -> ``cluster`` -> ``select``;
   then path A-bf16 on the same clips, in the JAX package's headline
   configuration (``computation.dtype=bfloat16
   computation.fast_block=[4,4,4,4,4]``): ``extract`` -> ``cluster`` ->
   ``select``, its taps held against path A's; then path A-nln on the same
   clips, ``extract`` with SLOWFAST_NLN_8x8_R50 (``layer_slowfast_nln``) in
   bf16, five launches of the non-local kernel a batch;
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
   CPU's (TF32 off), and ``merge_contrastive_csvs``; D6 a whole
   ``run_greedy`` at ``select.fp32.batch_mi``'s shapes through the fused
   step and through the eager chain on the same seed, each replayed in
   float64 along its own picks (``benchmark/reference/batch_mi.py``), with
   ``batch_mi.launches``. Every float32 ``batch_mi`` on the card (paths A,
   B, C, D, F) is the fused step;
7. path E, data parallelism (``acav100m_torch.runtime``) on path B's and
   D's inputs: E1 path B's cluster training through a one-rank NCCL group,
   bit-equal to path B's, with one all-reduce of the deltas and one
   sharded step timed; then 2 spawned ranks sharing ``cuda:0`` over gloo
   (NCCL refuses two ranks on one device): E2 post-warmup cluster steps of
   2 x 1024 rows against one rank's step on the 2048 rows, E3 the
   selectors (``batch_mi``, ``mi`` and ``ami`` full-table, float64) against
   one rank's picks, E4 equalized extraction of 3 npz shards x 4 clips
   against a one-rank run. With more than one card, E1 and E2 run again
   over NCCL on ``min(count, 4)`` cards;
8. path F, int8 extraction (``computation.quant=int8``) and stages 2-3: F1
   extracts path A's clips on path C's checkpoints three times, float32 fp
   (the reference), int8 in float32 and the JAX package's int8 leg (bf16,
   ``fast_block=[4,4,4,4,4]``, int8), then ``cluster`` and ``select`` on
   each: K2 and K2-bf16 never launch in int8, every video tap's cosine to
   the fp tap is above 0.99, video assignment agreement at least 0.75 and
   subset overlap at least 0.6 (the JAX package's gates); the int8 conv's
   int32 sums on the card equal the CPU's on every conv geometry of the
   model at full width; each block of the slow ``s3`` int8 stage on the
   card, from the CPU's input with the same scales, moves no int8 activation
   by more than one step (BN rounds otherwise on the card), at most 1e-3 of
   them, and stays within 1e-3 relative L2 of the CPU's output; one warm
   batch's
   device time in float32, bf16 and both int8 legs, the int8 GEMM's share
   and the calibration pass. F2 runs stages 2-3 on OpenCV (this machine
   has no FFmpeg): two OpenCV-written videos of three constant-colour
   scenes through ``download --source_dir``, ``segment --backend opencv``
   and ``bundle_shards``, then ``extract`` (``data.decoder=opencv``, int8),
   ``cluster`` and ``select``, with the row counts checked at each stage.
   Stage 1 is host text work whose ``nltk`` this machine lacks: the CPU
   tests hold it;
9. path G, correspondence retrieval (``retrieval`` through the port's
   CLI): G0 K1 at every shape path G gives it (M=1, K=10, B 64 and its
   tails 44 and 52, D 16, 32, 256, 512, 1024 and 2048, and 8 with a real
   width of 6) against its plain version and timed; G1 gaussian views with
   sgd k-means (K1) and greedy MI on the card, its picks equal to the same
   run on the CPU; G2 ResNet-50 at full width on the digits stand-in (10
   classes x 50, 32x32): its four taps card against CPU (TF32 off),
   ``--dataset resnet_pairs`` with sgd (K1 at D 1024 and 2048) card against
   CPU, and with scipy's k-means, whose F1 must beat the constant measure's;
   G3 ``--dataset mnist_sound`` (all four taps, log-mel on the card)
   likewise; G4 a 2-job ``--grid`` inline and on two spawned workers
   sharing the card, with the same results. Every shape K1 met in G1-G4 must
   be one that G0 checked;
10. path H, the evaluation suite (``evaluate`` through the port's CLI) at
   full width, R3D-50 width 64 on 8 x 112^2 and the audio ResNet-50 width
   32 on 80 x 128 log-mels: H0 one AdamW step at batch 2 from one seeded
   numpy weight tree, card against CPU in float64 (loss 1e-4, every
   parameter 1e-4 relative L2, running statistics 1e-5, accuracy equal),
   and in float32 each device against the float64 CPU step (the card's
   loss and params within 3 times the CPU's own float32 error); H1
   ``fixtures --labels`` (4 shards
   x 8 clips at 128^2); H2 ``evaluate`` with ``configs/acav_pretrain.yaml``'s
   values as JSON, batch 4, 8 steps (every loss finite, checkpoints and
   ``stats.jsonl`` written, peak memory), resumed to 12 (it must resume at
   step 8, the card's busy share printed), then a warm step's operations,
   ms and device time by kernel; H3 ``evaluate task=linear_eval`` on
   ``classify/`` from H2's checkpoint, multimodal, 20 head steps, with and
   without cached features (top-1/top-5), and the test views' frozen
   features card against CPU (TF32 off, 1e-4). Path H launches none of the
   four kernels;
11. paths H4 and H5 at the same widths. H4, the sharded pretrain step
   (``make_pretrain_step(state, group)``): a float64 step (TF32 off) at a
   global batch of 4 on 2 spawned gloo ranks sharing ``cuda:0``, on a
   one-rank NCCL group and, with more cards, on 2 or 4 NCCL ranks, one a
   card: the ranks bit-identical, each against the unsharded card step on
   the same rows (params 1e-9 relative L2, loss 1e-10); then float32 at a
   global batch of 8, each rank's warm step, its gradient all-reduce and
   batch-norm collectives timed one by one, peak memory, beside the
   unsharded step's. H5, bf16 (``init_pretrain(dtype=torch.bfloat16)``):
   the card's eval-mode embeddings at batch 4 against its float64 ones
   within 3 times the CPU's own bf16 error; a bf16 train step with finite
   losses, float32 parameters and statistics, its warm ms, kernels and
   peak memory beside the float32 step's. Neither launches a kernel of the
   table.

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
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tarfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from acav100m_torch import cli, runtime, tracing
from acav100m_torch.ablate_k1 import COLD_SETS, TAP_DIMS, k1_inputs
from acav100m_torch.models import init_weights, zoo
from acav100m_torch.models.slowfast import LayerSlowFast, ResBlock
from acav100m_torch.models.vggish import LayerVggish
from acav100m_torch.ops import cuda_build
from acav100m_torch.ops.bottleneck_kernel import (
    fused_stage,
    fused_stage_bf16,
    fused_stage_ref,
    pack_block_bf16,
    pack_block_f32,
)
from acav100m_torch.ops.kmeans_kernel import (
    discounted_distances,
    fused_assign_update,
    fused_assign_update_ref,
)
from acav100m_torch.ops import mi
from acav100m_torch.ops.conv_epilogue import conv_epilogue, conv_epilogue_ref
from acav100m_torch.ops.nonlocal_kernel import nonlocal_core, nonlocal_core_ref
from acav100m_torch.pipeline import contrastive_selection as cs
from acav100m_torch.pipeline import feature_extraction as fe
from acav100m_torch.pipeline import subset_selection as ss
from acav100m_torch.profiling import (card, device_busy, graphed, profile_calls,
                                      run as profile_run, time_cold_ms, time_ms)
from acav100m_torch.utils.io import dump_pickle, load_pickle, make_feature_row

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
TF32_TENSOR_FLOPS = 495e12  # dense TF32 on the tensor cores
BF16_TENSOR_FLOPS = 989e12  # dense bf16 on the tensor cores
AUDIO_DIMS = [64, 128, 256, 512, 128]
VIDEO_DIMS = [88, 352, 704, 1408, 2304]
KERNELS = [  # (source, tracing counter of its launches, the TPU kernel it ports)
    ("kmeans_assign_update", "k1.launches",
     "acav100m_tpu/ops/pallas/kmeans_kernel.py:85"),
    ("bottleneck_stage", "k2_fp32.launches",
     "acav100m_tpu/ops/pallas/bottleneck_kernel.py:116"),
    ("bottleneck_stage_bf16", "k2_bf16.launches",
     "acav100m_tpu/ops/pallas/bottleneck_kernel.py:116"),
    ("nonlocal_core_bf16", "nln_bf16.launches",
     "none: the JAX package has no non-local block"),
    ("batch_mi_step", "batch_mi.launches",
     "none: the JAX package's jitted greedy step (acav100m_tpu/ops/mi.py), no Pallas kernel"),
    ("conv_epilogue", "epilogue.launches",
     "none: XLA fuses conv, BN, ReLU and the residual for the JAX package"),
]
# the non-local blocks' cores at a batch of 32 clips of 32 frames at 256^2:
# (label, blocks a batch, N, Ci, Nq, Nk)
NLN_SHAPES = (("res3", 2, 32, 256, 8192, 2048), ("res4", 3, 32, 512, 2048, 512))
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


_counting = None  # the open tracing.enabled() that counts the launches


def reset_counts() -> None:
    """Count launches from here: a fresh ``tracing.enabled()``."""
    global _counting
    if _counting is not None:
        _counting.__exit__(None, None, None)
    _counting = tracing.enabled()
    _counting.__enter__()


def counts():
    c = tracing.counters()
    return {name: c.get(counter, 0) for name, counter, _ in KERNELS}


# -- phase 2: kernels against their plain versions --------------------------------

def k1_compare(args, dims, label: str) -> float:
    """K1 on ``args`` (centers, counts, batch, threshold) told ``dims``,
    against its plain version: argmin equal on every row whose two nearest
    centers are more than 1e-4 apart, counts, deltas and the mean min-distance
    within 1e-4 relative of those of K1's own argmin, two launches bitwise
    equal and equal to the launch without ``dims``. Returns the deltas'
    largest absolute error."""
    centers, cnt, batch, threshold = args
    m, k, _ = centers.shape
    b = batch.shape[1]
    underused = int((cnt < threshold).sum())
    check(0 < underused < m * k, f"K1 at {label}: some centers underused")
    best, c_add, deltas, mean = out = fused_assign_update(*args, dims=dims)
    again = fused_assign_update(*args, dims=dims)
    padded = fused_assign_update(*args)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(out, again)),
          f"K1 at {label}: two launches bitwise equal")
    check(all(torch.equal(u, v) for u, v in zip(out, padded)),
          f"K1 at {label}: the same bytes with dims as on the padded input")
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
    log(f"K1 {label}: best differs on {flips} of {int(decisive.sum())} decisive "
        f"rows ({int((best != best_p).sum())} of {m * b} in all); counts rel err "
        f"{err_c:.2e}, deltas rel err {err_d:.2e}, mean min-dist rel err {err_m:.2e}; "
        f"{underused} of {m * k} centers underused; two launches bitwise equal, and "
        f"equal to the launch without dims")
    check(flips == 0, f"K1 argmin at {label}")
    check(err_c <= 1e-4 and err_d <= 1e-4 and err_m <= 1e-4, f"K1 sums at {label}")
    return abs_d


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
        m, _, d = args[0].shape
        abs_d = k1_compare(args, dims, f"K={k} B={b}")
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
            packed = [pack_block_f32(blk) for blk in folded]  # as the model caches them
            x = torch.randn((n, hw, hw, cin), generator=gen).cuda()
            out = fused_stage(x, folded, stride, packed)
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
                ms = time_ms(lambda: fused_stage(x, folded, stride, packed))
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
            packed = [pack_block_bf16(blk) for blk in folded]  # as the model caches them
            x = torch.randn((n, hw, hw, cin), generator=gen).cuda().to(torch.bfloat16)
            out = fused_stage_bf16(x, folded, stride, packed)
            again = fused_stage_bf16(x, folded, stride, packed)
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
                ms = time_ms(lambda: fused_stage_bf16(x, folded, stride, packed))
                plain = time_ms(lambda: fused_stage_ref(x, folded, stride))
                library = time_ms(canonical)
                px = n * hw * hw
                flops = sum(2 * px * v.numel() for blk in folded
                            for key, v in blk.items() if key.endswith("w"))
                nbytes = (2 * (x.numel() + out.numel())
                          + sum(v.numel() * v.element_size()
                                for blk in folded for v in blk.values()))
                bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
                # one launch a block writes and reads back each inner block output
                between = 2 * 2 * out.numel() * (len(folded) - 1)
                floor_ms = (nbytes + between) / HBM_BYTES_PER_S * 1e3
                result = dict(max_abs_err=float(diff.max()), ms=ms, plain_ms=plain,
                              bound_ms=bound_ms, bound_by=bound_by, library_ms=library)
                log(f"K2-bf16 s2_slow at {n} frames (4 clips) 64x64, 80->256: {ms:.4f} ms, "
                    f"plain {plain:.4f} ms, canonical cuDNN stage in bf16 {library:.4f} ms, "
                    f"bound {bound_ms:.4f} ms ({bound_by}; {flops / 1e9:.2f} GFLOP, "
                    f"{nbytes / 1e6:.1f} MB); bytes floor of one launch a block "
                    f"{floor_ms:.4f} ms ({(nbytes + between) / 1e9:.3f} GB)")
    return result


def check_nln(gen: torch.Generator) -> dict:
    """The non-local core's kernel at the main path's two shapes (batch 32)
    against its plain twin on the same bf16 inputs (every element within a
    bf16 step of the twin's largest, at least 95% of them bit-equal: the two
    sum in other orders, and a sum on a rounding boundary of A^T or y lands
    on its other side), two launches bitwise equal; timed (CUDA events,
    median of 20) beside the twin and two cuBLAS ``bmm`` calls in each
    order. Returns a batch's five blocks' times."""
    result = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
              "max_abs_err": 0.0}
    for label, blocks, n, ci, nq, nk in NLN_SHAPES:
        theta = torch.randn((n, ci, nq), generator=gen).cuda().to(torch.bfloat16)
        phi = (torch.randn((n, ci, nk), generator=gen) + 0.5).cuda().to(torch.bfloat16)
        g = (torch.randn((n, ci, nk), generator=gen) + 0.3).cuda().to(torch.bfloat16)
        y = nonlocal_core(theta, phi, g)
        again = nonlocal_core(theta, phi, g)
        torch.cuda.synchronize()
        ref = nonlocal_core_ref(theta, phi, g)
        scale = float(ref.float().abs().max())
        diff = (y.float() - ref.float()).abs()
        exact = float((y == ref).float().mean())
        same = torch.equal(y, again)

        def cheap():
            return torch.bmm(torch.bmm(g, phi.transpose(1, 2)) / nk, theta)

        def published():
            return torch.bmm(g, (torch.bmm(theta.transpose(1, 2), phi) / nk).transpose(1, 2))

        ms = time_ms(lambda: nonlocal_core(theta, phi, g))
        plain = time_ms(lambda: nonlocal_core_ref(theta, phi, g))
        lib_cheap, lib_pub = time_ms(cheap), time_ms(published)
        flops = 2.0 * n * ci * ci * (nk + nq)
        nbytes = 2.0 * n * ci * (2 * nq + 2 * nk)
        bound_ms, bound_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        log(f"non-local core {label} (N {n}, Ci {ci}, Nq {nq}, Nk {nk}): {ms:.4f} ms, plain "
            f"twin {plain:.4f} ms, two cuBLAS bmm in bf16 {lib_cheap:.4f} ms (the kernel's "
            f"order) and {lib_pub:.4f} ms (the published order), bound {bound_ms:.4f} ms "
            f"({bound_by}; {flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); max err "
            f"{float(diff.max()) / scale:.2e} of max |y| {scale:.3f}, {100 * exact:.2f}% "
            f"bit-equal to the twin; two launches bitwise equal: {same}")
        check(float(diff.max()) <= 2 ** -7 * scale and exact >= 0.95,
              f"non-local core at {label} against its twin")
        check(same, f"non-local core at {label}: two launches bitwise equal")
        result.update({f"{label}_ms": ms, f"{label}_bound_ms": bound_ms,
                       f"{label}_library_ms": lib_cheap})
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound_ms),
                       ("library_ms", lib_cheap)):
            result[key] += blocks * v
        result["max_abs_err"] = max(result["max_abs_err"], float(diff.max()))
    result["bound_by"] = "bytes"
    log(f"non-local cores of a batch of 32 clips (2 at res3, 3 at res4): {result['ms']:.4f} ms, "
        f"bound {result['bound_ms']:.4f} ms, cuBLAS {result['library_ms']:.4f} ms")
    return result


def check_epilogue(gen: torch.Generator) -> dict:
    """The conv epilogue at the main path's shapes: the passes of one
    SLOWFAST_8x8_R50 forward of a batch of 32 clips (32 frames of 256^2),
    their shapes recorded from a forward of one clip, in float32 and bf16;
    each bit-equal to the plain twin on the same inputs, two launches
    bitwise equal; timed (CUDA events, median of 20, in place) beside the
    twin. Its bound is bytes: y (and the residual) read once and y written
    once. Returns the float32 batch's times."""
    from acav100m_torch.models import slowfast as tsf

    calls = {}
    plain = tsf.conv_epilogue

    def record(y, bias, residual=None, relu=True):
        key = (tuple(y.shape[1:]), residual is not None, relu)
        calls[key] = calls.get(key, 0) + 1
        return plain(y, bias, residual, relu)

    tsf.conv_epilogue = record
    try:
        with torch.inference_mode():
            LayerSlowFast().cuda()(torch.zeros((1, 32, 256, 256, 3), dtype=torch.uint8,
                                               device="cuda"))
    finally:
        tsf.conv_epilogue = plain
    check(sum(calls.values()) == 93, f"93 epilogue passes a forward, got {calls}")
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        res = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0.0}
        for (shape, has_res, relu), n in calls.items():
            def cl(scale):
                t = torch.randn((32,) + shape, generator=gen) * scale
                return t.cuda().to(dtype).contiguous(memory_format=torch.channels_last_3d)

            y0, bias = cl(2.0), torch.randn(shape[0], generator=gen).cuda()
            r = cl(1.0) if has_res else None
            y, again = y0.clone(), y0.clone()
            conv_epilogue(y, bias, r, relu)
            conv_epilogue(again, bias, r, relu)
            torch.cuda.synchronize()
            ref = conv_epilogue_ref(y0.clone(), bias, r, relu)
            bits = torch.int32 if dtype == torch.float32 else torch.int16
            check(torch.equal(y.view(bits), ref.view(bits)) and torch.equal(y, again),
                  f"epilogue {dtype} {shape} residual {has_res}: bit-equal to the twin")
            ms = time_ms(lambda: conv_epilogue(y, bias, r, relu))
            plain_ms = time_ms(lambda: conv_epilogue_ref(y, bias, r, relu))
            nbytes = y.numel() * y.element_size() * (3 if has_res else 2)
            for key, v in (("ms", ms), ("plain_ms", plain_ms), ("bytes", nbytes),
                           ("bound_ms", bound(nbytes, 0.0, 1.0)[0])):
                res[key] += n * v
            del y0, y, again, ref, r
        res["bound_by"] = "bytes"
        log(f"conv epilogue, the 93 passes of a batch of 32 clips in {dtype}: {res['ms']:.4f} ms, "
            f"plain twin {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms (bytes, "
            f"{res['bytes'] / 1e9:.2f} GB; {100 * res['bound_ms'] / res['ms']:.1f}% of it); "
            f"bit-equal to the twin, two launches bitwise equal")
        results[dtype] = res
    return results[torch.float32]


# select.fp32.batch_mi's shapes: a pool of 32000 clips, 10 clusterings at K=32
# (45 pairs), batches of 20 of which 4 win, a subset of 6400
SELECT_V, SELECT_D, SELECT_C, SELECT_B, SELECT_K, SELECT_SUBSET = 32000, 10, 32, 20, 4, 6400


def cell_assignments(seed: int) -> np.ndarray:
    """(V, 10) cluster ids as the cell's traffic draws them: 32 latent
    classes through a fixed random map a clustering, half the clips with
    another class for the video clusterings, each id redrawn with
    probability 0.25."""
    rng = np.random.RandomState(seed)
    v, d, c = SELECT_V, SELECT_D, SELECT_C
    maps = np.stack([rng.permutation(c) for _ in range(d)])
    cls_a = rng.randint(0, c, v)
    cls_v = np.where(rng.rand(v) < 0.5, cls_a, rng.randint(0, c, v))
    cls = np.where(np.arange(d)[None, :] < 5, cls_a[:, None], cls_v[:, None])
    return np.where(rng.rand(v, d) < 0.25, rng.randint(0, c, (v, d)),
                    maps[np.arange(d)[None, :], cls])


def check_batch_mi() -> dict:
    """Stage 6's fused greedy step (``mi.batch_mi_step``) at the cell's
    shapes, on a cache that holds 2000 clips, against its plain twin: the
    picks' scores within 1e-6 of the largest, the same picks, the folded
    cache bit-equal, the statistics within 1e-6; two launches the same
    bytes. Timed (CUDA events, median of 20): the kernel as graph replays
    (its device time) and as the selector launches it, the twin's chain as
    the selector's eager path runs it, and the twin's kernels' device time
    (``torch.profiler``)."""
    from itertools import combinations

    a = cell_assignments(0)
    combos = list(combinations(range(SELECT_D), 2))
    pairs_all = torch.as_tensor(mi.pair_assignments(a, combos), device="cuda")
    rng = np.random.RandomState(1)
    cache = mi.init_cache(len(combos), SELECT_C, torch.float32, "cuda")
    folded = torch.as_tensor(rng.choice(SELECT_V, 2000, replace=False), device="cuda")
    cache = mi.add_candidates_to_cache(cache, pairs_all[folded], SELECT_C)
    stats = mi.mem_stats(cache)
    ids = rng.choice(SELECT_V, SELECT_B, replace=False).astype(np.int64)
    ids_t = torch.as_tensor(ids, device="cuda")
    k = SELECT_K

    def twin():
        return mi.batch_mi_step_ref(cache, stats, pairs_all, ids_t, SELECT_B, k, SELECT_C)

    runs = []
    for _ in range(2):
        c2 = {key: t.clone() for key, t in cache.items()}
        s2 = {key: t.clone() for key, t in stats.items()}
        host = torch.empty(2 * k, dtype=torch.int32, pin_memory=True)
        mi.batch_mi_step(c2, s2, pairs_all, ids, SELECT_B, k, out_host=host)
        torch.cuda.synchronize()
        runs.append((host.numpy().copy(), c2, s2))
    want_idx, _, want_cache, want_stats = twin()
    scores = mi.score_candidates_mem(cache, stats, pairs_all[ids_t], SELECT_C).cpu().numpy()
    out, got_cache, got_stats = runs[0]
    idx, got_scores = out[:k], out[k:].view(np.float32)
    err = float(np.abs(got_scores - scores[idx]).max()) / float(np.abs(scores).max())
    same_bytes = (np.array_equal(runs[0][0], runs[1][0])
                  and all(torch.equal(runs[0][i][key], runs[1][i][key])
                          for i in (1, 2) for key in runs[0][i]))
    stats_err = max(float(((got_stats[key] - want_stats[key]).abs()
                           / want_stats[key].abs()).max()) for key in want_stats)
    check(err <= 1e-6, f"batch_mi_step scores against the twin's ({err:.2e})")
    check(idx.tolist() == want_idx.tolist(), "batch_mi_step picks the twin's")
    check(all(torch.equal(got_cache[key], want_cache[key]) for key in want_cache),
          "batch_mi_step folds the twin's cache bit for bit")
    check(stats_err <= 1e-6, f"batch_mi_step statistics ({stats_err:.2e})")
    check(same_bytes, "batch_mi_step: two launches give the same bytes")

    # the selector's launch: the tensors checked and the kernel launched a step
    c2 = {key: t.clone() for key, t in cache.items()}
    s2 = {key: t.clone() for key, t in stats.items()}
    out_dev = torch.empty(2 * k, dtype=torch.int32, device="cuda")
    host = torch.empty(2 * k, dtype=torch.int32, pin_memory=True)

    def step():
        return mi.batch_mi_step(c2, s2, pairs_all, ids, SELECT_B, k, out=out_dev, out_host=host)

    graph_ms = time_ms(graphed(step))
    launched_ms = time_ms(step)
    _, _, rows = profile_calls(step, iters=20)
    kernel_us = sum(us for us, _, name in rows if "batch_mi_step" in name)
    eager_ms = time_ms(twin)
    _, _, rows = profile_calls(twin, iters=20)
    twin_kernels = [(us, n) for us, n, name in rows if not name.startswith("Memcpy")]
    twin_us = sum(us for us, _ in twin_kernels)
    p, cc = len(combos), SELECT_C
    # N, a and b read once and the winners' k*P cells of each written; n and
    # the statistics read and written; the batch's pairs; the output
    nbytes = 4 * (p * cc * cc + 2 * p * cc + 3 * k * p + 2 * 4 * p + SELECT_B * p * 2 + 2 * k)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"batch_mi_step at V={SELECT_V} P={p} C={cc} B={SELECT_B} k={k} (cache of 2000 clips): "
        f"{graph_ms:.4f} ms a step as graph replays, {kernel_us / 1e3:.4f} ms of kernel "
        f"(torch.profiler), {launched_ms:.4f} ms a step as the selector launches it; the "
        f"eager chain (the twin) {eager_ms:.4f} ms a step, its {sum(n for _, n in twin_kernels)} "
        f"kernels {twin_us / 1e3:.4f} ms of device time; bound {bound_ms:.5f} ms "
        f"(bytes, {nbytes / 1e6:.3f} MB; latency bounds it); scores within {err:.1e} "
        f"of the largest, statistics within {stats_err:.1e}, picks {idx.tolist()}, cache "
        f"bit-equal, two launches the same bytes")
    return {"ms": graph_ms, "plain_ms": twin_us / 1e3, "eager_ms": eager_ms,
            "launched_ms": launched_ms, "bound_ms": bound_ms, "bound_by": "latency",
            "library_ms": None, "max_abs_err": err}


def main_path_a_nln() -> dict:
    """Path A-nln: path A's clips through extract with SLOWFAST_NLN_8x8_R50
    (``layer_slowfast_nln``) in bf16, seeded weights: the non-local kernel
    launched once a block, five a batch, beside K2-bf16; the rows' taps
    finite."""
    clips, feats = WORK / "a" / "clips", WORK / "a_nln" / "features"
    n_clips = 16
    spec = "shard-{000000..000001}"
    reset_counts()
    t_ext = run_stage("extract", f"data.media.path={clips}/{spec}.tar",
                      f"data.output.path={feats}", "data.batch_size=4",
                      "computation.dtype=bfloat16",
                      'models=["layer_vggish", "layer_slowfast_nln"]')
    launches = counts()
    c = tracing.counters()
    rows = [r for p in sorted(feats.glob("shard-*.pkl")) for r in load_pickle(p)]
    check(len(rows) == n_clips, f"path A-nln: {n_clips} rows, got {len(rows)}")
    for row in rows:
        (feat,) = row["video_features"]
        check(feat["model_key"] == "layer_slowfast_nln", "path A-nln model key")
        check(all(np.isfinite(a).all() for a in feat["array"].values()), "path A-nln finite")
    log(f"path A-nln (bf16): extract {t_ext:.2f} s ({n_clips / t_ext:.2f} clips/s); "
        f"{c.get('extract.batches', 0)} batches, {c.get('nonlocal.blocks', 0)} non-local "
        f"blocks; launches {launches}")
    check(launches["nonlocal_core_bf16"] == 5 * c.get("extract.batches", 0)
          == c.get("nonlocal.blocks", 0) > 0, "path A-nln: five kernel launches a batch")
    check(launches["bottleneck_stage_bf16"] > 0, "path A-nln: K2-bf16 still runs s2")
    return launches


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
    t_serial, busy, kernels, copies = device_busy(lambda: cli.main(
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
        f"{kernels:.3f} s, copies {copies:.3f} s: the card busy {100 * busy / t_serial:.1f}% "
        f"of its {t_serial:.2f} s wall, {100 * busy / t_pool:.1f}% of the 2-worker run's "
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
    t0 = time.time()
    with tracing.enabled():
        _, count = ss.run_chunks(cfg)
    t_all = time.time() - t0
    caches = sorted((root / "chunks" / "caches").glob("cache_*"))
    reduced = root / "chunks" / "reduced.csv"
    run_stage("reduce", str(reduced), *map(str, caches))
    chunk = {s.unit: s for s in tracing.spans() if s.name == "span.select.chunk"}
    per_chunk = [(chunk[i].end_ns - chunk[i].start_ns) / 1e9 for i in range(2)]
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
                wall, busy, _, _ = device_busy(lambda: sel.run_greedy(102, [start],
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
    _, busy, _, _ = device_busy(lambda: cs.train_probe(video, audio, device="cuda"))
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


def path_d6_greedy() -> None:
    """A whole ``run_greedy`` at ``select.fp32.batch_mi``'s shapes through the
    fused step, then through the eager chain (a selector whose
    ``takes_kernel`` refuses every case) on the same seed: wall time,
    launches and host reads, and each replayed in float64 along its own
    picks."""
    from itertools import combinations

    from benchmark.reference import batch_mi

    seed = 7
    a = cell_assignments(seed)
    combos = list(combinations(range(SELECT_D), 2))

    class EagerSelector(mi.BatchGreedySelector):
        takes_kernel = staticmethod(lambda *_: False)

    lines, picks = [], {}
    for fused, selector in ((True, mi.BatchGreedySelector), (False, EagerSelector)):
        rng = np.random.RandomState(seed)
        order = np.arange(SELECT_V)
        rng.shuffle(order)
        sel = selector(a, combos, SELECT_C, batch_size=SELECT_B, selection_size=SELECT_K,
                       rng=rng, device="cuda")
        check(sel.fused is fused, f"D6: the {selector.__name__} takes the fused step: {fused}")
        with tracing.enabled():  # counts from before, where tracing was already on
            before = tracing.counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, gains, lapse, _ = sel.run_greedy(SELECT_SUBSET, [int(order[0])])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c = {key: n - before.get(key, 0) for key, n in tracing.counters().items()}
        res = batch_mi.replay(a, combos, SELECT_C, SELECT_SUBSET, SELECT_B, SELECT_K, seed,
                              got, gains)
        name = "fused step" if fused else "eager chain"
        picks[name] = got
        iters = c["select.iterations"]
        lines.append(f"{name} {wall:.3f} s ({1e3 * np.median(lapse):.4f} ms an iteration, "
                     f"median), {iters} iterations, batch_mi.launches "
                     f"{c.get('batch_mi.launches', 0)}, host reads {c['select.host_reads']}, "
                     f"pick_gap {res['pick_gap']:.2e}, gain_err {res['gain_err']:.2e}")
        check(res["foreign"] == 0 and res["pick_gap"] <= 1e-4 and res["gain_err"] <= 1e-2,
              f"D6 {name}: replayed in float64")
        check(c.get("batch_mi.launches", 0) == (iters if fused else 0),
              f"D6 {name}: one launch an iteration on the fused step, none on the chain")
    same = next((i for i, (u, v) in enumerate(zip(*picks.values())) if u != v),
                SELECT_SUBSET)
    log(f"path D6, run_greedy at V={SELECT_V} P={len(combos)} C={SELECT_C} B={SELECT_B} "
        f"k={SELECT_K}, subset {SELECT_SUBSET}: " + "; ".join(lines)
        + f"; the first {same} picks equal")


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
    path_d6_greedy()
    log(f"path D launches {counts()} (stage 6's float32 batch_mi is the fused step); {card()}")


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
    """One rank of path E or H4 (a spawned process): joins the group, runs
    the scenarios, writes its results."""
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
        if "h4" in scenarios:
            out["h4"] = h4_rank(group, root)
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


# -- phase 8: path F, int8 extraction and stages 2-3 -------------------------------

INT8 = ["computation.quant=int8"]
# path F1's extractions of path A's clips on path C's checkpoints: the fp
# reference (float32, K2 route) and the JAX package's two int8 legs
F_LEGS = {"fp": [], "int8": INT8, "int8_bf16": INT8 + HEADLINE}
COSINE_MIN, AGREEMENT_MIN, OVERLAP_MIN = 0.99, 0.75, 0.6  # tests/test_quant.py's gates
# a block on the card against the CPU, same input and scales: BN rounds
# otherwise on the card, so an activation within rounding of a half step
# moves one step (tests/test_torch_quant.py), and a move at q_a moves some
# of q_b's; at most 1e-3 of a site's activations may move, each by one
# step, and the block's output is held to 1e-3 relative L2 (measured on an
# H100: at most 36 of 1048576 moved, 1.10e-4 relative L2)
STAGE_MOVED, STAGE_REL_L2 = 1e-3, 1e-3


def checkpoint_args() -> list:
    root = WORK / "c" / "weights"
    return [f"weights.slowfast_file={root / 'SLOWFAST_8x8_R50.pkl'}",
            f"weights.vggish_file={root / 'vggish.pth'}"]


def assignments(clusters: Path) -> dict:
    """{(filename, model, layer): cluster} of the video assignments."""
    out = {}
    for path in sorted(clusters.glob("shard-*.pkl")):
        for row in load_pickle(path):
            for f in row["video_assignments"]:
                for layer, v in f["array"].items():
                    out[row["filename"], f["model_key"], layer] = int(v)
    return out


def selected(csv: Path) -> set:
    return {line.split(",")[1] for line in csv.read_text().splitlines()}


def path_f1_legs() -> dict:
    """Each leg through extract -> cluster -> select on path A's clips and
    path C's checkpoints; the int8 legs' video taps, assignments and picks
    held against the fp leg's. Returns the int8 legs' launches (the fp leg
    is the comparison)."""
    clips = WORK / "a" / "clips"
    n_clips = 16
    legs, launches = {}, dict.fromkeys(counts(), 0)
    for leg, args in F_LEGS.items():
        root = WORK / "f" / leg
        reset_counts()
        t_ext = run_stage("extract", f"data.media.path={clips}/{SPEC}.tar",
                          f"data.output.path={root}/features", "data.batch_size=4",
                          *checkpoint_args(), *args)
        after_extract = counts()
        taps = check_features(root / "features", n_clips)
        t_clu = run_stage("cluster", f"data.path={root}/features/{SPEC}.pkl",
                          f"data.output.path={root}/clusters", "data.batch_size=4",
                          "clustering.ncentroids=4", "clustering.epochs=4")
        t_sel = run_stage("select", f"data.path={root}/clusters/{SPEC}.pkl",
                          f"data.output.path={root}/output.csv", f"data.meta.path={clips}")
        run = counts()
        rows, want = csv_rows(root / "output.csv"), round(0.2 * n_clips)
        check(rows == want, f"path F1 {leg}: output.csv rows {rows} != {want}")
        check(run["kmeans_assign_update"] > after_extract["kmeans_assign_update"],
              f"path F1 {leg}: K1 launched by cluster")
        if leg == "fp":
            check(after_extract["bottleneck_stage"] > 0, "path F1 fp: K2 launched")
        else:
            check(after_extract["bottleneck_stage"] == after_extract["bottleneck_stage_bf16"] == 0,
                  f"path F1 {leg}: K2 and K2-bf16 never launched in int8 ({after_extract})")
            for name, n in run.items():
                launches[name] += n
        legs[leg] = {"taps": taps, "assign": assignments(root / "clusters"),
                     "selected": selected(root / "output.csv"),
                     "seconds": (t_ext, t_clu, t_sel), "launches": run}
    fp = legs["fp"]
    for leg in ("int8", "int8_bf16"):
        got = legs[leg]
        cos = {}
        for key, want in fp["taps"].items():
            if key[1] != "video_features":
                continue
            a, b = got["taps"][key].astype(np.float64), want.astype(np.float64)
            cos[key] = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
        worst = min(cos, key=cos.get)
        same = [got["assign"][k] == v for k, v in fp["assign"].items()]
        agreement = sum(same) / len(same)
        overlap = len(got["selected"] & fp["selected"]) / len(fp["selected"])
        t_ext, t_clu, t_sel = got["seconds"]
        log(f"path F1 {leg} ({' '.join(F_LEGS[leg])}): extract {t_ext:.2f} s "
            f"({n_clips / t_ext:.2f} clips/s); cluster {t_clu:.2f} s; select {t_sel:.2f} s; "
            f"video taps' cosine to the fp leg's, per clip and layer, at least {cos[worst]:.6f} "
            f"({worst[0]} {worst[2]}); video assignment agreement {agreement:.3f} over "
            f"{len(same)}; subset overlap {overlap:.3f} of {len(fp['selected'])}; launches "
            f"{got['launches']}")
        check(cos[worst] > COSINE_MIN, f"path F1 {leg}: cosine {cos[worst]} > {COSINE_MIN}")
        check(agreement >= AGREEMENT_MIN, f"path F1 {leg}: agreement {agreement}")
        check(overlap >= OVERLAP_MIN, f"path F1 {leg}: overlap {overlap}")
    t_ext, t_clu, t_sel = fp["seconds"]
    log(f"path F1 fp reference (float32, K2 route): extract {t_ext:.2f} s; cluster "
        f"{t_clu:.2f} s; select {t_sel:.2f} s; launches {fp['launches']} (not counted)")
    return launches


def path_a_batch(n: int) -> dict:
    """The first ``n`` of path A's clips as a staged batch on the card."""
    from acav100m_torch.data.meta import load_metadata
    from acav100m_torch.data.tar_dataset import TarShardDataset, collate

    shard = str(WORK / "a" / "clips" / "shard-000000.tar")
    metas, _ = load_metadata([shard])
    samples = []
    for sample in TarShardDataset([shard], metas):
        samples.append(sample)
        if len(samples) == n:
            break
    batch = collate(samples, n)
    return {k: torch.from_numpy(batch[k]).cuda() for k in ("frames", "audio", "valid_samples")}


def int8_models(*extra) -> dict:
    return fe.build_models(fe.get_config({"data.media.path": "-", **dict(
        a.split("=", 1) for a in (*checkpoint_args(), *extra))}))


def int8_sites(blk, x: torch.Tensor):
    """``blk(x, "int8")`` -> (its output, the int8 activations it quantized:
    q_in, q_a, q_b)."""
    import acav100m_torch.models.quant as qmod

    sites, quantize = [], qmod.quantize_act

    def record(v, scale):
        sites.append(quantize(v, scale))
        return sites[-1]

    qmod.quantize_act = record
    try:
        with torch.inference_mode():
            return blk(x, "int8"), sites
    finally:
        qmod.quantize_act = quantize


def path_f1_card_checks() -> None:
    """On one clip of path A through the int8 model at full width (path C's
    checkpoint, calibrated on it): every int8 conv geometry's int32 sums on
    the card against the CPU's, bit for bit, and the slow ``s3`` stage on
    the card against the CPU with the same scales."""
    import acav100m_torch.models.quant as qmod

    model = int8_models(*INT8)["layer_slowfast"]
    frames = path_a_batch(2)["frames"][:1]
    seen, stage_in = {}, []
    conv = qmod.conv3d_int8

    def record(xq, wmat, ksize, stride, padding):
        y, shape = conv(xq, wmat, ksize, stride, padding)
        key = (tuple(xq.shape[1:]), tuple(wmat.shape), tuple(ksize), tuple(stride))
        if key not in seen:
            seen[key] = (xq.cpu(), wmat.cpu(), tuple(padding), y.cpu())
        return y, shape

    # s2_fuse returns (slow, fast): the slow tensor is s3's slow input
    hook = model.s2_fuse.register_forward_hook(lambda m, i, out: stage_in.append(out[0]))
    qmod.conv3d_int8 = record
    try:
        with torch.inference_mode():
            model.calibrate(frames)
            model(frames)
    finally:
        qmod.conv3d_int8 = conv
        hook.remove()
    t0 = time.time()
    differ = [key for key, (xq, wmat, padding, y) in seen.items()
              if not torch.equal(conv(xq, wmat, key[2], key[3], padding)[0], y)]
    kinds = sorted({(k[2], k[3][1]) for k in seen})
    log(f"path F1, int8 conv at full width (one clip, 32 frames of 256x256): {len(seen)} "
        f"geometries (kernel, spatial stride: {kinds}; Cin {sorted({k[0][0] for k in seen})}), "
        f"the card's int32 sums equal to the CPU's on {len(seen) - len(differ)} "
        f"({time.time() - t0:.1f} s on the CPU)")
    check(not differ and len(seen) >= 20, f"int8 conv card vs CPU bit for bit: {differ}")
    # the slow s3 stage (4 int8 blocks, same scales) from s2_fuse's output:
    # each block on the card and on the CPU from the CPU chain's input
    blocks = model.s3._blocks(0)
    cpu_blocks = [copy.deepcopy(b).cpu() for b in blocks]
    x = stage_in[-1].cpu()
    lines, chain = [], x.cuda()
    for i, (blk, blk_cpu) in enumerate(zip(blocks, cpu_blocks)):
        y, sites = int8_sites(blk, x.cuda())
        y_cpu, sites_cpu = int8_sites(blk_cpu, x)
        with torch.inference_mode():
            chain = blk(chain, "int8")
        steps = [(a.cpu().int() - b.int()).abs() for a, b in zip(sites, sites_cpu)]
        moved = [int((d > 0).sum()) for d in steps]
        rel = float((y.cpu() - y_cpu).double().norm() / y_cpu.double().norm())
        lines.append(f"block {i}: q_in/q_a/q_b moved {moved} of {[d.numel() for d in steps]}, "
                     f"output relative L2 {rel:.2e}")
        check(moved[0] == 0, f"s3 block {i}: the same input quantizes the same")
        check(max(int(d.max()) for d in steps) <= 1
              and all(m <= STAGE_MOVED * d.numel() for m, d in zip(moved, steps)),
              f"s3 block {i}: int8 activations within one step: {lines[-1]}")
        check(rel <= STAGE_REL_L2, f"s3 block {i}: {lines[-1]}")
        x = y_cpu
    chained = float((chain.cpu() - x).double().norm() / x.double().norm())
    log(f"path F1, the slow s3 int8 stage at full width ({tuple(stage_in[-1].shape)} in, "
        f"{tuple(x.shape)} out), card against CPU with the same scales, each block from the "
        f"same input: " + "; ".join(lines) + f"; the 4 blocks chained on each device: relative "
        f"L2 {chained:.2e} (one-step moves cascade through 12 quantizes)")


def path_f1_times() -> None:
    """Device time of one warm extract batch of 4 of path A's clips on path
    C's checkpoints (SlowFast + VGGish) in float32, bf16 and both int8 legs,
    the int8 GEMM's share of it, and the calibration pass."""
    from acav100m_torch.profiling import op_device_us, profile_calls

    batch = path_a_batch(4)
    args = (batch["frames"], batch["audio"], batch["valid_samples"])
    lines = []
    for label, extra in (("float32", []), ("bf16", HEADLINE), ("int8", INT8),
                         ("int8 bf16", INT8 + HEADLINE)):
        models = int8_models(*extra)
        sf = models["layer_slowfast"]
        calib = ""
        if sf.quant == "int8":
            with torch.inference_mode():
                sf.calibrate(batch["frames"])
                ms = time_ms(lambda: sf.calibrate(batch["frames"]), iters=5, warmup=1)
            calib = f", the calibration pass {ms:.3f} ms (SlowFast alone, fp graph)"
        extract = fe.make_extract_fn(models)
        prof, _, rows = profile_calls(lambda: extract(*args))
        busy = sum(us for us, _, _ in rows) / 1e3
        gemm = op_device_us(prof, "aten::_int_mm") / 1e3
        lines.append(f"{label}: {busy:.3f} ms of device time, the int8 GEMM {gemm:.3f} "
                     f"ms ({100 * gemm / busy:.1f}%){calib}; top kernels "
                     + "; ".join(f"{us / 1e3:.3f} ms {name[:60]}" for us, _, name in rows[:4]))
        del models, sf, extract
    log("path F1 times, one warm extract batch of 4 clips (32 frames of 256x256, SlowFast + "
        f"VGGish, path C's checkpoints; torch.profiler, mean of 3; {card()}): "
        + " | ".join(lines))


def write_scene_video(path: Path, seed: int, seconds=(12, 12, 12), fps: float = 10.0,
                      size: int = 256) -> None:
    """Three constant-colour scenes with hard cuts (the colours a third of the
    range apart, so each cut scores above ``segment``'s threshold of 10),
    written by OpenCV (mp4v)."""
    import cv2

    rng = np.random.RandomState(seed)
    colours = np.roll(np.array([[40, 40, 40], [200, 60, 60], [60, 200, 200]], np.uint8),
                      seed, axis=0)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (size, size))
    check(writer.isOpened(), "cv2.VideoWriter opens an mp4")
    for colour, s in zip(colours, seconds):
        for _ in range(int(fps * s)):
            frame = np.broadcast_to(colour, (size, size, 3)).copy()
            frame += rng.randint(0, 3, frame.shape).astype(np.uint8)
            writer.write(frame)
    writer.release()


def path_f2_stages() -> dict:
    """Stages 2-3 on this machine's OpenCV (no FFmpeg here), then stage 4 in
    int8 on the bundled clips and stages 5-6: ``download --source_dir``,
    ``segment --backend opencv``, ``bundle_shards``, ``extract
    data.decoder=opencv computation.quant=int8``, ``cluster``, ``select``,
    with the row counts checked at each stage. Returns its launches."""
    from acav100m_torch.pipeline.bundling import bundle_shards

    root = WORK / "f2"
    src = root / "src"
    src.mkdir(parents=True)
    vids = ["vidA0000001", "vidB0000002"]
    t0 = time.time()
    for i, vid in enumerate(vids):
        write_scene_video(src / f"{vid}.mp4", seed=i)
    (root / "filtered.tsv").write_text(
        "".join(f"https://www.youtube.com/watch?v={v}\t{{}}\n" for v in vids))
    t_write = time.time() - t0
    t_dl = run_stage("download", str(root / "filtered.tsv"), str(root / "raw"),
                     f"--source_dir={src}")
    check(sorted(p.name for p in (root / "raw").iterdir()) == [f"{v}.mp4" for v in vids],
          "download copied both videos")
    # each 36 s video: cuts at 12 and 24 s, so two shots of 10 s or more
    # before the last cut (the reference's rule), each cut to 10 s; with
    # num_clips 2 no threshold annealing drops a cut
    t_seg = run_stage("segment", str(root / "raw"), str(root / "clips"), "--backend=opencv",
                      "--num_clips=2")
    clips = sorted((root / "clips").glob("*.mp4"))
    check(len(clips) == 4, f"segment wrote 4 clips, got {[c.name for c in clips]}")
    shards = bundle_shards(clips, root / "shards", shard_size=2)
    metas = [json.loads(s.with_suffix(".json").read_text()) for s in shards]
    check(len(shards) == 2 and [len(m) for m in metas] == [2, 2], "2 shards of 2 clips")
    spec = f"{root}/shards/shard-{{000000..000001}}"
    reset_counts()
    t_ext = run_stage("extract", f"data.media.path={spec}.tar",
                      f"data.output.path={root}/features", "data.batch_size=2",
                      "data.decoder=opencv", *checkpoint_args(), *INT8)
    after_extract = counts()
    check_features(root / "features", 4)
    t_clu = run_stage("cluster", f"data.path={root}/features/shard-{{000000..000001}}.pkl",
                      f"data.output.path={root}/clusters", "data.batch_size=2",
                      "clustering.ncentroids=2", "clustering.epochs=8")
    n_assign = sum(len(load_pickle(p)) for p in (root / "clusters").glob("shard-*.pkl"))
    t_sel = run_stage("select", f"data.path={root}/clusters/shard-{{000000..000001}}.pkl",
                      f"data.output.path={root}/output.csv", f"data.meta.path={root}/shards")
    launches = counts()
    rows = csv_rows(root / "output.csv")
    log(f"path F2, stages 2-6 on 2 OpenCV-written videos (3 scenes of 12 s, 256x256, 10 fps): "
        f"writing {t_write:.2f} s, download {t_dl:.2f} s, segment (opencv) {t_seg:.2f} s -> "
        f"{len(clips)} clips {[c.name for c in clips]}, 2 shards; extract (opencv decoder, "
        f"int8) {t_ext:.2f} s -> 4 rows; cluster {t_clu:.2f} s -> {n_assign} rows; select "
        f"{t_sel:.2f} s -> {rows} csv rows; launches {launches}")
    check(after_extract["bottleneck_stage"] == after_extract["bottleneck_stage_bf16"] == 0,
          "path F2: no K2 in int8")
    check(n_assign == 4 and rows == round(0.2 * 4), f"path F2 rows: {n_assign}, {rows}")
    return launches


def main_path_f() -> dict:
    """Path F; returns its launches (the int8 legs' and F2's)."""
    launches = path_f1_legs()
    path_f1_card_checks()
    path_f1_times()
    for name, n in path_f2_stages().items():
        launches[name] += n
    return launches


# -- phase 9: path G, correspondence retrieval --------------------------------------

# K1 at the retrieval shapes: sgd_kmeans runs one clustering (M=1) of K=10
# centers in batches of 64 rows and a tail, at a view's width: 16 (gaussian,
# 300 rows: a tail of 44), 256, 512, 1024 and 2048 (the ResNet-50 taps) and
# 32 (log-mel), 500 rows of the digits (a tail of 52); and 8 with a real width
# of 6 (a width that takes the padded route). Every (rows, width, real width)
# that path G hands K1 on the card must be among these
G_K = 10
G_SHAPES = sorted({(b, d, d) for d, tail in ((16, 44), (32, 52), (256, 52), (512, 52),
                                             (1024, 52), (2048, 52)) for b in (64, tail)}
                  | {(b, 8, 6) for b in (64, 52)})
# the digits stand-in at views_for_data_name's scale
G_DIGITS = ["nclasses=10", "per_class=50"]


def path_g0_k1(gen: torch.Generator) -> None:
    """G0: K1 at the retrieval shapes against its plain version (phase 2's
    checks and tolerances), each shape timed as CUDA graph replays over
    ``COLD_SETS`` input sets beside its plain version and its bytes bound."""
    for b, d, real in G_SHAPES:
        sets = []
        for _ in range(COLD_SETS):
            # seen 3000: mid-run of 20 epochs over 300 gaussian rows
            centers, cnt, batch, threshold = k1_inputs(gen, G_K, b, (real,), seen=3000)
            pad = (0, d - real)
            sets.append((torch.nn.functional.pad(centers, pad).contiguous(), cnt,
                         torch.nn.functional.pad(batch, pad).contiguous(), threshold))
        label = f"M=1 K={G_K} B={b} D={d} (real {real})"
        abs_d = k1_compare(sets[0], (real,), label)
        cold = time_cold_ms(fused_assign_update, [a + ((real,),) for a in sets], graph=True)
        plain = time_ms(lambda: fused_assign_update_ref(*sets[0]))
        # rows and centers over the real columns, deltas, counts in and out,
        # best, the mean; 3xTF32 issues three TF32 products for each fp32 one
        nbytes = 4 * (b * real + G_K * real + G_K * d + 2 * G_K + b + 1)
        bound_ms, bound_by = bound(nbytes, 3 * 2 * b * G_K * real, TF32_TENSOR_FLOPS)
        log(f"G0 K1 at {label}: {cold:.4f} ms cold as graph replays, plain {plain:.4f} ms, "
            f"bound {bound_ms:.6f} ms ({bound_by}, {nbytes} bytes), deltas max abs err "
            f"{abs_d:.2e}")


@contextlib.contextmanager
def k1_shapes():
    """Records (rows, width, real width) of each batch that ``train_step``
    hands K1 on the card in this process; the wrapper's own launch count is
    untouched."""
    from acav100m_torch.ops import kmeans as km

    shapes = []
    real = km.fused_assign_update

    def spy(centers, counts, batch, threshold, dims=None):
        if centers.is_cuda:
            d = int(centers.shape[-1])
            shapes.append((int(batch.shape[1]), d, int(dims[0]) if dims else d))
        return real(centers, counts, batch, threshold, dims=dims)

    km.fused_assign_update = spy
    try:
        yield shapes
    finally:
        km.fused_assign_update = real


@contextlib.contextmanager
def no_tf32():
    """Full float32 convolutions and products, for a card-against-CPU
    comparison."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def run_retrieval(out: Path, *args) -> tuple:
    """``retrieval`` through the port's CLI, its results written under
    ``out``; returns (printed lines, wall seconds, K1 launches in the run,
    the shapes K1 met in this process)."""
    buf = io.StringIO()
    reset_counts()
    t0 = time.time()
    with k1_shapes() as shapes, contextlib.redirect_stdout(buf):
        cli.main(["retrieval", *args, "--out_path", str(out)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  {line}")
    return lines, wall, counts()["kmeans_assign_update"], shapes


def retrieval(name: str, *args) -> tuple:
    """One experiment through the CLI; returns (result dict, wall seconds,
    K1 launches, K1's shapes)."""
    out = WORK / "g" / f"{name}.pkl"
    _, wall, launches, shapes = run_retrieval(out, *args)
    return load_pickle(out), wall, launches, shapes


def card_against_cpu(tag: str, name: str, *args) -> tuple:
    """One sgd experiment through the CLI on the card with TF32 off, and the
    same on the CPU: the card's picks must be the CPU's. Returns the card's
    (result, wall seconds, K1 launches, K1's shapes)."""
    with no_tf32():
        card_res, wall, launches, shapes = retrieval(name, *args, "clustering_method=sgd")
    cpu_res, cpu_wall, _, _ = retrieval(f"{name}_cpu", *args, "clustering_method=sgd",
                                        "device=cpu")
    log(f"{tag} sgd on the card: {wall:.2f} s wall, K1 {launches} launches at (rows, "
        f"width, real) {sorted(set(shapes))}; on the CPU {cpu_wall:.2f} s; f1 "
        f"{card_res['f1']:.4f} (CPU {cpu_res['f1']:.4f}); {len(card_res['selection'])} picks")
    check(launches > 0, f"{tag}: K1 launched")
    check(card_res["selection"] == cpu_res["selection"],
          f"{tag}: the card's sgd picks are the CPU's")
    return card_res, wall, launches, shapes


def path_g1_gaussian() -> tuple:
    """G1: gaussian views through the CLI on the card (sgd, efficient_greedy,
    mi), against the same run on the CPU. One cluster pair (``layer_0``) at
    seed 3: every greedy step's maximum is shared only by candidates with
    the same cells' counts, which any device scores to the same bits, and
    stands above the rest by 2.7e-4 in float64, so the picks are not
    rounding's (``tests/test_torch_retrieval.py``); the sgd clusterings of
    all four views run K1. Returns (K1 launches, K1's shapes)."""
    _, _, launches, shapes = card_against_cpu(
        "G1 gaussian", "g1", "seed=3", "pairing=layer_0", "optimizer=efficient_greedy",
        "measure=mi")
    return launches, shapes


def path_g2_resnet() -> tuple:
    """G2: ResNet-50 at full width on the card. Its four taps on the digits
    stand-in (10 classes x 50, 32x32) card against CPU with TF32 off; the
    ``resnet_pairs`` CLI (taps layer3 and layer4) on sgd, card against CPU
    (K1 at D 1024 and 2048), and on scipy against the constant measure's F1
    on the same views. sgd's mini-batch k-means leaves these uncentered,
    whitened taps in one cluster, in the JAX package too
    (``tests/test_torch_retrieval.py``), so its F1 is not gated."""
    from acav100m_torch.retrieval import features as rf

    images, _ = rf.synthetic_digits(10, 50)
    with no_tf32():
        t0 = time.time()
        on_card = rf.ImageFeatureExtractor(device="cuda").extract(images)
        torch.cuda.synchronize()
        t_card = time.time() - t0
    on_cpu = rf.ImageFeatureExtractor(device="cpu").extract(images)
    errs = [float(np.abs(on_card[k] - on_cpu[k]).max() / np.abs(on_cpu[k]).max())
            for k in sorted(on_cpu)]
    log(f"G2 ResNet-50 taps of 500 images, card (TF32 off, {t_card:.2f} s with its "
        f"first call) against CPU, rel err " + ", ".join(f"{e:.2e}" for e in errs))
    check(max(errs) <= 1e-4, "G2: the ResNet-50 taps on the card within 1e-4 of the CPU's")
    base = ["--dataset", "resnet_pairs", *G_DIGITS]
    _, _, launches, shapes = card_against_cpu("G2 resnet_pairs", "g2_sgd", *base)
    mi_res, wall_scipy, _, _ = retrieval("g2_scipy", *base, "clustering_method=scipy")
    const, _, _, _ = retrieval("g2_scipy_constant", *base, "clustering_method=scipy",
                               "measure=constant")
    log(f"G2 resnet_pairs scipy: {wall_scipy:.2f} s, f1 {mi_res['f1']:.4f} against the "
        f"constant measure's {const['f1']:.4f}")
    check({1024, 2048} <= {d for _, d, _ in shapes}, "G2: K1 launched at D=1024 and 2048")
    check(mi_res["f1"] > const["f1"], "G2: F1 above the constant measure's")
    return launches, shapes


def path_g3_mnist_sound() -> tuple:
    """G3: the digits' four ResNet taps against spoken-digit log-mels
    computed on the card, bipartite pairing; sgd (K1) card against CPU, and
    scipy's F1 against the constant measure's (gated on scipy, as in G2)."""
    base = ["--dataset", "mnist_sound", *G_DIGITS]
    _, _, launches, shapes = card_against_cpu("G3 mnist_sound", "g3_sgd", *base)
    mi_res, wall_scipy, _, _ = retrieval("g3_scipy", *base, "clustering_method=scipy")
    const, _, _, _ = retrieval("g3_scipy_constant", *base, "clustering_method=scipy",
                               "measure=constant")
    log(f"G3 mnist_sound scipy: {wall_scipy:.2f} s, f1 {mi_res['f1']:.4f} against the "
        f"constant measure's {const['f1']:.4f}")
    check(32 in {d for _, d, _ in shapes}, "G3: K1 launched on the log-mel width")
    check(mi_res["f1"] > const["f1"], "G3: F1 above the constant measure's")
    return launches, shapes


def path_g4_grid() -> tuple:
    """G4: a 2-job dict grid on the card through ``--grid``, inline and on a
    pool of two spawned workers sharing the card: the same results. Returns
    the inline run's (K1 launches, K1's shapes); the workers' are not seen
    here."""
    grid = WORK / "g" / "grid.json"
    grid.parent.mkdir(parents=True, exist_ok=True)
    grid.write_text(json.dumps({"seed": [3, 4], "pairing": ["layer_0"],
                                "clustering_method": ["sgd"]}))

    def run(workers: int):
        out = WORK / "g" / f"grid_{workers}"
        lines, wall, launches, shapes = run_retrieval(out, "--grid", str(grid),
                                                      f"num_workers={workers}")
        return ([load_pickle(p) for p in sorted(out.glob("result_*.pkl"))], lines, wall,
                launches, shapes)

    inline, lines, wall, launches, shapes = run(1)
    pooled, pooled_lines, pooled_wall, _, _ = run(2)
    log(f"G4 grid of {len(inline)} jobs: inline {wall:.2f} s (K1 {launches} launches), "
        f"2 spawned workers on the card {pooled_wall:.2f} s with their start-up")
    check(len(inline) == 2 and pooled == inline and pooled_lines == lines,
          "G4: the pool's results are the inline run's")
    check(launches > 0, "G4: K1 launched")
    return launches, shapes


def main_path_g(gen: torch.Generator) -> int:
    """Path G; returns its K1 launches. Fails if K1 met a shape on the card
    that G0 did not hold against its plain version."""
    path_g0_k1(gen)
    launches, seen = 0, set()
    for phase in (path_g1_gaussian, path_g2_resnet, path_g3_mnist_sound, path_g4_grid):
        t0 = time.time()
        n, shapes = phase()
        launches += n
        seen.update(shapes)
        log(f"{phase.__name__} {time.time() - t0:.1f} s")
    log(f"path G: K1 met (rows, width, real width) {sorted(seen)}")
    check(seen <= set(G_SHAPES), f"path G: K1 met only shapes that G0 checked "
          f"(not checked: {sorted(seen - set(G_SHAPES))})")
    return launches


# -- phase 10: path H, the evaluation suite ----------------------------------------

# configs/acav_pretrain.yaml's values (the card's machine has no PyYAML, so
# path H hands them to ``evaluate`` as JSON; a CPU test holds the two equal)
H_PRETRAIN = {
    "task": "pretrain",
    "data": {"path": "data/curated/shard-{000000..000009}.tar", "batch_size": 4,
             "num_frames": 8, "crop": 112},
    "train": {"num_steps": 1000, "base_lr": 0.001, "warmup_steps": 100,
              "save_period": 100},
    "checkpoint": {"dir": "runs/acav_pretrain"},
}
H_TOL = {"loss": 1e-4, "params": 1e-4, "stats": 1e-5, "features": 1e-4}


def evaluate(*args) -> dict:
    """``evaluate`` through the port's CLI; returns its JSON line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["evaluate", *args])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def h_batch(rng: np.random.RandomState, b: int) -> tuple:
    """A pretrain batch at full width: uint8 frames (b, 8, 112, 112, 3) and
    log-mels (b, 80, 128, 1)."""
    return (rng.randint(0, 256, (b, 8, 112, 112, 3)).astype(np.uint8),
            rng.randn(b, 80, 128, 1).astype(np.float32))


def h_tree() -> dict:
    """A seeded numpy weight tree (random BN gammas and statistics) of the full-width ``Contrast``."""
    from acav100m_torch.evaluation import models as em
    from tests.torch_parity import random_variables

    return random_variables(em.flax_from_state_dict(em.Contrast().state_dict()), seed=12)


def h_tree_state(tree: dict, device, dtype, group=None):
    """The full-width ``Contrast`` loaded with ``tree``, in ``dtype`` on
    ``device`` (over ``group``), with adamw at lr 1e-3, no warmup."""
    from acav100m_torch.evaluation import models as em
    from acav100m_torch.evaluation import train as et

    state = et.init_pretrain(0, et.lr_schedule("linear", 1e-3, 10), device, group=group)
    state.model.load_state_dict(em.state_dict_from_flax(tree))
    state.model.to(dtype)
    state.optimizer = et.build_optimizer("adamw", state.model.named_parameters(),
                                         state.schedule)
    return state


def h0_step(tree: dict, visual, audio, device, dtype, group=None) -> tuple:
    """One adamw step (lr 1e-3, no warmup) of the full-width ``Contrast``
    loaded with ``tree``, in ``dtype`` on ``device`` (over ``group``, on
    the global batch) -> (loss, acc, wall seconds, the state dict after the
    step on the CPU, a digest of the parameters, statistics and optimizer
    state)."""
    from acav100m_torch.evaluation import train as et

    state = h_tree_state(tree, device, dtype, group)
    t0 = time.time()
    state, metrics = et.make_pretrain_step(state, group)(state, visual, audio)
    loss, acc = float(metrics["loss"]), float(metrics["acc"])
    wall = time.time() - t0
    opt = state.optimizer.state_dict()["state"]
    digest = hashlib.sha256()
    for t in [*state.model.state_dict().values(),
              *(v for i in sorted(opt) for _, v in sorted(opt[i].items()))]:
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return loss, acc, wall, {k: v.detach().cpu().double()
                             for k, v in state.model.state_dict().items()}, digest.hexdigest()


def h0_errors(a: tuple, b: tuple, names) -> tuple:
    """(loss relative error, largest relative L2 error of a parameter,
    largest relative error of a running statistic) of step ``a`` against
    ``b``."""
    sa, sb = a[3], b[3]
    p_err = max(float((sa[k] - sb[k]).norm() / sb[k].norm()) for k in names)
    s_err = max(float((sa[k] - sb[k]).abs().max() / sb[k].abs().max())
                for k in sb if k.endswith(("running_mean", "running_var")))
    return abs(a[0] - b[0]) / abs(b[0]), p_err, s_err


def path_h0_step() -> None:
    """H0: one adamw step (lr 1e-3, no warmup) of the full-width ``Contrast``
    on a batch of 2 at 8 x 112^2, from one seeded weight tree made with
    numpy (random BN gammas and statistics), on the card and on the CPU,
    TF32 off. Gated in float64: loss, accuracy, every updated parameter and
    the running statistics. In float32, batch norm in train mode (the
    projection heads' over 2 rows) turns rounding into differences of about
    1e-3 on any device, so each device's float32 step is held against the
    float64 CPU step: the card's loss and params may be off by at most 3
    times the CPU's own float32 error (or by the float64 tolerance)."""
    from acav100m_torch.evaluation import models as em

    tree = h_tree()
    visual, audio = h_batch(np.random.RandomState(12), 2)
    names = [k for k, _ in em.Contrast().named_parameters()]
    with no_tf32():
        runs = {(dev, str(dt).split(".")[-1]): h0_step(tree, visual, audio, dev, dt)
                for dt in (torch.float64, torch.float32) for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda", "float64"], runs["cpu", "float64"]
    l_err, p_err, s_err = h0_errors(card, cpu, names)
    log(f"H0 one full-width train step, B=2, float64, card ({card[2]:.2f} s with its first "
        f"call) against CPU ({cpu[2]:.2f} s): loss {card[0]:.9f} vs {cpu[0]:.9f} (rel err "
        f"{l_err:.2e}), acc {card[1]:.1f} vs {cpu[1]:.1f}, params rel L2 err {p_err:.2e}, "
        f"running stats rel err {s_err:.2e}")
    f32 = {}
    for dev in ("cuda", "cpu"):
        run = runs[dev, "float32"]
        f32[dev] = h0_errors(run, cpu, names)
        log(f"H0 float32 (TF32 off) on {dev} ({run[2]:.2f} s) against the float64 CPU step: "
            f"loss {run[0]:.6f} (rel err {f32[dev][0]:.2e}), acc {run[1]:.1f}, params rel L2 "
            f"err {f32[dev][1]:.2e}, running stats rel err {f32[dev][2]:.2e}")
    for i, what in enumerate(("loss", "params")):
        check(f32["cuda"][i] <= max(3 * f32["cpu"][i], H_TOL[what]),
              f"H0: the card's float32 {what} within 3 times the CPU's float32 error "
              f"({f32['cuda'][i]:.2e} against {f32['cpu'][i]:.2e})")
    check(l_err <= H_TOL["loss"], "H0: the card's loss within 1e-4 of the CPU's")
    check(card[1] == cpu[1], "H0: the card's accuracy is the CPU's")
    check(p_err <= H_TOL["params"], "H0: updated params within 1e-4 relative L2")
    check(s_err <= H_TOL["stats"], "H0: running statistics within 1e-5")


def path_h2_pretrain(clips: Path) -> Path:
    """H2: ``evaluate`` pretraining with ``configs/acav_pretrain.yaml``'s
    values (given as JSON) for 8 steps of batch 4 on the card, then resumed
    to 12; then a warm train step on one batch: its ms in 3 runs of 5 steps
    with the device synchronised around each, its operations
    (``torch.utils.flop_counter``) and bound, and its device time by kernel.
    Returns the run's directory."""
    from torch.utils.flop_counter import FlopCounterMode

    from acav100m_torch.evaluation import data as ed
    from acav100m_torch.evaluation import train as et
    from acav100m_torch.data.meta import load_metadata

    run = WORK / "h" / "run"
    cfg = WORK / "h" / "acav_pretrain.json"
    cfg.write_text(json.dumps(H_PRETRAIN))
    args = ["--cfg", str(cfg), f"data.path={clips}/shard-{{000000..000003}}.tar",
            "data.batch_size=4", "train.save_period=8", "train.log_every=1",
            f"checkpoint.dir={run}"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    first = evaluate(*args, "train.num_steps=8")
    t_first = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    second = {}
    t_second, busy, kernels, copies = device_busy(
        lambda: second.update(evaluate(*args, "train.num_steps=12")))
    lines = [json.loads(x) for x in (run / "stats.jsonl").read_text().splitlines()]
    iters = [x for x in lines if x["_type"] == "train_iter"]
    steps = [x["step"] for x in iters]
    walls = np.diff([0.0] + [x["time"] for x in iters[:8]]) * 1e3
    log(f"H2 evaluate pretrain, 8 steps of batch 4 at 8 x 112^2: {t_first:.2f} s, peak "
        f"device memory {peak:.2f} GiB, ms a step with its batch's decode and log-mels "
        + ", ".join(f"{w:.1f}" for w in walls) + "; losses "
        + ", ".join(f"{x['loss']:.4f}" for x in iters))
    log(f"H2 resumed to 12 steps: {t_second:.2f} s, {second}; the card busy "
        f"{kernels:.3f} s with kernels and {copies:.3f} s with copies "
        f"({100 * busy / t_second:.1f}% of the call)")
    check(first == {"task": "pretrain", "steps": 8}, f"H2: 8 steps ({first})")
    check(second == {"task": "pretrain", "steps": 12}, f"H2: 12 steps ({second})")
    check(steps == list(range(1, 13)), f"H2: the second call resumed at step 8 ({steps})")
    check(all(math.isfinite(x["loss"]) for x in iters), "H2: the losses are finite")
    check(all((run / n).is_file() for n in ("step_latest.ckpt", "epoch_latest.ckpt",
                                             "stats.jsonl")), "H2: checkpoints and stats")
    shards = sorted(clips.glob("shard-*.tar"))
    batch = next(ed.pretrain_batches(shards, load_metadata(shards)[0], 4,
                                     np.random.RandomState(0)))
    state = et.init_pretrain(0, et.lr_schedule("linear", 1e-3, 100), "cuda")
    step = et.make_pretrain_step(state)
    for _ in range(2):
        state, metrics = step(state, batch["visual"], batch["audio"])
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(5):
            state, metrics = step(state, batch["visual"], batch["audio"])
        torch.cuda.synchronize()
        ms.append((time.time() - t0) / 5 * 1e3)
    with FlopCounterMode(display=False) as flops:
        state, metrics = step(state, batch["visual"], batch["audio"])
    n = flops.get_total_flops()
    log(f"H2 warm train step, batch 4 at 8 x 112^2 (cuDNN TF32 on): "
        f"{', '.join(f'{x:.2f}' for x in ms)} ms (3 runs of 5 steps between "
        f"synchronisations); "
        f"{n / 1e9:.1f} GFLOP (torch.utils.flop_counter), bound "
        f"{n / TF32_TENSOR_FLOPS * 1e3:.3f} ms at {TF32_TENSOR_FLOPS / 1e12:.0f} TFLOP/s TF32; "
        f"{sum(p.numel() for p in state.model.parameters()) / 1e6:.2f} M parameters")
    profile_run("H2 warm train step by kernel", lambda: step(state, batch["visual"],
                                                             batch["audio"]), top=12)
    return run


def h_test_batches(classify: Path):
    """The classify/ test split's views (2 ensemble views a clip), in
    batches of 4, as ``evaluate`` builds them."""
    from acav100m_torch.evaluation.config import _collate_classify
    from acav100m_torch.evaluation.data import ClipClassificationDataset

    exs = list(ClipClassificationDataset(classify, "test").examples(
        np.random.RandomState(0)))
    return [_collate_classify(exs[i:i + 4]) for i in range(0, len(exs), 4)]


def path_h3_linear_eval(classify: Path, run: Path) -> None:
    """H3: ``evaluate task=linear_eval`` on ``classify/`` from H2's
    ``epoch_latest.ckpt`` (multimodal, 20 head steps), with the train
    features computed each step and cached once; then the test views'
    frozen features on the card against the CPU's (TF32 off)."""
    from acav100m_torch.evaluation import train as et

    ckpt = run / "epoch_latest.ckpt"
    base = ["task=linear_eval", f"data.path={classify}", f"checkpoint.pretrained={ckpt}",
            "eval.mode=multimodal", "eval.num_steps=20"]
    for cache in ("false", "true"):
        t0 = time.time()
        res = evaluate(*base, f"eval.cache_features={cache}")
        log(f"H3 linear eval, cache_features={cache}: top-1 {res['top1']:.1f}, "
            f"top-5 {res['top5']:.1f}, {time.time() - t0:.2f} s")
        check(set(res) == {"task", "top1", "top5"} and 0 <= res["top1"] <= res["top5"],
              f"H3: a result ({res})")
    backbone = et.load_pretrained_backbone(ckpt)
    batches = h_test_batches(classify)
    with no_tf32():
        card = [et.make_feature_fn(backbone, "multimodal", "cuda")(b["visual"], b["audio"])
                .cpu() for b in batches]
    cpu = [et.make_feature_fn(backbone, "multimodal", "cpu")(b["visual"], b["audio"])
           for b in batches]
    err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(card, cpu))
    n = sum(len(b["label"]) for b in batches)
    log(f"H3 frozen features of the {n} test views (3072 each), card (TF32 off) against "
        f"CPU: rel err {err:.2e}")
    check(err <= H_TOL["features"], "H3: the card's features within 1e-4 of the CPU's")


def main_path_h() -> dict:
    """Path H; returns the kernels' launches in it (none of them runs)."""
    log(f"path H starts with the host's load average {os.getloadavg()[0]:.2f}, "
        f"{len(multiprocessing.active_children())} live child processes and "
        f"{threading.active_count()} threads")
    reset_counts()
    t0 = time.time()
    path_h0_step()
    log(f"path_h0_step {time.time() - t0:.1f} s")
    clips = WORK / "h" / "clips"
    t0 = time.time()
    cli.main(["fixtures", str(clips), "--num_shards=4", "--clips_per_shard=8",
              "--size=128", "--labels"])
    log(f"H1 fixtures --labels, 4 shards x 8 clips at 128^2: {time.time() - t0:.2f} s")
    t0 = time.time()
    run = path_h2_pretrain(clips)
    log(f"path_h2_pretrain {time.time() - t0:.1f} s")
    t0 = time.time()
    path_h3_linear_eval(clips / "classify", run)
    log(f"path_h3_linear_eval {time.time() - t0:.1f} s")
    return counts()


# -- phase 11: paths H4 and H5, the sharded pretrain step and bf16 ----------------

H4_BATCH = 4  # the float64 gate's global batch
H4_TIMED_BATCH = 8  # the float32 timing's global batch
H4_TOL = {"params": 1e-9, "loss": 1e-10}
H5_FLOOR = 1e-3  # the card's bf16 error may reach 3x the CPU's, or this


# the function of ``runtime.mesh`` or ``evaluation.models`` that called
# ``all_reduce_sum`` or ``all_gather_cat`` -> the kind of collective
COLLECTIVE_KINDS = {"all_reduce_sum_flat": "grads", "_GroupBatchNorm": "bn",
                    "_GatherRows": "gather", "_SumShares": "loss"}


@contextlib.contextmanager
def timed_collectives():
    """Times each ``all_reduce`` and ``all_gather`` the port issues, the
    device synchronized before and after each (host clock, ms), by kind
    (``COLLECTIVE_KINDS``, from the caller of the port's collective): the
    gradients' flat bucket, batch norm's statistics and gradient sums, the
    embeddings' gathers and their gradients' all-reduces, the loss and
    accuracy."""
    import torch.distributed as dist

    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}
    times = {kind: [] for kind in (*COLLECTIVE_KINDS.values(), "other")}

    def timed(name):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real[name](*args, **kwargs)
            torch.cuda.synchronize()
            caller = sys._getframe(2).f_code.co_qualname
            kind = next((k for part, k in COLLECTIVE_KINDS.items() if part in caller), "other")
            times[kind].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    for name in real:
        setattr(dist, name, timed(name))
    try:
        yield times
    finally:
        for name, fn in real.items():
            setattr(dist, name, fn)


def h4_timing(group) -> dict:
    """Float32 steps (cuDNN TF32 as in H2) of a fresh full-width model at a
    global batch of 8 over ``group`` (None: one process): 3 warm steps'
    wall, one more step's collectives timed one by one, peak memory."""
    from acav100m_torch.evaluation import train as et

    state = et.init_pretrain(0, et.lr_schedule("linear", 1e-3, 100),
                             "cuda" if group is None else None, group=group)
    step = et.make_pretrain_step(state, group)
    visual, audio = h_batch(np.random.RandomState(14), H4_TIMED_BATCH)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = step(state, visual, audio)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, visual, audio)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with timed_collectives() as calls:
        state, metrics = step(state, visual, audio)
    check(not calls["other"], "H4: every collective of the step is of a known kind")
    return {"step_ms": walls, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "collectives": {k: [len(v), sum(v)] for k, v in calls.items()},
            "timed_loss": float(metrics["loss"])}


def h4_rank(group, root: Path) -> dict:
    """One rank of H4: the float64 gate step (TF32 off) on the global batch
    of 4 (rank 0 saves its state dict), then ``h4_timing``."""
    reset_counts()
    visual, audio = h_batch(np.random.RandomState(13), H4_BATCH)
    with no_tf32():
        loss, acc, wall, sd, digest = h0_step(h_tree(), visual, audio, None, torch.float64,
                                              group)
    if group.rank == 0:
        torch.save(sd, root / "h4_rank0.pt")
    del sd
    out = {"loss": loss, "acc": acc, "digest": digest, "gate_s": wall, **h4_timing(group)}
    out["launches"] = counts()
    return out


def h4_errors(loss: float, acc: float, sd: dict, one: tuple, names) -> tuple:
    l_err, p_err, s_err = h0_errors((loss, acc, 0.0, sd), one, names)
    check(p_err <= H4_TOL["params"] and l_err <= H4_TOL["loss"] and acc == one[1],
          f"H4: the sharded step within {H4_TOL} of the unsharded step, accuracy equal "
          f"(params {p_err:.2e}, loss {loss!r} vs {one[0]!r}, rel err {l_err:.2e}, acc {acc} "
          f"vs {one[1]})")
    return l_err, p_err, s_err


def h4_ranks(label: str, results: list, root: Path, one: tuple, names) -> None:
    """The ranks' gate steps: bit-identical, and rank 0's against the
    unsharded step ``one``; then their timing, printed."""
    check(len({(r["digest"], r["loss"], r["acc"], r["timed_loss"]) for r in results}) == 1,
          f"H4 {label}: every rank ends with the same loss, accuracy, parameters, "
          f"statistics and optimizer state")
    check(all(not any(r["launches"].values()) for r in results),
          f"H4 {label}: no kernel of the table launched ({[r['launches'] for r in results]})")
    errs = h4_errors(results[0]["loss"], results[0]["acc"], torch.load(root / "h4_rank0.pt"),
                     one, names)
    log(f"H4 {label}, float64 step at a global batch of {H4_BATCH} (TF32 off): ranks "
        f"bit-identical; against the unsharded card step: loss rel err {errs[0]:.2e}, params "
        f"rel L2 {errs[1]:.2e}, running stats {errs[2]:.2e}; "
        f"{[round(r['gate_s'], 2) for r in results]} s with the first call")
    for r in results:
        c = r["collectives"]
        log(f"H4 {label}, float32 step at a global batch of {H4_TIMED_BATCH} "
            f"({H4_TIMED_BATCH // len(results)} a rank, cuDNN TF32): warm walls "
            f"{', '.join(f'{x:.2f}' for x in r['step_ms'])} ms; one step's collectives, each "
            f"between synchronizations: gradient all-reduce {c['grads'][0]} x "
            f"{c['grads'][1]:.2f} ms, batch norm {c['bn'][0]} all-reduces {c['bn'][1]:.2f} ms, "
            f"the embeddings' gathers and their gradients {c['gather'][0]} "
            f"{c['gather'][1]:.2f} ms, loss {c['loss'][0]} {c['loss'][1]:.2f} ms; peak "
            f"{r['peak_gib']:.2f} GiB; {card()}")


def path_h4_sharded() -> None:
    """H4: the sharded pretrain step at full width, 8 x 112^2. The float64
    gate (TF32 off): 2 gloo ranks sharing ``cuda:0``, a one-rank NCCL group
    and, with more cards, one NCCL rank a card (2 or 4), each against the
    unsharded card step on the same global batch of 4 and bit-identical
    across ranks. Then float32 at a global batch of 8: each rank's warm
    step, its gradient all-reduce and batch-norm collectives, peak memory,
    beside the unsharded step's."""
    from acav100m_torch.evaluation import models as em

    root = WORK / "h4"
    names = [k for k, _ in em.Contrast().named_parameters()]
    tree = h_tree()
    visual, audio = h_batch(np.random.RandomState(13), H4_BATCH)
    with no_tf32():
        one = h0_step(tree, visual, audio, "cuda", torch.float64)
    t0 = time.time()
    results = spawn_ranks(2, "gloo", ["cuda:0", "cuda:0"], ("h4",), root / "gloo")
    log(f"H4, 2 ranks sharing cuda:0 over gloo: {time.time() - t0:.1f} s from spawn to exit")
    h4_ranks("2 gloo ranks on cuda:0", [r["h4"] for r in results], root / "gloo", one, names)
    group = runtime.initialize_runtime(free_address(), 1, 0, device="cuda:0")
    try:
        check(group.backend == "nccl", "H4's one-rank group runs over NCCL")
        with no_tf32():
            nccl = h0_step(tree, visual, audio, None, torch.float64, group)
    finally:
        runtime.shutdown_runtime(group)
    errs = h4_errors(nccl[0], nccl[1], nccl[3], one, names)
    log(f"H4 one-rank NCCL group, float64: against the unsharded card step loss rel err "
        f"{errs[0]:.2e}, params rel L2 {errs[1]:.2e}, running stats {errs[2]:.2e}")
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        world = 4 if n_cards >= 4 else 2
        results = spawn_ranks(world, "nccl", [f"cuda:{r}" for r in range(world)], ("h4",),
                              root / "nccl")
        h4_ranks(f"{world} NCCL ranks, one a card", [r["h4"] for r in results],
                 root / "nccl", one, names)
    t = h4_timing(None)
    log(f"H4 unsharded float32 step at a batch of {H4_TIMED_BATCH} on one process: warm walls "
        f"{', '.join(f'{x:.2f}' for x in t['step_ms'])} ms, peak {t['peak_gib']:.2f} GiB")


def h5_embeddings(tree: dict, visual, audio, device: str, dtype) -> list:
    """Eval-mode embeddings of the full-width ``Contrast`` computing in
    ``dtype`` (float32 parameters; float64 ones for float64), as float64 on
    the CPU."""
    from acav100m_torch.evaluation import models as em
    from acav100m_torch.evaluation import train as et

    net = em.Contrast(dtype=None if dtype == torch.float64 else dtype)
    net.load_state_dict(em.state_dict_from_flax(tree))
    net.to(device, torch.float64 if dtype == torch.float64 else torch.float32).eval()
    with torch.no_grad():
        zs = net(*et.model_inputs(visual, audio, device, next(net.parameters()).dtype))
    check(all(z.dtype == dtype for z in zs), f"H5: {dtype} embeddings")
    return [z.double().cpu() for z in zs]


def h5_step(dtype) -> dict:
    """A fresh full-width model computing in ``dtype`` at batch 4, 8 x
    112^2 (cuDNN TF32 as in H2): 3 runs of 5 warm steps, the device time of
    its kernels a step, peak memory, the losses, and whether the parameters
    and statistics after are float32 and finite."""
    from acav100m_torch.evaluation import train as et

    state = et.init_pretrain(0, et.lr_schedule("linear", 1e-3, 100), "cuda", dtype=dtype)
    step = et.make_pretrain_step(state)
    visual, audio = h_batch(np.random.RandomState(15), 4)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(2):
        state, metrics = step(state, visual, audio)
        losses.append(float(metrics["loss"]))
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            state, metrics = step(state, visual, audio)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) / 5 * 1e3)
        losses.append(float(metrics["loss"]))
    _, wall_us, rows = profile_calls(lambda: step(state, visual, audio))
    float32 = all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                  for k, v in state.model.state_dict().items()
                  if not k.endswith("num_batches_tracked"))
    return {"ms": ms, "kernels_ms": sum(us for us, _, _ in rows) / 1e3,
            "profiled_ms": wall_us / 1e3, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "losses": losses, "float32_state": float32}


def path_h5_bf16() -> None:
    """H5: the evaluation models in bf16 at full width. The card's bf16
    eval-mode embeddings (batch 4, 8 x 112^2, H0's tree) against its
    float64 ones may be off by at most 3 times the CPU's own bf16 error at
    the same inputs; then a bf16 train step: finite losses, float32
    parameters and statistics; its warm wall, kernels and peak memory
    beside the float32 step's."""
    tree = h_tree()
    visual, audio = h_batch(np.random.RandomState(16), 4)
    errs = {}
    for dev in ("cuda", "cpu"):
        ref = h5_embeddings(tree, visual, audio, dev, torch.float64)
        bf16 = h5_embeddings(tree, visual, audio, dev, torch.bfloat16)
        errs[dev] = max(float((b - r).norm() / r.norm()) for b, r in zip(bf16, ref))
    log(f"H5 bf16 eval-mode embeddings, batch 4 at 8 x 112^2, against float64 on the same "
        f"device: card rel L2 {errs['cuda']:.2e}, CPU {errs['cpu']:.2e}")
    check(errs["cuda"] <= max(3 * errs["cpu"], H5_FLOOR),
          "H5: the card's bf16 embeddings within 3 times the CPU's bf16 error")
    runs = {str(dt).split(".")[-1]: h5_step(dt) for dt in (torch.bfloat16, torch.float32)}
    check(all(math.isfinite(x) for x in runs["bfloat16"]["losses"]), "H5: finite bf16 losses")
    check(runs["bfloat16"]["float32_state"],
          "H5: the bf16 model's parameters and statistics stay float32 and finite")
    for name, r in runs.items():
        log(f"H5 {name} train step, batch 4 at 8 x 112^2 (cuDNN TF32 on): "
            f"{', '.join(f'{x:.2f}' for x in r['ms'])} ms (3 runs of 5 steps between "
            f"synchronisations); kernels {r['kernels_ms']:.2f} ms a step "
            f"(torch.profiler, {r['profiled_ms']:.2f} ms profiled); peak {r['peak_gib']:.2f} GiB; "
            f"losses {', '.join(f'{x:.4f}' for x in r['losses'])}; {card()}")


def main_path_h45() -> dict:
    """Paths H4 and H5; returns the kernels' launches in them (none runs)."""
    reset_counts()
    for phase in (path_h4_sharded, path_h5_bf16):
        t0 = time.time()
        phase()
        log(f"{phase.__name__} {time.time() - t0:.1f} s")
    return counts()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    shutil.rmtree(WORK, ignore_errors=True)
    # phase 1
    with tracing.enabled():
        cuda_build.build([name for name, _, _ in KERNELS])
        built = next(s for s in tracing.spans() if s.name == "span.kernels.build")
    log(f"built {len(KERNELS)} kernels in {(built.end_ns - built.start_ns) / 1e9:.1f} s "
        f"(nvcc for {', '.join(built.attrs['names']) or 'none'})")
    log(card())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")
    # phase 2, TF32 off for the comparisons
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    results = {"kmeans_assign_update": check_k1(gen), "bottleneck_stage": check_k2(gen),
               "bottleneck_stage_bf16": check_k2_bf16(gen), "nonlocal_core_bf16": check_nln(gen),
               "batch_mi_step": check_batch_mi(), "conv_epilogue": check_epilogue(gen)}
    # phase 3: the default precision again (cuDNN convs in TF32)
    torch.backends.cudnn.allow_tf32 = True
    t0 = time.time()
    launches, f32_taps = main_path_a(gen)
    log(f"path A total {time.time() - t0:.1f} s")
    t0 = time.time()
    launches["bottleneck_stage_bf16"] = main_path_a_bf16(f32_taps)["bottleneck_stage_bf16"]
    log(f"path A-bf16 total {time.time() - t0:.1f} s")
    t0 = time.time()
    for name, n in main_path_a_nln().items():
        launches[name] += n
    log(f"path A-nln total {time.time() - t0:.1f} s")
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
    t0 = time.time()
    for name, n in main_path_f().items():
        launches[name] += n
    log(f"path F total {time.time() - t0:.1f} s")
    t0 = time.time()
    g_launches = main_path_g(gen)
    launches["kmeans_assign_update"] += g_launches
    log(f"path G total {time.time() - t0:.1f} s; K1 {g_launches} launches")
    t0 = time.time()
    h_launches = main_path_h()
    log(f"path H total {time.time() - t0:.1f} s; launches {h_launches}")
    check(not any(h_launches.values()), "path H launches none of the kernels")
    t0 = time.time()
    h45_launches = main_path_h45()
    log(f"paths H4 and H5 total {time.time() - t0:.1f} s; launches {h45_launches}")
    check(not any(h45_launches.values()), "paths H4 and H5 launch none of the kernels")
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

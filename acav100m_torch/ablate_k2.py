"""Where kernel K2's time goes, by ablation, on one GPU.

    python -m acav100m_torch.ablate_k2

Without a hardware profiler, this builds variants of
``csrc/bottleneck_stage.cu``, each with one part of the work taken out by a
text substitution, and times each at the main path's shape (SlowFast
``s2`` slow: 32 frames of 64x64, Cin 80 -> 256, inner 64, 3 blocks) as the
median of 20 back-to-back calls between CUDA events. A variant computes
wrong numbers; only its time is read, beside the full kernel's. Each
substitution must match the source, so an edit to the kernel that moves
what a variant removes makes this script fail instead of timing the wrong
thing. It also prints ``ptxas``'s register and spill count for each
variant and the full kernel's most frequent SASS instructions.

Each form runs on its weights packed as the model caches them
(``pack_block_f32``, ``pack_block_bf16``). K2's bf16 form
(``csrc/bottleneck_stage_bf16.cu``) is timed beside the float32 form in the
same way, on bf16 inputs of the same shape, with its own variants; and the
card's own rate of the tensor-core instructions the forms issue is
measured: ``wgmma`` TF32 (from shared memory, and with A from registers as
the float32 form issues it), ``wgmma`` bf16, and ``mma.sync`` TF32 and
bf16 for comparison.

    python -m acav100m_torch.ablate_k2 --parent OLD.cu

also builds OLD.cu, either form's source from an earlier checkout (e.g.
``git show HEAD~1:acav100m_torch/csrc/bottleneck_stage.cu``; a launcher
that takes raw weights and the output tile gets them, one that takes the
pack gets this checkout's pack), and times it beside this checkout's
kernel of the same form in turns (parent, this, this, parent); ``--timeline`` prints only each form's time by phase of a
tile, from %globaltimer stamps (``TIMELINE_F32``, ``TIMELINE_BF16``).
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import functools
import re
import subprocess
import sys
from pathlib import Path
from typing import Optional

import torch

from .ops import cuda_build
from .ops.bottleneck_kernel import (_KEYS, _ptr, bind, fused_stage_ref, pack_block_bf16,
                                    pack_block_f32)
from .profiling import card, time_ms

SRC = cuda_build.CSRC / "bottleneck_stage.cu"
SRC_BF16 = cuda_build.CSRC / "bottleneck_stage_bf16.cu"
OUT = cuda_build.BUILD_DIR / "ablate_k2"

# name -> [(text in the source, replacement)]
_MMA3_CALLS = ("mma3<CI, RA>(", "mma3<NB, RB>(", "mma3<PASS, RB>(")
VARIANTS = {
    "full": [],
    # staging, the ring, barriers and epilogues alone: no product, so the
    # fragment loads and splits drop out with them
    "no_products": [(c, "if (false) " + c) for c in _MMA3_CALLS],
    # the wgmma instructions commented out of their asm, which keeps the
    # fragment loads and splits that feed them
    "no_mma": [('      "wgmma.mma_async.sync.aligned.m64n',
                '      "// wgmma.mma_async.sync.aligned.m64n')],
    # 1xTF32: only the big.big product of each k8 step
    "one_product": [(
        "  for (int m = 0; m < R; ++m) wgmma<N>(d[m], as[m], db_big, scale);\n"
        "#pragma unroll\n"
        "  for (int m = 0; m < R; ++m) wgmma<N>(d[m], ab[m], db_small, 1);\n"
        "#pragma unroll\n"
        "  for (int m = 0; m < R; ++m) wgmma<N>(d[m], ab[m], db_big, 1);\n",
        "  for (int m = 0; m < R; ++m) wgmma<N>(d[m], ab[m], db_big, scale);\n")],
    # no split: the raw fp32 bits go in as big and small
    "no_split": [(
        "  big = tf32_rna(v);\n"
        "  small = tf32_rna(v - __uint_as_float(big));\n",
        "  big = small = __float_as_uint(v);\n")],
    # the products alone: A's fragments are constants, so their shared
    # memory loads and splits drop out
    "only_mma": [("split(at(r0, 0), big[0], small[0]);", "split(1.f, big[0], small[0]);"),
                 ("split(at(r1, 0), big[1], small[1]);", "split(2.f, big[1], small[1]);"),
                 ("split(at(r0, 1), big[2], small[2]);", "split(3.f, big[2], small[2]);"),
                 ("split(at(r1, 1), big[3], small[3]);", "split(4.f, big[3], small[3]);")],
    # one product's loads, splits and wgmma gone; its stages still pass
    "skip_a": [(_MMA3_CALLS[0], "if (false) " + _MMA3_CALLS[0])],
    "skip_b": [(_MMA3_CALLS[1], "if (false) " + _MMA3_CALLS[1])],
    "skip_c": [(_MMA3_CALLS[2], "if (false) " + _MMA3_CALLS[2])],
    # product b summed in one accumulator, not one a tap: its error is the
    # number to read (see ACCUMULATION in the source)
    "b_one_acc": [("mma3<NB, RB>(part,", "mma3<NB, RB>(acc_b,"),
                  ("make_desc(w + BWB, CI * 16, 128), ks > 0);",
                   "make_desc(w + BWB, CI * 16, 128), 1);"),
                  ("for (int i = 0; i < NB / 2; ++i) acc_b[m][i] += part[m][i];",
                   "for (int i = 0; i < NB / 2; ++i) part[m][i] += 0.f;")],
    # product c's epilogue reads no identity from its stages
    "c_epi_no_reads": [("const float2 sc = *e;", "const float2 sc = make_float2(0.f, 0.f);")],
    # ... or stores nothing (its TMA stores not issued)
    "c_epi_no_stores": [("          tma_store_4d(&omap,", "          if (false) tma_store_4d(&omap,")],
    # the ring turns with no copies: every stage completes at once, unfilled
    "no_global": [("      mbar_expect_tx(bar, bytes);\n", "      mbar_arrive(bar);\n"),
                  ('"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes '
                   '[%0], [%1], %2, [%3];\\n"', '""'),
                  ('"cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
                   '      "[%0], [%1, {%2, %3, %4, %5}], [%6];\\n"', '""'),
                  ('"cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "\n'
                   '      "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\\n"', '""')],
    # two stages in the ring instead of as many as fit
    "ring2": [("p.NS = min(MAXNS, ", "p.NS = min(2, ")],
}


# the bf16 form's variants, on the same plan
VARIANTS_BF16 = {
    "full": [],
    # no tensor-core work: the wgmma instructions emptied (their operands
    # come from shared memory by descriptor, so nothing else drops out)
    "no_mma": [(
        "  if constexpr (N == 16) wgmma_n16(d, da, db);\n"
        "  else if constexpr (N == 32) wgmma_n32(d, da, db);\n"
        "  else if constexpr (N == 64) wgmma_n64(d, da, db);\n"
        "  else if constexpr (N == 128) wgmma_n128(d, da, db);\n"
        "  else wgmma_n256(d, da, db);\n", "")],
    # product b's (the 3x3's) wgmma gone
    "skip_b": [("wgmma<NB>(acc_b", "if (false) wgmma<NB>(acc_b")],
    # loads, the ring, barriers and epilogues alone
    "no_products": [("wgmma<NW>(acc_a[m]", "if (false) wgmma<NW>(acc_a[m]"),
                    ("wgmma<NB>(acc_b", "if (false) wgmma<NB>(acc_b"),
                    ("wgmma<NC>(acc_c", "if (false) wgmma<NC>(acc_c")],
}


# ``--timeline``: each form's kernel with a %globaltimer stamp taken by each
# CTA's first consumer thread at the boundaries of a tile's phases, for the
# CTA's first 8 tiles, read back through read_timeline(). Stamp k ends
# phase k - 1.
TIMELINE_PHASES = ("product a", "epilogue a", "product b", "epilogue b", "product c",
                   "wait for c", "epilogue c")
TIMELINE_PHASES_F32 = ("product a", "epilogue a", "product b", "epilogue b",
                       "product c and its epilogue")
_DECL = "extern __shared__ __align__(128) unsigned char smem[];\n"
_STAMPS = (_DECL + "__device__ unsigned long long g_tl[256 * 8 * 8];\n"
           "#define STAMP(k) if (threadIdx.x == 0 && blockIdx.x < 256 && i < 8) { "
           "unsigned long long v_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(v_)); "
           "g_tl[(blockIdx.x * 8 + i) * 8 + (k)] = v_; }\n")


def _read_timeline(entry):
    return ('extern "C" int read_timeline(void* dst) {\n'
            '  return (int)cudaMemcpyFromSymbol(dst, g_tl, sizeof(g_tl));\n}\n\n'
            f'extern "C" int {entry}(')


_LOOP = ("  for (int t = blockIdx.x, i = 0; t < p.tiles; t += gridDim.x, ++i) {\n"
         "    const int frame = t / tiles_frame, r = t % tiles_frame;\n"
         "    const int oy0 = (r / p.tiles_x) * G::TH, ox0 = (r % p.tiles_x) * G::TW;\n"
         "    const bf16_t* xn")
TIMELINE_BF16 = [
    (_DECL, _STAMPS),
    (_LOOP, _LOOP.replace("{\n", "{\n    STAMP(0)\n", 1)),
    ("    consumers_sync();  // the last tile's",
     "    STAMP(1)\n    consumers_sync();  // the last tile's"),
    ("    consumers_sync();  // a is whole\n", "    consumers_sync();  // a is whole\n    STAMP(2)\n"),
    ("    consumers_sync();  // every warpgroup",
     "    STAMP(3)\n    consumers_sync();  // every warpgroup"),
    ("    consumers_sync();  // b is whole\n", "    consumers_sync();  // b is whole\n    STAMP(4)\n"),
    ("      wgmma_wait_all();\n      // product c is done with b",
     "      STAMP(5)\n      wgmma_wait_all();\n      STAMP(6)\n      // product c is done with b"),
    ("\n    }\n  }\n}\n\n// ---- the launcher", "\n    }\n    STAMP(7)\n  }\n}\n\n// ---- the launcher"),
    ('extern "C" int bottleneck_block_bf16(', _read_timeline("bottleneck_block_bf16")),
]
_LOOP_F32 = ("    const int oy0 = (r / p.tiles_x) * G::TH, ox0 = (r % p.tiles_x) * G::TW;\n\n"
             "    // 1. a = relu")
TIMELINE_F32 = [
    (_DECL, _STAMPS),
    (_LOOP_F32, _LOOP_F32.replace(
        "\n\n", "\n    const int i = (t - (int)blockIdx.x) / (int)gridDim.x;\n    STAMP(0)\n\n", 1)),
    ("    consumers_sync();  // the last tile's",
     "    STAMP(1)\n    consumers_sync();  // the last tile's"),
    ("    consumers_sync();  // a is whole\n", "    consumers_sync();  // a is whole\n    STAMP(2)\n"),
    ("    consumers_sync();  // every warpgroup",
     "    STAMP(3)\n    consumers_sync();  // every warpgroup"),
    ("    consumers_sync();  // b is whole\n", "    consumers_sync();  // b is whole\n    STAMP(4)\n"),
    ("\n    }\n  }\n  if (leader) bulk_wait();\n}",
     "\n    }\n    STAMP(5)\n  }\n  if (leader) bulk_wait();\n}"),
    ('extern "C" int bottleneck_block(', _read_timeline("bottleneck_block")),
]
# form -> (stamps, phases, source, C entry point)
TIMELINES = {"float32": (TIMELINE_F32, TIMELINE_PHASES_F32, SRC, "bottleneck_block"),
             "bf16": (TIMELINE_BF16, TIMELINE_PHASES, SRC_BF16, "bottleneck_block_bf16")}


def timeline(form, x, blocks, packed, outs, stream) -> None:
    """Build ``form``'s kernel with its stamps and print the mean time of
    each phase of a tile, for block 0 alone and for the stage's last
    block, over every CTA's first 8 tiles."""
    subs, phases, base, entry = TIMELINES[form]
    OUT.mkdir(parents=True, exist_ok=True)
    src, lib = OUT / f"{form}_timeline.cu", OUT / f"{form}_timeline.so"
    src.write_text(variant_source(subs, base))
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    fn = bind(dll, entry)
    last = len(phases)
    for count in (1, len(blocks)):
        for _ in range(3):
            run_stage(fn, x, blocks[:count], outs[:count], stream, packed[:count])
        torch.cuda.synchronize()
        stamps = torch.zeros(256 * 8 * 8, dtype=torch.int64)
        cuda_build.check(dll.read_timeline(ctypes.c_void_p(stamps.data_ptr())), "read_timeline")
        tiles = stamps.view(256, 8, 8)[:, :, :last + 1]
        tiles = tiles[tiles[:, :, last] > 0].double()  # tiles that ran to their end
        mean = (tiles[:, 1:] - tiles[:, :-1]).mean(0)
        print(f"{form} timeline, block {count - 1} ({len(tiles)} tiles, ns a tile): "
              + ", ".join(f"{name} {ns:.0f}" for name, ns in zip(phases, mean.tolist()))
              + f"; tile {float(mean.sum()):.0f}")


# The card's own rate for the instructions the forms issue: mma.sync
# m16n8k8 TF32 and m16n8k16 bf16 from registers, 8 independent accumulators
# a warp, two CTAs of 8 warps an SM; wgmma m64n256k16 bf16 and m64n256k8
# TF32 from shared memory (WGMMA_RATE_SRC), and wgmma m64n128k8 TF32 with A
# from registers (WGMMA_RS_RATE_SRC, as the float32 form's product c), three
# warpgroups an SM, each issuing 8 a batch into its own accumulator.
# (name, PTX, FLOP an instruction)
MMA_SHAPES = {
    "m16n8k8 TF32": ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32", 2 * 16 * 8 * 8),
    "m16n8k16 bf16": ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", 2 * 16 * 8 * 16),
    "wgmma m64n256k16 bf16": ("wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16",
                              2 * 64 * 256 * 16),
    "wgmma m64n256k8 TF32": ("wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32",
                             2 * 64 * 256 * 8),
    "wgmma m64n128k8 TF32, A from registers": (
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32", 2 * 64 * 128 * 8),
}
MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256, 2) mma_rate(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int r = 0; r < 4; ++r) a[r] = (threadIdx.x + r) << 13;
  for (int r = 0; r < 2; ++r) b[r] = (threadIdx.x * 3 + r) << 13;
  float acc[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile(
          "MMA "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int launch(void* out, int blocks, int iters, void* stream) {
  mma_rate<<<blocks, 256, 0, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


WGMMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
extern __shared__ __align__(128) unsigned char sm[];
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
__global__ void __launch_bounds__(384, 1) wgmma_rate(float* out, int iters) {
  for (int i = threadIdx.x; i < 10240 / 4; i += blockDim.x)
    reinterpret_cast<float*>(sm)[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sm);
  // A: 64 rows x 16 channels (2 planes of 1 KB); B: 256 rows x 16 (2 of 4 KB)
  const uint64_t da = desc(base, 1024, 128), db = desc(base + 2048, 4096, 128);
  float d[128];
  for (int j = 0; j < 128; ++j) d[j] = 0.f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                   "MMA {REGS}, %128, %129, p, 1, 1, 0, 0;\n}\n"
                   : OUTS : "l"(da), "l"(db), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.f;
  for (int j = 0; j < 128; ++j) s += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int launch(void* out, int blocks, int iters, void* stream) {
  cudaFuncSetAttribute(wgmma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, 10240);
  wgmma_rate<<<blocks, 384, 10240, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


WGMMA_RS_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
extern __shared__ __align__(128) unsigned char sm[];
__global__ void __launch_bounds__(384, 1) wgmma_rate(float* out, int iters) {
  for (int i = threadIdx.x; i < 8192 / 4; i += blockDim.x)
    reinterpret_cast<float*>(sm)[i] = 0.f;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(sm);
  // B: 128 rows x 8 TF32 channels, two planes of 4 KB
  const uint64_t db = (uint64_t)((base & 0x3FFFF) >> 4) | ((uint64_t)(4096 >> 4) << 16) |
                      ((uint64_t)(128 >> 4) << 32);
  uint32_t a[4];
  for (int r = 0; r < 4; ++r) a[r] = (threadIdx.x + r) << 13;
  float d[64];
  for (int j = 0; j < 64; ++j) d[j] = 0.f;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 8; ++k)
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                   "MMA {REGS}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                   : OUTS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  float s = 0.f;
  for (int j = 0; j < 64; ++j) s += d[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int launch(void* out, int blocks, int iters, void* stream) {
  cudaFuncSetAttribute(wgmma_rate, cudaFuncAttributeMaxDynamicSharedMemorySize, 8192);
  wgmma_rate<<<blocks, 384, 8192, (cudaStream_t)stream>>>((float*)out, iters);
  return (int)cudaGetLastError();
}
"""


def rate_source(shape: str) -> str:
    """The timing kernel of ``shape`` (a key of MMA_SHAPES)."""
    ptx = MMA_SHAPES[shape][0]
    if not shape.startswith("wgmma"):
        return MMA_RATE_SRC.replace("MMA", ptx)
    if "registers" in shape:
        regs = "{" + ", ".join(f"%{i}" for i in range(64)) + "}"
        outs = ", ".join(f'"+f"(d[{i}])' for i in range(64))
        return (WGMMA_RS_RATE_SRC.replace("MMA", ptx).replace("{REGS}", regs)
                .replace("OUTS", outs))
    regs = "{" + ", ".join(f"%{i}" for i in range(128)) + "}"
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(128))
    src = WGMMA_RATE_SRC.replace("MMA", ptx).replace("{REGS}", regs).replace("OUTS", outs)
    if ".tf32" in ptx:  # TF32 takes no transpose flags
        src = src.replace("p, 1, 1, 0, 0;", "p, 1, 1;")
    return src


def mma_rate_tflops(nvcc: str, shape: str) -> float:
    """TFLOP/s of the instruction ``shape`` (a key of MMA_SHAPES) alone on
    this card."""
    flop = MMA_SHAPES[shape][1]
    tag = re.sub(r"\W+", "_", shape)
    src, lib = OUT / f"mma_rate_{tag}.cu", OUT / f"mma_rate_{tag}.so"
    src.write_text(rate_source(shape))
    subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wgmma = shape.startswith("wgmma")
    # instructions a launch: mma.sync 8 warps x 8 a CTA, two CTAs an SM;
    # wgmma 3 warpgroups x 8 a CTA, one CTA an SM
    blocks, threads, per_block = (sms, 384, 3 * 8) if wgmma else (2 * sms, 256, 8 * 8)
    iters = 4096
    out = torch.empty(blocks * threads, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ms = time_ms(lambda: cuda_build.check(fn(_ptr(out), blocks, iters, stream), "mma_rate"))
    return blocks * per_block * iters * flop / (ms * 1e-3) / 1e12


def variant_source(subs, src: Path = SRC) -> str:
    text = src.read_text()
    for old, new in subs:
        n = text.count(old)
        if n == 0:
            raise SystemExit(f"ablate_k2: substitution not found in {src.name}:\n{old}")
        text = text.replace(old, new)
    return text


# (source, variants, C entry point, x's dtype) of each form
FORMS = {"float32": (SRC, VARIANTS, "bottleneck_block", torch.float32),
         "bf16": (SRC_BF16, VARIANTS_BF16, "bottleneck_block_bf16", torch.bfloat16)}


def parent_form(parent: Path) -> str:
    """The form of an earlier checkout's K2 source: its C entry point."""
    return "bf16" if "bottleneck_block_bf16(" in parent.read_text() else "float32"


def parent_takes_tile(parent: Path) -> bool:
    """Whether an earlier checkout's K2 launcher takes the raw weights and
    the output tile (``int TH, int TW``) rather than its form's pack."""
    text = parent.read_text()
    entry = text[text.index('extern "C" int bottleneck_block'):]
    return "int TH, int TW" in entry[:entry.index("{")]


def build_all(parent: Optional[Path] = None):
    """One nvcc per variant of each form, all started together, and for
    ``parent`` (either form's source from an earlier checkout) the variant
    (its form, "parent"); returns {(form, name): (lib, ptxas line)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    sources = {(form, name): variant_source(subs, base)
               for form, (base, variants, _, _) in FORMS.items()
               for name, subs in variants.items()}
    if parent is not None:
        sources[parent_form(parent), "parent"] = parent.read_text()
    for (form, name), text in sources.items():
        src = OUT / f"{form}_{name}.cu"
        src.write_text(text)
        lib = OUT / f"{form}_{name}.so"
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[form, name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ablate_k2: nvcc failed for {key}:\n{log}")
        regs = re.findall(r"(Used \d+ registers.*|\d+ bytes spill stores.*)", log)
        built[key] = (lib, "; ".join(regs))
    return built


def run_stage(fn, x, blocks, outs, stream, packed=None):
    """The stage through launcher ``fn``: this checkout's kernel on
    ``packed`` weights, else an earlier checkout's, which takes the
    weights as they are and the output tile."""
    h = x
    for i, (blk, out) in enumerate(zip(blocks, outs)):
        n, hh, ww, cin = h.shape
        if packed is None:
            ws, tile = [blk[k] for k in _KEYS] + [blk.get("pw"), blk.get("pb")], (8, 16)
        else:
            w = packed[i]
            ws = [w["aw"], blk["ab"], w["bw"], blk["bb"], w["cw"], w["cb"], w.get("pw")]
            tile = ()
        err = fn(_ptr(h), n, hh, ww, cin, *(_ptr(t) for t in ws), blk["aw"].shape[1],
                 blk["cw"].shape[1], 1, *tile, _ptr(out), stream)
        cuda_build.check(err, "bottleneck_block")
        h = out
    return h


def sass_histogram(lib: Path, top: int = 24) -> str:
    nvcc = Path(cuda_build.find_nvcc())
    sass = subprocess.run([str(nvcc.parent / "cuobjdump"), "--dump-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    ops = collections.Counter(
        m.group(1).split(".")[0]
        for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", sass))
    return ", ".join(f"{op} {n}" for op, n in ops.most_common(top))


def stage_inputs(dev):
    """Seeded float32 weights and frames at the main path's shape."""
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    n, hw, cin, inner, cout = 32, 64, 80, 64, 256
    blocks = []
    for i in range(3):
        c_in = cin if i == 0 else cout
        blk = {"aw": rnd(c_in, inner, scale=c_in ** -0.5), "ab": rnd(inner, scale=0.1),
               "bw": rnd(3, 3, inner, inner, scale=(9 * inner) ** -0.5),
               "bb": rnd(inner, scale=0.1), "cw": rnd(inner, cout, scale=inner ** -0.5),
               "cb": rnd(cout, scale=0.1)}
        if i == 0:
            blk.update(pw=rnd(c_in, cout, scale=c_in ** -0.5), pb=rnd(cout, scale=0.1))
        blocks.append(blk)
    return rnd(n, hw, hw, cin), blocks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a K2 source (either form) of an earlier checkout, timed "
                             "beside this checkout's kernel of its form in turns: parent, "
                             "this, this, parent")
    parser.add_argument("--timeline", action="store_true",
                        help="only each form's time by phase of a tile")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_k2: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card())
    dev = torch.device("cuda")
    x, blocks = stage_inputs(dev)
    n, hw, _, cout = x.shape[0], x.shape[1], x.shape[3], blocks[0]["cw"].shape[1]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if args.timeline:
        for form, (_, _, _, dtype) in FORMS.items():
            bf = [{k: v.to(dtype) if v.dim() > 1 else v for k, v in blk.items()}
                  for blk in blocks]
            pack = pack_block_bf16 if form == "bf16" else pack_block_f32
            outs = [torch.empty((n, hw, hw, cout), device=dev, dtype=dtype) for _ in bf]
            timeline(form, x.to(dtype), bf, [pack(blk) for blk in bf], outs, stream)
        return 0
    built = build_all(args.parent)
    for form, (_, _, entry, dtype) in FORMS.items():
        xf = x.to(dtype)
        bf = [{k: v.to(dtype) if v.dim() > 1 else v for k, v in blk.items()}
              for blk in blocks]
        pack = pack_block_bf16 if form == "bf16" else pack_block_f32
        packed = [pack(blk) for blk in bf]
        outs = [torch.empty((n, hw, hw, cout), device=dev, dtype=dtype) for _ in blocks]
        ref = fused_stage_ref(xf, bf, 1).float()
        full_ms = None
        calls = {}
        for (f, name), (lib, regs) in built.items():
            if f != form:
                continue
            own = None if name == "parent" and parent_takes_tile(args.parent) else packed
            fn = bind(ctypes.CDLL(str(lib)), entry, tile=own is None)
            call = functools.partial(run_stage, fn, xf, bf, outs, stream, own)
            calls[name] = call
            y = call()
            torch.cuda.synchronize()
            err = float((y.float() - ref).abs().max() / ref.abs().max())
            ms = time_ms(call)
            full_ms = ms if name == "full" else full_ms
            print(f"{form:7s} {name:15s} {ms:.4f} ms ({ms - full_ms:+.4f} vs full); "
                  f"err {err:.2e} of max; {regs}")
        print(f"{form} full kernel SASS, most frequent:",
              sass_histogram(built[form, "full"][0]))
        if "parent" in calls:
            turns = [("parent", time_ms(calls["parent"])), ("this", time_ms(calls["full"])),
                     ("this", time_ms(calls["full"])), ("parent", time_ms(calls["parent"]))]
            print(f"{form} in turns, parent / this kernel (ms): "
                  + ", ".join(f"{who} {ms:.4f}" for who, ms in turns))
    for shape in MMA_SHAPES:
        print(f"{shape} alone: "
              f"{mma_rate_tflops(cuda_build.find_nvcc(), shape):.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

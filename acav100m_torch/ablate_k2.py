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

K2's bf16 form (``csrc/bottleneck_stage_bf16.cu``) is timed beside it in
the same way, on bf16 inputs of the same shape, with its own variants; and
the card's own rate of each form's ``mma.sync`` instruction is measured.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from .ops import cuda_build
from .ops.bottleneck_kernel import _KEYS, _ptr, bind, fused_stage_ref
from .profiling import card, time_ms

SRC = cuda_build.CSRC / "bottleneck_stage.cu"
SRC_BF16 = cuda_build.CSRC / "bottleneck_stage_bf16.cu"
OUT = cuda_build.BUILD_DIR / "ablate_k2"

# name -> [(text in the source, replacement)]
VARIANTS = {
    "full": [],
    # 1xTF32: only the big.big product of each fragment pair
    "one_mma": [("""#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j0 + jj], as[i], bb[jj]);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_tf32(acc[i][j0 + jj], ab[i], bs[jj]);
""", "")],
    # no split: the raw fp32 bits go in as big and small
    "no_split": [(
        "  big = tf32_rna(v);\n"
        "  small = tf32_rna(v - __uint_as_float(big));\n",
        "  big = small = __float_as_uint(v);\n")],
    # no tensor-core work: operands are loaded and split, then dropped
    "no_mma": [(
        '      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n',
        '      ""\n')],
    # one product's fragment loads, splits and MMAs gone; staging stays
    "skip_a": [("mma_chunk<3, 4, KA>(", "if (false) mma_chunk<3, 4, KA>(")],
    "skip_b": [("mma_chunk<2, 4, KC>(part", "if (false) mma_chunk<2, 4, KC>(part")],
    "skip_c": [("mma_chunk<2, 4, KC>(acc", "if (false) mma_chunk<2, 4, KC>(acc")],
    # staging, barriers and epilogues alone
    "no_products": [("mma_chunk<3, 4, KA>(", "if (false) mma_chunk<3, 4, KA>("),
                    ("mma_chunk<2, 4, KC>(", "if (false) mma_chunk<2, 4, KC>(")],
    # the MMAs alone: fragments are constants, so loads and splits drop out
    "only_mma": [
        ("const float2 lo = *reinterpret_cast<const float2*>(smem + ao[i][0] + 2 * t);",
         "const float2 lo = make_float2(1.f, 2.f);"),
        ("const float2 hi = *reinterpret_cast<const float2*>(smem + ao[i][1] + 2 * t);",
         "const float2 hi = make_float2(3.f, 4.f);"),
        ("split(smem[wo + 2 * t * ldw + 8 * (j0 + jj) + g], bb[jj][0], bs[jj][0]);",
         "split(5.f, bb[jj][0], bs[jj][0]);"),
        ("split(smem[wo + (2 * t + 1) * ldw + 8 * (j0 + jj) + g], bb[jj][1], bs[jj][1]);",
         "split(6.f, bb[jj][1], bs[jj][1]);"),
    ],
    # product c's epilogue reads no bias and no shortcut ...
    "c_epi_no_reads": [
        ("const float2 bias = __ldg(reinterpret_cast<const float2*>(cb + n));\n"
         "              const float2 sc = __ldg(reinterpret_cast<const float2*>(\n"
         "                  pw != nullptr ? pb + n : xq + n));",
         "const float2 bias = make_float2(0.f, 0.f), sc = bias;")],
    # ... or writes nothing
    "c_epi_no_stores": [("*reinterpret_cast<float2*>(dst + n) = v;",
                         "if (v.x == -1.f) *reinterpret_cast<float2*>(dst + n) = v;")],
    # staging keeps its shared-memory stores and barriers, reads nothing
    "no_global": [("    const bool ok = k0 + kk < K;\n", "    const bool ok = false;\n"),
                  ("const bool ok = xoff[r] >= 0 && k0 + c < Cin;", "const bool ok = false;")],
}


# the bf16 form's variants, on the same plan
VARIANTS_BF16 = {
    "full": [],
    # no tensor-core work: fragments are loaded by ldmatrix, then dropped
    "no_mma": [(
        '      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n',
        '      ""\n')],
    # product b's (the 3x3's) fragment loads and MMAs gone; staging stays
    "skip_b": [("mma_chunk<2, 4, KC>(acc, ak", "if (false) mma_chunk<2, 4, KC>(acc, ak")],
    # staging, barriers and epilogues alone
    "no_products": [("mma_chunk<3, 4, KA>(", "if (false) mma_chunk<3, 4, KA>("),
                    ("mma_chunk<2, 4, KC>(", "if (false) mma_chunk<2, 4, KC>(")],
}


# The card's own rate for the instruction each form issues: mma.sync
# m16n8k8 TF32 and m16n8k16 bf16 from registers, 8 independent accumulators
# a warp, two CTAs of 8 warps an SM, as K2 runs. (name, PTX, FLOP an MMA)
MMA_SHAPES = {
    "m16n8k8 TF32": ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32", 2 * 16 * 8 * 8),
    "m16n8k16 bf16": ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32", 2 * 16 * 8 * 16),
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


def mma_rate_tflops(nvcc: str, shape: str) -> float:
    """TFLOP/s of the mma.sync ``shape`` (a key of MMA_SHAPES) alone on this card."""
    ptx, flop = MMA_SHAPES[shape]
    tag = shape.replace(" ", "_")
    src, lib = OUT / f"mma_rate_{tag}.cu", OUT / f"mma_rate_{tag}.so"
    src.write_text(MMA_RATE_SRC.replace("MMA", ptx))
    subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True)
    fn = ctypes.CDLL(str(lib)).launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    blocks, iters = 2 * torch.cuda.get_device_properties(0).multi_processor_count, 4096
    out = torch.empty(blocks * 256, device="cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ms = time_ms(lambda: cuda_build.check(fn(_ptr(out), blocks, iters, stream), "mma_rate"))
    return blocks * 8 * iters * 8 * flop / (ms * 1e-3) / 1e12


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


def build_all():
    """One nvcc per variant of each form, all started together; returns
    {(form, name): (lib, ptxas line)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for form, (base, variants, _, _) in FORMS.items():
        for name, subs in variants.items():
            src = OUT / f"{form}_{name}.cu"
            src.write_text(variant_source(subs, base))
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


def run_stage(fn, x, blocks, outs, stream):
    h = x
    for blk, out in zip(blocks, outs):
        n, hh, ww, cin = h.shape
        err = fn(_ptr(h), n, hh, ww, cin, *(_ptr(blk[k]) for k in _KEYS),
                 _ptr(blk.get("pw")), _ptr(blk.get("pb")), blk["aw"].shape[1],
                 blk["cw"].shape[1], 1, 8, 16, _ptr(out), stream)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("ablate_k2: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card())
    built = build_all()
    gen = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")

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
    x = rnd(n, hw, hw, cin)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for form, (_, _, entry, dtype) in FORMS.items():
        xf = x.to(dtype)
        bf = [{k: v.to(dtype) if v.dim() > 1 else v for k, v in blk.items()}
              for blk in blocks]
        outs = [torch.empty((n, hw, hw, cout), device=dev, dtype=dtype) for _ in blocks]
        ref = fused_stage_ref(xf, bf, 1).float()
        full_ms = None
        for (f, name), (lib, regs) in built.items():
            if f != form:
                continue
            fn = bind(ctypes.CDLL(str(lib)), entry)
            y = run_stage(fn, xf, bf, outs, stream)
            torch.cuda.synchronize()
            err = float((y.float() - ref).abs().max() / ref.abs().max())
            ms = time_ms(lambda: run_stage(fn, xf, bf, outs, stream))
            full_ms = ms if name == "full" else full_ms
            print(f"{form:7s} {name:15s} {ms:.4f} ms ({ms - full_ms:+.4f} vs full); "
                  f"err {err:.2e} of max; {regs}")
        print(f"{form} full kernel SASS, most frequent:",
              sass_histogram(built[form, "full"][0]))
    for shape in MMA_SHAPES:
        print(f"mma.sync {shape} alone: "
              f"{mma_rate_tflops(cuda_build.find_nvcc(), shape):.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())

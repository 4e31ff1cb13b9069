"""Where kernel K1's time goes, by ablation, on one GPU.

    python -m acav100m_torch.ablate_k1
    python -m acav100m_torch.ablate_k1 --parent DIR   # beside another checkout's K1

Without a hardware profiler, this builds variants of
``csrc/kmeans_assign_update.cu``, each with one part of the work taken out
by a text substitution, and times each at the main path's shape (M=10
clusterings of K=32 centers, B=1024 rows, D=2304 columns, the ten feature
taps' real widths zero-padded to D) as the median of 20 back-to-back calls
between CUDA events, each call replayed from a CUDA graph so that the
host's launch work stays out: warm (the same inputs every call) and cold
(the calls rotate over four input sets, more than the L2 holds); and cold
without the graph ("eager", what a caller's loop sees). A variant computes
wrong numbers; only its time is read, beside the full kernel's. Each
substitution must match the source, so an edit to the kernel that moves
what a variant removes makes this script fail instead of timing the wrong
thing. It also prints ``ptxas``'s registers and spills for each variant and
the full kernel's most frequent SASS instructions.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import importlib.util
import inspect
import re
import subprocess
import sys
from pathlib import Path

import torch

from .ablate_k2 import sass_histogram
from .ops import cuda_build
from .ops import kmeans_kernel as kk
from .profiling import card, time_cold_ms

SRC = cuda_build.CSRC / "kmeans_assign_update.cu"
OUT = cuda_build.BUILD_DIR / "ablate_k1"
# the clusterings of the main path in their sorted order: SlowFast's five
# taps, then VGGish's
TAP_DIMS = (88, 352, 704, 1408, 2304, 64, 128, 256, 512, 128)
COLD_SETS = 4
TRACE_ITEMS = 4096

_NO_ACCUMULATE = ("      accumulate_block(a, w, m, item - plan.c0[g], nb, dm);",
                  "      (void)0;")
_MMA_LOOPS = ["      for (int j = 0; j < NT8; ++j) mma_tf32(part[j], as, bb[j]);",
              "      for (int j = 0; j < NT8; ++j) mma_tf32(part[j], ab, bs[j]);",
              "      for (int j = 0; j < NT8; ++j) mma_tf32(part[j], ab, bb[j]);"]
# the product's splits and MMAs; the fragment loads stay for the norms
_NO_PRODUCT = [("        split(b0, bb[j][0], bs[j][0]); split(b1, bb[j][1], bs[j][1]);", ""),
               *((loop, "") for loop in _MMA_LOOPS)]
_NO_NORMS = [("      xq0 = fmaf(a0, a0, xq0); xq0 = fmaf(a2, a2, xq0);", ""),
             ("      xq1 = fmaf(a1, a1, xq1); xq1 = fmaf(a3, a3, xq1);", ""),
             ("        cq[j] = fmaf(b0, b0, cq[j]); cq[j] = fmaf(b1, b1, cq[j]);", "")]


def _define(name: str, old: int, new: int):
    return (f"#define {name} {old} ", f"#define {name} {new} ")


# name -> [(text in the source, replacement)]
VARIANTS = {
    "full": [],
    # assign items only (the last tile of each clustering still sorts its rows)
    "assign_only": [_NO_ACCUMULATE],
    # accumulate blocks behind assign items that stage nothing and make up
    # a balanced assignment
    "accumulate_only": [
        ("  const int nchunks = (dhi - dlo + DC - 1) / DC;", "  const int nchunks = 0;"),
        ("    bst[r] = bk;", "    bst[r] = bk = (row0 + r) % K;")],
    # assign without the distance product: loads, staging, norms, epilogues
    "assign_no_product": [_NO_ACCUMULATE, *_NO_PRODUCT],
    # assign with its loads, staging, barriers and epilogues only
    "assign_loads_only": [_NO_ACCUMULATE, *_NO_PRODUCT, *_NO_NORMS],
    # assign with fragments loaded and split but no tensor-core work
    "assign_no_mma": [_NO_ACCUMULATE, (
        '      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
        '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"\n',
        '      ""\n')],
    # no kernel at all: the host's own work per call, and the counters' memset
    "no_launch": [("  k1_kernel<<<grid, NT, smem, s>>>(a, w, plan);",
                   "  if (false) k1_kernel<<<grid, NT, smem, s>>>(a, w, plan);")],
    # 1xTF32: only the big.big product (wrong in the last digits)
    "one_mma": [(loop, "") for loop in _MMA_LOOPS[:2]],
    # the full kernel with each work item's start, middle and end recorded:
    # the middle is where an assign item's product ends, or where an
    # accumulate item's wait and set-up end
    "timeline": [
        ("extern __shared__ float smem[];\n",
         "extern __shared__ float smem[];\n"
         "__device__ unsigned long long k1_trace[TRACE_ITEMS][3], k1_mid[4096];\n"
         "extern \"C\" int k1_trace_read(void* dst) {\n"
         "  return (int)cudaMemcpyFromSymbol(dst, k1_trace, sizeof(k1_trace));\n"
         "}\n"
         "__device__ __forceinline__ unsigned long long k1_now() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n"
         "}\n"),
        ("    // the quad's four shares of each norm, in a fixed order\n",
         "    if (tid == 0) k1_mid[blockIdx.x] = k1_now();\n"
         "    // the quad's four shares of each norm, in a fixed order\n"),
        ("  const int lo = segs[klo], hi = segs[khi];\n",
         "  if (tid == 0) k1_mid[blockIdx.x] = k1_now();\n"
         "  const int lo = segs[klo], hi = segs[khi];\n"),
        ("    run_item(a, w, plan, item);\n",
         "    const unsigned long long t0 = k1_now();\n"
         "    if (threadIdx.x == 0) k1_mid[blockIdx.x] = 0;\n"
         "    run_item(a, w, plan, item);\n"
         "    if (threadIdx.x == 0 && item < TRACE_ITEMS) {\n"
         "      k1_trace[item][0] = t0;\n"
         "      k1_trace[item][1] = k1_now();\n"
         "      k1_trace[item][2] = k1_mid[blockIdx.x];\n"
         "    }\n"),
        ("#define NT 256 ", f"#define TRACE_ITEMS {TRACE_ITEMS}\n#define NT 256 ")],
    # the interleaved queue A(0), A(1) C(0), A(2) C(1), ...: each clustering's
    # accumulate blocks right after the next one's assign items
    "interleaved": [("""  int pos = 0;
  for (int g = 0; g < M; ++g) {
    plan.a0[g] = pos;
    pos += T * ((plan.dm[plan.grp[g]] + SW - 1) / SW);
  }
  for (int g = M - 1; g >= 0; --g) {
    plan.c0[g] = pos;
    pos += (plan.dm[plan.grp[g]] + NCOL - 1) / NCOL;
  }
  plan.total = pos;
""", """  int pos = T * ((plan.dm[plan.grp[0]] + SW - 1) / SW);
  plan.a0[0] = 0;
  for (int g = 1; g < M; ++g) {
    plan.a0[g] = pos;
    pos += T * ((plan.dm[plan.grp[g]] + SW - 1) / SW);
    plan.c0[g - 1] = pos;
    pos += (plan.dm[plan.grp[g - 1]] + NCOL - 1) / NCOL;
  }
  plan.c0[M - 1] = pos;
  plan.total = pos + (plan.dm[plan.grp[M - 1]] + NCOL - 1) / NCOL;
""")],
    # candidates: wider chunks (longer runs of each row a request), narrower
    # or wider splits, a shallower ring, one CTA an SM
    "dc64": [_define("DC", 32, 64), _define("STAGES", 4, 3)],
    # the accumulate's loads of the rows replaced by a constant
    "acc_no_loads": [
        ("      v[u] = __ldg(reinterpret_cast<const float2*>(xm + (size_t)r * D));",
         "      v[u] = make_float2((float)r, 0.f);"),
        ("      v[u] = load2(xm + (size_t)r * D, nreal);",
         "      v[u] = make_float2((float)r, 0.f);")],
    # sorted rows staged per accumulate chunk
    "rs128": [_define("RS", 256, 128)],
    "sw256": [_define("SW", 512, 256)],
    "stages3": [_define("STAGES", 4, 3)],
    "stages6": [_define("STAGES", 4, 6)],
    "grid1": [_define("CTAS_PER_SM", 2, 1), _define("MINB", 2, 1)],
}


def variant_source(subs) -> str:
    text = SRC.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"ablate_k1: substitution not found in {SRC.name}:\n{old}")
        text = text.replace(old, new)
    return text


def build_all():
    """One nvcc per variant, all started together; returns {name: (lib, ptxas line)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.find_nvcc()
    procs = {}
    for name, subs in VARIANTS.items():
        src = OUT / f"{name}.cu"
        src.write_text(variant_source(subs))
        lib = OUT / f"{name}.so"
        cmd = [nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"ablate_k1: nvcc failed for {name}:\n{log}")
        regs = re.findall(r"(Used \d+ registers.*|\d+ bytes spill stores.*)", log)
        built[name] = (lib, "; ".join(regs))
    return built


def k1_inputs(gen: torch.Generator, k: int, b: int, dims=TAP_DIMS, seen: int = 20000,
              device="cuda"):
    """K1's arguments as the main path gives them after warmup: rows and
    centers zero past each clustering's width; centers near k of the rows;
    counts drawn below twice the threshold ``(seen / k)**0.7``, so about
    half the centers are underused. Returns (centers, counts, batch,
    threshold)."""
    m, d = len(dims), max(dims)
    mask = (torch.arange(d)[None, :] < torch.tensor(dims)[:, None]).float()[:, None, :]
    threshold = (seen / k) ** 0.7
    batch = torch.randn((m, b, d), generator=gen) * mask
    pick = torch.randperm(b, generator=gen)[:k]
    centers = (batch[:, pick] + 0.1 * torch.randn((m, k, d), generator=gen)) * mask
    counts = torch.randint(0, int(2 * threshold), (m, k), generator=gen).float()
    return (centers.contiguous().to(device), counts.to(device), batch.to(device), threshold)


def queue_plan(dims, b: int):
    """The kernel's queue in Python, from the constants of its source:
    [(first item, items, kind, clustering)] with kind "A" (assign) or "C"."""
    const = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", SRC.read_text())}
    tiles = -(-b // const["TB"])
    grp = sorted(range(len(dims)), key=lambda m: -dims[m])  # stable: widest first
    plan, pos = [], 0
    for m in grp:
        plan.append((pos, tiles * -(-dims[m] // const["SW"]), "A", m))
        pos += plan[-1][1]
    for m in reversed(grp):
        plan.append((pos, -(-dims[m] // const["NCOL"]), "C", m))
        pos += plan[-1][1]
    return plan


def timeline(lib, call, args) -> str:
    """One call of the timeline variant: for each run of work items in
    queue order, when its first item started and its last ended (us from
    the launch's first item), and the items' mean time to their middle
    stamp and from it to their end."""
    call(*args)
    torch.cuda.synchronize()
    raw = (ctypes.c_uint64 * (3 * TRACE_ITEMS))()
    cuda_build.check(lib.k1_trace_read(raw), "k1_trace_read")
    trace = torch.tensor(list(raw), dtype=torch.float64).view(TRACE_ITEMS, 3)
    _, _, batch, _, dims = args
    plan = queue_plan(dims, batch.shape[1])
    n = plan[-1][0] + plan[-1][1]
    t0 = trace[:n, 0].min()
    lines = [f"timeline of one call with dims ({n} items, last end "
             f"{float(trace[:n, 1].max() - t0) / 1e3:.1f} us):"]
    for first, count, kind, m in plan:
        span = trace[first:first + count]
        start, end, mid = span[:, 0], span[:, 1], span[:, 2]
        lines.append(
            f"  {kind}({m}, width {dims[m]}) x{count}: {float(start.min() - t0) / 1e3:6.1f} .. "
            f"{float(end.max() - t0) / 1e3:6.1f} us; mean {float((mid - start).mean()) / 1e3:5.1f}"
            f" us to the middle, {float((end - mid).mean()) / 1e3:5.1f} us after it")
    return "\n".join(lines)


def load_wrapper(root: Path):
    """``acav100m_torch.ops.kmeans_kernel`` of the checkout at ``root`` (the
    parent commit's, say), imported under another package name so that it
    lives beside this one; it builds its kernel into ``root/build``."""
    pkg = Path(root).resolve() / "acav100m_torch"
    spec = importlib.util.spec_from_file_location(
        "k1_other", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["k1_other"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("k1_other.ops.kmeans_kernel")


def compare(root: Path) -> int:
    """K1 of this checkout against the one at ``root``, in turns (other,
    this, this, other), each timed cold as graph replays: the other with
    the arguments its signature takes (with ``dims`` if it has them), this
    one with and without them."""
    other = load_wrapper(root)
    takes_dims = "dims" in inspect.signature(other.fused_assign_update).parameters
    gen = torch.Generator().manual_seed(0)
    sets = [k1_inputs(gen, 32, 1024) for _ in range(COLD_SETS)]
    dims_sets = [args + (TAP_DIMS,) for args in sets]
    for _ in range(200):
        kk.fused_assign_update_ref(*sets[0])
    out_other = other.fused_assign_update(*sets[0])
    out_this = kk.fused_assign_update(*dims_sets[0])
    torch.cuda.synchronize()
    print(f"other checkout {root}: best equal on {int((out_other[0] == out_this[0]).sum())} of "
          f"{out_this[0].numel()} rows; deltas max difference "
          f"{float((out_other[2] - out_this[2]).abs().max()):.2e}")
    for turn in ("other", "this", "this", "other"):
        if turn == "other":
            ms = time_cold_ms(other.fused_assign_update, dims_sets if takes_dims else sets,
                              graph=True)
            print(f"  other: {ms:.4f} ms cold{' with dims' if takes_dims else ''}")
        else:
            with_dims = time_cold_ms(kk.fused_assign_update, dims_sets, graph=True)
            padded = time_cold_ms(kk.fused_assign_update, sets, graph=True)
            print(f"  this:  {with_dims:.4f} ms cold with dims, {padded:.4f} ms padded")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="time K1 beside the one of the checkout at this path instead")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ablate_k1: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card())
    if args.parent is not None:
        return compare(args.parent)
    built = build_all()
    gen = torch.Generator().manual_seed(0)
    sets = [k1_inputs(gen, 32, 1024) for _ in range(COLD_SETS)]
    centers, counts, batch, threshold = sets[0]
    best_p, c_p, d_p, mean_p = kk.fused_assign_update_ref(centers, counts, batch, threshold)
    full = None
    dims_sets = [args + (TAP_DIMS,) for args in sets]
    # clocks up before the first timing: a few hundred ms of the plain version
    for _ in range(200):
        kk.fused_assign_update_ref(*sets[0])
    for name, (lib, regs) in built.items():
        fns = kk.bind(ctypes.CDLL(str(lib)))

        def call(*args, fns=fns):
            return kk.launch(fns, *args)

        best, c_add, deltas, mean = out = call(*sets[0])
        same = all(torch.equal(u, v) for u, v in zip(out, call(*dims_sets[0])))
        torch.cuda.synchronize()
        err = float((deltas - d_p).abs().max() / d_p.abs().max())
        warm = time_cold_ms(call, sets[:1], graph=True)
        cold = time_cold_ms(call, sets, graph=True)
        cold_dims = time_cold_ms(call, dims_sets, graph=True)
        eager = time_cold_ms(call, dims_sets)
        full = (warm, cold, cold_dims) if name == "full" else full
        print(f"{name:18s} padded: warm {warm:.4f} ms ({warm - full[0]:+.4f}), cold "
              f"{cold:.4f} ms ({cold - full[1]:+.4f}); with dims: cold {cold_dims:.4f} ms "
              f"({cold_dims - full[2]:+.4f}), eager {eager:.4f} ms; best differs on "
              f"{int((best != best_p).sum())} rows, deltas err {err:.2e} of max, dims "
              f"{'bitwise equal' if same else 'DIFFER'}; {regs}")
        if name == "timeline":
            print(timeline(ctypes.CDLL(str(lib)), call, dims_sets[0]))
    fns = kk.bind(ctypes.CDLL(str(built["full"][0])))
    again = time_cold_ms(lambda *args: kk.launch(fns, *args), dims_sets, graph=True)
    print(f"full again, at the end: cold with dims {again:.4f} ms")
    # what a plain stream of the padded batch reaches on this card
    summed = time_cold_ms(lambda c, n, x, t: x.sum(), sets, graph=True)
    print(f"torch sum of the padded batch ({batch.numel() * 4 / 1e6:.1f} MB), cold: "
          f"{summed:.4f} ms, {batch.numel() * 4 / summed / 1e9:.2f} TB/s")
    print("full kernel SASS, most frequent:", sass_histogram(built["full"][0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())

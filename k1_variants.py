#!/usr/bin/env python3
"""K1's design choices, measured on the card: csrc/stse_fused.cu as built and
edits of it that undo one choice each, built side by side and timed at the
flagship width.

    python3 k1_variants.py

Each variant is a list of (old, new) text edits of the source, each of which
must match exactly once; nvcc builds every variant at once into
build/coskad_tpu_torch/variants/. For each, in two rounds of turns: the
error against the plain version at B = 2048 (rtol 2e-4, atol 2e-5; a
variant that fails is reported, not raised), the kernel's ms at B = 2048
(CUDA events, mean of 20 launches) and each flagship layer alone as a
one-layer stack. The `clock` variant also records clock64 at the phase
boundaries of one block (block 200; warps 0 and 7) and prints the cycles
of each phase: input load, then per layer the walk over M, the barrier
after it, and the mixes (for a narrowing layer the walk includes U = X W
and R = X W_res). Details go to k1_variants.json in chip_smoke.py's
output directory (OUT_DIR). Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

import chip_smoke as cs

_CLOCK = ("#define K1_CLOCK(i) if (blockIdx.x == 200 && (threadIdx.x == 0 || threadIdx.x == 224)) "
          "k1_clock[threadIdx.x ? 1 : 0][i] = clock64();\n")
VARIANTS = {
    "as_built": [],
    # one window a block: M read from L2 once per window, not once per two
    "one_window_a_block": [
        ("  for (wb = 2; wb >= 1; --wb) {", "  for (wb = 1; wb >= 1; --wb) {")],
    # two node tiles a warp at 8 warps a block, not one at 16
    "two_tiles_eight_warps": [
        ("constexpr int kThreads = 512; ", "constexpr int kThreads = 256; "),
        ("constexpr int kPair = 1; ", "constexpr int kPair = 2; ")],
    # a ring of 3 slices of M a warp, not 2
    "three_slice_ring": [("constexpr int kStages = 2; ", "constexpr int kStages = 3; ")],
    # the TF32 pairs by cvt.rna.tf32 (split_tf32, as K2-K5 split), not truncation
    "split_tf32": [
        ("""  big = __float_as_uint(v) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big)) & 0xffffe000u;
""", "  split_tf32(v, big, small);\n")],
    "clock": [
        ("namespace {\n\nconstexpr int kMaxLayers",
         "namespace {\n__device__ long long k1_clock[2][40];\n" + _CLOCK + "constexpr int kMaxLayers"),
        ("  const int nwin = batch - win0 < WB ? batch - win0 : WB;\n",
         "  const int nwin = batch - win0 < WB ? batch - win0 : WB;\n  K1_CLOCK(0)\n"),
        ("    __syncthreads();     // xin complete; the last layer's reads of W^T, b and xalt done\n",
         "    __syncthreads();     // xin complete; the last layer's reads of W^T, b and xalt done\n"
         "    K1_CLOCK(1 + 4 * l)\n"),
        ("  bool narrow, last, identity;\n};", "  bool narrow, last, identity;\n  int l;\n};"),
        ("    lp.identity = L.identity;\n", "    lp.identity = L.identity;\n    lp.l = l;\n"),
        ("    if (first) {\n      cp_async_wait<0>();\n      __syncthreads();\n    }\n",
         "    if (first) {\n      K1_CLOCK(2 + 4 * lp.l)\n      cp_async_wait<0>();\n"
         "      __syncthreads();\n      K1_CLOCK(3 + 4 * lp.l)\n    }\n"),
        ("    if (lp.narrow) continue;  // the output is in xin\n",
         "    if (lp.narrow) {\n      K1_CLOCK(4 + 4 * l)\n      continue;\n    }\n"),
        ("    float* tmp = xin;\n", "    K1_CLOCK(4 + 4 * l)\n    float* tmp = xin;\n"),
        ("int stse_fused_occupancy(",
         "int k1_clocks(long long* out) {\n"
         "  return (int)cudaMemcpyFromSymbol(out, k1_clock, sizeof(k1_clock));\n}\n\n"
         "int stse_fused_occupancy("),
    ],
}
# the phases between clock64 readings (a layer's walk includes its wait for
# W^T, and where it narrows U and R)
PHASES = ["input"]
for _l in range(4):
    PHASES += ([f"layer{_l}_barrier_in"] if _l else []) + [f"layer{_l}_walk",
                                                           f"layer{_l}_barrier_w", f"layer{_l}_mix"]


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"edit does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(build):
    """Start nvcc for every variant at once; returns name -> library path."""
    with open(os.path.join(build.CSRC, "stse_fused.cu")) as f:
        src = f.read()
    out = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        cu = os.path.join(out, f"stse_fused_{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(src, edits))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC, "-Xptxas", "-v", "-o",
             cu[:-3] + ".so", cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"build {name}: {' | '.join(regs)}")
        libs[name] = os.path.join(out, f"stse_fused_{name}.so")
    return libs


def main() -> int:
    card, _ = cs.phase_environment()
    import torch
    from coskad_tpu_torch.kernels import build, stse_fused

    libs = {name: stse_fused.bind(ctypes.CDLL(path)) for name, path in build_variants(build).items()}
    gen = torch.Generator().manual_seed(1234)
    model = cs.seeded_stse(gen, "cuda", **cs.FULL)
    folded, packed = model.folded()
    x = torch.randn(2048, 2, 12, 18, generator=gen).cuda()
    singles = []
    for lay in folded.layers:
        one = folded._replace(layers=[lay])
        singles.append(("{}->{}".format(*lay.w.shape), one, stse_fused.pack_folded(one),
                        torch.randn(2048, lay.w.shape[0], 12, 18, generator=gen).cuda()))
    with torch.no_grad():
        ref = stse_fused.fused_stse_hidden_reference(x, folded)
    results = {name: dict(ms=[], layers_ms=[]) for name in libs}
    as_built = stse_fused._library
    try:
        for _ in range(2):
            for name, lib in libs.items():
                stse_fused._library = lambda lib=lib: lib
                r = results[name]
                with torch.no_grad():
                    h = stse_fused.fused_stse_hidden(x, folded, packed)
                    torch.cuda.synchronize()
                    r["max_abs_err"] = float((h - ref).abs().max())
                    r["within_tolerance"] = cs.within(h, ref, **cs.TOL)
                    r["ms"].append(cs.cuda_ms(lambda: stse_fused.fused_stse_hidden(x, folded, packed)))
                    r["layers_ms"].append({label: cs.cuda_ms(
                        lambda: stse_fused.fused_stse_hidden(x1, one, op))
                        for label, one, op, x1 in singles})
                r["occupancy"] = stse_fused.occupancy(packed, lib)
                if name == "clock":
                    stse_fused.fused_stse_hidden(x, folded, packed)
                    torch.cuda.synchronize()
                    clk = np.zeros((2, 40), np.int64)
                    lib.k1_clocks.argtypes = [ctypes.c_void_p]
                    lib.k1_clocks(clk.ctypes.data)
                    r["cycles"] = {f"warp{w}": dict(zip(PHASES, np.diff(clk[i][:17]).tolist()))
                                   for i, w in ((0, 0), (1, 7))}
    finally:
        stse_fused._library = as_built
    for name, r in results.items():
        print(f"k1 variant {name}: " + json.dumps(dict(r, card=card)))
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "k1_variants.json"), "w") as f:
        json.dump(dict(card=card, variants=results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

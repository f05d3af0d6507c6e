#!/usr/bin/env python3
"""P's design choices, measured on the card: csrc/probe_bf16.cu as built and
edits of it that change one choice each (a grid, a split, the parent's
one-element-a-thread select), built side by side and timed.

    python3 probe_variants.py

Each variant is a list of (old, new) text edits of the source, each of which
must match exactly once, and the jobs it changes; nvcc builds every variant
at once into build/coskad_tpu_torch/probe_variants/. For each variant's jobs,
in two rounds of turns: the error against the plain version (exact, or
within chip_smoke.PROBE_SUM_TOL for the sums; a variant that fails is
reported, not raised) and the device time of a call (chip_smoke.device_ms:
the median over the traced calls, inputs warm in L2, and with L2 scrubbed
before each call). Details go to probe_variants.json in chip_smoke.py's
output directory (OUT_DIR). Needs the card; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import chip_smoke as cs

SELECTS = ("where_mixed", "where_f32pred")
_ELEM = "constexpr int kElemThreads = 256, kElemBlocks = 512;"
_ELEM_ASSERT = ('static_assert(kElemVec * 4 * kElemBlocks * kElemThreads == kCount, '
                '"whole float4s a thread");')
_SELECT_START, _SELECT_END = "// The selects: out = pred < 0", "// out[c][n][q] = bf(a[c][q][n])"
# The parent's select: a thread an element, 2,048 blocks.
_SELECT_SCALAR = """// The selects, a thread an element.
__global__ void __launch_bounds__(kElemThreads)
select_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
              bool f32_pred, bool alpha_from_a) {
  const int i = blockIdx.x * kElemThreads + threadIdx.x;
  const __nv_bfloat16 alpha = bf(alpha_from_a ? a[0] : 0.25f);
  const __nv_bfloat16 bv = bf(b[i]);
  const bool neg = f32_pred ? a[i] < 0.0f : __hlt(bf(a[i]), bf(0.0f));
  out[i] = f32(neg ? __hmul(alpha, bv) : bv);
}

"""


def _const(old: str, new: str):
    return (f"constexpr int {old};", f"constexpr int {new};")


VARIANTS = {
    "as_built": (None, []),
    "select_scalar": (SELECTS, [
        (_ELEM, "constexpr int kElemThreads = 256, kElemBlocks = kCount / 256;"),
        (_ELEM_ASSERT, ""), ("SELECT", _SELECT_SCALAR)]),
    "select_2_float4_256_blocks": (SELECTS, [
        (_ELEM, "constexpr int kElemThreads = 256, kElemBlocks = 256;")]),
    "select_4_float4_128_blocks": (SELECTS, [
        (_ELEM, "constexpr int kElemThreads = 256, kElemBlocks = 128;")]),
    "select_1_float4_1024x128": (SELECTS, [
        (_ELEM, "constexpr int kElemThreads = 128, kElemBlocks = 1024;")]),
    "select_no_restrict": (SELECTS, [(
        "select_kernel(const float* __restrict__ a, const float* __restrict__ b, "
        "float* __restrict__ out,", "select_kernel(const float* a, const float* b, float* out,")]),
    "min_4_splits": (("min_bf16",), [_const("kMinSplits = 8", "kMinSplits = 4")]),
    "min_16_splits": (("min_bf16",), [_const("kMinSplits = 8", "kMinSplits = 16")]),
    "dot0_8_rows": (("dot0_bf16",), [_const("kDotRows = 16", "kDotRows = 8")]),
    "dot0_32_rows": (("dot0_bf16",), [_const("kDotRows = 16", "kDotRows = 32")]),
    "dot0_sums_16_rows": (("dot0_bf16",), [_const("kDotSumRows = 8", "kDotSumRows = 16")]),
    "dot0_sums_32_rows": (("dot0_bf16",), [_const("kDotSumRows = 8", "kDotSumRows = 32")]),
    "merge_128_blocks": (("transpose_merge",), [
        _const("kMergeBlocks = 512", "kMergeBlocks = 128")]),
    "merge_256_blocks": (("transpose_merge",), [
        _const("kMergeBlocks = 512", "kMergeBlocks = 256")]),
    "merge_1024_blocks": (("transpose_merge",), [
        _const("kMergeBlocks = 512", "kMergeBlocks = 1024")]),
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if old == "SELECT":  # the whole select kernel
            old = src[src.index(_SELECT_START):src.index(_SELECT_END)]
        if src.count(old) != 1:
            raise ValueError(f"edit does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build_variants(build):
    """Start nvcc for every variant at once; returns name -> library path."""
    with open(os.path.join(build.CSRC, "probe_bf16.cu")) as f:
        src = f.read()
    out = os.path.join(build.BUILD_DIR, "probe_variants")
    os.makedirs(out, exist_ok=True)
    procs = {}
    for name, (_, edits) in VARIANTS.items():
        cu = os.path.join(out, f"probe_bf16_{name}.cu")
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
        libs[name] = os.path.join(out, f"probe_bf16_{name}.so")
    return libs


def main() -> int:
    card, _ = cs.phase_environment()
    import torch
    from coskad_tpu_torch.kernels import build, probe

    libs = {name: probe.bind(ctypes.CDLL(path)) for name, path in build_variants(build).items()}
    a, b = probe.inputs()
    scrub = torch.empty((cs.L2_SCRUB_BYTES // 4,), device=a.device)
    want = {job: probe.plain(job, a, b) for job in probe.JOBS}
    results = {name: {job: dict(ms=[], cold_ms=[]) for job in (jobs or probe.JOBS)}
               for name, (jobs, _) in VARIANTS.items()}
    as_built = probe._library
    try:
        for _ in range(2):
            for name, lib in libs.items():
                probe._library = lambda lib=lib: lib
                for job, r in results[name].items():
                    out = probe.run(job, a, b)
                    torch.cuda.synchronize()
                    sums = job.startswith(("dot0", "dotg", "min"))
                    r["max_abs_err"] = float((out - want[job]).abs().max())
                    r["right"] = (cs.within(out, want[job], **cs.PROBE_SUM_TOL) if sums
                                  else torch.equal(out, want[job]))
                    ms, kernels = cs.device_ms(lambda: probe.run(job, a, b))
                    r["ms"].append(ms)
                    r["kernels_ms"] = kernels
                    r["cold_ms"].append(cs.device_ms(lambda: probe.run(job, a, b),
                                                     scrub=scrub)[0])
    finally:
        probe._library = as_built
    for name, r in results.items():
        print(f"probe variant {name}: " + json.dumps(dict(r, card=card)))
    os.makedirs(cs.OUT_DIR, exist_ok=True)
    with open(os.path.join(cs.OUT_DIR, "probe_variants.json"), "w") as f:
        json.dump(dict(card=card, variants=results), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

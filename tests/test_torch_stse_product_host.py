"""The batch-reduction products of K3, K4 and K5 (dW, dW_res, dM, dwp) and
the warp-level pieces of the host emulation they need, on the host.

csrc/stse_train.cu is compiled with g++ against tests/cuda_host_emu.h (one
std::thread per CUDA thread, a barrier per block and one per warp, the
m16n8k8 TF32 mma and cvt.rna.tf32 emulated, cp.async as a copy) and its
per-product entry point (`stse_train.launch_product`) is held against
float64 einsum on every form and ragged edge. The emulator's own
`tf32_of`, `bf16_bits` and `mma_tf32` are held bit for bit against numpy. This checks the
kernels' indexing, staging, splits and fragment layout as the emulator
reproduces PTX's; the card is the real check (chip_smoke.py's product
check).

Tolerance of a product: |err| <= 1e-5 * (|A|^T |B|) + 1e-6 elementwise,
fp32 accumulation of 3xTF32 products (a split of each operand into two
TF32 parts leaves ~2^-22 of it); one TF32 product (2^-11) would not meet it.
Under a bf16 form the operands are rounded to bf16 and each product is
exact, so the product is held to float64 einsum of the rounded operands with
the same fp32-sum tolerance.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from coskad_tpu_torch.kernels import build, stse_train

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to run the CUDA source on the host")
    return gxx


def _compile(gxx: str, src: str, d, name: str) -> ctypes.CDLL:
    (d / f"{name}.cpp").write_text(src)
    lib = str(d / f"lib{name}.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I", HERE,
                    "-I", build.CSRC, "-o", lib, str(d / f"{name}.cpp")],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/stse_train.cu with its shared-memory declarations and launches
    rewritten for the host emulation."""
    gxx = _gxx()
    with open(os.path.join(build.CSRC, "stse_train.cu")) as f:
        cu = f.read()
    cu, n_smem = re.subn(r"extern __shared__[^;]*float (\w+)\[\];", r"float* \1 = g_smem;", cu)
    cu, n_launch = re.subn(r"(\w+)<<<([^,]+),\s*([^,]+),\s*([^,]+),[^>]*>>>\(",
                           r"emu_launch(\1, \2, \3, \4, ", cu)
    assert n_smem >= 6 and n_launch >= 11, "kernel source no longer matches the host rewrite"
    cu = cu.replace("#include <cuda_runtime.h>", '#include "cuda_host_emu.h"')
    so = _compile(gxx, cu, tmp_path_factory.mktemp("product_host"), "stse_train_host")
    for fn in stse_train.REPLACES:
        getattr(so, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(so, fn).restype = ctypes.c_int
    so.stse_train_error_string.argtypes = [ctypes.c_int]
    so.stse_train_error_string.restype = ctypes.c_char_p
    return so


EMU_PROBE = r"""
#include "cuda_host_emu.h"

// One warp: A [16][8], B [8][8] and C [16][8] (row-major) into fragments in
// the PTX layout of m16n8k8 .tf32, one mma, D [16][8] back.
void mma_kernel(const float* a, const float* b, const float* c, float* d) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  const uint32_t af[4] = {__float_as_uint(a[g * 8 + t]), __float_as_uint(a[(g + 8) * 8 + t]),
                          __float_as_uint(a[g * 8 + t + 4]),
                          __float_as_uint(a[(g + 8) * 8 + t + 4])};
  const uint32_t bf[2] = {__float_as_uint(b[t * 8 + g]), __float_as_uint(b[(t + 4) * 8 + g])};
  float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                  c[(g + 8) * 8 + 2 * t + 1]};
  mma_tf32(acc, af, bf);
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// One warp: A [16][K], B [K][8] (bf16 values as floats, row-major) into the
// bf16 fragments of m16n8k16 (K 16) or m16n8k8 (K 8), a register a pair
// along k, the lower k in the low half; C [16][8] in, D [16][8] out.
template <int K>
void mma_bf16_kernel(const float* a, const float* b, const float* c, float* d) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  auto pa = [&](int r, int k) { return pack_bf16x2(a[r * K + k], a[r * K + k + 1]); };
  auto pb = [&](int k, int col) { return pack_bf16x2(b[k * 8 + col], b[(k + 1) * 8 + col]); };
  float acc[4] = {c[g * 8 + 2 * t], c[g * 8 + 2 * t + 1], c[(g + 8) * 8 + 2 * t],
                  c[(g + 8) * 8 + 2 * t + 1]};
  if constexpr (K == 16) {
    const uint32_t af[4] = {pa(g, 2 * t), pa(g + 8, 2 * t), pa(g, 2 * t + 8), pa(g + 8, 2 * t + 8)};
    const uint32_t bf[2] = {pb(2 * t, g), pb(2 * t + 8, g)};
    mma_bf16_k16(acc, af, bf);
  } else {
    const uint32_t af[2] = {pa(g, 2 * t), pa(g + 8, 2 * t)};
    mma_bf16_k8(acc, af, pb(2 * t, g));
  }
  d[g * 8 + 2 * t] = acc[0];
  d[g * 8 + 2 * t + 1] = acc[1];
  d[(g + 8) * 8 + 2 * t] = acc[2];
  d[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

extern "C" void emu_mma_bf16(const float* a, const float* b, const float* c, float* d, int k) {
  if (k == 16)
    emu_launch(mma_bf16_kernel<16>, dim3(1), 32, 0, a, b, c, d);
  else
    emu_launch(mma_bf16_kernel<8>, dim3(1), 32, 0, a, b, c, d);
}

extern "C" void emu_pack(const float* lo, const float* hi, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = pack_bf16x2(lo[i], hi[i]);
}

extern "C" void emu_tf32(const float* in, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = tf32_of(in[i]);
}

extern "C" void emu_bf16(const float* in, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) out[i] = bf16_bits(in[i]);
}

extern "C" void emu_mma(const float* a, const float* b, const float* c, float* d) {
  emu_launch(mma_kernel, dim3(1), 32, 0, a, b, c, d);
}
"""


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    so = _compile(_gxx(), EMU_PROBE, tmp_path_factory.mktemp("emu_probe"), "emu_probe")
    so.emu_tf32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    so.emu_bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    so.emu_mma.argtypes = [ctypes.c_void_p] * 4
    so.emu_mma_bf16.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int]
    so.emu_pack.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return so


def tf32_reference(x: np.ndarray) -> np.ndarray:
    """cvt.rna.tf32.f32 by arithmetic, in float64: 11 significant bits for
    a normal number, a 2^-136 grid below 2^-126 (the 19 bits kept of a
    subnormal), the halfway case away from zero; to float32."""
    x = x.astype(np.float64)
    mag = np.abs(x)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        _, exp = np.frexp(np.where(mag > 0, mag, 1.0))  # mag = m 2^exp, m in [0.5, 1)
        ulp = np.where(mag < 2.0 ** -126, 2.0 ** -136, np.ldexp(1.0, exp - 11))
        q = np.floor(mag / ulp + 0.5) * ulp
        out = np.where(np.isfinite(x), np.copysign(q, x), x).astype(np.float32)
    return out


TF32_CASES = np.array([
    0.0, -0.0, 1.0, -1.0, 3.0,
    1 + 2.0 ** -11, -(1 + 2.0 ** -11),  # halfway: away from zero, both signs
    1 + 3 * 2.0 ** -11,  # halfway from an odd last bit: away, not to even
    1 + 2.0 ** -11 - 2.0 ** -23, 1 + 2.0 ** -11 + 2.0 ** -23,  # just below / above halfway
    1 + 2.0 ** -12, 2 - 2.0 ** -23,  # 2 - ulp rounds up into the next binade
    2.0 ** -149, 2.0 ** -137, -(2.0 ** -137), 3 * 2.0 ** -137, 5 * 2.0 ** -140,  # subnormals
    2.0 ** -126 - 2.0 ** -149,  # the largest subnormal rounds up to the smallest normal
    2.0 ** -126, 3.4028234663852886e38, -3.4028234663852886e38,  # the largest float: to inf
    np.inf, -np.inf,
], np.float32)


def test_emulated_tf32_rounding_matches_numpy(emu_lib):
    rng = np.random.default_rng(0)
    x = np.concatenate([TF32_CASES, rng.normal(size=200).astype(np.float32),
                        (rng.normal(size=50) * 2.0 ** -130).astype(np.float32)])
    out = np.zeros(x.shape, np.uint32)
    emu_lib.emu_tf32(x.ctypes.data, out.ctypes.data, len(x))
    np.testing.assert_array_equal(out, tf32_reference(x).view(np.uint32))
    assert tf32_reference(np.float32([1 + 2.0 ** -11]))[0] == np.float32(1 + 2.0 ** -10)
    nan = np.float32([np.nan])
    emu_lib.emu_tf32(nan.ctypes.data, out.ctypes.data, 1)
    assert np.isnan(out[:1].view(np.float32)[0])


def bf16_reference(x: np.ndarray) -> np.ndarray:
    """cvt.rn.bf16.f32 by arithmetic, in float64: 8 significant bits for a
    normal number, a 2^-133 grid below 2^-126 (the 16 bits kept of a
    subnormal), the halfway case to the even neighbour; past the largest
    bf16 (halfway to 2^128 and up), infinity. To float32."""
    x = x.astype(np.float64)
    mag = np.abs(x)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        _, exp = np.frexp(np.where(mag > 0, mag, 1.0))
        ulp = np.where(mag < 2.0 ** -126, 2.0 ** -133, np.ldexp(1.0, exp - 8))
        q = np.round(mag / ulp) * ulp  # numpy rounds halves to even
        q = np.where(q >= 2.0 ** 128, np.inf, q)
        out = np.where(np.isfinite(x), np.copysign(q, x), x).astype(np.float32)
    return out


BF16_CASES = np.array([
    0.0, -0.0, 1.0, -3.0,
    1 + 2.0 ** -8, -(1 + 2.0 ** -8),  # halfway from an even last bit: down, both signs
    1 + 3 * 2.0 ** -8,  # halfway from an odd last bit: up to even
    1 + 2.0 ** -8 - 2.0 ** -23, 1 + 2.0 ** -8 + 2.0 ** -23,  # just below / above halfway
    2 - 2.0 ** -23,  # rounds up into the next binade
    2.0 ** -149, 2.0 ** -134, 3 * 2.0 ** -134, 5 * 2.0 ** -135,  # subnormals, ties to even
    2.0 ** -126 - 2.0 ** -149,  # the largest subnormal rounds up to the smallest normal
    3.3895313892515355e38,  # the largest bf16 stays
    3.4028234663852886e38, -3.4028234663852886e38,  # past halfway to 2^128: infinity
    np.inf, -np.inf,
], np.float32)


def test_emulated_bf16_rounding_matches_numpy(emu_lib):
    """bf16_bits (cvt.rn.bf16.f32) against the arithmetic above and against
    torch's own float -> bfloat16 conversion, bit for bit."""
    rng = np.random.default_rng(2)
    x = np.concatenate([BF16_CASES, rng.normal(size=200).astype(np.float32),
                        (rng.normal(size=50) * 2.0 ** -130).astype(np.float32)])
    out = np.zeros(x.shape, np.uint32)
    emu_lib.emu_bf16(x.ctypes.data, out.ctypes.data, len(x))
    np.testing.assert_array_equal(out, bf16_reference(x).view(np.uint32))
    torch_bits = torch.from_numpy(x).to(torch.bfloat16).float().numpy().view(np.uint32)
    np.testing.assert_array_equal(out, torch_bits)
    nan = np.float32([np.nan])
    emu_lib.emu_bf16(nan.ctypes.data, out.ctypes.data, 1)
    assert out[0] == 0x7FFF0000  # the canonical NaN


def test_emulated_bf16x2_packing_matches_numpy(emu_lib):
    """pack_bf16x2 (cvt.rn.bf16x2.f32): each half the bits bf16_bits gives its
    value (rounded to nearest even), lo in the low 16 bits."""
    rng = np.random.default_rng(3)
    lo = np.concatenate([BF16_CASES, rng.normal(size=100).astype(np.float32)])
    hi = np.roll(lo, 7)
    out = np.zeros(lo.shape, np.uint32)
    emu_lib.emu_pack(lo.ctypes.data, hi.ctypes.data, out.ctypes.data, len(lo))
    np.testing.assert_array_equal(out & 0xFFFF, bf16_reference(lo).view(np.uint32) >> 16)
    np.testing.assert_array_equal(out >> 16, bf16_reference(hi).view(np.uint32) >> 16)


@pytest.mark.parametrize("shape", ["tf32_m16n8k8", "bf16_m16n8k16", "bf16_m16n8k8"])
def test_emulated_mma_matches_numpy_exactly(emu_lib, shape):
    """The emulated mma.sync (the TF32 m16n8k8, the bf16 m16n8k16 and
    m16n8k8 with fp32 accumulators), operands in the PTX fragment layout:
    the exact products of an element added to C in k order, one rounding,
    as numpy computes it in float64."""
    rng = np.random.default_rng(1)
    k = 8 if shape.endswith("k8") else 16
    rounded = tf32_reference if shape.startswith("tf32") else bf16_reference
    a = rounded(rng.normal(size=(16, k)).astype(np.float32))
    b = rounded(rng.normal(size=(k, 8)).astype(np.float32))
    c = rng.normal(size=(16, 8)).astype(np.float32)
    d = np.full((16, 8), np.nan, np.float32)
    if shape.startswith("tf32"):
        emu_lib.emu_mma(a.ctypes.data, b.ctypes.data, c.ctypes.data, d.ctypes.data)
    else:
        emu_lib.emu_mma_bf16(a.ctypes.data, b.ctypes.data, c.ctypes.data, d.ctypes.data, k)
    want = c.astype(np.float64)
    for kk in range(k):
        want = want + a[:, kk, None].astype(np.float64) * b[None, kk, :].astype(np.float64)
    np.testing.assert_array_equal(d, want.astype(np.float32))


# (form, P, Q, n, k, splits): every product's form, with each ragged edge
PRODUCT_CASES = {
    # dW of layer 0: P = 2 < 16 (4-byte copies), 100 rows (a ragged last step), 3 splits
    "dw_layer0": ("rows", 2, 32, 100, 1, 3),
    # dW_res-like, 16-byte copies, one split
    "dw_res_wide": ("rows", 32, 64, 90, 1, 1),
    # P and Q of 13 and 215: ragged tiles both ways (4 tiles of 64 along Q), 2 splits
    "dw_ragged": ("rows", 13, 215, 37, 1, 2),
    # dwp: P = N * C_out in tiles of 64 (the last ragged), Q = latent
    "dwp": ("rows", 215, 16, 40, 1, 2),
    # dM of layer 0: 215 nodes (7 x 4 tiles, both ragged), 2 channels padded to k = 8
    "dm_layer0": ("windows", 215, 215, 3, 2, 2),
    # dM with 20 channels: a full 16-channel step, then a short one of 4
    "dm_chunked": ("windows", 13, 215, 5, 20, 2),
    # 16 channels, 35 nodes, 16-byte copies; 3 channels, 4-byte copies
    "dm_35": ("windows", 35, 35, 4, 16, 1),
    "dm_odd_channels": ("windows", 30, 30, 3, 3, 1),
}


def _operands(form, p, q, n, k, seed):
    rng = np.random.default_rng(seed)
    shape_a = (n, p) if form == "rows" else (n, p, k)
    shape_b = (n, q) if form == "rows" else (n, q, k)
    return (torch.from_numpy(rng.normal(size=shape_a).astype(np.float32)),
            torch.from_numpy(rng.normal(size=shape_b).astype(np.float32)))


@pytest.mark.parametrize("case", sorted(PRODUCT_CASES))
def test_host_run_of_product_matches_float64(host_lib, case):
    form, p, q, n, k, splits = PRODUCT_CASES[case]
    a, b = _operands(form, p, q, n, k, seed=len(case))
    got = stse_train.launch_product(host_lib, form, a, b, splits)
    want = stse_train.product_reference(form, a.double(), b.double())
    scale = stse_train.product_reference(form, a.double().abs(), b.double().abs())
    assert got.shape == (p, q)
    err = (got.double() - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all()), (case, float(err.max()))
    # the same bits again: the warps' and the splits' sums are taken in a fixed order
    assert torch.equal(got, stse_train.launch_product(host_lib, form, a, b, splits))


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "bfloat16_f32store"])
@pytest.mark.parametrize("case", ["dw_ragged", "dm_chunked"])
def test_host_run_of_bf16_product_matches_float64(host_lib, case, compute_dtype):
    """The bf16 mma (exact products, fp32 sums) from fp32 operands packed to
    bf16 at load and, under "bfloat16", from bf16 operands staged as they are
    (K3-K5's scratch: g, dt, dr, dg), each combination: the same function.
    dw_ragged's 13 and 215 columns stage bf16 rows element by element,
    dm_chunked's 20 channels two at a time."""
    form, p, q, n, k, splits = PRODUCT_CASES[case]
    a, b = _operands(form, p, q, n, k, seed=len(case) + 1)
    want = stse_train.product_reference(form, a.double(), b.double(), compute_dtype)
    scale = stse_train.product_reference(form, a.double().abs(), b.double().abs())
    kinds = [(torch.float32, torch.float32)]
    if compute_dtype == "bfloat16":
        kinds += [(torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32),
                  (torch.bfloat16, torch.bfloat16)]
    for ka, kb in kinds:
        got = stse_train.launch_product(host_lib, form, a.to(ka), b.to(kb), splits, compute_dtype)
        err = (got.double() - want).abs()
        assert bool((err <= 1e-5 * scale + 1e-6).all()), (case, ka, kb, float(err.max()))
    # not the float32 product: the operands were rounded
    exact = stse_train.product_reference(form, a.double(), b.double())
    assert not bool(((got.double() - exact).abs() <= 1e-5 * scale + 1e-6).all())
    with pytest.raises(ValueError, match="must be float32 "):  # 3xTF32 takes fp32 only
        stse_train.launch_product(host_lib, form, a, b.to(torch.bfloat16), splits, "float32")


def test_product_splits_fill_the_card_within_the_old_partials():
    """At the flagship width the split count gives >= 2 waves of one block an
    SM on 132 SMs where the reduction has the steps for it, and the largest
    partials at B = 2048 stay under the 64 x 64-tile design's (dM: 17 x
    216^2 floats)."""
    from coskad_tpu_torch.models import STSE

    model = STSE(input_dim=2, layer_channels=(32, 16, 32), hidden_dimension=64,
                 latent_dim=16, n_frames=12, n_joints=18)
    ops = stse_train.encoder_ops(model)
    plan = {}
    for batch in (2048, 128):
        for pr in stse_train.products(ops, batch):
            pt, qt = stse_train.product_tile(pr["form"], pr["p"], pr["q"])
            tiles = -(-pr["p"] // pt) * -(-pr["q"] // qt)
            s = stse_train.product_splits(pr["form"], pr["p"], pr["q"], pr["n"], pr["k"])
            plan[pr["name"], batch] = (tiles, s)
    assert plan["layer3.dw", 2048] == (1, 264) and plan["layer0.dw", 128] == (1, 108)
    assert plan["layer1.dm", 2048] == (28, 10) and plan["dwp", 2048] == (216, 2)
    assert plan["layer1.dm", 128] == (28, 10) and plan["dwp", 128] == (216, 1)
    biggest = max(s * pr["p"] * pr["q"] for pr in stse_train.products(ops, 2048)
                  for s in [plan[pr["name"], 2048][1]] if s > 1)
    assert biggest == 264 * 32 * 64 < 17 * 216 * 216
    assert len(stse_train.products(ops, 2048)) == 13
    assert sum(pr["flops"] for pr in stse_train.products(ops, 2048)) == pytest.approx(22.125e9,
                                                                                       rel=1e-4)


def test_product_on_cpu_takes_the_plain_version():
    a, b = _operands("windows", 6, 5, 3, 4, seed=2)
    before = stse_train.product_launches.value
    torch.testing.assert_close(stse_train.product("windows", a, b),
                               torch.einsum("wpk,wqk->pq", a, b))
    assert stse_train.product_launches.value == before
    with pytest.raises(ValueError, match="do not fit"):
        stse_train.product("rows", a, b)
    with pytest.raises(ValueError, match="do not fit"):
        stse_train.product("windows", a, b[:, :, :3])

// Bilinear x2 upsampling of NHWC maps for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package left its upsamplings to XLA. It
// was added because PyTorch's own NHWC kernel
// (upsample_bilinear2d_nhwc_out_frame), which the served nets ran 11 times
// a batch (every UpConvBlock: five in DepthNet, three in each RefineNet
// branch), took 16-20% of the card's busy time at about 12x its bound:
// each of its threads does four integer divisions and four 2-byte loads
// for one output element.
//
// out[n, 2i + a, 2j + b, c] for a, b in {0, 1}, with half-pixel centres
// (F.interpolate(scale_factor=2, mode="bilinear", align_corners=False)):
//   row 2i:     taps max(i - 1, 0) and the next row clamped, weights
//               1/4, 3/4 (i > 0) or 1, 0 (i = 0: the source index clamps
//               at 0);
//   row 2i + 1: taps i and min(i + 1, H - 1), weights 3/4, 1/4;
// and the same along the columns. The taps, the weights and the clamps
// are PyTorch's (h1, h1 + h1p, h0lambda, h1lambda), so the border rows
// take the same two taps as PyTorch's kernel, a zero weight included.
//
// Bound on an H100 SXM (3.35 TB/s): the input read once and the output
// (4x the input) written once. A bucket-8 batch of three-view frames moves
// ~0.90 GB in bf16 (~0.27 ms), of seven-view frames ~1.82 GB (~0.54 ms);
// the arithmetic, 24 f32 operations an output, is far below the bandwidth.
//
// Design:
// 1. Lanes. A thread owns one 16-byte vector of channels (8 bf16 or 4 f32)
//    of one input pixel (i, j) and writes its 2 x 2 output quad as four
//    16-byte stores. Neighbouring lanes take neighbouring channel vectors,
//    then neighbouring j, so every load and store of a warp is contiguous.
// 2. Reads. The quad reads the 3 x 3 input neighbourhood: nine 16-byte
//    loads issued together. A block covers a run of one input row; the
//    blocks resident at once cover neighbouring rows of one map, so the
//    three-fold reuse of each row and column hits L1 and L2, and device
//    memory sees each input byte about once. No shared memory.
// 3. Index arithmetic. The row and the map are the block's (one division a
//    block); a thread divides once, for its pixel's column.
// 4. Arithmetic. In f32, in PyTorch's expression order,
//      h0 * (w0 * x00 + w1 * x01) + h1 * (w0 * x10 + w1 * x11),
//    contracted into FMAs as PyTorch's build of that kernel contracts it
//    (its sm_90 SASS, torch 2.11 with CUDA 12.8):
//      top    = fma(w1, x01, w0 * x00),
//      bottom = fma(w0, x10, w1 * x11),
//      out    = fma(h0, top, h1 * bottom),
//    spelled out as _rn intrinsics, which the compiler never contracts
//    again; then one rounding to the output type (round to nearest even, as
//    c10::BFloat16 on sm_80+). The output then equals F.interpolate's on
//    the card bit for bit, in f32 too. In bf16 every product of a weight
//    and an input is exact in f32, so there only the outer FMA matters.
// 5. Offsets are 64-bit. The grid's blocks (maps x rows x runs of a row)
//    must stay below 2^31: a larger map is refused at launch
//    (cudaErrorInvalidConfiguration), and the wrapper raises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Lanes;

template <>
struct Lanes<__nv_bfloat16> {
  static constexpr int kN = 8;  // channels in 16 bytes
  __device__ __forceinline__ static float get(const uint4& v, int e) {
    const unsigned w = e < 2 ? v.x : e < 4 ? v.y : e < 6 ? v.z : v.w;
    return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    uint4 v;
    unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
      w[k] = *reinterpret_cast<const unsigned*>(&h);
    }
    return v;
  }
};

template <>
struct Lanes<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float get(const uint4& v, int e) {
    return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&f)[kN]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// w0 * x0 + w1 * x1 with the first product fused into the sum: fusing the
// second is the same function with its pairs swapped.
__device__ __forceinline__ float lerp2(float w0, float x0, float w1, float x1) {
  return __fmaf_rn(w0, x0, __fmul_rn(w1, x1));
}

// One output pixel's vector from its four taps (rows A, B x columns A, B).
template <typename T>
__device__ __forceinline__ uint4 blend(const uint4& aa, const uint4& ab, const uint4& ba,
                                       const uint4& bb, float h0, float h1, float w0, float w1) {
  using L = Lanes<T>;
  float f[L::kN];
#pragma unroll
  for (int e = 0; e < L::kN; ++e) {
    const float top = lerp2(w1, L::get(ab, e), w0, L::get(aa, e));
    const float bottom = lerp2(w0, L::get(ba, e), w1, L::get(bb, e));
    f[e] = lerp2(h0, top, h1, bottom);
  }
  return L::pack(f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cnm_upsample2x_bilinear_nhwc_kernel(
    const T* __restrict__ in, T* __restrict__ out, int H, int W, int C, int runs) {
  const int vectors = C / Lanes<T>::kN;  // 16-byte vectors a pixel
  const int row = blockIdx.x / runs;     // n * H + i
  const int item = (blockIdx.x - row * runs) * kThreads + threadIdx.x;
  if (item >= W * vectors) return;
  const int i = row % H;
  const int n = row / H;
  const int j = item / vectors;
  const int v = item - j * vectors;

  const uint4* src =
      reinterpret_cast<const uint4*>(in) + static_cast<int64_t>(n) * H * W * vectors;
  const int rows[3] = {max(i - 1, 0), i, min(i + 1, H - 1)};
  const int cols[3] = {max(j - 1, 0), j, min(j + 1, W - 1)};
  uint4 x[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      x[r][c] = __ldg(src + (static_cast<int64_t>(rows[r]) * W + cols[c]) * vectors + v);

  // Output row 2i reads rows (i - 1, i), or at i = 0 rows (0, min(1, H - 1))
  // with weights (1, 0); row 2i + 1 reads (i, min(i + 1, H - 1)). Likewise
  // the columns.
  const bool top = i == 0, left = j == 0;
  const float he1 = top ? 0.0f : 0.75f, he0 = 1.0f - he1;
  const float we1 = left ? 0.0f : 0.75f, we0 = 1.0f - we1;
  uint4 eb[3];  // row B of the even output row, by column
#pragma unroll
  for (int c = 0; c < 3; ++c) eb[c] = top ? x[2][c] : x[1][c];
  const uint4 e_b0 = left ? x[0][2] : x[0][1];  // row A, column B of the even column
  const uint4 e_b1 = left ? eb[2] : eb[1];      // row B, column B of the even column
  const uint4 o_b0 = left ? x[1][2] : x[1][1];  // odd row: rows (i, i + 1)
  const uint4 o_b1 = left ? x[2][2] : x[2][1];

  uint4 q[2][2];
  q[0][0] = blend<T>(x[0][0], e_b0, eb[0], e_b1, he0, he1, we0, we1);
  q[0][1] = blend<T>(x[0][1], x[0][2], eb[1], eb[2], he0, he1, 0.75f, 0.25f);
  q[1][0] = blend<T>(x[1][0], o_b0, x[2][0], o_b1, 0.75f, 0.25f, we0, we1);
  q[1][1] = blend<T>(x[1][1], x[1][2], x[2][1], x[2][2], 0.75f, 0.25f, 0.75f, 0.25f);

  uint4* dst = reinterpret_cast<uint4*>(out) + static_cast<int64_t>(n) * 4 * H * W * vectors;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      dst[(static_cast<int64_t>(2 * i + a) * 2 * W + 2 * j + b) * vectors + v] = q[a][b];
}

template <typename T>
int launch(const void* in, void* out, int N, int H, int W, int C, cudaStream_t stream) {
  const int runs = (W * (C / Lanes<T>::kN) + kThreads - 1) / kThreads;
  const int64_t blocks = static_cast<int64_t>(N) * H * runs;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  cnm_upsample2x_bilinear_nhwc_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), H, W, C, runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in: [N, H, W, C] (a channels-last [N, C, H, W]), bf16 (bf16 != 0) or f32,
// 16-byte aligned, C a multiple of 8; out: [N, 2H, 2W, C] of the same type,
// 16-byte aligned. One launch on `stream`; returns cudaGetLastError().
extern "C" int cnm_upsample2x_bilinear(const void* in, void* out, int N, int H, int W, int C,
                                       int bf16, cudaStream_t stream) {
  if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) return launch<__nv_bfloat16>(in, out, N, H, W, C, stream);
  return launch<float>(in, out, N, H, W, C, stream);
}

// Plane-sweep cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel cnmnet_tpu/kernels/cost_volume_pallas.py
// (_cost_volume_pallas_jit, body _make_kernel). That kernel splits the warp
// into two resampling passes inside 128-lane windows because Mosaic has no
// general gather; a GPU gathers natively, so this is a direct bilinear
// kernel with the semantics of the plain version, ops/cost_volume.py.
//
// out[b, p, y, x] = sum_c | bilinear(src_b, warp_p(x, y))_c - ref_b[y, x, c] |
//   warp_p(x, y) = (X / (Z + eps), Y / (Z + eps)),
//   (X, Y, Z)    = KRKi_b (x, y, 1) + KT_b * idepth[p],
// with the plain version's guard (|Z + eps| < eps -> eps), its clip of the
// coordinates to +-100 max(H, W) before the float->int conversion, and taps
// outside [0, W-1] x [0, H-1] counted as zero. No behind-camera mask.
//
// Layout: one thread per (pair, pixel, chunk of planes). KRKi (x, y, 1) and
// the pixel's three reference values are computed and loaded once per
// thread; each plane adds KT * idepth[p]. Stores go to [B, P, H, W], so a
// warp writes 32 consecutive x of one plane (coalesced). The source image
// (590 KB at 192x256x3 f32) is read through the read-only path and stays in
// the 50 MB L2.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32) at the serving shape,
// 2 pairs x 64 planes x 192 x 256 = 6.29 M outputs: the writes are 25.2 MB
// in f32 (7.5 us) or 12.6 MB in bf16 (3.8 us); the arithmetic is about 55
// f32 operations per output (0.35 GFLOP, 5.2 us). So the f32 volume is
// bound by its writes and the bf16 volume by its instruction count; the
// design keeps every other byte out of device memory (no sampling grid, no
// warped image) and writes each output exactly once.
//
// The arithmetic uses the _rn intrinsics, which the compiler never
// contracts into FMAs: every step rounds where the plain PyTorch version
// rounds, in its order (taps, then channels, first to last), so both give
// the same costs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPlaneChunk = 16;

__device__ __forceinline__ void store(float* out, size_t i, float v) { out[i] = v; }

__device__ __forceinline__ void store(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

// (k0 * u + k1 * v) + k2, rounded at each step.
__device__ __forceinline__ float row_dot(const float* k, float u, float v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k[0], u), __fmul_rn(k[1], v)), k[2]);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads) cost_volume_kernel(
    const float* __restrict__ ref, const float* __restrict__ src,
    const float* __restrict__ coef, const float* __restrict__ idepth,
    OutT* __restrict__ out, int H, int W, int P) {
  const int HW = H * W;
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix >= HW) return;
  const int b = blockIdx.z;
  const int p_begin = blockIdx.y * kPlaneChunk;
  const int p_end = min(p_begin + kPlaneChunk, P);

  const float u = static_cast<float>(pix % W);
  const float v = static_cast<float>(pix / W);
  const float* c = coef + 12 * b;  // KRKi row-major (9), then KT (3)
  const float hx = row_dot(c + 0, u, v);
  const float hy = row_dot(c + 3, u, v);
  const float hz = row_dot(c + 6, u, v);
  const float tx = c[9], ty = c[10], tz = c[11];

  const float* r = ref + (static_cast<size_t>(b) * HW + pix) * 3;
  const float r0 = r[0], r1 = r[1], r2 = r[2];
  const float* s = src + static_cast<size_t>(b) * HW * 3;

  const float eps = 1e-6f;
  const float bound = 100.0f * static_cast<float>(max(H, W));
  const size_t out_base = static_cast<size_t>(b) * P * HW + pix;

  for (int p = p_begin; p < p_end; ++p) {
    const float id = __ldg(idepth + p);
    const float X = __fadd_rn(hx, __fmul_rn(tx, id));
    const float Y = __fadd_rn(hy, __fmul_rn(ty, id));
    const float Z = __fadd_rn(hz, __fmul_rn(tz, id));
    float denom = __fadd_rn(Z, eps);
    if (fabsf(denom) < eps) denom = eps;
    const float x = fminf(fmaxf(__fdiv_rn(X, denom), -bound), bound);
    const float y = fminf(fmaxf(__fdiv_rn(Y, denom), -bound), bound);
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float fx = __fsub_rn(x, x0f);
    const float fy = __fsub_rn(y, y0f);
    const float gx = __fsub_rn(1.0f, fx);
    const float gy = __fsub_rn(1.0f, fy);
    const int x0 = static_cast<int>(x0f);
    const int y0 = static_cast<int>(y0f);

    // taps in the plain version's order: (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1)
    const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
    const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
    const float ws[4] = {__fmul_rn(gx, gy), __fmul_rn(fx, gy), __fmul_rn(gx, fy),
                         __fmul_rn(fx, fy)};
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
      if (xs[t] >= 0 && xs[t] <= W - 1 && ys[t] >= 0 && ys[t] <= H - 1) {
        const float* q = s + (static_cast<size_t>(ys[t]) * W + xs[t]) * 3;
        t0 = __fmul_rn(__ldg(q + 0), ws[t]);
        t1 = __fmul_rn(__ldg(q + 1), ws[t]);
        t2 = __fmul_rn(__ldg(q + 2), ws[t]);
      }
      w0 = __fadd_rn(w0, t0);
      w1 = __fadd_rn(w1, t1);
      w2 = __fadd_rn(w2, t2);
    }
    const float cost = __fadd_rn(
        __fadd_rn(fabsf(__fsub_rn(w0, r0)), fabsf(__fsub_rn(w1, r1))),
        fabsf(__fsub_rn(w2, r2)));
    store(out, out_base + static_cast<size_t>(p) * HW, cost);
  }
}

}  // namespace

// ref, src: [B, H, W, 3] f32 contiguous; coef: [B, 12] f32; idepth: [P] f32;
// out: [B, P, H, W], f32 or (out_bf16 != 0) bf16. Returns cudaGetLastError().
extern "C" int cnm_cost_volume(const float* ref, const float* src, const float* coef,
                               const float* idepth, void* out, int B, int H, int W,
                               int P, int out_bf16, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H * W + kThreads - 1) / kThreads, (P + kPlaneChunk - 1) / kPlaneChunk, B);
  if (out_bf16) {
    cost_volume_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        ref, src, coef, idepth, static_cast<__nv_bfloat16*>(out), H, W, P);
  } else {
    cost_volume_kernel<float><<<grid, kThreads, 0, stream>>>(
        ref, src, coef, idepth, static_cast<float*>(out), H, W, P);
  }
  return static_cast<int>(cudaGetLastError());
}

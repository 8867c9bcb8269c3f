// Depth -> unit surface normals (forward) for Hopper (sm_90a).
//
// Replaces the TPU kernel cnmnet_tpu/kernels/normals_pallas.py
// (_depth_to_normal_pallas_impl, body _make_kernel), with the semantics of
// the plain version, ops/normals.py: backproject depth through the full
// 3x3 K^-1 (no pinhole assumption on its last row), mask depths outside
// (vmin, vmax), take the nine zero-padded k x k window sums of the
// monomials (xx, xy, xz, yy, yz, zz, x, y, z), solve the 3x3 normal
// equations by the adjugate (A^T 1 where det < 1e-5 or NaN), and divide by
// sqrt(|n|^2 + 1e-20) + norm_eps.
//
// Layout: one block per (image, tile of kTileH x kTileW output pixels).
// The block stages the tile's masked points plus a k/2 halo in shared
// memory (zeros outside the image), takes the vertical k-tap sums of the
// nine monomials into shared memory, then each thread sums k of those
// horizontally for its pixel, solves in registers and writes its normal
// ([B, H, W, 3], NHWC). Any H and W; odd k <= 17.
//
// The uncentred f32 solve is ill-conditioned at realistic focal lengths:
// one ulp in a window sum can turn a normal by degrees. So every step uses
// the _rn intrinsics, which the compiler never contracts into FMAs, and
// rounds where the plain version rounds, in its order (taps added first to
// last, vertical pass then horizontal): the kernel and the plain version
// give the same normals, not merely equally good ones.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32) at 192x256, k = 9:
// 0.2 MB of depth read and 0.6 MB of normals written per image (0.24 us)
// against about 11 MFLOP (0.16 us), so one image is bound by its bytes and,
// below a few microseconds, by the launch itself. The design reads depth
// once and writes normals once: the monomials and their window sums never
// leave shared memory.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kMaxHalo = 8;  // k <= 17
constexpr int kStageW = kTileW + 2 * kMaxHalo;
constexpr int kStageH = kTileH + 2 * kMaxHalo;
constexpr int kThreads = kTileW * kTileH;

__global__ void __launch_bounds__(kThreads) depth_to_normal_kernel(
    const float* __restrict__ depth, const float* __restrict__ kinv,
    float* __restrict__ out, int H, int W, int k, float vmin, float vmax,
    float det_eps, float norm_eps) {
  __shared__ float px[kStageH][kStageW];
  __shared__ float py[kStageH][kStageW];
  __shared__ float pz[kStageH][kStageW];
  __shared__ float vsum[9][kTileH][kStageW];

  const int r = k / 2;
  const int sh = kTileH + 2 * r;
  const int sw = kTileW + 2 * r;
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const float* K = kinv + 9 * b;
  const float* d_img = depth + static_cast<size_t>(b) * H * W;

  // 1. masked points of the tile and its halo
  for (int i = tid; i < sh * sw; i += kThreads) {
    const int yy = i / sw;
    const int xx = i - yy * sw;
    const int gy = row0 - r + yy;
    const int gx = col0 - r + xx;
    float X = 0.0f, Y = 0.0f, Z = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const float d = d_img[static_cast<size_t>(gy) * W + gx];
      if (d > vmin && d < vmax) {
        const float u = static_cast<float>(gx);
        const float v = static_cast<float>(gy);
        X = mul(add(add(mul(K[0], u), mul(K[1], v)), K[2]), d);
        Y = mul(add(add(mul(K[3], u), mul(K[4], v)), K[5]), d);
        Z = mul(add(add(mul(K[6], u), mul(K[7], v)), K[8]), d);
      }
    }
    px[yy][xx] = X;
    py[yy][xx] = Y;
    pz[yy][xx] = Z;
  }
  __syncthreads();

  // 2. vertical k-tap sums of the nine monomials, for every staged column
  for (int i = tid; i < kTileH * sw; i += kThreads) {
    const int ty = i / sw;
    const int xx = i - ty * sw;
    float m[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) m[j] = 0.0f;
    for (int dy = 0; dy < k; ++dy) {
      const float x = px[ty + dy][xx];
      const float y = py[ty + dy][xx];
      const float z = pz[ty + dy][xx];
      m[0] = add(m[0], mul(x, x));
      m[1] = add(m[1], mul(x, y));
      m[2] = add(m[2], mul(x, z));
      m[3] = add(m[3], mul(y, y));
      m[4] = add(m[4], mul(y, z));
      m[5] = add(m[5], mul(z, z));
      m[6] = add(m[6], x);
      m[7] = add(m[7], y);
      m[8] = add(m[8], z);
    }
#pragma unroll
    for (int j = 0; j < 9; ++j) vsum[j][ty][xx] = m[j];
  }
  __syncthreads();

  // 3. horizontal sums, adjugate solve, normalisation
  const int gy = row0 + threadIdx.y;
  const int gx = col0 + threadIdx.x;
  if (gy >= H || gx >= W) return;
  float s[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    float acc = 0.0f;
    for (int dx = 0; dx < k; ++dx) acc = add(acc, vsum[j][threadIdx.y][threadIdx.x + dx]);
    s[j] = acc;
  }
  const float a = s[0], bb = s[1], c = s[2], d = s[3], e = s[4], f = s[5];
  const float rx = s[6], ry = s[7], rz = s[8];
  // the plain version's expressions, evaluated left to right
  const float adj00 = sub(mul(d, f), mul(e, e));
  const float adj01 = sub(mul(c, e), mul(bb, f));
  const float adj02 = sub(mul(bb, e), mul(c, d));
  const float adj11 = sub(mul(a, f), mul(c, c));
  const float adj12 = sub(mul(bb, c), mul(a, e));
  const float adj22 = sub(mul(a, d), mul(bb, bb));
  // det = a (df - ee) - b (bf - ce) + c (be - cd)
  const float det = add(sub(mul(a, adj00), mul(bb, sub(mul(bb, f), mul(c, e)))), mul(c, adj02));
  float nx = add(add(mul(adj00, rx), mul(adj01, ry)), mul(adj02, rz));
  float ny = add(add(mul(adj01, rx), mul(adj11, ry)), mul(adj12, rz));
  float nz = add(add(mul(adj02, rx), mul(adj12, ry)), mul(adj22, rz));
  if (isnan(det) || det < det_eps) {
    nx = rx;
    ny = ry;
    nz = rz;
  } else {
    const float inv_det = __fdiv_rn(1.0f, det);
    nx = mul(nx, inv_det);
    ny = mul(ny, inv_det);
    nz = mul(nz, inv_det);
  }
  const float sq = add(add(add(mul(nx, nx), mul(ny, ny)), mul(nz, nz)), 1e-20f);
  const float norm = add(__fsqrt_rn(sq), norm_eps);
  float* o = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * 3;
  o[0] = __fdiv_rn(nx, norm);
  o[1] = __fdiv_rn(ny, norm);
  o[2] = __fdiv_rn(nz, norm);
}

}  // namespace

// depth: [B, H, W] f32; kinv: [B, 3, 3] f32; out: [B, H, W, 3] f32, all
// contiguous. Returns cudaGetLastError().
extern "C" int cnm_depth_to_normal(const float* depth, const float* kinv, float* out,
                                   int B, int H, int W, int k, float vmin, float vmax,
                                   float det_eps, float norm_eps, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || k < 1 || k % 2 == 0 || k / 2 > kMaxHalo)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  depth_to_normal_kernel<<<grid, block, 0, stream>>>(depth, kinv, out, H, W, k, vmin, vmax,
                                                     det_eps, norm_eps);
  return static_cast<int>(cudaGetLastError());
}

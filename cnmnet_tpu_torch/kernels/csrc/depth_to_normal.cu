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
// The depth's rows are the image's from global row row_offset on: a row
// shard of the tiled op (parallel/tiled_ops.py) passes its rows with k/2
// halo rows from its neighbours and row_offset = its first row - k/2, and
// keeps the interior rows. A pixel backprojects through its global (u, v),
// and every window adds its taps first to last from 0, so the interior
// rows equal the untiled normals bit for bit. The untiled call passes 0.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32) at 192x256, k = 9:
// 0.2 MB of depth read and 0.6 MB of normals written per image (0.24 us)
// against about 11 MFLOP (0.16 us), so the function is bound by its bytes
// and, below a few microseconds, by the launch itself. The monomials and
// their window sums never leave shared memory; what costs time is the
// instructions and the latency of the box sums, which the design cuts:
//
// 1. Wide tiles. A block of 256 threads owns kTileW x kTileH = 64 x 8
//    outputs and stages them with their k/2 halo: 72 x 16 points at k = 9,
//    2.25 per output (2.5 for 32 x 8 tiles). Taller tiles stage less, but
//    at B = 1 and 192x256 their 48 blocks leave most of the 132 SMs idle,
//    and on an H100 64 x 16 tiles were slower at B = 1 and no faster at
//    B = 8.
// 2. Asynchronous staging. The raw depth tile goes to shared memory by
//    cp.async, whose zero fill stands for the plain version's zero padding
//    outside the image: depth 0 is masked, or backprojects to a zero point.
// 3. Register-blocked passes, with k a template parameter so that every
//    loop unrolls and every register index is known at compile time.
//    Vertical: a thread takes kSeg output rows of one staged column, loads
//    its kSeg + k - 1 points from shared memory once and keeps them in
//    registers (each point is read once, not k times), and forms each
//    monomial product once per point, not once per window. Horizontal: a
//    thread owns kRun adjacent outputs of a row and reads the kRun + k - 1
//    vertical sums of a monomial it needs as 8-byte loads (k kRun reads
//    before). Each window sum still adds its k taps first to last, from 0.
// 4. Vector stores. The kRun adjacent normals of a thread are 6 contiguous
//    floats of the [B, H, W, 3] output, written as three 8-byte stores
//    (where W is even and the run lies in the image): a warp writes one
//    whole 768-byte row segment with no staging in shared memory.
//
// Tensor cores do not apply: a box sum as a TF32 or bf16 product loses the
// f32 order. The uncentred f32 solve is ill-conditioned at realistic focal
// lengths: one ulp in a window sum can turn a normal by degrees. So every
// step uses the _rn intrinsics, which the compiler never contracts into
// FMAs, and rounds where the plain version rounds, in its order (taps
// added first to last, vertical pass then horizontal): the kernel and the
// plain version give the same normals, not merely equally good ones.
//
// Odd k above 17 take one k-generic instantiation (depth_to_normal_any):
// the same tiles, the same zero-filled cp.async staging and the same tap
// order (vertical pass then horizontal, each window summed first to last
// from 0), with k read at run time and nothing unrolled, so it too equals
// the plain version bit for bit. Its staged tile grows with R = k/2:
// (8 + 2R) x (64 + 2R) points and 8 x (64 + 2R) vertical sums of the 9
// monomials (shared_bytes below); it launches while that fits the block's
// opt-in shared memory (227 KB on an H100: up to k = 87).
// Any H and W.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

constexpr int kTileW = 64;
constexpr int kTileH = 8;
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // per SM: caps registers at 64 a thread
constexpr int kSeg = 4;        // output rows per thread in the vertical pass
constexpr int kRun = 2;        // adjacent outputs per thread in the horizontal pass
constexpr int kMaxK = 17;
constexpr int kMaxDevices = 64;
static_assert(kTileW / kRun * kTileH == kThreads, "one run of outputs per thread");
static_assert(kTileH % kSeg == 0, "whole vertical segments");

template <int K>
struct Tile {
  static constexpr int R = K / 2;
  static constexpr int SH = kTileH + 2 * R;       // staged rows
  static constexpr int SW = kTileW + 2 * R;       // staged columns
  static constexpr int Pitch = (SW + 3) / 4 * 4;  // floats a row: 16-byte rows
  static constexpr int Stage = SH * Pitch;
  static constexpr int Vsum = 9 * kTileH * Pitch;
  static constexpr int Loads = (kRun + K - 1 + 1) / 2;  // float2 reads a monomial
  // points X, Y, Z; then the raw depth, which the vertical sums overwrite
  static constexpr size_t Bytes = (3 * Stage + (Stage > Vsum ? Stage : Vsum)) * sizeof(float);
  static_assert(kTileW - kRun + 2 * Loads <= Pitch, "horizontal reads stay in the row");
};

__device__ __forceinline__ void copy4_async(float* dst, const float* src, bool inside) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(inside ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void wait_async_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Monomial j of a point: xx, xy, xz, yy, yz, zz, x, y, z.
__device__ __forceinline__ float monomial(int j, float x, float y, float z) {
  switch (j) {
    case 0: return mul(x, x);
    case 1: return mul(x, y);
    case 2: return mul(x, z);
    case 3: return mul(y, y);
    case 4: return mul(y, z);
    case 5: return mul(z, z);
    case 6: return x;
    case 7: return y;
    default: return z;
  }
}

// Adjugate solve and normalisation: the plain version's expressions,
// evaluated left to right.
__device__ __forceinline__ float3 solve(const float s[9], float det_eps, float norm_eps) {
  const float a = s[0], bb = s[1], c = s[2], d = s[3], e = s[4], f = s[5];
  const float rx = s[6], ry = s[7], rz = s[8];
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
  return make_float3(__fdiv_rn(nx, norm), __fdiv_rn(ny, norm), __fdiv_rn(nz, norm));
}

template <int K>
__global__ void __launch_bounds__(kThreads, kMinBlocks) depth_to_normal_kernel(
    const float* __restrict__ depth, const float* __restrict__ kinv,
    float* __restrict__ out, int H, int W, int row_offset, float vmin, float vmax,
    float det_eps, float norm_eps) {
  using T = Tile<K>;
  extern __shared__ __align__(16) float smem[];
  float* px = smem;                  // [SH][Pitch] masked points
  float* py = px + T::Stage;
  float* pz = py + T::Stage;
  float* raw = pz + T::Stage;        // [SH][Pitch] depth, then:
  float* vsum = raw;                 // [9][kTileH][Pitch] vertical sums

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const float* d_img = depth + static_cast<size_t>(b) * H * W;

  // 1. raw depth of the tile and its halo; zeros outside the image
  for (int i = tid; i < T::SH * T::SW; i += kThreads) {
    const int yy = i / T::SW;
    const int xx = i - yy * T::SW;
    const int gy = row0 - T::R + yy;
    const int gx = col0 - T::R + xx;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    copy4_async(raw + yy * T::Pitch + xx,
                inside ? d_img + static_cast<size_t>(gy) * W + gx : d_img, inside);
  }
  wait_async_copies();
  __syncthreads();

  // 2. masked points
  const float* Kb = kinv + 9 * b;
  const float k0 = Kb[0], k1 = Kb[1], k2 = Kb[2], k3 = Kb[3], k4 = Kb[4], k5 = Kb[5];
  const float k6 = Kb[6], k7 = Kb[7], k8 = Kb[8];
  for (int i = tid; i < T::SH * T::SW; i += kThreads) {
    const int yy = i / T::SW;
    const int xx = i - yy * T::SW;
    const int at = yy * T::Pitch + xx;
    const float d = raw[at];
    float X = 0.0f, Y = 0.0f, Z = 0.0f;
    if (d > vmin && d < vmax) {
      const float u = static_cast<float>(col0 - T::R + xx);
      const float v = static_cast<float>(row0 - T::R + yy + row_offset);
      X = mul(add(add(mul(k0, u), mul(k1, v)), k2), d);
      Y = mul(add(add(mul(k3, u), mul(k4, v)), k5), d);
      Z = mul(add(add(mul(k6, u), mul(k7, v)), k8), d);
    }
    px[at] = X;
    py[at] = Y;
    pz[at] = Z;
  }
  __syncthreads();

  // 3. vertical k-tap sums: kSeg output rows of one staged column a thread,
  // one monomial at a time, each product taken once per point
  constexpr int kPts = kSeg + K - 1;
  for (int i = tid; i < T::SW * (kTileH / kSeg); i += kThreads) {
    const int xx = i % T::SW;
    const int r0 = (i / T::SW) * kSeg;
    float x[kPts], y[kPts], z[kPts];
#pragma unroll
    for (int t = 0; t < kPts; ++t) {
      const int at = (r0 + t) * T::Pitch + xx;
      x[t] = px[at];
      y[t] = py[at];
      z[t] = pz[at];
    }
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      float m[kPts];
#pragma unroll
      for (int t = 0; t < kPts; ++t) m[t] = monomial(j, x[t], y[t], z[t]);
#pragma unroll
      for (int r = 0; r < kSeg; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int t = r; t < r + K; ++t) acc = add(acc, m[t]);
        vsum[(j * kTileH + r0 + r) * T::Pitch + xx] = acc;
      }
    }
  }
  __syncthreads();

  // 4. horizontal sums of kRun adjacent outputs, solve, store
  const int ty = tid / (kTileW / kRun);
  const int tx = (tid % (kTileW / kRun)) * kRun;
  const int gy = row0 + ty;
  const int gx = col0 + tx;
  if (gy >= H || gx >= W) return;
  float s[kRun][9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    float v[2 * T::Loads];
    const float2* row = reinterpret_cast<const float2*>(vsum + (j * kTileH + ty) * T::Pitch + tx);
#pragma unroll
    for (int l = 0; l < T::Loads; ++l) {
      const float2 q = row[l];
      v[2 * l] = q.x;
      v[2 * l + 1] = q.y;
    }
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < K; ++t) acc = add(acc, v[o + t]);
      s[o][j] = acc;
    }
  }
  float3 n[kRun];
#pragma unroll
  for (int o = 0; o < kRun; ++o) n[o] = solve(s[o], det_eps, norm_eps);
  float* o_row = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * 3;
  if (W % 2 == 0 && gx + kRun <= W) {
    float2* o2 = reinterpret_cast<float2*>(o_row);
    o2[0] = make_float2(n[0].x, n[0].y);
    o2[1] = make_float2(n[0].z, n[1].x);
    o2[2] = make_float2(n[1].y, n[1].z);
  } else {
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      if (gx + o < W) {
        o_row[3 * o] = n[o].x;
        o_row[3 * o + 1] = n[o].y;
        o_row[3 * o + 2] = n[o].z;
      }
    }
  }
}
static_assert(kRun == 2, "the vector store above writes two normals");

template <int K>
int launch(const float* depth, const float* kinv, float* out, int B, int H, int W,
           int row_offset, float vmin, float vmax, float det_eps, float norm_eps,
           cudaStream_t stream) {
  static bool ready[kMaxDevices];
  int dev = 0;
  int status = static_cast<int>(cudaGetDevice(&dev));
  if (status != 0) return status;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    status = static_cast<int>(cudaFuncSetAttribute(
        depth_to_normal_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(Tile<K>::Bytes)));
    if (status != 0) return status;
    ready[dev] = true;
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  depth_to_normal_kernel<K><<<grid, kThreads, Tile<K>::Bytes, stream>>>(
      depth, kinv, out, H, W, row_offset, vmin, vmax, det_eps, norm_eps);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory of one block at window k: the masked points, then the raw
// depth or, once the points are formed, the 9 x kTileH rows of vertical
// sums (Tile<K>::Bytes for the unrolled instances).
__host__ __device__ constexpr size_t shared_bytes(int k) {
  const int r = k / 2;
  const size_t sh = kTileH + 2 * r;
  const size_t pitch = (kTileW + 2 * r + 3) / 4 * 4;
  const size_t stage = sh * pitch;
  const size_t vsum = 9 * kTileH * pitch;
  return (3 * stage + (stage > vsum ? stage : vsum)) * sizeof(float);
}
static_assert(shared_bytes(9) == Tile<9>::Bytes && shared_bytes(17) == Tile<17>::Bytes,
              "one layout for both forms");

// Odd k > kMaxK: Tile<K>'s layout with k at run time. Each thread forms a
// window's monomials from the staged points as it sums them (the unrolled
// form keeps them in registers), so a product is taken k times, not once;
// every product and sum rounds as in the plain version.
__global__ void __launch_bounds__(kThreads) depth_to_normal_any(
    const float* __restrict__ depth, const float* __restrict__ kinv,
    float* __restrict__ out, int H, int W, int K, int row_offset, float vmin, float vmax,
    float det_eps, float norm_eps) {
  const int R = K / 2;
  const int SH = kTileH + 2 * R;
  const int SW = kTileW + 2 * R;
  const int Pitch = (SW + 3) / 4 * 4;
  const int Stage = SH * Pitch;
  extern __shared__ __align__(16) float smem[];
  float* px = smem;
  float* py = px + Stage;
  float* pz = py + Stage;
  float* raw = pz + Stage;
  float* vsum = raw;

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const float* d_img = depth + static_cast<size_t>(b) * H * W;

  for (int i = tid; i < SH * SW; i += kThreads) {
    const int yy = i / SW;
    const int xx = i - yy * SW;
    const int gy = row0 - R + yy;
    const int gx = col0 - R + xx;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    copy4_async(raw + yy * Pitch + xx, inside ? d_img + static_cast<size_t>(gy) * W + gx : d_img,
                inside);
  }
  wait_async_copies();
  __syncthreads();

  const float* Kb = kinv + 9 * b;
  const float k0 = Kb[0], k1 = Kb[1], k2 = Kb[2], k3 = Kb[3], k4 = Kb[4], k5 = Kb[5];
  const float k6 = Kb[6], k7 = Kb[7], k8 = Kb[8];
  for (int i = tid; i < SH * SW; i += kThreads) {
    const int yy = i / SW;
    const int xx = i - yy * SW;
    const int at = yy * Pitch + xx;
    const float d = raw[at];
    float X = 0.0f, Y = 0.0f, Z = 0.0f;
    if (d > vmin && d < vmax) {
      const float u = static_cast<float>(col0 - R + xx);
      const float v = static_cast<float>(row0 - R + yy + row_offset);
      X = mul(add(add(mul(k0, u), mul(k1, v)), k2), d);
      Y = mul(add(add(mul(k3, u), mul(k4, v)), k5), d);
      Z = mul(add(add(mul(k6, u), mul(k7, v)), k8), d);
    }
    px[at] = X;
    py[at] = Y;
    pz[at] = Z;
  }
  __syncthreads();

  // vertical k-tap sums: one (staged column, output row) a thread
  for (int i = tid; i < SW * kTileH; i += kThreads) {
    const int xx = i % SW;
    const int r = i / SW;
    for (int j = 0; j < 9; ++j) {
      float acc = 0.0f;
      for (int t = 0; t < K; ++t) {
        const int at = (r + t) * Pitch + xx;
        acc = add(acc, monomial(j, px[at], py[at], pz[at]));
      }
      vsum[(j * kTileH + r) * Pitch + xx] = acc;
    }
  }
  __syncthreads();

  const int ty = tid / (kTileW / kRun);
  const int tx = (tid % (kTileW / kRun)) * kRun;
  const int gy = row0 + ty;
  const int gx = col0 + tx;
  if (gy >= H || gx >= W) return;
  float s[kRun][9];
  for (int j = 0; j < 9; ++j) {
    const float* row = vsum + (j * kTileH + ty) * Pitch + tx;
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      float acc = 0.0f;
      for (int t = 0; t < K; ++t) acc = add(acc, row[o + t]);
      s[o][j] = acc;
    }
  }
  float3 n[kRun];
#pragma unroll
  for (int o = 0; o < kRun; ++o) n[o] = solve(s[o], det_eps, norm_eps);
  float* o_row = out + ((static_cast<size_t>(b) * H + gy) * W + gx) * 3;
  if (W % 2 == 0 && gx + kRun <= W) {
    float2* o2 = reinterpret_cast<float2*>(o_row);
    o2[0] = make_float2(n[0].x, n[0].y);
    o2[1] = make_float2(n[0].z, n[1].x);
    o2[2] = make_float2(n[1].y, n[1].z);
  } else {
#pragma unroll
    for (int o = 0; o < kRun; ++o) {
      if (gx + o < W) {
        o_row[3 * o] = n[o].x;
        o_row[3 * o + 1] = n[o].y;
        o_row[3 * o + 2] = n[o].z;
      }
    }
  }
}

int launch_any(const float* depth, const float* kinv, float* out, int B, int H, int W, int k,
               int row_offset, float vmin, float vmax, float det_eps, float norm_eps,
               cudaStream_t stream) {
  static size_t allowed[kMaxDevices];  // the opt-in size set so far, per device
  int dev = 0;
  int status = static_cast<int>(cudaGetDevice(&dev));
  if (status != 0) return status;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int optin = 0;
  status = static_cast<int>(
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (status != 0) return status;
  const size_t bytes = shared_bytes(k);
  if (bytes > static_cast<size_t>(optin)) return static_cast<int>(cudaErrorInvalidValue);
  if (bytes > allowed[dev]) {
    status = static_cast<int>(cudaFuncSetAttribute(
        depth_to_normal_any, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
    if (status != 0) return status;
    allowed[dev] = bytes;
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  depth_to_normal_any<<<grid, kThreads, bytes, stream>>>(depth, kinv, out, H, W, k, row_offset,
                                                         vmin, vmax, det_eps, norm_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// depth: [B, H, W] f32, rows from global row row_offset on; kinv: [B, 3, 3]
// f32; out: [B, H, W, 3] f32, all contiguous; k odd, unrolled up to kMaxK,
// k-generic above while its tile fits the block's shared memory
// (cnm_depth_to_normal_shared_bytes). Returns cudaGetLastError() after the
// launch.
extern "C" int cnm_depth_to_normal(const float* depth, const float* kinv, float* out,
                                   int B, int H, int W, int k, int row_offset, float vmin,
                                   float vmax, float det_eps, float norm_eps,
                                   cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || k < 1 || k % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (k > kMaxK)
    return launch_any(depth, kinv, out, B, H, W, k, row_offset, vmin, vmax, det_eps, norm_eps,
                      stream);
  switch (k) {
#define CNM_CASE(KK) \
  case KK:           \
    return launch<KK>(depth, kinv, out, B, H, W, row_offset, vmin, vmax, det_eps, norm_eps, \
                      stream);
    CNM_CASE(1) CNM_CASE(3) CNM_CASE(5) CNM_CASE(7) CNM_CASE(9)
    CNM_CASE(11) CNM_CASE(13) CNM_CASE(15) CNM_CASE(17)
#undef CNM_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block at window k (0 for an even or
// non-positive k): what the wrapper holds against the device's opt-in limit.
extern "C" size_t cnm_depth_to_normal_shared_bytes(int k) {
  return k < 1 || k % 2 == 0 ? 0 : shared_bytes(k);
}

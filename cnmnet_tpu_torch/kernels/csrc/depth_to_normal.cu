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
// Odd k above 17 take one k-generic instance (depth_to_normal_any): the
// same output tiles and the same tap order (vertical pass then
// horizontal, each window summed first to last from 0), with k read at run
// time, so it too equals the plain version bit for bit. It walks the
// tile's staged columns in pieces of 128 and keeps one piece's vertical
// sums in shared memory (36,864 B at any k), so it takes every odd k.
// Any H and W; B up to 65,535 a launch (the grid's z extent: the wrapper
// splits a larger batch).

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
constexpr int kMaxBatch = 65535;  // maps a launch: the grid's z extent
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

// Odd k > kMaxK: one k-generic instance whose shared memory does not
// depend on k. The block keeps the unrolled form's 64 x 8 output tile and
// walks its staged columns (64 + k - 1 of them) in pieces of kPiece, left
// to right. For each piece:
//
// 1. Vertical pass. Thread (column, segment) walks its staged column down
//    from the first row of its segment's kSegRows output rows, reading the
//    depth straight from global memory (a warp reads 32 adjacent columns
//    of one row; 0 outside the image, as cp.async fills it), forms the
//    point and its 9 monomials once, and adds them to the running sums of
//    every output row of the segment whose window holds that row. Rows
//    arrive top to bottom, so each window sum adds its k taps first to
//    last, from 0; the 9 x kSegRows sums live in registers.
// 2. The piece's 9 x kTileH x kPiece vertical sums go to shared memory.
// 3. Horizontal pass. A thread owns kRun adjacent outputs of a row and
//    adds the piece's columns that lie in each window, left to right, to
//    running sums kept in registers across the pieces.
//
// So every product is taken once per point and segment, as in the unrolled
// form, the taps of every window sum are added in the plain version's
// order, and the block's shared memory is 9 x kTileH x kPiece floats at
// any k (shared_bytes).
constexpr int kPiece = 128;                 // staged columns a piece
constexpr int kSegs = kThreads / kPiece;    // vertical segments a column
constexpr int kSegRows = kTileH / kSegs;    // output rows a segment
static_assert(kSegs * kPiece == kThreads && kSegs * kSegRows == kTileH,
              "one (column, segment) a thread in the vertical pass");
constexpr size_t kAnyBytes = 9 * kTileH * kPiece * sizeof(float);

// Shared memory of one block at window k: for the unrolled instances the
// masked points, then the raw depth or, once the points are formed, the
// 9 x kTileH rows of vertical sums (Tile<K>::Bytes); above kMaxK one
// piece's vertical sums.
__host__ __device__ constexpr size_t shared_bytes(int k) {
  const int r = k / 2;
  const size_t sh = kTileH + 2 * r;
  const size_t pitch = (kTileW + 2 * r + 3) / 4 * 4;
  const size_t stage = sh * pitch;
  const size_t vsum = 9 * kTileH * pitch;
  return k > kMaxK ? kAnyBytes : (3 * stage + (stage > vsum ? stage : vsum)) * sizeof(float);
}
static_assert(shared_bytes(9) == Tile<9>::Bytes && shared_bytes(17) == Tile<17>::Bytes,
              "one layout for both forms");

__global__ void __launch_bounds__(kThreads) depth_to_normal_any(
    const float* __restrict__ depth, const float* __restrict__ kinv,
    float* __restrict__ out, int H, int W, int K, int row_offset, float vmin, float vmax,
    float det_eps, float norm_eps) {
  extern __shared__ __align__(16) float vsum[];  // [9][kTileH][kPiece]
  const int R = K / 2;
  const int SW = kTileW + 2 * R;  // staged columns
  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  const int tid = threadIdx.x;
  const float* d_img = depth + static_cast<size_t>(b) * H * W;
  const float* Kb = kinv + 9 * b;
  const float k0 = Kb[0], k1 = Kb[1], k2 = Kb[2], k3 = Kb[3], k4 = Kb[4], k5 = Kb[5];
  const float k6 = Kb[6], k7 = Kb[7], k8 = Kb[8];

  const int vc = tid % kPiece;                // the vertical pass's column in the piece
  const int vr0 = (tid / kPiece) * kSegRows;  // and its segment's first output row
  const int ty = tid / (kTileW / kRun);       // the horizontal pass's outputs
  const int tx = (tid % (kTileW / kRun)) * kRun;
  float s[kRun][9];
#pragma unroll
  for (int o = 0; o < kRun; ++o)
#pragma unroll
    for (int j = 0; j < 9; ++j) s[o][j] = 0.0f;

  for (int c0 = 0; c0 < SW; c0 += kPiece) {
    const int c = c0 + vc;  // staged column: global column col0 - R + c
    if (c < SW) {
      float acc[9][kSegRows];
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int q = 0; q < kSegRows; ++q) acc[j][q] = 0.0f;
      const int gx = col0 - R + c;
      const bool col_inside = gx >= 0 && gx < W;
      const float u = static_cast<float>(gx);
      // staged row vr0 + t; output row vr0 + q takes it as tap t - q
#pragma unroll 2
      for (int t = 0; t < kSegRows + K - 1; ++t) {
        const int gy = row0 - R + vr0 + t;
        const float d =
            col_inside && gy >= 0 && gy < H ? __ldg(d_img + static_cast<size_t>(gy) * W + gx) : 0.0f;
        float X = 0.0f, Y = 0.0f, Z = 0.0f;
        if (d > vmin && d < vmax) {
          const float v = static_cast<float>(gy + row_offset);
          X = mul(add(add(mul(k0, u), mul(k1, v)), k2), d);
          Y = mul(add(add(mul(k3, u), mul(k4, v)), k5), d);
          Z = mul(add(add(mul(k6, u), mul(k7, v)), k8), d);
        }
        float m[9];
#pragma unroll
        for (int j = 0; j < 9; ++j) m[j] = monomial(j, X, Y, Z);
#pragma unroll
        for (int q = 0; q < kSegRows; ++q) {
          if (t >= q && t < q + K) {
#pragma unroll
            for (int j = 0; j < 9; ++j) acc[j][q] = add(acc[j][q], m[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int q = 0; q < kSegRows; ++q) vsum[(j * kTileH + vr0 + q) * kPiece + vc] = acc[j][q];
    }
    __syncthreads();

    // output tx takes staged columns tx .. tx + K - 1, output tx + 1 the
    // next K; this piece holds columns c0 .. min(c0 + kPiece, SW) - 1
    const int lo = max(tx, c0);
    const int hi = min(tx + K, min(c0 + kPiece, SW) - 1);
    for (int cc = lo; cc <= hi; ++cc) {
      const float* col = vsum + ty * kPiece + (cc - c0);
      const bool first = cc < tx + K;
      const bool second = cc > tx;
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const float v = col[j * kTileH * kPiece];
        if (first) s[0][j] = add(s[0][j], v);
        if (second) s[1][j] = add(s[1][j], v);
      }
    }
    __syncthreads();  // the next piece overwrites vsum
  }

  const int gy = row0 + ty;
  const int gx = col0 + tx;
  if (gy >= H || gx >= W) return;
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
  static bool ready[kMaxDevices];
  int dev = 0;
  int status = static_cast<int>(cudaGetDevice(&dev));
  if (status != 0) return status;
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {  // needed only where a variant's tile passes 48 KB
    status = static_cast<int>(cudaFuncSetAttribute(
        depth_to_normal_any, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kAnyBytes)));
    if (status != 0) return status;
    ready[dev] = true;
  }
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, B);
  depth_to_normal_any<<<grid, kThreads, kAnyBytes, stream>>>(
      depth, kinv, out, H, W, k, row_offset, vmin, vmax, det_eps, norm_eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// depth: [B, H, W] f32, rows from global row row_offset on; kinv: [B, 3, 3]
// f32; out: [B, H, W, 3] f32, all contiguous; B at most kMaxBatch; k odd,
// unrolled up to kMaxK, k-generic above. Returns cudaGetLastError() after
// the launch.
extern "C" int cnm_depth_to_normal(const float* depth, const float* kinv, float* out,
                                   int B, int H, int W, int k, int row_offset, float vmin,
                                   float vmax, float det_eps, float norm_eps,
                                   cudaStream_t stream) {
  if (B <= 0 || B > kMaxBatch || H <= 0 || W <= 0 || k < 1 || k % 2 == 0)
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
// non-positive k): the wrapper's kernels/normals.shared_bytes, compared on the
// card.
extern "C" size_t cnm_depth_to_normal_shared_bytes(int k) {
  return k < 1 || k % 2 == 0 ? 0 : shared_bytes(k);
}

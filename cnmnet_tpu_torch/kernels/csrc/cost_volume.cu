// Plane-sweep cost volume for Hopper (sm_90a).
//
// Replaces the TPU kernel cnmnet_tpu/kernels/cost_volume_pallas.py
// (_cost_volume_pallas_jit, body _make_kernel). That kernel splits the warp
// into two resampling passes inside 128-lane windows because Mosaic has no
// general gather; a GPU gathers natively, so this is a direct bilinear
// kernel with the semantics of the plain version, ops/cost_volume.py.
//
// out[b, p, y, x] = sum_c | bilinear(src_b, warp_p(x, v))_c - ref_b[y, x, c] |
//   v            = y + row_offset,
//   warp_p(x, v) = (X / (Z + eps), Y / (Z + eps)),
//   (X, Y, Z)    = KRKi_b (x, v, 1) + KT_b * idepth[p],
// with the plain version's guard (|Z + eps| < eps -> eps), its clip of the
// coordinates to +-100 max(Hs, W) before the float->int conversion, and taps
// outside [0, W-1] x [0, Hs-1] counted as zero. No behind-camera mask.
//
// The reference rows and the output are H rows from global row row_offset
// of an image whose source has Hs rows: a row shard of the tiled cost
// volume (parallel/tiled_ops.py) passes its rows, their offset and the
// gathered source; the untiled call passes row_offset = 0 and Hs = H. Every
// cost depends on its global pixel and the source alone, so a shard's rows
// equal the untiled volume's rows bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32) at the serving shape,
// 2 pairs x 64 planes x 192 x 256 = 6.29 M outputs: the writes are 12.6 MB
// in bf16 (3.8 us) or 25.2 MB in f32 (7.5 us); the arithmetic is about 55
// f32 operations per output (5.2 us). What bounds this kernel in practice
// is the instructions each output issues (about 85, a fifth of them the
// two IEEE divisions with their slow-path checks) and the 64 bytes of taps
// the L1 returns for it, so the design cuts both:
//
// 1. Bordered four-channel source. A pack launch writes each source image
//    as [H + 4, W + 4] float4 (the colour, then 0) inside a 2-pixel border
//    of zeros (cnm_cost_volume's bsrc; 815 KB per pair at 192x256, so 16
//    pairs stay in the 50 MB L2). A tap is then one 16-byte load. Clamping
//    the left tap to x0 in [-2, W] and y0 in [-2, H] moves every tap the
//    plain version masks onto a border zero (a tap pair straddling the edge
//    keeps its inside tap), so no tap needs a bounds check or a branch.
//    The weights are >= 0 and the images finite, so a border tap adds
//    0 * w = +0, which is what the plain version adds for a masked tap.
//    The tap's index from the packed corner is an unsigned 32-bit number,
//    so the four taps take one 64-bit address and one 64-bit add.
// 2. Many gathers in flight. A thread computes two pixels for kPlanes
//    planes: it first locates every tap (the divisions and their branches),
//    then gathers and sums, so the 4 x 2 x kPlanes loads of an item can be
//    issued together; __launch_bounds__ lets it use the registers. The two
//    pixels of lane l are x = l and l + 32 of the warp's 64, so each gather
//    instruction reads the taps of 32 adjacent pixels, which lie on few
//    cache lines.
// 3. Packed stores. One shuffle with the neighbouring lane gives each lane
//    two adjacent costs, stored as one bf16x2 (or float2), so a warp writes
//    128 (256) contiguous bytes along W of the [B, P, H, W] volume the stem
//    conv reads.
// 4. Whole waves. The grid is persistent: as many blocks as fit on the card
//    at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each
//    walking (pair, row, W chunk, plane group) items. All index arithmetic
//    is 32-bit, so a launch stays below 2^31 elements of volume, reference
//    and packed source; the wrapper (kernels/cost_volume.py) covers a
//    larger volume in several launches, of whole pairs or of one pair's
//    planes, each writing its part of the one output.
// 5. No shared memory, so the launch asks for the L1 side of the carveout.
//
// The two quotients X / d and Y / d stay two IEEE divisions: one shared
// reciprocal with a correction step saved about 2% of the time on an H100
// (kernels/ablate.py), too little to rest exactness on it.
//
// What the rest of Hopper does not offer here: there is no product to
// contract (the cost is an L1 norm of a gather), so tensor cores and wgmma
// do not apply; and the source footprint of a tile of reference pixels over
// the planes is an epipolar band that depends on the cameras, not a box, so
// TMA cannot fetch it.
//
// The arithmetic uses the _rn intrinsics, which the compiler never
// contracts into FMAs: every step rounds where the plain PyTorch version
// rounds, in its order (taps, then channels, first to last), and both
// quotients are IEEE-rounded divisions, so both give the same costs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kPad = 2;       // zero border of the packed source
constexpr int kThreads = 128;
constexpr int kPx = 2;        // pixels per thread
constexpr int kChunk = kThreads * kPx;
constexpr int kPlanes = 8;    // planes per item
constexpr int kMinBlocks = 6; // per SM: caps registers at 85 a thread
constexpr int kPackThreads = 256;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kPackThreads) pack_source_kernel(
    const float* __restrict__ src, float4* __restrict__ bsrc, int B, int H, int W) {
  const int Hp = H + 2 * kPad, Wp = W + 2 * kPad;
  const int n = B * Hp * Wp;
  const int i = blockIdx.x * kPackThreads + threadIdx.x;
  if (i >= n) return;
  const int b = i / (Hp * Wp);
  const int r = i - b * Hp * Wp;
  const int y = r / Wp - kPad;
  const int x = r % Wp - kPad;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (y >= 0 && y < H && x >= 0 && x < W) {
    const float* s = src + ((b * H + y) * W + x) * 3;
    v = make_float4(__ldg(s), __ldg(s + 1), __ldg(s + 2), 0.0f);
  }
  bsrc[i] = v;
}

// (k0 * u + k1 * v) + k2, rounded at each step.
__device__ __forceinline__ float row_dot(const float* k, float u, float v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(k[0], u), __fmul_rn(k[1], v)), k[2]);
}

struct Pixel {
  float hx, hy, hz;  // KRKi (x, y, 1)
  float r0, r1, r2;  // reference colour
};

// Where a pixel samples the source on the plane of inverse depth id: the
// packed-source index of its top-left tap and the fractions.
struct Tap {
  unsigned idx;
  float fx, fy;
};

__device__ __forceinline__ Tap locate(const Pixel& px, float tx, float ty, float tz, float id,
                                      float bound, int Wp, int Hs, int W) {
  const float eps = 1e-6f;
  const float X = __fadd_rn(px.hx, __fmul_rn(tx, id));
  const float Y = __fadd_rn(px.hy, __fmul_rn(ty, id));
  const float Z = __fadd_rn(px.hz, __fmul_rn(tz, id));
  float denom = __fadd_rn(Z, eps);
  denom = fabsf(denom) < eps ? eps : denom;
  const float x = fminf(fmaxf(__fdiv_rn(X, denom), -bound), bound);
  const float y = fminf(fmaxf(__fdiv_rn(Y, denom), -bound), bound);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const int x0 = min(max(static_cast<int>(x0f), -kPad), W);
  const int y0 = min(max(static_cast<int>(y0f), -kPad), Hs);
  return {static_cast<unsigned>((y0 + kPad) * Wp + x0 + kPad), __fsub_rn(x, x0f),
          __fsub_rn(y, y0f)};
}

// The cost of one tap set; sb points at the packed source's corner.
__device__ __forceinline__ float tap_cost(const float4* __restrict__ sb, int Wp, const Tap& t,
                                          const Pixel& px) {
  const float4* q = sb + t.idx;
  // taps in the plain version's order: (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1)
  const float4 a = __ldg(q);
  const float4 b = __ldg(q + 1);
  const float4 c = __ldg(q + Wp);
  const float4 d = __ldg(q + Wp + 1);
  const float gx = __fsub_rn(1.0f, t.fx);
  const float gy = __fsub_rn(1.0f, t.fy);
  const float wa = __fmul_rn(gx, gy), wb = __fmul_rn(t.fx, gy);
  const float wc = __fmul_rn(gx, t.fy), wd = __fmul_rn(t.fx, t.fy);
  float w0 = __fmul_rn(a.x, wa), w1 = __fmul_rn(a.y, wa), w2 = __fmul_rn(a.z, wa);
  w0 = __fadd_rn(w0, __fmul_rn(b.x, wb));
  w1 = __fadd_rn(w1, __fmul_rn(b.y, wb));
  w2 = __fadd_rn(w2, __fmul_rn(b.z, wb));
  w0 = __fadd_rn(w0, __fmul_rn(c.x, wc));
  w1 = __fadd_rn(w1, __fmul_rn(c.y, wc));
  w2 = __fadd_rn(w2, __fmul_rn(c.z, wc));
  w0 = __fadd_rn(w0, __fmul_rn(d.x, wd));
  w1 = __fadd_rn(w1, __fmul_rn(d.y, wd));
  w2 = __fadd_rn(w2, __fmul_rn(d.z, wd));
  return __fadd_rn(__fadd_rn(fabsf(__fsub_rn(w0, px.r0)), fabsf(__fsub_rn(w1, px.r1))),
                   fabsf(__fsub_rn(w2, px.r2)));
}

// Two adjacent costs at out[i], out[i + 1] (i even): packed where both lie
// in the row and W is even, one by one otherwise.
__device__ __forceinline__ void store2(float* out, int i, float c0, float c1, bool packed,
                                       bool first, bool second) {
  if (packed) {
    *reinterpret_cast<float2*>(out + i) = make_float2(c0, c1);
  } else {
    if (first) out[i] = c0;
    if (second) out[i + 1] = c1;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, int i, float c0, float c1,
                                       bool packed, bool first, bool second) {
  if (packed) {
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(c0, c1);
  } else {
    if (first) out[i] = __float2bfloat16_rn(c0);
    if (second) out[i + 1] = __float2bfloat16_rn(c1);
  }
}

// Where the warp's lanes store: after one exchange with the neighbouring
// lane, an even lane l holds the costs of (base + l, base + l + 1) and an
// odd lane those of (base + 31 + l, base + 32 + l), so each lane stores one
// adjacent pair and the warp one contiguous run of 64 pixels.
struct Row {
  int at;  // index of the pair's first pixel on plane 0
  bool odd, first, second, packed;
};

// N planes from p0 on: every tap located first, then the loads and sums,
// so that the gathers of all N planes can be in flight together.
template <int N, typename OutT>
__device__ __forceinline__ void plane_costs(OutT* __restrict__ out, const float4* __restrict__ sb,
                                            const float* __restrict__ idepth,
                                            const Pixel (&px)[kPx], float tx, float ty,
                                            float tz, float bound, int p0, int Wp, int Hs,
                                            int W, int HW, const Row& row) {
  Tap t[N][kPx];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float id = __ldg(idepth + p0 + j);
#pragma unroll
    for (int k = 0; k < kPx; ++k) t[j][k] = locate(px[k], tx, ty, tz, id, bound, Wp, Hs, W);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float lo = tap_cost(sb, Wp, t[j][0], px[0]);
    const float hi = tap_cost(sb, Wp, t[j][1], px[1]);
    const float got = __shfl_xor_sync(0xffffffffu, row.odd ? lo : hi, 1);
    store2(out, row.at + (p0 + j) * HW, row.odd ? got : lo, row.odd ? hi : got, row.packed,
           row.first, row.second);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) cost_volume_kernel(
    const float* __restrict__ ref, const float4* __restrict__ bsrc,
    const float* __restrict__ coef, const float* __restrict__ idepth,
    OutT* __restrict__ out, int B, int H, int W, int P, int Hs, int row_offset) {
  const int chunks = (W + kChunk - 1) / kChunk;
  const int groups = (P + kPlanes - 1) / kPlanes;
  const int items = B * H * chunks * groups;
  const int Wp = W + 2 * kPad;
  const int HW = H * W;
  const float bound = 100.0f * static_cast<float>(max(Hs, W));

  // plane groups vary fastest: the blocks resident at one time work on
  // neighbouring rows of one pair, whose source bands overlap in L2
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int t = item;
    const int g = t % groups;
    t /= groups;
    const int chunk = t % chunks;
    t /= chunks;
    const int y = t % H;
    const int b = t / H;
    // lane l of a warp takes x = base + l and base + 32 + l: each gather
    // instruction covers 32 adjacent pixels, whose taps share cache lines
    const int lane = threadIdx.x % 32;
    const int base = chunk * kChunk + (threadIdx.x / 32) * 64;
    if (base >= W) continue;  // the whole warp
    const int xs[kPx] = {base + lane, base + 32 + lane};

    const float* c = coef + 12 * b;  // KRKi row-major (9), then KT (3)
    const float tx = __ldg(c + 9), ty = __ldg(c + 10), tz = __ldg(c + 11);
    const float v = static_cast<float>(y + row_offset);
    Pixel px[kPx];
#pragma unroll
    for (int k = 0; k < kPx; ++k) {
      const float u = static_cast<float>(xs[k]);
      px[k].hx = row_dot(c + 0, u, v);
      px[k].hy = row_dot(c + 3, u, v);
      px[k].hz = row_dot(c + 6, u, v);
      const float* r = ref + (b * HW + y * W + min(xs[k], W - 1)) * 3;
      px[k].r0 = __ldg(r);
      px[k].r1 = __ldg(r + 1);
      px[k].r2 = __ldg(r + 2);
    }
    Row row;
    row.odd = lane & 1;
    const int x = row.odd ? base + 31 + lane : base + lane;
    row.at = b * P * HW + y * W + x;
    row.first = x < W;
    row.second = x + 1 < W;
    row.packed = row.second && (W % 2 == 0);
    const float4* sb = bsrc + b * (Hs + 2 * kPad) * Wp;
    const int p0 = g * kPlanes;
    if (p0 + kPlanes <= P) {
      plane_costs<kPlanes>(out, sb, idepth, px, tx, ty, tz, bound, p0, Wp, Hs, W, HW, row);
    } else {
      for (int p = p0; p < P; ++p)
        plane_costs<1>(out, sb, idepth, px, tx, ty, tz, bound, p, Wp, Hs, W, HW, row);
    }
  }
}

// Persistent grid for one output type on the current device: blocks that
// fit at once on every SM, found once per device.
template <typename OutT>
int persistent_blocks(int* status) {
  static int blocks[kMaxDevices];
  int dev = 0;
  *status = static_cast<int>(cudaGetDevice(&dev));
  if (*status != 0 || dev >= kMaxDevices) return 0;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    *status = static_cast<int>(cudaFuncSetAttribute(
        cost_volume_kernel<OutT>, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxL1)));
    if (*status == 0)
      *status = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
    if (*status == 0)
      *status = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, cost_volume_kernel<OutT>, kThreads, 0));
    if (*status != 0) return 0;
    blocks[dev] = sms * per_sm;
  }
  return blocks[dev];
}

template <typename OutT>
int launch(const float* ref, const float* src, float* bsrc, const float* coef,
           const float* idepth, OutT* out, int B, int H, int W, int P, int Hs, int row_offset,
           cudaStream_t stream) {
  const int packed = B * (Hs + 2 * kPad) * (W + 2 * kPad);
  pack_source_kernel<<<(packed + kPackThreads - 1) / kPackThreads, kPackThreads, 0, stream>>>(
      src, reinterpret_cast<float4*>(bsrc), B, Hs, W);
  int status = static_cast<int>(cudaGetLastError());
  if (status != 0) return status;
  const int items = B * H * ((W + kChunk - 1) / kChunk) * ((P + kPlanes - 1) / kPlanes);
  const int grid = std::min(items, persistent_blocks<OutT>(&status));
  if (status != 0) return status;
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cost_volume_kernel<OutT><<<grid, kThreads, 0, stream>>>(
      ref, reinterpret_cast<const float4*>(bsrc), coef, idepth, out, B, H, W, P, Hs, row_offset);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ref: [B, H, W, 3] f32 contiguous, the rows from global row row_offset on;
// src: [B, Hs, W, 3] f32 contiguous, the whole source; bsrc: scratch of
// B (Hs + 4) (W + 4) x 4 f32, 16-byte aligned (the packed source); coef:
// [B, 12] f32; idepth: [P] f32; out: [B, P, H, W], f32 or (out_bf16 != 0)
// bf16. The caller keeps B * P * H * W, B * H * W * 3 and the scratch's
// size below 2^31. Two launches (pack, then costs) on `stream`; returns the
// first non-zero cudaGetLastError(), checked after each.
extern "C" int cnm_cost_volume(const float* ref, const float* src, float* bsrc,
                               const float* coef, const float* idepth, void* out, int B, int H,
                               int W, int P, int Hs, int row_offset, int out_bf16,
                               cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || P <= 0 || Hs <= 0 || row_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16)
    return launch(ref, src, bsrc, coef, idepth, static_cast<__nv_bfloat16*>(out), B, H, W, P, Hs,
                  row_offset, stream);
  return launch(ref, src, bsrc, coef, idepth, static_cast<float*>(out), B, H, W, P, Hs,
                row_offset, stream);
}

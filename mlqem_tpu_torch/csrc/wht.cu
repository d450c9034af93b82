// Walsh-Hadamard transform over device-memory planes, for Hopper (sm_90a).
//
// Replaces mlqem_tpu/ops/pallas/wht.py::wht_pallas_planes (body
// _wht_kernel): H^{(x)w} on every row of the re and im planes
// [rows, 2^w] f32, as w butterfly stages of +-1/sqrt(2) pairs in order of
// the bit (0 first), the same arithmetic as the plain butterfly.
//
// What bounds it here: H is real, so the two planes are 2*rows independent
// real transforms with ~2 flops per element per stage, 42 flops per element
// at w=21 against 8 bytes moved: device-memory bandwidth bounds it. At the
// light-cone engine's w=21 one row is 8 MB per plane and cannot sit in
// shared memory, so the transform runs in passes over device memory: one
// low pass (bits 0..12 of 8192 contiguous floats) and ceil((w - 13) / 8)
// high passes (8 strided bits each), two passes at w=21. Each pass reads
// and writes the planes once; two passes are the floor of any design here.
//
// What the design does about it. A pass walks 32 KB tiles (8192 floats,
// tile bits 0..12) with persistent blocks over (plane, row, tile):
// - Loads are in flight while a tile computes: each block keeps a ring of
//   kRing = 4 tiles in dynamic shared memory, filled by 16-byte cp.async
//   copies 3 tiles ahead of the one it transforms.
// - The butterflies run in registers. In layout A each thread holds 8
//   float4 (32 floats): tile bits 0-1 lie in a float4, 5-7 across the
//   thread's 8 float4, 2-4 and 8-9 across lanes (warp shuffles), 10-12
//   across warps. One exchange through the tile's own shared memory then
//   gives layout B, where tile bits 10-12 lie across the thread's registers.
//   So a tile costs 10 register/shuffle stages, 1 exchange and 3 more
//   register stages, against one barrier per stage before.
// - Every shared-memory access is a float4 whose quarter warp reads or
//   writes 128 contiguous bytes (no bank conflicts), and stores to device
//   memory are float4 of whole 128-byte lines.
// In the low pass the tile is 8192 contiguous floats (several rows when
// w < 13; the ragged end of a plane is zero-filled and not stored). In a
// high pass over bits lo..lo+k-1 a tile is 2^k strided rows (tile bits
// 5..4+k) by 2^(13-k) contiguous floats, as in the JAX kernel's
// [2^k, lanes] blocks: tile bits 0-4 are columns and take no stage.
// Stages run in the plain butterfly's order (bit 0 first) with its
// per-stage 1/sqrt(2), so the result equals the plain version bit for bit.
// Tiles of one pass are disjoint, so the transform runs in place.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLogTile = 13;               // 8192 floats = 32 KB a tile
constexpr int kTile = 1 << kLogTile;
constexpr int kColBits = 5;                // high pass: tile bits 0-4 are columns
constexpr int kHighBits = kLogTile - kColBits;   // stages per high pass (8)
constexpr int kThreads = 256;
constexpr int kVec = kTile / 4 / kThreads;       // float4 per thread (8)
constexpr int kRing = 4;                   // 128 KB: one block per SM
constexpr size_t kSmemBytes = sizeof(float) * kTile * kRing;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

// One pass: tile bits [sb0, sb1) are transformed, tile bit b standing for
// element bit b (low pass, lo = 0) or lo + b - kColBits (high pass).
struct Pass {
  float* re;
  float* im;
  long long n;        // floats per plane
  long long tiles;    // tiles per plane
  int w, lo, k, sb0, sb1;
};

__device__ __forceinline__ void bfly(float& a, float& b) {
  const float x = a, y = b;
  a = (x + y) * kInvSqrt2;
  b = (x - y) * kInvSqrt2;
}

__device__ __forceinline__ void bfly4(float4& a, float4& b) {
  bfly(a.x, b.x);
  bfly(a.y, b.y);
  bfly(a.z, b.z);
  bfly(a.w, b.w);
}

// Partner across lanes (xor m): the lane holding the lower element keeps
// (x + y) / sqrt(2), the upper one (y - x) / sqrt(2), as bfly does.
__device__ __forceinline__ float shfl_bfly(float x, int m, bool upper) {
  const float y = __shfl_xor_sync(0xffffffffu, x, m);
  return upper ? (y - x) * kInvSqrt2 : (x + y) * kInvSqrt2;
}

__device__ __forceinline__ void shfl_stage(float4 (&v)[kVec], int m,
                                           int lane) {
  const bool upper = lane & m;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    v[e].x = shfl_bfly(v[e].x, m, upper);
    v[e].y = shfl_bfly(v[e].y, m, upper);
    v[e].z = shfl_bfly(v[e].z, m, upper);
    v[e].w = shfl_bfly(v[e].w, m, upper);
  }
}

// Butterflies between registers v[e] and v[e | 1 << q].
__device__ __forceinline__ void reg_stage(float4 (&v)[kVec], int q) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    if (!(e & (1 << q))) bfly4(v[e], v[e | (1 << q)]);
  }
}

// First element of tile u of a plane.
__device__ __forceinline__ long long tile_origin(const Pass& P, long long u) {
  if (P.lo == 0) return u * kTile;
  const int cb = kLogTile - P.k;          // contiguous bits of a tile row
  const int mid_bits = P.lo - cb;
  const long long row = u >> (P.w - kLogTile);
  const long long g = u & ((1ll << (P.w - kLogTile)) - 1);
  return (row << P.w) | ((g >> mid_bits) << (P.lo + P.k)) |
         ((g & ((1ll << mid_bits) - 1)) << cb);
}

// Plane offset of tile element idx (a multiple of 4: a float4 stays
// contiguous in device memory).
__device__ __forceinline__ long long element(const Pass& P, long long origin,
                                             int idx) {
  if (P.lo == 0) return origin + idx;
  const int rho = idx >> kColBits;
  const int t = rho & ((1 << P.k) - 1);
  const int p = rho >> P.k;
  return origin + (static_cast<long long>(t) << P.lo) +
         ((p << kColBits) | (idx & ((1 << kColBits) - 1)));
}

__device__ __forceinline__ void plane_of(const Pass& P, long long tile,
                                         float** plane, long long* u) {
  *plane = tile < P.tiles ? P.re : P.im;
  *u = tile < P.tiles ? tile : tile - P.tiles;
}

// Start the 16-byte copies of `tile` into `slot` (zero-filled past the end
// of the plane).
__device__ __forceinline__ void load_tile(const Pass& P, long long tile,
                                          float* slot) {
  float* plane;
  long long u;
  plane_of(P, tile, &plane, &u);
  const long long origin = tile_origin(P, u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int idx = (threadIdx.x + j * kThreads) * 4;
    const long long g = element(P, origin, idx);
    const long long left = P.n - g;
    const int bytes = left >= 4 ? 16 : (left > 0 ? static_cast<int>(4 * left)
                                                 : 0);
    const unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(slot + idx));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(plane + (bytes ? g : 0)), "r"(bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kRing - 2 groups of this thread's copies are pending.
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
}

// Transform the tile in `slot` and store it to device memory.
__device__ __forceinline__ void transform_tile(const Pass& P, long long tile,
                                               float* slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float4 v[kVec];
  // layout A: element e of this thread at tile bits
  // 0-1 (in the float4), 2-4 (lane 0-2), 5-7 (e), 8-9 (lane 3-4), 10-12 (warp)
  const int a0 = ((lane & 7) << 2) | ((lane >> 3) << 8) | (warp << 10);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    v[e] = *reinterpret_cast<const float4*>(slot + a0 + (e << 5));
  }
  const auto on = [&P](int b) { return P.sb0 <= b && b < P.sb1; };
  if (on(0)) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      bfly(v[e].x, v[e].y);
      bfly(v[e].z, v[e].w);
    }
  }
  if (on(1)) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      bfly(v[e].x, v[e].z);
      bfly(v[e].y, v[e].w);
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (on(2 + q)) shfl_stage(v, 1 << q, lane);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (on(5 + q)) reg_stage(v, q);
  }
#pragma unroll
  for (int q = 3; q < 5; ++q) {
    if (on(5 + q)) shfl_stage(v, 1 << q, lane);
  }
  // exchange: each thread rewrites the places it read, then reads layout
  // B: element e at tile bits 0-1 (float4), 2-9 (thread), 10-12 (e)
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    *reinterpret_cast<float4*>(slot + a0 + (e << 5)) = v[e];
  }
  __syncthreads();
  const int b0 = threadIdx.x << 2;
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    v[e] = *reinterpret_cast<const float4*>(slot + b0 + (e << 10));
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (on(10 + q)) reg_stage(v, q);
  }
  float* plane;
  long long u;
  plane_of(P, tile, &plane, &u);
  const long long origin = tile_origin(P, u);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long g = element(P, origin, b0 + (e << 10));
    if (g + 4 <= P.n) {
      *reinterpret_cast<float4*>(plane + g) = v[e];
    } else {                               // the ragged end of a plane
      const float f[4] = {v[e].x, v[e].y, v[e].z, v[e].w};
      for (int c = 0; c < 4 && g + c < P.n; ++c) plane[g + c] = f[c];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2) wht_pass(Pass P) {
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  const long long total = 2 * P.tiles;
  const long long step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    const long long t = blockIdx.x + s * step;
    if (t < total) load_tile(P, t, ring + s * kTile);
    commit_copies();
  }
  int slot = 0;
  for (long long t = blockIdx.x; t < total; t += step) {
    wait_copies();        // this thread's copies of tile t have landed
    __syncthreads();      // everyone's have; the previous slot is free
    const long long next = t + (kRing - 1) * step;
    const int free_slot = slot == 0 ? kRing - 1 : slot - 1;
    if (next < total) load_tile(P, next, ring + free_slot * kTile);
    commit_copies();
    transform_tile(P, t, ring + slot * kTile);
    slot = slot == kRing - 1 ? 0 : slot + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

cudaError_t launch(const Pass& P, int grid_cap, cudaStream_t s) {
  const long long total = 2 * P.tiles;
  const unsigned grid = static_cast<unsigned>(total < grid_cap ? total
                                                               : grid_cap);
  wht_pass<<<grid, kThreads, kSmemBytes, s>>>(P);
  return cudaGetLastError();
}

}  // namespace

// H^{(x)w} on every row of re and im [rows, 2^w] (contiguous f32, 16-byte
// aligned, on the current device, distinct), in place, on `stream`: one
// low pass, then ceil((w - 13) / 8) high passes. Returns cudaGetLastError()
// after the launches (0 = ok). The caller checks 1 <= w <= 30.
extern "C" int wht_planes_launch(float* re, float* im, long long rows, int w,
                                 void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      wht_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, wht_pass, kThreads, kSmemBytes)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  const long long n = rows << w;
  const int k0 = w < kLogTile ? w : kLogTile;
  Pass P{re, im, n, (n + kTile - 1) / kTile, w, 0, k0, 0, k0};
  if ((err = launch(P, grid_cap, s)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  for (int lo = kLogTile; lo < w; lo += kHighBits) {
    const int k = w - lo < kHighBits ? w - lo : kHighBits;
    P = Pass{re, im, n, rows << (w - kLogTile), w, lo, k, kColBits,
             kColBits + k};
    if ((err = launch(P, grid_cap, s)) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  return 0;
}

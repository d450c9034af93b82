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
// shared memory the way the TPU kernel (and K1) hold a row.
//
// What the design does about it: the transform runs in passes over device
// memory, each doing up to 13 stages on a 32 KB tile in shared memory, so
// w=21 takes 2 passes (one read and one write of the planes each) instead
// of 21. The low pass takes bits 0..12 of 8192 contiguous floats (whole
// rows when w < 13). A high pass takes bits lo..lo+k-1 (k <= 8) on a
// [2^k x 2^(13-k)] tile: 2^k strided indices, each with 2^(13-k) >= 32
// contiguous low-bit neighbours, so every warp reads and writes whole
// 128-byte lines and the butterflies across the tile's rows are free of
// bank conflicts. Blocks loop over (plane, row, tile), so even a single row
// (the ideal arm) gives 2 * 2^(w-13) tiles to spread over the SMs. Tiles of
// one pass are disjoint, so the transform runs in place.
// Left for later: vector loads, a pipeline of tile loads (cp.async / TMA),
// and fusing the neighbouring phase multiplies into the passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLogTile = 13;               // 8192 floats = 32 KB per block
constexpr int kTile = 1 << kLogTile;
constexpr int kHighBits = 8;               // stages per high pass: >= 32 columns
constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

__device__ __forceinline__ void butterfly(float* a, float* b) {
  const float x = *a, y = *b;
  *a = (x + y) * kInvSqrt2;
  *b = (x - y) * kInvSqrt2;
}

// Bits 0..k-1 of every chunk of kTile consecutive floats of each plane
// (n floats per plane; a plane's last chunk is shorter when w < 13).
__global__ void __launch_bounds__(kThreads)
wht_low_pass(float* __restrict__ re, float* __restrict__ im, long long n,
             int k, long long chunks) {
  __shared__ float tile[kTile];
  for (long long t = blockIdx.x; t < 2 * chunks; t += gridDim.x) {
    float* plane = t < chunks ? re : im;
    const long long base = (t < chunks ? t : t - chunks) * kTile;
    const long long left = n - base;
    const int len = left < kTile ? static_cast<int>(left) : kTile;
    for (int i = threadIdx.x; i < len; i += kThreads) {
      tile[i] = plane[base + i];
    }
    __syncthreads();
    for (int q = 0; q < k; ++q) {
      const int low = (1 << q) - 1;
      for (int i = threadIdx.x; i < (len >> 1); i += kThreads) {
        const int a = ((i & ~low) << 1) | (i & low);
        butterfly(&tile[a], &tile[a | (1 << q)]);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < len; i += kThreads) {
      plane[base + i] = tile[i];
    }
    __syncthreads();
  }
}

// Bits lo..lo+k-1 of every row (2^w floats, w >= lo + k, lo >= 13). A tile
// is 2^k rows (the transformed bits) by 2^cb columns (bits 0..cb-1,
// cb = 13 - k); the tile index picks bits cb..lo-1 and lo+k..w-1.
__global__ void __launch_bounds__(kThreads)
wht_high_pass(float* __restrict__ re, float* __restrict__ im, long long rows,
              int w, int lo, int k) {
  __shared__ float tile[kTile];
  const int cb = kLogTile - k;
  const int mid_bits = lo - cb;
  const long long per_row = 1ll << (w - kLogTile);
  const long long per_plane = rows * per_row;
  for (long long t = blockIdx.x; t < 2 * per_plane; t += gridDim.x) {
    float* plane = t < per_plane ? re : im;
    const long long u = t < per_plane ? t : t - per_plane;
    const long long row = u >> (w - kLogTile);
    const long long g = u & (per_row - 1);
    const long long origin = (row << w) | ((g >> mid_bits) << (lo + k)) |
                             ((g & ((1ll << mid_bits) - 1)) << cb);
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      tile[e] = plane[origin + (static_cast<long long>(e >> cb) << lo) +
                      (e & ((1 << cb) - 1))];
    }
    __syncthreads();
    for (int s = 0; s < k; ++s) {
      const int low = (1 << s) - 1;
      for (int i = threadIdx.x; i < kTile / 2; i += kThreads) {
        const int pr = i >> cb, col = i & ((1 << cb) - 1);
        const int ra = ((pr & ~low) << 1) | (pr & low);
        butterfly(&tile[(ra << cb) | col], &tile[((ra | (1 << s)) << cb) | col]);
      }
      __syncthreads();
    }
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      plane[origin + (static_cast<long long>(e >> cb) << lo) +
            (e & ((1 << cb) - 1))] = tile[e];
    }
    __syncthreads();
  }
}

// Blocks for a grid-stride launch of `kernel` over `work` tiles.
template <typename Kernel>
cudaError_t grid_for(Kernel kernel, long long work, unsigned* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, 0)) != cudaSuccess) {
    return err;
  }
  const long long most = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<unsigned>(work < most ? work : most);
  return cudaSuccess;
}

}  // namespace

// H^{(x)w} on every row of re and im [rows, 2^w] (contiguous f32, on the
// current device, distinct), in place, on `stream`: one low pass, then
// ceil((w - 13) / 8) high passes. Returns cudaGetLastError() after the
// launches (0 = ok). The caller checks 1 <= w <= 30.
extern "C" int wht_planes_launch(float* re, float* im, long long rows, int w,
                                 void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = rows << w;
  const long long chunks = (n + kTile - 1) / kTile;
  unsigned grid = 0;
  cudaError_t err = grid_for(wht_low_pass, 2 * chunks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  wht_low_pass<<<grid, kThreads, 0, s>>>(re, im, n, w < kLogTile ? w : kLogTile,
                                         chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  for (int lo = kLogTile; lo < w; lo += kHighBits) {
    const int k = w - lo < kHighBits ? w - lo : kHighBits;
    err = grid_for(wht_high_pass, 2 * (rows << (w - kLogTile)), &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    wht_high_pass<<<grid, kThreads, 0, s>>>(re, im, rows, w, lo, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

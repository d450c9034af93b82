// One kicked-Ising Trotter step at 15-30 qubits for Hopper (sm_90a): K3's
// wide tier.
//
// Replaces mlqem_tpu/ops/pallas/fused_step.py::fused_trotter_step (body
// _step_kernel) where a row no longer fits on chip: csrc/fused_step.cu takes
// nq <= 14, this file nq 15-30. Each row is one trajectory, held as re and
// im planes [rows, 2^w] f32. The step applies
//   1. a Walsh-Hadamard transform H^{(x)w},
//   2. the RX phase    exp(i * theta_h/2 * (kick[row] . bit_pm[j, :])),
//   3. a Walsh-Hadamard transform,
//   4. the ZZ phase    exp(-i * theta_j[row]/2 * (bond[row] . bond_par[j,:])).
//
// What bounds it here: one read and one write of both planes (16 * 2^w
// bytes a row) against 2 WHTs of w stages and two complex rotations an
// amplitude, ~3 f32 operations a byte moved at w=21, under the card's f32
// balance of ~20: device-memory bandwidth bounds it. At w=21 a row is
// 16 MB, so the step cannot stay on chip and runs in passes over device
// memory.
//
// What the design does about it. H^{(x)w} = H_hi . H_lo over the tile split
// of csrc/wht.cu (K4): a low pass over amplitude bits 0-12 and high passes
// over groups of up to 8 bits above. A diagonal phase is elementwise within
// any tile, so the step H . D_rx . H . D_zz takes 2 * (high passes) + 1
// passes, each reading and writing both planes once:
//   - pass 1:      H_lo, from the inputs into the outputs;
//   - then:        H over each high group but the last, in place;
//   - middle pass: H over the last high group, the RX phase, H again;
//   - then:        the high groups in reverse order;
//   - last pass:   H_lo, then the ZZ phase.
// Three passes at w <= 21, five at 22-29 and seven at 30.
// - A tile holds both planes of the same 8192 amplitudes (64 KB), since a
//   phase mixes re and im. Persistent blocks of 256 threads walk the tiles
//   with a ring of 3 tiles (192 KB of shared memory) filled by 16-byte
//   cp.async copies two tiles ahead of the one being transformed.
// - The butterflies run in registers and warp shuffles in K4's layouts
//   (A: tile bits 0-1 in a float4, 2-4 and 8-9 across lanes, 5-7 across a
//   thread's 8 float4, 10-12 across warps; B after one exchange through
//   the tile's shared memory: 10-12 across the thread's float4). Each
//   stage scales by f32(1/sqrt(2)) as the plain butterfly does (K4's
//   arithmetic), so the step keeps the plain version's norm over many
//   steps: a WHT of w such stages is (1 - 1.7e-8)^w short of unitary, and
//   a step that scaled by 2^(-w/2) instead would drift from the plain
//   version by ~3.4e-8 * w a WHT.
// - Phases as in the chip tier (csrc/kicked_regs.cuh): with +-1 signs the
//   sign sum of amplitude x is n - 2 * popcount(mask(x) ^ neg(row)), so a
//   tile's row takes a table of n + 1 cos/sin values (w + 1 for RX, nb + 1
//   for ZZ), built once per tile by one warp. The per-amplitude masks are
//   built once from the +-1 tables by step_masks_launch (two 32-bit words
//   an amplitude, 16 MB at w=21, read through L2 by every row) and loaded
//   at a tile's start, so their latency hides behind the butterflies.
// - A row whose signs are not all +-1 sums them per amplitude, which gives
//   the plain version's result; any table entry other than +-1 makes every
//   pass write NaN, so a misuse cannot pass silently.
// Arithmetic is f32 throughout with full-precision sincosf (no fast math).
//
// Left for later: the floor of this split is 3 passes at w=21; one low pass
// holding 2^13 and one high pass holding 2^8 per tile, so the step cannot
// take fewer without larger tiles (a cluster's distributed shared memory).
// Several steps, and the per-step <Z_obs> of the light-cone engine, could
// share passes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLogTile = 13;               // 8192 amplitudes a tile
constexpr int kTile = 1 << kLogTile;
constexpr int kColBits = 5;        // high pass: tile bits 0-4 are columns
constexpr int kHighBits = kLogTile - kColBits;   // most bits a high pass takes
constexpr int kThreads = 256;
constexpr int kVec = kTile / 4 / kThreads;       // float4 per thread and plane
constexpr int kRing = 3;
constexpr size_t kSmemBytes = sizeof(float) * 2 * kTile * kRing;   // 192 KB
constexpr int kMaxSigns = 32;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

enum PhaseKind { kNoPhase = 0, kRxPhase = 1, kZzPhase = 2 };

// One pass over (row, tile). lo = 0: the low pass over amplitude bits
// 0..12; lo >= 13: a high pass over bits lo..lo+k-1, which sit at tile
// bits 5..4+k (tile bits 0-4 and 5+k..12 are amplitude bits 0..12-k).
struct Pass {
  const float* src_re;
  const float* src_im;
  float* re;                 // the outputs, written in every pass
  float* im;
  const uint32_t* masks;     // this pass's phase masks [2^w]
  const int* bad;            // nonzero: a table entry is not +-1
  const float* sgn;          // the phase's signs [rows, n]
  const float* theta_j;      // [rows]
  long long tiles;           // rows << (w - 13)
  int w, lo, k, sb0, sb1;    // tile bits [sb0, sb1) are transformed
  int twice;                 // H, phase, H (the middle pass)
  int phase, n;              // PhaseKind and the number of signs
  float scale;               // theta_h / 2 (RX); the ZZ scale is per row
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

__device__ __forceinline__ bool on(const Pass& P, int b) {
  return P.sb0 <= b && b < P.sb1;
}

// Layout A's stages (tile bits 0-9) on one plane.
__device__ __forceinline__ void stages_a(const Pass& P, float4 (&v)[kVec],
                                         int lane) {
  if (on(P, 0)) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      bfly(v[e].x, v[e].y);
      bfly(v[e].z, v[e].w);
    }
  }
  if (on(P, 1)) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      bfly(v[e].x, v[e].z);
      bfly(v[e].y, v[e].w);
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (on(P, 2 + q)) shfl_stage(v, 1 << q, lane);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (on(P, 5 + q)) reg_stage(v, q);
  }
#pragma unroll
  for (int q = 3; q < 5; ++q) {
    if (on(P, 5 + q)) shfl_stage(v, 1 << q, lane);
  }
}

// Layout B's stages (tile bits 10-12) on one plane.
__device__ __forceinline__ void stages_b(const Pass& P, float4 (&v)[kVec]) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (on(P, 10 + q)) reg_stage(v, q);
  }
}

// First amplitude of tile u (of all rows) in a plane.
__device__ __forceinline__ long long tile_origin(const Pass& P, long long u) {
  if (P.lo == 0) return u << kLogTile;
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

// Start the 16-byte copies of tile u's two planes into `slot`.
__device__ __forceinline__ void load_tile(const Pass& P, long long u,
                                          float* slot) {
  const long long origin = tile_origin(P, u);
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int idx = (threadIdx.x + j * kThreads) * 4;
    const long long g = element(P, origin, idx);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const unsigned dst = static_cast<unsigned>(
          __cvta_generic_to_shared(slot + c * kTile + idx));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"((c ? P.src_im : P.src_re) + g)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kRing - 2 groups of this thread's copies are pending.
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
}

// Both planes of this thread's float4 at tile places base + (e << shift).
__device__ __forceinline__ void read_slot(const float* slot, int base,
                                          int shift, float4 (&re)[kVec],
                                          float4 (&im)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    re[e] = *reinterpret_cast<const float4*>(slot + base + (e << shift));
    im[e] = *reinterpret_cast<const float4*>(slot + kTile + base +
                                             (e << shift));
  }
}

__device__ __forceinline__ void write_slot(float* slot, int base, int shift,
                                           const float4 (&re)[kVec],
                                           const float4 (&im)[kVec]) {
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    *reinterpret_cast<float4*>(slot + base + (e << shift)) = re[e];
    *reinterpret_cast<float4*>(slot + kTile + base + (e << shift)) = im[e];
  }
}

// The phase's per-row table, built by warp 0 for the tile's row.
struct RowTable {
  float2 cs[kMaxSigns + 1];   // (cos, sin)(scale * (n - 2m))
  float sgn[kMaxSigns];
  float scale;
  uint32_t neg;
  int signs;                  // every sign is +-1
};

__device__ __forceinline__ void build_table(const Pass& P, long long row,
                                            RowTable* tab, int lane) {
  const float scale =
      P.phase == kRxPhase ? P.scale : -0.5f * P.theta_j[row];
  const float s = lane < P.n ? P.sgn[row * P.n + lane] : 1.f;
  const uint32_t neg = __ballot_sync(0xffffffffu, s < 0.f);
  const int signs = __all_sync(0xffffffffu, (s == 1.f) | (s == -1.f));
  for (int m = lane; m <= P.n; m += 32) {
    float sn, c;
    sincosf(scale * static_cast<float>(P.n - 2 * m), &sn, &c);
    tab->cs[m] = make_float2(c, sn);
  }
  if (lane < P.n) tab->sgn[lane] = s;
  if (lane == 0) {
    tab->scale = scale;
    tab->neg = neg;
    tab->signs = signs;
  }
}

// (r + i i) <- (r + i i) (c + i s).
__device__ __forceinline__ void rotate(float& r, float& i, float2 cs) {
  const float x = r, y = i;
  r = x * cs.x - y * cs.y;
  i = x * cs.y + y * cs.x;
}

// A row whose signs are not all +-1: the phase of amplitude mask m from the
// signs themselves.
__device__ __forceinline__ float2 summed_phase(const RowTable* tab, int n,
                                               uint32_t m) {
  float dot = 0.f;
  for (int k = 0; k < n; ++k) {
    dot += ((m >> k) & 1u) ? -tab->sgn[k] : tab->sgn[k];
  }
  float sn, c;
  sincosf(tab->scale * dot, &sn, &c);
  return make_float2(c, sn);
}

// The phase on this thread's float4 of layout B, whose masks are mk. The
// branch is uniform over the block (one row a tile), and the table loop
// stays one run of code apart from the per-amplitude sums: a sign check
// inside the loop puts an unrolled sincosf slow path beside every lookup,
// which made the phase passes much slower.
__device__ __forceinline__ void apply_phase(const Pass& P, const RowTable* tab,
                                            const uint4 (&mk)[kVec],
                                            float4 (&re)[kVec],
                                            float4 (&im)[kVec]) {
  if (tab->signs) {
    const uint32_t neg = tab->neg;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      rotate(re[e].x, im[e].x, tab->cs[__popc(mk[e].x ^ neg)]);
      rotate(re[e].y, im[e].y, tab->cs[__popc(mk[e].y ^ neg)]);
      rotate(re[e].z, im[e].z, tab->cs[__popc(mk[e].z ^ neg)]);
      rotate(re[e].w, im[e].w, tab->cs[__popc(mk[e].w ^ neg)]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      rotate(re[e].x, im[e].x, summed_phase(tab, P.n, mk[e].x));
      rotate(re[e].y, im[e].y, summed_phase(tab, P.n, mk[e].y));
      rotate(re[e].z, im[e].z, summed_phase(tab, P.n, mk[e].z));
      rotate(re[e].w, im[e].w, summed_phase(tab, P.n, mk[e].w));
    }
  }
}

// Store both planes of this thread's float4 at tile places base + (e <<
// shift); NaN instead when the tables are bad.
__device__ __forceinline__ void store_tile(const Pass& P, long long origin,
                                           int base, int shift, bool bad,
                                           const float4 (&re)[kVec],
                                           const float4 (&im)[kVec]) {
  const float nan = __int_as_float(0x7fffffff);
  const float4 poison = make_float4(nan, nan, nan, nan);
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const long long g = element(P, origin, base + (e << shift));
    *reinterpret_cast<float4*>(P.re + g) = bad ? poison : re[e];
    *reinterpret_cast<float4*>(P.im + g) = bad ? poison : im[e];
  }
}

// Transform the tile in `slot` and store it to the outputs.
__device__ __forceinline__ void transform_tile(const Pass& P, long long u,
                                               float* slot, RowTable* tab,
                                               bool bad) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long origin = tile_origin(P, u);
  const int a0 = ((lane & 7) << 2) | ((lane >> 3) << 8) | (warp << 10);
  const int b0 = threadIdx.x << 2;
  // this thread's masks in layout B, loaded now for the phase below
  uint4 mk[kVec];
  if (P.phase != kNoPhase) {
    const long long dim_mask = (1ll << P.w) - 1;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const long long x = element(P, origin, b0 + (e << 10)) & dim_mask;
      mk[e] = *reinterpret_cast<const uint4*>(P.masks + x);
    }
    if (warp == 0) build_table(P, origin >> P.w, tab, lane);
  }
  float4 re[kVec], im[kVec];
  read_slot(slot, a0, 5, re, im);
  stages_a(P, re, lane);
  stages_a(P, im, lane);
  // exchange: each thread rewrites the places it read, then reads layout B
  write_slot(slot, a0, 5, re, im);
  __syncthreads();
  read_slot(slot, b0, 10, re, im);
  stages_b(P, re);
  stages_b(P, im);
  if (P.phase != kNoPhase) apply_phase(P, tab, mk, re, im);
  if (!P.twice) {
    store_tile(P, origin, b0, 10, bad, re, im);
    return;
  }
  stages_b(P, re);
  stages_b(P, im);
  write_slot(slot, b0, 10, re, im);
  __syncthreads();
  read_slot(slot, a0, 5, re, im);
  stages_a(P, re, lane);
  stages_a(P, im, lane);
  store_tile(P, origin, a0, 5, bad, re, im);
}

__global__ void __launch_bounds__(kThreads, 1) step_pass(Pass P) {
  extern __shared__ float4 ring4[];
  __shared__ RowTable tab;
  float* ring = reinterpret_cast<float*>(ring4);
  const bool bad = *P.bad != 0;
  const long long step = gridDim.x;
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    const long long t = blockIdx.x + s * step;
    if (t < P.tiles) load_tile(P, t, ring + s * 2 * kTile);
    commit_copies();
  }
  int slot = 0;
  for (long long t = blockIdx.x; t < P.tiles; t += step) {
    wait_copies();        // this thread's copies of tile t have landed
    __syncthreads();      // everyone's have; the previous slot is free
    const long long next = t + (kRing - 1) * step;
    const int free_slot = slot == 0 ? kRing - 1 : slot - 1;
    if (next < P.tiles) load_tile(P, next, ring + free_slot * 2 * kTile);
    commit_copies();
    transform_tile(P, t, ring + slot * 2 * kTile, &tab, bad);
    slot = slot == kRing - 1 ? 0 : slot + 1;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The per-amplitude masks of the +-1 tables: bit q of masks[j] is set where
// bit_pm[j, q] < 0, bit k of masks[dim + j] where bond_par[j, k] < 0.
__global__ void step_masks_kernel(const float* bit_pm, const float* bond_par,
                                  long long dim, int w, int nb,
                                  uint32_t* masks, int* bad) {
  int b = 0;
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < dim; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    uint32_t bm = 0, pm = 0;
    for (int q = 0; q < w; ++q) {
      const float v = bit_pm[j * w + q];
      bm |= static_cast<uint32_t>(v < 0.f) << q;
      b |= (v != 1.f) & (v != -1.f);
    }
    for (int k = 0; k < nb; ++k) {
      const float v = bond_par[j * nb + k];
      pm |= static_cast<uint32_t>(v < 0.f) << k;
      b |= (v != 1.f) & (v != -1.f);
    }
    masks[j] = bm;
    masks[dim + j] = pm;
  }
  if (b) atomicOr(bad, 1);
}

// Persistent blocks: as many as fit on the card, at most `work`.
cudaError_t grid_for(const void* kernel, int threads, size_t smem,
                     long long work, int* grid) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, threads, smem)) != cudaSuccess) {
    return err;
  }
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm
                                                                   : 1);
  *grid = static_cast<int>(work < cap ? work : cap);
  return cudaSuccess;
}

}  // namespace

// Build the masks of bit_pm [2^w, w] and bond_par [2^w, nb] (contiguous
// f32 on the current device) into masks [2 * 2^w + 1] int32: bit masks,
// parity masks, then a flag set to 1 when an entry is not +-1. Returns
// cudaGetLastError() after the launch (0 = ok). The caller checks
// 1 <= w <= 30 and 0 <= nb <= 32.
extern "C" int step_masks_launch(const float* bit_pm, const float* bond_par,
                                 int w, int nb, int* masks, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long dim = 1ll << w;
  uint32_t* words = reinterpret_cast<uint32_t*>(masks);
  cudaError_t err = cudaMemsetAsync(masks + 2 * dim, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = 0;
  if ((err = grid_for(reinterpret_cast<const void*>(step_masks_kernel), 256,
                      0, (dim + 255) / 256, &grid)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  step_masks_kernel<<<grid, 256, 0, s>>>(bit_pm, bond_par, dim, w, nb, words,
                                         masks + 2 * dim);
  return static_cast<int>(cudaGetLastError());
}

// One step on re_in/im_in [rows, 2^w] into re_out/im_out (contiguous f32,
// 16-byte aligned, on the current device; the outputs distinct from the
// inputs), on `stream`, with the masks of step_masks_launch: kick
// [rows, w]; bond [rows, nb]; theta_j [rows]. Returns cudaGetLastError()
// after the launches (0 = ok). The caller checks 15 <= w <= 30 and
// 0 <= nb <= 32.
extern "C" int fused_trotter_step_wide_launch(
    const float* re_in, const float* im_in, const float* kick,
    const float* bond, const float* theta_j, const int* masks,
    float* re_out, float* im_out, long long rows, int w, int nb,
    float theta_h, void* stream) {
  if (rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      step_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long dim = 1ll << w;
  const long long tiles = rows << (w - kLogTile);
  int grid = 0;
  if ((err = grid_for(reinterpret_cast<const void*>(step_pass), kThreads,
                      kSmemBytes, tiles, &grid)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const uint32_t* words = reinterpret_cast<const uint32_t*>(masks);
  // the high groups: ceil((w - 13) / 8) of nearly equal size
  const int high = w - kLogTile;
  const int groups = (high + kHighBits - 1) / kHighBits;
  int lo[4], k[4];
  for (int i = 0, at = kLogTile; i < groups; ++i) {
    k[i] = high / groups + (i < high % groups ? 1 : 0);
    lo[i] = at;
    at += k[i];
  }
  const auto run = [&](bool first, int g, int twice, int phase) {
    Pass P{first ? re_in : re_out, first ? im_in : im_out, re_out, im_out,
           phase == kZzPhase ? words + dim : words, masks + 2 * dim,
           phase == kZzPhase ? bond : kick, theta_j, tiles, w,
           g < 0 ? 0 : lo[g], g < 0 ? kLogTile : k[g],
           g < 0 ? 0 : kColBits, g < 0 ? kLogTile : kColBits + k[g], twice,
           phase, phase == kZzPhase ? nb : w, 0.5f * theta_h};
    step_pass<<<grid, kThreads, kSmemBytes, s>>>(P);
    return cudaGetLastError();
  };
  if ((err = run(true, -1, 0, kNoPhase)) != cudaSuccess) return err;
  for (int i = 0; i + 1 < groups; ++i) {
    if ((err = run(false, i, 0, kNoPhase)) != cudaSuccess) return err;
  }
  if ((err = run(false, groups - 1, 1, kRxPhase)) != cudaSuccess) return err;
  for (int i = groups - 2; i >= 0; --i) {
    if ((err = run(false, i, 0, kNoPhase)) != cudaSuccess) return err;
  }
  return static_cast<int>(run(false, -1, 0, kZzPhase));
}

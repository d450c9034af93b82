// Kicked-Ising Trotter steps with the state in registers, for Hopper
// (sm_90a): the device code of K1 (csrc/evolve.cu, which replaces
// mlqem_tpu/ops/pallas/evolve.py::evolve_fused) and K3 (csrc/fused_step.cu,
// which replaces mlqem_tpu/ops/pallas/fused_step.py::fused_trotter_step).
// Each row is one trajectory, held as re and im planes [rows, 2^nq] f32.
// For each of `steps` Trotter steps the row gets
//   1. a Walsh-Hadamard transform H^{(x)nq},
//   2. the RX phase    exp(i * theta_h/2 * (kick_s . bit_pm[:, j])),
//   3. a Walsh-Hadamard transform,
//   4. the ZZ phase    exp(-i * theta_j/2 * (bond_s . bond_par[:, j])).
// The +-1 tables are read through strides given at run time, so K1's
// [n, 2^nq] layout and K3's JAX layout [2^nq, n] share every instance.
//
// What bounds it here: per row one read and one write of 2 * 4 * 2^nq
// bytes against 2*steps WHTs of nq butterfly stages, i.e. the f32 adds of
// the butterflies and the shared-memory traffic that moves amplitudes
// between threads. Device memory bounds K3 on paper (one step: ~2.5 f32
// operations a byte, under the card's ~20), and bounds K1 at 4 steps only
// once the butterflies and the exchanges are cheap.
//
// What the design does about it:
// - The state lives in registers: each thread holds 32 amplitudes of a row
//   per plane (nq >= 5; below, a thread holds its whole row). Layout A puts
//   amplitude bits 0-4 in a thread's registers; layout Hi puts the bits
//   from `split` up (5 at nq <= 10, 10 above) there. A WHT is butterflies
//   in registers, one exchange A <-> Hi through shared memory (float2
//   re/im pairs, padded one word in 32: no bank conflicts), and more
//   butterflies in registers; at nq 11-14 bits 5-9 lie across the lanes of
//   a warp and go through warp shuffles. At nq <= 10 a row lies within one
//   warp (nq=10: one row a warp; fewer qubits: several rows), so a step
//   needs no block barrier; at nq 11-14 a row spans 2-16 warps and each
//   exchange takes one. Blocks have 256 threads, 512 at nq=14 (one row,
//   2^14 amplitudes, 32 a plane a thread).
// - The butterflies are unscaled (a + b, a - b); the 2^(-nq/2) of each WHT
//   is folded into the cos/sin of the phase that follows it.
// - Phases: with +-1 kick and bond signs, kick_s . bit_pm[:, j] equals
//   nq - 2 * popcount(neg(j) ^ kneg), so it takes nq + 1 values per row and
//   step (nb + 1 for ZZ). Those sincosf are computed once per row and phase
//   into a shared-memory table and looked up per amplitude; they equal the
//   per-amplitude values bit for bit, since the dot of +-1 values is an
//   exact integer. A row whose signs are not all +-1 sums them per
//   amplitude inside the kernel, so any input gives the plain version's
//   result.
// - The +-1 tables are turned once per persistent block into per-amplitude
//   sign masks in shared memory: two 32-bit words an amplitude (K1, whose
//   nb reaches 32), or one word holding both (PACKED: K3, nq + nb <= 30),
//   which keeps nq=14 at 198 KB of the 227 KB a block may use and lets two
//   nq=13 blocks share an SM. Any table entry other than +-1 makes the
//   kernel write NaN to every output, so a misuse cannot pass silently.
// Arithmetic is f32 throughout with full-precision sincosf (no fast math).
//
// Left for later: at nq 11-14 a block holds one row and waits at each
// exchange with nothing else in flight; loads of the next row could
// overlap the current one's butterflies. Rows that start at |0...0> (K1's
// callers) could skip the read of the planes, which changes K1's interface.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInvSqrt2 = 0.70710678118654752440f;

// Shared-memory index of amplitude j: one word of padding in 32.
__host__ __device__ constexpr int pad(int j) { return j + (j >> 5); }

struct Args {
  const float* re_in;
  const float* im_in;
  const float* kick;
  const float* bond;
  const float* theta_j;
  const float* bit_pm;     // entry (q, j) at q * bit_q + j * bit_j
  const float* bond_par;   // entry (k, j) at k * par_k + j * par_j
  float* re_out;
  float* im_out;
  long long rows;
  int nb, steps;
  float theta_h;
  int bit_q, bit_j, par_k, par_j;
};

template <int NQ>
struct Geo {
  static constexpr int THREADS = NQ > 13 ? 512 : 256;
  static constexpr int MIN_BLOCKS = NQ > 13 ? 1 : 2;
  static constexpr int XCHG_AMPS = THREADS * 32;  // amplitudes a block holds
  static constexpr int DIM = 1 << NQ;
  static constexpr int RB = NQ < 5 ? NQ : 5;     // register bits
  static constexpr int AMPS = 1 << RB;           // per thread and plane
  static constexpr int TB = NQ - RB;             // thread-in-row bits
  static constexpr int SPLIT = NQ <= 10 ? RB : 10;
  static constexpr int NTOP = NQ - SPLIT;        // bits >= SPLIT, in Hi registers
  static constexpr int MID = RB - NTOP;          // Hi register bits below them
  static constexpr int ROWS = THREADS >> TB;     // rows a block holds
  static constexpr int PD = pad(DIM);
  static constexpr bool XCHG = NQ > 5;
  // Amplitude of register e of thread tau of a row: tau << RB | e in
  // layout A, tau | hi(e) in layout Hi. Both are a per-thread base plus a
  // constant of the unrolled e, and so are their padded indices:
  // pad(x + e) = pad(x) + e for x a multiple of 32 (layout A, nq >= 5),
  // pad(x + tau + hi(e)) = pad(x + tau) + pad(hi(e)) (layout Hi).
  __host__ __device__ static constexpr int hi(int e) {
    return ((e >> MID) << SPLIT) | ((e & ((1 << MID) - 1)) << TB);
  }
  static size_t smem_bytes(int nb, bool packed) {
    return (XCHG ? sizeof(float2) * pad(XCHG_AMPS) : 0) +
           sizeof(float2) * ROWS * (NQ + nb + 2) +
           (packed ? 1 : 2) * sizeof(uint32_t) * PD;
  }
};

// Barrier among the threads of a row.
template <int NQ>
__device__ __forceinline__ void row_sync() {
  if constexpr (NQ > 10) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// Unscaled butterflies between registers e and e | 1 << q.
template <int N>
__device__ __forceinline__ void reg_stage(float (&re)[N], float (&im)[N],
                                          int q) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    if (!(e & (1 << q))) {
      const int f = e | (1 << q);
      const float ra = re[e], rb = re[f], ia = im[e], ib = im[f];
      re[e] = ra + rb;
      re[f] = ra - rb;
      im[e] = ia + ib;
      im[f] = ia - ib;
    }
  }
}

__device__ __forceinline__ float shfl_bfly(float x, int m, bool upper) {
  const float y = __shfl_xor_sync(0xffffffffu, x, m);
  return upper ? y - x : x + y;
}

// Layout A's stages: bits 0..RB-1 in registers, then (nq > 10) bits 5-9
// across the lanes.
template <int NQ>
__device__ __forceinline__ void a_stages(float (&re)[Geo<NQ>::AMPS],
                                         float (&im)[Geo<NQ>::AMPS],
                                         int lane) {
  using G = Geo<NQ>;
#pragma unroll
  for (int q = 0; q < G::RB; ++q) reg_stage(re, im, q);
  if constexpr (NQ > 10) {
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const bool upper = lane & (1 << q);
#pragma unroll
      for (int e = 0; e < G::AMPS; ++e) {
        re[e] = shfl_bfly(re[e], 1 << q, upper);
        im[e] = shfl_bfly(im[e], 1 << q, upper);
      }
    }
  }
}

// Layout Hi's stages: bits SPLIT..NQ-1, registers bits MID.. .
template <int NQ>
__device__ __forceinline__ void hi_stages(float (&re)[Geo<NQ>::AMPS],
                                          float (&im)[Geo<NQ>::AMPS]) {
  using G = Geo<NQ>;
#pragma unroll
  for (int i = 0; i < G::NTOP; ++i) reg_stage(re, im, G::MID + i);
}

// From layout Hi to A (TO_A) or back, through the block's exchange buffer.
template <int NQ, bool TO_A>
__device__ __forceinline__ void exchange(float (&re)[Geo<NQ>::AMPS],
                                         float (&im)[Geo<NQ>::AMPS],
                                         float2* xch, int rib, int tau) {
  using G = Geo<NQ>;
  if constexpr (G::XCHG) {
    const int rb = rib << NQ;
    float2* at_a = xch + pad(rb + (tau << G::RB));
    float2* at_hi = xch + pad(rb + tau);
#pragma unroll
    for (int e = 0; e < G::AMPS; ++e) {
      (TO_A ? at_hi[pad(G::hi(e))] : at_a[e]) = make_float2(re[e], im[e]);
    }
    row_sync<NQ>();
#pragma unroll
    for (int e = 0; e < G::AMPS; ++e) {
      const float2 z = TO_A ? at_a[e] : at_hi[pad(G::hi(e))];
      re[e] = z.x;
      im[e] = z.y;
    }
  }
}

__device__ __forceinline__ void rotate(float& r, float& i, float c, float s) {
  const float x = r, y = i;
  r = x * c - y * s;
  i = x * s + y * c;
}

// Multiply amplitude j by norm * exp(i * scale * sum_k (neg_k(j) ? -w_k :
// w_k)) for this thread's amplitudes (layout A or Hi); w = sgn[0..n-1].
// Layout A takes the RX phase (the bit masks), Hi the ZZ phase (the
// parity masks); PACKED masks hold the bit mask below bit NQ and the
// parity mask from bit NQ up.
template <int NQ, bool IN_A, bool PACKED>
__device__ __forceinline__ void phase(float (&re)[Geo<NQ>::AMPS],
                                      float (&im)[Geo<NQ>::AMPS],
                                      const uint32_t* masks, float2* tab,
                                      const float* sgn, int n, float scale,
                                      float norm, int tau) {
  using G = Geo<NQ>;
  uint32_t neg = 0;
  bool signs = true;
  for (int k = 0; k < n; ++k) {
    const float w = sgn[k];
    neg |= static_cast<uint32_t>(w < 0.f) << k;
    signs &= (w == 1.f) | (w == -1.f);
  }
  for (int m = tau; m <= n; m += 1 << G::TB) {
    float s, c;
    sincosf(scale * static_cast<float>(n - 2 * m), &s, &c);
    tab[m] = make_float2(c * norm, s * norm);
  }
  row_sync<NQ>();
  // this thread's masks: layout A from pad(tau << RB), Hi from pad(tau)
  const uint32_t* at = masks + pad(IN_A ? tau << G::RB : tau);
  const auto mask = [at](int e) {
    const uint32_t m = at[IN_A ? e : pad(G::hi(e))];
    if constexpr (PACKED) {
      return IN_A ? m & ((1u << NQ) - 1u) : m >> NQ;
    } else {
      return m;
    }
  };
  if (signs) {
#pragma unroll
    for (int e = 0; e < G::AMPS; ++e) {
      const float2 cs = tab[__popc(mask(e) ^ neg)];
      rotate(re[e], im[e], cs.x, cs.y);
    }
  } else {                                 // signs other than +-1
#pragma unroll
    for (int e = 0; e < G::AMPS; ++e) {
      const uint32_t m = mask(e);
      float dot = 0.f;
      for (int k = 0; k < n; ++k) dot += ((m >> k) & 1u) ? -sgn[k] : sgn[k];
      float s, c;
      sincosf(scale * dot, &s, &c);
      rotate(re[e], im[e], c * norm, s * norm);
    }
  }
}

template <int NQ, bool PACKED>
__global__ void __launch_bounds__(Geo<NQ>::THREADS, Geo<NQ>::MIN_BLOCKS)
    kicked_kernel(Args a) {
  using G = Geo<NQ>;
  extern __shared__ float2 smem2[];
  float2* xch = smem2;
  float2* tabs = xch + (G::XCHG ? pad(G::XCHG_AMPS) : 0);
  const int tab_len = NQ + a.nb + 2;
  uint32_t* bit_neg = reinterpret_cast<uint32_t*>(tabs + G::ROWS * tab_len);
  uint32_t* par_neg = PACKED ? bit_neg : bit_neg + G::PD;

  int bad = 0;
  for (int j = threadIdx.x; j < G::DIM; j += G::THREADS) {
    uint32_t bm = 0, pm = 0;
    for (int q = 0; q < NQ; ++q) {
      const float v = a.bit_pm[q * a.bit_q + j * a.bit_j];
      bm |= static_cast<uint32_t>(v < 0.f) << q;
      bad |= (v != 1.f) & (v != -1.f);
    }
    for (int k = 0; k < a.nb; ++k) {
      const float v = a.bond_par[k * a.par_k + j * a.par_j];
      pm |= static_cast<uint32_t>(v < 0.f) << k;
      bad |= (v != 1.f) & (v != -1.f);
    }
    if constexpr (PACKED) {
      bit_neg[pad(j)] = bm | pm << NQ;
    } else {
      bit_neg[pad(j)] = bm;
      par_neg[pad(j)] = pm;
    }
  }
  bad = __syncthreads_or(bad);

  const int rib = threadIdx.x >> G::TB;          // row in block
  const int tau = threadIdx.x & ((1 << G::TB) - 1);
  const int lane = threadIdx.x & 31;
  float2* rx_tab = tabs + rib * tab_len;
  float2* zz_tab = rx_tab + NQ + 1;
  const int nk = a.steps * NQ, nbs = a.steps * a.nb;
  const float half_th = 0.5f * a.theta_h;
  const float norm = ldexpf((NQ & 1) ? kInvSqrt2 : 1.f, -(NQ / 2));
  for (long long base = static_cast<long long>(blockIdx.x) * G::ROWS;
       base < a.rows; base += static_cast<long long>(gridDim.x) * G::ROWS) {
    const long long row = base + rib;
    const bool valid = row < a.rows;
    const long long rr = valid ? row : a.rows - 1;   // inputs to read
    const long long off = row * G::DIM + tau;     // + hi(e): layout Hi
    if (bad) {
      if (valid) {
        for (int e = 0; e < G::AMPS; ++e) {
          a.re_out[off + G::hi(e)] = __int_as_float(0x7fffffff);
          a.im_out[off + G::hi(e)] = __int_as_float(0x7fffffff);
        }
      }
      continue;
    }
    float re[G::AMPS], im[G::AMPS];
#pragma unroll
    for (int e = 0; e < G::AMPS; ++e) {
      const long long g = off + G::hi(e);
      re[e] = valid ? a.re_in[g] : 0.f;
      im[e] = valid ? a.im_in[g] : 0.f;
    }
    const float half_tj = -0.5f * a.theta_j[rr];
    const float* kick = a.kick + rr * nk;
    const float* bond = a.bond + rr * nbs;
    for (int s = 0; s < a.steps; ++s) {
      hi_stages<NQ>(re, im);
      exchange<NQ, true>(re, im, xch, rib, tau);
      a_stages<NQ>(re, im, lane);
      phase<NQ, true, PACKED>(re, im, bit_neg, rx_tab, kick + s * NQ, NQ,
                              half_th, norm, tau);
      a_stages<NQ>(re, im, lane);
      exchange<NQ, false>(re, im, xch, rib, tau);
      hi_stages<NQ>(re, im);
      phase<NQ, false, PACKED>(re, im, par_neg, zz_tab, bond + s * a.nb,
                               a.nb, half_tj, norm, tau);
    }
    if (valid) {
#pragma unroll
      for (int e = 0; e < G::AMPS; ++e) {
        const long long g = off + G::hi(e);
        a.re_out[g] = re[e];
        a.im_out[g] = im[e];
      }
    }
  }
}

// Launch on `stream` with persistent blocks, as many as fit on the card;
// returns cudaGetLastError() after the launch (0 = ok).
template <int NQ, bool PACKED>
int launch_kicked(const Args& a, cudaStream_t stream) {
  using G = Geo<NQ>;
  const size_t smem = G::smem_bytes(a.nb, PACKED);
  cudaError_t err = cudaFuncSetAttribute(
      kicked_kernel<NQ, PACKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kicked_kernel<NQ, PACKED>, G::THREADS, smem)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long groups = (a.rows + G::ROWS - 1) / G::ROWS;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > groups) grid = groups;
  kicked_kernel<NQ, PACKED>
      <<<static_cast<unsigned>(grid), G::THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

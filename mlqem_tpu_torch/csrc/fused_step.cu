// One kicked-Ising Trotter step for Hopper (sm_90a).
//
// Replaces mlqem_tpu/ops/pallas/fused_step.py::fused_trotter_step (body
// _step_kernel). Each row is one trajectory, held as re and im planes
// [rows, 2^nq] f32. The step applies
//   1. a Walsh-Hadamard transform H^{(x)nq},
//   2. the RX phase    exp(i * theta_h/2 * (kick[row] . bit_pm[j, :])),
//   3. a Walsh-Hadamard transform,
//   4. the ZZ phase    exp(-i * theta_j[row]/2 * (bond[row] . bond_par[j, :])).
// The tables keep the JAX layout: bit_pm [2^nq, nq], bond_par [2^nq, nb].
//
// What bounds it here: per row one read and one write of both planes
// (16 * 2^nq bytes) against 2 WHTs of nq stages and 2 * 2^nq sincosf. At
// nq=13 that is ~6.5 flops of butterflies and ~5 flops of phases (before
// sincosf's own cost) per byte moved, under the card's f32 balance of ~20:
// device-memory bandwidth bounds it on paper, and shared-memory traffic
// with a barrier per butterfly stage is what it meets first in practice.
//
// What the design does about it: as in K1 (csrc/evolve.cu, which runs all
// steps at once), a row sits in shared memory, each WHT is nq in-place
// butterfly stages with a barrier between stages, and the state is read
// once and written once. Blocks are persistent and loop over rows, so the
// +-1 tables are turned once per block into per-amplitude sign masks
// (16 bits each, so a 14-qubit row fits: 8 * 2^14 bytes of state plus
// 4 * 2^14 bytes of masks = 192 KB of the 227 KB a block may use); the
// exponents are then exact sums of +-signs, as the TPU kernel's f32 dot of
// +-1 values. Any table entry other than +-1 makes the kernel write NaN to
// every output. Arithmetic is f32 with full-precision sincosf (no fast
// math). It is its own entry point, not K1 with steps=1: the light-cone
// engine reads <Z> between steps.
// Left for later: several rows per block at small nq, warp-shuffle
// butterflies for the low stages, vector loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

__device__ __forceinline__ void wht_rows(float* re, float* im, int nq,
                                         int dim) {
  const int half = dim >> 1;
  for (int q = 0; q < nq; ++q) {
    const int low = (1 << q) - 1;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      const int a = ((i & ~low) << 1) | (i & low);
      const int b = a | (1 << q);
      const float ra = re[a], rb = re[b], ia = im[a], ib = im[b];
      re[a] = (ra + rb) * kInvSqrt2;
      re[b] = (ra - rb) * kInvSqrt2;
      im[a] = (ia + ib) * kInvSqrt2;
      im[b] = (ia - ib) * kInvSqrt2;
    }
    __syncthreads();
  }
}

// Multiply amplitude j by exp(i * scale * sum_k (neg_k(j) ? -w_k : w_k)),
// for the amplitudes this thread owns.
__device__ __forceinline__ void phase_rows(float* re, float* im,
                                           const uint16_t* neg,
                                           const float* w, int n,
                                           float scale, int dim) {
  for (int j = threadIdx.x; j < dim; j += blockDim.x) {
    const uint32_t m = neg[j];
    float dot = 0.f;
    for (int k = 0; k < n; ++k) {
      dot += ((m >> k) & 1u) ? -w[k] : w[k];
    }
    float s, c;
    sincosf(scale * dot, &s, &c);
    const float r = re[j], i = im[j];
    re[j] = r * c - i * s;
    im[j] = r * s + i * c;
  }
}

__global__ void __launch_bounds__(kMaxThreads)
fused_step_kernel(const float* __restrict__ re_in,
                  const float* __restrict__ im_in,
                  const float* __restrict__ kick,
                  const float* __restrict__ bond,
                  const float* __restrict__ theta_j,
                  const float* __restrict__ bit_pm,
                  const float* __restrict__ bond_par,
                  float* __restrict__ re_out, float* __restrict__ im_out,
                  long long rows, int nq, int nb, float theta_h) {
  extern __shared__ float smem[];
  const int dim = 1 << nq;
  float* sre = smem;
  float* sim = sre + dim;
  uint16_t* bit_neg = reinterpret_cast<uint16_t*>(sim + dim);
  uint16_t* par_neg = bit_neg + dim;
  float* skick = reinterpret_cast<float*>(par_neg + dim);
  float* sbond = skick + nq;

  int bad = 0;
  for (int j = threadIdx.x; j < dim; j += blockDim.x) {
    uint32_t bm = 0, pm = 0;
    for (int q = 0; q < nq; ++q) {
      const float v = bit_pm[j * nq + q];
      bm |= static_cast<uint32_t>(v < 0.f) << q;
      bad |= (v != 1.f) & (v != -1.f);
    }
    for (int k = 0; k < nb; ++k) {
      const float v = bond_par[j * nb + k];
      pm |= static_cast<uint32_t>(v < 0.f) << k;
      bad |= (v != 1.f) & (v != -1.f);
    }
    bit_neg[j] = static_cast<uint16_t>(bm);
    par_neg[j] = static_cast<uint16_t>(pm);
  }
  bad = __syncthreads_or(bad);

  const float half_th = 0.5f * theta_h;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * dim;
    if (bad) {
      for (int j = threadIdx.x; j < dim; j += blockDim.x) {
        re_out[base + j] = __int_as_float(0x7fffffff);
        im_out[base + j] = __int_as_float(0x7fffffff);
      }
      continue;
    }
    for (int j = threadIdx.x; j < dim; j += blockDim.x) {
      sre[j] = re_in[base + j];
      sim[j] = im_in[base + j];
    }
    for (int i = threadIdx.x; i < nq; i += blockDim.x) {
      skick[i] = kick[row * nq + i];
    }
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      sbond[i] = bond[row * nb + i];
    }
    const float half_tj = -0.5f * theta_j[row];
    __syncthreads();
    wht_rows(sre, sim, nq, dim);
    phase_rows(sre, sim, bit_neg, skick, nq, half_th, dim);
    __syncthreads();
    wht_rows(sre, sim, nq, dim);
    phase_rows(sre, sim, par_neg, sbond, nb, half_tj, dim);
    __syncthreads();
    for (int j = threadIdx.x; j < dim; j += blockDim.x) {
      re_out[base + j] = sre[j];
      im_out[base + j] = sim[j];
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// All arrays are contiguous f32 on the current device: re_in, im_in,
// re_out, im_out [rows, 2^nq]; kick [rows, nq]; bond [rows, nb]; theta_j
// [rows]; bit_pm [2^nq, nq]; bond_par [2^nq, nb]. The caller checks
// 1 <= nq <= 14 and 0 <= nb <= 16.
extern "C" int fused_trotter_step_launch(const float* re_in,
                                         const float* im_in,
                                         const float* kick, const float* bond,
                                         const float* theta_j,
                                         const float* bit_pm,
                                         const float* bond_par, float* re_out,
                                         float* im_out, long long rows, int nq,
                                         int nb, float theta_h, void* stream) {
  if (rows <= 0) return 0;
  const int dim = 1 << nq;
  int threads = dim / 4;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                         : threads);
  const size_t smem = 12 * static_cast<size_t>(dim) +
                      static_cast<size_t>(nq + nb) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_step_kernel, threads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > rows) grid = rows;
  fused_step_kernel<<<static_cast<unsigned>(grid), threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      re_in, im_in, kick, bond, theta_j, bit_pm, bond_par, re_out, im_out,
      rows, nq, nb, theta_h);
  return static_cast<int>(cudaGetLastError());
}

// Fused kicked-Ising evolution for Hopper (sm_90a).
//
// Replaces mlqem_tpu/ops/pallas/evolve.py::evolve_fused (body
// _evolve_kernel). Each row is one trajectory, held as re and im planes
// [rows, 2^nq] f32. For each of `steps` Trotter steps the row gets
//   1. a Walsh-Hadamard transform H^{(x)nq},
//   2. the RX phase    exp(i * theta_h/2 * (kick_s . bit_pm_t[:, j])),
//   3. a Walsh-Hadamard transform,
//   4. the ZZ phase    exp(-i * theta_j/2 * (bond_s . bond_par_t[:, j])).
//
// What bounds it here: per row one 8 KB read and one 8 KB write for each
// plane (16 KB in, 16 KB out) against 2*steps WHTs (nq butterfly stages
// each) and 2*steps*dim sincosf. At nq=10, steps=4 that is ~80 shared-memory
// passes over the row and 8192 sincosf per 32 KB of device-memory traffic,
// so the kernel is bound by shared-memory bandwidth and the FP32 pipes, not
// by HBM.
//
// What the design does about it: the TPU kernel did each WHT as a dense
// dim x dim matmul only because its compiler rejects lane-splitting
// reshapes. Here a row (2 * 4 * dim bytes) sits in shared memory, and each
// WHT is log2(dim) in-place butterfly stages of +-1/sqrt(2) pairs with a
// barrier between stages, i.e. O(dim log dim) work instead of O(dim^2).
// The state is read from device memory once and written once for all
// steps. Blocks are persistent (as many as fit on the card) and loop over
// rows, so the +-1 tables bit_pm_t [nq, dim] and bond_par_t [nb, dim] are
// turned once per block into per-amplitude sign masks in shared memory;
// the exponents are then sums of +-kick / +-bond signs, exact like the
// TPU kernel's f32 dot of +-1 values. Any table entry other than +-1 makes
// the kernel write NaN to every output, so a misuse cannot pass silently.
// Arithmetic is f32 throughout with full-precision sincosf (no fast math).
// Left for later: several rows per block, warp-shuffle butterflies for the
// low stages, vector loads, and skipping the read of the |0...0> start.

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
                                           const uint32_t* neg,
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
evolve_fused_kernel(const float* __restrict__ re_in,
                    const float* __restrict__ im_in,
                    const float* __restrict__ kick,
                    const float* __restrict__ bond,
                    const float* __restrict__ theta_j,
                    const float* __restrict__ bit_pm_t,
                    const float* __restrict__ bond_par_t,
                    float* __restrict__ re_out, float* __restrict__ im_out,
                    long long rows, int nq, int nb, int steps,
                    float theta_h) {
  extern __shared__ float smem[];
  const int dim = 1 << nq;
  float* sre = smem;
  float* sim = sre + dim;
  uint32_t* bit_neg = reinterpret_cast<uint32_t*>(sim + dim);
  uint32_t* par_neg = bit_neg + dim;
  float* skick = reinterpret_cast<float*>(par_neg + dim);
  float* sbond = skick + steps * nq;

  int bad = 0;
  for (int j = threadIdx.x; j < dim; j += blockDim.x) {
    uint32_t bm = 0, pm = 0;
    for (int q = 0; q < nq; ++q) {
      const float v = bit_pm_t[q * dim + j];
      bm |= static_cast<uint32_t>(v < 0.f) << q;
      bad |= (v != 1.f) & (v != -1.f);
    }
    for (int k = 0; k < nb; ++k) {
      const float v = bond_par_t[k * dim + j];
      pm |= static_cast<uint32_t>(v < 0.f) << k;
      bad |= (v != 1.f) & (v != -1.f);
    }
    bit_neg[j] = bm;
    par_neg[j] = pm;
  }
  bad = __syncthreads_or(bad);

  const float half_th = 0.5f * theta_h;
  const int nk = steps * nq, nbs = steps * nb;
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
    for (int i = threadIdx.x; i < nk; i += blockDim.x) {
      skick[i] = kick[row * nk + i];
    }
    for (int i = threadIdx.x; i < nbs; i += blockDim.x) {
      sbond[i] = bond[row * nbs + i];
    }
    const float half_tj = -0.5f * theta_j[row];
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      wht_rows(sre, sim, nq, dim);
      phase_rows(sre, sim, bit_neg, skick + s * nq, nq, half_th, dim);
      __syncthreads();
      wht_rows(sre, sim, nq, dim);
      phase_rows(sre, sim, par_neg, sbond + s * nb, nb, half_tj, dim);
      __syncthreads();
    }
    for (int j = threadIdx.x; j < dim; j += blockDim.x) {
      re_out[base + j] = sre[j];
      im_out[base + j] = sim[j];
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// All arrays are contiguous f32 on the current device: re_in, im_in,
// re_out, im_out [rows, 2^nq]; kick [rows, steps*nq]; bond
// [rows, steps*nb]; theta_j [rows]; bit_pm_t [nq, 2^nq]; bond_par_t
// [nb, 2^nq]. The caller checks 1 <= nq <= 13, 0 <= nb <= 32 and that the
// shared-memory size fits.
extern "C" int evolve_fused_launch(const float* re_in, const float* im_in,
                                   const float* kick, const float* bond,
                                   const float* theta_j,
                                   const float* bit_pm_t,
                                   const float* bond_par_t, float* re_out,
                                   float* im_out, long long rows, int nq,
                                   int nb, int steps, float theta_h,
                                   void* stream) {
  if (rows <= 0) return 0;
  const int dim = 1 << nq;
  int threads = dim / 4;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads
                                                         : threads);
  const size_t smem =
      (4 * static_cast<size_t>(dim) + static_cast<size_t>(steps) *
       (nq + nb)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      evolve_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, evolve_fused_kernel, threads, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > rows) grid = rows;
  evolve_fused_kernel<<<static_cast<unsigned>(grid), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      re_in, im_in, kick, bond, theta_j, bit_pm_t, bond_par_t, re_out,
      im_out, rows, nq, nb, steps, theta_h);
  return static_cast<int>(cudaGetLastError());
}

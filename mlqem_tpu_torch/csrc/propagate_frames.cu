// The Pauli-frame pass of the kicked-Ising engines (K5), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this pass as a jnp
// lax.scan that XLA compiles (mlqem_tpu/ops/kicked_ising.py:205-262,
// KickedIsingEngine._frame_signs). Run as eager int32 torch ops, the pass
// is ~25 small launches a bond and step (1,114 a pass at nq 10 and 4 steps,
// 5,912 at w 21 and 10 steps) and goes at the host's launch rate. Here it
// is one launch.
//
// What it computes, op for op as ops/kernels/frames.py::
// propagate_frames_reference: a row's frame is two bit masks over the
// qubits, x and z. Each step writes the row's kick signs from z, then, for
// each bond (a, b) in the given order, conjugates by CX(a, b) (x ^= x_a << b,
// z ^= z_b << a), XORs in the Pauli of the bond's first draw, writes the
// bond's sign from x_b, conjugates by CX(a, b) again and XORs in the Pauli
// of the second draw; after the step it writes x to x_after. A draw d holds
// 4·p_a + p_b, the Pauli codes p (0 I, 1 X, 2 Y, 3 Z) on a and b, split as
// d >> 2 and d & 3 (the plain version's floor division and remainder, for
// any int32); p has an X part for p in {1, 2} and a Z part for p in {2, 3}.
//
// What bounds it here: bytes. A row reads 8·nb bytes of draws a step and
// writes 4·(nq + nb) bytes of signs and 4 of x_after; the bit operations
// are ~20 integer ops a bond. At the labels shape (524,288 rows, 4 steps,
// nq 10, nb 9) that is 151 MB in and 167 MB out: 0.095 ms at 3.35 TB/s.
//
// What the design does about it. One thread a row keeps the row's frame in
// registers for the whole pass, so only the draws and the signs touch
// device memory. A block of kRows rows walks the steps together, both ways
// through shared memory:
// - the step's draws of the block's rows are one contiguous run of
//   rows·nb int2 (the two draws of a bond side by side), loaded coalesced;
//   each thread then reads its own row there, whose stride is padded to an
//   odd number of int2 so that a warp's 64-bit reads fall on distinct
//   banks;
// - each thread writes its row's kick and bond signs of the step to shared
//   memory, and the block stores them from there, consecutive threads on a
//   row's consecutive floats: a warp's own stores would land on 32 rows
//   steps·nq (steps·nb) floats apart;
// - x_after [steps, rows] is stored by each thread directly, coalesced.
// The bond list, (a, b) int32 pairs on the device, is read once a block.
// Nothing here draws random numbers: the draws come in.
//
// On an H100 80GB HBM3 (700 W) at the labels shape: 0.384 ms (4x the
// bound); with each thread storing its own signs, 1.231 ms. At 128 rows,
// w 21 and 10 steps (a light-cone chunk): 0.060 ms.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;  // rows a block, one a thread

struct Args {
  const int2* draws;   // [steps, rows, nb]: a bond's (first, second) draw
  const int2* bonds;   // [nb]: (a, b)
  float* kick;         // [rows, steps, nq]
  float* bond;         // [rows, steps, nb]
  int* x_after;        // [steps, rows]
  long long rows;
  int steps, nb, nq;
};

__device__ __forceinline__ unsigned x_part(int p) { return (p == 1) | (p == 2); }
__device__ __forceinline__ unsigned z_part(int p) { return (p == 2) | (p == 3); }

// conjugation of the frame by CX(a, b): X_a -> X_a X_b, Z_b -> Z_a Z_b
__device__ __forceinline__ void cx(unsigned& x, unsigned& z, int a, int b) {
  x ^= ((x >> a) & 1u) << b;
  z ^= ((z >> b) & 1u) << a;
}

// the Pauli of draw d on (a, b), multiplied into the frame
__device__ __forceinline__ void noise(unsigned& x, unsigned& z, int d, int a,
                                      int b) {
  const int pa = d >> 2, pb = d & 3;
  x ^= (x_part(pa) << a) | (x_part(pb) << b);
  z ^= (z_part(pa) << a) | (z_part(pb) << b);
}

__device__ __forceinline__ float sign_of(unsigned bit) {
  return 1.0f - 2.0f * static_cast<float>(bit);
}

__global__ void __launch_bounds__(kRows) frames_kernel(const Args A) {
  extern __shared__ int2 smem[];
  const int nb = A.nb, nq = A.nq, pad = nb | 1;
  int2* s_bonds = smem;                                  // [nb]
  int2* s_draws = s_bonds + nb;                          // [kRows][pad]
  float* s_kick = reinterpret_cast<float*>(s_draws + kRows * pad);
  float* s_bond = s_kick + kRows * nq;                   // [kRows][nb]
  const int t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int nr = static_cast<int>(
      min(static_cast<long long>(kRows), A.rows - r0));
  const long long kick_row = static_cast<long long>(A.steps) * nq;
  const long long bond_row = static_cast<long long>(A.steps) * nb;
  for (int k = t; k < nb; k += kRows) s_bonds[k] = A.bonds[k];
  unsigned x = 0u, z = 0u;
  for (int s = 0; s < A.steps; ++s) {
    const int2* g = A.draws + (static_cast<long long>(s) * A.rows + r0) * nb;
#pragma unroll 4
    for (int i = t; i < nr * nb; i += kRows) {
      const int r = i / nb;
      s_draws[r * pad + (i - r * nb)] = g[i];
    }
    __syncthreads();
    if (t < nr) {
      float* kt = s_kick + t * nq;
      for (int q = 0; q < nq; ++q) kt[q] = sign_of((z >> q) & 1u);
      const int2* d = s_draws + t * pad;
      float* bt = s_bond + t * nb;
      for (int k = 0; k < nb; ++k) {
        const int2 ab = s_bonds[k], dk = d[k];
        cx(x, z, ab.x, ab.y);
        noise(x, z, dk.x, ab.x, ab.y);
        bt[k] = sign_of((x >> ab.y) & 1u);
        cx(x, z, ab.x, ab.y);
        noise(x, z, dk.y, ab.x, ab.y);
      }
      A.x_after[static_cast<long long>(s) * A.rows + r0 + t] =
          static_cast<int>(x);
    }
    __syncthreads();
    // the step's signs, a row's nq (nb) floats at a time
    float* gk = A.kick + r0 * kick_row + static_cast<long long>(s) * nq;
    for (int i = t; i < nr * nq; i += kRows) {
      const int r = i / nq;
      gk[r * kick_row + (i - r * nq)] = s_kick[i];
    }
    float* gb = A.bond + r0 * bond_row + static_cast<long long>(s) * nb;
    for (int i = t; i < nr * nb; i += kRows) {
      const int r = i / nb;
      gb[r * bond_row + (i - r * nb)] = s_bond[i];
    }
    // the next step's loads write s_draws only; s_kick and s_bond are
    // written again after the next barrier
  }
}

}  // namespace

// draws int32 [steps, rows, nb, 2] and bonds int32 [nb, 2] (8-byte aligned);
// kick f32 [rows, steps, nq], bond f32 [rows, steps, nb], x_after int32
// [steps, rows]; 1 <= nq <= 31, bond qubits in [0, nq). Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int propagate_frames_launch(const int* draws, const int* bonds,
                                       float* kick, float* bond,
                                       int* x_after, long long rows,
                                       int steps, int nb, int nq,
                                       void* stream) {
  if (rows <= 0 || steps <= 0) return 0;
  const size_t smem =
      sizeof(int2) * (nb + static_cast<size_t>(kRows) * (nb | 1)) +
      sizeof(float) * static_cast<size_t>(kRows) * (nq + nb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        frames_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Args A{reinterpret_cast<const int2*>(draws),
               reinterpret_cast<const int2*>(bonds), kick, bond, x_after,
               rows, steps, nb, nq};
  const unsigned blocks = static_cast<unsigned>((rows + kRows - 1) / kRows);
  frames_kernel<<<blocks, kRows, smem, static_cast<cudaStream_t>(stream)>>>(A);
  return static_cast<int>(cudaGetLastError());
}

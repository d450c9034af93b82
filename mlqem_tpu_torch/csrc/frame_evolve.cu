// Fused generic Pauli-frame evolution for Hopper (sm_90a).
//
// Replaces mlqem_tpu/ops/pallas/frame_evolve.py::evolve_frame_marginals
// (body _evolve_kernel). Each row is one trajectory: it starts at |0...0>,
// runs an op plan and writes only its per-qubit P(1) = sum_j |psi_j|^2
// bit_q(j), [rows, nq] f32. The plan is a list of (kind, a, b, slot):
// rotations rx/ry/rz/rzz take the row's sign-folded angle
// theta_eff[row, slot] (the Pauli frame's anticommutation signs are folded
// in by the caller, so the kernel never sees the frame); h/cx/cy/cz/swap
// are fixed Cliffords.
//
// What bounds it here: a row is 2 * 4 * 2^nq bytes of state (8 KB at
// nq=10) that never leaves shared memory. Device memory sees only the
// angles in (4 * n_rot bytes a row) and nq floats out. Every op reads and
// writes the whole row in shared memory, so at the bench shape (148 ops,
// nq=10) a row costs ~2.4 MB of shared-memory traffic against ~0.3 KB of
// device-memory traffic: the kernel is bound by shared-memory bandwidth
// and the barrier after each op.
//
// What the design does about it: the TPU kernel builds each bit flip from
// two lane rolls under a mask, because its compiler rejects lane-splitting
// reshapes; here a flip is an index XOR, and every op is done in place on
// amplitude pairs (j with bit q clear, j | 2^q), each pair owned by one
// thread, with one __syncthreads() per op. The plan is data, not code: it
// is copied to shared memory once per block and walked in a loop whose
// switch on the op kind is uniform across the block, so one build serves
// every circuit. The angles' cos/sin of theta/2 are computed once per row
// into shared memory with full-precision sincosf (no fast math, f32
// throughout), and the marginals are reduced with per-thread partials,
// warp shuffles and one shared-memory pass. Left for later: several rows
// per block for small nq, keeping high-qubit pairs in registers across
// ops, and conflict-free layouts for the low-qubit flips.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNq = 13;
constexpr int kMaxThreads = 256;
constexpr float kInvSqrt2 = 0.70710678118654752440f;

enum OpKind : int {
  ROT_Z = 0, ROT_X = 1, ROT_Y = 2, ROT_ZZ = 3,
  GATE_H = 4, GATE_CX = 5, GATE_CY = 6, GATE_CZ = 7, GATE_SWAP = 8
};

// Index of the p-th amplitude whose bit q is 0.
__device__ __forceinline__ int insert_zero(int p, int q) {
  return ((p >> q) << (q + 1)) | (p & ((1 << q) - 1));
}

__global__ void __launch_bounds__(kMaxThreads)
frame_evolve_kernel(const float* __restrict__ theta,
                    const int4* __restrict__ plan, float* __restrict__ out,
                    int nq, int n_ops, int n_rot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float partial[kMaxThreads / 32][kMaxNq];
  int4* ops = reinterpret_cast<int4*>(smem_raw);          // [n_ops]
  float* re = reinterpret_cast<float*>(ops + n_ops);      // [dim]
  const int dim = 1 << nq;
  const int half = dim >> 1;
  float* im = re + dim;                                   // [dim]
  float* cs = im + dim;                                   // [n_rot][cos, sin]
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const long long row = blockIdx.x;

  for (int i = tid; i < n_ops; i += nt) ops[i] = plan[i];
  const float* th = theta + row * n_rot;
  for (int i = tid; i < n_rot; i += nt) {
    float s, c;
    sincosf(0.5f * th[i], &s, &c);
    cs[2 * i] = c;
    cs[2 * i + 1] = s;
  }
  for (int j = tid; j < dim; j += nt) {
    re[j] = (j == 0) ? 1.0f : 0.0f;
    im[j] = 0.0f;
  }
  __syncthreads();

  for (int k = 0; k < n_ops; ++k) {
    const int4 op = ops[k];
    const int kind = op.x, a = op.y, b = op.z;
    const int ma = 1 << a;
    switch (kind) {
      case ROT_Z:
      case ROT_ZZ: {  // diagonal: psi_j *= c - i s sgn(j)
        const float c = cs[2 * op.w], s = cs[2 * op.w + 1];
        for (int p = tid; p < half; p += nt) {
          const int j0 = insert_zero(p, a), j1 = j0 | ma;
          // sgn_a is +1 at j0 and -1 at j1; rzz also takes sgn_b, which
          // is the same at both (b != a)
          const float sv0 =
              (kind == ROT_ZZ && ((j0 >> b) & 1)) ? -s : s;
          const float sv1 = -sv0;
          const float r0 = re[j0], i0 = im[j0], r1 = re[j1], i1 = im[j1];
          re[j0] = r0 * c + i0 * sv0;
          im[j0] = i0 * c - r0 * sv0;
          re[j1] = r1 * c + i1 * sv1;
          im[j1] = i1 * c - r1 * sv1;
        }
        break;
      }
      case ROT_X: {  // [[c, -is], [-is, c]]
        const float c = cs[2 * op.w], s = cs[2 * op.w + 1];
        for (int p = tid; p < half; p += nt) {
          const int j0 = insert_zero(p, a), j1 = j0 | ma;
          const float r0 = re[j0], i0 = im[j0], r1 = re[j1], i1 = im[j1];
          re[j0] = c * r0 + s * i1;
          im[j0] = c * i0 - s * r1;
          re[j1] = c * r1 + s * i0;
          im[j1] = c * i1 - s * r0;
        }
        break;
      }
      case ROT_Y: {  // [[c, -s], [s, c]]
        const float c = cs[2 * op.w], s = cs[2 * op.w + 1];
        for (int p = tid; p < half; p += nt) {
          const int j0 = insert_zero(p, a), j1 = j0 | ma;
          const float r0 = re[j0], i0 = im[j0], r1 = re[j1], i1 = im[j1];
          re[j0] = c * r0 - s * r1;
          im[j0] = c * i0 - s * i1;
          re[j1] = c * r1 + s * r0;
          im[j1] = c * i1 + s * i0;
        }
        break;
      }
      case GATE_H: {
        for (int p = tid; p < half; p += nt) {
          const int j0 = insert_zero(p, a), j1 = j0 | ma;
          const float r0 = re[j0], i0 = im[j0], r1 = re[j1], i1 = im[j1];
          re[j0] = (r0 + r1) * kInvSqrt2;
          im[j0] = (i0 + i1) * kInvSqrt2;
          re[j1] = (r0 - r1) * kInvSqrt2;
          im[j1] = (i0 - i1) * kInvSqrt2;
        }
        break;
      }
      case GATE_CX:
      case GATE_CY: {  // pairs on the target b where the control a is set
        const int mb = 1 << b;
        for (int p = tid; p < half; p += nt) {
          const int j0 = insert_zero(p, b), j1 = j0 | mb;
          if (!((j0 >> a) & 1)) continue;
          const float r0 = re[j0], i0 = im[j0], r1 = re[j1], i1 = im[j1];
          if (kind == GATE_CX) {
            re[j0] = r1; im[j0] = i1;
            re[j1] = r0; im[j1] = i0;
          } else {  // Y = [[0, -i], [i, 0]]
            re[j0] = i1; im[j0] = -r1;
            re[j1] = -i0; im[j1] = r0;
          }
        }
        break;
      }
      case GATE_CZ: {  // negate where bits a and b are both set
        for (int p = tid; p < half; p += nt) {
          const int j1 = insert_zero(p, a) | ma;
          if ((j1 >> b) & 1) {
            re[j1] = -re[j1];
            im[j1] = -im[j1];
          }
        }
        break;
      }
      case GATE_SWAP: {  // exchange (bit a = 0, bit b = 1) with its mirror
        const int mb = 1 << b;
        for (int p = tid; p < half; p += nt) {
          const int j0 = insert_zero(p, a);
          if (!((j0 >> b) & 1)) continue;
          const int j1 = (j0 | ma) & ~mb;
          const float r0 = re[j0], i0 = im[j0];
          re[j0] = re[j1]; im[j0] = im[j1];
          re[j1] = r0; im[j1] = i0;
        }
        break;
      }
      default:
        break;
    }
    __syncthreads();
  }

  // per-qubit P(1): per-thread partials, warp shuffles, one smem pass
  float acc[kMaxNq];
#pragma unroll
  for (int q = 0; q < kMaxNq; ++q) acc[q] = 0.0f;
  for (int j = tid; j < dim; j += nt) {
    const float pj = re[j] * re[j] + im[j] * im[j];
#pragma unroll
    for (int q = 0; q < kMaxNq; ++q)
      if (q < nq && ((j >> q) & 1)) acc[q] += pj;
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < kMaxNq; ++q) {
    float v = acc[q];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial[warp][q] = v;
  }
  __syncthreads();
  if (tid < nq) {
    float v = 0.0f;
    for (int w = 0; w < (nt + 31) / 32; ++w) v += partial[w][tid];
    out[row * nq + tid] = v;
  }
}

}  // namespace

// Launch on `stream`: theta [rows, n_rot] f32, plan [n_ops, 4] int32
// (16-byte aligned), out [rows, nq] f32, all on the device and contiguous;
// 1 <= nq <= 13, rows >= 1, n_rot >= 1. One block per row, min(2^(nq-1),
// 256) threads (at least one warp). Returns the CUDA error of the launch
// (0 on success).
extern "C" int evolve_frame_marginals_launch(const void* theta,
                                             const void* plan, void* out,
                                             long long rows, int nq,
                                             int n_ops, int n_rot,
                                             void* stream) {
  if (nq < 1 || nq > kMaxNq || rows < 1 || n_rot < 1 || n_ops < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int half = 1 << (nq - 1);
  const int threads = half < 32 ? 32 : (half > kMaxThreads ? kMaxThreads
                                                           : half);
  const size_t smem = 16 * static_cast<size_t>(n_ops) +
                      4 * (2 * (static_cast<size_t>(1) << nq) +
                           2 * static_cast<size_t>(n_rot));
  cudaError_t err = cudaFuncSetAttribute(
      frame_evolve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  frame_evolve_kernel<<<static_cast<unsigned int>(rows), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(theta), static_cast<const int4*>(plan),
      static_cast<float*>(out), nq, n_ops, n_rot);
  return static_cast<int>(cudaGetLastError());
}

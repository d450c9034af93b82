// Fused generic Pauli-frame evolution for Hopper (sm_90a): K2.
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
// nq=10) that never leaves the SM. Device memory sees only the angles in
// (4 * n_rot bytes a row) and nq floats out, so the bound is the f32 work
// of the ops: ~6 operations an amplitude for a rotation. What a design
// meets first is how amplitudes reach each other: with the row in shared
// memory, every op reads and writes all of it behind a block barrier
// (~2.4 MB of shared-memory traffic a row at the bench's 148 ops).
//
// What the design does about it (nq <= 10; the bench is nq=10):
// - A row lies in one warp's registers: 32 amplitudes a plane a lane,
//   amplitude j = lane << 5 | e with bits 0-4 in the register index e and
//   bits 5..nq-1 across the lanes (one row a warp at nq=10, 2^(10-nq) rows
//   a warp at nq 5-9; below nq 5 a lane holds its whole row, 32 rows a
//   warp). The state never enters shared memory and the op loop has no
//   block barrier.
// - The plan is warp-uniform (every row runs it), so the switch on
//   (kind, moving bit) never diverges. It is copied to shared memory once
//   per persistent block.
// - Diagonal ops (rz, rzz, cz) move no data: each amplitude's sign is a
//   bit of a 32-bit word per lane, the XOR (rz, rzz) or AND (cz) of
//   per-bit patterns of e and of the lane's own bits.
// - Ops that move a bit (rx, ry, h, cx, cy) take one of six code paths by
//   that bit: five register positions, each a template instance (a qubit
//   known only at run time cannot index a register array without putting
//   it in local memory), and one lane path, a __shfl_xor_sync by
//   1 << (q - 5). A control qubit is a run-time predicate word, as the
//   diagonal signs are. swap(a, b) runs as cx(a, b) cx(b, a) cx(a, b), an
//   exact permutation. So the instances number kinds x 6, not kinds x nq^2.
// - Angles: the lanes compute the warp's rows' n_rot sincosf(theta/2) at
//   full precision into a per-warp table in shared memory (76 float2 a row
//   at the bench), with coalesced theta loads, behind a __syncwarp(); a
//   plan whose table does not fit beside it computes each op's sincosf in
//   the lanes instead, to the same values.
// - P(1): each lane sums partials over its register bits, and its own
//   total for each lane bit; one warp-shuffle reduction gives [nq] a row.
// For nq 11-13 the kernel keeps a row in shared memory: one block a row,
// one barrier an op. (Bits 10-12 would lie across warps and need a block
// exchange wherever an op moves them; the bench never runs those widths.)
// For nq 14-30 (the frame engine's widest rows; 14 qubits is the Ising
// pipeline's first width past shared memory) the same block loop runs on a
// row in global memory: persistent blocks of 512 threads, each with a slot
// of a scratch buffer that the wrapper allocates, one barrier an op. At
// nq = 14 the grid's slots (128 KB each) stay mostly in L2; each op reads
// and writes the whole row there.
// The wrapper merges each cx(a, b) rz(b) cx(a, b) of a plan with no op on a
// or b between them into rzz(a, b), exactly (ops/kernels/frame_evolve.py::
// fuse_plan): the bench's 148 ops run as 76.
// Arithmetic is f32 throughout with full-precision sincosf (no fast math).
// Left for later: the lane path's shuffles carry most of what is left at
// nq=10 (half of the bench's rx move a lane bit); runs of ops on disjoint
// bits could share one pass over the registers; nq 11-13 in registers;
// nq >= 14 in a thread-block cluster's distributed shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNq = 30;
constexpr int kMaxSmemNq = 13;        // widths with a row in shared memory
constexpr int kMaxWarpNq = 10;        // widths that the warp kernel takes
constexpr int kMaxThreads = 256;      // a block of the shared-memory tier
constexpr int kGlobalThreads = 512;   // a block of the global-memory tier
constexpr int kWarps = 4;             // warps a block of the warp kernel
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr size_t kMaxSmem = 232448;   // per block on sm_90

enum OpKind : int {
  ROT_Z = 0, ROT_X = 1, ROT_Y = 2, ROT_ZZ = 3,
  GATE_H = 4, GATE_CX = 5, GATE_CY = 6, GATE_CZ = 7, GATE_SWAP = 8
};

// Bit e of kBitPattern[q] is bit q of e.
__constant__ uint32_t kBitPattern[5] = {0xAAAAAAAAu, 0xCCCCCCCCu,
                                        0xF0F0F0F0u, 0xFF00FF00u,
                                        0xFFFF0000u};

// ---------------------------------------------------------------------------
// nq <= 10: a row in a warp's registers
// ---------------------------------------------------------------------------

// Bit e of the result is bit q of amplitude base | e (base: the lane's
// high bits, e < 32).
__device__ __forceinline__ uint32_t bit_word(int q, int base) {
  return q < 5 ? kBitPattern[q] : ((base >> q) & 1 ? 0xFFFFFFFFu : 0u);
}

// psi_j *= c - i s (-1)^{sign bit e}.
template <int N>
__device__ __forceinline__ void diag_rot(float (&re)[N], float (&im)[N],
                                         float c, float s, uint32_t sign) {
#pragma unroll
  for (int e = 0; e < N; ++e) {
    const float sv = (sign >> e) & 1u ? -s : s;
    const float r = re[e], i = im[e];
    re[e] = r * c + i * sv;
    im[e] = i * c - r * sv;
  }
}

// rx, ry, h, cx, cy with target bit Q in the registers: pairs (e, e | 2^Q).
// `ctl` is the control's word (cx, cy).
template <int Q, int N>
__device__ __forceinline__ void reg_pair_op(int kind, float (&re)[N],
                                            float (&im)[N], float c, float s,
                                            uint32_t ctl) {
  constexpr int M = 1 << Q;
  switch (kind) {
    case ROT_X:  // [[c, -is], [-is, c]]
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (e & M) continue;
        const int f = e | M;
        const float r0 = re[e], i0 = im[e], r1 = re[f], i1 = im[f];
        re[e] = c * r0 + s * i1;
        im[e] = c * i0 - s * r1;
        re[f] = c * r1 + s * i0;
        im[f] = c * i1 - s * r0;
      }
      break;
    case ROT_Y:  // [[c, -s], [s, c]]
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (e & M) continue;
        const int f = e | M;
        const float r0 = re[e], i0 = im[e], r1 = re[f], i1 = im[f];
        re[e] = c * r0 - s * r1;
        im[e] = c * i0 - s * i1;
        re[f] = c * r1 + s * r0;
        im[f] = c * i1 + s * i0;
      }
      break;
    case GATE_H:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (e & M) continue;
        const int f = e | M;
        const float r0 = re[e], i0 = im[e], r1 = re[f], i1 = im[f];
        re[e] = (r0 + r1) * kInvSqrt2;
        im[e] = (i0 + i1) * kInvSqrt2;
        re[f] = (r0 - r1) * kInvSqrt2;
        im[f] = (i0 - i1) * kInvSqrt2;
      }
      break;
    case GATE_CX:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (e & M) continue;
        const int f = e | M;
        if ((ctl >> e) & 1u) {
          const float r0 = re[e], i0 = im[e];
          re[e] = re[f];
          im[e] = im[f];
          re[f] = r0;
          im[f] = i0;
        }
      }
      break;
    case GATE_CY:  // Y = [[0, -i], [i, 0]]
#pragma unroll
      for (int e = 0; e < N; ++e) {
        if (e & M) continue;
        const int f = e | M;
        if ((ctl >> e) & 1u) {
          const float r0 = re[e], i0 = im[e], r1 = re[f], i1 = im[f];
          re[e] = i1;
          im[e] = -r1;
          re[f] = -i0;
          im[f] = r0;
        }
      }
      break;
    default:
      break;
  }
}

// The same ops with the target across the lanes: the partner of every
// register is in lane ^ m; `upper`: this lane holds the target's 1 half.
template <int N>
__device__ __forceinline__ void lane_pair_op(int kind, float (&re)[N],
                                             float (&im)[N], float c,
                                             float s, uint32_t ctl, int m,
                                             bool upper) {
  switch (kind) {
    case ROT_X:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float pr = __shfl_xor_sync(0xffffffffu, re[e], m);
        const float pi = __shfl_xor_sync(0xffffffffu, im[e], m);
        const float r = re[e], i = im[e];
        re[e] = c * r + s * pi;
        im[e] = c * i - s * pr;
      }
      break;
    case ROT_Y: {
      const float sv = upper ? -s : s;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float pr = __shfl_xor_sync(0xffffffffu, re[e], m);
        const float pi = __shfl_xor_sync(0xffffffffu, im[e], m);
        re[e] = c * re[e] - sv * pr;
        im[e] = c * im[e] - sv * pi;
      }
      break;
    }
    case GATE_H:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float pr = __shfl_xor_sync(0xffffffffu, re[e], m);
        const float pi = __shfl_xor_sync(0xffffffffu, im[e], m);
        re[e] = (upper ? pr - re[e] : re[e] + pr) * kInvSqrt2;
        im[e] = (upper ? pi - im[e] : im[e] + pi) * kInvSqrt2;
      }
      break;
    case GATE_CX:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float pr = __shfl_xor_sync(0xffffffffu, re[e], m);
        const float pi = __shfl_xor_sync(0xffffffffu, im[e], m);
        if ((ctl >> e) & 1u) {
          re[e] = pr;
          im[e] = pi;
        }
      }
      break;
    case GATE_CY:
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float pr = __shfl_xor_sync(0xffffffffu, re[e], m);
        const float pi = __shfl_xor_sync(0xffffffffu, im[e], m);
        if ((ctl >> e) & 1u) {
          re[e] = upper ? -pi : pi;
          im[e] = upper ? pr : -pr;
        }
      }
      break;
    default:
      break;
  }
}

// A non-diagonal op on target bit t: one of the six code paths.
template <int RB>
__device__ __forceinline__ void moving_op(int kind, int t, float (&re)[1 << RB],
                                          float (&im)[1 << RB], float c,
                                          float s, uint32_t ctl, int lane) {
  if (t >= RB) {
    if constexpr (RB == 5) {
      lane_pair_op(kind, re, im, c, s, ctl, 1 << (t - 5),
                   (lane >> (t - 5)) & 1);
    }
    return;
  }
  switch (t) {
    case 0: reg_pair_op<0>(kind, re, im, c, s, ctl); break;
    case 1: if constexpr (RB > 1) reg_pair_op<1>(kind, re, im, c, s, ctl);
            break;
    case 2: if constexpr (RB > 2) reg_pair_op<2>(kind, re, im, c, s, ctl);
            break;
    case 3: if constexpr (RB > 3) reg_pair_op<3>(kind, re, im, c, s, ctl);
            break;
    case 4: if constexpr (RB > 4) reg_pair_op<4>(kind, re, im, c, s, ctl);
            break;
    default: break;
  }
}

// RB = min(nq, 5) register bits; tb = nq - RB lane bits of a row.
template <int RB>
__global__ void __launch_bounds__(kWarps * 32, 4)
frame_warp_kernel(const float* __restrict__ theta,
                  const int4* __restrict__ plan, float* __restrict__ out,
                  long long rows, int nq, int n_ops, int n_rot, int tb,
                  int tab_stride) {
  constexpr int N = 1 << RB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int4* ops = reinterpret_cast<int4*>(smem_raw);            // [n_ops]
  for (int i = threadIdx.x; i < n_ops; i += blockDim.x) ops[i] = plan[i];
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 >> tb;                     // rows a warp
  const int tau = lane & ((1 << tb) - 1);       // lane in row
  const int rw = lane >> tb;                    // row in warp
  const int base = tau << RB;                   // this lane's j, less e
  // cos/sin table of the warp's rows (tab_stride > 0): [rpw][tab_stride]
  float2* tab = reinterpret_cast<float2*>(ops + n_ops) +
                warp * rpw * tab_stride;
  const long long groups = (rows + rpw - 1) / rpw;
  const long long n_theta = rows * n_rot;

  for (long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
       g < groups; g += static_cast<long long>(gridDim.x) * kWarps) {
    const long long row = g * rpw + rw;
    const long long rr = row < rows ? row : rows - 1;     // inputs to read
    if (tab_stride > 0) {
      __syncwarp();                             // the last group's reads
      const long long t0 = g * rpw * n_rot;
      for (int i = lane; i < rpw * n_rot; i += 32) {
        const int r = i / n_rot, k = i - r * n_rot;
        const float th = t0 + i < n_theta ? theta[t0 + i] : 0.f;
        float s, c;
        sincosf(0.5f * th, &s, &c);
        tab[r * tab_stride + k] = make_float2(c, s);
      }
      __syncwarp();
    }
    float re[N], im[N];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      re[e] = (base | e) == 0 ? 1.f : 0.f;
      im[e] = 0.f;
    }

    for (int k = 0; k < n_ops; ++k) {
      const int4 op = ops[k];
      const int kind = op.x, a = op.y, b = op.z;
      float c = 1.f, s = 0.f;
      if (kind <= ROT_ZZ) {
        if (tab_stride > 0) {
          const float2 cs = tab[rw * tab_stride + op.w];
          c = cs.x;
          s = cs.y;
        } else {
          sincosf(0.5f * theta[rr * n_rot + op.w], &s, &c);
        }
      }
      switch (kind) {
        case ROT_Z:
          diag_rot(re, im, c, s, bit_word(a, base));
          break;
        case ROT_ZZ:
          diag_rot(re, im, c, s, bit_word(a, base) ^ bit_word(b, base));
          break;
        case GATE_CZ: {
          const uint32_t both = bit_word(a, base) & bit_word(b, base);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            if ((both >> e) & 1u) {
              re[e] = -re[e];
              im[e] = -im[e];
            }
          }
          break;
        }
        case GATE_SWAP:  // cx(a, b) cx(b, a) cx(a, b)
#pragma unroll 1
          for (int r = 0; r < 3; ++r) {
            const int t = r == 1 ? a : b;
            moving_op<RB>(GATE_CX, t, re, im, c, s,
                          bit_word(a ^ b ^ t, base), lane);
          }
          break;
        default: {  // rx, ry, h move bit a; cx, cy move b under control a
          const bool ctl = kind >= GATE_CX;
          moving_op<RB>(kind, ctl ? b : a, re, im, c, s,
                        ctl ? bit_word(a, base) : 0u, lane);
          break;
        }
      }
    }

    // per-qubit P(1): register bits from this lane's partials, lane bits
    // from its total; then a sum over the row's lanes
    float acc[kMaxWarpNq];
    float total = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxWarpNq; ++q) acc[q] = 0.f;
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const float p = re[e] * re[e] + im[e] * im[e];
      total += p;
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        if (e & (1 << q)) acc[q] += p;
      }
    }
#pragma unroll
    for (int q = RB; q < kMaxWarpNq; ++q) {
      acc[q] = (q < nq && ((base >> q) & 1)) ? total : 0.f;
    }
    for (int o = 1; o < (1 << tb); o <<= 1) {
#pragma unroll
      for (int q = 0; q < kMaxWarpNq; ++q) {
        acc[q] += __shfl_xor_sync(0xffffffffu, acc[q], o);
      }
    }
    if (row < rows) {
      for (int q = tau; q < nq; q += 1 << tb) {
        float v = 0.f;
#pragma unroll
        for (int p = 0; p < kMaxWarpNq; ++p) v = p == q ? acc[p] : v;
        out[row * nq + q] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// nq 11-30: a row in a block, in shared memory (nq 11-13) or in a global
// memory slot (nq 14-30)
// ---------------------------------------------------------------------------

// Index of the p-th amplitude whose bit q is 0.
__device__ __forceinline__ int insert_zero(int p, int q) {
  return ((p >> q) << (q + 1)) | (p & ((1 << q) - 1));
}

// The row's cos/sin(theta/2) into cs and |0...0> into re/im; one barrier.
__device__ __forceinline__ void block_row_start(const float* th, int n_rot,
                                                float* cs, float* re,
                                                float* im, int dim) {
  const int tid = threadIdx.x, nt = blockDim.x;
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
}

// The plan on a row held by the whole block, one barrier an op. re/im are
// in shared or global memory: the barrier makes a block's writes to either
// visible to the block.
__device__ void block_row_ops(const int4* ops, int n_ops, const float* cs,
                              float* re, float* im, int nq) {
  const int half = 1 << (nq - 1);
  const int tid = threadIdx.x, nt = blockDim.x;
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
}

// The row's per-qubit P(1) into out_row: per-thread partials, warp
// shuffles, one shared-memory pass. NQ is the tier's widest row.
template <int NQ>
__device__ __forceinline__ void block_row_marginals(const float* re,
                                                    const float* im, int nq,
                                                    float (*partial)[NQ],
                                                    float* out_row) {
  const int tid = threadIdx.x, nt = blockDim.x, dim = 1 << nq;
  float acc[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.0f;
  for (int j = tid; j < dim; j += nt) {
    const float pj = re[j] * re[j] + im[j] * im[j];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (q < nq && ((j >> q) & 1)) acc[q] += pj;
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    float v = acc[q];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) partial[warp][q] = v;
  }
  __syncthreads();
  if (tid < nq) {
    float v = 0.0f;
    for (int w = 0; w < (nt + 31) / 32; ++w) v += partial[w][tid];
    out_row[tid] = v;
  }
}

// nq 11-13: one block a row, the row in shared memory.
__global__ void __launch_bounds__(kMaxThreads)
frame_smem_kernel(const float* __restrict__ theta,
                  const int4* __restrict__ plan, float* __restrict__ out,
                  int nq, int n_ops, int n_rot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float partial[kMaxThreads / 32][kMaxSmemNq];
  int4* ops = reinterpret_cast<int4*>(smem_raw);          // [n_ops]
  float* re = reinterpret_cast<float*>(ops + n_ops);      // [dim]
  const int dim = 1 << nq;
  float* im = re + dim;                                   // [dim]
  float* cs = im + dim;                                   // [n_rot][cos, sin]
  const long long row = blockIdx.x;

  for (int i = threadIdx.x; i < n_ops; i += blockDim.x) ops[i] = plan[i];
  block_row_start(theta + row * n_rot, n_rot, cs, re, im, dim);
  block_row_ops(ops, n_ops, cs, re, im, nq);
  block_row_marginals<kMaxSmemNq>(re, im, nq, partial, out + row * nq);
}

// nq 14-30: persistent blocks, each with its own slot of `scratch`
// ([gridDim.x][2][dim] f32) for the re/im planes of the row it runs; a
// slot is 2^(nq+3) bytes (128 KB at nq = 14), so the slots of the whole
// grid stay in L2 at nq 14 and stream through device memory above it.
__global__ void __launch_bounds__(kGlobalThreads)
frame_global_kernel(const float* __restrict__ theta,
                    const int4* __restrict__ plan, float* __restrict__ out,
                    float* scratch, long long rows, int nq, int n_ops,
                    int n_rot) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float partial[kGlobalThreads / 32][kMaxNq];
  int4* ops = reinterpret_cast<int4*>(smem_raw);          // [n_ops]
  float* cs = reinterpret_cast<float*>(ops + n_ops);      // [n_rot][cos, sin]
  const size_t dim = static_cast<size_t>(1) << nq;
  float* re = scratch + 2 * dim * blockIdx.x;
  float* im = re + dim;

  for (int i = threadIdx.x; i < n_ops; i += blockDim.x) ops[i] = plan[i];
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    // the barrier of block_row_start also ends the last row's reads of
    // cs, re/im and partial
    block_row_start(theta + row * n_rot, n_rot, cs, re, im,
                    static_cast<int>(dim));
    block_row_ops(ops, n_ops, cs, re, im, nq);
    block_row_marginals<kMaxNq>(re, im, nq, partial, out + row * nq);
  }
}

template <int RB>
int launch_warp(const float* theta, const int4* plan, float* out,
                long long rows, int nq, int n_ops, int n_rot,
                cudaStream_t stream) {
  const int tb = nq - RB, rpw = 32 >> tb;
  // the cos/sin table, a row's stride odd in float2 (no bank conflicts
  // between the rows of a warp), if it fits beside the plan
  int stride = n_rot | 1;
  size_t smem = 16 * static_cast<size_t>(n_ops) +
                sizeof(float2) * kWarps * rpw * static_cast<size_t>(stride);
  if (smem > kMaxSmem) {
    stride = 0;
    smem = 16 * static_cast<size_t>(n_ops);
  }
  cudaError_t err = cudaFuncSetAttribute(
      frame_warp_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, frame_warp_kernel<RB>, kWarps * 32, smem)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long groups = (rows + rpw - 1) / rpw;
  const long long blocks = (groups + kWarps - 1) / kWarps;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > blocks) grid = blocks;
  frame_warp_kernel<RB><<<static_cast<unsigned>(grid), kWarps * 32, smem,
                          stream>>>(theta, plan, out, rows, nq, n_ops, n_rot,
                                    tb, stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`: theta [rows, n_rot] f32, plan [n_ops, 4] int32
// (16-byte aligned), out [rows, nq] f32, all on the device and contiguous;
// 1 <= nq <= 30, rows >= 1, n_rot >= 1. nq <= 10: persistent blocks of 4
// warps, a row in a warp's registers; nq 11-13: one block a row,
// min(2^(nq-1), 256) threads, the row in shared memory; nq 14-30: `slots`
// persistent blocks of 512 threads, each row in the block's slot of
// `scratch` (slots * 2 * 2^nq f32 on the device; unread below nq 14).
// Returns the CUDA error of the launch (0 on success).
extern "C" int evolve_frame_marginals_launch(const void* theta,
                                             const void* plan, void* out,
                                             void* scratch, long long slots,
                                             long long rows, int nq,
                                             int n_ops, int n_rot,
                                             void* stream) {
  if (nq < 1 || nq > kMaxNq || rows < 1 || n_rot < 1 || n_ops < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* th = static_cast<const float*>(theta);
  const int4* pl = static_cast<const int4*>(plan);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 1: return launch_warp<1>(th, pl, o, rows, nq, n_ops, n_rot, s);
    case 2: return launch_warp<2>(th, pl, o, rows, nq, n_ops, n_rot, s);
    case 3: return launch_warp<3>(th, pl, o, rows, nq, n_ops, n_rot, s);
    case 4: return launch_warp<4>(th, pl, o, rows, nq, n_ops, n_rot, s);
    default: break;
  }
  if (nq <= kMaxWarpNq) {
    return launch_warp<5>(th, pl, o, rows, nq, n_ops, n_rot, s);
  }
  const size_t tables = 16 * static_cast<size_t>(n_ops) +
                        8 * static_cast<size_t>(n_rot);
  cudaError_t err;
  if (nq > kMaxSmemNq) {
    if (scratch == nullptr || slots < 1 || slots > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    err = cudaFuncSetAttribute(frame_global_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(tables));
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long grid = slots < rows ? slots : rows;
    frame_global_kernel<<<static_cast<unsigned int>(grid), kGlobalThreads,
                          tables, s>>>(th, pl, o,
                                       static_cast<float*>(scratch), rows,
                                       nq, n_ops, n_rot);
    return static_cast<int>(cudaGetLastError());
  }
  const int half = 1 << (nq - 1);
  const int threads = half < 32 ? 32 : (half > kMaxThreads ? kMaxThreads
                                                           : half);
  const size_t smem = tables + 8 * (static_cast<size_t>(1) << nq);
  err = cudaFuncSetAttribute(frame_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  frame_smem_kernel<<<static_cast<unsigned int>(rows), threads, smem, s>>>(
      th, pl, o, nq, n_ops, n_rot);
  return static_cast<int>(cudaGetLastError());
}

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
// For nq 11-30 a block of 16 warps holds 2^14 amplitudes in registers, in
// the warp tier's layout: 32 a plane a thread, position bits 0-4 in the
// register index, 5-9 across the lanes, 10-13 across the warps. Each qubit
// has a position, chosen on the host by a schedule (ops/kernels/
// frame_evolve.py::frame_schedule, cached per plan and width) that cuts the
// merged plan into segments under one qubit -> position map each:
// - every op that moves a bit (rx, ry, h; the target of cx, cy) finds it in
//   a register or lane position and runs on the warp tier's six code paths
//   (moving_op); diagonal ops and controls are sign or predicate words at
//   any position; a swap trades two qubits' positions on the host and
//   moves no data;
// - between segments a relayout trades register qubits for warp qubits:
//   one padded (conflict-free) transpose through a 66 KB shared buffer,
//   a plane at a time, 4 barriers. The Ising template runs ~1.5
//   relayouts a Trotter step in place of a barrier an op.
// nq 11-14 (the chip tier): a block holds 2^(14-nq) whole rows, from |0>
// to P(1) (the positions mapped back to qubits) in one launch.
// nq 15-30 (the pass tier): a row stays in a slot of a device-memory
// scratch buffer; each pass of the schedule is a launch over (rows of a
// group x 2^(nq-14) chunks): a block loads the 2^14 amplitudes under the
// pass's 14 on-chip qubits, runs the pass, stores them back. The lanes
// always hold storage bits 0-4, so every warp load and store is one
// 128-byte run. Off-chip diagonals and controls are per-block constants.
// The last pass writes each chunk's P(1) partials, a second kernel sums
// them over the chunks in order. A row moves through device memory once a
// pass, not once an op.
// The wrapper merges each cx(a, b) rz(b) cx(a, b) of a plan with no op on a
// or b between them into rzz(a, b), exactly (ops/kernels/frame_evolve.py::
// fuse_plan): the bench's 148 ops run as 76.
// Arithmetic is f32 throughout with full-precision sincosf (no fast math).
// Left for later: the lane path's shuffles carry most of what is left at
// nq=10 (half of the bench's rx move a lane bit); runs of ops on disjoint
// bits could share one pass over the registers; nq 15-18 in a thread-block
// cluster's distributed shared memory, in place of passes over device
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxNq = 30;
constexpr int kMaxWarpNq = 10;        // widths that the warp kernel takes
constexpr int kWarps = 4;             // warps a block of the warp kernel
constexpr int kMaxSmemNq = 14;        // positions a block of 16 warps holds
constexpr int kChipThreads = 512;
constexpr int kHeader = 4;            // int4 records of a pass's two maps
constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr size_t kMaxSmem = 232448;   // per block on sm_90

enum OpKind : int {
  ROT_Z = 0, ROT_X = 1, ROT_Y = 2, ROT_ZZ = 3,
  GATE_H = 4, GATE_CX = 5, GATE_CY = 6, GATE_CZ = 7, GATE_SWAP = 8,
  RELAYOUT = 9
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
// nq 11-30: 2^14 amplitudes a block in registers, on positions
// ---------------------------------------------------------------------------

// Shared-memory address of on-chip index j: a word of padding every 32,
// so that a warp's 32 lanes (bits 5-9) hit 32 banks, and a thread's 32
// amplitudes p0 | e lie at one base plus e.
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }
constexpr int kBufWords = (1 << kMaxSmemNq) + (1 << (kMaxSmemNq - 5));

// v, as the compiler sees it, changes here, after the memory accesses
// before it: what depends on it is computed after them, not hoisted.
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v) : : "memory");
  return v;
}

// Position p's source in a relayout packed as (lo, hi), 4 bits a position.
__device__ __forceinline__ int relayout_src(int lo, int hi, int p) {
  return (p < 7 ? lo >> (4 * p) : hi >> (4 * (p - 7))) & 15;
}

// One plane of the schedule's relayout (lo, hi) on the block's 2^14
// amplitudes: the amplitude at new on-chip index p0 | e (p0 = tid << 5)
// takes the one at the old index whose bit src(p) is bit p. The lanes keep
// their positions, so both sides of the exchange are free of bank
// conflicts.
__device__ __forceinline__ void relayout_plane(float (&v)[32], float* buf,
                                               int lo, int hi) {
  const int p0 = threadIdx.x << 5;
  int src_base = 0;
#pragma unroll
  for (int p = 5; p < kMaxSmemNq; ++p) {
    if ((p0 >> p) & 1) src_base |= 1 << relayout_src(lo, hi, p);
  }
  __syncthreads();                  // the buffer's last reads are done
  float* row = buf + padded(p0);
#pragma unroll
  for (int e = 0; e < 32; ++e) row[e] = v[e];
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    int j = src_base;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if ((e >> k) & 1) j ^= 1 << relayout_src(lo, hi, k);
    }
    v[e] = buf[padded(j)];
  }
}

// Load (kStore false) or store a block's chunk of its slot of `scratch`
// ([slots][2^nq] (re, im) pairs): position index base | e lies at storage
// index st_base | st[k] for the bits k of e, store[p] the storage bit of
// position p. The lanes hold storage bits 0-4: a warp's 32 accesses of one
// e are one 256-byte run. 8 amplitudes a group, each group's addresses
// computed after the last group's accesses: 8 live 64-bit addresses, not
// 32. Computed again at each end, so that none of it stays live across the
// op loop.
template <bool kStore>
__device__ __forceinline__ void chunk_io(float (&re)[32], float (&im)[32],
                                         float* scratch,
                                         const unsigned char* store, int nq,
                                         int base, long long slot) {
  float2* row = reinterpret_cast<float2*>(scratch) + (slot << nq);
  int st_base = 0, st[5];
  for (int p = 5; p < nq; ++p) {
    if ((base >> p) & 1) st_base |= 1 << store[p];
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) st[k] = 1 << store[k];
#pragma unroll
  for (int g = 0; g < 32; g += 8) {
    const int group_base = opaque(st_base);
#pragma unroll
    for (int e = g; e < g + 8; ++e) {
      int j = group_base;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        if ((e >> k) & 1) j |= st[k];
      }
      if (kStore) {
        row[j] = make_float2(re[e], im[e]);
      } else {
        const float2 v = row[j];
        re[e] = v.x;
        im[e] = v.y;
      }
    }
  }
}

// One launch of the chip tier (nq 11-14: whole rows, 2^(14-nq) a block,
// load = 0, finish = 1, out [rows, nq]) or one pass of the pass tier (nq
// 15-30: block b runs chunk b mod 2^(nq-14) of slot b >> (nq-14) of
// `scratch` ([slots][2^nq] (re, im) pairs), row row0 + slot; load: read
// the chunk, else start at |0>; finish: write P(1) partials to out
// [slots][chunks][nq], else store the chunk). prog: the pass's storage
// bit of each position (32 bytes), its qubit of each position at the end
// (32 bytes), n_ops ops on positions. Angles: slots [slot_lo, slot_lo +
// n_slots) of theta.
__global__ void __launch_bounds__(kChipThreads, 1)
frame_chip_kernel(const float* __restrict__ theta,
                  const int4* __restrict__ prog, float* __restrict__ out,
                  float* scratch, long long rows, long long row0, int nq,
                  int n_ops, int n_rot, int slot_lo, int n_slots, int load,
                  int finish) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float part[kChipThreads / 32][11];
  float* buf = reinterpret_cast<float*>(smem_raw);         // [kBufWords]
  int4* ops = reinterpret_cast<int4*>(buf + kBufWords);    // [4 + n_ops]
  const unsigned char* store = reinterpret_cast<unsigned char*>(ops);
  const unsigned char* qubit_at = store + 32;
  const int4* plan = ops + kHeader;
  float2* table = reinterpret_cast<float2*>(ops + kHeader + n_ops);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = threadIdx.x << 5;              // on-chip index less e
  const bool wide = nq > kMaxSmemNq;
  const int chip = wide ? kMaxSmemNq : nq;      // positions on chip
  const int cbits = nq - chip;                  // chunk bits (pass tier)
  const int rpb = 1 << (kMaxSmemNq - chip);     // rows a block
  const int chunk = blockIdx.x & ((1 << cbits) - 1);
  // the block's slot (pass tier) or first row (chip tier)
  const int first = wide ? blockIdx.x >> cbits : blockIdx.x * rpb;
  const int rib = p0 >> chip;                   // this thread's row in block
  // this thread's position index less e (the chunk's bits above 13)
  const int base = (chunk << kMaxSmemNq) | (p0 & ((1 << chip) - 1));

  for (int i = threadIdx.x; i < kHeader + n_ops; i += blockDim.x) {
    ops[i] = prog[i];
  }
  for (int i = threadIdx.x; i < rpb * n_slots; i += blockDim.x) {
    const int r = i / n_slots;
    long long rr = row0 + first + r;
    if (rr >= rows) rr = rows - 1;
    float s, c;
    sincosf(0.5f * theta[rr * n_rot + slot_lo + i - r * n_slots], &s, &c);
    table[i] = make_float2(c, s);
  }
  __syncthreads();
  const float2* tab = table + rib * n_slots - slot_lo;     // by angle slot

  float re[32], im[32];
  if (load) {
    chunk_io<false>(re, im, scratch, store, nq, base, first);
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      re[e] = (base | e) == 0 ? 1.f : 0.f;
      im[e] = 0.f;
    }
  }

  for (int k = 0; k < n_ops; ++k) {
    const int4 op = plan[k];
    const int kind = op.x, a = op.y, b = op.z;
    if (kind == RELAYOUT) {
      relayout_plane(re, buf, a, b);
      relayout_plane(im, buf, a, b);
      continue;
    }
    float c = 1.f, s = 0.f;
    if (kind <= ROT_ZZ) {
      const float2 cs = tab[op.w];
      c = cs.x;
      s = cs.y;
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
        for (int e = 0; e < 32; ++e) {
          if ((both >> e) & 1u) {
            re[e] = -re[e];
            im[e] = -im[e];
          }
        }
        break;
      }
      default: {  // rx, ry, h move bit a; cx, cy move b under control a
        const bool ctl = kind >= GATE_CX;
        moving_op<5>(kind, ctl ? b : a, re, im, c, s,
                     ctl ? bit_word(a, base) : 0u, lane);
        break;
      }
    }
  }

  if (!finish) {
    chunk_io<true>(re, im, scratch, store, nq, base, first);
    return;
  }
  // P(1) of each position: register bits from this thread's partials, the
  // others from its total; a warp sum, then a sum over a row's warps
  float v[11];
#pragma unroll
  for (int i = 0; i < 11; ++i) v[i] = 0.f;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float pr = re[e] * re[e] + im[e] * im[e];
    v[10] += pr;
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      if ((e >> k) & 1) v[k] += pr;
    }
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) v[5 + k] = ((lane >> k) & 1) ? v[10] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < 11; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 11; ++i) part[warp][i] = v[i];
  }
  __syncthreads();
  const int wpr = 1 << (chip - 10);             // warps a row
  for (int i = threadIdx.x; i < rpb * nq; i += blockDim.x) {
    const int r = i / nq, p = i - r * nq;
    float sum = 0.f;
    for (int j = 0; j < wpr; ++j) {
      const float* pw = part[r * wpr + j];
      if (p < 10) {
        sum += pw[p];
      } else if (p < chip) {
        sum += ((j >> (p - 10)) & 1) ? pw[10] : 0.f;
      } else {
        sum += ((chunk >> (p - kMaxSmemNq)) & 1) ? pw[10] : 0.f;
      }
    }
    const int q = qubit_at[p];
    if (wide) {
      out[((static_cast<long long>(first) << cbits) + chunk) * nq + q] = sum;
    } else if (first + r < rows) {
      out[(static_cast<long long>(first) + r) * nq + q] = sum;
    }
  }
}

// The pass tier's P(1): out[r, q] = sum over the chunks c, in order, of
// partials[r][c][q], for the n = rows x nq entries of a group.
__global__ void frame_chunk_sum_kernel(const float* __restrict__ partials,
                                       float* __restrict__ out, long long n,
                                       int nq, int chunks) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const long long r = i / nq;
  const float* p = partials + r * chunks * nq + (i - r * nq);
  float sum = 0.f;
  for (int c = 0; c < chunks; ++c) sum += p[static_cast<long long>(c) * nq];
  out[i] = sum;
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

// The chip and pass tiers: `passes` (host memory) holds n_passes records
// (first int4 of the pass in prog, n_ops, slot_lo, n_slots).
int launch_chip(const float* theta, const int4* prog, float* out,
                float* scratch, float* partials, long long slots,
                long long rows, int nq, int n_rot, const int* passes,
                int n_passes, cudaStream_t stream) {
  const bool wide = nq > kMaxSmemNq;
  if (n_passes < 1 || (!wide && n_passes != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpb = wide ? 1 : 1 << (kMaxSmemNq - nq);
  size_t smem = 0;
  for (int i = 0; i < n_passes; ++i) {
    const int* ps = passes + 4 * i;
    const size_t need = sizeof(float) * kBufWords +
                        16 * static_cast<size_t>(kHeader + ps[1]) +
                        sizeof(float2) * rpb * static_cast<size_t>(ps[3]);
    if (need > smem) smem = need;
  }
  cudaError_t err = cudaFuncSetAttribute(
      frame_chip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!wide) {
    const int* ps = passes;
    const long long grid = (rows + rpb - 1) / rpb;
    frame_chip_kernel<<<static_cast<unsigned>(grid), kChipThreads, smem,
                        stream>>>(theta, prog + ps[0], out, nullptr, rows, 0,
                                  nq, ps[1], n_rot, ps[2], ps[3], 0, 1);
    return static_cast<int>(cudaGetLastError());
  }
  if (scratch == nullptr || partials == nullptr || slots < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = 1 << (nq - kMaxSmemNq);
  for (long long row0 = 0; row0 < rows; row0 += slots) {
    const long long group = rows - row0 < slots ? rows - row0 : slots;
    for (int i = 0; i < n_passes; ++i) {
      const int* ps = passes + 4 * i;
      const bool last = i + 1 == n_passes;
      frame_chip_kernel<<<static_cast<unsigned>(group * chunks),
                          kChipThreads, smem, stream>>>(
          theta, prog + ps[0], last ? partials : nullptr, scratch, rows,
          row0, nq, ps[1], n_rot, ps[2], ps[3], i > 0, last);
      if ((err = cudaGetLastError()) != cudaSuccess)
        return static_cast<int>(err);
    }
    const long long n = group * nq;
    frame_chunk_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                             stream>>>(partials, out + row0 * nq, n, nq,
                                       chunks);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Launch on `stream`: theta [rows, n_rot] f32, plan int4 records (16-byte
// aligned), out [rows, nq] f32, all on the device and contiguous;
// 1 <= nq <= 30, rows >= 1, n_rot >= 1. nq <= 10: `plan` holds n_ops ops
// on qubits; persistent blocks of 4 warps, a row in a warp's registers.
// nq 11-30: `plan` holds the schedule's passes and `passes` (host memory)
// their n_passes records; nq 11-14: one launch, 2^(14-nq) rows a block of
// 512 threads; nq 15-30: groups of `slots` rows, each row in its slot of
// `scratch` (slots * 2^nq (re, im) f32 pairs), a launch a pass over the
// group's rows x 2^(nq-14) chunks, P(1) partials in `partials` (slots *
// 2^(nq-14) * nq f32), and a launch that sums them. Returns the first CUDA
// error of the launches (0 on success).
extern "C" int evolve_frame_marginals_launch(const void* theta,
                                             const void* plan, void* out,
                                             void* scratch, void* partials,
                                             const int* passes,
                                             long long slots,
                                             long long rows, int nq,
                                             int n_ops, int n_rot,
                                             int n_passes, void* stream) {
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
  return launch_chip(th, pl, o, static_cast<float*>(scratch),
                     static_cast<float*>(partials), slots, rows, nq, n_rot,
                     passes, n_passes, s);
}

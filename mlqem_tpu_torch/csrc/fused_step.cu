// One kicked-Ising Trotter step for Hopper (sm_90a): K3.
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
// (16 * 2^nq bytes) against 2 WHTs of nq stages and two complex rotations
// an amplitude: at nq=13 ~2.5 f32 operations per byte moved, under the
// card's f32 balance of ~20, so device-memory bandwidth bounds it (0.48 ms
// at the light-cone cross-check's [12,288, 2^13]).
//
// What the design does about it: the device code is kicked_regs.cuh's,
// shared with K1 (csrc/evolve.cu) and run with steps = 1: the state in
// registers, read once and written once; unscaled butterflies with one
// shared-memory exchange per WHT and warp shuffles for bits 5-9 at
// nq 11-14; the phases' cos/sin from a per-row table of nq + 1 and nb + 1
// values. The JAX-layout tables are read through run-time strides, and
// each amplitude's bit and parity masks share one 32-bit word (nq + nb <=
// 30), so an nq=13 block takes 101 KB of shared memory (two blocks an SM)
// and nq=14 fits: 512 threads hold its 2^14 amplitudes, 198 KB. It is its
// own entry point, not K1 with steps=1: the light-cone engine reads <Z>
// between steps. Any table entry other than +-1 makes the kernel write
// NaN to every output.
// Left for later: see kicked_regs.cuh.

#include "kicked_regs.cuh"

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
  const Args a{re_in,  im_in,  kick, bond, theta_j, bit_pm, bond_par,
               re_out, im_out, rows, nb,   1,       theta_h,
               1,      nq,     1,    nb};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 1: return launch_kicked<1, true>(a, s);
    case 2: return launch_kicked<2, true>(a, s);
    case 3: return launch_kicked<3, true>(a, s);
    case 4: return launch_kicked<4, true>(a, s);
    case 5: return launch_kicked<5, true>(a, s);
    case 6: return launch_kicked<6, true>(a, s);
    case 7: return launch_kicked<7, true>(a, s);
    case 8: return launch_kicked<8, true>(a, s);
    case 9: return launch_kicked<9, true>(a, s);
    case 10: return launch_kicked<10, true>(a, s);
    case 11: return launch_kicked<11, true>(a, s);
    case 12: return launch_kicked<12, true>(a, s);
    case 13: return launch_kicked<13, true>(a, s);
    case 14: return launch_kicked<14, true>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

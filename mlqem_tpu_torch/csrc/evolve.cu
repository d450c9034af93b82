// Fused kicked-Ising evolution for Hopper (sm_90a): K1.
//
// Replaces mlqem_tpu/ops/pallas/evolve.py::evolve_fused (body
// _evolve_kernel). Each row is one trajectory, held as re and im planes
// [rows, 2^nq] f32, and gets `steps` Trotter steps (WHT, RX phase, WHT, ZZ
// phase) with the +-1 tables in the layout [n, 2^nq].
//
// What bounds it here: per row one read and one write of 2 * 4 * 2^nq
// bytes against 2*steps WHTs of nq butterfly stages, i.e. the f32 adds of
// the butterflies (2.6 ms at 524,288 rows of nq=10, 4 steps) and the
// shared-memory traffic that moves amplitudes between threads. Device
// memory (8.75 GB, 2.6 ms) is not the limit once those are small.
//
// What the design does about it: the device code is kicked_regs.cuh's,
// shared with K3 (csrc/fused_step.cu): the state in registers, unscaled
// butterflies, one shared-memory exchange per WHT, warp shuffles for bits
// 5-9 at nq 11-13, and the phases' cos/sin from a per-row table of nq + 1
// and nb + 1 values. K1 keeps two mask words an amplitude, since its nb
// reaches 32. One template instance per nq 1-13.
// Left for later: see kicked_regs.cuh.

#include "kicked_regs.cuh"

// Launch on `stream`; returns cudaGetLastError() after the launch (0 = ok).
// All arrays are contiguous f32 on the current device: re_in, im_in,
// re_out, im_out [rows, 2^nq]; kick [rows, steps*nq]; bond
// [rows, steps*nb]; theta_j [rows]; bit_pm_t [nq, 2^nq]; bond_par_t
// [nb, 2^nq]. The caller checks 1 <= nq <= 13 and 0 <= nb <= 32; shared
// memory (at most 136 KB, at nq=13) does not depend on steps.
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
  const Args a{re_in,  im_in,  kick,    bond,  theta_j, bit_pm_t, bond_par_t,
               re_out, im_out, rows,    nb,    steps,   theta_h,  dim,
               1,      dim,    1};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nq) {
    case 1: return launch_kicked<1, false>(a, s);
    case 2: return launch_kicked<2, false>(a, s);
    case 3: return launch_kicked<3, false>(a, s);
    case 4: return launch_kicked<4, false>(a, s);
    case 5: return launch_kicked<5, false>(a, s);
    case 6: return launch_kicked<6, false>(a, s);
    case 7: return launch_kicked<7, false>(a, s);
    case 8: return launch_kicked<8, false>(a, s);
    case 9: return launch_kicked<9, false>(a, s);
    case 10: return launch_kicked<10, false>(a, s);
    case 11: return launch_kicked<11, false>(a, s);
    case 12: return launch_kicked<12, false>(a, s);
    case 13: return launch_kicked<13, false>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

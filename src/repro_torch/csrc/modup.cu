// ModUp of every digit at once: (B, l, N) int64 in natural eval order ->
// (B, dnum, l_ext, N) int64 in natural eval order, own limbs passed
// through, in two launches.
//
// Replaces: modup_pallas, src/repro/kernels/modup/modup.py:71 (body
// _modup_kernel :44), one call per digit in the JAX engine, plus the
// engine's bit-reversal gathers and own-limb where around it.
//
// Bound on the H100: device memory, for the int64 input and output and
// the 32-bit inverse and forward tables; the reduce's ls Montgomery
// products per output word are far below the card's integer rate.
//
// Design: the TPU kernel fills a VMEM scratch on grid step s % ld == 0
// and reads it on the steps after; CUDA blocks run in no order, so that
// cannot carry over.  Here:
//   launch 1 runs the cluster INTT (ntt_device.cuh) of all l source rows;
//     each source limb belongs to one digit, whose qhat_inv scale is
//     folded into its post-twist; it writes a (B, l, N) 32-bit
//     coefficient workspace (9.4 MB at the paper's level 35: it stays in
//     the 50 MB L2 for launch 2);
//   launch 2 runs one cluster per (batch, digit, destination limb): an
//     own limb is copied from the input, any other is reduced from the
//     workspace as it is loaded, transformed on chip and stored in
//     natural order into its slot of the output.
#include "ntt_device.cuh"

using namespace he2;

extern "C" int modup_all(const int64_t* x, int64_t* y, uint32_t* work,
                         const uint32_t* twist_i_scaled, const uint32_t* tw_i,
                         const int32_t* src_map, const uint32_t* cm,
                         const int32_t* own, const int32_t* digit,
                         const uint32_t* twist_f, const uint32_t* tw_f,
                         const int32_t* dst_map, const uint32_t* q,
                         const uint32_t* qn, long long batch, long long l,
                         long long l_ext, long long dnum, long long alpha,
                         long long logn, long long logc, cudaStream_t st) {
  const NttTables ti{twist_i_scaled, nullptr, tw_i, src_map, q, qn, int(l), int(logn)};
  int rc = inverse<kDstU32>(ti, batch * l, int(logc), x, nullptr, work, st);
  if (rc != 0) return rc;
  const NttTables tf{twist_f, dst_map, tw_f, dst_map, q, qn, int(l_ext), int(logn)};
  const ModUpArgs mu{work, cm, own, digit, int(l), int(l_ext), int(dnum), int(alpha)};
  return forward<kSrcModUp>(tf, batch * dnum * l_ext, int(logc), x, y, mu, st);
}

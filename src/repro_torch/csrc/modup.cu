// One digit's ModUp: INTT of the ls source limbs (BConv scale folded into
// the post-twist), tree-reduce into each of the ld destination limbs,
// forward NTT.  Input and output in bit-reversed eval order, int64.
//
// Replaces: modup_pallas, src/repro/kernels/modup/modup.py:71 (body
// _modup_kernel :44).
//
// Bound on the H100: device memory for the digit's ls input rows and ld
// output rows (int64), plus the two 32-bit intermediates below; the
// reduce does ls Montgomery multiplies per output word, which the card's
// integer rate covers.
//
// Design: the TPU kernel fills a VMEM scratch on grid step s % ld == 0
// and reads it on the steps after; CUDA blocks run concurrently and in no
// order, so that cannot carry over.  Here:
//   launch group 1 writes the scaled INTT of the source limbs into a
//     (B, ls, N) 32-bit workspace (two launches at logN > 11);
//   launch group 2 runs the forward NTT of every (batch, destination
//     limb) row, its first pass computing the reduce straight from the
//     workspace (the digit is read ld times, from L2: B*ls*N*4 B is 3 MB
//     at the paper's shapes).
// Keeping the digit on chip across the three phases, as the TPU kernel
// does, is later work.
#include "ntt_device.cuh"

using namespace he2;

extern "C" int modup_digit(const int64_t* x, int64_t* y, uint32_t* t_src,
                           uint32_t* work, const uint32_t* twist_i_scaled,
                           const uint32_t* tw_i, const int32_t* src_map,
                           const uint32_t* cm, const uint32_t* twist_f,
                           const uint32_t* tw_f, const int32_t* dst_map,
                           const uint32_t* q, const uint32_t* qn,
                           long long batch, long long ls, long long ld,
                           long long logn, cudaStream_t st) {
  const NttTables ti{twist_i_scaled, nullptr, tw_i, src_map, q, qn, int(ls), int(logn)};
  int rc = inverse<kDstU32Twist>(ti, int(batch * ls), x, t_src, t_src, nullptr, st);
  if (rc != 0) return rc;
  const NttTables tf{twist_f, dst_map, tw_f, dst_map, q, qn, int(ld), int(logn)};
  const Reduce red{t_src, cm, int(ls), int(ld)};
  return forward<kSrcReduceTwist>(tf, int(batch * ld), nullptr, red, work, y, st);
}

// Negacyclic NTT of B*l int64 rows in one launch, natural order at both
// ends: forward takes coefficients and returns evaluations at
// psi^(2k+1) in index order k; inverse the reverse.
//
// Replaces: ntt_pallas, src/repro/kernels/ntt/ntt.py:70 (bodies
// _ntt_kernel :59, _fwd_body :29, _inv_body :44), together with the
// bit-reversal gather the JAX engine applies around it.
//
// Bound on the H100: device memory.  A transform does logn/2 butterflies
// per word, a few 32-bit multiplies each, against 8 B read + 8 B written
// per word of int64 storage and 8 B of tables per limb word; at logN = 16
// the card's integer rate is far above what 3.35 TB/s can feed.
//
// Design: the TPU kernel keeps one limb in VMEM per grid step.  Here a
// limb at logN = 16 (256 KB) is spread over a cluster of 2^logc blocks
// (ntt_device.cuh): the cross-block stages run in registers next to the
// load (forward) or the store (inverse), the rest in each block's shared
// memory, and the bit-reversal is an exchange through distributed shared
// memory, so each word is read and written once, coalesced.  The caller picks logc
// (kernels/ntt/ops.py: cluster_bits).  Tables are read through a
// per-limb row map, so batched rows and repeated primes replicate no
// table.
#include "ntt_device.cuh"

using namespace he2;

extern "C" int ntt_forward(const int64_t* x, int64_t* y, const uint32_t* twist,
                           const uint32_t* tw, const int32_t* row_map,
                           const uint32_t* q, const uint32_t* qn,
                           long long rows, long long l, long long logn,
                           long long logc, cudaStream_t st) {
  const NttTables t{twist, row_map, tw, row_map, q, qn, int(l), int(logn)};
  return forward<kSrcI64>(t, rows, int(logc), x, y, ModUpArgs{}, st);
}

extern "C" int ntt_inverse(const int64_t* x, int64_t* y, const uint32_t* twist,
                           const uint32_t* tw, const int32_t* row_map,
                           const uint32_t* q, const uint32_t* qn,
                           long long rows, long long l, long long logn,
                           long long logc, cudaStream_t st) {
  const NttTables t{twist, row_map, tw, row_map, q, qn, int(l), int(logn)};
  return inverse<kDstI64>(t, rows, int(logc), x, y, nullptr, st);
}

#ifdef HE2_PROBE
// The phase timestamps of the last launches (see PROBE in ntt_device.cuh).
extern "C" int he2_read_probe(unsigned long long* dst, long long n,
                              cudaStream_t) {
  return cudaMemcpyFromSymbol(dst, he2::he2_probe, n * 8);
}
#endif

// Negacyclic NTT of B*l int64 rows, forward (natural -> bit-reversed) or
// inverse (bit-reversed -> natural).
//
// Replaces: ntt_pallas, src/repro/kernels/ntt/ntt.py:70 (bodies
// _ntt_kernel :59, _fwd_body :29, _inv_body :44).
//
// Bound on the H100: device memory.  A transform does logn/2 butterflies
// per word, a few 32-bit multiplies each, against 8 B read + 8 B written
// per word of int64 storage; at logN = 16 the card's integer rate is far
// above what 3.35 TB/s can feed.
//
// Design: the TPU kernel keeps one limb in VMEM per grid step; a limb at
// logN = 16 (256 KB) does not fit a block's shared memory, so the
// transform is two launches (ntt_device.cuh): the top logn - 11 stages in
// registers, one thread per column, and the last 11 stages in shared
// memory, one block per 2^11-word chunk.  The row crosses device memory
// twice (int64 in, 32-bit between the launches, int64 out).  Tables are
// read through a per-limb row map, so batched rows and repeated primes
// replicate no table.
#include "ntt_device.cuh"

using namespace he2;

extern "C" int ntt_forward(const int64_t* x, int64_t* y, uint32_t* work,
                           const uint32_t* twist, const uint32_t* tw,
                           const int32_t* row_map, const uint32_t* q,
                           const uint32_t* qn, long long rows, long long l,
                           long long logn, cudaStream_t st) {
  const NttTables t{twist, row_map, tw, row_map, q, qn, int(l), int(logn)};
  return forward<kSrcI64Twist>(t, int(rows), x, Reduce{}, work, y, st);
}

extern "C" int ntt_inverse(const int64_t* x, int64_t* y, uint32_t* work,
                           const uint32_t* twist, const uint32_t* tw,
                           const int32_t* row_map, const uint32_t* q,
                           const uint32_t* qn, long long rows, long long l,
                           long long logn, cudaStream_t st) {
  const NttTables t{twist, row_map, tw, row_map, q, qn, int(l), int(logn)};
  return inverse<kDstI64Twist>(t, int(rows), x, work, nullptr, y, st);
}

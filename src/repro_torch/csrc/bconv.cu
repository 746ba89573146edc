// Fast basis conversion, (B, ls, N) -> (B, ld, N) int64, coefficient domain:
//   t_i = x_i * qhat_inv_i mod q_i;   y_j = sum_i t_i * (qhat_i mod d_j) mod d_j.
//
// Replaces: bconv_pallas, src/repro/kernels/bconv/bconv.py:40 (passes
// _scale_kernel :25 and _reduce_kernel :31, two pallas_calls).
//
// Bound on the H100: device memory (8 B read per source word, 8 B written
// per destination word); ls * ld Montgomery multiplies per coefficient
// (432 at the paper's ModDown, ls = k = 12, ld = 36) stay below the
// card's integer rate at that traffic.
//
// Design: the TPU's two passes become one launch.  One thread owns one
// coefficient of one batch row: it scales its ls source words once, keeps
// them in registers, and writes all ld destination words, so the scaled
// intermediate never reaches device memory and every input word is read
// once.  Constants are read through the cache (uniform across a warp).
#include <cuda_runtime.h>

#include "launch_log.cuh"
#include "modarith.cuh"

using namespace he2;

constexpr int kMaxSrc = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bconv_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y,
             const uint32_t* qhat_inv, const uint32_t* src_q,
             const uint32_t* src_qn, const uint32_t* cm, const uint32_t* dst_q,
             const uint32_t* dst_qn, int ls, int ld, int logn, size_t total) {
  const size_t idx = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const size_t n = size_t(1) << logn;
  const size_t b = idx >> logn;
  const size_t col = idx & (n - 1);
  uint32_t t[kMaxSrc];
#pragma unroll
  for (int i = 0; i < kMaxSrc; ++i) {
    if (i < ls) {
      const uint32_t v = static_cast<uint32_t>(x[(b * ls + i) * n + col]);
      t[i] = mont_mul(v, __ldg(qhat_inv + i), __ldg(src_q + i), __ldg(src_qn + i));
    }
  }
  for (int j = 0; j < ld; ++j) {
    const uint32_t d = __ldg(dst_q + j);
    const uint32_t dn = __ldg(dst_qn + j);
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < kMaxSrc; ++i)
      if (i < ls) acc = add_mod(acc, mont_mul(t[i], __ldg(cm + i * ld + j), d, dn), d);
    y[(b * ld + j) * n + col] = acc;
  }
}

extern "C" int bconv(const int64_t* x, int64_t* y, const uint32_t* qhat_inv,
                     const uint32_t* src_q, const uint32_t* src_qn,
                     const uint32_t* cm, const uint32_t* dst_q,
                     const uint32_t* dst_qn, long long batch, long long ls,
                     long long ld, long long logn, cudaStream_t st) {
  if (ls < 1 || ls > kMaxSrc || ld < 1) return cudaErrorInvalidValue;
  const size_t total = size_t(batch) << logn;
  const unsigned blocks = unsigned((total + kThreads - 1) / kThreads);
  bconv_kernel<<<blocks, kThreads, 0, st>>>(x, y, qhat_inv, src_q, src_qn, cm,
                                            dst_q, dst_qn, int(ls), int(ld),
                                            int(logn), total);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) log_launch(1);
  return e;
}

// Keyswitch inner product with the fused plaintext multiply, summed over
// rotations:
//   out_c[b, r] = sum_rot [pt[rot, r] *] sum_j digits[b, rot, j, r] * evk[rot, j, c, r]
// for c in {0, 1}, all residues int64 in normal form.
//
// Replaces: fused_ip_pallas, src/repro/kernels/fused_ip/fused_ip.py:41
// (body _fused_ip_kernel :23).  The reference engine calls that kernel
// once per rotation and sums outside it; this kernel takes the rotation
// axis and sums inside, so the per-rotation products never reach device
// memory.
//
// Bound on the H100: device memory.  Per output word pair it reads
// R*dnum digit words, 2*R*dnum evk words and R plaintext words (8 B each)
// for about 3*R*dnum 32-bit Montgomery multiplies.
//
// Design: one thread per (batch, limb, coefficient), coalesced along the
// coefficient; a grid row per (batch, limb) keeps the index arithmetic in
// 32 bits.  Operands arrive in normal form, so each Montgomery
// product carries a factor 2^-32; every term of the sum carries the same
// power, and one multiply by 2^64 (2^96 with pt) mod q per output undoes
// it.  The evk of a shared key (relinearization) is read with rotation
// stride 0.
#include <cuda_runtime.h>

#include "launch_log.cuh"
#include "modarith.cuh"

using namespace he2;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fused_ip_kernel(const int64_t* __restrict__ dig, const int64_t* __restrict__ evk,
                const int64_t* __restrict__ pt, int64_t* __restrict__ out,
                const uint32_t* q, const uint32_t* qn, const uint32_t* fix,
                int nrot, int evk_shared, int dnum, int l, int logn) {
  const size_t n = size_t(1) << logn;
  const size_t col = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const int b = blockIdx.y / l;  // row = b * l + r: 32-bit, no 64-bit division
  const int r = blockIdx.y % l;
  const size_t ln = size_t(l) * n;
  const size_t rem = size_t(r) * n + col;
  const uint32_t qq = __ldg(q + r);
  const uint32_t qi = __ldg(qn + r);
  uint32_t acc0 = 0, acc1 = 0;
  for (int rot = 0; rot < nrot; ++rot) {
    const int64_t* d = dig + (size_t(b) * nrot + rot) * dnum * ln + rem;
    const int64_t* k = evk + size_t(evk_shared ? 0 : rot) * dnum * 2 * ln + rem;
    uint32_t s0 = 0, s1 = 0;
    for (int j = 0; j < dnum; ++j) {
      const uint32_t dv = static_cast<uint32_t>(d[size_t(j) * ln]);
      s0 = add_mod(s0, mont_mul(dv, static_cast<uint32_t>(k[size_t(2 * j) * ln]), qq, qi), qq);
      s1 = add_mod(s1, mont_mul(dv, static_cast<uint32_t>(k[size_t(2 * j + 1) * ln]), qq, qi), qq);
    }
    if (pt) {
      const uint32_t p = static_cast<uint32_t>(pt[size_t(rot) * ln + rem]);
      s0 = mont_mul(s0, p, qq, qi);
      s1 = mont_mul(s1, p, qq, qi);
    }
    acc0 = add_mod(acc0, s0, qq);
    acc1 = add_mod(acc1, s1, qq);
  }
  const uint32_t f = __ldg(fix + r);
  out[size_t(b) * 2 * ln + rem] = mont_mul(acc0, f, qq, qi);
  out[size_t(b) * 2 * ln + ln + rem] = mont_mul(acc1, f, qq, qi);
}

// One block row per (batch, limb): batch * l <= 65535 (the grid's y limit).
extern "C" int fused_ip(const int64_t* digits, const int64_t* evk,
                        const int64_t* pt, int64_t* out, const uint32_t* q,
                        const uint32_t* qn, const uint32_t* fix,
                        long long batch, long long nrot, long long evk_shared,
                        long long dnum, long long l, long long logn,
                        cudaStream_t st) {
  if (batch * l < 1 || batch * l > 65535) return cudaErrorInvalidValue;
  const size_t n = size_t(1) << logn;
  const dim3 grid(unsigned((n + kThreads - 1) / kThreads), unsigned(batch * l));
  fused_ip_kernel<<<grid, kThreads, 0, st>>>(digits, evk, pt, out, q, qn, fix,
                                             int(nrot), int(evk_shared),
                                             int(dnum), int(l), int(logn));
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) log_launch(1);
  return e;
}

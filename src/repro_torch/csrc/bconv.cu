// Fast basis conversion, (B, ls, N) -> (B, ld, N) int64, coefficient domain:
//   t_i = x_i * qhat_inv_i mod q_i;   y_j = sum_i t_i * (qhat_i mod d_j) mod d_j.
//
// Replaces: bconv_pallas, src/repro/kernels/bconv/bconv.py:40 (passes
// _scale_kernel :25 and _reduce_kernel :31, two pallas_calls).
//
// Bound on the H100: device memory (8 B read per source word, 8 B written
// per destination word).  The arithmetic is close behind: ls * ld 32x32->64
// products per coefficient (432 at the paper's ModDown, ls = 12, ld = 36).
//
// Design: the TPU's two passes are one launch, parallel over destination
// rows as well as coefficients.
//   * Grid: one block per (batch row, column tile of `lanes` pairs of
//     columns).  A thread owns kCols = 2 adjacent columns, moved with one
//     16-byte load or store a row.  The block's threads split the
//     destination rows in groups of G (a template constant, so the G-row
//     loop unrolls and the 2 * G accumulators stay in registers): slot s
//     of `lanes` threads takes groups s, s + slots, ...
//   * The block copies its source tile to shared memory asynchronously
//     (cp.async), each word once from device memory, while it stages the
//     constants there: (qhat_i mod d_j) in Montgomery form for all ld
//     rows, the source and the destination primes.  It scales the tile
//     once (t_i < q_i, one Montgomery product a word); every group then
//     reads it from shared memory and the constants as warp broadcasts.
//   * Lazy reduction: a thread adds t_i * c_ij into a 64-bit accumulator
//     per (row, column) without reducing.  With c_ij < d_j, gacc =
//     floor(2^32 / max q_i) products stay below d_j * 2^32, so after every
//     gacc source rows one Montgomery reduction brings the sum, plus the
//     carried value r < 2 d_j in the high word, below 4 d_j; one fold keeps
//     r below 2 d_j, and the store folds it below d_j.  Primes must lie
//     below 2^30 (4 d_j < 2^32, and the 64-bit sum cannot overflow); the
//     wrapper checks them and passes gacc (4 for every prime the repo
//     makes).  bconv_lazy_host in kernels/modops.py repeats this
//     arithmetic on the host.
#include <cuda_runtime.h>

#include "launch_log.cuh"
#include "modarith.cuh"

using namespace he2;

constexpr int kMaxSrc = 32;
constexpr int kCols = 2;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ void copy16_async(void* smem_dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

template <int G>
__global__ void __launch_bounds__(kMaxThreads)
bconv_kernel(const longlong2* __restrict__ x, longlong2* __restrict__ y,
             const uint32_t* __restrict__ qhat_inv,
             const uint32_t* __restrict__ src_q,
             const uint32_t* __restrict__ src_qn,
             const uint32_t* __restrict__ cm,
             const uint32_t* __restrict__ dst_q,
             const uint32_t* __restrict__ dst_qn, int ls, int ld, int logn,
             int lane_bits, int groups, int tile_bits, int gacc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lanes = 1 << lane_bits;
  const int rows = groups * G;  // ld padded to whole groups
  // [ls][lanes] raw source tile, [ls] source constants, [ls][lanes]
  // scaled tile, [rows] (d, dn), [ls][rows] constants
  longlong2* s_x = reinterpret_cast<longlong2*>(smem);
  uint4* s_src = reinterpret_cast<uint4*>(s_x + ls * lanes);
  uint2* s_t = reinterpret_cast<uint2*>(s_src + ls);
  uint2* s_dst = s_t + ls * lanes;
  uint32_t* s_c = reinterpret_cast<uint32_t*>(s_dst + rows);

  const int nt = blockDim.x, h = threadIdx.x;
  const size_t row = size_t(1) << (logn - 1);  // a row in 16-byte pairs
  const size_t pair0 = size_t(blockIdx.x & ((1u << tile_bits) - 1))
                       << lane_bits;
  const size_t b = blockIdx.x >> tile_bits;

  const longlong2* src = x + b * ls * row + pair0;
#ifndef HE2_BCONV_NO_LOAD  // study builds (tools/ntt_study.py --bconv)
  for (int k = h; k < ls * lanes; k += nt)
    copy16_async(s_x + k,
                 src + size_t(k >> lane_bits) * row + (k & (lanes - 1)));
#endif
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#pragma unroll 4
  for (int k = h; k < ls * rows; k += nt) {
    const int i = k / rows, j = k - i * rows;
    s_c[k] = j < ld ? cm[i * ld + j] : 0u;
  }
  for (int i = h; i < ls; i += nt)
    s_src[i] = make_uint4(qhat_inv[i], src_q[i], src_qn[i], 0u);
  for (int j = h; j < rows; j += nt) {
    const int jj = min(j, ld - 1);  // a padding row computes, never stores
    s_dst[j] = make_uint2(dst_q[jj], dst_qn[jj]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int k = h; k < ls * lanes; k += nt) {  // scale the tile once
    const uint4 s = s_src[k >> lane_bits];
    const longlong2 v = s_x[k];
    s_t[k] = make_uint2(mont_mul(static_cast<uint32_t>(v.x), s.x, s.y, s.z),
                        mont_mul(static_cast<uint32_t>(v.y), s.x, s.y, s.z));
  }
  __syncthreads();

  const int lane = h & (lanes - 1);
  longlong2* dst = y + b * ld * row + pair0 + lane;
  for (int grp = h >> lane_bits; grp < groups; grp += nt >> lane_bits) {
    const int j0 = grp * G;
    uint64_t acc[G][kCols];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g][0] = acc[g][1] = 0;
    int left = gacc;
    for (int i = 0; i < ls; ++i) {
      const uint2 t = s_t[(i << lane_bits) + lane];
      const uint32_t* c = s_c + i * rows + j0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        acc[g][0] += static_cast<uint64_t>(t.x) * c[g];
        acc[g][1] += static_cast<uint64_t>(t.y) * c[g];
      }
      if (--left == 0 || i + 1 == ls) {  // uniform across the block
        left = gacc;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint2 d = s_dst[j0 + g];
#pragma unroll
          for (int k = 0; k < kCols; ++k)
            acc[g][k] = static_cast<uint64_t>(fold(
                            mont_redc_lazy(acc[g][k], d.x, d.y), 2 * d.x))
                        << 32;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = j0 + g;
#ifdef HE2_BCONV_NO_STORE  // study builds: compute, but store (almost) nothing
      if (j < ld && static_cast<uint32_t>(acc[g][0] >> 32) == 0xffffffffu)
#else
      if (j < ld)
#endif
      {
        const uint32_t d = s_dst[j].x;
        dst[size_t(j) * row] =
            make_longlong2(fold(static_cast<uint32_t>(acc[g][0] >> 32), d),
                           fold(static_cast<uint32_t>(acc[g][1] >> 32), d));
      }
    }
  }
}

using Kernel = decltype(&bconv_kernel<2>);

static Kernel kernel_for(long long g) {
  switch (g) {
    case 2: return bconv_kernel<2>;
    case 4: return bconv_kernel<4>;
    case 6: return bconv_kernel<6>;
    case 9: return bconv_kernel<9>;
    default: return nullptr;
  }
}

static int log2_exact(long long v) {
  int b = 0;
  while ((1LL << b) < v) ++b;
  return (1LL << b) == v ? b : -1;
}

// Geometry from the wrapper (kernels/bconv/ops.py: geometry): g destination
// rows a group (2, 4, 6 or 9), `groups` = ceil(ld / g), `lanes` column pairs a
// tile and `tiles` tiles a row (lanes * kCols * tiles = N, both powers of
// two), `threads` (a multiple of lanes) a block; one launch of batch *
// tiles blocks.  cm holds (qhat_i mod d_j) in Montgomery form, (ls, ld);
// gacc source rows go into a sum before it is reduced.  x and y must be
// 16-byte aligned.
extern "C" int bconv(const int64_t* x, int64_t* y, const uint32_t* qhat_inv,
                     const uint32_t* src_q, const uint32_t* src_qn,
                     const uint32_t* cm, const uint32_t* dst_q,
                     const uint32_t* dst_qn, long long batch, long long ls,
                     long long ld, long long logn, long long gacc, long long g,
                     long long lanes, long long threads, long long tiles,
                     long long groups, cudaStream_t st) {
  const Kernel kernel = kernel_for(g);
  const int lane_bits = log2_exact(lanes), tile_bits = log2_exact(tiles);
  const long long blocks = batch * tiles;
  if (!kernel || ls < 1 || ls > kMaxSrc || ld < 1 || logn < 1 || gacc < 1 ||
      lane_bits < 0 || tile_bits < 0 || threads < lanes ||
      threads > kMaxThreads || threads % lanes ||
      lanes * kCols * tiles != (1LL << logn) || groups != (ld + g - 1) / g ||
      blocks < 1 || blocks > 0x7fffffffLL ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16)
    return cudaErrorInvalidValue;
  const size_t smem =
      size_t(ls * lanes) * (sizeof(longlong2) + sizeof(uint2)) +
      size_t(ls) * sizeof(uint4) +
      size_t(groups * g) * (sizeof(uint2) + ls * sizeof(uint32_t));
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  kernel<<<unsigned(blocks), unsigned(threads), smem, st>>>(
      reinterpret_cast<const longlong2*>(x), reinterpret_cast<longlong2*>(y),
      qhat_inv, src_q, src_qn, cm, dst_q, dst_qn, int(ls), int(ld), int(logn),
      lane_bits, int(groups), tile_bits, int(gacc));
  e = cudaGetLastError();
  if (e == cudaSuccess) log_launch(1);
  return e;
}

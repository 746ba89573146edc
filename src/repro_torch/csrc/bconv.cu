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
//   * Any number of source rows, any 8-byte aligned operand: at most
//     kChunk source rows of a 16-byte aligned operand (every shape of the
//     repo's dnum > 1 chains) take bconv_kernel, which loads its tile
//     once.  More rows (ModDown at dnum = 1: 36), or an operand 8 bytes past
//     a 16-byte boundary, take bconv_tc_kernel below, which does the sum on
//     the int8 tensor cores; an unaligned operand is loaded with two 8-byte
//     copies a pair of columns.
#include <cuda_runtime.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "launch_log.cuh"
#include "modarith.cuh"

using namespace he2;

constexpr int kChunk = 32;  // source rows in shared memory at a time
constexpr int kCols = 2;
constexpr int kMaxThreads = 512;

__device__ __forceinline__ void copy16_async(void* smem_dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy8_async(void* smem_dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}

// At most kChunk source rows, 16-byte aligned: the tile is loaded once.
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

// ---------------------------------------------------------------------------
// Tensor-core kernel: more than kChunk source rows, or an operand 8 bytes past
// a 16-byte boundary (the rest take bconv_kernel above).
//
// The sum y_j = sum_i t_i * c_ij mod d_j (c_ij = qhat_i mod d_j in normal
// form, t_i, c_ij < 2^30) is a matrix product of (coefficients x ls) by
// (ls x ld), done exactly on the int8 tensor cores.  Both factors are split
// into their four bytes, t = sum_a t[a] 2^(8a), c = sum_b c[b] 2^(8b), and
// the byte products are summed by byte weight k = a + b in int32:
//   S_k[coef][j] = sum_i sum_a t_i[a] * c_ij[k - a],  k = 0..6,
// with mma.sync m16n8k32 u8.u8.s32.  The depth of the product runs over
// (source row i, byte a), K = 4 i + a, so an A fragment register is a scaled
// source word as it is (its four bytes are its four K entries) and needs no
// byte shuffling; the B fragment of weight k is the constant word with its
// bytes permuted (one PRMT: byte a of it is byte k - a of c, or 0).  A sum
// is below ls * 4 * 255^2: int32 holds it for ls up to 2^13.  The epilogue
// recombines y = sum_k S_k 2^(8k) mod d_j as one Montgomery reduction of
//   W = r 2^32 + sum_k S_k * (2^(8k + 32) mod d_j),
// r the carried residue of the previous chunks (0 in the first): seven
// 32 x 32 -> 64 products and one reduction an output word, where
// bconv_kernel does ls products on the integer pipe.  W < d 2^32 + d ls 2^20 stays below 2^63 for a chunk
// of kTcChunk rows, and the reduced value below 2.02 d, folded below d.
//
// Grid: as many blocks as the card holds at once, each looping over work
// items, an item a (batch row, tile of kTcCoefs coefficients).  A block
// copies kTcChunk source rows of its tile and their constants to shared
// memory by cp.async; each of its kTcWarps warps takes 16 coefficients (one
// m16 tile), reads its A fragments, scaling each source word once as it
// reads it (a Montgomery product, t_i = x_i qhat_inv_i mod q_i < q_i), and
// takes them through every 8-row tile of destination rows.  Once every warp
// holds its fragments the raw buffer is free, so the next chunk (or the
// next item's first) loads while the current one multiplies.  With at most
// kTcChunk source rows the K steps are unrolled (a template argument) and
// the constants load once a block; with more, a chunk's constants load
// with it, into the other of two buffers, and each output's residue is
// carried in shared memory from chunk to chunk.
//
// Bound on the H100 at the dnum = 1 ModDown, (2, 36) -> (2, 36), N = 2^16:
// device memory, 8 B read per source word and 8 B written per destination
// word (0.0225 ms).  The integer pipe does 36 scalings (3 products) and 36
// x 9 epilogue products a coefficient (3.4 us at 16.7 T/s), the tensor cores
// 5 x 7 x 5 m16n8k32 products a 16 x 8 tile (3.1 G multiply-adds, 3.1 us at
// 1979 TOPS dense).  bconv_tc_host in kernels/modops.py repeats this
// arithmetic on the host.
#ifndef HE2_TC_WARPS  // study builds (tools/ntt_study.py --bconv) vary it
#define HE2_TC_WARPS 8
#endif
constexpr int kTcWarps = HE2_TC_WARPS;
constexpr int kTcCoefs = 16 * kTcWarps;  // coefficients a block
constexpr int kTcChunk = 64;             // source rows a chunk (8 K steps)
constexpr int kTcRow = kTcCoefs + 4;     // raw-tile row stride, in int64
constexpr int kTcCarry = kTcCoefs + 4;   // carried-residue row stride
constexpr int kTcSums = 7;               // byte weights 0..6

// The byte selector of weight k: byte a of __byte_perm(c, 0, tc_sel(k)) is
// byte k - a of c, or 0 (selector 4 picks a byte of the zero word).
__host__ __device__ constexpr unsigned tc_sel(int k) {
  unsigned s = 0;
  for (int a = 0; a < 4; ++a)
    s |= static_cast<unsigned>(k - a >= 0 && k - a <= 3 ? k - a : 4) << (4 * a);
  return s;
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
#ifdef HE2_TC_NO_MMA  // study builds: the products' data flow, no product
  d[0] += a[0] ^ b0;
  d[1] += a[1] ^ b1;
  d[2] += a[2] ^ b0;
  d[3] += a[3] ^ b1;
#else
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
#endif
}

// Shared memory of bconv_tc_kernel, in bytes (the launch sizes it so).
__host__ __device__ inline size_t tc_smem(int ls, int cs) {
  const int chunk = ls < kTcChunk ? ls : kTcChunk;
  const int kpad = (chunk + 7) & ~7;
  const bool many = ls > kTcChunk;
  return size_t(chunk) * kTcRow * 8 +            // raw tile
         size_t(many ? 2 : 1) * chunk * 16 +     // source constants
         size_t(many ? 2 : 1) * kpad * cs * 4 +  // constants
         size_t(kTcSums + 2) * cs * 4 +          // byte weights, d, dn
         (many ? size_t(cs) * kTcCarry * 4 : 0);  // carried residues
}

// src: (ls) rows of (qhat_inv_i in Montgomery form, q_i, -q_i^-1 mod 2^32,
// 0); c: (ceil(ls / 8) * 8, cs) = qhat_i mod d_j, zero past ls and ld; epi:
// (kTcSums + 2, cs), rows 2^(8k + 32) mod d_j, then d_j and -d_j^-1 mod 2^32
// (kernels/bconv/ops.py: BConvConsts lays them out, cs = tc_stride(ld)).
// Work item t is coefficient tile t & (2^tile_bits - 1) of batch row
// t >> tile_bits; block k takes items k, k + gridDim.x, ...  STEPS > 0: at
// most kTcChunk source rows, ceil(ls / 8) = STEPS K steps of 8 rows; STEPS
// = 0: more rows, kTcChunk at a time, the K steps counted at run time.
template <int STEPS>
__global__ void __launch_bounds__(32 * kTcWarps)
bconv_tc_kernel(const int64_t* __restrict__ x, int64_t* __restrict__ y,
                const uint4* __restrict__ src_c, const uint32_t* __restrict__ c,
                const uint32_t* __restrict__ epi, int ls, int ld, int logn,
                int tile_bits, long long items, int cs, int aligned) {
  constexpr bool many = STEPS == 0;
  constexpr int kSteps = many ? kTcChunk / 8 : STEPS;  // unrolled K steps
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunk = min(ls, kTcChunk);
  const int kpad = (chunk + 7) & ~7;
  int64_t* s_x = reinterpret_cast<int64_t*>(smem);  // [chunk][kTcRow]
  uint4* s_src = reinterpret_cast<uint4*>(s_x + chunk * kTcRow);
  uint32_t* s_c = reinterpret_cast<uint32_t*>(s_src + (many ? 2 : 1) * chunk);
  uint32_t* s_e = s_c + (many ? 2 : 1) * kpad * cs;  // [kTcSums + 2][cs]
  uint32_t* s_r = s_e + (kTcSums + 2) * cs;  // [cs][kTcCarry] when many
  const uint32_t* s_d = s_e + kTcSums * cs;
  const uint32_t* s_dn = s_d + cs;

  const int nt = blockDim.x, h = threadIdx.x;
  const long long n = 1LL << logn;
  const long long tile_mask = (1LL << tile_bits) - 1;
  const int ntiles = (ld + 7) >> 3;

  // source rows [c0, c0 + cl) of item t into the raw tile
  auto fetch_x = [&](long long t, int c0, int cl) {
#ifndef HE2_BCONV_NO_LOAD  // study builds (tools/ntt_study.py --bconv)
    const long long coef0 = (t & tile_mask) * kTcCoefs;
    const int64_t* src = x + (t >> tile_bits) * ls * n + coef0;
    for (int k = h; k < cl * (kTcCoefs / 2); k += nt) {
      const int i = k / (kTcCoefs / 2), p = 2 * (k - i * (kTcCoefs / 2));
      int64_t* to = s_x + i * kTcRow + p;
      const int64_t* at = src + static_cast<long long>(c0 + i) * n + p;
      if (coef0 + p >= n) {  // past a ring of fewer than kTcCoefs words
        to[0] = to[1] = 0;
      } else if (aligned) {
        copy16_async(to, at);
      } else {
        copy8_async(to, at);
        copy8_async(to + 1, at + 1);
      }
    }
#endif
  };
  // the constants of source rows [c0, c0 + cl) into buffers buf
  auto fetch_c = [&](int c0, int cl, int buf) {
    const int rows = (cl + 7) & ~7;
    uint32_t* cc = s_c + buf * kpad * cs;
    const uint32_t* from = c + static_cast<long long>(c0) * cs;
    for (int k = 4 * h; k < rows * cs; k += 4 * nt)
      copy16_async(cc + k, from + k);
    for (int i = h; i < cl; i += nt)
      copy16_async(s_src + buf * chunk + i, src_c + c0 + i);
  };

  const int warp = h >> 5, lane = h & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = warp * 16;
  long long item = blockIdx.x;
  for (int k = 4 * h; k < (kTcSums + 2) * cs; k += 4 * nt)
    copy16_async(s_e + k, epi + k);
  fetch_c(0, chunk, 0);
  fetch_x(item, 0, chunk);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // seq counts the chunks done, so that the constants alternate between
  // their two buffers across items too
  for (int seq = 0; item < items; item += gridDim.x) {
    const long long b = item >> tile_bits;
    const long long coef0 = (item & tile_mask) * kTcCoefs;
    for (int c0 = 0; c0 < ls; c0 += kTcChunk, ++seq) {
      const int cl = min(kTcChunk, ls - c0);
      const int steps = many ? (cl + 7) >> 3 : STEPS;
      const int buf = many ? (seq & 1) : 0;
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();  // the chunk is in; every warp is done with the last
      // the warp's A fragments for every K step, each source word scaled
      // as it is read (rows past the chunk are zero)
      const uint4* sc = s_src + buf * chunk;
      uint32_t a[kSteps][4];
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        if (many && ks >= steps) break;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = ks * 8 + half * 4 + tg;
          uint32_t v0 = 0, v1 = 0;
          if (r < cl) {
            const uint4 q = sc[r];
            const int64_t* row = s_x + r * kTcRow + m0 + g;
            v0 = mont_mul(static_cast<uint32_t>(row[0]), q.x, q.y, q.z);
            v1 = mont_mul(static_cast<uint32_t>(row[8]), q.x, q.y, q.z);
          }
          a[ks][2 * half] = v0;
          a[ks][2 * half + 1] = v1;
        }
      }
      __syncthreads();  // every warp has its fragments; the raw tile is free
      // the next chunk, or the next item's first, loads while this one
      // multiplies
      if (c0 + kTcChunk < ls) {
        const int nc = min(kTcChunk, ls - c0 - kTcChunk);
        fetch_c(c0 + kTcChunk, nc, (seq + 1) & 1);
        fetch_x(item, c0 + kTcChunk, nc);
      } else if (item + gridDim.x < items) {
        if (many) fetch_c(0, chunk, (seq + 1) & 1);
        fetch_x(item + gridDim.x, 0, chunk);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      const uint32_t* cc = s_c + buf * kpad * cs;
      const bool last = c0 + kTcChunk >= ls;
      // this thread's outputs: coefficients m0 + g (+ 8), rows n0 + 2 tg
      // (+ 1) of each tile of 8 destination rows
      int64_t* yt = y + (b * ld + 2 * tg) * n + coef0 + m0 + g;
      const bool in0 = coef0 + m0 + g < n, in1 = coef0 + m0 + g + 8 < n;
      for (int tile = 0; tile < ntiles; ++tile) {
        const int n0 = tile * 8;
        int acc[kTcSums][4];
#pragma unroll
        for (int w = 0; w < kTcSums; ++w)
          acc[w][0] = acc[w][1] = acc[w][2] = acc[w][3] = 0;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          if (many && ks >= steps) break;
          const uint32_t w0 = cc[(ks * 8 + tg) * cs + n0 + g];
          const uint32_t w1 = cc[(ks * 8 + 4 + tg) * cs + n0 + g];
#pragma unroll
          for (int w = 0; w < kTcSums; ++w)
            mma_u8(acc[w], a[ks], __byte_perm(w0, 0u, tc_sel(w)),
                   __byte_perm(w1, 0u, tc_sel(w)));
        }
        // acc[.][e]: coefficient m0 + g (+ 8 for e >= 2), row n0 + 2 tg
        // (+ 1 for odd e)
#pragma unroll
        for (int col = 0; col < 2; ++col) {
          const int j = n0 + 2 * tg + col;
          uint32_t mk[kTcSums];
#pragma unroll
          for (int w = 0; w < kTcSums; ++w) mk[w] = s_e[w * cs + j];
          const uint32_t d = s_d[j], dn = s_dn[j];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + col, m = m0 + g + 8 * half;
            uint64_t sum =
                c0 == 0 ? 0
                        : static_cast<uint64_t>(s_r[j * kTcCarry + m]) << 32;
#ifdef HE2_TC_NO_EPILOGUE  // study builds: the sums kept, not recombined
            uint32_t r = 0;
#pragma unroll
            for (int w = 0; w < kTcSums; ++w)
              r ^= static_cast<uint32_t>(acc[w][e]);
            r = fold(r ^ static_cast<uint32_t>(sum >> 32), d);
#else
#pragma unroll
            for (int w = 0; w < kTcSums; ++w)
              sum += static_cast<uint64_t>(static_cast<uint32_t>(acc[w][e])) *
                     mk[w];
            const uint32_t r = fold(fold(mont_redc_lazy(sum, d, dn), 2 * d), d);
#endif
            if (!last) {
              s_r[j * kTcCarry + m] = r;
            } else if (j < ld && (half ? in1 : in0)) {
#ifdef HE2_BCONV_NO_STORE  // study builds: compute, store (almost) nothing
              if (r == 0xffffffffu)
#endif
                yt[(n0 + col) * n + 8 * half] = r;
            }
          }
        }
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

using TcKernel = decltype(&bconv_tc_kernel<0>);

// The tensor-core kernel for ls source rows: its K steps unrolled for one
// chunk, counted at run time for several.
static TcKernel tc_kernel_for(long long ls) {
  switch (ls > kTcChunk ? 0 : (ls + 7) / 8) {
    case 1: return bconv_tc_kernel<1>;
    case 2: return bconv_tc_kernel<2>;
    case 3: return bconv_tc_kernel<3>;
    case 4: return bconv_tc_kernel<4>;
    case 5: return bconv_tc_kernel<5>;
    case 6: return bconv_tc_kernel<6>;
    case 7: return bconv_tc_kernel<7>;
    case 8: return bconv_tc_kernel<8>;
    default: return bconv_tc_kernel<0>;
  }
}

static int log2_exact(long long v) {
  int b = 0;
  while ((1LL << b) < v) ++b;
  return (1LL << b) == v ? b : -1;
}

// Row stride of the tensor-core kernel's constants: whole tiles of 8
// destination rows, padded to 8 mod 32 words so that a warp's B fragment
// loads (4 rows x 8 columns) fall in 32 different banks.
static int tc_stride(long long ld) {
  const int n8 = static_cast<int>((ld + 7) / 8 * 8);
  return n8 + (8 - n8 % 32 + 32) % 32;
}

// As many blocks of the tensor-core kernel `kernel` as the current device
// holds at once with `smem` bytes of shared memory each, in *grid; the
// first call for a (device, kernel, smem) asks the occupancy (and raises
// the kernel's shared-memory limit if smem exceeds every earlier size),
// later ones read the answer kept here.
static cudaError_t tc_grid(TcKernel kernel, size_t smem, long long* grid) {
  struct Entry {
    int dev;
    TcKernel kernel;
    size_t smem;
    long long grid;
  };
  static std::mutex mu;
  static std::vector<Entry> seen;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  size_t limit = 0;  // the kernel's shared-memory limit on dev, once set
  for (const Entry& x : seen) {
    if (x.dev != dev || x.kernel != kernel) continue;
    if (x.smem == smem) {
      *grid = x.grid;
      return cudaSuccess;
    }
    limit = std::max(limit, x.smem);
  }
  if (smem > limit &&
      (e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(smem))) != cudaSuccess)
    return e;
  int sms = 0, per_sm = 0;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, 32 * kTcWarps, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = 1LL * per_sm * sms;
  seen.push_back({dev, kernel, smem, *grid});
  return cudaSuccess;
}

// Geometry from the wrapper (kernels/bconv/ops.py: geometry) for
// bconv_kernel: g destination rows a group (2, 4, 6 or 9), `groups` =
// ceil(ld / g), `lanes` column pairs a tile and `tiles` tiles a row (lanes *
// kCols * tiles = N, both powers of two), `threads` (a multiple of lanes) a
// block; one launch of batch * tiles blocks.  cm holds (qhat_i mod d_j) in
// Montgomery form, (ls, ld); gacc source rows go into a sum before it is
// reduced.  bconv_tc_kernel takes tc_src, tc_c and tc_epi (its comment says
// their layout; cs = tc_stride(ld)) and sets its own geometry: batch *
// ceil(N / kTcCoefs) blocks of 32 * kTcWarps threads.  At most kChunk
// source rows of a 16-byte aligned operand take bconv_kernel, the rest the
// tensor-core kernel (every shape, in a -DHE2_BCONV_TC_ONLY study build:
// tools/ntt_study.py --bconv, tools/bconv_ab.py).  x must be 8-byte
// aligned, y 16-byte aligned, the tc_* arrays 16-byte aligned.  One launch
// a call.
extern "C" int bconv(const int64_t* x, int64_t* y, const uint32_t* qhat_inv,
                     const uint32_t* src_q, const uint32_t* src_qn,
                     const uint32_t* cm, const uint32_t* dst_q,
                     const uint32_t* dst_qn, const uint32_t* tc_src,
                     const uint32_t* tc_c, const uint32_t* tc_epi,
                     long long batch, long long ls, long long ld,
                     long long logn, long long gacc, long long g,
                     long long lanes, long long threads, long long tiles,
                     long long groups, cudaStream_t st) {
  const int lane_bits = log2_exact(lanes), tile_bits = log2_exact(tiles);
  const long long blocks = batch * tiles;
  if (!kernel_for(g) || ls < 1 || ld < 1 || logn < 1 || gacc < 1 ||
      lane_bits < 0 || tile_bits < 0 || threads < lanes ||
      threads > kMaxThreads || threads % lanes ||
      lanes * kCols * tiles != (1LL << logn) || groups != (ld + g - 1) / g ||
      blocks < 1 || blocks > 0x7fffffffLL || ls > (1LL << 20) ||
      reinterpret_cast<uintptr_t>(x) % 8 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaError_t e;
#ifdef HE2_BCONV_TC_ONLY  // study builds: every shape on the tensor cores
  constexpr bool narrow = false;
#else
  constexpr bool narrow = true;
#endif
  if (narrow && ls <= kChunk && aligned) {
    const size_t smem =
        size_t(ls * lanes) * (sizeof(longlong2) + sizeof(uint2)) +
        size_t(ls) * sizeof(uint4) +
        size_t(groups * g) * (sizeof(uint2) + ls * sizeof(uint32_t));
    const Kernel kernel = kernel_for(g);
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    kernel<<<unsigned(blocks), unsigned(threads), smem, st>>>(
        reinterpret_cast<const longlong2*>(x), reinterpret_cast<longlong2*>(y),
        qhat_inv, src_q, src_qn, cm, dst_q, dst_qn, int(ls), int(ld),
        int(logn), lane_bits, int(groups), tile_bits, int(gacc));
  } else {
    const long long n = 1LL << logn;
    const long long tc_tiles = (n + kTcCoefs - 1) / kTcCoefs;
    const int tc_bits = log2_exact(tc_tiles);
    const long long items = batch * tc_tiles;
    const int cs = tc_stride(ld);
    const size_t smem = tc_smem(int(ls), cs);
    if (tc_bits < 0 ||
        (reinterpret_cast<uintptr_t>(tc_src) |
         reinterpret_cast<uintptr_t>(tc_c) |
         reinterpret_cast<uintptr_t>(tc_epi)) % 16)
      return cudaErrorInvalidValue;
    const TcKernel kernel = tc_kernel_for(ls);
    long long grid = 0;
    if ((e = tc_grid(kernel, smem, &grid)) != cudaSuccess) return e;
    grid = std::min(items, grid);  // blocks loop over the items
    kernel<<<unsigned(grid), 32 * kTcWarps, smem, st>>>(
        x, y, reinterpret_cast<const uint4*>(tc_src), tc_c, tc_epi, int(ls),
        int(ld), int(logn), tc_bits, items, cs, int(aligned));
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) log_launch(1);
  return e;
}

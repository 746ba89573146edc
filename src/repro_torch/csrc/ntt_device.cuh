// Negacyclic NTT of whole rows in one launch, natural order at both ends,
// shared by ntt.cu and modup.cu.
//
// Forward: psi^i pre-twist, DIF stages s = logn-1 .. 0, then the
// bit-reversal, so evaluation point k (psi^(2k+1)) lands at index k.
// Inverse: the bit-reversal, DIT stages s = 0 .. logn-1, then the
// psi^-i n^-1 post-twist.  Stage s with m = 2^s pairs (p, p + m) inside
// blocks of 2m and uses twiddle tw[m + (p mod m)] (the flat tree layout
// of the JAX package's kernels/ntt).
//
// A row lives on chip from its first read to its last write.  One limb at
// logN = 16 is 256 KB, more than a block's 227 KB of shared memory, so a
// row is spread over a thread-block cluster of C = 2^LOGC blocks, each
// holding M = N / C words in dynamic shared memory:
//   * the LOGC top stages mix words i + r M (r < C) of the same column i;
//     the forward runs them in registers right after the load and writes
//     word i + r M to block r's shared memory (distributed shared
//     memory); the inverse reads the column back from the C blocks and
//     runs them in registers right before the store;
//   * the other logm = logn - LOGC stages stay inside each block's M
//     words: passes of up to 5 stages, each thread holding the 32 words
//     of one butterfly group in registers, with the twiddles of these
//     stages copied (cp.async, during the first phase) into a second
//     M-word region of shared memory;
//   * the bit-reversal is a regrouping through distributed shared memory:
//     after the DIF, block r holds index k = j C + bitrev_c(r) (j < M) at
//     offset bitrev_logm(j); each block regroups its words by the block
//     that stores them, and every block then reads its group from all C
//     blocks (32 consecutive words a warp), so that it stores a natural
//     slice [r M, (r+1) M), coalesced.  The inverse loads its slice
//     coalesced and runs the same exchange backwards (a third region).
// Device memory sees each input word once and each output word once.
// Rows that fit one block (logn <= 13) use LOGC = 0 and no cluster.
//
// Shared memory is swizzled (swz) so that every pass, and the
// bit-reversed reads and writes, hit 32 distinct banks per warp.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "launch_log.cuh"
#include "modarith.cuh"

namespace he2 {

namespace cg = cooperative_groups;

// Phase timestamps (tools/ntt_study.py builds ntt.cu with -DHE2_PROBE):
// thread 0 of each block records the global timer at PROBE(i) into
// he2_probe[block * 8 + i].  Without HE2_PROBE, PROBE(i) is nothing.
#ifdef HE2_PROBE
__device__ unsigned long long he2_probe[1 << 16];
#define PROBE(i)                                                      \
  do {                                                                \
    if (threadIdx.x == 0) {                                           \
      unsigned long long t_;                                          \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \
      he2_probe[blockIdx.x * 8 + (i)] = t_;                           \
    }                                                                 \
  } while (0)
#else
#define PROBE(i) \
  do {           \
  } while (0)
#endif

constexpr int kMinLogN = 5;
constexpr int kMaxLogN = 17;
constexpr int kMaxLogC = 3;    // portable cluster sizes 1, 2, 4, 8
constexpr int kMaxLogM = 14;   // 2 or 3 regions of 64 KB a block
constexpr int kPassBits = 5;   // stages a thread runs in registers
constexpr int kThreads = 256;
constexpr int kMinBlocks = 2;  // at most 128 registers a thread
// The loops that touch device memory issue a batch of independent loads
// before using any of them: with 16 warps an SM, one load in flight a
// thread leaves the memory idle.
constexpr int kBatch = 16;     // words a thread loads in the first phase
constexpr int kWords = 8;      // words a thread moves at once elsewhere

// Per-row tables.  Row r of a launch reads limb r % l; the twiddles and
// the moduli come from global table row tw_row[r % l], the twist from
// twist_row[r % l] (or row r % l of a dense per-call table when null).
struct NttTables {
  const uint32_t* twist;
  const int32_t* twist_row;
  const uint32_t* tw;
  const int32_t* tw_row;
  const uint32_t* q;
  const uint32_t* qn;
  int l;
  int logn;
};

// All digits of one ModUp.  Forward row r is (batch b, digit d,
// destination limb e) with r = (b * dnum + d) * l_ext + e.  An own limb
// (own[d * l_ext + e] >= 0) is that input row, passed through; any other
// is the reduce y_e = sum_i t_i * (qhat_i mod d_e) mod d_e over the
// digit's source rows of the (B, l, N) scaled INTT output t.
struct ModUpArgs {
  const uint32_t* t;      // (B, l, N) coefficients, scale folded in
  const uint32_t* cm;     // (dnum, alpha, l_ext) Montgomery wrt d_e
  const int32_t* own;     // (dnum, l_ext) input row or -1
  const int32_t* digit;   // (dnum, 2) first source row, row count
  int l, l_ext, dnum, alpha;
};

enum Src { kSrcI64, kSrcModUp };
enum Dst { kDstI64, kDstU32 };

struct Row {
  uint32_t q, qn;
  const uint32_t* tw;
  const uint32_t* twist;
};

__device__ __forceinline__ Row row_tables(const NttTables& t, int row) {
  const size_t n = size_t(1) << t.logn;
  const int r = row % t.l;
  const int tr = t.tw_row[r];
  const int sr = t.twist_row ? t.twist_row[r] : r;
  return Row{t.q[tr], t.qn[tr], t.tw + size_t(tr) * n, t.twist + size_t(sr) * n};
}

// Bijective on [0, M) and linear over XOR: bits 5..9 and 10..14 are
// folded into the bank bits.
__device__ __forceinline__ int swz(int off) {
  return off ^ ((off >> 5) & 31) ^ ((off >> 10) & 31);
}

__device__ __forceinline__ int bit_rev(int k, int bits) {
  return bits ? static_cast<int>(__brev(static_cast<unsigned>(k)) >> (32 - bits)) : 0;
}

template <int LOGC>
__device__ __forceinline__ uint32_t* smem_of(uint32_t* sh, int off, int rank) {
  if constexpr (LOGC == 0) {
    return sh + off;
  } else {
    return cg::this_cluster().map_shared_rank(sh + off, rank);
  }
}

template <int LOGC>
__device__ __forceinline__ void row_sync() {
  if constexpr (LOGC == 0)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

// Butterflies keep words in [0, 2q) (q < 2^30, so 4q fits 32 bits) and
// reduce fully only at the twist or on the way out.  DIF: (u, v) ->
// (u + v, (u - v) w); DIT: (u, v) -> (u + v w, u - v w).
template <bool FWD>
__device__ __forceinline__ void butterfly(uint32_t& a, uint32_t& b, uint32_t w,
                                          const Row& rt) {
  const uint32_t q2 = 2 * rt.q;
  if constexpr (FWD) {
    const uint32_t u = a, v = b;
    a = fold(u + v, q2);
    b = mont_mul_lazy(u + q2 - v, w, rt.q, rt.qn);
  } else {
    const uint32_t u = a;
    const uint32_t vw = mont_mul_lazy(b, w, rt.q, rt.qn);
    a = fold(u + vw, q2);
    b = fold(u + q2 - vw, q2);
  }
}

// Stages [s_lo, s_lo + R) of the block's M = 2^logm words.  A group is
// every word sharing the bits outside [s_lo, s_lo + R); consecutive
// threads take consecutive groups.  Local stages (s < logm) use the same
// twiddles in every block of a cluster: p mod m = off mod m.
template <int R, bool FWD>
__device__ __forceinline__ void pass(uint32_t* sh, const uint32_t* tw, int s_lo,
                                     int logm, const Row& rt) {
  constexpr int K = 1 << R;
  const int groups = 1 << (logm - R);
  const int low = (1 << s_lo) - 1;
  // swz is linear over XOR and base has no bit in [s_lo, s_lo + R), so
  // the byte offset of word k of a group is swz(base) ^ D(k), D(k) the XOR
  // of d[b] over the bits b of k
  uint32_t d[R];
#pragma unroll
  for (int b = 0; b < R; ++b) d[b] = uint32_t(swz(1 << (s_lo + b))) << 2;
  char* shb = reinterpret_cast<char*>(sh);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    const int glow = g & low;
    const int base = ((g >> s_lo) << (s_lo + R)) | glow;
    const uint32_t sb = uint32_t(swz(base)) << 2;
    uint32_t off[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      uint32_t o = sb;
#pragma unroll
      for (int b = 0; b < R; ++b)
        if (k & (1 << b)) o ^= d[b];
      off[k] = o;
    }
    uint32_t e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = *reinterpret_cast<uint32_t*>(shb + off[k]);
#pragma unroll
    for (int bb = 0; bb < R; ++bb) {
      const int b = FWD ? R - 1 - bb : bb;
      const int M = 1 << b;
      const int m = 1 << (s_lo + b);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (k & M) continue;
        const int j = ((k & (M - 1)) << s_lo) | glow;
        const uint32_t w = tw[m + j];
        butterfly<FWD>(e[k], e[k + M], w, rt);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) *reinterpret_cast<uint32_t*>(shb + off[k]) = e[k];
  }
  __syncthreads();
}

template <bool FWD>
__device__ __forceinline__ void run_pass(uint32_t* sh, const uint32_t* tw,
                                         int s_lo, int r, int logm,
                                         const Row& rt) {
  switch (r) {
    case 1: pass<1, FWD>(sh, tw, s_lo, logm, rt); break;
    case 2: pass<2, FWD>(sh, tw, s_lo, logm, rt); break;
    case 3: pass<3, FWD>(sh, tw, s_lo, logm, rt); break;
    case 4: pass<4, FWD>(sh, tw, s_lo, logm, rt); break;
    case 5: pass<5, FWD>(sh, tw, s_lo, logm, rt); break;
  }
}

// The block's logm local stages.  Every pass but the one at s_lo = 0
// starts at bit 5 or above, so a warp's 32 groups differ in the low five
// address bits; the s_lo = 0 pass relies on swz instead.
__device__ __forceinline__ void local_fwd(uint32_t* sh, const uint32_t* tw,
                                          int logm, const Row& rt) {
  int hi = logm;
  while (hi > kPassBits) {
    const int r = hi - kPassBits < kPassBits ? hi - kPassBits : kPassBits;
    run_pass<true>(sh, tw, hi - r, r, logm, rt);
    hi -= r;
  }
  run_pass<true>(sh, tw, 0, hi, logm, rt);
}

__device__ __forceinline__ void local_inv(uint32_t* sh, const uint32_t* tw,
                                          int logm, const Row& rt) {
  int lo = logm < kPassBits ? logm : kPassBits;
  run_pass<false>(sh, tw, 0, lo, logm, rt);
  while (lo < logm) {
    const int r = logm - lo < kPassBits ? logm - lo : kPassBits;
    run_pass<false>(sh, tw, lo, r, logm, rt);
    lo += r;
  }
}

// tw[0 .. M), the twiddles of the local stages, copied asynchronously
// into the second shared-memory region: the copy overlaps the first phase,
// and twiddles_ready() waits for it before the passes.
__device__ __forceinline__ const uint32_t* stage_twiddles(uint32_t* sh, int M,
                                                          const Row& rt) {
  uint32_t* tws = sh + M;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(tws));
  for (int c = threadIdx.x; c < M / 4; c += blockDim.x)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst + 16 * c), "l"(rt.tw + 4 * c) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  return tws;
}

__device__ __forceinline__ void twiddles_ready() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Split cluster barrier: arrive when the block starts, wait before the
// first write to another block's shared memory, so that every block of
// the cluster is running by then.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  return static_cast<int>(cg::this_cluster().block_rank());
}

// The LOGC top stages of column i, words e[r] = row[i + r M].
template <int LOGC>
__device__ __forceinline__ void top_fwd(uint32_t (&e)[1 << LOGC], int i,
                                        int logm, const Row& rt) {
#pragma unroll
  for (int b = LOGC - 1; b >= 0; --b) {
    const int Mb = 1 << b;
    const int m = 1 << (logm + b);
#pragma unroll
    for (int r = 0; r < (1 << LOGC); ++r) {
      if (r & Mb) continue;
      const int j = i + ((r & (Mb - 1)) << logm);
      butterfly<true>(e[r], e[r + Mb], __ldg(rt.tw + m + j), rt);
    }
  }
}

template <int LOGC>
__device__ __forceinline__ void top_inv(uint32_t (&e)[1 << LOGC], int i,
                                        int logm, const Row& rt) {
#pragma unroll
  for (int b = 0; b < LOGC; ++b) {
    const int Mb = 1 << b;
    const int m = 1 << (logm + b);
#pragma unroll
    for (int r = 0; r < (1 << LOGC); ++r) {
      if (r & Mb) continue;
      const int j = i + ((r & (Mb - 1)) << logm);
      butterfly<false>(e[r], e[r + Mb], __ldg(rt.tw + m + j), rt);
    }
  }
}

// ---------------------------------------------------------------- forward
// Grid: rows * C blocks, cluster (C, 1, 1).  SRC = kSrcI64 reads int64
// `in`; SRC = kSrcModUp builds row r of a ModUp from `mu` (own rows copied
// from `in`).
template <int LOGC, int SRC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
fwd_kernel(NttTables t, const int64_t* in, int64_t* out, ModUpArgs mu) {
  extern __shared__ uint32_t sh[];
  constexpr int C = 1 << LOGC;
  constexpr int U = C < kBatch ? kBatch / C : 1;  // columns a batch
  const int logm = t.logn - LOGC;
  const int M = 1 << logm;
  const size_t n = size_t(1) << t.logn;
  const int row = blockIdx.x >> LOGC;
  const int rank = LOGC ? cluster_rank() : 0;
  const int T = blockDim.x;
  int64_t* y = out + size_t(row) * n;

  const uint32_t* src = nullptr;
  const uint32_t* cm = nullptr;
  int ls = 0;
  const int64_t* x = in + size_t(row) * n;
  if constexpr (SRC == kSrcModUp) {
    const int e = row % mu.l_ext;
    const int d = (row / mu.l_ext) % mu.dnum;
    const int b = row / (mu.l_ext * mu.dnum);
    const int own = mu.own[d * mu.l_ext + e];
    if (own >= 0) {  // the whole cluster takes this branch: no barrier
      x = in + (size_t(b) * mu.l + own) * n + size_t(rank) * M;
      int64_t* yr = y + size_t(rank) * M;
      for (int k0 = threadIdx.x; k0 < M; k0 += T * kWords) {
        int64_t v[kWords];
#pragma unroll
        for (int u = 0; u < kWords; ++u)
          if (k0 + u * T < M) v[u] = x[k0 + u * T];
#pragma unroll
        for (int u = 0; u < kWords; ++u)
          if (k0 + u * T < M) yr[k0 + u * T] = v[u];
      }
      return;
    }
    src = mu.t + (size_t(b) * mu.l + mu.digit[2 * d]) * n;
    ls = mu.digit[2 * d + 1];
    cm = mu.cm + size_t(d) * mu.alpha * mu.l_ext + e;
  }
  const Row rt = row_tables(t, row);
  const uint32_t* tws = stage_twiddles(sh, M, rt);
  PROBE(0);

  // load, pre-twist, top LOGC stages, scatter to the owning blocks (once
  // every block of the cluster has started)
  if constexpr (LOGC > 0) cluster_arrive();
  const int cols = M >> LOGC;
  const int c0 = rank * cols;
  bool waited = false;
  for (int i0 = threadIdx.x; i0 < cols; i0 += T * U) {
    uint32_t e[U][C];
    if constexpr (SRC == kSrcI64) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < C; ++r)
          if (i0 + u * T < cols)
            e[u][r] = static_cast<uint32_t>(x[c0 + i0 + u * T + (r << logm)]);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < C; ++r) e[u][r] = 0;
      for (int s = 0; s < ls; ++s) {
        const uint32_t f = __ldg(cm + s * mu.l_ext);
        const uint32_t* ts = src + size_t(s) * n + c0 + i0;
        uint32_t v[U][C];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < C; ++r)
            if (i0 + u * T < cols) v[u][r] = ts[u * T + (r << logm)];
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int r = 0; r < C; ++r)
            if (i0 + u * T < cols)
              e[u][r] = add_mod(e[u][r], mont_mul(v[u][r], f, rt.q, rt.qn), rt.q);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = c0 + i0 + u * T;
      if (i0 + u * T >= cols) break;
#pragma unroll
      for (int r = 0; r < C; ++r)
        e[u][r] = mont_mul(e[u][r], __ldg(rt.twist + i + (r << logm)), rt.q, rt.qn);
      top_fwd<LOGC>(e[u], i, logm, rt);
      if constexpr (LOGC > 0) {
        if (!waited) cluster_wait();
        waited = true;
      }
#pragma unroll
      for (int r = 0; r < C; ++r) *smem_of<LOGC>(sh, swz(i), r) = e[u][r];
    }
  }
  if constexpr (LOGC > 0) {
    if (!waited) cluster_wait();
  }
  PROBE(1);
  twiddles_ready();
  row_sync<LOGC>();  // every word of the block has arrived
  PROBE(2);
  local_fwd(sh, tws, logm, rt);
  PROBE(3);

  // natural order out.  Block `rank` holds p = rank M + off, the value of
  // k = bitrev(p) = j C + bitrev_c(rank) with j = bitrev_logm(off); block
  // r' stores k in [r' M, (r' + 1) M), whose words sit in every block at
  // the offsets off = a + b C with a = bitrev_c(r') (b < M / C).
  if constexpr (LOGC == 0) {
    for (int j0 = threadIdx.x; j0 < M; j0 += T * kWords) {
      uint32_t v[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (j0 + u * T < M) v[u] = fold(sh[swz(bit_rev(j0 + u * T, logm))], rt.q);
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (j0 + u * T < M) y[j0 + u * T] = v[u];
    }
  } else {
    // 1. regroup locally by destination: word a + b C to a (M / C) + b
    uint32_t* grouped = sh + M;  // the twiddles are no longer needed
    const int B = M >> LOGC;
    for (int b = threadIdx.x; b < B; b += T) {
      uint32_t v[C];
#pragma unroll
      for (int a = 0; a < C; ++a) v[a] = sh[swz((b << LOGC) + a)];
#pragma unroll
      for (int a = 0; a < C; ++a) grouped[a * B + b] = v[a];
    }
    row_sync<LOGC>();  // every block's groups are ready
    // 2. read this block's group from every block (32 consecutive words a
    //    warp), into natural order k - rank M = bitrev(b) C + bitrev_c(s)
    const int a = bit_rev(rank, LOGC);
    const int logb = logm - LOGC;
    for (int b0 = threadIdx.x; b0 < B; b0 += T * (kWords / C > 0 ? kWords / C : 1)) {
      constexpr int UB = kWords / C > 0 ? kWords / C : 1;
      uint32_t v[UB][C];
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int s2 = 0; s2 < C; ++s2)
          if (b0 + u * T < B) v[u][s2] = *smem_of<LOGC>(grouped, a * B + b0 + u * T, s2);
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int s2 = 0; s2 < C; ++s2)
          if (b0 + u * T < B)
            sh[swz((bit_rev(b0 + u * T, logb) << LOGC) + bit_rev(s2, LOGC))] = v[u][s2];
    }
    __syncthreads();
    // 3. coalesced store of the slice
    int64_t* yr = y + size_t(rank) * M;
    for (int k0 = threadIdx.x; k0 < M; k0 += T * kWords) {
      uint32_t v[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (k0 + u * T < M) v[u] = fold(sh[swz(k0 + u * T)], rt.q);
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (k0 + u * T < M) yr[k0 + u * T] = v[u];
    }
    row_sync<LOGC>();  // keep the groups alive for the other blocks
  }
  PROBE(4);
}

// ---------------------------------------------------------------- inverse
// Grid: rows * C blocks, cluster (C, 1, 1).  Natural eval order in,
// post-twisted natural coefficients out, int64 (DST = kDstI64) or 32-bit
// (DST = kDstU32).
template <int LOGC, int DST>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
inv_kernel(NttTables t, const int64_t* in, int64_t* out64, uint32_t* out32) {
  extern __shared__ uint32_t sh[];
  constexpr int C = 1 << LOGC;
  constexpr int U = C < kBatch ? kBatch / C : 1;  // columns a batch
  const int logm = t.logn - LOGC;
  const int M = 1 << logm;
  const size_t n = size_t(1) << t.logn;
  const int row = blockIdx.x >> LOGC;
  const int rank = LOGC ? cluster_rank() : 0;
  const int T = blockDim.x;
  const Row rt = row_tables(t, row);
  const uint32_t* tws = stage_twiddles(sh, M, rt);
  PROBE(0);

  if constexpr (LOGC == 0) {
    // bit-reversal on the way in: index k to offset bitrev(k)
    const int64_t* xr = in + size_t(row) * n;
    for (int j0 = threadIdx.x; j0 < M; j0 += T * kWords) {
      uint32_t v[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (j0 + u * T < M) v[u] = static_cast<uint32_t>(xr[j0 + u * T]);
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (j0 + u * T < M) sh[swz(bit_rev(j0 + u * T, logm))] = v[u];
    }
  } else {
    // The forward's way out, backwards.  Block r' loads its natural slice
    // k = r' M + kk, kk = bitrev(b) C + bitrev_c(s), coalesced, grouped
    // by the block s that takes it at offset b C + bitrev_c(r').
    uint32_t* grouped = sh + 2 * M;
    const int B = M >> LOGC;
    const int logb = logm - LOGC;
    const int64_t* xr = in + size_t(row) * n + size_t(rank) * M;
    for (int k0 = threadIdx.x; k0 < M; k0 += T * kWords) {
      uint32_t v[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u)
        if (k0 + u * T < M) v[u] = static_cast<uint32_t>(xr[k0 + u * T]);
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int kk = k0 + u * T;
        if (kk < M)
          grouped[swz(bit_rev(kk & (C - 1), LOGC) * B + bit_rev(kk >> LOGC, logb))] = v[u];
      }
    }
    row_sync<LOGC>();  // every block's groups are ready
    // read this block's group from every block (32 consecutive words a
    // warp) into its offsets
    constexpr int UB = kWords / C > 0 ? kWords / C : 1;
    for (int b0 = threadIdx.x; b0 < B; b0 += T * UB) {
      uint32_t v[UB][C];
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int r2 = 0; r2 < C; ++r2)
          if (b0 + u * T < B) v[u][r2] = *smem_of<LOGC>(grouped, swz(rank * B + b0 + u * T), r2);
#pragma unroll
      for (int u = 0; u < UB; ++u)
#pragma unroll
        for (int r2 = 0; r2 < C; ++r2)
          if (b0 + u * T < B) sh[swz(((b0 + u * T) << LOGC) + bit_rev(r2, LOGC))] = v[u][r2];
    }
  }
  twiddles_ready();
  __syncthreads();
  PROBE(1);
  local_inv(sh, tws, logm, rt);
  PROBE(2);
  if constexpr (LOGC > 0) row_sync<LOGC>();  // every block's stages are done
  PROBE(3);

  // gather column i from the C blocks, top LOGC stages, post-twist, store
  const int cols = M >> LOGC;
  const int c0 = rank * cols;
  for (int i0 = threadIdx.x; i0 < cols; i0 += T * U) {
    uint32_t e[U][C];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < C; ++r)
        if (i0 + u * T < cols) e[u][r] = *smem_of<LOGC>(sh, swz(c0 + i0 + u * T), r);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = c0 + i0 + u * T;
      if (i0 + u * T >= cols) break;
      top_inv<LOGC>(e[u], i, logm, rt);
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const size_t p = size_t(row) * n + i + (r << logm);
        const uint32_t v = mont_mul(e[u][r], __ldg(rt.twist + i + (r << logm)), rt.q, rt.qn);
        if constexpr (DST == kDstI64)
          out64[p] = v;
        else
          out32[p] = v;
      }
    }
  }
  PROBE(4);
  if constexpr (LOGC > 0) row_sync<LOGC>();  // keep sh alive for readers
}

// ---------------------------------------------------------------- host side
inline bool ntt_shape_ok(int logn, int logc) {
  return logn >= kMinLogN && logn <= kMaxLogN && logc >= 0 &&
         logc <= kMaxLogC && logn - logc >= kMinLogN &&
         logn - logc <= kMaxLogM;
}

inline int threads_for(int logm) {
  const int t = 1 << (logm - kPassBits);  // one 32-word group a thread
  return t < 32 ? 32 : (t > kThreads ? kThreads : t);
}

// One launch of `kern` over rows * 2^logc blocks in clusters of 2^logc,
// with `regions` regions of 2^(logn - logc) words of dynamic shared memory
// (data, twiddles, and the inverse's grouped input).  A refused launch (shared memory, cluster size) returns its
// error; nothing falls back.
template <typename Kern, typename... Args>
int launch_rows(Kern kern, int logn, int logc, int regions, long long rows,
                cudaStream_t st, Args... args) {
  const int logm = logn - logc;
  const size_t smem = size_t(4 * regions) << logm;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(rows << logc), 1, 1);
  cfg.blockDim = dim3(threads_for(logm), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << logc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = logc > 0 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  e = cudaGetLastError();
  if (e == cudaSuccess) log_launch(1u << logc);
  return e;
}

template <int SRC>
int forward(const NttTables& t, long long rows, int logc, const int64_t* x,
            int64_t* y, const ModUpArgs& mu, cudaStream_t st) {
  if (!ntt_shape_ok(t.logn, logc)) return cudaErrorInvalidValue;
  switch (logc) {
    case 0: return launch_rows(fwd_kernel<0, SRC>, t.logn, 0, 2, rows, st, t, x, y, mu);
    case 1: return launch_rows(fwd_kernel<1, SRC>, t.logn, 1, 2, rows, st, t, x, y, mu);
    case 2: return launch_rows(fwd_kernel<2, SRC>, t.logn, 2, 2, rows, st, t, x, y, mu);
    default: return launch_rows(fwd_kernel<3, SRC>, t.logn, 3, 2, rows, st, t, x, y, mu);
  }
}

template <int DST>
int inverse(const NttTables& t, long long rows, int logc, const int64_t* x,
            int64_t* y64, uint32_t* y32, cudaStream_t st) {
  if (!ntt_shape_ok(t.logn, logc)) return cudaErrorInvalidValue;
  switch (logc) {
    case 0: return launch_rows(inv_kernel<0, DST>, t.logn, 0, 2, rows, st, t, x, y64, y32);
    case 1: return launch_rows(inv_kernel<1, DST>, t.logn, 1, 3, rows, st, t, x, y64, y32);
    case 2: return launch_rows(inv_kernel<2, DST>, t.logn, 2, 3, rows, st, t, x, y64, y32);
    default: return launch_rows(inv_kernel<3, DST>, t.logn, 3, 3, rows, st, t, x, y64, y32);
  }
}

}  // namespace he2

// Negacyclic radix-2 NTT passes shared by ntt.cu and modup.cu.
//
// Forward: psi^i pre-twist, then DIF stages s = logn-1 .. 0 (natural ->
// bit-reversed order).  Inverse: DIT stages s = 0 .. logn-1 (bit-reversed
// -> natural), then the psi^-i n^-1 post-twist.  Stage s with m = 2^s
// pairs (p, p + m) inside blocks of 2m and uses twiddle tw[m + (p mod m)]
// (the flat tree layout of the JAX package's kernels/ntt).
//
// One limb at logN = 16 is 2^16 words = 256 KB, more than a block's
// 227 KB of shared memory, so a transform is split in two launches:
//   * "low" stages (m < 2^C, C = min(logn, 11)) stay inside contiguous
//     chunks of 2^C words: one block per (row, chunk) runs them in 8 KB
//     of shared memory;
//   * "high" stages (m >= 2^C) only mix words whose indices differ in
//     the top H = logn - C bits: one thread per (row, column c < 2^C)
//     holds the 2^H words c + k 2^C in registers and runs them all.
// Each launch reads and writes the row once, so a transform moves the
// row through device memory twice instead of logn times.
#pragma once
#include <cuda_runtime.h>

#include "modarith.cuh"

namespace he2 {

constexpr int kChunkBits = 11;
constexpr int kLowThreads = 256;
constexpr int kHighThreads = 128;
constexpr int kMaxHigh = 6;  // logn <= 17

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

// The ModUp reduce y_j = sum_i t_i * (qhat_i mod d_j) mod d_j, read
// straight from the (B, ls, N) INTT output.  Row r of a forward launch is
// (batch r / ld, destination limb r % ld).
struct Reduce {
  const uint32_t* t;   // (B, ls, N)
  const uint32_t* cm;  // (ls, ld) Montgomery wrt d_j
  int ls;
  int ld;
};

enum Src { kSrcI64Twist, kSrcU32, kSrcReduceTwist };
enum Dst { kDstU32, kDstI64Twist, kDstU32Twist };

__host__ __device__ inline int chunk_bits(int logn) {
  return logn < kChunkBits ? logn : kChunkBits;
}

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

__device__ __forceinline__ uint32_t reduce_at(const Reduce& red, int row,
                                              size_t col, size_t n, uint32_t d,
                                              uint32_t dn) {
  const int b = row / red.ld;
  const int j = row % red.ld;
  const uint32_t* src = red.t + size_t(b) * red.ls * n + col;
  uint32_t acc = 0;
  for (int i = 0; i < red.ls; ++i)
    acc = add_mod(acc, mont_mul(src[size_t(i) * n], red.cm[i * red.ld + j], d, dn), d);
  return acc;
}

// ---------------------------------------------------------------- forward
template <int SRC>
__global__ void __launch_bounds__(kLowThreads)
fwd_low(NttTables t, const int64_t* in64, const uint32_t* in32, int64_t* out,
        Reduce red) {
  __shared__ uint32_t sh[1 << kChunkBits];
  const int C = chunk_bits(t.logn);
  const int csize = 1 << C;
  const int nchunk = 1 << (t.logn - C);
  const int row = blockIdx.x / nchunk;
  const int h = blockIdx.x % nchunk;
  const size_t n = size_t(1) << t.logn;
  const size_t base = size_t(row) * n + size_t(h) * csize;
  const Row rt = row_tables(t, row);
  for (int i = threadIdx.x; i < csize; i += blockDim.x) {
    const size_t col = size_t(h) * csize + i;
    uint32_t v;
    if constexpr (SRC == kSrcU32) {
      v = in32[base + i];
    } else {
      if constexpr (SRC == kSrcI64Twist)
        v = static_cast<uint32_t>(in64[base + i]);
      else
        v = reduce_at(red, row, col, n, rt.q, rt.qn);
      v = mont_mul(v, rt.twist[col], rt.q, rt.qn);
    }
    sh[i] = v;
  }
  __syncthreads();
  for (int s = C - 1; s >= 0; --s) {
    const int m = 1 << s;
    for (int b = threadIdx.x; b < csize / 2; b += blockDim.x) {
      const int j = b & (m - 1);
      const int i0 = ((b >> s) << (s + 1)) + j;
      const uint32_t u = sh[i0];
      const uint32_t v = sh[i0 + m];
      sh[i0] = add_mod(u, v, rt.q);
      sh[i0 + m] = mont_mul(sub_mod(u, v, rt.q), rt.tw[m + j], rt.q, rt.qn);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < csize; i += blockDim.x) out[base + i] = sh[i];
}

template <int H, int SRC>
__global__ void __launch_bounds__(kHighThreads)
fwd_high(NttTables t, const int64_t* in64, uint32_t* out, Reduce red) {
  constexpr int K = 1 << H;
  const int C = t.logn - H;
  const int per_row = (1 << C) / kHighThreads;
  const int row = blockIdx.x / per_row;
  const size_t c = size_t(blockIdx.x % per_row) * kHighThreads + threadIdx.x;
  const size_t n = size_t(1) << t.logn;
  const Row rt = row_tables(t, row);
  uint32_t e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t col = c + (size_t(k) << C);
    uint32_t v;
    if constexpr (SRC == kSrcI64Twist)
      v = static_cast<uint32_t>(in64[size_t(row) * n + col]);
    else
      v = reduce_at(red, row, col, n, rt.q, rt.qn);
    e[k] = mont_mul(v, rt.twist[col], rt.q, rt.qn);
  }
#pragma unroll
  for (int b = H - 1; b >= 0; --b) {
    const int M = 1 << b;
    const size_t m = size_t(1) << (b + C);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k & M) continue;
      const size_t j = c + (size_t(k & (M - 1)) << C);
      const uint32_t u = e[k];
      const uint32_t v = e[k + M];
      e[k] = add_mod(u, v, rt.q);
      e[k + M] = mont_mul(sub_mod(u, v, rt.q), rt.tw[m + j], rt.q, rt.qn);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) out[size_t(row) * n + c + (size_t(k) << C)] = e[k];
}

// ---------------------------------------------------------------- inverse
template <int DST>
__global__ void __launch_bounds__(kLowThreads)
inv_low(NttTables t, const int64_t* in, uint32_t* out32, int64_t* out64) {
  __shared__ uint32_t sh[1 << kChunkBits];
  const int C = chunk_bits(t.logn);
  const int csize = 1 << C;
  const int nchunk = 1 << (t.logn - C);
  const int row = blockIdx.x / nchunk;
  const int h = blockIdx.x % nchunk;
  const size_t n = size_t(1) << t.logn;
  const size_t base = size_t(row) * n + size_t(h) * csize;
  const Row rt = row_tables(t, row);
  for (int i = threadIdx.x; i < csize; i += blockDim.x)
    sh[i] = static_cast<uint32_t>(in[base + i]);
  __syncthreads();
  for (int s = 0; s < C; ++s) {
    const int m = 1 << s;
    for (int b = threadIdx.x; b < csize / 2; b += blockDim.x) {
      const int j = b & (m - 1);
      const int i0 = ((b >> s) << (s + 1)) + j;
      const uint32_t u = sh[i0];
      const uint32_t vw = mont_mul(sh[i0 + m], rt.tw[m + j], rt.q, rt.qn);
      sh[i0] = add_mod(u, vw, rt.q);
      sh[i0 + m] = sub_mod(u, vw, rt.q);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < csize; i += blockDim.x) {
    uint32_t v = sh[i];
    if constexpr (DST != kDstU32)
      v = mont_mul(v, rt.twist[size_t(h) * csize + i], rt.q, rt.qn);
    if constexpr (DST == kDstI64Twist)
      out64[base + i] = v;
    else
      out32[base + i] = v;
  }
}

// Reads and writes the same positions of each column, so in == out32 is
// allowed.
template <int H, int DST>
__global__ void __launch_bounds__(kHighThreads)
inv_high(NttTables t, const uint32_t* in, uint32_t* out32, int64_t* out64) {
  constexpr int K = 1 << H;
  const int C = t.logn - H;
  const int per_row = (1 << C) / kHighThreads;
  const int row = blockIdx.x / per_row;
  const size_t c = size_t(blockIdx.x % per_row) * kHighThreads + threadIdx.x;
  const size_t n = size_t(1) << t.logn;
  const Row rt = row_tables(t, row);
  uint32_t e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) e[k] = in[size_t(row) * n + c + (size_t(k) << C)];
#pragma unroll
  for (int b = 0; b < H; ++b) {
    const int M = 1 << b;
    const size_t m = size_t(1) << (b + C);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k & M) continue;
      const size_t j = c + (size_t(k & (M - 1)) << C);
      const uint32_t u = e[k];
      const uint32_t vw = mont_mul(e[k + M], rt.tw[m + j], rt.q, rt.qn);
      e[k] = add_mod(u, vw, rt.q);
      e[k + M] = sub_mod(u, vw, rt.q);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const size_t col = c + (size_t(k) << C);
    const uint32_t v = mont_mul(e[k], rt.twist[col], rt.q, rt.qn);
    if constexpr (DST == kDstI64Twist)
      out64[size_t(row) * n + col] = v;
    else
      out32[size_t(row) * n + col] = v;
  }
}

// ---------------------------------------------------------------- host side
inline bool ntt_shape_ok(int logn) {
  return logn >= 1 && logn <= kChunkBits + kMaxHigh;
}

template <int H, int SRC>
void launch_fwd_high(const NttTables& t, int rows, const int64_t* x,
                     uint32_t* work, const Reduce& red, cudaStream_t st) {
  const int per_row = (1 << (t.logn - H)) / kHighThreads;
  fwd_high<H, SRC><<<rows * per_row, kHighThreads, 0, st>>>(t, x, work, red);
}

template <int H, int DST>
void launch_inv_high(const NttTables& t, int rows, uint32_t* work,
                     uint32_t* y32, int64_t* y64, cudaStream_t st) {
  const int per_row = (1 << (t.logn - H)) / kHighThreads;
  inv_high<H, DST><<<rows * per_row, kHighThreads, 0, st>>>(t, work, y32, y64);
}

// Forward transform of `rows` rows into int64 `y`.  SRC is kSrcI64Twist
// (read int64 `x`) or kSrcReduceTwist (ModUp reduce from `red`).  `work`
// holds rows * N words when logn > kChunkBits.
template <int SRC>
int forward(const NttTables& t, int rows, const int64_t* x, const Reduce& red,
            uint32_t* work, int64_t* y, cudaStream_t st) {
  if (!ntt_shape_ok(t.logn)) return cudaErrorInvalidValue;
  const int C = chunk_bits(t.logn);
  const int H = t.logn - C;
  const int nchunk = 1 << H;
  if (H == 0) {
    fwd_low<SRC><<<rows, kLowThreads, 0, st>>>(t, x, nullptr, y, red);
    return cudaGetLastError();
  }
  switch (H) {
    case 1: launch_fwd_high<1, SRC>(t, rows, x, work, red, st); break;
    case 2: launch_fwd_high<2, SRC>(t, rows, x, work, red, st); break;
    case 3: launch_fwd_high<3, SRC>(t, rows, x, work, red, st); break;
    case 4: launch_fwd_high<4, SRC>(t, rows, x, work, red, st); break;
    case 5: launch_fwd_high<5, SRC>(t, rows, x, work, red, st); break;
    case 6: launch_fwd_high<6, SRC>(t, rows, x, work, red, st); break;
  }
  fwd_low<kSrcU32><<<rows * nchunk, kLowThreads, 0, st>>>(t, nullptr, work, y, red);
  return cudaGetLastError();
}

// Inverse transform of int64 `x`, post-twisted, into int64 `y64`
// (DST = kDstI64Twist) or 32-bit `y32` (DST = kDstU32Twist).  `work`
// holds rows * N words when logn > kChunkBits; it may equal `y32`.
template <int DST>
int inverse(const NttTables& t, int rows, const int64_t* x, uint32_t* work,
            uint32_t* y32, int64_t* y64, cudaStream_t st) {
  if (!ntt_shape_ok(t.logn)) return cudaErrorInvalidValue;
  const int C = chunk_bits(t.logn);
  const int H = t.logn - C;
  const int nchunk = 1 << H;
  if (H == 0) {
    inv_low<DST><<<rows, kLowThreads, 0, st>>>(t, x, y32, y64);
    return cudaGetLastError();
  }
  inv_low<kDstU32><<<rows * nchunk, kLowThreads, 0, st>>>(t, x, work, nullptr);
  switch (H) {
    case 1: launch_inv_high<1, DST>(t, rows, work, y32, y64, st); break;
    case 2: launch_inv_high<2, DST>(t, rows, work, y32, y64, st); break;
    case 3: launch_inv_high<3, DST>(t, rows, work, y32, y64, st); break;
    case 4: launch_inv_high<4, DST>(t, rows, work, y32, y64, st); break;
    case 5: launch_inv_high<5, DST>(t, rows, work, y32, y64, st); break;
    case 6: launch_inv_high<6, DST>(t, rows, work, y32, y64, st); break;
  }
  return cudaGetLastError();
}

}  // namespace he2

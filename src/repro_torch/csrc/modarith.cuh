// 32-bit modular arithmetic shared by every kernel of the port.
//
// Replaces the JAX package's kernels/modops.py helpers (mul32_split,
// mont_redc, mont_mul, add_mod, sub_mod).  The TPU builds 64-bit products
// from 16-bit partials because it has no wide multiply; Hopper has one, so
// mont_mul is a 64-bit product plus one Montgomery reduction (R = 2^32).
// Valid for odd q < 2^31; every function but mont_mul_lazy and
// mont_redc_lazy returns a fully reduced residue, so any exact reduction
// elsewhere gives the same value.  No 64-bit `%` (emulated, slow) appears
// in device code.
#pragma once
#include <cstdint>

namespace he2 {

// a * b * 2^-32 mod q for a < 2^32, b < q.  With b in Montgomery form
// (b * 2^32 mod q) this is the plain product a * b mod q.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t qinv_neg) {
  const uint64_t t = static_cast<uint64_t>(a) * b;          // < 2^62
  const uint32_t m = static_cast<uint32_t>(t) * qinv_neg;    // t * -q^-1 mod 2^32
  const uint32_t r =
      static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);  // < 2q
  return r >= q ? r - q : r;
}

// a * b * 2^-32 mod q, only partly reduced: the result is below 2q.
// For a < 2^32, b < q.
__device__ __forceinline__ uint32_t mont_mul_lazy(uint32_t a, uint32_t b,
                                                  uint32_t q, uint32_t qinv_neg) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t m = static_cast<uint32_t>(t) * qinv_neg;
  return static_cast<uint32_t>((t + static_cast<uint64_t>(m) * q) >> 32);
}

// x * 2^-32 mod q for a 64-bit x, only partly reduced: the result is below
// x / 2^32 + q.  For x + (2^32 - 1) * q < 2^64 and a result below 2^32
// (csrc/bconv.cu's lazy sums keep x below 3 q * 2^32 with q < 2^30).
__device__ __forceinline__ uint32_t mont_redc_lazy(uint64_t x, uint32_t q,
                                                   uint32_t qinv_neg) {
  const uint32_t m = static_cast<uint32_t>(x) * qinv_neg;
  return static_cast<uint32_t>((x + static_cast<uint64_t>(m) * q) >> 32);
}

// a - c if a >= c, else a: maps [0, 2c) onto [0, c).
__device__ __forceinline__ uint32_t fold(uint32_t a, uint32_t c) {
  return a >= c ? a - c : a;
}

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t q) {
  const uint32_t s = a + b;  // < 2q < 2^32
  return s >= q ? s - q : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t q) {
  return a >= b ? a - b : a + q - b;
}

}  // namespace he2

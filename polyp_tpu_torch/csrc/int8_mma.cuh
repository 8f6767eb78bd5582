// int8 helpers of the W8A8 kernels: the round-half-to-even quantize every
// int8 kernel applies, its division-free form (the dense and both int8
// GEGLU forms), the packing of codes into words, the amax and codes of
// eight bf16 or four fp32 values, and X8, eight activations of either type.
#pragma once

#include "common.cuh"

namespace polyp {

// clip(round_half_even(v / s), -127, 127), as jnp.round / torch.round do it.
// The division is IEEE (no fast-math flags), so codes equal the host's.
__device__ __forceinline__ int quant_s8(float v, float s) {
  return static_cast<int>(fminf(fmaxf(rintf(v / s), -127.f), 127.f));
}

// quant_s8(v, s) from the product y = v * inv, inv = 1/s (IEEE), without
// the division and without the conversion unit (rint and float-to-int run
// at an eighth of the ALU's rate): adding 1.5·2^23 rounds a float of
// magnitude below 2^22 to an integer, half to even, and leaves that integer
// in the low mantissa bits, so the low byte of the sum of the clamped y is
// its int8 code in two's complement. y is within |y|·2^-22.9 of v/s (two
// roundings), so where y is farther than |y|·2^-22 from the nearest
// half-integer, v/s and its rounded quotient lie strictly on y's side of it
// and this is the code quant_s8 gives. Nearer (about one value in 10^5 at
// |y| ~ 30; every value beyond 2^22), `*near` is set and the caller
// recomputes that value with quant_s8 itself. Returns a word whose low byte
// is the code.
__device__ __forceinline__ uint32_t quant_s8_bits(float v, float inv, bool* near) {
  constexpr float kRound = 12582912.f;  // 1.5 * 2^23
  const float y = v * inv;
  const float r = (y + kRound) - kRound;  // rint(y)
  // the distance to the nearest half-integer is 0.5 - |y - r|
  *near = fabsf(y - r) >= fmaf(-fabsf(y), 0x1p-22f, 0.5f);
  return __float_as_uint(fminf(fmaxf(y, -127.f), 127.f) + kRound);
}

// The low bytes of four words, packed little-endian into one.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// Four int8 codes packed little-endian into one 32-bit word.
__device__ __forceinline__ uint32_t pack_s8x4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// Eight bf16 values (one 16-byte vector) quantized with scale s into eight
// int8 codes (one 8-byte vector).
__device__ __forceinline__ uint2 quant_bf16x8(uint4 v, float s) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  uint2 out;
  out.x = pack_s8x4(quant_s8(__bfloat162float(e[0]), s), quant_s8(__bfloat162float(e[1]), s),
                    quant_s8(__bfloat162float(e[2]), s), quant_s8(__bfloat162float(e[3]), s));
  out.y = pack_s8x4(quant_s8(__bfloat162float(e[4]), s), quant_s8(__bfloat162float(e[5]), s),
                    quant_s8(__bfloat162float(e[6]), s), quant_s8(__bfloat162float(e[7]), s));
  return out;
}

// quant_bf16x8's codes from quant_s8_bits (inv = 1/s, IEEE), the division
// taken only where one of the eight products is too near a tie: the same
// codes at a fraction of the cost.
__device__ __forceinline__ uint2 quant_bf16x8_bits(uint4 v, float s, float inv) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  uint32_t q[8];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    bool tie;
    q[i] = quant_s8_bits(__bfloat162float(e[i]), inv, &tie);
    near |= tie;
  }
  if (near) return quant_bf16x8(v, s);
  return make_uint2(pack_low_bytes(q[0], q[1], q[2], q[3]), pack_low_bytes(q[4], q[5], q[6], q[7]));
}

__device__ __forceinline__ float absmax_bf16x8(uint4 v) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  float m = 0.f;
  for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(__bfloat162float(e[i])));
  return m;
}

// Four fp32 values (one 16-byte vector) quantized with scale s (inv = 1/s,
// IEEE) into four int8 codes packed little-endian into one word:
// quant_s8_bits for each, the division taken for all four where one of
// them is too near a tie. An fp32 x has far more values near a tie than a
// bf16 one (24 bits of precision against 8), so this branch is taken more
// often than quant_bf16x8_bits', and it is what keeps the codes bit-equal
// to quant_s8 and torch.round.
__device__ __forceinline__ uint32_t quant_f32x4_bits(float4 v, float s, float inv) {
  bool n0, n1, n2, n3;
  const uint32_t q0 = quant_s8_bits(v.x, inv, &n0), q1 = quant_s8_bits(v.y, inv, &n1);
  const uint32_t q2 = quant_s8_bits(v.z, inv, &n2), q3 = quant_s8_bits(v.w, inv, &n3);
  if (n0 | n1 | n2 | n3) {
    return pack_s8x4(quant_s8(v.x, s), quant_s8(v.y, s), quant_s8(v.z, s), quant_s8(v.w, s));
  }
  return pack_low_bytes(q0, q1, q2, q3);
}

__device__ __forceinline__ float absmax_f32x4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

// Eight activations of an int8 kernel's input x, bf16 (one 16-byte load)
// or fp32 (two): the loads, the amax and the codes of each, so that a
// kernel's quantize is written once for both input types.
template <class T>
struct X8;

template <>
struct X8<bf16> {
  uint4 v;
  __device__ static X8 load(const bf16* p) { return {*reinterpret_cast<const uint4*>(p)}; }
  __device__ static X8 zero() { return {make_uint4(0u, 0u, 0u, 0u)}; }
  __device__ float absmax() const { return absmax_bf16x8(v); }
  __device__ uint2 codes(float s, float inv) const { return quant_bf16x8_bits(v, s, inv); }
};

template <>
struct X8<float> {
  float4 lo, hi;
  __device__ static X8 load(const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
    return {q[0], q[1]};
  }
  __device__ static X8 zero() {
    return {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  __device__ float absmax() const { return fmaxf(absmax_f32x4(lo), absmax_f32x4(hi)); }
  __device__ uint2 codes(float s, float inv) const {
    return make_uint2(quant_f32x4_bits(lo, s, inv), quant_f32x4_bits(hi, s, inv));
  }
};

// Two values of a bias (bf16 or fp32) as fp32.
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

}  // namespace polyp

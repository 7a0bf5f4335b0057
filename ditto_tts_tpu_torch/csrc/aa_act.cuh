// The anti-aliased SnakeBeta of one channel, on a run of consecutive
// samples held in registers: 2x kaiser-sinc upsample (two 6-tap phases),
// snake on each phase, 12-tap anti-aliased decimation. No shared memory, no
// barrier. Shared by kernel D (snake.cu, the standalone activation) and
// kernel C (act_conv.cu, which stages the activation of each channel chunk
// as the tap GEMM's operand).
//
// With x[t0 - 5 + i] in xr[i] (the caller clamps the index to [0, T): the
// replicate pad of the Pallas kernels), the run's outputs y[j] = out(t0+j):
//   SE[i] = s(e(t0 - 2 + i)),  SO[i] = s(o(t0 - 3 + i)),   i < N + 5
//   e, o: 6-tap upsample phases, both reading xr[i .. i+5]
//   s(v)  = v + inv_b * sin2(a*v)   (fp32; FAST = false: sinf(a*v)^2)
//   y[j]  = sum_m de[m] SE[j+m] + dn[m] SO[j+m]        (fp32)
// Two orders of summation, one function up to fp32 rounding (the filter is
// symmetric), each that of a plain version:
//   REV = true  (fused_snake_plain, kernel D): the phases take xr[i+5-m] for
//     m = 0..5, and each decimation step adds the s(e) term first;
//   REV = false (aa_snake_conv1d_plain, kernel C): the phases take xr[i+m],
//     and each decimation step adds the s(o) term first.
// UP_X (kernel D's #8 mode, bf16 x): the upsample taps and products are
// rounded to bf16 and so is each running sum but the last, as XLA computes
// fused_snake_pallas in x's type; done two phase rows at a time in bf16x2
// arithmetic, which rounds exactly so (mul.rn / add.rn, never fused).
// POLY (kernel D's polyphase mode, ops/snake.py
// polyphase_anti_aliased_activation): the phase rows outside [0, T) are
// not computed from the clamped x but take the polyphase form's 2x-rate
// replicate edges, s(e(0)) on the left and s(o(T-1)) on the right for both
// phases (the caller passes e(0) and o(T-1), summed as the rows are, so
// the snake of each is the row's own); the phases sum as REV = false, and
// the decimation sums its s(o) and s(e) terms apart and then adds the two,
// in the plain form's order. Only runs within 3 samples of either end
// change.
// sin2 is sin^2 by the Pallas kernels' pi-periodic reduction and odd
// polynomial (ditto_tts_tpu/ops/fastmath.py; the port's ops/snake.py:sin2
// keeps the same constants): branch-free, ~11 instructions. sinf measured
// twice as costly here (PERF.md): with its slow-path range reduction
// for large arguments (a local-memory table walk) inlined 2(N+5) times a
// run, it was most of each run's instructions; and a*v is not
// range-limited, so not __sinf.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace ditto {

struct AaTaps {
  float ue[6], uo[6];   // upsample taps of e and o, in the order summed
  float de[6], dn[6];   // decimation taps on s(e) and s(o)
};

// sin(v)^2: v = n*pi + f, |f| <= pi/2, pi split so that n*kPiHi is exact
// for |n| < 2^15; sin(f) = f (c0 + c1 f^2 + ... + c4 f^8)
__device__ __forceinline__ float sin2f(float v) {
  constexpr float kInvPi = 0.3183098861837907f, kPiHi = 3.140625f,
                  kPiLo = 0.0009676535897932384f;
  const float n = rintf(v * kInvPi);
  const float f = v - n * kPiHi - n * kPiLo;
  const float f2 = f * f;
  const float s = f * (0.999999977f + f2 * (-0.166666476f + f2 *
                      (0.00833289979f + f2 * (-0.000198008956f +
                                              f2 * 2.59048416e-06f))));
  return s * s;
}

// FAST: sin^2 by sin2f (the Pallas kernels' and ops.snake.sin2's), else
// by sinf (snake_beta(fast=False), torch.sin)
template <bool FAST = true>
__device__ __forceinline__ float snake_act(float v, float a, float inv_b) {
  if constexpr (FAST) {
    return v + inv_b * sin2f(a * v);
  } else {
    const float s = sinf(a * v);
    return v + inv_b * (s * s);
  }
}

// NV 16-byte vectors from global memory at p (16-byte aligned) into words,
// through the read-only path; and back
template <int NV>
__device__ __forceinline__ void load_vec(uint32_t (&w)[4 * NV], const void* p) {
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const uint4 u = __ldg(static_cast<const uint4*>(p) + q);
    w[4 * q] = u.x;
    w[4 * q + 1] = u.y;
    w[4 * q + 2] = u.z;
    w[4 * q + 3] = u.w;
  }
}

template <int NV>
__device__ __forceinline__ void store_vec(void* p, const uint32_t (&w)[4 * NV]) {
#pragma unroll
  for (int q = 0; q < NV; ++q)
    static_cast<uint4*>(p)[q] =
        make_uint4(w[4 * q], w[4 * q + 1], w[4 * q + 2], w[4 * q + 3]);
}

// element i of an array of T packed in 32-bit words, as fp32
template <typename T, int W>
__device__ __forceinline__ float word_elem(const uint32_t (&w)[W], int i) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[i]);
  else return __uint_as_float(i & 1 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
}

__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t badd2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// one phase row in fp32: sum_m tp[m] * xr[i + (REV ? 5 - m : m)]
template <bool REV, int W>
__device__ __forceinline__ float up_row(const float (&xr)[W], int i,
                                        const float (&tp)[6]) {
  float acc = tp[0] * xr[i + (REV ? 5 : 0)];
#pragma unroll
  for (int m = 1; m < 6; ++m) acc = acc + tp[m] * xr[i + (REV ? 5 - m : m)];
  return acc;
}

// phase rows i and i+1 under UP_X (REV order): X2[k] holds the bf16 pair
// (xr[k], xr[k+1]), tp2[m] the bf16 tap m twice
template <int W>
__device__ __forceinline__ void up_pair_bf16(const uint32_t (&X2)[W], int i,
                                             const uint32_t (&tp2)[6],
                                             float& v0, float& v1) {
  uint32_t acc = bmul2(tp2[0], X2[i + 5]);
#pragma unroll
  for (int m = 1; m < 5; ++m) acc = badd2(acc, bmul2(tp2[m], X2[i + 5 - m]));
  const uint32_t p = bmul2(tp2[5], X2[i]);   // the last sum stays fp32
  v0 = bf16_lo(acc) + bf16_lo(p);
  v1 = bf16_hi(acc) + bf16_hi(p);
}

// xr[i] = x[t0 - 5 + i] for i < N + 11 (the last one is read only under
// UP_X); y[j] = the activation at t0 + j, j < N. Read only under POLY: t0,
// T, and in a run within 3 samples of either end e0 = e(0) and oT =
// o(T-1), the phase rows (before the snake) that the rows outside [0, T)
// take.
template <bool UP_X, bool REV, int N, bool POLY = false, bool FAST = true>
__device__ __forceinline__ void aa_act(const float (&xr)[N + 11], float a,
                                       float inv_b, const AaTaps& tp,
                                       float (&y)[N], int t0 = 0, int T = 0,
                                       float e0 = 0.f, float oT = 0.f) {
  static_assert(!UP_X || REV, "UP_X is kernel D's #8 mode");
  static_assert(!POLY || (!UP_X && !REV), "POLY sums in the plain order");
  constexpr int NP = N + 5 + (UP_X ? (N + 5) % 2 : 0);
  float se[NP], so[NP];
  if constexpr (UP_X) {
    uint32_t X2[N + 10], te[6], to[6];
#pragma unroll
    for (int k = 0; k < N + 10; ++k) X2[k] = pack_bf16(xr[k], xr[k + 1]);
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      te[m] = pack_bf16(tp.ue[m], tp.ue[m]);
      to[m] = pack_bf16(tp.uo[m], tp.uo[m]);
    }
#pragma unroll
    for (int i = 0; i < NP; i += 2) {
      up_pair_bf16(X2, i, te, se[i], se[i + 1]);
      up_pair_bf16(X2, i, to, so[i], so[i + 1]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      se[i] = up_row<REV>(xr, i, tp.ue);
      so[i] = up_row<REV>(xr, i, tp.uo);
    }
  }
  if constexpr (POLY) {
    // rows e(t0 - 2 + i) and o(t0 - 3 + i) outside [0, T), each a row
    // apart, so no row waits on another
    if (t0 < 3 || t0 + N + 3 > T) {
#pragma unroll
      for (int i = 0; i < N + 5; ++i) {
        const int ue = t0 - 2 + i, uo = t0 - 3 + i;
        se[i] = ue < 0 ? e0 : ue >= T ? oT : se[i];
        so[i] = uo < 0 ? e0 : uo >= T ? oT : so[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < N + 5; ++i) {
    se[i] = snake_act<FAST>(se[i], a, inv_b);
    so[i] = snake_act<FAST>(so[i], a, inv_b);
  }
  if constexpr (POLY) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float ao = tp.dn[0] * so[j], ae = tp.de[0] * se[j];
#pragma unroll
      for (int m = 1; m < 6; ++m) {
        ao = ao + tp.dn[m] * so[j + m];
        ae = ae + tp.de[m] * se[j + m];
      }
      y[j] = ao + ae;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float acc = REV ? tp.de[0] * se[j] + tp.dn[0] * so[j]
                      : tp.dn[0] * so[j] + tp.de[0] * se[j];
#pragma unroll
      for (int m = 1; m < 6; ++m)
        acc = REV ? acc + tp.de[m] * se[j + m] + tp.dn[m] * so[j + m]
                  : acc + tp.dn[m] * so[j + m] + tp.de[m] * se[j + m];
      y[j] = acc;
    }
  }
}

}  // namespace ditto

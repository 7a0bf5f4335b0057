// Kernel D: the standalone anti-aliased Snake / SnakeBeta (2x kaiser-sinc
// upsample -> snake -> 2x anti-aliased decimation) over a [B, C, T] tensor
// of any strides.
//
// Replaces two Pallas TPU kernels, one function in two layouts:
//   ditto_tts_tpu/ops/snake_pallas.py fused_snake_pallas ([B, C, T]; the
//     BigVGAN activations under aa_impl="fused_pallas" on the time-minor
//     stages, models/vocoder.py:49-53), and
//   ditto_tts_tpu/ops/snake_pallas_nlc.py fused_snake_nlc ([B, T, C]; the
//     channels-last stages at widths >= 96, models/vocoder.py:184-195).
// The wrapper passes the (b, c, t) strides of either layout, so the port's
// [B, C, T] carry and a [B, T, C] view go through without copies.
//
// The polyphase mode (POLY) replaces no Pallas kernel: it is
// ops/snake.py polyphase_anti_aliased_activation with snake_beta, which
// XLA fuses where the JAX vocoder's _act_nlc and _act call it with
// fast=True (the default aa_impl="fused_conv": the 768-wide stage, the
// 48- and 24-wide stages and act_post, 55 calls a request). It is the
// same function but for the edges: the phase rows outside [0, T) take the
// 2x-rate replicate values s(e(0)) and s(o(T-1)) (aa_act.cuh), so only
// the first and last run of a row differ from the Pallas mode; the sums
// run in the plain form's order, and sin^2 is sin2f (fast) or sinf. Like
// the Pallas mode it is bound by its bytes, one read and one write of
// bf16 a sample.
//
// Arithmetic (aa_act.cuh, REV order, as fused_snake_plain): per channel,
// a = exp(alpha), inv_b = 1/(exp(beta)+1e-9), h the 12-tap kaiser-sinc
// low-pass, x replicate-padded (the index clamped to [0, T)):
//   e[u] = sum_m 2h[2m+1] x[u+2-m],   o[u] = sum_m 2h[2m] x[u+3-m]
//   s(v) = v + inv_b * sin(a*v)^2     (fp32; sin^2 by a polynomial)
//   y[t] = sum_m h[2m+1] s(e)[t+m-2] + h[2m] s(o)[t+m-3]   (fp32)
// stored in x's type. The two Pallas kernels differ in the upsample taps:
// fused_snake_nlc casts x to fp32 first (UP_X = false); fused_snake_pallas
// multiplies in x's type (UP_X = true): taps, products and each running sum
// but the last are rounded to x's type. sin^2 is the Pallas kernels' own
// pi-periodic polynomial (ops/fastmath.py; aa_act.cuh sin2f), as in the
// plain version.
//
// What bounds it on an H100: ~56 fp32 operations per sample against the
// 2 * sizeof(T) bytes of one read and one write: at 67 TFLOP/s fp32 and
// 3.35 TB/s that is memory bound (bf16: 0.84 ps/sample of operations
// against 1.19 ps of bytes), but only if each sample costs few issued
// instructions: the card issues ~3e13 thread instructions a second, so a
// bf16 sample at the byte bound may take ~35.
//
// Design: no shared memory and no barrier. Each thread owns a run of N = 16
// consecutive outputs of one channel, holds x over the run and its 5-sample
// halos in registers and evaluates the whole activation there (aa_act.cuh),
// so each phase row is computed once per run (21 rows for 16 outputs).
//   time-minor ([B, C, T], every launch on the serving paths): neighbouring
//     lanes own neighbouring runs of one channel; a thread reads x over
//     [t0-8, t0+24) with 16-byte loads (the halo overlaps its neighbours',
//     from L1) and writes its run with 16-byte stores. A row's runs start
//     where its 16-byte vectors do (t0 = 16k - shift, shift < 8 the row's
//     start modulo a vector), so a row of any length or storage offset
//     (T = 3748 on the 768-wide stage) still takes vector loads;
//   channel-minor ([B, T, C] views): neighbouring lanes own one run of
//     neighbouring channels, so each scalar load and store of a warp is
//     contiguous across channels.
// The runs at either end of T, a T shorter than one vector window, a time
// stride other than 1, and stores to a y whose row is aligned otherwise
// than x's take scalar loads or stores with the clamped index, in the same
// kernel.

#include "aa_act.cuh"

namespace ditto {
namespace {

constexpr int kThreads = 256;
constexpr int kRun = 16;   // outputs per thread

template <typename T, bool UP_X, bool TIME_MINOR, bool POLY, bool FAST>
__global__ void __launch_bounds__(kThreads)
snake_kernel(const T* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ inv_b, T* __restrict__ y,
             AaTaps taps, int C, int Tlen, long long xsb, long long xsc,
             long long xst, long long ysb, long long ysc, long long yst) {
  constexpr int E = 16 / sizeof(T);           // elements per 16-byte vector
  constexpr int NW = kRun + 16;               // the vector window [t0-8, t0+24)
  const int tid = threadIdx.x;
  const int c = TIME_MINOR ? blockIdx.y : blockIdx.y * 32 + (tid & 31);
  if (c >= C) return;
  const long long b = blockIdx.z;
  const T* xr = x + b * xsb + c * xsc;
  T* yr = y + b * ysb + c * ysc;
  // time-minor: the runs of a row start where its 16-byte vectors do, so
  // the first run begins up to E-1 samples before t = 0
  const int shift = TIME_MINOR && xst == 1
                        ? static_cast<int>(reinterpret_cast<uintptr_t>(xr) / sizeof(T) % E)
                        : 0;
  const int t0 = (TIME_MINOR ? blockIdx.x * kThreads + tid
                             : blockIdx.x * (kThreads / 32) + (tid >> 5)) * kRun -
                 shift;
  if (t0 >= Tlen) return;

  float w[kRun + 11];   // x[t0 - 5 + i]
  if (TIME_MINOR && xst == 1 && t0 >= 8 && t0 + kRun + 8 <= Tlen) {
    uint32_t v[NW * sizeof(T) / 4];
    load_vec<NW / E>(v, xr + t0 - 8);
#pragma unroll
    for (int i = 0; i < kRun + 11; ++i) w[i] = word_elem<T>(v, i + 3);
  } else {
#pragma unroll
    for (int i = 0; i < kRun + 11; ++i) {
      const int t = min(max(t0 - 5 + i, 0), Tlen - 1);
      w[i] = to_f<T>(xr[t * xst]);
    }
  }
  // the polyphase edges: e(0) and o(T-1), from x's first and last 3
  // samples (the index clamped), in the order aa_act sums its rows
  float e0 = 0.f, oT = 0.f;
  if (POLY && (t0 < 3 || t0 + kRun + 3 > Tlen)) {
    float xe[6], xo[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      xe[r] = to_f<T>(xr[min(max(r - 3, 0), Tlen - 1) * xst]);
      xo[r] = to_f<T>(xr[max(min(Tlen - 3 + r, Tlen - 1), 0) * xst]);
    }
    e0 = up_row<false>(xe, 0, taps.ue);
    oT = up_row<false>(xo, 0, taps.uo);
  }
  float out[kRun];
  aa_act<UP_X, !POLY, kRun, POLY, FAST>(w, a[c], inv_b[c], taps, out, t0,
                                        Tlen, e0, oT);

  if (TIME_MINOR && yst == 1 && t0 >= 0 && t0 + kRun <= Tlen &&
      reinterpret_cast<uintptr_t>(yr + t0) % 16 == 0) {
    uint32_t v[kRun * sizeof(T) / 4];
#pragma unroll
    for (int k = 0; k < kRun * static_cast<int>(sizeof(T)) / 4; ++k) {
      if constexpr (sizeof(T) == 4) v[k] = __float_as_uint(out[k]);
      else v[k] = pack_bf16(out[2 * k], out[2 * k + 1]);
    }
    store_vec<kRun / E>(yr + t0, v);
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (t0 + j >= 0 && t0 + j < Tlen) yr[(t0 + j) * yst] = from_f<T>(out[j]);
  }
}

template <typename T, bool UP_X, bool POLY, bool FAST>
cudaError_t launch(const void* x, const float* a, const float* inv_b, void* y,
                   const AaTaps& taps, int B, int C, int Tlen,
                   const long long* xs, const long long* ys, bool time_minor,
                   cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (time_minor) {
    // runs of a row shifted back by up to E-1 samples: one more may be needed
    const int runs = (Tlen + 16 / static_cast<int>(sizeof(T)) - 1 + kRun - 1) / kRun;
    const dim3 grid((runs + kThreads - 1) / kThreads, C, B);
    snake_kernel<T, UP_X, true, POLY, FAST><<<grid, kThreads, 0, s>>>(
        xp, a, inv_b, yp, taps, C, Tlen, xs[0], xs[1], xs[2], ys[0], ys[1],
        ys[2]);
  } else {
    constexpr int TB = kThreads / 32 * kRun;
    const dim3 grid((Tlen + TB - 1) / TB, (C + 31) / 32, B);
    snake_kernel<T, UP_X, false, POLY, FAST><<<grid, kThreads, 0, s>>>(
        xp, a, inv_b, yp, taps, C, Tlen, xs[0], xs[1], xs[2], ys[0], ys[1],
        ys[2]);
  }
  return cudaGetLastError();
}

// the modes of ditto_snake
enum Mode : int { kPallasF32Taps = 0, kPallasXTaps = 1, kPoly = 2,
                  kPolySinf = 3 };

template <typename T>
cudaError_t launch_mode(int mode, const void* x, const float* a,
                        const float* inv_b, void* y, const AaTaps& taps, int B,
                        int C, int Tlen, const long long* xs,
                        const long long* ys, bool tm, cudaStream_t s) {
  // fp32 x: rounding to x's type is exact, so #8 and #9 are one function
  constexpr bool kXTaps = sizeof(T) == 2;
  switch (mode) {
    case kPallasF32Taps:
      return launch<T, false, false, true>(x, a, inv_b, y, taps, B, C, Tlen,
                                           xs, ys, tm, s);
    case kPallasXTaps:
      return launch<T, kXTaps, false, true>(x, a, inv_b, y, taps, B, C, Tlen,
                                            xs, ys, tm, s);
    case kPoly:
      return launch<T, false, true, true>(x, a, inv_b, y, taps, B, C, Tlen,
                                          xs, ys, tm, s);
    case kPolySinf:
      return launch<T, false, true, false>(x, a, inv_b, y, taps, B, C, Tlen,
                                           xs, ys, tm, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace ditto

// x, y: [B, C, T] with element strides xs / ys (3 each, in elements);
// a / inv_b [C] fp32; taps: 24 floats (upsample taps of e, of o;
// decimation taps on s(e), on s(o); each in the order its mode sums);
// mode: 0 = the Pallas edges with fp32 upsample taps (fused_snake_nlc),
// 1 = the Pallas edges with taps in x's type (fused_snake_pallas), 2 = the
// polyphase form with sin2, 3 = the polyphase form with sinf;
// time_minor: 1 when time is the minor dimension.
extern "C" int ditto_snake(const void* x, const float* a, const float* inv_b,
                           void* y, const float* taps, int B, int C, int T,
                           const long long* xs, const long long* ys,
                           int mode, int time_minor, int dtype, void* stream) {
  using namespace ditto;
  AaTaps tp;
  for (int m = 0; m < 6; ++m) {
    tp.ue[m] = taps[m];
    tp.uo[m] = taps[6 + m];
    tp.de[m] = taps[12 + m];
    tp.dn[m] = taps[18 + m];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tm = time_minor != 0;
  if (B > 65535 || C > 65535)   // grid.y / grid.z
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kFloat32)
    return launch_mode<float>(mode, x, a, inv_b, y, tp, B, C, T, xs, ys, tm, s);
  if (dtype == kBFloat16)
    return launch_mode<__nv_bfloat16>(mode, x, a, inv_b, y, tp, B, C, T, xs,
                                      ys, tm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

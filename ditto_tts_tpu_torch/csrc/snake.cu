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
// Arithmetic, per channel (a = exp(alpha), inv_b = 1/(exp(beta)+1e-9),
// h the 12-tap kaiser-sinc low-pass, x replicate-padded by 8 samples):
//   e[u] = sum_m 2h[2m+1] x[u+2-m],   o[u] = sum_m 2h[2m] x[u+3-m]
//   s(v) = v + inv_b * sin(a*v)^2                       (fp32, sinf)
//   y[t] = sum_m h[2m+1] s(e)[t+m-2] + h[2m] s(o)[t+m-3]   (fp32)
// stored in x's type. The two Pallas kernels differ in the upsample taps:
// fused_snake_nlc casts x to fp32 first (UP_X = false); fused_snake_pallas
// multiplies in x's type (UP_X = true): taps and products are rounded to
// x's type and so is the running sum after each add but the last (the
// last sum feeds the fp32 snake, and XLA keeps it in fp32). The Pallas
// kernels' pi-periodic polynomial sin^2 (ops/fastmath.py) was a Mosaic
// workaround; sinf is exact to an ulp, and a*v is not range-limited, so
// not __sinf.
//
// What bounds it on an H100: ~56 fp32 operations per sample against the
// 2 * sizeof(T) bytes of one read and one write: at 67 TFLOP/s fp32 and
// 3.35 TB/s that is memory bound (bf16: 0.84 ps/sample of operations
// against 1.19 ps of bytes). The design reads x once from device memory
// (the 8-sample halo comes from L2), keeps the phases in shared memory and
// writes y once.
//
// Design: a block owns CG channels x TT time steps of one batch row. It
// stages the tile plus the 8-sample halo on each side in shared memory as
// fp32 (the index clamped to [0, T): the replicate pad), evaluates the two
// upsample phases and the snake for the TT+8 phase rows the decimation
// needs, then decimates. Shared memory and the thread-to-element map
// follow the tensor's minor dimension (TIME_MINOR: time for [B, C, T],
// channels for [B, T, C]), so neighbouring threads read neighbouring
// addresses in device memory and in distinct shared-memory banks.

#include "common.cuh"

namespace ditto {
namespace {

constexpr int kThreads = 256;
constexpr int kHalo = 8;

struct SnakeTaps {
  float he[6], ho[6], ge[6], go[6];  // 2h[2m+1], 2h[2m], h[2m+1], h[2m]
};

template <typename T, bool UP_X>
__device__ __forceinline__ float up_phase(const float* xr, int step,
                                          const float* taps) {
  // sum_m taps[m] * xr[-m*step], in the order of the Pallas kernel
  if (UP_X) {
    float acc = round_to<T>(round_to<T>(taps[0]) * xr[0]);
#pragma unroll
    for (int m = 1; m < 5; ++m)
      acc = round_to<T>(acc + round_to<T>(round_to<T>(taps[m]) * xr[-m * step]));
    return acc + round_to<T>(round_to<T>(taps[5]) * xr[-5 * step]);
  }
  float acc = taps[0] * xr[0];
#pragma unroll
  for (int m = 1; m < 6; ++m) acc = acc + taps[m] * xr[-m * step];
  return acc;
}

template <typename T, bool UP_X, bool TIME_MINOR, int CG, int TT>
__global__ void __launch_bounds__(kThreads)
snake_kernel(const T* __restrict__ x, const float* __restrict__ a,
             const float* __restrict__ inv_b, T* __restrict__ y,
             SnakeTaps taps, int C, int Tlen, long long xsb, long long xsc,
             long long xst, long long ysb, long long ysc, long long yst) {
  constexpr int NX = TT + 2 * kHalo;  // x rows  [t0-8, t0+TT+8)
  constexpr int NP = TT + 8;          // phase rows [t0-4, t0+TT+4)
  // element (c, j) of a [CG][N] tile sits at c*N + j (TIME_MINOR) or
  // j*CG + c, so that linear index i walks the tensor's minor dimension
  constexpr int XC = TIME_MINOR ? NX : 1, PC = TIME_MINOR ? NP : 1;
  constexpr int STEP = TIME_MINOR ? 1 : CG;
  __shared__ float xs[CG * NX];
  __shared__ float se[CG * NP];
  __shared__ float so[CG * NP];

  const int t0 = blockIdx.x * TT, c0 = blockIdx.y * CG;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;

  for (int i = tid; i < CG * NX; i += kThreads) {
    const int c = TIME_MINOR ? i / NX : i % CG;
    const int j = TIME_MINOR ? i % NX : i / CG;
    const int cc = c0 + c;
    const int t = min(max(t0 - kHalo + j, 0), Tlen - 1);
    xs[i] = cc < C ? to_f<T>(x[b * xsb + cc * xsc + t * xst]) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < CG * NP; i += kThreads) {
    const int c = TIME_MINOR ? i / NP : i % CG;
    const int u = TIME_MINOR ? i % NP : i / CG;
    const int cc = c0 + c;
    // phase row u is sample t0-4+u; e reads x[u+2-m], o x[u+3-m]: tile
    // rows u+6-m and u+7-m
    const float* xr = xs + c * XC + u * STEP;
    const float e = up_phase<T, UP_X>(xr + 6 * STEP, STEP, taps.he);
    const float o = up_phase<T, UP_X>(xr + 7 * STEP, STEP, taps.ho);
    const float av = cc < C ? a[cc] : 0.f;
    const float ib = cc < C ? inv_b[cc] : 0.f;
    const float s1 = sinf(av * e), s2 = sinf(av * o);
    se[i] = e + ib * (s1 * s1);
    so[i] = o + ib * (s2 * s2);
  }
  __syncthreads();
  for (int i = tid; i < CG * TT; i += kThreads) {
    const int c = TIME_MINOR ? i / TT : i % CG;
    const int j = TIME_MINOR ? i % TT : i / CG;
    const int cc = c0 + c, t = t0 + j;
    if (cc >= C || t >= Tlen) continue;
    // s(e) at t+m-2 is phase row j+m+2, s(o) at t+m-3 row j+m+1
    const float* ser = se + c * PC + (j + 2) * STEP;
    const float* sor = so + c * PC + (j + 1) * STEP;
    float acc = taps.ge[0] * ser[0] + taps.go[0] * sor[0];
#pragma unroll
    for (int m = 1; m < 6; ++m)
      acc = acc + taps.ge[m] * ser[m * STEP] + taps.go[m] * sor[m * STEP];
    y[b * ysb + cc * ysc + t * yst] = from_f<T>(acc);
  }
}

template <typename T, bool UP_X>
cudaError_t launch(const void* x, const float* a, const float* inv_b, void* y,
                   const SnakeTaps& taps, int B, int C, int Tlen,
                   const long long* xs, const long long* ys, bool time_minor,
                   cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (time_minor) {
    constexpr int CG = 4, TT = 512;
    const dim3 grid((Tlen + TT - 1) / TT, (C + CG - 1) / CG, B);
    snake_kernel<T, UP_X, true, CG, TT><<<grid, kThreads, 0, s>>>(
        xp, a, inv_b, yp, taps, C, Tlen, xs[0], xs[1], xs[2], ys[0], ys[1], ys[2]);
  } else {
    constexpr int CG = 32, TT = 64;
    const dim3 grid((Tlen + TT - 1) / TT, (C + CG - 1) / CG, B);
    snake_kernel<T, UP_X, false, CG, TT><<<grid, kThreads, 0, s>>>(
        xp, a, inv_b, yp, taps, C, Tlen, xs[0], xs[1], xs[2], ys[0], ys[1], ys[2]);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace ditto

// x, y: [B, C, T] with element strides xs / ys (3 each, in elements);
// a / inv_b [C] fp32; taps: 24 floats (2h[2m+1], 2h[2m], h[2m+1], h[2m]);
// up_x: 1 = upsample taps in x's type (fused_snake_pallas), 0 = fp32
// (fused_snake_nlc); time_minor: 1 when time is the minor dimension.
extern "C" int ditto_snake(const void* x, const float* a, const float* inv_b,
                           void* y, const float* taps, int B, int C, int T,
                           const long long* xs, const long long* ys,
                           int up_x, int time_minor, int dtype, void* stream) {
  using namespace ditto;
  SnakeTaps tp;
  for (int m = 0; m < 6; ++m) {
    tp.he[m] = taps[m];
    tp.ho[m] = taps[6 + m];
    tp.ge[m] = taps[12 + m];
    tp.go[m] = taps[18 + m];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tm = time_minor != 0;
  if (dtype == kFloat32)
    return up_x ? launch<float, true>(x, a, inv_b, y, tp, B, C, T, xs, ys, tm, s)
                : launch<float, false>(x, a, inv_b, y, tp, B, C, T, xs, ys, tm, s);
  if (dtype == kBFloat16)
    return up_x ? launch<__nv_bfloat16, true>(x, a, inv_b, y, tp, B, C, T, xs, ys, tm, s)
                : launch<__nv_bfloat16, false>(x, a, inv_b, y, tp, B, C, T, xs, ys, tm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

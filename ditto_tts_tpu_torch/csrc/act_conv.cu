// Kernel C: anti-aliased SnakeBeta followed by a 'SAME' dilated conv1d, in
// one pass over [B, C, T].
//
// Replaces the Pallas TPU kernel ditto_tts_tpu/ops/act_conv_pallas.py
// aa_snake_conv1d (_kernel), which the BigVGAN AMP blocks run at widths
// 96..384 (models/vocoder.py:261-296). Its edge semantics are the Pallas
// kernel's, exactly:
//   * x is replicate-padded (here: the x index is clamped to [0, T)), so
//     the activation near the ends differs from the polyphase oracle;
//   * the activation runs in fp32 on x as stored (bf16 on the main path):
//       e[t] = sum_r 2h[2r]   x[t+r-3],     o[t] = sum_r 2h[2r+1] x[t+r-2]
//       s(v) = v + inv_b * sin(a*v)^2        (a = exp(alpha), inv_b =
//                                             1/(exp(beta)+1e-9), per channel)
//       z[t] = sum_r h[2r] s(o)[t+r-3] + h[2r+1] s(e)[t+r-2]
//     with h the 12-tap kaiser-sinc low-pass, then zeroed outside [0, T);
//   * z is rounded to the compute type before the tap contraction, which
//     sums in fp32 with the fp32 bias; the output has x's type.
// The Pallas kernel's pi-periodic polynomial sin^2 (ops/fastmath.py) was a
// Mosaic workaround; this kernel uses sinf (they differ by <= ~5e-7).
//
// What bounds it on an H100: at C=O=384, T=15k, B=4, K=11 a pair is
// 2*B*O*C*K*T = 1.9e11 FLOP against ~0.1 GB of x and y, far above the
// card's ~295 FLOP/byte line: operations bound. This first version runs the
// taps on the CUDA cores in fp32 (ceiling: the fp32 FMA rate).
//
// Design: the conv tiling is kernel B's (8*TO output channels x 32*TTH time
// steps per block, a TO x TTH register tile per thread, input channels in
// chunks of 8). At C=384 and K=11, dil=5 a shared-memory window of every
// channel does not fit, but the activation is per channel, so each chunk is
// activated where it is staged: the chunk's x rows (clamped) go to shared
// memory, the two 6-tap upsample phases and the snake are evaluated into
// two phase buffers, the 12-tap decimation writes z over the x buffer, and
// the chunk's taps accumulate into registers. The activation is recomputed
// once per output-channel tile (O/64 times), a small cost next to the taps.

#include "common.cuh"

namespace ditto {
namespace {

constexpr int kThreads = 256;
constexpr int kCC = 8;

struct Taps {
  float eu[6], ou[6], ze[6], zo[6];  // 2h[2r], 2h[2r+1], h[2r+1], h[2r]
};

template <typename T, int TO, int TTH>
__global__ void __launch_bounds__(kThreads)
act_conv_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ inv_b, const T* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ y, Taps taps,
                int C, int Tlen, int O, int K, int dil) {
  constexpr int OB = 8 * TO, TB = 32 * TTH;
  extern __shared__ float smem[];
  const int ca = (K - 1) * dil / 2;   // 'SAME' padding of the conv
  const int NZ = TB + 2 * ca;         // act rows  [t0-ca,   t0+TB+ca)
  const int NP = NZ + 6;              // phase rows [t0-ca-3, t0+TB+ca+3)
  const int NX = NZ + 12;             // x rows     [t0-ca-6, t0+TB+ca+6)
  float* xs = smem;                   // [kCC][NX], then z [kCC][NZ]
  float* se = xs + kCC * NX;          // [kCC][NP]
  float* so = se + kCC * NP;          // [kCC][NP]
  float* ws = so + kCC * NP;          // [OB][kCC][K]

  const int t0 = blockIdx.x * TB, o0 = blockIdx.y * OB, b = blockIdx.z;
  const int tid = threadIdx.x, to = tid >> 5, tt = tid & 31;
  const T* xb = x + static_cast<long long>(b) * C * Tlen;

  float acc[TO][TTH];
#pragma unroll
  for (int i = 0; i < TO; ++i)
#pragma unroll
    for (int j = 0; j < TTH; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();
    for (int i = tid; i < kCC * NX; i += kThreads) {
      const int c = i / NX, j = i % NX;
      const int cc = c0 + c;
      const int t = min(max(t0 - ca - 6 + j, 0), Tlen - 1);
      xs[i] = cc < C ? to_f<T>(xb[static_cast<long long>(cc) * Tlen + t]) : 0.f;
    }
    for (int i = tid; i < OB * kCC * K; i += kThreads) {
      const int o = i / (kCC * K), r = i % (kCC * K);
      const int c = r / K, kk = r % K;
      const int oo = o0 + o, cc = c0 + c;
      ws[i] = (oo < O && cc < C)
                  ? to_f<T>(w[(static_cast<long long>(oo) * C + cc) * K + kk]) : 0.f;
    }
    __syncthreads();
    // upsample phases + snake, fp32
    for (int i = tid; i < kCC * NP; i += kThreads) {
      const int c = i / NP, p = i % NP;
      const int cc = c0 + c;
      const float* xr = xs + c * NX + p;
      float e = taps.eu[0] * xr[0];
      float od = taps.ou[0] * xr[1];
#pragma unroll
      for (int m = 1; m < 6; ++m) {
        e = e + taps.eu[m] * xr[m];
        od = od + taps.ou[m] * xr[m + 1];
      }
      const float av = cc < C ? a[cc] : 0.f;
      const float ib = cc < C ? inv_b[cc] : 0.f;
      const float s1 = sinf(av * e), s2 = sinf(av * od);
      se[i] = e + ib * (s1 * s1);
      so[i] = od + ib * (s2 * s2);
    }
    __syncthreads();
    // decimation, zeroed outside [0, T), rounded to the compute type;
    // z overwrites the x buffer (row stride NZ)
    for (int i = tid; i < kCC * NZ; i += kThreads) {
      const int c = i / NZ, r = i % NZ;
      const float* sor = so + c * NP + r;
      const float* ser = se + c * NP + r + 1;
      float z = taps.zo[0] * sor[0] + taps.ze[0] * ser[0];
#pragma unroll
      for (int m = 1; m < 6; ++m) z = z + taps.zo[m] * sor[m] + taps.ze[m] * ser[m];
      const int t = t0 - ca + r;
      z = (t < 0 || t >= Tlen) ? 0.f : round_to<T>(z);
      xs[i] = z;
    }
    __syncthreads();
    for (int c = 0; c < kCC; ++c) {
      const float* zr = xs + c * NZ + tt;
      for (int kk = 0; kk < K; ++kk) {
        float wv[TO], zv[TTH];
#pragma unroll
        for (int i = 0; i < TO; ++i) wv[i] = ws[((to * TO + i) * kCC + c) * K + kk];
#pragma unroll
        for (int j = 0; j < TTH; ++j) zv[j] = zr[32 * j + kk * dil];
#pragma unroll
        for (int i = 0; i < TO; ++i)
#pragma unroll
          for (int j = 0; j < TTH; ++j) acc[i][j] = fmaf(wv[i], zv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TO; ++i) {
    const int o = o0 + to * TO + i;
    if (o >= O) continue;
    const float bv = bias != nullptr ? bias[o] : 0.f;
    T* yr = y + (static_cast<long long>(b) * O + o) * Tlen;
#pragma unroll
    for (int j = 0; j < TTH; ++j) {
      const int t = t0 + tt + 32 * j;
      if (t < Tlen) yr[t] = from_f<T>(acc[i][j] + bv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* a, const float* inv_b,
                   const void* w, const float* bias, void* y, const Taps& taps,
                   int B, int C, int Tlen, int O, int K, int dil,
                   cudaStream_t stream) {
  constexpr int TO = 8, TTH = 8;
  constexpr int OB = 8 * TO, TB = 32 * TTH;
  const int ca = (K - 1) * dil / 2;
  const int NZ = TB + 2 * ca;
  const size_t smem =
      (static_cast<size_t>(kCC) * ((NZ + 12) + 2 * (NZ + 6)) + OB * kCC * K) *
      sizeof(float);
  auto kernel = act_conv_kernel<T, TO, TTH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tlen + TB - 1) / TB, (O + OB - 1) / OB, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, inv_b, static_cast<const T*>(w), bias,
      static_cast<T*>(y), taps, C, Tlen, O, K, dil);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ditto

// x [B, C, T], a / inv_b [C] fp32, w [O, C, K] (K odd), bias [O] fp32 or
// null, y [B, O, T]; taps: 24 floats (2h[2r], 2h[2r+1], h[2r+1], h[2r])
extern "C" int ditto_act_conv(const void* x, const float* a, const float* inv_b,
                              const void* w, const float* bias, void* y,
                              const float* taps, int B, int C, int T, int O,
                              int K, int dil, int dtype, void* stream) {
  using namespace ditto;
  Taps tp;
  for (int r = 0; r < 6; ++r) {
    tp.eu[r] = taps[r];
    tp.ou[r] = taps[6 + r];
    tp.ze[r] = taps[12 + r];
    tp.zo[r] = taps[18 + r];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return launch<float>(x, a, inv_b, w, bias, y, tp, B, C, T, O, K, dil, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(x, a, inv_b, w, bias, y, tp, B, C, T, O, K, dil, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

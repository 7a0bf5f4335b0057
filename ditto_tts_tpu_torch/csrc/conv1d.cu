// Kernel B: VALID, stride-1, dilated conv1d on [B, C, T] with fp32 sums.
//
//   y[b, o, t] = bias[o] + sum_{c, k} w[o, c, k] * x[b, c, t + k*dil]
//
// Replaces the Pallas TPU kernels ditto_tts_tpu/ops/conv_pallas.py
// conv1d_nlc_pallas (_kernel, channels-last) and conv1d_ncl_pallas
// (_kernel_ncl / _kernel_ncl_windowed, time-minor): one function in two
// layouts. The port carries [B, C, T] everywhere, so one kernel serves every
// stride-1 conv of the SEANet codec (fp32, C 1..512, T up to 480k samples)
// and of BigVGAN (bf16: conv_pre, the polyphase upsample convs, the AMP
// convs outside the fused widths, conv_post). Operands are fp32 or bf16 (x
// and w of one type), the bias is fp32, the output has x's type.
//
// What bounds it on an H100: the SEANet convs at audio rate move
// ~2*B*C*T*4 bytes for 2*B*O*C*K*T FLOP (C=O=32, K=7: ~56 FLOP/byte) and the
// vocoder's wide convs are far above the card's ~295 FLOP/byte line, so by
// the card's peaks most calls are bound by operations. This first version
// runs the taps on the CUDA cores in fp32, so its ceiling is the fp32 FMA
// rate, not the tensor cores.
//
// Design: each block owns a tile of (8*TO output channels) x (32*TTH time
// steps) of one batch row; 256 threads each keep a TO x TTH register tile
// of fp32 sums. The block walks the input channels in chunks of 8: it
// stages the chunk's x window [t0, t0 + tile + (K-1)*dil) (the halo, zero
// past the end) and the chunk's weights in shared memory as fp32, then
// accumulates every tap of the chunk from shared memory. A warp shares one
// output-channel group (weight reads broadcast) and reads consecutive time
// steps (no bank conflicts). The ragged time and channel ends are masked.

#include "common.cuh"

namespace ditto {
namespace {

constexpr int kThreads = 256;
constexpr int kCC = 8;  // input channels per shared-memory chunk

template <typename T, int TO, int TTH>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const float* __restrict__ bias, T* __restrict__ y, int C,
              int Tin, int O, int Tout, int K, int dil) {
  constexpr int OB = 8 * TO, TB = 32 * TTH;
  extern __shared__ float smem[];
  const int W = TB + (K - 1) * dil;   // window width incl. halo
  float* xs = smem;                   // [kCC][W]
  float* ws = xs + kCC * W;           // [OB][kCC][K]

  const int t0 = blockIdx.x * TB, o0 = blockIdx.y * OB, b = blockIdx.z;
  const int tid = threadIdx.x, to = tid >> 5, tt = tid & 31;
  const T* xb = x + static_cast<long long>(b) * C * Tin;

  float acc[TO][TTH];
#pragma unroll
  for (int i = 0; i < TO; ++i)
#pragma unroll
    for (int j = 0; j < TTH; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();
    for (int i = tid; i < kCC * W; i += kThreads) {
      const int c = i / W, j = i % W;
      const int cc = c0 + c, t = t0 + j;
      xs[i] = (cc < C && t < Tin)
                  ? to_f<T>(xb[static_cast<long long>(cc) * Tin + t]) : 0.f;
    }
    for (int i = tid; i < OB * kCC * K; i += kThreads) {
      const int o = i / (kCC * K), r = i % (kCC * K);
      const int c = r / K, kk = r % K;
      const int oo = o0 + o, cc = c0 + c;
      ws[i] = (oo < O && cc < C)
                  ? to_f<T>(w[(static_cast<long long>(oo) * C + cc) * K + kk]) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < kCC; ++c) {
      const float* xr = xs + c * W + tt;
      for (int kk = 0; kk < K; ++kk) {
        float wv[TO], xv[TTH];
#pragma unroll
        for (int i = 0; i < TO; ++i) wv[i] = ws[((to * TO + i) * kCC + c) * K + kk];
#pragma unroll
        for (int j = 0; j < TTH; ++j) xv[j] = xr[32 * j + kk * dil];
#pragma unroll
        for (int i = 0; i < TO; ++i)
#pragma unroll
          for (int j = 0; j < TTH; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TO; ++i) {
    const int o = o0 + to * TO + i;
    if (o >= O) continue;
    const float bv = bias != nullptr ? bias[o] : 0.f;
    T* yr = y + (static_cast<long long>(b) * O + o) * Tout;
#pragma unroll
    for (int j = 0; j < TTH; ++j) {
      const int t = t0 + tt + 32 * j;
      if (t < Tout) yr[t] = from_f<T>(acc[i][j] + bv);
    }
  }
}

template <typename T, int TO>
cudaError_t launch(const void* x, const void* w, const float* bias, void* y,
                   int B, int C, int Tin, int O, int K, int dil,
                   cudaStream_t stream) {
  constexpr int TTH = 8;
  constexpr int OB = 8 * TO, TB = 32 * TTH;
  const int Tout = Tin - (K - 1) * dil;
  const size_t smem =
      (static_cast<size_t>(kCC) * (TB + (K - 1) * dil) + OB * kCC * K) * sizeof(float);
  auto kernel = conv1d_kernel<T, TO, TTH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tout + TB - 1) / TB, (O + OB - 1) / OB, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(y), C, Tin, O, Tout, K, dil);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const float* bias, void* y,
                     int B, int C, int Tin, int O, int K, int dil,
                     cudaStream_t s) {
  // the narrowest output-channel tile that covers O (8 channels a warp row)
  if (O <= 8) return launch<T, 1>(x, w, bias, y, B, C, Tin, O, K, dil, s);
  if (O <= 16) return launch<T, 2>(x, w, bias, y, B, C, Tin, O, K, dil, s);
  if (O <= 32) return launch<T, 4>(x, w, bias, y, B, C, Tin, O, K, dil, s);
  return launch<T, 8>(x, w, bias, y, B, C, Tin, O, K, dil, s);
}

}  // namespace
}  // namespace ditto

// x [B, C, Tin], w [O, C, K], bias [O] fp32 or null, y [B, O, Tin-(K-1)*dil]
extern "C" int ditto_conv1d(const void* x, const void* w, const float* bias,
                            void* y, int B, int C, int Tin, int O, int K,
                            int dil, int dtype, void* stream) {
  using namespace ditto;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return dispatch<float>(x, w, bias, y, B, C, Tin, O, K, dil, s);
  if (dtype == kBFloat16)
    return dispatch<__nv_bfloat16>(x, w, bias, y, B, C, Tin, O, K, dil, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
//       s(v) = v + inv_b * sin2(a*v)         (a = exp(alpha), inv_b =
//                                             1/(exp(beta)+1e-9), per channel)
//       z[t] = sum_r h[2r] s(o)[t+r-3] + h[2r+1] s(e)[t+r-2]
//     with h the 12-tap kaiser-sinc low-pass, then zeroed outside [0, T)
//     (aa_act.cuh, in the order of aa_snake_conv1d_plain);
//   * z is rounded to the compute type before the tap contraction, which
//     sums in fp32 with the fp32 bias (and, for the time-minor twin
//     aa_snake_conv1d_ncl, the residual) before the single cast to the
//     output type TY (the signal's carry type; x and w have the compute
//     type).
//
// It also replaces ditto_tts_tpu/ops/act_conv_pallas.py aa_snake_conv1d_ncl
// (_kernel_ncl), the same function on the time-minor layout with the AMP
// block's residual add in the epilogue (models/vocoder.py:299-330, under
// aa_impl="fused_ncl", at widths 48 and 24): the port carries [B, C, T], so
// that is this kernel with the optional residual pointer.
// sin2 is the Pallas kernel's own pi-periodic polynomial sin^2
// (ops/fastmath.py; aa_act.cuh sin2f), as in the plain version.
//
// What bounds it on an H100: at C=O=384, T=15k, B=4, K=11 a pair is
// 2*B*O*C*K*T = 1.9e11 FLOP against ~0.1 GB of x and y, far above the
// card's ~295 FLOP/byte line: operations bound, on the tensor cores in
// bf16. The activation adds ~60-100 issued fp32 instructions per sample of
// each channel chunk, once for each output-channel tile.
//
// bf16 (act_conv_kernel_tc): kernel B's tap-sum implicit GEMM on mma.sync
// (tap_gemm.cuh) over an activation computed once. A block owns BN time
// steps of one batch row and every output channel. First it activates
// every input channel over the rows [t0-ca, t0+BN+ca) into one resident,
// time-major slab [BN + 2ca][C + 8] in shared memory (139.5 KB at C=384,
// K=11, dil=5): a thread computes a run of 16 rows of one channel in
// registers (aa_act.cuh) from x read with 16-byte loads (runs start where
// the x window is 16-byte aligned in time), zeroes the rows outside [0, T),
// rounds z to bf16 and stores it into its channel's column (a warp's 32
// lanes are 32 channels, so each row store is one 64-byte segment). Then
// it walks O tiles of BM x chunks of KC channels x taps; tap m reads the
// slab shifted by m*dil rows, the weights (reordered per call into
// [K][O][Cp] by tap_weight_reorder) stream through B's 3-deep cp.async
// ring, whose first tiles fly during the activation. So the activation is
// evaluated once per sample and halo row, not once per O tile and chunk.
// Epilogue of each O tile straight from the fragments: the fp32 bias and
// residual join the sum before the one cast to TY; ragged T and O are
// masked. Tiles (measured, PERF.md): at O > 96, 12 warps of 64 x 32 (BM
// 192, BN 128, one block an SM) and chunks of 64 channels, which halve the
// ring's barriers (-25% against 32 at 384 and 192); below, 8 warps of 48 x
// 32 or 32 x 32 (two blocks an SM) and chunks of 32, which pad C = 48 and
// 24 less. A slab that does not fit in shared memory beside the ring (C >
// 384 at K=11, dil=5, O > 96; the widest C on any path is 384) is refused.
//
// fp32 (act_conv_kernel) stays on the CUDA cores in exact fp32 (TF32 would
// break the fp32 chain parity's 2e-5): kernel B's fp32 tiling (8*TO output
// channels x 32*TTH time steps per block, a TO x TTH register tile per
// thread, input channels in chunks of 8); each chunk's x rows go to shared
// memory, the two upsample phases and the snake are evaluated into two
// phase buffers, the decimation writes z over the x buffer, and the
// chunk's taps accumulate from shared memory.

#include "aa_act.cuh"
#include "common.cuh"
#include "tap_gemm.cuh"

namespace ditto {
namespace {

// ---- fp32 x and w: the CUDA cores ----

constexpr int kThreads = 256;
constexpr int kCC = 8;

template <typename TY, int TO, int TTH>
__global__ void __launch_bounds__(kThreads)
act_conv_kernel(const float* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ inv_b, const float* __restrict__ w,
                const float* __restrict__ bias, const TY* __restrict__ res,
                TY* __restrict__ y, AaTaps taps, int C, int Tlen, int O,
                int K, int dil) {
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
  const float* xb = x + static_cast<long long>(b) * C * Tlen;

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
      xs[i] = cc < C ? xb[static_cast<long long>(cc) * Tlen + t] : 0.f;
    }
    for (int i = tid; i < OB * kCC * K; i += kThreads) {
      const int o = i / (kCC * K), r = i % (kCC * K);
      const int c = r / K, kk = r % K;
      const int oo = o0 + o, cc = c0 + c;
      ws[i] = (oo < O && cc < C)
                  ? w[(static_cast<long long>(oo) * C + cc) * K + kk] : 0.f;
    }
    __syncthreads();
    // upsample phases + snake, fp32
    for (int i = tid; i < kCC * NP; i += kThreads) {
      const int c = i / NP, p = i % NP;
      const int cc = c0 + c;
      const float* xr = xs + c * NX + p;
      float e = taps.ue[0] * xr[0];
      float od = taps.uo[0] * xr[1];
#pragma unroll
      for (int m = 1; m < 6; ++m) {
        e = e + taps.ue[m] * xr[m];
        od = od + taps.uo[m] * xr[m + 1];
      }
      const float av = cc < C ? a[cc] : 0.f;
      const float ib = cc < C ? inv_b[cc] : 0.f;
      se[i] = snake_act(e, av, ib);
      so[i] = snake_act(od, av, ib);
    }
    __syncthreads();
    // decimation, zeroed outside [0, T); z overwrites the x buffer (row
    // stride NZ)
    for (int i = tid; i < kCC * NZ; i += kThreads) {
      const int c = i / NZ, r = i % NZ;
      const float* sor = so + c * NP + r;
      const float* ser = se + c * NP + r + 1;
      float z = taps.dn[0] * sor[0] + taps.de[0] * ser[0];
#pragma unroll
      for (int m = 1; m < 6; ++m) z = z + taps.dn[m] * sor[m] + taps.de[m] * ser[m];
      const int t = t0 - ca + r;
      xs[i] = (t < 0 || t >= Tlen) ? 0.f : z;
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
    const long long row = (static_cast<long long>(b) * O + o) * Tlen;
#pragma unroll
    for (int j = 0; j < TTH; ++j) {
      const int t = t0 + tt + 32 * j;
      if (t >= Tlen) continue;
      float v = acc[i][j] + bv;
      if (res != nullptr) v += to_f<TY>(res[row + t]);
      y[row + t] = from_f<TY>(v);
    }
  }
}

template <typename TY, int TO>
cudaError_t launch(const void* x, const float* a, const float* inv_b,
                   const void* w, const float* bias, const void* res, void* y,
                   const AaTaps& taps, int B, int C, int Tlen, int O, int K,
                   int dil, cudaStream_t stream) {
  constexpr int TTH = 8;
  constexpr int OB = 8 * TO, TB = 32 * TTH;
  const int ca = (K - 1) * dil / 2;
  const int NZ = TB + 2 * ca;
  const size_t smem =
      (static_cast<size_t>(kCC) * ((NZ + 12) + 2 * (NZ + 6)) + OB * kCC * K) *
      sizeof(float);
  auto kernel = act_conv_kernel<TY, TO, TTH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tlen + TB - 1) / TB, (O + OB - 1) / OB, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), a, inv_b, static_cast<const float*>(w),
      bias, static_cast<const TY*>(res), static_cast<TY*>(y), taps, C, Tlen,
      O, K, dil);
  return cudaGetLastError();
}

template <typename TY>
cudaError_t dispatch_f32(const void* x, const float* a, const float* inv_b,
                         const void* w, const float* bias, const void* res,
                         void* y, const AaTaps& taps, int B, int C, int Tlen,
                         int O, int K, int dil, cudaStream_t s) {
  if (O <= 32)
    return launch<TY, 4>(x, a, inv_b, w, bias, res, y, taps, B, C, Tlen, O, K, dil, s);
  return launch<TY, 8>(x, a, inv_b, w, bias, res, y, taps, B, C, Tlen, O, K, dil, s);
}

// ---- bf16 x and w: the tap GEMM on the tensor cores ----

constexpr int kStages = 3;   // weight tiles in the cp.async ring
constexpr int kNR = 16;      // slab rows of one channel a thread activates

template <typename TY>
__device__ __forceinline__ float2 load_pair(const TY* p) {
  if constexpr (sizeof(TY) == 4) return *reinterpret_cast<const float2*>(p);
  else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(p);
    return make_float2(bf16_lo(v), bf16_hi(v));
  }
}

template <typename TY>
__device__ __forceinline__ void store_pair(TY* p, float v0, float v1) {
  if constexpr (sizeof(TY) == 4) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  else *reinterpret_cast<uint32_t*>(p) = pack_bf16(v0, v1);
}

// the slab's pitch: C rounded up to whole chunks of KC channels, + 8 (an
// odd multiple of 16 bytes)
template <int KC>
__host__ __device__ __forceinline__ int slab_pitch(int C) {
  return (C + KC - 1) / KC * KC + 8;
}

// Warps of MT x 4 mma tiles (16 MT output channels x 32 time steps), WARPS_M
// x WARPS_N of them: BM = 16 MT WARPS_M output channels a tile, BN = 32
// WARPS_N time steps a block; weight tiles of KC input channels
template <typename TY, int MT, int WARPS_M, int WARPS_N, int KC>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32,
                                  512 / (WARPS_M * WARPS_N * 32))
act_conv_kernel_tc(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ a,
                   const float* __restrict__ inv_b,
                   const __nv_bfloat16* __restrict__ wr,
                   const float* __restrict__ bias, const TY* __restrict__ res,
                   TY* __restrict__ y, AaTaps taps, int C, int Cp, int Tlen,
                   int O, int K, int dil, int vec_x, int vec_y) {
  constexpr int NT = 4, NTH = WARPS_M * WARPS_N * 32;
  constexpr int WM = 16 * MT, WN = 8 * NT, BM = WARPS_M * WM, BN = WARPS_N * WN;
  constexpr int PW = KC + 8;
  constexpr int NV = (kNR + 11 + 7) / 8;   // 16-byte vectors of an x window
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][BM][PW]
  __nv_bfloat16* Zs = Ws + kStages * BM * PW;                       // [R][P]
  const int ca = (K - 1) * dil / 2;   // 'SAME' padding of the conv
  const int R = BN + 2 * ca;          // slab rows: z at [t0-ca, t0+BN+ca)
  const int P = slab_pitch<KC>(C), Cs = P - 8;

  const int t0 = blockIdx.x * BN, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int per_tile = Cs / KC * K;   // (chunk, tap) steps of one O tile
  const int J = (O + BM - 1) / BM * per_tile;

  auto load_w = [&](int jj) {   // step jj = (O tile, chunk, tap) into its slot
    const int ot = jj / per_tile, r = jj - ot * per_tile;
    const int i = r / K, m = r - i * K;
    __nv_bfloat16* dst = Ws + (jj % kStages) * BM * PW;
    for (int u = tid; u < BM * (KC / 8); u += NTH) {
      const int row = u / (KC / 8), seg = u % (KC / 8);
      const int o = ot * BM + row, c = i * KC + seg * 8;
      const bool ok = o < O && c < Cp;
      cp_async16(dst + row * PW + seg * 8,
                 ok ? wr + (static_cast<long long>(m) * O + o) * Cp + c : wr,
                 ok);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {   // in flight during the activation
    if (st < J) load_w(st);
    cp_async_commit();
  }

  // The activation of every input channel over the slab's rows, once.
  // Item q is channel q % Cs (a warp's lanes: 32 consecutive channels, so
  // each row store is one 64-byte segment) of run q / Cs: slab rows
  // [r0, r0 + kNR), r0 = s0 + kNR (q / Cs) with s0 in (-8, 0] and s0 = ca + 5
  // (mod 8), so every run's x window [t0-ca+r0-5, +kNR+11) starts 8-aligned
  // in time. Channels past C are zeros, which zero weights multiply.
  {
    int s0 = (ca + 5) % 8;
    if (s0 > 0) s0 -= 8;
    const int items = Cs * ((R - s0 + kNR - 1) / kNR);
    const __nv_bfloat16* xb = x + static_cast<long long>(b) * C * Tlen;
    for (int q = tid; q < items; q += NTH) {
      const int c = q % Cs, r0 = s0 + q / Cs * kNR;
      float z[kNR];
      if (c < C) {
        const int ts = t0 - ca + r0 - 5;
        const __nv_bfloat16* src = xb + static_cast<long long>(c) * Tlen;
        float xw[kNR + 11];
        if (vec_x && ts >= 0 && ts + 8 * NV <= Tlen) {
          uint32_t v[4 * NV];
          load_vec<NV>(v, src + ts);
#pragma unroll
          for (int j = 0; j < kNR + 11; ++j) xw[j] = word_elem<__nv_bfloat16>(v, j);
        } else {
#pragma unroll
          for (int j = 0; j < kNR + 11; ++j)
            xw[j] = to_f<__nv_bfloat16>(src[min(max(ts + j, 0), Tlen - 1)]);
        }
        aa_act<false, false, kNR>(xw, a[c], inv_b[c], taps, z);
      } else {
#pragma unroll
        for (int j = 0; j < kNR; ++j) z[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kNR; ++j) {
        const int r = r0 + j, t = t0 - ca + r;
        if (r >= 0 && r < R)
          Zs[r * P + c] = __float2bfloat16(t >= 0 && t < Tlen ? z[j] : 0.f);
      }
    }
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int g = lane >> 2, qd = lane & 3;
  for (int jj = 0; jj < J; ++jj) {
    const int ot = jj / per_tile, r = jj - ot * per_tile;
    const int i = r / K, m = r - i * K;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step jj's weights (and, at jj = 0, the slab) are in
                       // shared memory; every warp is done with the slot
                       // refilled below
    if (jj + kStages - 1 < J) load_w(jj + kStages - 1);
    cp_async_commit();
    tap_mma<MT, NT, KC, PW>(acc, Ws + ((jj % kStages) * BM + wm * WM) * PW,
                            Zs + (wn * WN + m * dil) * P + i * KC, P, lane);
    if (r != per_tile - 1) continue;

    // the O tile's epilogue from the fragments: + bias (+ residual) in
    // fp32, one cast
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int o = ot * BM + wm * WM + mt * 16 + g + half * 8;
        if (o >= O) continue;
        const float bv = bias != nullptr ? bias[o] : 0.f;
        const long long row = (static_cast<long long>(b) * O + o) * Tlen;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int t = t0 + wn * WN + nt * 8 + 2 * qd;
          float v0 = acc[mt][nt][2 * half] + bv;
          float v1 = acc[mt][nt][2 * half + 1] + bv;
          if (vec_y && t + 1 < Tlen) {
            if (res != nullptr) {
              const float2 rv = load_pair<TY>(res + row + t);
              v0 += rv.x;
              v1 += rv.y;
            }
            store_pair<TY>(y + row + t, v0, v1);
          } else {
            if (t < Tlen) {
              if (res != nullptr) v0 += to_f<TY>(res[row + t]);
              y[row + t] = from_f<TY>(v0);
            }
            if (t + 1 < Tlen) {
              if (res != nullptr) v1 += to_f<TY>(res[row + t + 1]);
              y[row + t + 1] = from_f<TY>(v1);
            }
          }
        }
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
  cp_async_wait<0>();
}

template <typename TY, int MT, int WARPS_M, int WARPS_N, int KC>
cudaError_t launch_tc(const void* x, const float* a, const float* inv_b,
                      const void* wr, const float* bias, const void* res,
                      void* y, const AaTaps& taps, int B, int C, int Cp,
                      int Tlen, int O, int K, int dil, cudaStream_t stream) {
  constexpr int BM = 16 * MT * WARPS_M, BN = 32 * WARPS_N;
  const size_t rows = BN + static_cast<size_t>((K - 1) * dil / 2) * 2;
  const size_t smem = (static_cast<size_t>(kStages) * BM * (KC + 8) +
                       rows * slab_pitch<KC>(C)) * sizeof(__nv_bfloat16);
  if (smem > 227 * 1024)   // the slab of every channel does not fit
    return cudaErrorInvalidValue;
  auto kernel = act_conv_kernel_tc<TY, MT, WARPS_M, WARPS_N, KC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tlen + BN - 1) / BN, B);
  const int vec_x = Tlen % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const uintptr_t pair = 2 * sizeof(TY);
  const int vec_y = Tlen % 2 == 0 && reinterpret_cast<uintptr_t>(y) % pair == 0 &&
                    reinterpret_cast<uintptr_t>(res) % pair == 0;
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), a, inv_b,
      static_cast<const __nv_bfloat16*>(wr), bias,
      static_cast<const TY*>(res), static_cast<TY*>(y), taps, C, Cp, Tlen, O,
      K, dil, vec_x, vec_y);
  return cudaGetLastError();
}

// the tile by O (MT, WARPS_M, WARPS_N, KC): 12 warps of 64 x 32, BM 192 x
// BN 128, for the wide stages; 8 warps (two blocks an SM) of 48 x 32 or
// 32 x 32 below
template <typename TY>
cudaError_t dispatch_tc(const void* x, const float* a, const float* inv_b,
                        const void* wr, const float* bias, const void* res,
                        void* y, const AaTaps& taps, int B, int C, int Cp,
                        int Tlen, int O, int K, int dil, cudaStream_t s) {
#define DITTO_TC(MT, WM, WN, KC)                                             \
  launch_tc<TY, MT, WM, WN, KC>(x, a, inv_b, wr, bias, res, y, taps, B, C, \
                                Cp, Tlen, O, K, dil, s)
  if (O > 96) return DITTO_TC(4, 3, 4, 64);   // 192, 384
  if (O > 48) return DITTO_TC(3, 2, 4, 32);   // 96
  if (O > 32) return DITTO_TC(3, 1, 8, 32);   // 48
  return DITTO_TC(2, 1, 8, 32);               // 24
#undef DITTO_TC
}

}  // namespace
}  // namespace ditto

// x [B, C, T] and w [O, C, K] (K odd) of type `dtype`, a / inv_b [C] fp32,
// bias [O] fp32 or null, residual [B, O, T] of type `ydtype` or null, y
// [B, O, T] of type `ydtype`; wr: for bf16, scratch for the reordered
// weights [K, O, (C+7)/8*8]; taps: 24 floats (2h[2r], 2h[2r+1], h[2r+1],
// h[2r])
extern "C" int ditto_act_conv(const void* x, const float* a, const float* inv_b,
                              const void* w, void* wr, const float* bias,
                              const void* res, void* y, const float* taps,
                              int B, int C, int T, int O, int K, int dil,
                              int dtype, int ydtype, void* stream) {
  using namespace ditto;
  AaTaps tp;
  for (int r = 0; r < 6; ++r) {
    tp.ue[r] = taps[r];
    tp.uo[r] = taps[6 + r];
    tp.de[r] = taps[12 + r];
    tp.dn[r] = taps[18 + r];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (dtype == kFloat32 && ydtype == kFloat32)
    return dispatch_f32<float>(x, a, inv_b, w, bias, res, y, tp, B, C, T, O, K, dil, s);
  if (dtype == kFloat32 && ydtype == kBFloat16)
    return dispatch_f32<bf16>(x, a, inv_b, w, bias, res, y, tp, B, C, T, O, K, dil, s);
  if (dtype != kBFloat16 || wr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = reorder_weights(w, wr, O, C, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Cp = (C + 7) / 8 * 8;
  if (ydtype == kFloat32)
    return dispatch_tc<float>(x, a, inv_b, wr, bias, res, y, tp, B, C, Cp, T, O, K, dil, s);
  if (ydtype == kBFloat16)
    return dispatch_tc<bf16>(x, a, inv_b, wr, bias, res, y, tp, B, C, Cp, T, O, K, dil, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// What bounds it on an H100: the vocoder's wide convs (C = O = 768, K = 11:
// 2*B*O*C*K*T = 195 GFLOP at T = 3752, B = 4) are far above the card's ~295
// FLOP/byte line and bound by operations; the narrow stages (C = O = 24 or
// 48 at T = 120k..240k) and the SEANet convs move more bytes than their
// operations need and sit near the bytes bound.
//
// bf16 (conv1d_kernel_tc): a tap-sum implicit GEMM on mma.sync, as the
// Pallas kernels summed [bt, C] x [C, ocb] MXU products over the taps into
// an fp32 accumulator (ops/conv_pallas.py:56-71). A block of 8 warps owns a
// BM x BN tile (output channels x time) of one batch row in fp32
// registers and walks the input channels in chunks of KC (32, or 64 for
// the 64-row tile). For each chunk it stages x as a time-major slab
// [BN + (K-1)*dil][KC + 8] (tap_gemm.cuh); each tap's mma B operand is that
// slab shifted by m*dil rows, so one slab feeds all K taps. x is [B, C, T]
// with time minor, which cp.async cannot transpose (and ldmatrix.trans on
// a [C][T] slab needs m*dil % 8 == 0, which dil in {1, 3, 5} breaks): the
// next chunk's x is loaded into registers when a chunk starts and stored
// transposed when its last tap is done (a register double buffer), in
// units of 2 channels x 2 time steps (one 32-bit load per channel where T
// is even and x 4-byte aligned, then byte permutes that pair the
// channels); a warp takes 8 row pairs of 4 channel pairs, so its reads are
// whole 32-byte sectors and its shared stores meet at most 2 to a bank.
// The weights are reordered once per call by tap_weight_reorder into
// [K][O][Cp] (C padded with zeros to Cp, a multiple of 8), so each tap's
// [BM][KC] tile is a cp.async copy; a ring of 3 such tiles keeps two in
// flight while the tensor cores work. Missing channels and rows are
// zero-filled, never read past the tensor. Epilogue: the fp32 bias joins
// the sum, one cast to bf16, the tile staged through shared memory so that
// rows leave coalesced along T; ragged T and O ends are masked. No split
// over channels across blocks, no atomics: the result is deterministic.
// Measured on the card (PERF.md): the tap iterations of the wide convs run
// at ~224 TFLOP/s and staging one slab costs about 2 tap iterations, which
// leaves the wide convs ~2x slower than F.conv1d; the narrow stages (one
// chunk) are bound by each block's staging-compute-store chain, not by
// bytes, and beat F.conv1d.
//
// fp32 (conv1d_kernel) stays on the CUDA cores in exact fp32: it serves the
// fp32 SEANet codec and the fp32 chain parity with TF32 off, which TF32
// (~1e-3) would break at its 2e-5 tolerance. Each block owns a tile of
// (8*TO output channels) x (32*TTH time steps) of one batch row; 256
// threads each keep a TO x TTH register tile of fp32 sums. The block walks
// the input channels in chunks of 8: it stages the chunk's x window (the
// halo zero past the end) and weights in shared memory, then accumulates
// every tap of the chunk from shared memory.

#include "common.cuh"
#include "tap_gemm.cuh"

namespace ditto {
namespace {

constexpr int kThreads = 256;
constexpr int kCC = 8;  // input channels per shared-memory chunk

template <int TO, int TTH>
__global__ void __launch_bounds__(kThreads)
conv1d_kernel(const float* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ bias, float* __restrict__ y, int C,
              int Tin, int O, int Tout, int K, int dil) {
  constexpr int OB = 8 * TO, TB = 32 * TTH;
  extern __shared__ float smem[];
  const int W = TB + (K - 1) * dil;   // window width incl. halo
  float* xs = smem;                   // [kCC][W]
  float* ws = xs + kCC * W;           // [OB][kCC][K]

  const int t0 = blockIdx.x * TB, o0 = blockIdx.y * OB, b = blockIdx.z;
  const int tid = threadIdx.x, to = tid >> 5, tt = tid & 31;
  const float* xb = x + static_cast<long long>(b) * C * Tin;

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
                  ? xb[static_cast<long long>(cc) * Tin + t] : 0.f;
    }
    for (int i = tid; i < OB * kCC * K; i += kThreads) {
      const int o = i / (kCC * K), r = i % (kCC * K);
      const int c = r / K, kk = r % K;
      const int oo = o0 + o, cc = c0 + c;
      ws[i] = (oo < O && cc < C)
                  ? w[(static_cast<long long>(oo) * C + cc) * K + kk] : 0.f;
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
    float* yr = y + (static_cast<long long>(b) * O + o) * Tout;
#pragma unroll
    for (int j = 0; j < TTH; ++j) {
      const int t = t0 + tt + 32 * j;
      if (t < Tout) yr[t] = acc[i][j] + bv;
    }
  }
}

template <int TO>
cudaError_t launch(const void* x, const void* w, const float* bias, void* y,
                   int B, int C, int Tin, int O, int K, int dil,
                   cudaStream_t stream) {
  constexpr int TTH = 8;
  constexpr int OB = 8 * TO, TB = 32 * TTH;
  const int Tout = Tin - (K - 1) * dil;
  const size_t smem =
      (static_cast<size_t>(kCC) * (TB + (K - 1) * dil) + OB * kCC * K) * sizeof(float);
  auto kernel = conv1d_kernel<TO, TTH>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tout + TB - 1) / TB, (O + OB - 1) / OB, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(y), C, Tin, O, Tout, K, dil);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* x, const void* w, const float* bias,
                         void* y, int B, int C, int Tin, int O, int K,
                         int dil, cudaStream_t s) {
  // the narrowest output-channel tile that covers O (8 channels a warp row)
  if (O <= 8) return launch<1>(x, w, bias, y, B, C, Tin, O, K, dil, s);
  if (O <= 16) return launch<2>(x, w, bias, y, B, C, Tin, O, K, dil, s);
  if (O <= 32) return launch<4>(x, w, bias, y, B, C, Tin, O, K, dil, s);
  return launch<8>(x, w, bias, y, B, C, Tin, O, K, dil, s);
}

// ---- bf16: the tap-sum implicit GEMM on the tensor cores ----

constexpr int kStages = 3;         // weight tiles in the cp.async ring
constexpr int kTcThreads = 256;    // 8 warps

template <int BM, int BN, int KC>
size_t tc_smem_bytes(int halo) {
  const size_t main = (static_cast<size_t>(kStages) * BM +
                       2 * static_cast<size_t>(BN + halo)) * (KC + 8);
  const size_t epi = static_cast<size_t>(BM) * (BN + 8);
  return (main > epi ? main : epi) * sizeof(__nv_bfloat16);
}

// BM x BN output tile (channels x time), warps of WM x WN, KC input
// channels a chunk; slab and weight rows have a pitch of KC + 8 elements
template <int BM, int BN, int WM, int WN, int KC>
__global__ void __launch_bounds__(kTcThreads, 2)   // 2 blocks an SM
conv1d_kernel_tc(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ wr,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                 int C, int Cp, int Tin, int O, int Tout, int K, int dil,
                 int vec) {
  constexpr int WARPS_N = BN / WN, MT = WM / 16, NT = WN / 8, P = KC + 8;
  static_assert((BM / WM) * WARPS_N * 32 == kTcThreads, "8 warps a block");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kStages][BM][P]
  const int R = BN + (K - 1) * dil;                                 // slab rows
  __nv_bfloat16* Xs = Ws + kStages * BM * P;                        // [2][R][P]

  const int t0 = blockIdx.x * BN, o0 = blockIdx.y * BM, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) +
                             static_cast<long long>(b) * C * Tin;
  const int nchunks = (C + KC - 1) / KC, J = nchunks * K;

  auto load_w = [&](int jj) {   // tap tile jj = (chunk, tap) into its slot
    const int i = jj / K, m = jj - i * K;
    __nv_bfloat16* dst = Ws + (jj % kStages) * BM * P;
    for (int u = tid; u < BM * (KC / 8); u += kTcThreads) {
      const int r = u / (KC / 8), seg = u % (KC / 8);
      const int o = o0 + r, c = i * KC + seg * 8;
      const bool ok = o < O && c < Cp;
      cp_async16(dst + r * P + seg * 8,
                 ok ? wr + (static_cast<long long>(m) * O + o) * Cp + c : wr,
                 ok);
    }
  };
  // x units: channels c, c+1 of pair p at slab rows 2q, 2q+1, four values
  // in two 32-bit words. A warp takes blocks of 8 row pairs x 4 channel
  // pairs, so its global reads are whole 32-byte sectors and its shared
  // stores meet at most 2 to a bank; warp w holds blocks w*XV .. w*XV+XV-1
  // (every warp gets its share of the channel pairs past C) in registers,
  // enough for a halo up to 64 rows; a longer halo's rest is copied in
  // place, 8 blocks a step.
  constexpr int NPB = KC / 8;                   // blocks of 4 channel pairs
  constexpr int XV = (((BN + 64) / 2 + 7) / 8 * NPB + 7) / 8;
  const int RQ = (R + 1) / 2;                   // row pairs of the slab
  const int pl = lane >> 3, ql = lane & 7;
  auto x_pair = [&](int i, int p, int q, uint32_t& w0, uint32_t& w1) {
    const int c = i * KC + 2 * p, t = t0 + 2 * q;
    uint32_t a = 0, a1 = 0;   // x[c][t..t+1], x[c+1][t..t+1]
    if (t < Tin && c < C) {
      const unsigned short* src = xb + static_cast<long long>(c) * Tin + t;
      const bool c1 = c + 1 < C;
      if (vec) {   // Tin even, x 4-byte aligned: t, t+1 in one word
        a = *reinterpret_cast<const uint32_t*>(src);
        if (c1) a1 = *reinterpret_cast<const uint32_t*>(src + Tin);
      } else {
        const bool t1 = t + 1 < Tin;
        a = src[0] | (t1 ? static_cast<uint32_t>(src[1]) << 16 : 0u);
        if (c1)
          a1 = src[Tin] | (t1 ? static_cast<uint32_t>(src[Tin + 1]) << 16 : 0u);
      }
    }
    w0 = __byte_perm(a, a1, 0x5410);   // x[c][t],   x[c+1][t]
    w1 = __byte_perm(a, a1, 0x7632);   // x[c][t+1], x[c+1][t+1]
  };
  auto x_store = [&](int buf, int p, int q, uint32_t w0, uint32_t w1) {
    uint32_t* dst =
        reinterpret_cast<uint32_t*>(Xs + (buf * R + 2 * q) * P + 2 * p);
    dst[0] = w0;
    if (2 * q + 1 < R) dst[P / 2] = w1;
  };
  uint32_t xr[2 * XV];
  auto load_x = [&](int i) {
#pragma unroll
    for (int e = 0; e < XV; ++e) {
      const int kb = warp * XV + e, q = kb / NPB * 8 + ql;
      if (q < RQ) x_pair(i, kb % NPB * 4 + pl, q, xr[2 * e], xr[2 * e + 1]);
    }
  };
  auto store_x = [&](int i, int buf) {
#pragma unroll
    for (int e = 0; e < XV; ++e) {
      const int kb = warp * XV + e, q = kb / NPB * 8 + ql;
      if (q < RQ) x_store(buf, kb % NPB * 4 + pl, q, xr[2 * e], xr[2 * e + 1]);
    }
    for (int kb = 8 * XV + warp; kb / NPB * 8 < RQ; kb += 8) {
      const int p = kb % NPB * 4 + pl, q = kb / NPB * 8 + ql;
      if (q >= RQ) continue;
      uint32_t w0, w1;
      x_pair(i, p, q, w0, w1);
      x_store(buf, p, q, w0, w1);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load_x(0);
  store_x(0, 0);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < J) load_w(st);
    cp_async_commit();
  }
  for (int jj = 0; jj < J; ++jj) {
    const int i = jj / K, m = jj - i * K;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tap tile jj and slab i are in shared memory, and
                       // every warp is done with the slot refilled below
    if (jj + kStages - 1 < J) load_w(jj + kStages - 1);
    cp_async_commit();
    const bool next_x = i + 1 < nchunks;
    if (next_x && m == 0) load_x(i + 1);
    tap_mma<MT, NT, KC, P>(
        acc, Ws + ((jj % kStages) * BM + wm * WM) * P,
        Xs + ((i & 1) * R + wn * WN + m * dil) * P, P, lane);
    if (next_x && m == K - 1) store_x(i + 1, (i + 1) & 1);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring and the slabs are free for the epilogue

  constexpr int PY = BN + 8;
  __nv_bfloat16* Ys = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][PY]
  const int g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * WM + mt * 16 + g + half * 8;
      const float bv = bias != nullptr && o0 + r < O ? bias[o0 + r] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<uint32_t*>(Ys + r * PY + wn * WN + nt * 8 + 2 * qd) =
            pack_bf16(acc[mt][nt][2 * half] + bv,
                      acc[mt][nt][2 * half + 1] + bv);
    }
  __syncthreads();
  const int tn = min(BN, Tout - t0);
  __nv_bfloat16* yb = y + (static_cast<long long>(b) * O + o0) * Tout + t0;
  if ((Tout & 1) == 0) {   // bf16 pairs: rows start 4-byte aligned
    for (int u = tid; u < BM * (BN / 2); u += kTcThreads) {
      const int r = u / (BN / 2), c = 2 * (u % (BN / 2));
      if (o0 + r < O && c < tn)
        *reinterpret_cast<uint32_t*>(yb + static_cast<long long>(r) * Tout + c) =
            *reinterpret_cast<const uint32_t*>(Ys + r * PY + c);
    }
  } else {
    for (int u = tid; u < BM * BN; u += kTcThreads) {
      const int r = u / BN, c = u % BN;
      if (o0 + r < O && c < tn)
        yb[static_cast<long long>(r) * Tout + c] = Ys[r * PY + c];
    }
  }
}

template <int BM, int BN, int WM, int WN, int KC>
cudaError_t launch_tc(const void* x, const void* wr, const float* bias,
                      void* y, int B, int C, int Cp, int Tin, int O, int K,
                      int dil, cudaStream_t stream) {
  const int Tout = Tin - (K - 1) * dil;
  const size_t smem = tc_smem_bytes<BM, BN, KC>((K - 1) * dil);
  auto kernel = conv1d_kernel_tc<BM, BN, WM, WN, KC>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tout + BN - 1) / BN, (O + BM - 1) / BM, B);
  const int vec = Tin % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0;
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(wr), bias,
      static_cast<__nv_bfloat16*>(y), C, Cp, Tin, O, Tout, K, dil, vec);
  return cudaGetLastError();
}

// the tile configuration (BM, BN, warp tile, chunk) by O, each the fastest
// one measured for its band of O (PERF.md)
cudaError_t dispatch_tc(const void* x, const void* wr, const float* bias,
                        void* y, int B, int C, int Cp, int Tin, int O, int K,
                        int dil, cudaStream_t s) {
  if (O > 32 && (O <= 64 || O % 128 == 64))   // 48, 192
    return launch_tc<64, 128, 32, 32, 64>(x, wr, bias, y, B, C, Cp, Tin, O, K, dil, s);
  if (O > 32)   // 96, 384 .. 3072
    return launch_tc<128, 128, 64, 32, 32>(x, wr, bias, y, B, C, Cp, Tin, O, K, dil, s);
  // 1..32: the shortest chain of work per block
  return launch_tc<16, 256, 16, 32, 32>(x, wr, bias, y, B, C, Cp, Tin, O, K, dil, s);
}

}  // namespace
}  // namespace ditto

// fp32: x [B, C, Tin], w [O, C, K], bias [O] fp32 or null,
// y [B, O, Tin-(K-1)*dil]
extern "C" int ditto_conv1d_f32(const void* x, const void* w,
                                const float* bias, void* y, int B, int C,
                                int Tin, int O, int K, int dil, void* stream) {
  return static_cast<int>(ditto::dispatch_f32(
      x, w, bias, y, B, C, Tin, O, K, dil, static_cast<cudaStream_t>(stream)));
}

// bf16: as ditto_conv1d_f32, plus wr, scratch for the reordered weights
// [K, O, (C+7)/8*8]
extern "C" int ditto_conv1d_bf16(const void* x, const void* w, void* wr,
                                 const float* bias, void* y, int B, int C,
                                 int Tin, int O, int K, int dil, void* stream) {
  using namespace ditto;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = reorder_weights(w, wr, O, C, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(dispatch_tc(x, wr, bias, y, B, C, (C + 7) / 8 * 8,
                                      Tin, O, K, dil, s));
}

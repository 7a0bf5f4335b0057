// Kernel E: the DiT block's elementwise glue, one pass over each GEMM or
// attention output before the next GEMM or attention reads it.
//
// Replaces no Pallas kernel: the JAX package leaves this glue to XLA, which
// fuses it into its neighbours. Eager PyTorch runs it as ~60 launches a
// block (models/dit.py:dit_block on nn/core.py's primitives: the fp32
// layer_norm's ten ops, a bias add after every dense, apply_rope's neg,
// cat, two products and a sum, the residual adds, the MLP's biases, GELU,
// sigmoid and product), each a round trip of a [B*S, width] tensor through
// device memory, ~1.9 GB a ditto-base block at B=8 x 750 frames.
//
// Three modes, each one launch, each keeping every rounding point of the
// eager ops it replaces (T is the compute dtype, fp32 or bf16; rnd(v) rounds
// to T; arithmetic in fp32 by __f*_rn, so that no multiply and add fuse
// where the eager ops round in between):
//   add_norm   x = rnd(rnd(y + bias) + res) (no bias: rnd(y + res); no y:
//              x = res), written where asked; xn = layer_norm(x) with
//              nn/core.py's math: fp32 mean, biased variance of the
//              deviations, (x - mean) * rsqrt(var + eps), then * gamma +
//              beta, each rounded in fp32, and xn rounded to T. Statistics
//              are reduced in registers and by warp shuffles in a fixed
//              order: the same inputs give the same bits on every call.
//   qkv_rope   in [rows, parts * H] (the packed in_proj output, or the
//              cross-attention's q) plus bias; parts below rope_parts take
//              the half-split rotary embedding of ops/rope.py:apply_rope,
//              out = rnd(rnd(x * cos) + rnd(rotate_half(x) * sin)) from the
//              row's position's tables; out is [parts, rows, H], each part
//              a dense [B, S, H] that kernel A reads as [B, nh, S, hd].
//   gelu_gate  out = rnd(rnd(gelu(rnd(a + ba))) * rnd(sigmoid(rnd(g + bg))))
//              with PyTorch's CUDA formulas in fp32: exact erf GELU
//              x * 0.5 * (1 + erf(x / sqrt 2)) and 1 / (1 + exp(-x)).
//
// What bounds it on an H100: bytes. A few operations per element against
// 2 * sizeof(T) bytes or more, so the least time is the bytes over 3.35
// TB/s. Design: 16-byte loads and stores, neighbouring threads on
// neighbouring vectors; no shared memory. add_norm gives each row to one
// warp, which holds it in registers (NV 16-byte vectors a lane), so y, res
// and x are each read once and x and xn written once; qkv_rope gives each
// thread a vector of the first half of a head and the matching vector of
// the second half, the pair RoPE mixes; gelu_gate is flat over vectors.
// Biases, norm weights and RoPE tables are small and stay in L2.

#include <initializer_list>

#include "common.cuh"

namespace ditto {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 16 bytes of T at p (16-byte aligned) as fp32, and back (rounded to T)
template <typename T>
__device__ __forceinline__ void load16(float (&f)[16 / sizeof(T)], const T* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = __uint_as_float(i & 1 ? w[i / 2] & 0xffff0000u : w[i / 2] << 16);
  }
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&f)[16 / sizeof(T)]) {
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = __float_as_uint(f[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])))
              << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float s) {
  // butterfly: partners add the same two values, so every lane ends with
  // the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
  return s;
}

// One warp a row of W elements; lane l holds vectors l, l + 32, ... (NV of
// them at most). ADD: x = rnd(rnd(y + bias) + res), stored to x_out where
// it is given; else x = res. NORM: xn = layer_norm(x) to xn_out.
template <typename T, int NV, bool ADD, bool NORM>
__global__ void __launch_bounds__(kThreads)
add_norm_kernel(const T* __restrict__ y, const T* __restrict__ bias,
                const T* __restrict__ res, const T* __restrict__ gamma,
                const T* __restrict__ beta, T* __restrict__ x_out,
                T* __restrict__ xn_out, int rows, int W, long long ys,
                long long rs, float eps) {
  constexpr int E = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;   // the whole warp: the shuffles stay full
  float v[NV][E];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = (i * 32 + lane) * E;
    if (c >= W) continue;
    load16<T>(v[i], res + row * rs + c);
    if constexpr (ADD) {
      float a[E];
      load16<T>(a, y + row * ys + c);
      if (bias != nullptr) {
        float b[E];
        load16<T>(b, bias + c);
#pragma unroll
        for (int e = 0; e < E; ++e) a[e] = round_to<T>(__fadd_rn(a[e], b[e]));
      }
#pragma unroll
      for (int e = 0; e < E; ++e) v[i][e] = round_to<T>(__fadd_rn(a[e], v[i][e]));
      if (x_out != nullptr) store16<T>(x_out + static_cast<long long>(row) * W + c, v[i]);
    }
  }
  if constexpr (NORM) {
    const float inv_w = 1.0f / static_cast<float>(W);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i * 32 + lane) * E >= W) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) s = __fadd_rn(s, v[i][e]);
    }
    const float mean = __fmul_rn(warp_sum(s), inv_w);
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if ((i * 32 + lane) * E >= W) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[i][e] = __fsub_rn(v[i][e], mean);
        q = __fadd_rn(q, __fmul_rn(v[i][e], v[i][e]));
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(q), inv_w), eps));
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = (i * 32 + lane) * E;
      if (c >= W) continue;
      float o[E], g[E], b[E];
      load16<T>(g, gamma + c);
      load16<T>(b, beta + c);
#pragma unroll
      for (int e = 0; e < E; ++e)
        o[e] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][e], rstd), g[e]), b[e]);
      store16<T>(xn_out + static_cast<long long>(row) * W + c, o);
    }
  }
}

// One thread a pair of vectors: E elements at d0 in the first half of a head
// and the E at d0 + hd/2 (the elements RoPE pairs), of one part of one row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
qkv_rope_kernel(const T* __restrict__ in, const T* __restrict__ bias,
                const T* __restrict__ cos_t, const T* __restrict__ sin_t,
                T* __restrict__ out, int items, int rows, int S, int parts,
                int H, int hd, int rope_parts, long long in_rs) {
  constexpr int E = 16 / sizeof(T);
  const int it = blockIdx.x * kThreads + threadIdx.x;
  if (it >= items) return;
  const int half = hd / 2;
  const int ph = half / E;            // vector pairs a head
  const int per_part = H / (2 * E);   // vector pairs a part of a row
  const int p = it % per_part;
  const int rp = it / per_part;
  const int part = rp % parts;
  const int row = rp / parts;
  const int j = p % ph;
  const int d0 = (p / ph) * hd + j * E;
  const T* src = in + row * in_rs + part * H;
  float x0[E], x1[E];
  load16<T>(x0, src + d0);
  load16<T>(x1, src + d0 + half);
  if (bias != nullptr) {
    float b0[E], b1[E];
    load16<T>(b0, bias + part * H + d0);
    load16<T>(b1, bias + part * H + d0 + half);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      x0[e] = round_to<T>(__fadd_rn(x0[e], b0[e]));
      x1[e] = round_to<T>(__fadd_rn(x1[e], b1[e]));
    }
  }
  if (part < rope_parts) {
    const long long t = static_cast<long long>(row % S) * hd + j * E;
    float c0[E], c1[E], s0[E], s1[E];
    load16<T>(c0, cos_t + t);
    load16<T>(c1, cos_t + t + half);
    load16<T>(s0, sin_t + t);
    load16<T>(s1, sin_t + t + half);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      // rotate_half: [-x1, x0]
      const float r0 = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x0[e], c0[e])),
                                             round_to<T>(__fmul_rn(-x1[e], s0[e]))));
      const float r1 = round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(x1[e], c1[e])),
                                             round_to<T>(__fmul_rn(x0[e], s1[e]))));
      x0[e] = r0;
      x1[e] = r1;
    }
  }
  T* dst = out + (static_cast<long long>(part) * rows + row) * H;
  store16<T>(dst + d0, x0);
  store16<T>(dst + d0 + half, x1);
}

// PyTorch's CUDA GELU (approximate="none") and sigmoid in fp32 opmath
__device__ __forceinline__ float gelu_f(float x) {
  constexpr float kAlpha = static_cast<float>(0.70710678118654752440);  // M_SQRT1_2
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(x, kAlpha))));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gelu_gate_kernel(const T* __restrict__ a, const T* __restrict__ ba,
                 const T* __restrict__ g, const T* __restrict__ bg,
                 T* __restrict__ out, int items, int N, long long as,
                 long long gs) {
  constexpr int E = 16 / sizeof(T);
  const int it = blockIdx.x * kThreads + threadIdx.x;
  if (it >= items) return;
  const int nv = N / E;
  const int row = it / nv;
  const int c = (it % nv) * E;
  float u[E], z[E], bu[E], bz[E];
  load16<T>(u, a + row * as + c);
  load16<T>(z, g + row * gs + c);
  load16<T>(bu, ba + c);
  load16<T>(bz, bg + c);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float up = round_to<T>(gelu_f(round_to<T>(__fadd_rn(u[e], bu[e]))));
    const float gate = round_to<T>(sigmoid_f(round_to<T>(__fadd_rn(z[e], bz[e]))));
    u[e] = __fmul_rn(up, gate);
  }
  store16<T>(out + static_cast<long long>(row) * N + c, u);
}

// 16-byte vectors a lane holds in add_norm: NV is built for 1, 3 and 6
// only, the rows the port runs (3: ditto-base's 768 in bf16; 6: ditto-ref's
// 768 in fp32; 1: the tests' narrow rows); a row between them takes the next
// larger NV, its extra lanes idle
constexpr int kMaxVecs = 6;

template <typename T, bool ADD, bool NORM, int NV>
cudaError_t launch_add_norm_nv(const void* y, const void* bias, const void* res,
                               const void* gamma, const void* beta, void* x_out,
                               void* xn_out, int rows, int W, long long ys,
                               long long rs, float eps, cudaStream_t s) {
  const int grid = (rows + kWarps - 1) / kWarps;
  add_norm_kernel<T, NV, ADD, NORM><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(x_out),
      static_cast<T*>(xn_out), rows, W, ys, rs, eps);
  return cudaGetLastError();
}

template <typename T, bool ADD, bool NORM>
cudaError_t launch_add_norm(const void* y, const void* bias, const void* res,
                            const void* gamma, const void* beta, void* x_out,
                            void* xn_out, int rows, int W, long long ys,
                            long long rs, float eps, cudaStream_t s) {
  constexpr int E = 16 / sizeof(T);
  const int nv = (W / E + 31) / 32;
#define DITTO_NV(n)                                                           \
  if (nv <= n)                                                                \
    return launch_add_norm_nv<T, ADD, NORM, n>(y, bias, res, gamma, beta,     \
                                               x_out, xn_out, rows, W, ys, rs, \
                                               eps, s);
  DITTO_NV(1) DITTO_NV(3) DITTO_NV(kMaxVecs)
#undef DITTO_NV
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t add_norm_dtype(const void* y, const void* bias, const void* res,
                           const void* gamma, const void* beta, void* x_out,
                           void* xn_out, int rows, int W, long long ys,
                           long long rs, float eps, cudaStream_t s) {
  if (y != nullptr && xn_out != nullptr)
    return launch_add_norm<T, true, true>(y, bias, res, gamma, beta, x_out,
                                          xn_out, rows, W, ys, rs, eps, s);
  if (y != nullptr)
    return launch_add_norm<T, true, false>(y, bias, res, gamma, beta, x_out,
                                           xn_out, rows, W, ys, rs, eps, s);
  if (xn_out != nullptr)
    return launch_add_norm<T, false, true>(y, bias, res, gamma, beta, x_out,
                                           xn_out, rows, W, ys, rs, eps, s);
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
}  // namespace ditto

// add_norm: res [rows, W] (row stride rs), y [rows, W] (row stride ys) or
// null (norm only), bias [W] or null, gamma / beta [W] (read with xn_out),
// x_out / xn_out dense [rows, W], either null to skip it (x_out is written
// only with y). Every pointer 16-byte aligned, W and the strides multiples
// of 16 / sizeof(T), W at most 6 * 32 * 16 / sizeof(T).
extern "C" int ditto_add_norm(const void* y, const void* bias, const void* res,
                              const void* gamma, const void* beta, void* x_out,
                              void* xn_out, int rows, int W, long long ys,
                              long long rs, float eps, int dtype, void* stream) {
  using namespace ditto;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = dtype == kFloat32 ? 4 : 8;
  if (rows < 1 || W < E || W % E || ys % E || rs % E ||
      W > kMaxVecs * 32 * E ||
      (xn_out != nullptr && (gamma == nullptr || beta == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {y, bias, res, gamma, beta,
                        static_cast<const void*>(x_out),
                        static_cast<const void*>(xn_out)})
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == kFloat32)
    return add_norm_dtype<float>(y, bias, res, gamma, beta, x_out, xn_out, rows,
                                 W, ys, rs, eps, s);
  if (dtype == kBFloat16)
    return add_norm_dtype<__nv_bfloat16>(y, bias, res, gamma, beta, x_out,
                                         xn_out, rows, W, ys, rs, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// qkv_rope: in [rows, parts * H] (row stride in_rs), bias [parts * H] or
// null; cos / sin [S, hd] dense (rows run over [B, S], position row % S),
// read for parts < rope_parts only; out dense [parts, rows, H]. H a
// multiple of hd, hd of 2 * 16 / sizeof(T); pointers 16-byte aligned.
extern "C" int ditto_qkv_rope(const void* in, const void* bias, const void* cos_t,
                              const void* sin_t, void* out, int rows, int S,
                              int parts, int H, int hd, int rope_parts,
                              long long in_rs, int dtype, void* stream) {
  using namespace ditto;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = dtype == kFloat32 ? 4 : 8;
  if (rows < 1 || S < 1 || parts < 1 || hd < 2 * E || hd % (2 * E) ||
      H % hd || in_rs % E || rope_parts < 0 || rope_parts > parts ||
      (rope_parts > 0 && (cos_t == nullptr || sin_t == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {in, bias, cos_t, sin_t, static_cast<const void*>(out)})
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long items = static_cast<long long>(rows) * parts * (H / (2 * E));
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(items);
  const int grid = (n + kThreads - 1) / kThreads;
  if (dtype == kFloat32)
    qkv_rope_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(in), static_cast<const float*>(bias),
        static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
        static_cast<float*>(out), n, rows, S, parts, H, hd, rope_parts, in_rs);
  else if (dtype == kBFloat16)
    qkv_rope_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(in),
        static_cast<const __nv_bfloat16*>(bias),
        static_cast<const __nv_bfloat16*>(cos_t),
        static_cast<const __nv_bfloat16*>(sin_t),
        static_cast<__nv_bfloat16*>(out), n, rows, S, parts, H, hd, rope_parts,
        in_rs);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// gelu_gate: a, g [rows, N] (row strides as, gs), ba, bg [N]; out dense
// [rows, N]. N and the strides multiples of 16 / sizeof(T); pointers
// 16-byte aligned.
extern "C" int ditto_gelu_gate(const void* a, const void* ba, const void* g,
                               const void* bg, void* out, int rows, int N,
                               long long as, long long gs, int dtype,
                               void* stream) {
  using namespace ditto;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int E = dtype == kFloat32 ? 4 : 8;
  if (rows < 1 || N < E || N % E || as % E || gs % E)
    return static_cast<int>(cudaErrorInvalidValue);
  for (const void* p : {a, ba, g, bg, static_cast<const void*>(out)})
    if (p == nullptr || !aligned16(p))
      return static_cast<int>(cudaErrorMisalignedAddress);
  const long long items = static_cast<long long>(rows) * (N / E);
  if (items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int n = static_cast<int>(items);
  const int grid = (n + kThreads - 1) / kThreads;
  if (dtype == kFloat32)
    gelu_gate_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(ba),
        static_cast<const float*>(g), static_cast<const float*>(bg),
        static_cast<float*>(out), n, N, as, gs);
  else if (dtype == kBFloat16)
    gelu_gate_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(ba),
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const __nv_bfloat16*>(bg),
        static_cast<__nv_bfloat16*>(out), n, N, as, gs);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Kernel A: softmax(Q K^T * scale) V with fp32 scores, softmax and sums.
//
// Replaces the Pallas TPU kernels ditto_tts_tpu/ops/attention.py
// pallas_attention (_attn_kernel) and pallas_attention_packed
// (_attn_kernel_packed): the same function, with a kv-length mask and an
// optional causal mask, over [B, H, S, D] tensors (D in {64, 128}, fp32 or
// bf16). Every DiT attention call of the serving path comes here, self and
// cross, at every length. Inputs and the output take any strides over
// (b, h, s) with a unit stride over d, so the DiT passes its RoPE'd
// [B, S, H, D] projections and receives the merged-head layout without a
// copy. Keys >= kv_len, and keys after the query when causal, are masked;
// K/V tiles wholly past the causal limit of a query tile are skipped.
//
// What bounds it on an H100: at the DiT's self-attention (B=4, H=12,
// S=750..1024, D=64, bf16) the work is 4*B*H*S^2*D = 6.9e9..1.6e10 FLOP
// against 18..25 MB of Q/K/V/O: operations (7..16 us at the bf16
// tensor-core peak) rather than bytes (5.5..7.5 us at 3.35 TB/s). The
// cross-attention (Sk = 64) is bound by its Q and O bytes (~2.8 us).
//
// bf16 (attn_kernel_tc), FlashAttention-2 on mma.sync, as the Pallas kernel
// ran QK^T and PV on the MXU with fp32 sums: each warp owns 16 query rows
// (a block 4 warps; 8 measured slower); the Q tile is copied once and
// held in registers as mma A fragments (ldmatrix); 64-key K/V tiles arrive
// by cp.async in a double-buffered ring (tile j+1 in flight while tile j
// computes), stored in bf16 with a row pitch of D+8 elements so that
// ldmatrix is free of bank conflicts; rows past Sq or past the keys in use are zero-filled by the
// copy and never read from memory. S = QK^T takes its K fragments from
// ldmatrix; masks are applied in registers; the scale is folded into
// exp2f; each warp keeps its rows' running max and sum in registers,
// reduced over the 4 threads of a quad by shuffles, with no barrier in the
// softmax. P goes to bf16 in registers and is the A fragment of PV, whose
// V fragments come from ldmatrix.trans; the fp32 output is rescaled once a
// tile and divided by the row sum at the end. Rounding: P is rounded to
// bf16 unnormalised (relative to the running max), where the Pallas kernel
// and attention_plain round the normalised probabilities; both are one
// bf16 rounding of each weight (relative 2^-9), well inside the bf16
// tolerance. A cross-attention call (Sk = 64) is one K/V tile: one copy
// group, no loop overhead. Q/K/V must be 16-byte aligned with strides
// that are multiples of 8 elements (the wrapper checks). Measured on the
// card (PERF.md): 150-195 TFLOP/s at the self-attention shapes, where 4
// blocks per SM (127 registers a thread) leave the 576-768 blocks of the
// DiT's calls two rounds; SDPA's time at the cross-attention shapes.
//
// fp32 (attn_kernel) stays on the CUDA cores in exact fp32: it serves the
// fp32 chain parity with TF32 off, which TF32 (~1e-3) would break at its
// 2e-5 tolerance. Each block owns one (batch*head, 64-query tile) and walks
// K/V in 64-key tiles with an online softmax; Q/K/V tiles are staged in
// shared memory as fp32 with a padded row stride; each of the 128 threads
// keeps a 4-row x (D/8)-column slice of the output in registers, and sums
// each tile's PV apart before adding it to that slice.

#include "common.cuh"
#include "mma.cuh"

namespace ditto {
namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per K/V tile
constexpr int kThreads = 128;

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t attn_smem_floats() {
  return kBQ * (D + 1)      // Q tile
         + kBK * (D + 1)    // K tile
         + kBK * D          // V tile
         + kBQ * (kBK + 1)  // scores / probabilities
         + 3 * kBQ;         // row max, row sum, row rescale
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
            Strides vs, Strides os, int H, int Sq, int Sk, int kv_len,
            int causal, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                   // [kBQ][D+1]
  float* Ks = Qs + kBQ * (D + 1);     // [kBK][D+1]
  float* Vs = Ks + kBK * (D + 1);     // [kBK][D]
  float* Ss = Vs + kBK * D;           // [kBQ][kBK+1]
  float* row_m = Ss + kBQ * (kBK + 1);
  float* row_l = row_m + kBQ;
  float* row_a = row_l + kBQ;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + h * ks.h;
  const float* vb = v + b * vs.b + h * vs.h;
  float* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qr = q0 + r;
    Qs[r * (D + 1) + d] = qr < Sq ? qb[qr * qs.s + d] : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  // thread tile: rows ty*4 .. ty*4+3; score columns / output dims tx + 8*j
  const int ty = tid >> 3, tx = tid & 7;
  constexpr int DJ = D / 8;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int kv_end = min(Sk, kv_len);
  if (causal) kv_end = min(kv_end, q0 + kBQ);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V/P are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int kr = k0 + r;
      const bool in = kr < Sk;
      Ks[r * (D + 1) + d] = in ? kb[kr * ks.s + d] : 0.f;
      Vs[r * D + d] = in ? vb[kr * vs.s + d] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qr = q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        const int kc = k0 + c;
        const bool ok = kc < kv_len && kc < Sk && (!causal || kc <= qr);
        Ss[r * (kBK + 1) + c] = ok ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    if (tid < kBQ) {  // online softmax, one row per thread
      float* sr = Ss + tid * (kBK + 1);
      const float m_old = row_m[tid];
      float mx = m_old;
      for (int c = 0; c < kBK; ++c) mx = fmaxf(mx, sr[c]);
      float sum = 0.f;
      if (mx == -INFINITY) {  // no valid key yet for this row
        for (int c = 0; c < kBK; ++c) sr[c] = 0.f;
        row_a[tid] = 1.f;
      } else {
        for (int c = 0; c < kBK; ++c) {
          const float p = expf(sr[c] - mx);  // exp(-inf) = 0 for masked keys
          sr[c] = p;
          sum += p;
        }
        const float a = m_old == -INFINITY ? 0.f : expf(m_old - mx);
        row_a[tid] = a;
        row_l[tid] = row_l[tid] * a + sum;
        row_m[tid] = mx;
      }
    }
    __syncthreads();

    // the tile's PV in its own sum, then acc = acc * a + tile: summing all
    // Sk products into one running sum loses ~Sk * 2^-26 of a row whose
    // values are alike (2.6e-5 of max|out| over 1024 text keys), two
    // levels ~(64 + Sk / 64) * 2^-26
    float t[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) t[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ss[(ty * 4 + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) t[i][j] = fmaf(pv[i], vv[j], t[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(acc[i][j], a, t[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int qr = q0 + r;
    if (qr >= Sq) continue;
    const float inv_l = 1.f / row_l[r];
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[qr * os.s + tx + 8 * j] = acc[i][j] * inv_l;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int Sq, int Sk,
                   int kv_len, int causal, float scale, cudaStream_t stream) {
  const size_t smem = attn_smem_floats<D>() * sizeof(float);
  auto kernel = attn_kernel<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, H, Sq, Sk, kv_len, causal, scale);
  return cudaGetLastError();
}


// ---- bf16: flash attention on the tensor cores ----

constexpr int kTcBK = 64;    // keys per K/V tile
constexpr int kTcWarps = 4;  // 16 query rows each

// Q, two K and two V tiles of bf16 rows, pitch D + 8 elements
template <int D>
constexpr size_t attn_tc_smem_bytes() {
  return static_cast<size_t>(16 * kTcWarps + 4 * kTcBK) * (D + 8) *
         sizeof(__nv_bfloat16);
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
attn_kernel_tc(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, Strides qs, Strides ks,
               Strides vs, Strides os, int H, int Sq, int Sk, int kv_len,
               int causal, float scale) {
  constexpr int BQ = 16 * kTcWarps, BK = kTcBK, P = D + 8;   // row pitch
  constexpr int NTHR = kTcWarps * 32, CH = D / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][P]
  __nv_bfloat16* Ks = Qs + BQ * P;                                 // [2][BK][P]
  __nv_bfloat16* Vs = Ks + 2 * BK * P;                             // [2][BK][P]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + h * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + h * vs.h;
  __nv_bfloat16* ob = o + b * os.b + h * os.h;

  const int kv_lim = min(Sk, kv_len);            // keys that may be valid
  const int kv_end = causal ? min(kv_lim, q0 + BQ) : kv_lim;
  const int ntiles = (kv_end + BK - 1) / BK;     // >= 1: kv_len >= 1

  for (int i = tid; i < BQ * CH; i += NTHR) {
    const int r = i / CH, c = i % CH;
    const bool in = q0 + r < Sq;
    cp_async16(Qs + r * P + c * 8, in ? qb + (q0 + r) * qs.s + c * 8 : qb, in);
  }
  auto load_kv = [&](int tile, int buf) {
    const int k0 = tile * BK;
    for (int i = tid; i < BK * CH; i += NTHR) {
      const int r = i / CH, c = i % CH;
      const bool in = k0 + r < kv_end;           // zero past the keys in use
      const int off = (buf * BK + r) * P + c * 8;
      cp_async16(Ks + off, in ? kb + (k0 + r) * ks.s + c * 8 : kb, in);
      cp_async16(Vs + off, in ? vb + (k0 + r) * vs.s + c * 8 : vb, in);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  const float sl2 = scale * 1.4426950408889634f;   // scores in log2 units
  const int g = lane >> 2, qd = lane & 3;
  const int row0 = q0 + warp * 16 + g;             // rows row0, row0 + 8
  uint32_t qf[D / 16][4];
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) {
      load_kv(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile j (and, at j = 0, Q) is in shared memory
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * P + kk * 16 +
                            (lane >> 4) * 8);
    }
    const __nv_bfloat16* Kt = Ks + (j & 1) * BK * P;
    const __nv_bfloat16* Vt = Vs + (j & 1) * BK * P;

    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];   // b0, b1 of key tiles 2np and 2np + 1
        ldsm_x4(kf, Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                        kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    const int k0 = j * BK;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kc = k0 + n * 8 + 2 * qd + (e & 1);
        const bool ok = kc < kv_lim && (!causal || kc <= row0 + (e >> 1) * 8);
        s[n][e] = ok ? s[n][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], base[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];   // a row with no key yet
      alpha[i] = exp2f(m_run[i] - base[i]);         // 0 while m_run = -inf
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);   // masked: exp2(-inf) = 0
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_run[i] = l_run[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];   // b0, b1 of d tiles 2dp and 2dp + 1
        ldsm_x4_trans(vf, Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   P + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // every warp is done with buffer j & 1
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + i * 8;
    if (r >= Sq) continue;
    const float inv_l = 1.f / l_run[i];
    __nv_bfloat16* orow = ob + r * os.s + 2 * qd;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<uint32_t*>(orow + d * 8) =
          pack_bf16(acc[d][2 * i] * inv_l, acc[d][2 * i + 1] * inv_l);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      const long long* st, int B, int H, int Sq, int Sk,
                      int kv_len, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = attn_tc_smem_bytes<D>();
  auto kernel = attn_kernel_tc<D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = 16 * kTcWarps;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kernel<<<grid, kTcWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H, Sq,
      Sk, kv_len, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ditto

// strides: 12 element strides (b, h, s) of q, k, v, o in that order
extern "C" int ditto_attention(const void* q, const void* k, const void* v,
                               void* o, const long long* strides, int B, int H,
                               int Sq, int Sk, int D, int kv_len, int causal,
                               float scale, int dtype, void* stream) {
  using namespace ditto;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32 && D == 64)
    return launch<64>(q, k, v, o, strides, B, H, Sq, Sk, kv_len, causal, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch<128>(q, k, v, o, strides, B, H, Sq, Sk, kv_len, causal, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch_tc<64>(q, k, v, o, strides, B, H, Sq, Sk, kv_len, causal, scale, s);
  if (dtype == kBFloat16 && D == 128)
    return launch_tc<128>(q, k, v, o, strides, B, H, Sq, Sk, kv_len, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

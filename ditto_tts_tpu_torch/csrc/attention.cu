// Kernel A: softmax(Q K^T * scale) V with fp32 scores, softmax and sums.
//
// Replaces the Pallas TPU kernels ditto_tts_tpu/ops/attention.py
// pallas_attention (_attn_kernel) and pallas_attention_packed
// (_attn_kernel_packed): the same function, with a kv-length mask and an
// optional causal mask, over [B, H, S, D] tensors (D in {64, 128}, fp32 or
// bf16). Every DiT attention call of the serving path comes here, self and
// cross, at every length.
//
// What bounds it on an H100: at the DiT's self-attention (B=4, H=12,
// S=750..1024, D=64, bf16) the work is 4*B*H*S^2*D = 8.6e9..1.6e10 FLOP
// against 18..25 MB of Q/K/V/O, i.e. operations (13 us at the bf16
// tensor-core peak) rather than bytes (7.5 us at 3.35 TB/s). This first
// version runs the products on the CUDA cores in fp32 (no tensor cores, no
// TMA, no pipelining), so its own ceiling is the fp32 FMA rate.
//
// Design: the TPU kernel keeps one head's whole K/V in VMEM. Here one head's
// K/V at Sk=1024, D=64 in fp32 is 512 KB, more than a block's 227 KB of
// shared memory, so each block owns one (batch*head, 64-query tile) and
// walks K/V in 64-key tiles with an online softmax (running max m and sum l
// per row; the output accumulator is rescaled by exp(m_old - m_new) when
// the max grows). Q/K/V tiles are staged in shared memory as fp32 with a
// padded row stride so that neither the QK^T nor the PV loop has bank
// conflicts; each of the 128 threads keeps a 4-row x (D/8)-column slice of
// the output in registers. Keys >= kv_len, and keys after the query when
// causal, get -inf scores; K/V tiles wholly past the causal limit of the
// query tile are skipped. Inputs and the output take any strides over
// (b, h, s) with a unit stride over d, so the DiT passes its RoPE'd
// [B, S, H, D] projections and receives the merged-head layout without a
// copy.

#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
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
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qr = q0 + r;
    Qs[r * (D + 1) + d] = qr < Sq ? to_f<T>(qb[qr * qs.s + d]) : 0.f;
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
      Ks[r * (D + 1) + d] = in ? to_f<T>(kb[kr * ks.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_f<T>(vb[kr * vs.s + d]) : 0.f;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_a[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
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
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
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
      ob[qr * os.s + tx + 8 * j] = from_f<T>(acc[i][j] * inv_l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   const long long* st, int B, int H, int Sq, int Sk,
                   int kv_len, int causal, float scale, cudaStream_t stream) {
  const size_t smem = attn_smem_floats<D>() * sizeof(float);
  auto kernel = attn_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, H, Sq, Sk, kv_len, causal, scale);
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
    return launch<float, 64>(q, k, v, o, strides, B, H, Sq, Sk, kv_len, causal, scale, s);
  if (dtype == kFloat32 && D == 128)
    return launch<float, 128>(q, k, v, o, strides, B, H, Sq, Sk, kv_len, causal, scale, s);
  if (dtype == kBFloat16 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, strides, B, H, Sq, Sk, kv_len, causal, scale, s);
  if (dtype == kBFloat16 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, strides, B, H, Sq, Sk, kv_len, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

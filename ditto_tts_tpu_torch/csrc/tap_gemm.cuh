// The tap contraction of a VALID dilated conv on the tensor cores, shared
// by the bf16 kernels that run it (kernel B, conv1d.cu; kernel C,
// act_conv.cu), and the reorder of their weights into per-tap tiles.
//
//   y[o, t] += sum_{c in chunk} w_m[o, c] * x[c, t + m*dil]   (one tap m)
//
// is a GEMM with M = output channels, N = time and the chunk's channels as
// the contraction. The block stages x once per channel chunk as a
// time-major, channel-contiguous slab [rows][pitch] (rows = time tile +
// (K-1)*dil of halo) and each tap's weights as a [rows][pitch] tile with
// the output channel as the row. For tap m, the mma B operand is the slab
// shifted down by m*dil rows: ldmatrix takes any 16-byte-aligned row
// address, so one staged slab feeds every tap and every output channel.
// A pitch of KC + 8 bf16 elements (an odd multiple of 16 bytes) keeps the
// 8 rows of each ldmatrix on 8 different bank groups for every shift.
#pragma once

#include <cuda_runtime.h>

#include "mma.cuh"

namespace ditto {

// acc[mt][nt] (a warp's MT x NT tiles of 16 x 8 fp32 sums) += the chunk's
// contribution of one tap. w: the warp's first weight row of the tap tile;
// x: the warp's first slab row, already shifted by m*dil, at the chunk's
// first channel; pitches PW and px in elements; KC channels in the chunk.
template <int MT, int NT, int KC, int PW>
__device__ __forceinline__ void tap_mma(float (&acc)[MT][NT][4],
                                        const __nv_bfloat16* w,
                                        const __nv_bfloat16* x, int px,
                                        int lane) {
  static_assert(NT % 2 == 0 && KC % 16 == 0, "n tiles in pairs, k in 16s");
#pragma unroll
  for (int ks = 0; ks < KC / 16; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(af[mt], w + (mt * 16 + (lane & 15)) * PW + ks * 16 +
                          (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t bf[4];   // b0, b1 of time tiles 2np and 2np + 1
      ldsm_x4(bf, x + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * px +
                      ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], af[mt], bf[0], bf[1]);
        mma_bf16(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// wr[m][o][c] = w[o][c][m] for c < C, 0 for C <= c < Cp: each tap's
// [O][Cp] weights contiguous, so a tap tile is a 16-byte cp.async copy
__global__ void tap_weight_reorder(const __nv_bfloat16* __restrict__ w,
                                   __nv_bfloat16* __restrict__ wr, int O,
                                   int C, int Cp, int K) {
  const int n = K * O * Cp;   // < 2^31 for every conv the wrappers take
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int c = i % Cp, r = i / Cp, o = r % O, m = r / O;
    wr[i] = c < C ? w[(o * C + c) * K + m] : __float2bfloat16(0.f);
  }
}

// reorder w [O, C, K] into wr [K, O, Cp] (Cp = C rounded up to 8) on s
inline cudaError_t reorder_weights(const void* w, void* wr, int O, int C,
                                   int K, cudaStream_t s) {
  const int Cp = (C + 7) / 8 * 8;
  const int n = K * O * Cp;
  const int blocks = n / 256 + 1 < 4096 ? n / 256 + 1 : 4096;
  tap_weight_reorder<<<blocks, 256, 0, s>>>(
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(wr),
      O, C, Cp, K);
  return cudaGetLastError();
}

}  // namespace ditto

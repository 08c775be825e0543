// Length-masked LSTM recurrence: the final hidden state of one direction.
//
// Replaces the TPU kernel text2pos_tpu/ops/lstm_pallas.py:60
// (lstm_final_hidden_pallas, body _lstm_kernel :29). The input projections
// x·W_ih + b for all steps are one matmul outside (ops/lstm.py); this kernel
// runs the T-step recurrence gates = xp[t] + h·W_hh with h and c on chip.
//
// Design. One CTA per tile of BT=16 sequences, one thread per hidden unit j
// (blockDim = H <= 256, so up to 255 registers a thread for the 64 gate
// accumulators and 16 cell states). Thread j computes the four gate columns j, H+j, 2H+j, 3H+j
// for all 16 sequences, so the cell update needs no exchange between
// threads: c stays in registers, h is double-buffered in shared memory
// (every thread reads all of h for the next step; one barrier per step).
// W_hh streams from L2 each step (1 MB f32 for the coarse encoder, more than
// shared memory holds); its loads are coalesced across j. Accumulation is
// f32, as in JAX, whose LanguageEncoder has no compute dtype.
//
// Bound. 2·T·B·H·4H FLOPs of f32 FMA per direction (68.7 GFLOP for the
// coarse encoder at T=64, B=2048, H=256): operations, not bytes, bound it.
// Steps past the longest sequence of a tile are skipped (they leave every
// state unchanged), so the work done follows the data's lengths.
//
// Masking. Step t updates sequence b only if t < len[b]. With reverse=1
// the kernel visits t = T-1 … 0, which equals the reference's scan over
// the reversed padded sequence with reversed validity.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BT = 16;  // sequences per CTA

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__global__ void __launch_bounds__(256)
lstm_final_hidden_kernel(const float* __restrict__ xp,       // [T, B, 4H]
                         const float* __restrict__ whh,      // [H, 4H]
                         const int* __restrict__ lengths,    // [B]
                         float* __restrict__ h_out,          // [B, H]
                         int T, int B, int H, int reverse) {
  extern __shared__ float hbuf[];  // [2][BT][H]
  __shared__ int len_s[BT];
  __shared__ int maxlen_s;

  const int j = threadIdx.x;
  const int b0 = blockIdx.x * BT;
  const int H4 = 4 * H;

  if (j < BT) {
    const int b = b0 + j;
    len_s[j] = b < B ? min(lengths[b], T) : 0;
  }
  for (int i = j; i < BT * H; i += blockDim.x) hbuf[i] = 0.0f;
  __syncthreads();
  if (j == 0) {
    int m = 0;
    for (int i = 0; i < BT; ++i) m = max(m, len_s[i]);
    maxlen_s = m;
  }
  __syncthreads();
  const int maxlen = maxlen_s;

  float c[BT];
#pragma unroll
  for (int i = 0; i < BT; ++i) c[i] = 0.0f;

  // Forward: t = 0 … maxlen-1. Reverse: t = T-1 … 0, of which the steps
  // with t >= maxlen are invalid for every sequence of the tile.
  const int steps = maxlen;
  int cur = 0;
  for (int s = 0; s < steps; ++s) {
    const int t = reverse ? maxlen - 1 - s : s;
    const float* hs = hbuf + cur * BT * H;
    float* hn = hbuf + (cur ^ 1) * BT * H;

    float acc[4][BT];
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const int b = b0 + i;
      const float* x = xp + ((size_t)t * B + (b < B ? b : 0)) * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][i] = b < B ? x[g * H] : 0.0f;
    }

    for (int k = 0; k < H; k += 4) {
      float w[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = whh + (size_t)(k + kk) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) w[kk][g] = __ldg(wr + g * H);
      }
#pragma unroll
      for (int i = 0; i < BT; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + i * H + k);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float a = acc[g][i];
          a = fmaf(hv.x, w[0][g], a);
          a = fmaf(hv.y, w[1][g], a);
          a = fmaf(hv.z, w[2][g], a);
          a = fmaf(hv.w, w[3][g], a);
          acc[g][i] = a;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < BT; ++i) {
      const float ig = sigmoid_f(acc[0][i]);
      const float fg = sigmoid_f(acc[1][i]);
      const float gg = tanhf(acc[2][i]);
      const float og = sigmoid_f(acc[3][i]);
      const float cn = fg * c[i] + ig * gg;
      const float hnew = og * tanhf(cn);
      const bool v = t < len_s[i];
      c[i] = v ? cn : c[i];
      hn[i * H + j] = v ? hnew : hs[i * H + j];
    }
    __syncthreads();
    cur ^= 1;
  }

  const float* hs = hbuf + cur * BT * H;
#pragma unroll
  for (int i = 0; i < BT; ++i) {
    const int b = b0 + i;
    if (b < B) h_out[(size_t)b * H + j] = hs[i * H + j];
  }
}

}  // namespace

// Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int t2p_lstm_final_hidden(const void* xp, const void* whh,
                                     const void* lengths, void* h_out,
                                     int T, int B, int H, int reverse,
                                     void* stream) {
  if (H < 32 || H > 256 || H % 32 != 0 || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)BT * H * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_final_hidden_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + BT - 1) / BT;
  lstm_final_hidden_kernel<<<grid, H, smem, (cudaStream_t)stream>>>(
      (const float*)xp, (const float*)whh, (const int*)lengths, (float*)h_out,
      T, B, H, reverse);
  return (int)cudaGetLastError();
}

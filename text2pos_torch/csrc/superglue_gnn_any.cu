// SuperGlue attention GNN in eval mode at any configured width and set
// sizes: the second hand-written form of text2pos_torch/csrc/superglue_gnn.cu,
// which is tuned for (E, T0, T1) = (128, 16, 6) alone. This one takes E a
// multiple of 4 up to 512 (4 heads of E/4 channels, 75 at JAX's default
// E = 300) and 1 <= T1 <= T0 <= 32 (pad_size and num_mentioned), with f32 or
// bf16 weights: all 2·num_layers self/cross blocks, the final projection and
// the [N, T0, T1] score matrix, one launch.
//
// Replaces the TPU kernel text2pos_tpu/ops/superglue_gnn_pallas.py:253
// (gnn_scores_pallas, which takes any N and E with T1 <= T0), at the shapes
// the tuned kernel does not take. The arithmetic is superglue_gnn.cu's and
// gnn_scores_plain's (ops/superglue_gnn.py), rounding included:
//   qkv = rnd(a·[Wq|Wk|Wv] + b)          a = rnd(res)
//   msg = rnd(softmax_j(q·k_j / sqrt(E/4)) rounded · v_j), per head
//   m   = rnd(msg·Wm + bm)
//   h1  = rnd(relu(([a | m]·W0) * s0[set] + t0[set]))
//   res = res + rnd(h1·W1 + b1)
// then md = rnd(rnd(res)·Wf + bf) and scores = md0·md1^T / sqrt(E), where
// rnd rounds to bf16 in the bf16 form and is the identity in f32. Nothing is
// padded: the attention scale is 1/sqrt(E/4) and the score scale
// 1/sqrt(E) of the real widths.
//
// Design: simple first. One CTA a pair, 256 threads, f32 FMAs on the CUDA
// cores for both weight types (a bf16 product is exact in f32, so only the
// order of the sums differs from the tensor cores'). The pair's rows,
// objects then hints, padded to a multiple of 8, stay resident: the f32
// residual (aliasing [a | m]'s left half in the f32 form), [a | m] and
// q|k|v in the compute type, and the softmax's probabilities. Messages
// overwrite q; h1 and md overwrite q|k. A product out[R, N] = X[R, K]·W[K, N]
// gives a thread an 8-row × 4-column tile at a time (W read straight from
// global memory, row-major, 4 columns a load; X from the resident rows).
// Where the rows fit in shared memory (227 KB: every shape of 300 or less
// at T0 = 16, 256 at T0 = 32 in f32) they live there; where not (up to
// E = 512 with T0 = T1 = 32 in f32, 655 KB) the same code keeps them in a
// global workspace, a slice a CTA, and a persistent grid loops over pairs.
//
// Bound. About 20·E²·(T0 + T1) FLOPs a block a pair (the five products),
// 0.48 GFLOP a pair at E = 300 with 12 blocks, against (T0 + T1)·E·4 bytes
// in and T0·T1·4 out: operations bound it. On the CUDA cores at the f32
// rate, not the tensor cores' bf16 rate: the tuned kernel's fragment
// layouts, row tiles and attention tiles are fixed at E = 128 and a 16×16
// attention tile, and this form is the simple one that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HEADS = 4;
constexpr int NT = 256;
constexpr int MAX_E = 512;
constexpr int MAX_T = 32;
constexpr int RT = 8;   // rows of a thread's product tile
constexpr int CT = 4;   // columns of a thread's product tile

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Byte offsets of a pair's resident rows (R = T0 + T1 rounded up to 8).
struct Layout {
  int R;
  size_t res, a, q, prob, total;
};

__host__ __device__ inline Layout layout(int E, int T0, int T1, bool bf16) {
  Layout l;
  l.R = (T0 + T1 + RT - 1) / RT * RT;
  const size_t s = bf16 ? 2 : 4;
  l.res = 0;
  l.a = bf16 ? align16((size_t)l.R * E * 4) : 0;   // f32: res = a's left half
  l.q = l.a + align16((size_t)l.R * 2 * E * s);
  l.prob = l.q + align16((size_t)l.R * 3 * E * s);
  l.total = l.prob + align16((size_t)(T0 + T1) * HEADS * T0 * 4);
  return l;
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ static void ldg(const float* p, float (&v)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static float rnd(float x) { return x; }
  __device__ static float get(const float* p) { return *p; }
  __device__ static void put(float* p, float x) { *p = x; }
};
template <> struct Vec<__nv_bfloat16> {
  __device__ static void unpack(uint2 u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x << 16), v[1] = __uint_as_float(u.x & 0xffff0000u);
    v[2] = __uint_as_float(u.y << 16), v[3] = __uint_as_float(u.y & 0xffff0000u);
  }
  __device__ static void load(const __nv_bfloat16* p, float (&v)[4]) {
    unpack(*reinterpret_cast<const uint2*>(p), v);
  }
  __device__ static void ldg(const __nv_bfloat16* p, float (&v)[4]) {
    unpack(__ldg(reinterpret_cast<const uint2*>(p)), v);
  }
  __device__ static uint32_t pack2(float a, float b) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(b)) << 16);
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[4]) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  }
  __device__ static float rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
};

template <typename T>
struct Weights {
  const T* wqkv;      // [L, E, 3E] row-major
  const float* bqkv;  // [L, 3E]
  const T* wm;        // [L, E, E]
  const float* bm;    // [L, E]
  const T* w0;        // [L, 2E, 2E]
  const float* s0;    // [L, 2, 2E]
  const float* t0;    // [L, 2, 2E]
  const T* w1;        // [L, 2E, E]
  const float* b1;    // [L, E]
  const T* wf;        // [E, E]
  const float* bf;    // [E]
};

// out[R, N] = X[R, K] (resident, row stride ldx) · W[K, N] (global,
// row-major); epi(row, col, v[4]) takes columns col .. col + 3 of a row.
template <typename T, typename Epi>
__device__ __forceinline__ void matmul(const T* X, int ldx, int R, int K,
                                       int N, const T* __restrict__ W,
                                       Epi epi) {
  const int ncg = N / CT, units = (R / RT) * ncg;
  for (int u = threadIdx.x; u < units; u += NT) {
    const int c = (u % ncg) * CT, r0 = (u / ncg) * RT;
    float acc[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = 0.0f;
    const T* wp = W + c;
    const T* xp = X + (size_t)r0 * ldx;
    for (int k = 0; k < K; k += 4) {
      float w[4][CT];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Vec<T>::ldg(wp + (size_t)(k + kk) * N, w[kk]);
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        float x[4];
        Vec<T>::load(xp + (size_t)i * ldx + k, x);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(x[kk], w[kk][j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) epi(r0 + i, c, acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
gnn_any_kernel(const float* __restrict__ desc0,  // [N, T0, E]
               const float* __restrict__ desc1,  // [N, T1, E]
               Weights<T> wt, int num_blocks, int E, int T0, int T1,
               float* __restrict__ scores,       // [N, T0, T1]
               int n_pairs, unsigned char* workspace) {
  extern __shared__ uint4 smem_any[];
  constexpr bool BF16 = sizeof(T) == 2;
  const Layout lay = layout(E, T0, T1, BF16);
  unsigned char* base = workspace ? workspace + (size_t)blockIdx.x * lay.total
                                  : reinterpret_cast<unsigned char*>(smem_any);
  T* A = reinterpret_cast<T*>(base + lay.a);          // [R][2E]: a | m
  T* Q = reinterpret_cast<T*>(base + lay.q);          // [R][3E]: q | k | v
  float* prob = reinterpret_cast<float*>(base + lay.prob);  // [P][HEADS][T0]
  // The f32 residual: its own rows in bf16, a's left half in f32.
  float* res = reinterpret_cast<float*>(base + lay.res);
  const int ldres = BF16 ? E : 2 * E;
  const int R = lay.R, P = T0 + T1, D = E / HEADS;
  const int tid = threadIdx.x;
  const float att_scale = sqrtf((float)D), score_scale = sqrtf((float)E);

  for (int n = blockIdx.x; n < n_pairs; n += gridDim.x) {
    // Objects, then hints, then zero rows.
    for (int i = tid; i < R * (E / 4); i += NT) {
      const int r = i / (E / 4), c = (i % (E / 4)) * 4;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (r < T0)
        Vec<float>::ldg(desc0 + ((size_t)n * T0 + r) * E + c, v);
      else if (r < P)
        Vec<float>::ldg(desc1 + ((size_t)n * T1 + (r - T0)) * E + c, v);
      if (BF16) Vec<float>::store(res + (size_t)r * ldres + c, v);
      Vec<T>::store(A + (size_t)r * 2 * E + c, v);
    }
    __syncthreads();

    for (int l = 0; l < num_blocks; ++l) {
      const bool cross = (l & 1) == 1;
      // q|k|v of every row.
      {
        const float* b = wt.bqkv + (size_t)l * 3 * E;
        matmul<T>(A, 2 * E, R, E, 3 * E, wt.wqkv + (size_t)l * E * 3 * E,
                  [&](int r, int c, float (&v)[4]) {
          float bb[4], o[4];
          Vec<float>::ldg(b + c, bb);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = v[j] + bb[j];
          Vec<T>::store(Q + (size_t)r * 3 * E + c, o);
        });
      }
      __syncthreads();

      // Probabilities of each (row, head) over the source set's rows.
      for (int it = tid; it < P * HEADS; it += NT) {
        const int r = it / HEADS, h = it % HEADS;
        const bool own = r >= T0;
        const bool src = cross ? !own : own;
        const int kbase = src ? T0 : 0, nk = src ? T1 : T0;
        const T* q = Q + (size_t)r * 3 * E + h * D;
        float* pr = prob + (size_t)it * T0;
        float mx = -INFINITY;
        for (int j = 0; j < nk; ++j) {
          const T* kr = Q + (size_t)(kbase + j) * 3 * E + E + h * D;
          float dot = 0.0f;
          for (int d = 0; d < D; ++d)
            dot = fmaf(Vec<T>::get(q + d), Vec<T>::get(kr + d), dot);
          const float s = dot / att_scale;
          pr[j] = s;
          mx = fmaxf(mx, s);
        }
        float sum = 0.0f;
        for (int j = 0; j < nk; ++j) {
          const float e = expf(pr[j] - mx);
          pr[j] = e;
          sum += e;
        }
        for (int j = 0; j < nk; ++j) pr[j] = Vec<T>::rnd(pr[j] / sum);
      }
      __syncthreads();

      // Messages over q: msg[r, c] = Σ_j p[r, head(c), j] · v[j, c].
      for (int it = tid; it < P * E; it += NT) {
        const int r = it / E, c = it % E, h = c / D;
        const bool own = r >= T0;
        const bool src = cross ? !own : own;
        const int kbase = src ? T0 : 0, nk = src ? T1 : T0;
        const float* pr = prob + (size_t)(r * HEADS + h) * T0;
        const T* vc = Q + (size_t)kbase * 3 * E + 2 * E + c;
        float m = 0.0f;
        for (int j = 0; j < nk; ++j)
          m = fmaf(pr[j], Vec<T>::get(vc + (size_t)j * 3 * E), m);
        Vec<T>::put(Q + (size_t)r * 3 * E + c, m);
      }
      __syncthreads();

      // m = msg·Wm + bm into a's right half.
      {
        const float* b = wt.bm + (size_t)l * E;
        matmul<T>(Q, 3 * E, R, E, E, wt.wm + (size_t)l * E * E,
                  [&](int r, int c, float (&v)[4]) {
          float bb[4], o[4];
          Vec<float>::ldg(b + c, bb);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = v[j] + bb[j];
          Vec<T>::store(A + (size_t)r * 2 * E + E + c, o);
        });
      }
      __syncthreads();

      // h1 = relu(([a | m]·W0) * s0[set] + t0[set]) over q|k.
      {
        const float* s0 = wt.s0 + (size_t)l * 4 * E;
        const float* t0 = wt.t0 + (size_t)l * 4 * E;
        matmul<T>(A, 2 * E, R, 2 * E, 2 * E, wt.w0 + (size_t)l * 4 * E * E,
                  [&](int r, int c, float (&v)[4]) {
          const int set = r >= T0 ? 1 : 0;
          float s[4], t[4], o[4];
          Vec<float>::ldg(s0 + set * 2 * E + c, s);
          Vec<float>::ldg(t0 + set * 2 * E + c, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) o[j] = fmaxf(fmaf(v[j], s[j], t[j]), 0.0f);
          Vec<T>::store(Q + (size_t)r * 3 * E + c, o);
        });
      }
      __syncthreads();

      // res += rnd(h1·W1 + b1); a's left half gets rnd(res).
      {
        const float* b = wt.b1 + (size_t)l * E;
        matmul<T>(Q, 3 * E, R, 2 * E, E, wt.w1 + (size_t)l * 2 * E * E,
                  [&](int r, int c, float (&v)[4]) {
          float bb[4], x[4];
          Vec<float>::ldg(b + c, bb);
          float* rp = res + (size_t)r * ldres + c;
          Vec<float>::load(rp, x);
#pragma unroll
          for (int j = 0; j < 4; ++j) x[j] += Vec<T>::rnd(v[j] + bb[j]);
          Vec<float>::store(rp, x);
          if (BF16) Vec<T>::store(A + (size_t)r * 2 * E + c, x);
        });
      }
      __syncthreads();
    }

    // md = rnd(rnd(res)·Wf + bf) over q.
    matmul<T>(A, 2 * E, R, E, E, wt.wf, [&](int r, int c, float (&v)[4]) {
      float bb[4], o[4];
      Vec<float>::ldg(wt.bf + c, bb);
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = v[j] + bb[j];
      Vec<T>::store(Q + (size_t)r * 3 * E + c, o);
    });
    __syncthreads();

    for (int it = tid; it < T0 * T1; it += NT) {
      const int i = it / T1, j = it % T1;
      const T* a = Q + (size_t)i * 3 * E;
      const T* b = Q + (size_t)(T0 + j) * 3 * E;
      float dot = 0.0f;
      for (int c = 0; c < E; c += 4) {
        float x[4], y[4];
        Vec<T>::load(a + c, x);
        Vec<T>::load(b + c, y);
#pragma unroll
        for (int d = 0; d < 4; ++d) dot = fmaf(x[d], y[d], dot);
      }
      scores[(size_t)n * T0 * T1 + it] = dot / score_scale;
    }
    __syncthreads();   // the next pair overwrites the rows
  }
}

bool shape_ok(int E, int T0, int T1) {
  return E >= 4 && E <= MAX_E && E % 4 == 0 && T1 >= 1 && T1 <= T0 &&
         T0 <= MAX_T;
}

// The resident rows of a CTA fit in shared memory.
bool fits(int E, int T0, int T1, int bf16, int* smem_max) {
  int dev = 0;
  cudaGetDevice(&dev);
  *smem_max = 0;
  cudaDeviceGetAttribute(smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return layout(E, T0, T1, bf16 != 0).total <= (size_t)*smem_max;
}

// Persistent CTAs when the rows live in a global workspace.
int workspace_ctas(int n_pairs) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return n_pairs < 4 * sms ? n_pairs : 4 * sms;
}

template <typename T>
int launch(const float* desc0, const float* desc1, const Weights<T>& wt,
           int num_blocks, int E, int T0, int T1, float* scores, int n_pairs,
           unsigned char* workspace, cudaStream_t stream) {
  int smem_max = 0;
  const bool in_smem = fits(E, T0, T1, sizeof(T) == 2, &smem_max);
  if (!in_smem && workspace == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = in_smem ? layout(E, T0, T1, sizeof(T) == 2).total : 0;
  cudaError_t e = cudaFuncSetAttribute(
      gnn_any_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = in_smem ? n_pairs : workspace_ctas(n_pairs);
  gnn_any_kernel<T><<<grid, NT, smem, stream>>>(
      desc0, desc1, wt, num_blocks, E, T0, T1, scores, n_pairs,
      in_smem ? nullptr : workspace);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global workspace a launch at this shape needs: 0 where a pair's
// rows fit in shared memory. Returns a cudaError_t.
extern "C" int t2p_superglue_gnn_any_workspace(int E, int T0, int T1,
                                               int bf16, int n_pairs,
                                               long long* bytes) {
  if (!shape_ok(E, T0, T1) || n_pairs < 1) return (int)cudaErrorInvalidValue;
  int smem_max = 0;
  *bytes = fits(E, T0, T1, bf16, &smem_max)
               ? 0
               : (long long)workspace_ctas(n_pairs) *
                     (long long)layout(E, T0, T1, bf16 != 0).total;
  return 0;
}

// desc0 [N, T0, E] f32, desc1 [N, T1, E] f32, scores [N, T0, T1] f32;
// matmul weights row-major in bf16 (bf16 != 0) or f32, vectors f32;
// workspace as t2p_superglue_gnn_any_workspace says (may be null when it
// says 0). Returns a cudaError_t; 0 means the launch was accepted.
extern "C" int t2p_superglue_gnn_any(
    const void* desc0, const void* desc1, const void* wqkv, const void* bqkv,
    const void* wm, const void* bm, const void* w0, const void* s0,
    const void* t0, const void* w1, const void* b1, const void* wf,
    const void* bf, int num_blocks, int n_pairs, int E, int T0, int T1,
    int bf16, void* workspace, void* scores, void* stream) {
  if (n_pairs < 1 || num_blocks < 0 || !shape_ok(E, T0, T1))
    return (int)cudaErrorInvalidValue;
  unsigned char* ws = (unsigned char*)workspace;
  if (bf16) {
    using T = __nv_bfloat16;
    Weights<T> wt{(const T*)wqkv, (const float*)bqkv, (const T*)wm,
                  (const float*)bm, (const T*)w0, (const float*)s0,
                  (const float*)t0, (const T*)w1, (const float*)b1,
                  (const T*)wf, (const float*)bf};
    return launch<T>((const float*)desc0, (const float*)desc1, wt, num_blocks,
                     E, T0, T1, (float*)scores, n_pairs, ws,
                     (cudaStream_t)stream);
  }
  Weights<float> wt{(const float*)wqkv, (const float*)bqkv, (const float*)wm,
                    (const float*)bm, (const float*)w0, (const float*)s0,
                    (const float*)t0, (const float*)w1, (const float*)b1,
                    (const float*)wf, (const float*)bf};
  return launch<float>((const float*)desc0, (const float*)desc1, wt,
                       num_blocks, E, T0, T1, (float*)scores, n_pairs, ws,
                       (cudaStream_t)stream);
}

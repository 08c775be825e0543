// Log-domain Sinkhorn: `iters` alternating row/column dual updates, then
// Z + u + v; optionally with SuperGlue's dustbins built in the kernel.
//
// Replaces the TPU kernel text2pos_tpu/ops/sinkhorn_pallas.py:51
// (log_sinkhorn_pallas, body _sinkhorn_kernel :26), and the dustbin
// couplings and marginals around it (text2pos_tpu/ops/sinkhorn.py:44,
// log_optimal_transport).
//
// Design. The Pallas kernel puts the batch on the vector lanes; here the
// batch is on the threads: one thread (R = 4 neighbouring lanes, each a band
// of rows, for couplings larger than the serving one) owns one [M, N]
// coupling, its row duals u and column duals v, in registers for all
// iterations. The row log-sum-exp is a loop inside the thread; the column
// one too, plus log2(R) shuffles when R > 1 (at the serving 20,480
// couplings a second thread a coupling did not pay on the H100). No shuffle, no idle lane at R = 1: the warp-per-coupling kernel this
// replaces spent 15 of 32 lanes and 10 dependent shuffles a column on a
// 17x7 coupling. A CTA takes 32 couplings; their inputs are staged through
// shared memory (odd stride: conflict-free) so global loads and stores stay
// coalesced. Exponentials and logarithms use ex2/lg2 on log2(e)-scaled
// differences (x - max), which keeps the natural-log duals of the
// reference; everything else is f32.
//
// Dustbins (bins = 1). The kernel reads the [B, M-1, N-1] scores and the
// scalar alpha (a device pointer), forms the dustbin row and column, the
// marginals (norm = -log(M-1 + N-1); the dustbin's log(N-1) + norm and
// log(M-1) + norm) in registers, and writes Z + u + v - norm: no coupling
// tensor is built in device memory.
//
// Shapes. Two instantiations: the serving 17x7 coupling at R = 1 (exact
// unrolled loops) and a generic one for any coupling up to 32 x 16 (R = 4,
// 8 rows a thread, masked). Padding rows and columns hold -inf and never
// contribute. Past 32 x 16 (pad_size 32 and more, or 16 hints and more,
// which JAX's kernel takes as it takes any) the wide form,
// sinkhorn_wide_kernel (launch name "sinkhorn_wide"): a warp a coupling,
// with the coupling on chip. Its warp copies the scores into shared memory
// once (the dustbins and marginals built there; a row stride of N | 1, so
// a row pass and a column pass both read conflict-free), keeps u and v
// there for every iteration and writes Z + u + v once. In each pass
// every lane works: a row (column) takes G = 32 / rows (columns) lanes,
// rounded down to a power of two (at least 1), each taking every G-th
// element of it; the G partial maxima and sums combine by shuffles (max,
// then the sum of ex2 against the combined max). At G = 1 a lane's row is
// the loop over the other axis in index order; at [49, 7] the row pass
// keeps that order and the column pass takes 4 lanes a column (28 of 32),
// 13 rows each, a sum in another order than the plain version's (held to
// 1e-4 of it). Where a lane holds at most 8 elements of a row it takes two
// rounds of rows at once (at [49, 7] the whole row pass), at most 16 one,
// each with its elements loaded into registers first: the loads and the
// rounds' chains in flight together (0.093 against 0.122 ms at [1280, 49,
// 7] for one round at a time, the same outputs). The ex2/lg2 arithmetic
// is the register form's. A coupling
// whose copy does not fit a CTA's shared memory (past about 57,000 values)
// takes the same code with its scores read from global memory at every
// pass and its duals in a global workspace of M + N floats a coupling
// (wide_plan; the route "workspace"). An earlier wide form did that at
// every shape, and its warp's column pass at [49, 7] ran 7 lanes of 32,
// each a chain of 98 dependent steps over L1: 7.9 µs an iteration.
//
// Bound. Per iteration and coupling 2·M·N exponentials and M + N
// logarithms on the special-function units (16 a clock an SM on compute
// capability 9.0), against 2·B·M·N·4 bytes of traffic: the SFU rate bounds
// it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CPC = 32;                    // couplings per CTA
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const float* z;        // bins ? scores [B, M-1, N-1] : couplings [B, M, N]
  const float* log_mu;   // [B, M] (bins = 0)
  const float* log_nu;   // [B, N] (bins = 0)
  const float* alpha;    // device scalar (bins = 1)
  float* out;            // [B, M, N]
  int B, M, N, iters, bins;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// RPT rows a thread, NP columns, R threads a coupling; EXACT: the coupling
// is exactly (RPT·R) x NP, so no masking is compiled in.
template <int RPT, int NP, int R, bool EXACT>
__global__ void __launch_bounds__(CPC * R)
sinkhorn_kernel(const Args a) {
  extern __shared__ float stage[];
  const int M = EXACT ? RPT * R : a.M;
  const int N = EXACT ? NP : a.N;
  const int g = threadIdx.x % R;            // row band within the coupling
  const int cl = threadIdx.x / R;           // coupling within the CTA
  const int b0 = blockIdx.x * CPC;
  const int nb = min(CPC, a.B - b0);
  const bool bins = a.bins != 0;
  const int Mi = bins ? M - 1 : M, Ni = bins ? N - 1 : N;
  const int in_cnt = Mi * Ni, out_cnt = M * N;
  const int stride = out_cnt | 1;
  const float neg_inf = -INFINITY;

  const float* src = a.z + (size_t)b0 * in_cnt;
  for (int i = threadIdx.x; i < nb * in_cnt; i += CPC * R)
    stage[(i / in_cnt) * stride + i % in_cnt] = src[i];
  __syncthreads();

  const bool live = cl < nb;
  const float* zs = stage + cl * stride;
  const float alpha = bins ? __ldg(a.alpha) : 0.0f;
  const float norm = bins ? -logf((float)(Mi + Ni)) : 0.0f;

  float z[RPT][NP], u[RPT], v[NP], mu[RPT], nu[NP];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = g * RPT + r;
    const bool rv = EXACT || row < M;
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      float x = neg_inf;
      if (rv && (EXACT || j < N)) {
        if (bins && (row == M - 1 || j == N - 1)) x = alpha;
        else x = live ? zs[row * Ni + j] : 0.0f;
      }
      z[r][j] = x;
    }
    if (bins) mu[r] = row == M - 1 ? logf((float)Ni) + norm : norm;
    else mu[r] = (live && rv) ? __ldg(a.log_mu + (size_t)(b0 + cl) * M + row) : 0.0f;
    u[r] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (bins) nu[j] = j == N - 1 ? logf((float)Mi) + norm : norm;
    else nu[j] = (live && (EXACT || j < N)) ? __ldg(a.log_nu + (size_t)(b0 + cl) * N + j) : 0.0f;
    v[j] = 0.0f;
  }

  for (int it = 0; it < a.iters; ++it) {
    // u_i = log_mu_i - logsumexp_j(z_ij + v_j)
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      if (EXACT || g * RPT + r < M) {
        float m = neg_inf;
#pragma unroll
        for (int j = 0; j < NP; ++j) m = fmaxf(m, z[r][j] + v[j]);
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < NP; ++j) s += ex2((z[r][j] + v[j] - m) * LOG2E);
        u[r] = mu[r] - (m + lg2(s) * LN2);
      } else {
        u[r] = neg_inf;
      }
    }
    // v_j = log_nu_j - logsumexp_i(z_ij + u_i)
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      if (EXACT || j < N) {                  // uniform across the warp
        float m = neg_inf;
#pragma unroll
        for (int r = 0; r < RPT; ++r) m = fmaxf(m, z[r][j] + u[r]);
#pragma unroll
        for (int o = 1; o < R; o <<= 1)
          m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
        float s = 0.0f;
#pragma unroll
        for (int r = 0; r < RPT; ++r) s += ex2((z[r][j] + u[r] - m) * LOG2E);
#pragma unroll
        for (int o = 1; o < R; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        v[j] = nu[j] - (m + lg2(s) * LN2);
      }
    }
  }

  __syncthreads();                           // every input read from stage
  if (live) {
    float* os = stage + cl * stride;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = g * RPT + r;
#pragma unroll
      for (int j = 0; j < NP; ++j)
        if ((EXACT || row < M) && (EXACT || j < N))
          os[row * N + j] = z[r][j] + u[r] + v[j] - norm;
    }
  }
  __syncthreads();
  float* dst = a.out + (size_t)b0 * out_cnt;
  for (int i = threadIdx.x; i < nb * out_cnt; i += CPC * R)
    dst[i] = stage[(i / out_cnt) * stride + i % out_cnt];
}

template <int RPT, int NP, int R, bool EXACT>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = CPC * ((a.M * a.N) | 1) * (int)sizeof(float);
  auto kern = sinkhorn_kernel<RPT, NP, R, EXACT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(a.B + CPC - 1) / CPC, CPC * R, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

constexpr int WIDE_WARPS = 4;              // couplings a CTA at most

// Floats of shared memory a coupling takes in the wide form: Z with a row
// stride of N | 1, u, v, and the marginals.
__host__ __device__ inline int wide_floats(int M, int N) {
  return M * (N | 1) + 2 * (M + N);
}

// The wide form's plan (mirrored by ops/sinkhorn.py wide_plan): the
// couplings a CTA (4, halved until their copies fit `smem_max` bytes) and
// whether they fit at all (else the workspace route, 4 a CTA).
struct WidePlan {
  bool smem;
  int warps, bytes;
};

WidePlan wide_plan(int M, int N, int smem_max) {
  const long long per = 4LL * wide_floats(M, N);
  int w = WIDE_WARPS;
  while (w > 1 && w * per > smem_max) w /= 2;
  if (w * per > smem_max) return {false, WIDE_WARPS, 0};
  return {true, w, (int)(w * per)};
}

// The largest power of two at most 32 / n, and at least 1: the lanes that
// share a row or a column of n of them.
__device__ __forceinline__ int lanes_per(int n) {
  int g = 1;
  while (g * 2 * n <= 32) g *= 2;
  return g;
}

// u_i = log_mu_i - logsumexp_j(z_ij + v_j) for R rounds of rows of a pass
// at once (rows i0 + r·per + lane / G; the column pass swaps the axes): G
// lanes a row, each every G-th element, all CAP of them in registers
// (predicated past the row's end), so a lane's loads and its R rows'
// chains are in flight together; the G partial maxima and sums combine by
// shuffles; lane sub 0 of a group writes.
template <int CAP, int R, typename ZF, typename MF>
__device__ __forceinline__ void wide_rounds(int i0, int rows, int cols, int G,
                                            ZF z, MF mu, const float* other,
                                            float* dual, int lane) {
  const int per = 32 / G, sub = lane % G;
  float m[R], s[R], x[R][CAP];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * per + lane / G;
    m[r] = -INFINITY;
    s[r] = 0.0f;
#pragma unroll
    for (int k = 0; k < CAP; ++k) {
      const int j = sub + k * G;
      x[r][k] = i < rows && j < cols ? z(i, j) + other[j] : -INFINITY;
      m[r] = fmaxf(m[r], x[r][k]);
    }
  }
  for (int o = 1; o < G; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], o));
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool live = i0 + r * per + lane / G < rows;
#pragma unroll
    for (int k = 0; k < CAP; ++k)
      if (live && sub + k * G < cols) s[r] += ex2((x[r][k] - m[r]) * LOG2E);
  }
  for (int o = 1; o < G; o <<= 1)
#pragma unroll
    for (int r = 0; r < R; ++r)
      s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + r * per + lane / G;
    if (i < rows && sub == 0) dual[i] = mu(i) - (m[r] + lg2(s[r]) * LN2);
  }
}

// A pass over `rows` rows of `cols` (see wide_rounds): two rounds at once
// where a lane holds at most 8 elements of a row, one where 16; past 16 a
// loop over the elements, twice. The same sums every way: each lane's in
// index order, then the shuffles.
template <typename ZF, typename MF>
__device__ __forceinline__ void wide_pass(int rows, int cols, ZF z, MF mu,
                                          const float* other, float* dual,
                                          int lane) {
  const int G = lanes_per(rows), per = 32 / G;
  const int sub = lane % G;
  if (cols <= 8 * G) {                       // uniform across the warp
    for (int i0 = 0; i0 < rows; i0 += 2 * per)
      wide_rounds<8, 2>(i0, rows, cols, G, z, mu, other, dual, lane);
    return;
  }
  if (cols <= 16 * G) {
    for (int i0 = 0; i0 < rows; i0 += per)
      wide_rounds<16, 1>(i0, rows, cols, G, z, mu, other, dual, lane);
    return;
  }
  for (int i0 = 0; i0 < rows; i0 += per) {   // uniform across the warp
    const int i = i0 + lane / G;
    const bool live = i < rows;
    float m = -INFINITY, s = 0.0f;
    if (live)
      for (int j = sub; j < cols; j += G) m = fmaxf(m, z(i, j) + other[j]);
    for (int o = 1; o < G; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (live)
      for (int j = sub; j < cols; j += G)
        s += ex2((z(i, j) + other[j] - m) * LOG2E);
    for (int o = 1; o < G; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (live && sub == 0) dual[i] = mu(i) - (m + lg2(s) * LN2);
  }
}

// The wide form (see the header): coupling b on warp b of the grid. SMEM:
// the coupling copied into shared memory ([Z | u | v | mu | nu] a warp),
// else read from global memory with u and v in duals[b] = [u (M) | v (N)].
template <bool SMEM>
__global__ void __launch_bounds__(WIDE_WARPS * 32)
sinkhorn_wide_kernel(const Args a, float* __restrict__ duals) {
  extern __shared__ float wsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= a.B) return;                      // whole warps; warp syncs only
  const int M = a.M, N = a.N, ld = N | 1;
  const bool bins = a.bins != 0;
  const int Mi = bins ? M - 1 : M, Ni = bins ? N - 1 : N;
  const float* zb = a.z + (size_t)b * Mi * Ni;
  const float alpha = bins ? __ldg(a.alpha) : 0.0f;
  const float norm = bins ? -logf((float)(Mi + Ni)) : 0.0f;
  auto zg = [&](int i, int j) -> float {
    if (bins && (i == M - 1 || j == N - 1)) return alpha;
    return __ldg(zb + (size_t)i * Ni + j);
  };
  auto mug = [&](int i) -> float {
    if (bins) return i == M - 1 ? logf((float)Ni) + norm : norm;
    return __ldg(a.log_mu + (size_t)b * M + i);
  };
  auto nug = [&](int j) -> float {
    if (bins) return j == N - 1 ? logf((float)Mi) + norm : norm;
    return __ldg(a.log_nu + (size_t)b * N + j);
  };
  float* zs = wsm + (size_t)warp * wide_floats(M, N);
  float* u = SMEM ? zs + (size_t)M * ld : duals + (size_t)b * (M + N);
  float* v = u + M;
  float* mus = v + N;
  float* nus = mus + M;
  if (SMEM) {
    for (int k = lane; k < M * N; k += 32) {
      const int i = k / N, j = k % N;
      zs[i * ld + j] = zg(i, j);
    }
    for (int i = lane; i < M; i += 32) mus[i] = mug(i);
    for (int j = lane; j < N; j += 32) nus[j] = nug(j);
  }
  for (int i = lane; i < M + N; i += 32) u[i] = 0.0f;
  __syncwarp();
  auto z = [&](int i, int j) -> float {
    return SMEM ? zs[i * ld + j] : zg(i, j);
  };
  auto zt = [&](int j, int i) -> float { return z(i, j); };
  auto mu = [&](int i) -> float { return SMEM ? mus[i] : mug(i); };
  auto nu = [&](int j) -> float { return SMEM ? nus[j] : nug(j); };
  for (int it = 0; it < a.iters; ++it) {
    wide_pass(M, N, z, mu, v, u, lane);      // u_i = log_mu_i - lse_j
    __syncwarp();
    wide_pass(N, M, zt, nu, u, v, lane);     // v_j = log_nu_j - lse_i
    __syncwarp();
  }
  float* dst = a.out + (size_t)b * M * N;
  for (int k = lane; k < M * N; k += 32) {
    const int i = k / N, j = k % N;
    dst[k] = z(i, j) + u[i] + v[j] - norm;
  }
}

Args make_args(const void* z, const void* log_mu, const void* log_nu,
               const void* alpha, void* out, int B, int M, int N, int iters,
               int bins) {
  Args a;
  a.z = (const float*)z;
  a.log_mu = (const float*)log_mu;
  a.log_nu = (const float*)log_nu;
  a.alpha = (const float*)alpha;
  a.out = (float*)out;
  a.B = B;
  a.M = M;
  a.N = N;
  a.iters = iters;
  a.bins = bins;
  return a;
}

}  // namespace

namespace {

cudaError_t wide_plan_here(int M, int N, WidePlan* p) {
  int dev = 0, smem_max = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) *p = wide_plan(M, N, smem_max);
  return e;
}

}  // namespace

// The wide form's plan for an M x N coupling (dustbins included) on this
// card: out[0] = 1 where the couplings are copied into shared memory (0:
// the workspace route), out[1] couplings a CTA, out[2] shared-memory bytes
// a CTA. Returns a cudaError_t.
extern "C" int t2p_sinkhorn_wide_plan(int M, int N, int* out) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  WidePlan p;
  const cudaError_t e = wide_plan_here(M, N, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.smem;
  out[1] = p.warps;
  out[2] = p.bytes;
  return 0;
}

// The wide form at any M x N (dustbins included). duals: a float
// workspace of B·(M + N), which the kernel initializes, where the plan
// takes the workspace route (it may be null otherwise). Returns a
// cudaError_t; 0 means the launch was accepted.
extern "C" int t2p_log_sinkhorn_wide(const void* z, const void* log_mu,
                                     const void* log_nu, const void* alpha,
                                     void* out, void* duals, int B, int M,
                                     int N, int iters, int bins,
                                     void* stream) {
  if (M < 1 || N < 1 || B < 1 || iters < 0 || (bins && (M < 2 || N < 2)))
    return (int)cudaErrorInvalidValue;
  WidePlan p;
  cudaError_t e = wide_plan_here(M, N, &p);
  if (e != cudaSuccess) return (int)e;
  if (!p.smem && duals == nullptr) return (int)cudaErrorInvalidValue;
  const Args a = make_args(z, log_mu, log_nu, alpha, out, B, M, N, iters,
                           bins);
  const unsigned grid = (unsigned)((B + p.warps - 1) / p.warps);
  cudaStream_t s = (cudaStream_t)stream;
  if (p.smem) {
    if (p.bytes > 48 * 1024) {
      e = cudaFuncSetAttribute(sinkhorn_wide_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.bytes);
      if (e != cudaSuccess) return (int)e;
    }
    sinkhorn_wide_kernel<true><<<grid, p.warps * 32, p.bytes, s>>>(
        a, (float*)duals);
  } else {
    sinkhorn_wide_kernel<false><<<grid, p.warps * 32, 0, s>>>(
        a, (float*)duals);
  }
  return (int)cudaGetLastError();
}

// M x N is the coupling's shape, dustbins included. Returns a cudaError_t;
// 0 means the launch was accepted.
extern "C" int t2p_log_sinkhorn(const void* z, const void* log_mu,
                                const void* log_nu, const void* alpha,
                                void* out, int B, int M, int N, int iters,
                                int bins, void* stream) {
  if (M < 1 || M > 32 || N < 1 || N > 16 || B < 1 || iters < 0 ||
      (bins && (M < 2 || N < 2)))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(z, log_mu, log_nu, alpha, out, B, M, N, iters,
                           bins);
  cudaStream_t s = (cudaStream_t)stream;
  if (M == 17 && N == 7) return launch<17, 7, 1, true>(a, s);
  return launch<8, 16, 4, false>(a, s);
}

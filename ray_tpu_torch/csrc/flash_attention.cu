// Flash attention forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel     (:33)  O and the row logsumexp
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel  (:102) dQ = sum_k dS K
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel (:136) dV = sum_q P^T dO, dK = sum_q dS^T Q
// with the reference's rules: scores S = Q K^T * scale in float32, NEG_INF is
// the finite -1e30, a row is alive while its max is above NEG_INF / 2, keys at
// or past S and (causal) keys after the query are masked, a dead row gives
// zeros and lse = NEG_INF. The backward recomputes P = exp(S - lse) and
// dS = P * (dO V^T - delta) * scale, delta = rowsum(dO * O) coming in.
//
// Layouts: q, o, dO, dq [B, S, Hq, D]; k, v, dk, dv [B, S, Hkv, D], each read
// or written through its (batch, seq, head) strides with unit stride over D;
// lse and delta [B, Hq, S] float32. Query head h uses kv head h / g.
//
// Bound: operations. At the training shapes (B 4, S 2048, Hq 32, Hkv 8, D 64,
// causal) the forward does 4 * B * Hq * D * S (S + 1) / 2 flops on ~85 MB, the
// backward 3 and 4 such products, all far above the card's flops per byte. So
// the design keeps every S x S tile on chip and puts the products on the
// tensor cores:
//  - bf16: each product is a block GEMM of 16x16x16 WMMA tiles (mma.sync),
//    bf16 operands from shared memory, float32 accumulation. P and dS are
//    rounded to bf16 before their products; the softmax statistics and all
//    sums stay float32. float32 inputs take a register-tiled CUDA-core GEMM
//    with the same structure, exact float32 throughout.
//  - forward: one CTA per (q tile, q head, batch) loops over the k tiles up to
//    the diagonal (causal), carrying m, l and the accumulator in shared
//    memory. The TPU kernel carries them in scratch along a sequential grid
//    axis; here the loop is inside the CTA and needs no cross-CTA reduction.
//  - dQ: one CTA per (q tile, q head, batch), looping over k tiles up to the
//    diagonal.
//  - dK/dV: one CTA per (k tile, kv head, batch), looping over the g query
//    heads of its group and the q tiles from the diagonal on, so the GQA sum
//    over the group (the adjoint of the JAX wrapper's KV repeat) happens in
//    the CTA's accumulators: no atomics, no [B, S, Hq, D] dK buffer.
//  - no repeat and no padding: heads map by index, rows past S load as zeros
//    and are masked (keys) or not stored (queries).
// Known limits: global loads are synchronous (no cp.async/TMA pipeline), the
// accumulators round-trip through shared memory between WMMA products, and
// wgmma is not used. Those are the next steps.
//
// C interface (bound with ctypes): each *_launch returns the cudaError_t of
// its launch (0 on success). `strides` points to host int64 triples
// (batch, seq, head) of the strided tensors, in argument order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

constexpr size_t up128(size_t x) { return (x + 127) & ~size_t(127); }

// Tile sizes and padded shared-memory row lengths. Rows are padded by 16
// bytes so that WMMA's row loads spread over the banks; every buffer starts
// on a 128-byte boundary (WMMA needs 32).
template <typename T, int D>
struct Tiles {
  static constexpr int BQ = 64;
  static constexpr int BK = sizeof(T) == 2 ? 64 : 32;
  static constexpr int LD = D + 16 / (int)sizeof(T);   // T tile [rows][D]
  static constexpr int LP = BK + 16 / (int)sizeof(T);  // T tile [BQ][BK]
  static constexpr int LS = BK + 4;                    // float tile [BQ][BK]
  static constexpr int LA = D + 4;                     // float tile [rows][D]
  static constexpr size_t q_tile = up128((size_t)BQ * LD * sizeof(T));
  static constexpr size_t k_tile = up128((size_t)BK * LD * sizeof(T));
  static constexpr size_t p_tile = up128((size_t)BQ * LP * sizeof(T));
  static constexpr size_t s_tile = up128((size_t)BQ * LS * sizeof(float));
  static constexpr size_t row = up128((size_t)BQ * sizeof(float));
  static constexpr size_t q_acc = up128((size_t)BQ * LA * sizeof(float));
  static constexpr size_t k_acc = up128((size_t)BK * LA * sizeof(float));
  // forward: q, k, v, s, p, acc, m, l, corr
  static constexpr size_t fwd_smem = q_tile + 2 * k_tile + s_tile + p_tile + q_acc + 3 * row;
  // dQ: q, dO, k, v, s, dP, dS, acc, lse, delta
  static constexpr size_t dq_smem = 2 * q_tile + 2 * k_tile + 2 * s_tile + p_tile + q_acc + 2 * row;
  // dK/dV: k, v, q, dO, s, dP, P, dS, dK acc, dV acc, lse, delta
  static constexpr size_t dkv_smem =
      2 * k_tile + 2 * q_tile + 2 * s_tile + 2 * p_tile + 2 * k_acc + 2 * row;
};

// Rows [row0, row0 + R) of one head into a [R][ld] shared tile with 16-byte
// loads; rows at or past S are zeros.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* head, long long row_stride,
                                          int row0, int S) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kRowVecs = D / kVec;
  for (int x = threadIdx.x; x < R * kRowVecs; x += kThreads) {
    const int r = x / kRowVecs, c = (x % kRowVecs) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S) val = *reinterpret_cast<const uint4*>(head + (row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// Rows of a float [R][ld] shared tile, divided by max(div[r], 1e-30) when
// div is given, to rows [row0, row0 + R) of one head; rows past S are skipped.
template <typename T, int R, int D>
__device__ __forceinline__ void store_tile(T* head, long long row_stride, int row0, int S,
                                           const float* src, int ld, const float* div) {
  for (int x = threadIdx.x; x < R * D; x += kThreads) {
    const int r = x / D, c = x % D;
    if (row0 + r >= S) continue;
    float val = src[r * ld + c];
    if (div != nullptr) val /= fmaxf(div[r], 1e-30f);
    head[(row0 + r) * row_stride + c] = from_float<T>(val);
  }
}

__device__ __forceinline__ void zero(float* t, int n) {
  for (int x = threadIdx.x; x < n; x += kThreads) t[x] = 0.f;
}

// C[M][N] (+)= sum_k A(m, k) B(k, n), all in shared memory, C float32.
// A(m, k) = A[m * lda + k], or A[k * lda + m] with kColA (a transposed read);
// B(k, n) = B[k * ldb + n], or B[n * ldb + k] with kColB.
// bf16: warp w takes 16x16 output tiles w, w + 8, ...; WMMA 16x16x16.
template <bool kColA, bool kColB, int M, int N, int K, bool kAccumulate>
__device__ __forceinline__ void gemm(float* C, int ldc, const bf16* A, int lda, const bf16* B,
                                     int ldb) {
  using LA = std::conditional_t<kColA, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<kColB, wmma::col_major, wmma::row_major>;
  constexpr int TN = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * TN; t += kWarps) {
    const int tm = t / TN * 16, tn = t % TN * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (kAccumulate)
      wmma::load_matrix_sync(c, C + tm * ldc + tn, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(a, kColA ? A + kk * lda + tm : A + tm * lda + kk, lda);
      wmma::load_matrix_sync(b, kColB ? B + tn * ldb + kk : B + kk * ldb + tn, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + tm * ldc + tn, c, ldc, wmma::mem_row_major);
  }
}

// float32: thread (ty, tx) of a 16x16 layout owns C[ty + 16 i][tx + 16 j].
template <bool kColA, bool kColB, int M, int N, int K, bool kAccumulate>
__device__ __forceinline__ void gemm(float* C, int ldc, const float* A, int lda, const float* B,
                                     int ldb) {
  static_assert(kThreads == 256, "the float32 GEMM lays threads out 16 x 16");
  constexpr int RM = M / 16, RN = N / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      acc[i][j] = kAccumulate ? C[(ty + 16 * i) * ldc + tx + 16 * j] : 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[RM], b[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) a[i] = kColA ? A[k * lda + ty + 16 * i] : A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < RN; ++j) b[j] = kColB ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) C[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
}

__device__ __forceinline__ bool key_live(int row, int col, int S, int causal) {
  return col < S && (!causal || row >= col);
}

// ------------------------------------------------------------------ forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so, int S, int g,
    int causal, float scale) {
  using L = Tiles<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* q_s = reinterpret_cast<T*>(p);         p += L::q_tile;
  T* k_s = reinterpret_cast<T*>(p);         p += L::k_tile;
  T* v_s = reinterpret_cast<T*>(p);         p += L::k_tile;
  float* s_s = reinterpret_cast<float*>(p); p += L::s_tile;
  T* p_s = reinterpret_cast<T*>(p);         p += L::p_tile;
  float* acc = reinterpret_cast<float*>(p); p += L::q_acc;
  float* m_s = reinterpret_cast<float*>(p); p += L::row;
  float* l_s = reinterpret_cast<float*>(p); p += L::row;
  float* corr_s = reinterpret_cast<float*>(p);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hq = gridDim.y, kh = h / g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* k_head = k + b * sk.b + kh * sk.h;
  const T* v_head = v + b * sv.b + kh * sv.h;

  load_tile<T, BQ, D>(q_s, L::LD, q + b * sq.b + h * sq.h, sq.s, q0, S);
  zero(acc, BQ * L::LA);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  // causal: k tiles past the last query row of this tile are all masked
  const int n_k = causal ? (min(q0 + BQ, S) - 1) / BK + 1 : (S + BK - 1) / BK;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    load_tile<T, BK, D>(k_s, L::LD, k_head, sk.s, k0, S);
    load_tile<T, BK, D>(v_s, L::LD, v_head, sv.s, k0, S);
    __syncthreads();
    gemm<false, true, BQ, BK, D, false>(s_s, L::LS, q_s, L::LD, k_s, L::LD);  // Q K^T
    __syncthreads();

    // online softmax: warp w updates rows w, w + 8, ...; lanes split the keys
    for (int r = warp; r < BQ; r += kWarps) {
      float x[BK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const int j = lane + 32 * e;
        x[e] = key_live(q0 + r, k0 + j, S, causal) ? s_s[r * L::LS + j] * scale : kNegInf;
        mx = fmaxf(mx, x[e]);
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      const float alive = m_new > kNegInf * 0.5f ? 1.f : 0.f;
      const float m_safe = m_new * alive;
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < BK / 32; ++e) {
        const float pe = expf(x[e] - m_safe) * alive;
        p_s[r * L::LP + lane + 32 * e] = from_float<T>(pe);
        sum += pe;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_safe) * alive;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        corr_s[r] = corr;
      }
    }
    __syncthreads();
    for (int x = threadIdx.x; x < BQ * D; x += kThreads) acc[x / D * L::LA + x % D] *= corr_s[x / D];
    __syncthreads();
    gemm<false, false, BQ, D, BK, true>(acc, L::LA, p_s, L::LP, v_s, L::LD);  // acc += P V
    __syncthreads();
  }

  store_tile<T, BQ, D>(o + b * so.b + h * so.h, so.s, q0, S, acc, L::LA, l_s);
  float* lse_row = lse + ((size_t)b * hq + h) * S;
  for (int r = threadIdx.x; r < BQ && q0 + r < S; r += kThreads) {
    const float l = l_s[r];
    lse_row[q0 + r] = l > 0.f ? m_s[r] + logf(fmaxf(l, 1e-30f)) : kNegInf;
  }
}

// Loads lse and delta of rows [q0, q0 + BQ); rows past S get a dead lse.
template <int BQ>
__device__ __forceinline__ void load_rowstats(float* lse_s, float* delta_s, const float* lse_row,
                                              const float* delta_row, int q0, int S) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse_row[q0 + r] : kNegInf;
    delta_s[r] = in ? delta_row[q0 + r] : 0.f;
  }
}

// P and dS of one [BQ][BK] tile from the scores and dO V^T (both float).
template <typename T, int BQ, int BK, int LS, int LP>
__device__ __forceinline__ void p_and_ds(const float* s_s, const float* dp_s, const float* lse_s,
                                         const float* delta_s, T* p_out, T* ds_out, int q0,
                                         int k0, int S, int causal, float scale) {
  for (int x = threadIdx.x; x < BQ * BK; x += kThreads) {
    const int r = x / BK, j = x % BK;
    const float s = key_live(q0 + r, k0 + j, S, causal) ? s_s[r * LS + j] * scale : kNegInf;
    const float lse = lse_s[r];
    const float alive = lse > kNegInf * 0.5f ? 1.f : 0.f;
    const float pe = expf(s - lse * alive) * alive;
    if (p_out != nullptr) p_out[r * LP + j] = from_float<T>(pe);
    ds_out[r * LP + j] = from_float<T>(pe * (dp_s[r * LS + j] - delta_s[r]) * scale);
  }
}

// ------------------------------------------------------------------ dQ
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq, int S,
    int g, int causal, float scale) {
  using L = Tiles<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* q_s = reinterpret_cast<T*>(p);           p += L::q_tile;
  T* do_s = reinterpret_cast<T*>(p);          p += L::q_tile;
  T* k_s = reinterpret_cast<T*>(p);           p += L::k_tile;
  T* v_s = reinterpret_cast<T*>(p);           p += L::k_tile;
  float* s_s = reinterpret_cast<float*>(p);   p += L::s_tile;
  float* dp_s = reinterpret_cast<float*>(p);  p += L::s_tile;
  T* ds_s = reinterpret_cast<T*>(p);          p += L::p_tile;
  float* acc = reinterpret_cast<float*>(p);   p += L::q_acc;
  float* lse_s = reinterpret_cast<float*>(p); p += L::row;
  float* delta_s = reinterpret_cast<float*>(p);

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hq = gridDim.y, kh = h / g;
  const T* k_head = k + b * sk.b + kh * sk.h;
  const T* v_head = v + b * sv.b + kh * sv.h;
  const size_t row_base = ((size_t)b * hq + h) * S;

  load_tile<T, BQ, D>(q_s, L::LD, q + b * sq.b + h * sq.h, sq.s, q0, S);
  load_tile<T, BQ, D>(do_s, L::LD, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  load_rowstats<BQ>(lse_s, delta_s, lse + row_base, delta + row_base, q0, S);
  zero(acc, BQ * L::LA);
  const int n_k = causal ? (min(q0 + BQ, S) - 1) / BK + 1 : (S + BK - 1) / BK;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    load_tile<T, BK, D>(k_s, L::LD, k_head, sk.s, k0, S);
    load_tile<T, BK, D>(v_s, L::LD, v_head, sv.s, k0, S);
    __syncthreads();
    gemm<false, true, BQ, BK, D, false>(s_s, L::LS, q_s, L::LD, k_s, L::LD);    // Q K^T
    gemm<false, true, BQ, BK, D, false>(dp_s, L::LS, do_s, L::LD, v_s, L::LD);  // dO V^T
    __syncthreads();
    p_and_ds<T, BQ, BK, L::LS, L::LP>(s_s, dp_s, lse_s, delta_s, nullptr, ds_s, q0, k0, S, causal,
                                      scale);
    __syncthreads();
    gemm<false, false, BQ, D, BK, true>(acc, L::LA, ds_s, L::LP, k_s, L::LD);  // acc += dS K
    __syncthreads();
  }
  store_tile<T, BQ, D>(dq + b * sdq.b + h * sdq.h, sdq.s, q0, S, acc, L::LA, nullptr);
}

// ------------------------------------------------------------------ dK / dV
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk, Strides sv, Strides sdo,
    Strides sdk, Strides sdv, int S, int g, int causal, float scale) {
  using L = Tiles<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* p = smem;
  T* k_s = reinterpret_cast<T*>(p);            p += L::k_tile;
  T* v_s = reinterpret_cast<T*>(p);            p += L::k_tile;
  T* q_s = reinterpret_cast<T*>(p);            p += L::q_tile;
  T* do_s = reinterpret_cast<T*>(p);           p += L::q_tile;
  float* s_s = reinterpret_cast<float*>(p);    p += L::s_tile;
  float* dp_s = reinterpret_cast<float*>(p);   p += L::s_tile;
  T* p_s = reinterpret_cast<T*>(p);            p += L::p_tile;
  T* ds_s = reinterpret_cast<T*>(p);           p += L::p_tile;
  float* dk_acc = reinterpret_cast<float*>(p); p += L::k_acc;
  float* dv_acc = reinterpret_cast<float*>(p); p += L::k_acc;
  float* lse_s = reinterpret_cast<float*>(p);  p += L::row;
  float* delta_s = reinterpret_cast<float*>(p);

  const int k0 = blockIdx.x * BK, kh = blockIdx.y, b = blockIdx.z;
  const int hq = gridDim.y * g;
  load_tile<T, BK, D>(k_s, L::LD, k + b * sk.b + kh * sk.h, sk.s, k0, S);
  load_tile<T, BK, D>(v_s, L::LD, v + b * sv.b + kh * sv.h, sv.s, k0, S);
  zero(dk_acc, BK * L::LA);
  zero(dv_acc, BK * L::LA);
  // causal: q tiles that end before this k tile's first key see none of it
  const int first_q = causal ? k0 / BQ : 0;
  const int n_q = (S + BQ - 1) / BQ;

  for (int j = 0; j < g; ++j) {
    const int h = kh * g + j;
    const T* q_head = q + b * sq.b + h * sq.h;
    const T* do_head = dout + b * sdo.b + h * sdo.h;
    const size_t row_base = ((size_t)b * hq + h) * S;
    for (int qt = first_q; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      load_tile<T, BQ, D>(q_s, L::LD, q_head, sq.s, q0, S);
      load_tile<T, BQ, D>(do_s, L::LD, do_head, sdo.s, q0, S);
      load_rowstats<BQ>(lse_s, delta_s, lse + row_base, delta + row_base, q0, S);
      __syncthreads();
      gemm<false, true, BQ, BK, D, false>(s_s, L::LS, q_s, L::LD, k_s, L::LD);    // Q K^T
      gemm<false, true, BQ, BK, D, false>(dp_s, L::LS, do_s, L::LD, v_s, L::LD);  // dO V^T
      __syncthreads();
      p_and_ds<T, BQ, BK, L::LS, L::LP>(s_s, dp_s, lse_s, delta_s, p_s, ds_s, q0, k0, S, causal,
                                        scale);
      __syncthreads();
      gemm<true, false, BK, D, BQ, true>(dv_acc, L::LA, p_s, L::LP, do_s, L::LD);  // += P^T dO
      gemm<true, false, BK, D, BQ, true>(dk_acc, L::LA, ds_s, L::LP, q_s, L::LD);  // += dS^T Q
      __syncthreads();
    }
  }
  store_tile<T, BK, D>(dk + b * sdk.b + kh * sdk.h, sdk.s, k0, S, dk_acc, L::LA, nullptr);
  store_tile<T, BK, D>(dv + b * sdv.b + kh * sdv.h, sdv.s, k0, S, dv_acc, L::LA, nullptr);
}

// ------------------------------------------------------------------ launchers
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

Strides stride(const long long* s, int i) { return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                const long long* st, int B, int S, int Hkv, int g, int causal, cudaStream_t stream) {
  using L = Tiles<T, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = prepare(kernel, L::fwd_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + L::BQ - 1) / L::BQ, Hkv * g, B);
  kernel<<<grid, kThreads, L::fwd_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), static_cast<float*>(lse), stride(st, 0), stride(st, 1), stride(st, 2),
      stride(st, 3), S, g, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, const long long* st, int B, int S, int Hkv, int g,
                   int causal, cudaStream_t stream) {
  using L = Tiles<T, D>;
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = prepare(kernel, L::dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + L::BQ - 1) / L::BQ, Hkv * g, B);
  kernel<<<grid, kThreads, L::dq_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), stride(st, 0), stride(st, 1),
      stride(st, 2), stride(st, 3), stride(st, 4), S, g, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, const long long* st,
                    int B, int S, int Hkv, int g, int causal, cudaStream_t stream) {
  using L = Tiles<T, D>;
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = prepare(kernel, L::dkv_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + L::BK - 1) / L::BK, Hkv, B);
  kernel<<<grid, kThreads, L::dkv_smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), stride(st, 0),
      stride(st, 1), stride(st, 2), stride(st, 3), stride(st, 4), stride(st, 5), S, g, causal,
      1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

bool valid(int B, int S, int Hkv, int g) {
  return B > 0 && S > 0 && Hkv > 0 && g > 0 && B <= 65535 && (long long)Hkv * g <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128. Shapes are checked by the
// Python wrapper; what the kernels cannot take is refused here as well.
#define FLASH_DISPATCH(FN, ...)                                                     \
  {                                                                                 \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                             \
    if (dtype == 0 && D == 64) return (int)FN<float, 64>(__VA_ARGS__, s);           \
    if (dtype == 0 && D == 128) return (int)FN<float, 128>(__VA_ARGS__, s);         \
    if (dtype == 1 && D == 64) return (int)FN<bf16, 64>(__VA_ARGS__, s);            \
    if (dtype == 1 && D == 128) return (int)FN<bf16, 128>(__VA_ARGS__, s);          \
    return (int)cudaErrorInvalidValue;                                              \
  }

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                const long long* strides, int B, int S, int Hkv, int g, int D,
                                int causal, int dtype, void* stream) {
  if (!valid(B, S, Hkv, g)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(fwd, q, k, v, o, lse, strides, B, S, Hkv, g, causal);
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq,
                                   const long long* strides, int B, int S, int Hkv, int g, int D,
                                   int causal, int dtype, void* stream) {
  if (!valid(B, S, Hkv, g)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, strides, B, S, Hkv, g, causal);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dk, void* dv,
                                    const long long* strides, int B, int S, int Hkv, int g, int D,
                                    int causal, int dtype, void* stream) {
  if (!valid(B, S, Hkv, g)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, strides, B, S, Hkv, g, causal);
}

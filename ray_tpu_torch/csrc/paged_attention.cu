// Paged decode attention for NVIDIA Hopper (sm_90a).
//
// Replaces ray_tpu/ops/paged_attention.py::_decode_kernel (the Pallas TPU
// kernel). One query token per sequence attends over a KV cache kept in
// block_size-token pages scattered through a pool; a block table maps the
// sequence's i-th block to its page. Same result as the TPU kernel: online
// softmax over the pages in float32, pages at or past lengths[b] skipped,
// positions kpos >= lengths[b] in the last page masked to NEG_INF, output
// acc / max(l, 1e-30) in q's dtype, so a length-0 row gives zeros.
//
// Layouts: q [B, Hq, D]; k/v pages [Hkv, NB, BS, D] (head-major, one page is
// one contiguous [BS, D] tile); tables [B, max_blocks] int32; lengths [B]
// int32; out [B, Hq, D]. Query head h belongs to kv head h / g, g = Hq / Hkv.
//
// Bound: bytes. The call must read sum_b lengths[b] * Hkv * D * 2 (K and V)
// elements plus q, and write out; it does ~4 * Hq * D flops per cached
// token, far below the card's rate per byte. So the design reads every K/V
// byte once and keeps everything else on chip:
//  - grid (B, Hkv): one CTA per (sequence, kv head) serves all g query heads
//    of its group, so each page is read once for the group. The TPU kernel's
//    padding of the group to 8 sublanes is dropped.
//  - the TPU grid's sequential page axis is a loop inside the CTA over
//    ceil(len / BS) pages, so dead pages cost nothing; the CTA reads its
//    length and its table row itself (no scalar prefetch).
//  - per page, K and V [BS, D] land in shared memory with 16-byte coalesced
//    loads; each warp takes whole key rows, lanes split D, and g dot products
//    reduce by warp shuffles; the (m, l) update for a head is done by one
//    warp; the float32 accumulator acc[g, D] stays in registers, thread t
//    owning column t % D.
// Known limit: B * Hkv CTAs (64 at batch 8 of Llama-3-8B) fill half of the
// 132 SMs and each CTA waits on its page load before computing. Split-K
// over pages with a combine pass and cp.async/TMA double buffering are the
// next step.
//
// C interface (bound with ctypes): paged_decode_attention_launch returns the
// cudaError_t of the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;    // query heads per kv head
constexpr int kMaxBS = 64;  // tokens per page
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ tables, const int* __restrict__ lengths, T* __restrict__ out,
    int num_pages_pool, int block_size, int max_blocks, int g, float scale) {
  constexpr int kPerLane = D / 32;           // q/k elements each lane holds
  constexpr int kHeadStep = kThreads / D;    // threads sharing one column
  constexpr int kOwn = kMaxG / kHeadStep;    // heads a thread accumulates
  constexpr int kWarpHeads = kMaxG / kWarps; // heads a warp runs softmax for

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + block_size * D;
  __shared__ float p_s[kMaxG][kMaxBS];  // scores, then probabilities
  __shared__ float corr_s[kMaxG];
  __shared__ float l_s[kMaxG];

  const int b = blockIdx.x, kh = blockIdx.y;
  const int hkv = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hq = hkv * g;
  const int len = lengths[b];
  const int n_pages = len > 0 ? min((len + block_size - 1) / block_size, max_blocks) : 0;

  // this group's query rows, lane-split over D, in float32 registers
  float qr[kMaxG][kPerLane];
#pragma unroll
  for (int h = 0; h < kMaxG; ++h) {
    const T* qrow = q + ((size_t)b * hq + (size_t)kh * g + h) * D + lane * kPerLane;
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) qr[h][e] = h < g ? to_float(qrow[e]) : 0.f;
  }

  float m_run[kWarpHeads], l_run[kWarpHeads];
#pragma unroll
  for (int s = 0; s < kWarpHeads; ++s) {
    m_run[s] = kNegInf;
    l_run[s] = 0.f;
  }
  const int col = tid % D, h_first = tid / D;
  float acc[kOwn];
#pragma unroll
  for (int o = 0; o < kOwn; ++o) acc[o] = 0.f;

  const size_t page_elems = (size_t)block_size * D;
  const T* k_head = k_pages + (size_t)kh * num_pages_pool * page_elems;
  const T* v_head = v_pages + (size_t)kh * num_pages_pool * page_elems;
  const int* table_row = tables + (size_t)b * max_blocks;
  const int vecs = (int)(page_elems * sizeof(T) / sizeof(uint4));

  for (int i = 0; i < n_pages; ++i) {
    const size_t page = (size_t)table_row[i] * page_elems;
    const uint4* k_src = reinterpret_cast<const uint4*>(k_head + page);
    const uint4* v_src = reinterpret_cast<const uint4*>(v_head + page);
    uint4* k_dst = reinterpret_cast<uint4*>(k_s);
    uint4* v_dst = reinterpret_cast<uint4*>(v_s);
    for (int x = tid; x < vecs; x += kThreads) {
      k_dst[x] = k_src[x];
      v_dst[x] = v_src[x];
    }
    __syncthreads();

    // scores: warp w takes key rows w, w + kWarps, ...; lanes split D
    for (int j = warp; j < block_size; j += kWarps) {
      float kv[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) kv[e] = to_float(k_s[j * D + lane * kPerLane + e]);
      const bool valid = i * block_size + j < len;
#pragma unroll
      for (int h = 0; h < kMaxG; ++h) {
        if (h < g) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < kPerLane; ++e) part += qr[h][e] * kv[e];
          part = warp_sum(part);
          if (lane == 0) p_s[h][j] = valid ? part * scale : kNegInf;
        }
      }
    }
    __syncthreads();

    // online softmax: warp w updates (m, l) of heads w, w + kWarps, ...
#pragma unroll
    for (int s = 0; s < kWarpHeads; ++s) {
      const int h = warp + s * kWarps;
      if (h < g) {
        float mx = kNegInf;
        for (int j = lane; j < block_size; j += 32) mx = fmaxf(mx, p_s[h][j]);
        const float m_new = fmaxf(m_run[s], warp_max(mx));
        const float alive = m_new > kNegInf * 0.5f ? 1.f : 0.f;
        const float m_safe = m_new * alive;
        float sum = 0.f;
        for (int j = lane; j < block_size; j += 32) {
          const float p = expf(p_s[h][j] - m_safe) * alive;
          p_s[h][j] = p;
          sum += p;
        }
        const float corr = expf(m_run[s] - m_safe) * alive;
        l_run[s] = l_run[s] * corr + warp_sum(sum);
        m_run[s] = m_new;
        if (lane == 0) corr_s[h] = corr;
      }
    }
    __syncthreads();

    // acc[h, col] = acc * corr[h] + sum_j p[h, j] * V[j, col]
#pragma unroll
    for (int o = 0; o < kOwn; ++o) {
      const int h = h_first + o * kHeadStep;
      if (h < g) acc[o] *= corr_s[h];
    }
    for (int j = 0; j < block_size; ++j) {
      const float v = to_float(v_s[j * D + col]);
#pragma unroll
      for (int o = 0; o < kOwn; ++o) {
        const int h = h_first + o * kHeadStep;
        if (h < g) acc[o] += p_s[h][j] * v;
      }
    }
    __syncthreads();  // k_s, v_s and p_s are rewritten by the next page
  }

#pragma unroll
  for (int s = 0; s < kWarpHeads; ++s) {
    const int h = warp + s * kWarps;
    if (h < g && lane == 0) l_s[h] = l_run[s];
  }
  __syncthreads();
#pragma unroll
  for (int o = 0; o < kOwn; ++o) {
    const int h = h_first + o * kHeadStep;
    if (h < g)
      store(out + ((size_t)b * hq + (size_t)kh * g + h) * D + col, acc[o] / fmaxf(l_s[h], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* lengths, void* out, int B, int Hkv, int NB, int BS,
                   int max_blocks, int g, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)BS * D * sizeof(T);
  auto kernel = paged_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const float scale = 1.0f / sqrtf((float)D);
  kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      lengths, static_cast<T*>(out), NB, BS, max_blocks, g, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Shapes are checked by the Python
// wrapper; what the kernel cannot take is refused here as well.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pages,
                                             const void* v_pages, const void* tables,
                                             const void* lengths, void* out, int B, int Hkv,
                                             int NB, int BS, int max_blocks, int g, int D,
                                             int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hkv > 65535 || g < 1 || g > kMaxG || BS < 8 || BS > kMaxBS ||
      BS % 8 != 0 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k_pages, v_pages, t, l, out, B, Hkv, NB, BS, max_blocks, g, s);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k_pages, v_pages, t, l, out, B, Hkv, NB, BS, max_blocks, g, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k_pages, v_pages, t, l, out, B, Hkv, NB, BS,
                                          max_blocks, g, s);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k_pages, v_pages, t, l, out, B, Hkv, NB, BS,
                                           max_blocks, g, s);
  return (int)cudaErrorInvalidValue;
}

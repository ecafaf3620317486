// Paged decode attention for NVIDIA Hopper (sm_90a), as split-K flash-decoding.
//
// Replaces ray_tpu/ops/paged_attention.py::_decode_kernel (the Pallas TPU
// kernel, pallas_call at :117). One query token per sequence attends over a
// KV cache kept in block_size-token pages scattered through a pool; a block
// table maps the sequence's i-th block to its page. Same result as the TPU
// kernel: softmax over the live keys in float32, pages at or past
// ceil(lengths[b] / BS) skipped, positions kpos >= lengths[b] masked to
// NEG_INF (the finite -1e30), a row is alive while its max is above
// NEG_INF / 2, output acc / max(l, 1e-30) in q's dtype, so a length-0 row
// gives zeros.
//
// Layouts: q [B, Hq, D]; k/v pages [Hkv, NB, BS, D] (head-major, one page is
// one contiguous [BS, D] tile); tables [B, max_blocks] int32; lengths [B]
// int32; out [B, Hq, D]. Query head h belongs to kv head h / g, g = Hq / Hkv.
// workspace: float32 partials of every split, acc [B, Hq, n_splits, D], then
// m and l [B, Hq, n_splits] each; only live splits are written and read.
//
// Bound: bytes. Per cached token the call does 4 * Hq * D flops on
// 4 * Hkv * D bytes of K and V in bf16, g flops a byte with g <= 8, far below
// what the card computes per byte. So it is done when every live K/V byte
// has been read once, and what stands in the way is latency: the TPU kernel
// walks a sequence's pages one after another (grid axis 2, "arbitrary"),
// carrying (m, l, acc) in VMEM, and one CTA per (sequence, kv head) doing
// that walk fills under half of the 132 SMs at batch 8 and waits on every
// page in turn. Here the walk becomes parallel work plus one merge:
//  - paged_split_kernel, grid (B, Hkv, n_splits): each CTA takes one run of
//    pages_per_split pages of one sequence (SplitTiles::kTokens tokens cut
//    to whole pages) and serves all g query heads of its kv head, so each
//    page is still read once for the group. n_splits = ceil(max_blocks /
//    pages_per_split) comes from the table's width on the host, never from
//    lengths; a CTA whose first page lies at or past the live pages exits
//    before it loads anything.
//  - loads in flight: each warp copies the K and V rows of its own 32-token
//    chunks with 16-byte cp.async, all of them issued before any compute,
//    K and V of each chunk in commit groups of their own, so the scores
//    start as soon as K has landed while V is still on its way. One lane
//    per page reads the page's table entry and passes it by shuffle. Rows
//    sit in shared memory with their 16-byte chunks XOR-swizzled, so the
//    lanes of a warp reading one row each hit distinct banks.
//  - no barrier per page: lane j of a warp takes key j of its chunk and
//    computes the g scores against q (float32 in shared memory, broadcast
//    reads); a chunk's max and sum cost two warp reductions per head per 32
//    keys; P goes to the warp's own row of shared memory, and the PV product
//    runs with lanes over D. Each warp keeps its float32 (m, l, acc[g, D])
//    in registers, each lane D / 32 columns of acc.
//  - the warps merge once, at the end, through shared memory, and the CTA
//    writes its split's partial (m, l, acc) to the workspace.
//  - paged_combine_kernel: one warp per (sequence, query head) reads the
//    live splits' partials and writes out = sum_s e^(m_s - m*) acc_s /
//    max(sum_s e^(m_s - m*) l_s, 1e-30), m* = max_s m_s, in q's dtype. A
//    length-0 row has no live split and gives zeros; a row with one live
//    split gets weight e^0 = 1, the unsplit result.
//  - head dims 16, 32, 64 and 128, a group of at most 8 (the kernel is
//    built for groups of 1, 2, 4 and 8, smaller groups padded with zero
//    rows of q), and any block size from 1 to 64: a page row of D >= 16
//    values is a whole number of 16-byte chunks.
// What still limits it (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py and
// scripts/torch_flash_ab.py --paged): the pair takes about 0.022 ms at the
// main path's lengths against a 0.003 ms byte bound. Across length sets its
// time grows by about 0.7 us per MB of K/V, so some 16 us of a call is fixed:
// two launches, the second waiting on the first; a CTA's chain of dependent
// steps (lengths, table entries, K, scores, V, PV, merge, partial); and the
// combine (about a fifth of the device time). In that chain the scores read
// q from shared memory (G * D floats per key, broadcast), since the lanes
// hold keys and not columns. A last-CTA merge with an atomic counter in
// place of the combine launch measured slower at 128-token splits.
//
// C interface (bound with ctypes): paged_decode_split_pages gives the pages a
// split holds; paged_decode_attention_launch returns the cudaError_t of the
// two launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kMaxG = 8;    // query heads per kv head
constexpr int kMaxBS = 64;  // tokens per page
constexpr float kNegInf = -1e30f;

// The split tile: the tokens one CTA takes (whole pages of at most kTokens
// tokens) and the warps that share them, 32 tokens a chunk. K and V of a
// split stay within kSmemBudget, so float32 at D 128 takes 64 tokens.
template <typename T, int D>
struct SplitTiles {
  static constexpr int kSmemBudget = 64 * 1024;
  static constexpr int kWantTokens = 128;
  static constexpr int kWantWarps = 4;
  static constexpr int kFit = kSmemBudget / (2 * D * (int)sizeof(T));
  static constexpr int kTokens = kWantTokens < kFit ? kWantTokens : kFit;
  static constexpr int kWarps = kWantWarps < kTokens / 32 ? kWantWarps : kTokens / 32;
  static constexpr int kChunks = kTokens / (32 * kWarps);  // 32-token chunks per warp
  static constexpr int kThreads = 32 * kWarps;
  // CTAs a SM holds by shared memory (K/V, plus ~8 KB of q, P and the
  // merge's m and l), for the register budget in __launch_bounds__
  static constexpr int kMinBlocks = (227 * 1024) / (kSmemBudget + 8 * 1024);
  static_assert(kTokens >= kMaxBS && kTokens % (32 * kWarps) == 0, "split tile");
  static_assert(2 * kChunks - 1 <= 7, "cp_async_wait takes at most 7 groups in flight");
};

constexpr int kCombineWarps = 4;

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

template <int kBytes> struct VecOf;
template <> struct VecOf<2> { using type = unsigned short; };
template <> struct VecOf<4> { using type = unsigned int; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

// kN consecutive values of T (one 2- to 16-byte load) as float32
template <typename T, int kN>
__device__ __forceinline__ void load_floats(float (&out)[kN], const T* p) {
  using V = typename VecOf<kN * sizeof(T)>::type;
  const V raw = *reinterpret_cast<const V*>(p);
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < kN; ++e) out[e] = to_float(t[e]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most n commit groups of this thread are in flight (n is a
// constant once the chunk loop is unrolled)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// A split's K (or V) rows in shared memory, [rows][D] in 16-byte chunks,
// chunk c of row r stored at c ^ f(r): the eight rows a quarter-warp reads
// at one chunk index land on eight distinct 16-byte bank groups.
template <typename T, int D>
struct RowLayout {
  static constexpr int kVec = 16 / (int)sizeof(T);  // values per chunk
  static constexpr int kChunks = D / kVec;          // chunks per row
  static constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;
  static constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  __device__ static __forceinline__ int at(int r, int c) {
    return (r * kChunks + (c ^ ((r / kRowsPerLine) & kMask))) * kVec;
  }
};

template <typename T, int D, int G>
__global__ void __launch_bounds__(SplitTiles<T, D>::kThreads, SplitTiles<T, D>::kMinBlocks)
paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages, const T* __restrict__ v_pages,
    const int* __restrict__ tables, const int* __restrict__ lengths, float* __restrict__ ws_acc,
    float* __restrict__ ws_m, float* __restrict__ ws_l, int num_pages_pool, int block_size,
    int max_blocks, int pages_per_split, int n_splits, int g, float scale) {
  using Tiles = SplitTiles<T, D>;
  using Row = RowLayout<T, D>;
  constexpr int kWarps = Tiles::kWarps, kChunks = Tiles::kChunks;
  constexpr int kCols = D >= 32 ? D / 32 : 1;  // PV columns a lane owns
  constexpr int kColBytes = kCols * (int)sizeof(T);

  extern __shared__ __align__(16) unsigned char smem[];  // K, V; then the warps' acc
  __shared__ __align__(16) float q_s[G * D];
  __shared__ __align__(16) float p_s[kWarps][32][G];     // each warp's P, key-major
  __shared__ float ml_s[kWarps][2][G];

  const int b = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int hq = gridDim.y * g;
  const int len = lengths[b];
  const int live_pages = len > 0 ? min((len + block_size - 1) / block_size, max_blocks) : 0;
  const int first_page = split * pages_per_split;
  if (first_page >= live_pages) return;  // a dead split: the combine never reads it
  const int n_pages = min(pages_per_split, live_pages - first_page);
  const int rows = n_pages * block_size;                         // rows loaded
  const int live_rows = min(len - first_page * block_size, rows);  // rows at positions < len
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)pages_per_split * block_size * D;
  const size_t page_elems = (size_t)block_size * D;
  const T* k_head = k_pages + (size_t)kh * num_pages_pool * page_elems;
  const T* v_head = v_pages + (size_t)kh * num_pages_pool * page_elems;
  const int* table_row = tables + (size_t)b * max_blocks + first_page;

  // every K and V row of this warp's chunks in flight before any compute:
  // groups K0, V0, K1, V1, ...
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int r0 = (warp * kChunks + i) * 32;
    const int p0 = r0 / block_size;  // the chunk's rows lie in at most 32 pages
    const int my_page = p0 + lane < n_pages ? table_row[p0 + lane] : 0;
    // lane l finds where row r0 + l starts in the head's pages
    const int pl = (r0 + lane) / block_size;
    const long long row_off =
        (long long)__shfl_sync(0xffffffffu, my_page, (pl - p0) & 31) * (long long)page_elems +
        (long long)(r0 + lane - pl * block_size) * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const T* src = half ? v_head : k_head;
      T* dst = half ? v_s : k_s;
#pragma unroll
      for (int it = 0; it < Row::kChunks; ++it) {  // 32 rows of kChunks chunks, 32 lanes
        const int x = lane + 32 * it;
        const int rr = x / Row::kChunks, c = x % Row::kChunks;
        const long long off = __shfl_sync(0xffffffffu, row_off, rr);
        if (r0 + rr < rows) cp_async16(dst + Row::at(r0 + rr, c), src + off + c * Row::kVec);
      }
      cp_async_commit();
    }
  }

  // the group's query rows in float32; rows g..G-1 are zeros
  for (int x = tid; x < G * D; x += Tiles::kThreads) {
    const int h = x / D;
    q_s[x] = h < g ? to_float(q[((size_t)b * hq + (size_t)kh * g) * D + x]) : 0.f;
  }
  __syncthreads();

  float m_run[G], l_run[G], acc[G][kCols];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m_run[h] = kNegInf;
    l_run[h] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[h][c] = 0.f;
  }
  const bool lane_cols = lane * kCols < D;  // false only for lanes 16-31 at D 16
  const int col_chunk = lane * kColBytes / 16, col_in = (lane * kColBytes % 16) / (int)sizeof(T);

#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int r0 = (warp * kChunks + i) * 32;
    const int n_valid = min(32, live_rows - r0);  // keys of this chunk at positions < len
    if (n_valid <= 0) continue;                   // warp-uniform
    cp_async_wait(2 * (kChunks - i) - 1);         // K of chunk i has landed
    __syncwarp();

    // scores: lane j takes key r0 + j
    const int r = r0 + lane;
    float s[G];
#pragma unroll
    for (int h = 0; h < G; ++h) s[h] = 0.f;
#pragma unroll
    for (int c = 0; c < Row::kChunks; ++c) {
      float kf[Row::kVec];
      load_floats<T, Row::kVec>(kf, k_s + Row::at(r, c));
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float4* qv = reinterpret_cast<const float4*>(q_s + h * D + c * Row::kVec);
#pragma unroll
        for (int e = 0; e < Row::kVec / 4; ++e) {
          const float4 qq = qv[e];
          s[h] += qq.x * kf[4 * e] + qq.y * kf[4 * e + 1] + qq.z * kf[4 * e + 2] +
                  qq.w * kf[4 * e + 3];
        }
      }
    }
    const bool valid = lane < n_valid;

    // online softmax over the chunk, head by head
#pragma unroll
    for (int h = 0; h < G; ++h) {
      const float sc = valid ? s[h] * scale : kNegInf;
      const float m_new = fmaxf(m_run[h], warp_max(sc));
      const bool alive = m_new > kNegInf * 0.5f;
      const float m_safe = alive ? m_new : 0.f;
      const float p = alive ? expf(sc - m_safe) : 0.f;
      const float corr = alive ? expf(m_run[h] - m_safe) : 0.f;
      l_run[h] = l_run[h] * corr + warp_sum(p);
      m_run[h] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[h][c] *= corr;
      p_s[warp][lane][h] = p;
    }
    cp_async_wait(2 * (kChunks - i) - 2);  // V of chunk i has landed
    __syncwarp();

    // acc[h, cols] += sum_j p[h, j] V[r0 + j, cols], lanes over D
    if (lane_cols) {
#pragma unroll 4
      for (int j = 0; j < n_valid; ++j) {
        float vf[kCols];
        load_floats<T, kCols>(vf, v_s + Row::at(r0 + j, col_chunk) + col_in);
        float p[G];
        if constexpr (G % 4 == 0) {
#pragma unroll
          for (int h = 0; h < G; h += 4) {
            const float4 pp = *reinterpret_cast<const float4*>(&p_s[warp][j][h]);
            p[h] = pp.x, p[h + 1] = pp.y, p[h + 2] = pp.z, p[h + 3] = pp.w;
          }
        } else {
#pragma unroll
          for (int h = 0; h < G; ++h) p[h] = p_s[warp][j][h];
        }
#pragma unroll
        for (int h = 0; h < G; ++h)
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[h][c] += p[h] * vf[c];
      }
    }
    __syncwarp();  // p_s is rewritten by the next chunk
  }

  // merge the warps: their acc goes where K and V were
  cp_async_wait(0);
  __syncthreads();
  float* acc_s = reinterpret_cast<float*>(smem);  // [kWarps][G][D]
  if (lane_cols) {
#pragma unroll
    for (int h = 0; h < G; ++h)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc_s[(warp * G + h) * D + lane * kCols + c] = acc[h][c];
  }
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      ml_s[warp][0][h] = m_run[h];
      ml_s[warp][1][h] = l_run[h];
    }
  }
  __syncthreads();
  for (int x = tid; x < g * D; x += Tiles::kThreads) {
    const int h = x / D, d = x % D;
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, ml_s[w][0][h]);
    const bool alive = m > kNegInf * 0.5f;
    const float m_safe = alive ? m : 0.f;
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = alive ? expf(ml_s[w][0][h] - m_safe) : 0.f;
      a += wt * acc_s[(w * G + h) * D + d];
      l += wt * ml_s[w][1][h];
    }
    const size_t row = ((size_t)b * hq + (size_t)kh * g + h) * n_splits + split;
    ws_acc[row * D + d] = a;
    if (d == 0) {
      ws_m[row] = m;
      ws_l[row] = l;
    }
  }
}

// out[b, h] from the live splits' partials; one warp per (b, query head),
// lanes over D
template <typename T, int D>
__global__ void __launch_bounds__(32 * kCombineWarps) paged_combine_kernel(
    const float* __restrict__ ws_acc, const float* __restrict__ ws_m,
    const float* __restrict__ ws_l, const int* __restrict__ lengths, T* __restrict__ out,
    int n_rows, int hq, int block_size, int max_blocks, int pages_per_split, int n_splits) {
  constexpr int kCols = D >= 32 ? D / 32 : 1;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kCombineWarps + (threadIdx.x >> 5);  // b * hq + h
  if (row >= n_rows) return;
  const int len = lengths[row / hq];
  const int live_pages = len > 0 ? min((len + block_size - 1) / block_size, max_blocks) : 0;
  const int live = (live_pages + pages_per_split - 1) / pages_per_split;
  const float* m_row = ws_m + (size_t)row * n_splits;
  const float* l_row = ws_l + (size_t)row * n_splits;
  const float* acc_row = ws_acc + (size_t)row * n_splits * D + lane * kCols;

  float m = kNegInf;
  for (int s = lane; s < live; s += 32) m = fmaxf(m, m_row[s]);
  m = warp_max(m);
  const bool alive = m > kNegInf * 0.5f;
  const float m_safe = alive ? m : 0.f;
  const bool lane_cols = lane * kCols < D;
  float a[kCols], l = 0.f;
#pragma unroll
  for (int c = 0; c < kCols; ++c) a[c] = 0.f;
#pragma unroll 4
  for (int s = 0; s < live; ++s) {
    const float wt = alive ? expf(m_row[s] - m_safe) : 0.f;
    l += wt * l_row[s];
    if (lane_cols) {
      float v[kCols];
      load_floats<float, kCols>(v, acc_row + (size_t)s * D);
#pragma unroll
      for (int c = 0; c < kCols; ++c) a[c] += wt * v[c];
    }
  }
  if (lane_cols) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(out + (size_t)row * D + lane * kCols + c, a[c] * inv);
  }
}

template <typename T, int D>
int split_pages(int BS) {
  return SplitTiles<T, D>::kTokens / BS;
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables,
                   const int* lengths, void* out, float* ws, int B, int Hkv, int NB, int BS,
                   int max_blocks, int n_splits, int g, cudaStream_t stream) {
  using Tiles = SplitTiles<T, D>;
  const int pps = split_pages<T, D>(BS);
  if (n_splits < 1 || n_splits > 65535 || (long long)n_splits * pps < max_blocks)
    return cudaErrorInvalidValue;
  const size_t kv = 2 * (size_t)pps * BS * D * sizeof(T);
  const size_t merge = (size_t)Tiles::kWarps * G * D * sizeof(float);
  const size_t smem = kv > merge ? kv : merge;
  auto kernel = paged_split_kernel<T, D, G>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int hq = Hkv * g;
  const size_t parts = (size_t)B * hq * n_splits;
  float* ws_acc = ws;
  float* ws_m = ws_acc + parts * D;
  float* ws_l = ws_m + parts;
  kernel<<<dim3(B, Hkv, n_splits), Tiles::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), tables,
      lengths, ws_acc, ws_m, ws_l, NB, BS, max_blocks, pps, n_splits, g,
      1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_rows = B * hq;
  paged_combine_kernel<T, D><<<(n_rows + kCombineWarps - 1) / kCombineWarps,
                               32 * kCombineWarps, 0, stream>>>(
      ws_acc, ws_m, ws_l, lengths, static_cast<T*>(out), n_rows, hq, BS, max_blocks, pps,
      n_splits);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_group(const void* q, const void* k, const void* v, const int* tables,
                         const int* lengths, void* out, float* ws, int B, int Hkv, int NB,
                         int BS, int max_blocks, int n_splits, int g, cudaStream_t stream) {
  if (g == 1)
    return launch<T, D, 1>(q, k, v, tables, lengths, out, ws, B, Hkv, NB, BS, max_blocks,
                           n_splits, g, stream);
  if (g == 2)
    return launch<T, D, 2>(q, k, v, tables, lengths, out, ws, B, Hkv, NB, BS, max_blocks,
                           n_splits, g, stream);
  if (g <= 4)
    return launch<T, D, 4>(q, k, v, tables, lengths, out, ws, B, Hkv, NB, BS, max_blocks,
                           n_splits, g, stream);
  return launch<T, D, kMaxG>(q, k, v, tables, lengths, out, ws, B, Hkv, NB, BS, max_blocks,
                             n_splits, g, stream);
}

}  // namespace

// Pages one split holds at this block size, head dim and dtype (0 = float32,
// 1 = bfloat16); 0 for what the kernel does not take. The wrapper sizes the
// workspace and n_splits from it.
extern "C" int paged_decode_split_pages(int BS, int D, int dtype) {
  if (BS < 1 || BS > kMaxBS) return 0;
#define PAGED_SPLIT(T, DIM) \
  if (D == DIM) return split_pages<T, DIM>(BS);
  if (dtype == 0) {
    PAGED_SPLIT(float, 16) PAGED_SPLIT(float, 32) PAGED_SPLIT(float, 64) PAGED_SPLIT(float, 128)
  }
  if (dtype == 1) {
    PAGED_SPLIT(__nv_bfloat16, 16) PAGED_SPLIT(__nv_bfloat16, 32)
    PAGED_SPLIT(__nv_bfloat16, 64) PAGED_SPLIT(__nv_bfloat16, 128)
  }
#undef PAGED_SPLIT
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. workspace: float32, B * Hq * n_splits *
// (D + 2) values. Shapes are checked by the Python wrapper; what the kernel
// cannot take is refused here as well.
extern "C" int paged_decode_attention_launch(const void* q, const void* k_pages,
                                             const void* v_pages, const void* tables,
                                             const void* lengths, void* out, void* workspace,
                                             int B, int Hkv, int NB, int BS, int max_blocks,
                                             int n_splits, int g, int D, int dtype,
                                             void* stream) {
  if (B <= 0 || Hkv <= 0 || Hkv > 65535 || g < 1 || g > kMaxG || BS < 1 || BS > kMaxBS ||
      max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(tables);
  const int* l = static_cast<const int*>(lengths);
  float* ws = static_cast<float*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAGED_DISPATCH(T, DIM)                                                              \
  if (D == DIM)                                                                             \
    return (int)launch_group<T, DIM>(q, k_pages, v_pages, t, l, out, ws, B, Hkv, NB, BS,    \
                                     max_blocks, n_splits, g, s);
  if (dtype == 0) {
    PAGED_DISPATCH(float, 16) PAGED_DISPATCH(float, 32)
    PAGED_DISPATCH(float, 64) PAGED_DISPATCH(float, 128)
  }
  if (dtype == 1) {
    PAGED_DISPATCH(__nv_bfloat16, 16) PAGED_DISPATCH(__nv_bfloat16, 32)
    PAGED_DISPATCH(__nv_bfloat16, 64) PAGED_DISPATCH(__nv_bfloat16, 128)
  }
#undef PAGED_DISPATCH
  return (int)cudaErrorInvalidValue;
}

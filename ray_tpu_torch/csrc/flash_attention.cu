// Flash attention forward and backward for NVIDIA Hopper (sm_90a).
//
// Replaces the three Pallas TPU kernels of ray_tpu/ops/flash_attention.py:
//   flash_fwd_bf16_kernel,
//   flash_fwd_f32_kernel <- _fwd_kernel     (:33)  O and the row logsumexp
//   flash_bwd_dq_bf16_kernel,
//   flash_bwd_dq_f32_kernel <- _bwd_dq_kernel (:102) dQ = sum_k dS K
//   flash_bwd_dkv_bf16_kernel,
//   flash_bwd_dkv_f32_kernel <- _bwd_dkv_kernel (:136) dV = sum_q P^T dO, dK = sum_q dS^T Q
// with the reference's rules: scores S = Q K^T * scale in float32, NEG_INF is
// the finite -1e30, a row is alive while its max is above NEG_INF / 2, keys at
// or past S and (causal) keys after the query are masked, a dead row gives
// zeros and lse = NEG_INF. The backward recomputes P = exp(S - lse) and
// dS = P * (dO V^T - delta) * scale, delta = rowsum(dO * O) coming in.
//
// Layouts: q, o, dO, dq [B, S, Hq, D]; k, v, dk, dv [B, S, Hkv, D], each read
// or written through its (batch, seq, head) strides with unit stride over D;
// lse and delta [B, Hq, S] float32. Query head h uses kv head h / g. The
// kernels take head dims 64, 128 and 256; the Python wrapper zero-pads any
// other head dim up to 256 to the next of them and passes the caller's head
// dim, from which the launchers take the scale 1/sqrt(head dim).
//
// Head dim 256 (Gemma-style models) in bf16, the column split: each
// thread's float32 accumulators (O in the forward, dQ, dK and dV) would
// double from D 128's, 128 registers a thread for dK and dV alone, with
// S, dP and the fragments on top, past the 255 a thread may hold. So the
// grid's x axis carries two CTAs per head (ColumnSplit), each loading the
// full-D Q and K (and dO and V in the backward) it needs, forming the full
// products S = Q K^T and dP = dO V^T, so the softmax statistics and dS are
// whole, and accumulating only its half of the output columns. A thread
// then holds D 128's accumulators; the cost is a second QK^T (and dO V^T)
// per tile pair and K/V tiles of 33 KB per 64 rows in shared memory. The
// forward reads Q's fragments from shared memory per use at D 256 (64 more
// registers otherwise) and loads only its half of V.
//
// Bound: operations. At the training shapes (B 4, S 2048, Hq 32, Hkv 8, D 64,
// causal) the forward does 4 * B * Hq * D * S (S + 1) / 2 flops on ~85 MB, the
// backward 3 and 4 such products, all far above the card's flops per byte. So
// the design keeps every S x S tile on chip and puts the products on the
// tensor cores.
//
// bf16 forward (flash_fwd_bf16_kernel), the FlashAttention-2 layout:
//  - one CTA per (q tile of 128 rows, q head, batch). Each warp owns whole
//    m16 slabs of rows and runs the k loop for them alone, so the online
//    softmax needs no exchange between warps: at D 64, 4 warps of 32 rows
//    (two slabs), so each K and V fragment read from shared memory feeds
//    two products; at D 128, 8 warps of 16 rows, since two slabs would need
//    more than 255 registers. The grid puts the q tile on its slowest axis,
//    reversed, so the longest causal tiles of every head start first and
//    the shortest form the tail.
//  - Q goes to shared memory once by cp.async and then lives in registers as
//    ldmatrix.x4 A fragments. K and V tiles of 64 keys stream through a
//    two-stage cp.async.cg ring: tile j + 1 is copied while tile j is
//    multiplied, and the copy zero-fills rows at or past S (src-size 0). One
//    __syncthreads per tile both publishes tile j and frees the stage of
//    tile j - 1 for tile j + 1. Rows are padded by 16 bytes so that the
//    eight row addresses of each ldmatrix fall on distinct banks.
//  - S = Q K^T by mma.sync.m16n8k16 (bf16 in, float32 accumulate), with K's
//    B fragments from ldmatrix; S stays in C fragments (each thread holds
//    rows lane / 4 and lane / 4 + 8 of a slab). The softmax runs on the
//    fragments: the row max of the raw scores and the row sum reduce over
//    the four lanes of a quad (two __shfl_xor_sync each), and P = 2^(s c -
//    m c) with c = scale log2 e, one FMA and one ex2.approx per score. m, l
//    and the O accumulator are float32 registers, O rescaled in registers.
//    The mask is applied only on tiles that cross the diagonal or the ragged
//    end, and a warp skips a causal tile whose keys all follow its rows.
//  - O += P V: P's C fragments are rounded to bf16 pairs and two adjacent n8
//    tiles form one k16 A fragment, so P never leaves registers; V's B
//    fragments come from ldmatrix.x4.trans of the row-major V tile.
//  - epilogue: O / max(l, 1e-30) rounded to bf16 and stored from the
//    fragments as bf16 pairs; lse = m scale + ln l in natural log.
//  - what still holds it back against the bound: the bound assumes the
//    wgmma rate, which mma.sync does not reach; each tile's softmax (FMA,
//    ex2, max, sum, rescale, pack) is issued by the same warps between the
//    two products, and only one K/V tile is in flight. The next steps are
//    wgmma from a TMA ring with warp specialisation (producer warp, two
//    consumer warpgroups overlapping softmax and products) and a persistent
//    grid.
//
// bf16 dK/dV (flash_bwd_dkv_bf16_kernel), the FlashAttention-2 backward
// with the keys as the M dimension, so nothing of S leaves registers:
//  - one CTA per (k tile of 64 keys, kv head, batch), 4 warps, each owning
//    one m16 slab of keys. The grid puts the k tile on its slowest axis,
//    ascending, so the CTAs with the most causal q tiles start first. K and
//    V of the tile are copied once by cp.async; at D 64 each warp then holds
//    its slab's K and V as ldmatrix.x4 A fragments (m = keys, k = D); at D
//    128 those would not fit beside the accumulators and are read from
//    shared memory per use.
//  - the CTA loops over the g query heads of its group and, for each, over
//    the q tiles from the diagonal on (64 queries at D 64, 32 at D 128), so
//    the GQA sum over the group (the adjoint of the JAX wrapper's KV repeat)
//    happens in the accumulators: no atomics, no [B, S, Hq, D] buffer. Q,
//    dO, lse and delta of a q tile stream through a two-stage cp.async ring
//    (zero-filled past S), with one __syncthreads per tile as in the
//    forward.
//  - a q tile is taken 16 queries at a time. lse comes in, so P^T needs no
//    reduction over the tile, and only one chunk's S^T and dP^T are live:
//    16 registers where the whole tile's would take 64. That keeps the D 64
//    kernel at 3 CTAs (12 warps) a SM, which hides more latency than two
//    CTAs of the whole-tile layout did.
//  - S^T = K Q^T and dP^T = V dO^T by mma.sync.m16n8k16, the B fragments by
//    ldmatrix.x4 of the row-major Q and dO tiles. In the C fragments a
//    thread holds keys lane / 4 and + 8 and queries 2 (lane % 4) and + 1 of
//    each n8 tile, so it reads lse and delta of those queries only, as
//    float2 from the ring stage.
//  - P^T = 2^(s c - lse log2 e), c = scale log2 e, one FMA and one ex2 per
//    score; a dead query (lse NEG_INF) takes NEG_INF in place of -lse
//    log2 e, so its P is 2^(-huge) = 0 as the reference's alive factor
//    gives (the plain exponent would overflow to +inf). The mask is applied
//    only on chunks that cross the diagonal or where the warp holds keys
//    past S, and a warp skips a chunk whose queries all precede its keys.
//    Queries past S are zero-filled Q and dO rows with lse = delta = 0, so
//    they add exact zeros.
//  - dS^T = P^T (dP^T - delta) scale in registers. P^T and dS^T are rounded
//    to bf16 pairs, the chunk's two n8 tiles forming one k16 A fragment, and
//    dV += P^T dO, dK += dS^T Q take their B fragments from ldmatrix.x4.trans
//    of the same Q and dO stage. dK and dV stay float32 C fragments for the
//    whole CTA and are stored as bf16 pairs; keys past S are not stored.
//  - what still holds it back against the bound: mma.sync rather than
//    wgmma; the exponentials and dS of each chunk are issued by the same
//    warps between the products; and every warp reads the whole Q and dO
//    tile from shared memory twice per q tile (ldmatrix and .trans), 32 KB
//    for its four 16 x 64 x 64 products at D 64 (16 flops a byte), which
//    shared memory's 128 bytes a cycle cannot feed at the tensor-core rate.
//    Two key slabs a warp would halve those reads only with both slabs' K
//    and V resident, 64 more registers than the accumulators leave.
//
// bf16 dQ (flash_bwd_dq_bf16_kernel), the FlashAttention-2 dQ with the
// queries as the M dimension, as in the forward:
//  - one CTA per (q tile of 64 rows, q head, batch), 4 warps, each owning
//    one m16 slab of rows and running the whole k loop for it. The grid puts
//    the q tile on its slowest axis, reversed, as the forward does.
//  - Q and dO of the tile are copied once by cp.async; at D 64 each warp
//    then holds its slab's Q and dO as ldmatrix.x4 A fragments, at D 128
//    (where those would not fit beside the accumulator, S and dP) they are
//    read from shared memory per use. The slab's lse and delta are read once
//    into registers: a thread needs rows lane / 4 and + 8 only.
//  - K and V tiles of 64 keys stream through the forward's two-stage
//    cp.async ring (zero-filled past S, one __syncthreads per tile).
//  - S = Q K^T and dP = dO V^T by mma.sync, K's and V's B fragments from
//    ldmatrix; both stay in C fragments. P = 2^(s c - lse log2 e), one FMA
//    and one ex2 per score, a dead row (lse NEG_INF) taking NEG_INF in place
//    of -lse log2 e as in dK/dV. The mask is applied only on tiles that cross
//    the diagonal or the ragged end, and a warp skips a tile whose keys all
//    follow its rows.
//  - dS = P (dP - delta) scale in registers, rounded to bf16 pairs, two n8
//    tiles forming one k16 A fragment, and dQ += dS K takes K's B fragments
//    from ldmatrix.x4.trans of the same K stage. dQ stays float32 in C
//    fragments until the epilogue stores it as bf16 pairs (rows past S are
//    not stored).
//  - what still holds it back against the bound: mma.sync rather than
//    wgmma, the exponentials and dS issued by the same warps between the
//    products, and one K/V tile in flight. delta = rowsum(dO * O) is still a
//    PyTorch reduction before the call.
//
// float32 (flash_fwd_f32_kernel, flash_bwd_dq_f32_kernel,
// flash_bwd_dkv_f32_kernel) keeps the first design, a block GEMM through
// shared memory on the CUDA cores, exact float32 throughout (mma.sync has no
// float32 product, and float32 is a checking type):
//  - forward: one CTA per (q tile, q head, batch) loops over the k tiles up
//    to the diagonal (causal), carrying m, l and the accumulator in shared
//    memory. The TPU kernel carries them in scratch along a sequential grid
//    axis; here the loop is inside the CTA and needs no cross-CTA reduction.
//  - dQ: one CTA per (q tile, q head, batch), looping over k tiles up to the
//    diagonal.
//  - dK/dV: one CTA per (k tile, kv head, batch), looping over the group's
//    q heads and q tiles as the bf16 kernel does.
//  - no repeat and no padding: heads map by index, rows past S load as zeros
//    and are masked (keys) or not stored (queries).
//
// C interface (bound with ctypes): each *_launch returns the cudaError_t of
// its launch (0 on success). `strides` points to host int64 triples
// (batch, seq, head) of the strided tensors, in argument order.
// flash_fwd_smem_bytes, flash_bwd_dq_smem_bytes and flash_bwd_dkv_smem_bytes
// report a forward, dQ or dK/dV CTA's dynamic shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.442695040888963407f;

struct Strides {
  long long b, s, h;
};

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// Tile sizes and padded shared-memory row lengths of the float32 kernels.
// Rows are padded by 16 bytes so that row loads spread over the banks; every
// buffer starts on a 128-byte boundary. Their accumulators live in shared
// memory, so D 256 needs no column split, only q tiles of 32 rows to fit.
template <typename T, int D>
struct Tiles {
  static constexpr int BQ = D > 128 ? 32 : 64;  // D 256: 213 KB for dK/dV at 32
  static constexpr int BK = 32;
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
  // float32 forward: q, k, v, s, p, acc, m, l, corr
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

// C[M][N] (+)= sum_k A(m, k) B(k, n), all in shared memory, float32.
// A(m, k) = A[m * lda + k], or A[k * lda + m] with kColA (a transposed read);
// B(k, n) = B[k * ldb + n], or B[n * ldb + k] with kColB.
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

// ------------------------------------------------------------------ bf16 forward
// Register-level tensor-core helpers (PTX): cp.async copies, ldmatrix
// fragment loads and the m16n8k16 bf16 product with float32 accumulation.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with `valid` false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i,
// and thread t receives, of each, row t / 4 at columns 2 (t % 4) and + 1
// (with .trans: rows 2 (t % 4) and + 1 at column t / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8]. a: rows (0-7, k 0-7), (8-15, k 0-7),
// (0-7, k 8-15), (8-15, k 8-15), each thread row t / 4, k 2 (t % 4) and + 1;
// b: k 2 (t % 4), + 1 (b0) and + 8, + 9 (b1) at n t / 4; c: row t / 4 (c0,
// c1) and t / 4 + 8 (c2, c3) at n 2 (t % 4) and + 1.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (relative error about 2^-22); 2^(-huge)
// is 0, so masked scores need no separate zeroing.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The column split of head dims above 128 (all three bf16 kernels): a CTA
// accumulates DO = D / 2 of the output's columns, and the grid's x axis
// carries kHalves CTAs per head. Each CTA still forms the full-D products
// S = Q K^T (and dP = dO V^T), so its softmax statistics and dS are whole,
// and only its half of O, dQ, dK or dV is held: a thread keeps D 128's
// accumulators at D 256. At D 64 and 128, DO = D and kHalves = 1.
template <int D>
struct ColumnSplit {
  static constexpr int DO = D > 128 ? D / 2 : D;
  static constexpr int kHalves = D / DO;
  static_assert(DO % 16 == 0 && DO * kHalves == D, "whole k16 steps a half");
};

// Tiles of the bf16 forward: 128 query rows, 64 keys, rows padded by 16
// bytes; shared memory holds Q, then K and V of two stages (V only this
// CTA's DO columns). Each warp owns kSlabs m16 slabs of rows, so every K and
// V fragment it loads from shared memory feeds kSlabs products: two at D 64
// (4 warps), one at D 128 and 256 (8 warps), where two would need more than
// 255 registers. Q lives in registers up to D 128; at D 256 its fragments
// (64 registers) are read from shared memory per use.
template <int D>
struct FwdTiles {
  static constexpr int DO = ColumnSplit<D>::DO;
  static constexpr int kHalves = ColumnSplit<D>::kHalves;
  static constexpr int kSlabs = D == 64 ? 2 : 1;
  static constexpr int BQ = 128;
  static constexpr int BK = 64;
  static constexpr int kThreads = 32 * BQ / (16 * kSlabs);
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;  // D 128: 8 warps of ~200 registers
  static constexpr bool kResidentQ = D <= 128;
  static constexpr int LD = D + 8;    // Q and K rows
  static constexpr int LDV = DO + 8;  // V rows
  static constexpr size_t q_bytes = (size_t)BQ * LD * sizeof(bf16);
  static constexpr size_t k_elems = (size_t)BK * LD;
  static constexpr size_t stage_elems = k_elems + (size_t)BK * LDV;  // K, then V
  static constexpr size_t smem = q_bytes + 2 * stage_elems * sizeof(bf16);
};

// Rows [row0, row0 + R) of one head into a [R][LD] shared tile by cp.async,
// 16 bytes a copy from NT threads; rows at or past S are zero-filled by the
// copy itself.
template <int R, int D, int LD, int NT>
__device__ __forceinline__ void cp_async_tile(bf16* dst, const bf16* head, long long row_stride,
                                              int row0, int S) {
  constexpr int kChunks = D / 8;
  static_assert(R * kChunks % NT == 0, "every thread copies the same count");
#pragma unroll
  for (int i = 0; i < R * kChunks / NT; ++i) {
    const int x = threadIdx.x + i * NT;
    const int r = x / kChunks, c = x % kChunks * 8;
    const bool in = row0 + r < S;
    cp_async16(dst + r * LD + c, head + (in ? row0 + r : 0) * row_stride + c, in);
  }
}

template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, FwdTiles<D>::kMinBlocks) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
    Strides so, int S, int g, int causal, float scale) {
  using L = FwdTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD, LDV = L::LDV, NT = L::kThreads;
  constexpr int MS = L::kSlabs, DO = L::DO;
  constexpr int KD = D / 16;   // k16 steps of Q K^T
  constexpr int NS = BK / 8;   // n8 score tiles of one k tile
  constexpr int NO = DO / 8;   // n8 output tiles of this CTA's columns
  constexpr int KR = L::kResidentQ ? KD : 1;
  static_assert(KD % 2 == 0 && NO % 2 == 0 && BK % 16 == 0, "x4 loads take pairs");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = reinterpret_cast<bf16*>(smem + L::q_bytes);  // stage t: K, then V

  // blocks start in x-fastest order: every (head, half, batch) of the last q
  // tile first, so the longest causal tiles lead and the shortest form the tail
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, b = blockIdx.y;
  const int h = blockIdx.x / L::kHalves, col0 = blockIdx.x % L::kHalves * DO;
  const int hq = gridDim.x / L::kHalves, kh = h / g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_r0 = 16 * MS * warp;  // this warp's rows: q0 + warp_r0 .. + 16 MS - 1
  const int warp_q0 = q0 + warp_r0;
  const int row0 = warp_q0 + lane / 4;  // this thread's rows: row0 + 16 i and + 8
  const int col_t = 2 * (lane % 4);     // its first column in each n8 tile
  const float scale_log2 = scale * kLog2e;
  const bf16* k_head = k + b * sk.b + kh * sk.h;
  const bf16* v_head = v + b * sv.b + kh * sv.h + col0;  // this CTA's V columns
  const int n_k = causal ? (min(q0 + BQ, S) - 1) / BK + 1 : (S + BK - 1) / BK;

  cp_async_tile<BQ, D, LD, NT>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, S);
  cp_async_tile<BK, D, LD, NT>(kv_s, k_head, sk.s, 0, S);
  cp_async_tile<BK, DO, LDV, NT>(kv_s + L::k_elems, v_head, sv.s, 0, S);
  cp_async_commit();

  uint32_t qf[MS][KR][4];
  float acc[MS][NO][4];
  float m[MS][2], l[MS][2];  // per row: the max raw score (unscaled), the sum
#pragma unroll
  for (int i = 0; i < MS; ++i) {
#pragma unroll
    for (int n = 0; n < NO; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
    m[i][0] = m[i][1] = kNegInf;
    l[i][0] = l[i][1] = 0.f;
  }

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    // Tile kt is the only copy in flight. After the barrier it is visible to
    // every warp, and every warp is done with tile kt - 1, whose stage the
    // copy of tile kt + 1 then reuses.
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_k) {
      bf16* next = kv_s + ((kt + 1) & 1) * L::stage_elems;
      cp_async_tile<BK, D, LD, NT>(next, k_head, sk.s, k0 + BK, S);
      cp_async_tile<BK, DO, LDV, NT>(next + L::k_elems, v_head, sv.s, k0 + BK, S);
      cp_async_commit();
    }
    if (L::kResidentQ && kt == 0) {
#pragma unroll
      for (int i = 0; i < MS; ++i)
#pragma unroll
        for (int kd = 0; kd < KR; ++kd)
          ldsm_x4(qf[i][kd], q_s + (warp_r0 + 16 * i + lane % 16) * LD + kd * 16 + lane / 16 * 8);
    }
    if (causal && k0 > warp_q0 + 16 * MS - 1) continue;  // every key follows every row here
    const bf16* k_st = kv_s + (kt & 1) * L::stage_elems;
    const bf16* v_st = k_st + L::k_elems;

    // S = Q K^T: one x4 load gives the B fragments of two k16 steps
    float s[MS][NS][4];
#pragma unroll
    for (int i = 0; i < MS; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; kd += 2) {
      uint32_t qa[MS][2][4];
#pragma unroll
      for (int i = 0; i < MS; ++i)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if constexpr (L::kResidentQ) {
#pragma unroll
            for (int y = 0; y < 4; ++y) qa[i][x][y] = qf[i][kd + x][y];
          } else {
            ldsm_x4(qa[i][x],
                    q_s + (warp_r0 + 16 * i + lane % 16) * LD + (kd + x) * 16 + lane / 16 * 8);
          }
        }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t bk[4];
        ldsm_x4(bk, k_st + (8 * j + lane % 8) * LD + kd * 16 + lane / 8 * 8);
#pragma unroll
        for (int i = 0; i < MS; ++i) {
          mma_bf16(s[i][j], qa[i][0], bk[0], bk[1]);
          mma_bf16(s[i][j], qa[i][1], bk[2], bk[3]);
        }
      }
    }

    // online softmax on the fragments. The max is taken over raw scores
    // (scale > 0 keeps the order); P = 2^(s scale log2 e - m scale log2 e).
    if (k0 + BK > S || (causal && k0 + BK - 1 > warp_q0)) {
#pragma unroll
      for (int i = 0; i < MS; ++i)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!key_live(row0 + 16 * i + (e & 2) * 4, k0 + 8 * j + col_t + (e & 1), S, causal))
              s[i][j][e] = kNegInf;
    }
#pragma unroll
    for (int i = 0; i < MS; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[i][r];
#pragma unroll
        for (int j = 0; j < NS; ++j) mx = fmaxf(mx, fmaxf(s[i][j][2 * r], s[i][j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // a dead row (no live key yet) keeps m = NEG_INF: its P and its
        // correction are 2^(-huge) = 0, as the reference's alive factor gives
        const float m_scaled = mx > kNegInf * 0.5f ? mx * scale_log2 : 0.f;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            s[i][j][e] = ex2(fmaf(s[i][j][e], scale_log2, -m_scaled));
            sum += s[i][j][e];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float corr = ex2(fmaf(m[i][r], scale_log2, -m_scaled));
        l[i][r] = l[i][r] * corr + sum;
        m[i][r] = mx;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[i][n][2 * r] *= corr;
          acc[i][n][2 * r + 1] *= corr;
        }
      }

    // O += P V: score tiles 2t and 2t + 1 are the A fragment of k16 step t;
    // one transposed x4 load gives the B fragments of two n8 output tiles
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      uint32_t a[MS][4];
#pragma unroll
      for (int i = 0; i < MS; ++i) {
        a[i][0] = pack_bf16(s[i][2 * t][0], s[i][2 * t][1]);
        a[i][1] = pack_bf16(s[i][2 * t][2], s[i][2 * t][3]);
        a[i][2] = pack_bf16(s[i][2 * t + 1][0], s[i][2 * t + 1][1]);
        a[i][3] = pack_bf16(s[i][2 * t + 1][2], s[i][2 * t + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, v_st + (16 * t + lane % 16) * LDV + n * 8 + lane / 16 * 8);
#pragma unroll
        for (int i = 0; i < MS; ++i) {
          mma_bf16(acc[i][n], a[i], bv[0], bv[1]);
          mma_bf16(acc[i][n + 1], a[i], bv[2], bv[3]);
        }
      }
    }
  }

  // epilogue: rows past S are not stored; lse = m scale + ln l, written by
  // the CTA of the first columns (every half holds the same m and l)
  bf16* o_head = o + b * so.b + h * so.h + col0;
  float* lse_row = lse + ((size_t)b * hq + h) * S;
#pragma unroll
  for (int i = 0; i < MS; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 16 * i + 8 * r;
      if (row >= S) continue;
      const float div = fmaxf(l[i][r], 1e-30f);
      bf16* dst = o_head + row * so.s + col_t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
            __floats2bfloat162_rn(acc[i][n][2 * r] / div, acc[i][n][2 * r + 1] / div);
      if (lane % 4 == 0 && col0 == 0)
        lse_row[row] = l[i][r] > 0.f ? m[i][r] * scale + logf(div) : kNegInf;
    }
}

// ------------------------------------------------------------------ float32 forward
template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
    Strides so, int S, int g, int causal, float scale) {
  using T = float;
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

// ------------------------------------------------------------------ float32 dQ
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, Strides sq, Strides sk, Strides sv,
    Strides sdo, Strides sdq, int S, int g, int causal, float scale) {
  using T = float;
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

// ------------------------------------------------------------------ bf16 dQ
// Tiles of the bf16 dQ kernel: 64 query rows a CTA, 4 warps of one m16 slab
// each, k tiles of 64 keys, rows padded by 16 bytes. Shared memory holds Q
// and dO of the tile, then K and V of two ring stages. A k tile is taken 32
// keys at a time, so that only those keys' S and dP (32 registers) are
// live. At D 64 each warp keeps its slab's Q and dO as ldmatrix.x4 A
// fragments, and kMinBlocks caps the registers at 170 for 3 CTAs a SM with
// no spill; at D 128, where the dQ accumulator alone takes 64 registers, Q
// and dO are read from shared memory per use. At D 256 a CTA accumulates
// half of dQ's columns (ColumnSplit), from full-D Q, dO, K and V tiles
// (198 KB of shared memory, one CTA a SM), and takes a k tile 16 keys at a
// time (16 registers of S and dP instead of 32), which keeps it from
// spilling at 255 registers.
template <int D>
struct DqTiles {
  static constexpr int DO = ColumnSplit<D>::DO;
  static constexpr int kHalves = ColumnSplit<D>::kHalves;
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
  static constexpr int KC = D > 128 ? 16 : 32;  // keys whose S and dP are live at once
  static constexpr int kThreads = 32 * BQ / 16;
  static constexpr bool kResidentQ = D == 64;  // Q/dO A fragments kept in registers
  static constexpr int kMinBlocks = D == 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int LD = D + 8;
  static constexpr size_t q_elems = (size_t)BQ * LD;   // one Q or dO tile
  static constexpr size_t kv_elems = (size_t)BK * LD;  // one K or V tile
  static constexpr size_t smem = (2 * q_elems + 4 * kv_elems) * sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kThreads, DqTiles<D>::kMinBlocks) flash_bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
    Strides sdo, Strides sdq, int S, int g, int causal, float scale) {
  using L = DqTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK, KC = L::KC, LD = L::LD, NT = L::kThreads;
  constexpr int KD = D / 16;      // k16 steps of Q K^T and dO V^T
  constexpr int NS = KC / 8;      // n8 score tiles of one key chunk
  constexpr int NO = L::DO / 8;   // n8 tiles of this CTA's dQ columns
  constexpr int KR = L::kResidentQ ? KD : 1;
  static_assert(KD % 2 == 0 && NO % 2 == 0 && KC % 16 == 0 && BK % KC == 0,
                "x4 loads take pairs");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* do_s = q_s + L::q_elems;
  bf16* kv_s = do_s + L::q_elems;  // stage t: K, V at 2t, 2t + 1

  // blocks start in x-fastest order: every (head, half, batch) of the last q
  // tile first, so the longest causal tiles lead and the shortest form the tail
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ, b = blockIdx.y;
  const int h = blockIdx.x / L::kHalves, col0 = blockIdx.x % L::kHalves * L::DO;
  const int hq = gridDim.x / L::kHalves, kh = h / g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_q0 = q0 + 16 * warp;   // this warp's rows: warp_q0 .. + 15
  const int row0 = warp_q0 + lane / 4;  // this thread's rows: row0 and row0 + 8
  const int col_t = 2 * (lane % 4);     // its first column in each n8 tile
  const float scale_log2 = scale * kLog2e;
  const bf16* k_head = k + b * sk.b + kh * sk.h;
  const bf16* v_head = v + b * sv.b + kh * sv.h;
  const int n_k = causal ? (min(q0 + BQ, S) - 1) / BK + 1 : (S + BK - 1) / BK;

  cp_async_tile<BQ, D, LD, NT>(q_s, q + b * sq.b + h * sq.h, sq.s, q0, S);
  cp_async_tile<BQ, D, LD, NT>(do_s, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  cp_async_tile<BK, D, LD, NT>(kv_s, k_head, sk.s, 0, S);
  cp_async_tile<BK, D, LD, NT>(kv_s + L::kv_elems, v_head, sv.s, 0, S);
  cp_async_commit();

  // lse and delta of this thread's two rows, fixed for the whole CTA. A dead
  // row (lse NEG_INF) and a row past S take NEG_INF in place of -lse log2 e,
  // so their P is 2^(-huge) = 0 (the plain exponent would overflow to +inf).
  float nl[2], dl[2];
  const size_t row_base = ((size_t)b * hq + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const float l = row < S ? lse[row_base + row] : kNegInf;
    nl[r] = l > kNegInf * 0.5f ? -l * kLog2e : kNegInf;
    dl[r] = row < S ? delta[row_base + row] : 0.f;
  }

  uint32_t qf[KR][4], dof[KR][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  // this warp's slab of Q or dO as the A fragment of k16 step kd
  const int a_off = (16 * warp + lane % 16) * LD + lane / 16 * 8;

  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    // Tile kt is the only copy in flight. After the barrier it is visible to
    // every warp, and every warp is done with tile kt - 1, whose stage the
    // copy of tile kt + 1 then reuses.
    cp_async_wait_all();
    __syncthreads();
    if (kt + 1 < n_k) {
      bf16* next = kv_s + ((kt + 1) & 1) * 2 * L::kv_elems;
      cp_async_tile<BK, D, LD, NT>(next, k_head, sk.s, k0 + BK, S);
      cp_async_tile<BK, D, LD, NT>(next + L::kv_elems, v_head, sv.s, k0 + BK, S);
      cp_async_commit();
    }
    if (L::kResidentQ && kt == 0) {
#pragma unroll
      for (int kd = 0; kd < KR; ++kd) {
        ldsm_x4(qf[kd], q_s + a_off + kd * 16);
        ldsm_x4(dof[kd], do_s + a_off + kd * 16);
      }
    }
    const bf16* k_st = kv_s + (kt & 1) * 2 * L::kv_elems;
    const bf16* v_st = k_st + L::kv_elems;
#pragma unroll 1
    for (int c0 = 0; c0 < BK; c0 += KC) {
      const int kc0 = k0 + c0;  // this chunk's keys: kc0 .. + KC - 1
      if (causal && kc0 > warp_q0 + 15) break;  // every key follows every row here

      // S = Q K^T and dP = dO V^T: one x4 load of K (V) gives the B
      // fragments of two k16 steps of one n8 key tile
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; kd += 2) {
        uint32_t qa[2][4], da[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if constexpr (L::kResidentQ) {
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              qa[x][y] = qf[kd + x][y];
              da[x][y] = dof[kd + x][y];
            }
          } else {
            ldsm_x4(qa[x], q_s + a_off + (kd + x) * 16);
            ldsm_x4(da[x], do_s + a_off + (kd + x) * 16);
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const int b_off = (c0 + 8 * j + lane % 8) * LD + kd * 16 + lane / 8 * 8;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, k_st + b_off);
          mma_bf16(s[j], qa[0], bk[0], bk[1]);
          mma_bf16(s[j], qa[1], bk[2], bk[3]);
          ldsm_x4(bv, v_st + b_off);
          mma_bf16(dp[j], da[0], bv[0], bv[1]);
          mma_bf16(dp[j], da[1], bv[2], bv[3]);
        }
      }

      // P = 2^(s c - lse log2 e) and dS = P (dP - delta) scale, in place of
      // S. The mask is applied only where the chunk crosses the diagonal or
      // the ragged end (keys past S are zero-filled rows, whose P is not 0).
      const bool masked = kc0 + KC > S || (causal && kc0 + KC - 1 > warp_q0);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[j][e], scale_log2, nl[e >> 1]));
          if (masked && !key_live(row0 + (e & 2) * 4, kc0 + 8 * j + col_t + (e & 1), S, causal))
            p = 0.f;
          s[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;
        }

      // dQ += dS K: score tiles 2t and 2t + 1 are the A fragment of k16
      // step t; one transposed x4 load of K gives the B fragments of two n8
      // tiles
#pragma unroll
      for (int t = 0; t < KC / 16; ++t) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
        a[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
        a[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
        a[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
#pragma unroll
        for (int n = 0; n < NO; n += 2) {
          uint32_t bk[4];
          ldsm_x4_trans(bk,
                        k_st + (c0 + 16 * t + lane % 16) * LD + col0 + n * 8 + lane / 16 * 8);
          mma_bf16(acc[n], a, bk[0], bk[1]);
          mma_bf16(acc[n + 1], a, bk[2], bk[3]);
        }
      }
    }
  }

  // epilogue: rows past S are not stored
  bf16* dq_head = dq + b * sdq.b + h * sdq.h + col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    bf16* dst = dq_head + row * sdq.s + col_t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------------ bf16 dK / dV
// 4 bytes global -> shared (cp.async.ca; .cg copies only 16); with `valid`
// false nothing is read and the 4 bytes are zero-filled.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

// Tiles of the bf16 dK/dV kernel: 64 keys a CTA, 4 warps of one m16 key slab
// each; q tiles of 64 queries at D 64 and 32 at D 128, where the dK and dV
// accumulators alone take 128 registers. kMinBlocks caps the registers: at
// D 64 three CTAs a SM (at most 170 registers a thread) with no spill.
// Rows are padded by 16 bytes. Shared memory holds K and V, then two ring
// stages of Q, dO, lse and delta. At D 256 a CTA accumulates half of dK's
// and dV's columns (ColumnSplit): S^T and dP^T still take the full-D K, V,
// Q and dO tiles (133 KB), and a thread keeps D 128's 128 accumulators.
template <int D>
struct DkvTiles {
  static constexpr int DO = ColumnSplit<D>::DO;
  static constexpr int kHalves = ColumnSplit<D>::kHalves;
  static constexpr int BK = 64;
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int kThreads = 32 * BK / 16;
  static constexpr bool kResidentKV = D == 64;  // K/V A fragments kept in registers
  static constexpr int kMinBlocks = D == 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int LD = D + 8;
  static constexpr size_t kv_bytes = 2 * (size_t)BK * LD * sizeof(bf16);
  static constexpr size_t q_elems = (size_t)BQ * LD;  // one Q or dO tile
  static constexpr size_t stage_bytes = 2 * q_elems * sizeof(bf16) + 2 * BQ * sizeof(float);
  static constexpr size_t smem = kv_bytes + 2 * stage_bytes;
};

template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kThreads, DkvTiles<D>::kMinBlocks) flash_bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, Strides sq,
    Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int S, int g, int causal,
    float scale) {
  using L = DkvTiles<D>;
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD, NT = L::kThreads;
  constexpr int KD = D / 16;      // k16 steps of K Q^T and V dO^T
  constexpr int NO = L::DO / 8;   // n8 tiles of this CTA's dK and dV columns
  constexpr int KR = L::kResidentKV ? KD : 1;
  static_assert(KD % 2 == 0 && NO % 2 == 0 && BQ % 16 == 0, "x4 loads take pairs");
  static_assert(L::kv_bytes % 16 == 0 && L::stage_bytes % 16 == 0, "16-byte aligned stages");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);
  bf16* v_s = k_s + BK * LD;
  unsigned char* ring = smem + L::kv_bytes;  // stage t: Q, dO, lse, delta

  // blocks start in x-fastest order: every (kv head, half, batch) of k tile
  // 0 first, so the CTAs with the most causal q tiles lead
  const int b = blockIdx.y, k0 = blockIdx.z * BK;
  const int kh = blockIdx.x / L::kHalves, col0 = blockIdx.x % L::kHalves * L::DO;
  const int hq = gridDim.x / L::kHalves * g;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_k0 = k0 + 16 * warp;   // this warp's keys: warp_k0 .. + 15
  const int key0 = warp_k0 + lane / 4;  // this thread's keys: key0 and key0 + 8
  const int col_t = 2 * (lane % 4);     // its first query in each n8 tile
  const float scale_log2 = scale * kLog2e;
  // causal: q tiles that end before this k tile's first key see none of it
  const int first_q = causal ? k0 / BQ : 0;
  const int n_qh = (S + BQ - 1) / BQ - first_q;  // q tiles per query head
  const int n_it = g * n_qh;

  // Q, dO, lse and delta of iteration `it` (query head it / n_qh) into
  // stage it & 1; rows at or past S are zero-filled
  auto issue = [&](int it) {
    const int h = kh * g + it / n_qh, q0 = (first_q + it % n_qh) * BQ;
    bf16* q_st = reinterpret_cast<bf16*>(ring + (it & 1) * L::stage_bytes);
    cp_async_tile<BQ, D, LD, NT>(q_st, q + b * sq.b + h * sq.h, sq.s, q0, S);
    cp_async_tile<BQ, D, LD, NT>(q_st + L::q_elems, dout + b * sdo.b + h * sdo.h, sdo.s, q0, S);
    float* stats = reinterpret_cast<float*>(q_st + 2 * L::q_elems);
    const size_t row = ((size_t)b * hq + h) * S;
    for (int x = threadIdx.x; x < 2 * BQ; x += NT) {
      const int r = x % BQ;
      const bool in = q0 + r < S;
      cp_async4(stats + x, (x < BQ ? lse : delta) + row + (in ? q0 + r : 0), in);
    }
  };

  cp_async_tile<BK, D, LD, NT>(k_s, k + b * sk.b + kh * sk.h, sk.s, k0, S);
  cp_async_tile<BK, D, LD, NT>(v_s, v + b * sv.b + kh * sv.h, sv.s, k0, S);
  issue(0);
  cp_async_commit();

  uint32_t kf[KR][4], vf[KR][4];
  float dk_acc[NO][4], dv_acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  // this warp's slab of K or V as the A fragment of k16 step kd
  const int a_off = (16 * warp + lane % 16) * LD + lane / 16 * 8;

  for (int it = 0; it < n_it; ++it) {
    // Tile it is the only copy in flight. After the barrier it is visible to
    // every warp, and every warp is done with tile it - 1, whose stage the
    // copy of tile it + 1 then reuses.
    cp_async_wait_all();
    __syncthreads();
    if (it + 1 < n_it) {
      issue(it + 1);
      cp_async_commit();
    }
    if (L::kResidentKV && it == 0) {
#pragma unroll
      for (int kd = 0; kd < KR; ++kd) {
        ldsm_x4(kf[kd], k_s + a_off + kd * 16);
        ldsm_x4(vf[kd], v_s + a_off + kd * 16);
      }
    }
    const int q0 = (first_q + it % n_qh) * BQ;
    const bf16* q_st = reinterpret_cast<const bf16*>(ring + (it & 1) * L::stage_bytes);
    const bf16* do_st = q_st + L::q_elems;
    const float* lse_st = reinterpret_cast<const float*>(q_st + 2 * L::q_elems);
    const float* delta_st = lse_st + BQ;

    // 16 queries at a time, n8 tiles 2t and 2t + 1: lse is given, so P^T
    // needs no reduction over the tile, and only this chunk's S^T and dP^T
    // are live. A chunk whose queries all precede this warp's keys is
    // skipped; the mask is applied only where the chunk crosses the diagonal
    // or the warp holds keys past S.
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      const int c0 = q0 + 16 * t;
      if (causal && c0 + 15 < warp_k0) continue;
      const bool masked = (causal && c0 < warp_k0 + 15) || warp_k0 + 16 > S;
      // S^T = K Q^T and dP^T = V dO^T: one x4 load of Q (dO) gives the B
      // fragments of two k16 steps of one n8 query tile
      float st[2][4], dpt[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[u][e] = dpt[u][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; kd += 2) {
        uint32_t ka[2][4], va[2][4];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          if constexpr (L::kResidentKV) {
#pragma unroll
            for (int y = 0; y < 4; ++y) {
              ka[x][y] = kf[kd + x][y];
              va[x][y] = vf[kd + x][y];
            }
          } else {
            ldsm_x4(ka[x], k_s + a_off + (kd + x) * 16);
            ldsm_x4(va[x], v_s + a_off + (kd + x) * 16);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int b_off = (16 * t + 8 * u + lane % 8) * LD + kd * 16 + lane / 8 * 8;
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, q_st + b_off);
          mma_bf16(st[u], ka[0], bq[0], bq[1]);
          mma_bf16(st[u], ka[1], bq[2], bq[3]);
          ldsm_x4(bo, do_st + b_off);
          mma_bf16(dpt[u], va[0], bo[0], bo[1]);
          mma_bf16(dpt[u], va[1], bo[2], bo[3]);
        }
      }

      // P^T = 2^(s c - lse log2 e) and dS^T = P^T (dP^T - delta) scale
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int qc = 16 * t + 8 * u + col_t;  // this thread's first query in the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse_st + qc);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_st + qc);
        // a dead query gives 2^(s c - 1e30) = 0
        const float nl[2] = {l2.x > kNegInf * 0.5f ? -l2.x * kLog2e : kNegInf,
                             l2.y > kNegInf * 0.5f ? -l2.y * kLog2e : kNegInf};
        const float dl[2] = {d2.x, d2.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(st[u][e], scale_log2, nl[e & 1]));
          if (masked && !key_live(q0 + qc + (e & 1), key0 + (e & 2) * 4, S, causal)) p = 0.f;
          st[u][e] = p;
          dpt[u][e] = p * (dpt[u][e] - dl[e & 1]) * scale;
        }
      }

      // dV += P^T dO and dK += dS^T Q: the chunk's two n8 tiles are one k16
      // A fragment; one transposed x4 load of dO (Q) gives the B fragments
      // of two n8 output tiles
      uint32_t ap[4], ads[4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        ap[2 * u] = pack_bf16(st[u][0], st[u][1]);
        ap[2 * u + 1] = pack_bf16(st[u][2], st[u][3]);
        ads[2 * u] = pack_bf16(dpt[u][0], dpt[u][1]);
        ads[2 * u + 1] = pack_bf16(dpt[u][2], dpt[u][3]);
      }
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        const int b_off = (16 * t + lane % 16) * LD + col0 + n * 8 + lane / 16 * 8;
        uint32_t bo[4], bq[4];
        ldsm_x4_trans(bo, do_st + b_off);
        mma_bf16(dv_acc[n], ap, bo[0], bo[1]);
        mma_bf16(dv_acc[n + 1], ap, bo[2], bo[3]);
        ldsm_x4_trans(bq, q_st + b_off);
        mma_bf16(dk_acc[n], ads, bq[0], bq[1]);
        mma_bf16(dk_acc[n + 1], ads, bq[2], bq[3]);
      }
    }
  }

  // epilogue: keys past S are not stored
  bf16* dk_head = dk + b * sdk.b + kh * sdk.h + col0;
  bf16* dv_head = dv + b * sdv.b + kh * sdv.h + col0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dk_head + key * sdk.s + 8 * n + col_t) =
          __floats2bfloat162_rn(dk_acc[n][2 * r], dk_acc[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv_head + key * sdv.s + 8 * n + col_t) =
          __floats2bfloat162_rn(dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------------------------------ float32 dK / dV
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, Strides sq,
    Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int S, int g, int causal,
    float scale) {
  using T = float;
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

template <int D>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                     const long long* st, int B, int S, int Hkv, int g, int causal, float scale,
                     cudaStream_t stream) {
  using L = FwdTiles<D>;
  auto kernel = flash_fwd_bf16_kernel<D>;
  const int q_tiles = (S + L::BQ - 1) / L::BQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = prepare(kernel, L::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv * g * L::kHalves, B, q_tiles);
  kernel<<<grid, L::kThreads, L::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), stride(st, 0), stride(st, 1),
      stride(st, 2), stride(st, 3), S, g, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                const long long* st, int B, int S, int Hkv, int g, int causal, float scale,
                cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return fwd_bf16<D>(q, k, v, o, lse, st, B, S, Hkv, g, causal, scale, stream);
  } else {
    using L = Tiles<T, D>;
    auto kernel = flash_fwd_f32_kernel<D>;
    cudaError_t err = prepare(kernel, L::fwd_smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + L::BQ - 1) / L::BQ, Hkv * g, B);
    kernel<<<grid, kThreads, L::fwd_smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), static_cast<float*>(lse), stride(st, 0), stride(st, 1),
        stride(st, 2), stride(st, 3), S, g, causal, scale);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, const long long* st, int B,
                        int S, int Hkv, int g, int causal, float scale, cudaStream_t stream) {
  using L = DqTiles<D>;
  auto kernel = flash_bwd_dq_bf16_kernel<D>;
  const int q_tiles = (S + L::BQ - 1) / L::BQ;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = prepare(kernel, L::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv * g * L::kHalves, B, q_tiles);
  kernel<<<grid, L::kThreads, L::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), stride(st, 0), stride(st, 1),
      stride(st, 2), stride(st, 3), stride(st, 4), S, g, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, void* dq, const long long* st, int B, int S, int Hkv, int g,
                   int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return bwd_dq_bf16<D>(q, k, v, dout, lse, delta, dq, st, B, S, Hkv, g, causal, scale, stream);
  } else {
    using L = Tiles<T, D>;
    auto kernel = flash_bwd_dq_f32_kernel<D>;
    cudaError_t err = prepare(kernel, L::dq_smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + L::BQ - 1) / L::BQ, Hkv * g, B);
    kernel<<<grid, kThreads, L::dq_smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dq), stride(st, 0), stride(st, 1),
        stride(st, 2), stride(st, 3), stride(st, 4), S, g, causal, scale);
    return cudaGetLastError();
  }
}

template <int D>
cudaError_t bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv,
                         const long long* st, int B, int S, int Hkv, int g, int causal,
                         float scale, cudaStream_t stream) {
  using L = DkvTiles<D>;
  auto kernel = flash_bwd_dkv_bf16_kernel<D>;
  const int k_tiles = (S + L::BK - 1) / L::BK;
  if (k_tiles > 65535) return cudaErrorInvalidValue;
  cudaError_t err = prepare(kernel, L::smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv * L::kHalves, B, k_tiles);
  kernel<<<grid, L::kThreads, L::smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      stride(st, 0), stride(st, 1), stride(st, 2), stride(st, 3), stride(st, 4), stride(st, 5),
      S, g, causal, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dk, void* dv, const long long* st,
                    int B, int S, int Hkv, int g, int causal, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    return bwd_dkv_bf16<D>(q, k, v, dout, lse, delta, dk, dv, st, B, S, Hkv, g, causal, scale,
                           stream);
  } else {
    using L = Tiles<T, D>;
    auto kernel = flash_bwd_dkv_f32_kernel<D>;
    cudaError_t err = prepare(kernel, L::dkv_smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + L::BK - 1) / L::BK, Hkv, B);
    kernel<<<grid, kThreads, L::dkv_smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv),
        stride(st, 0), stride(st, 1), stride(st, 2), stride(st, 3), stride(st, 4),
        stride(st, 5), S, g, causal, scale);
    return cudaGetLastError();
  }
}

// The kernels' shapes; the scale 1/sqrt(scale_dim) is the caller's head dim,
// which the Python wrapper zero-pads up to D (scale_dim <= D).
bool valid(int B, int S, int Hkv, int g, int D, int scale_dim) {
  return B > 0 && S > 0 && Hkv > 0 && g > 0 && B <= 65535 && (long long)Hkv * g <= 65535 &&
         scale_dim > 0 && scale_dim <= D;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D: 64, 128 or 256. Shapes are checked by
// the Python wrapper; what the kernels cannot take is refused here as well.
#define FLASH_DISPATCH(FN, ...)                                                     \
  {                                                                                 \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                             \
    const float scale = 1.0f / sqrtf((float)scale_dim);                             \
    if (dtype == 0 && D == 64) return (int)FN<float, 64>(__VA_ARGS__, scale, s);    \
    if (dtype == 0 && D == 128) return (int)FN<float, 128>(__VA_ARGS__, scale, s);  \
    if (dtype == 0 && D == 256) return (int)FN<float, 256>(__VA_ARGS__, scale, s);  \
    if (dtype == 1 && D == 64) return (int)FN<bf16, 64>(__VA_ARGS__, scale, s);     \
    if (dtype == 1 && D == 128) return (int)FN<bf16, 128>(__VA_ARGS__, scale, s);   \
    if (dtype == 1 && D == 256) return (int)FN<bf16, 256>(__VA_ARGS__, scale, s);   \
    return (int)cudaErrorInvalidValue;                                              \
  }

extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v, void* o, void* lse,
                                const long long* strides, int B, int S, int Hkv, int g, int D,
                                int causal, int dtype, int scale_dim, void* stream) {
  if (!valid(B, S, Hkv, g, D, scale_dim)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(fwd, q, k, v, o, lse, strides, B, S, Hkv, g, causal);
}

// Dynamic shared memory of one forward, dQ or dK/dV CTA, in bytes (for reports).
extern "C" int flash_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 1 && D == 64) return (int)FwdTiles<64>::smem;
  if (dtype == 1 && D == 128) return (int)FwdTiles<128>::smem;
  if (dtype == 0 && D == 64) return (int)Tiles<float, 64>::fwd_smem;
  if (dtype == 0 && D == 128) return (int)Tiles<float, 128>::fwd_smem;
  if (dtype == 1 && D == 256) return (int)FwdTiles<256>::smem;
  if (dtype == 0 && D == 256) return (int)Tiles<float, 256>::fwd_smem;
  return -1;
}

extern "C" int flash_bwd_dq_smem_bytes(int D, int dtype) {
  if (dtype == 1 && D == 64) return (int)DqTiles<64>::smem;
  if (dtype == 1 && D == 128) return (int)DqTiles<128>::smem;
  if (dtype == 0 && D == 64) return (int)Tiles<float, 64>::dq_smem;
  if (dtype == 0 && D == 128) return (int)Tiles<float, 128>::dq_smem;
  if (dtype == 1 && D == 256) return (int)DqTiles<256>::smem;
  if (dtype == 0 && D == 256) return (int)Tiles<float, 256>::dq_smem;
  return -1;
}

extern "C" int flash_bwd_dkv_smem_bytes(int D, int dtype) {
  if (dtype == 1 && D == 64) return (int)DkvTiles<64>::smem;
  if (dtype == 1 && D == 128) return (int)DkvTiles<128>::smem;
  if (dtype == 0 && D == 64) return (int)Tiles<float, 64>::dkv_smem;
  if (dtype == 0 && D == 128) return (int)Tiles<float, 128>::dkv_smem;
  if (dtype == 1 && D == 256) return (int)DkvTiles<256>::smem;
  if (dtype == 0 && D == 256) return (int)Tiles<float, 256>::dkv_smem;
  return -1;
}

extern "C" int flash_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dq,
                                   const long long* strides, int B, int S, int Hkv, int g, int D,
                                   int causal, int dtype, int scale_dim, void* stream) {
  if (!valid(B, S, Hkv, g, D, scale_dim)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, strides, B, S, Hkv, g, causal);
}

extern "C" int flash_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                                    const void* lse, const void* delta, void* dk, void* dv,
                                    const long long* strides, int B, int S, int Hkv, int g, int D,
                                    int causal, int dtype, int scale_dim, void* stream) {
  if (!valid(B, S, Hkv, g, D, scale_dim)) return (int)cudaErrorInvalidValue;
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, strides, B, S, Hkv, g, causal);
}

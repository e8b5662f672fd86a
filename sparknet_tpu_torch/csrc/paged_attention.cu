// Paged decode attention for Hopper (sm_90a): one query token a row against
// a block-paged K/V pool.
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_kernels.py::_paged_kernel
// (launched by _paged_pallas).  Inputs, float32 except the int32 tables:
//
//   q          [B, H, D]      one query token per row (slot)
//   k/v pools  [NB, T, H, D]  K/V in blocks of T tokens
//   tables     [B, MB]        the pool blocks of each row, in sequence order
//   positions  [B]            row b attends to logical columns 0..pos[b]
//
//   o[b, h] = sum_{c <= pos[b]} softmax_c(q[b, h] . K_b[c, h] / sqrt(D)) V_b[c, h]
//
// where logical column c of row b is token c % T of pool block
// tables[b, c / T].  The TPU kernel scalar-prefetches the tables, DMAs each
// named [T, H, D] block into VMEM, masks columns past pos[b] to -1e30 and
// folds every one of the MB blocks into an online softmax whose running max
// starts at -1e30 (:818).
//
// What bounds it: bytes, and at small shapes latency.  Each live column
// costs 2 * D floats of K and V against 4 * D flops, far below the card's
// balance, and no K/V head is shared between queries, so the tensor cores
// cannot help.  The least time is the live K/V bytes (sum over rows of
// (pos + 1) * H * D * 8) over the memory rate: 0.163 ms at the long-context
// shape chip_smoke.py times (B 64, H 16, D 64, T 16, MB 128, random
// positions; 1.07 GB of pools).  The bytes come only as fast as they are
// asked for: at 3.35 TB/s and about 1 us of loaded latency, Little's law
// wants some 25 KB in flight on each of the 132 SMs.  A thread that loads
// one 4-byte V value, waits, and adds it keeps 4 bytes in flight.  At the
// char LM's decode shape ([32, 4, 16], T = 8, MB = 16) a row's whole live
// window is at most 128 columns, 16 KB of K and V: the bytes are nothing
// and the time is the chain of dependent round trips (position, table,
// K/V) plus the launch.
//
// The design:
//
//  - one CTA of 4 warps per (row b, head h), grid (H, B).  It reads its
//    position (clamped to [0, MB * T - 1]) and walks columns 0..pos in
//    tiles of KT columns (32 / G a warp, G = max(1, D / 32) lanes a
//    column: KT = 128 at D <= 32, 64 at D = 64, 32 at D = 128; 16 KB of K
//    and 16 KB of V a tile from D = 32 up, 8 + 8 KB at D = 16);
//  - the pool row of each of a tile's columns (tables[b, c / T] * T +
//    c % T) is worked out once, one thread a column, into shared memory, a
//    tile ahead of its copies;
//  - every thread then issues 16-byte cp.async.cg copies of the tile's K
//    and V lines of head h (a warp's copies are whole consecutive lines)
//    into a ring of kStages = 3 shared-memory stages: while one tile is
//    scored, the next two are in flight.  Columns past pos are zero-filled
//    (src-size 0): nothing past pos is read, not the null block, not stale
//    lines, not other rows' blocks.  At the long shape a CTA takes 102 KB,
//    two fit an SM, and up to 2 x 2 x 32 KB = 128 KB of K/V is in flight
//    on an SM (the old kernel: about 4 KB).  At the char LM's shape the
//    whole window is one tile: one round trip;
//  - each warp takes its fixed 32 / G columns of every tile and keeps its
//    own online softmax (m, l, and o over D) with no block barrier: lane
//    group (column j, part g) scores column j against q (D / G dims a lane,
//    q staged once in shared memory, the G parts summed by xor shuffles); the warp's max is
//    five shuffles; p = exp(s - m') (0 past pos); then lane d (a group of
//    D lanes a column at D < 32) adds p_j V[j, d] over the share's columns
//    from shared memory, p_j broadcast by a shuffle.  K rows are padded to
//    D + 4G words and each part reads every G-th 16-byte chunk, so a
//    quarter-warp's 128-bit loads hit 32 distinct banks;  V rows are read
//    whole by the warp and need no pad;
//  - the only block barrier in the walk guards the ring (one a tile).  The
//    four warps' carries are merged once at the end, in warp order, by
//    exp(m_w - max m).  A warp whose share holds no live column keeps m =
//    -1e30, l = 0 and o = 0 (masked columns get p = 0 explicitly, never
//    exp(-1e30 - -1e30) = 1) and adds exactly 0;
//  - one launch a call: no second reduce kernel and no workspace.
//
// Exactness contract (pallas_kernels.py:740-751): a row's output depends
// only on its own q, table and position.  Nothing reduces across rows, and
// every sum of a CTA is taken in an order fixed by its position alone (the
// tiling, each warp's share, the lane groups and the merge), with no
// atomics, so interleaved decode gives the same bits as decoding alone.
//
// The head dims are the zoo's (8 for transformer, 16 for charlm) and 32, 64
// and 128; any other raises in the wrapper (ops/kernels.py) and returns
// cudaErrorInvalidValue here, as does a pool not 16-byte aligned.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;  // K/V tiles in the shared-memory ring
constexpr unsigned kFull = 0xffffffffu;

template <int D>
struct PagedCfg {
  static constexpr int kG = D <= 32 ? 1 : D / 32;      // lanes a column, scoring
  static constexpr int kDL = D / kG;                   // dims a lane, scoring
  static constexpr int kCW = 32 / kG;                  // columns a warp a tile
  static constexpr int kKT = kWarps * kCW;             // columns a tile
  static constexpr int kVL = D < 32 ? 1 : D / 32;      // dims a lane, P V
  static constexpr int kGroups = D < 32 ? 32 / D : 1;  // lane groups, P V
  static constexpr int kKS = D + 4 * kG;               // K row stride, words
  static constexpr int kVS = D;                        // V row stride, words
  static constexpr int kCPR = D / 4;                   // 16-byte chunks a row
  static constexpr int kCopies = kKT * kCPR / kThreads;  // K (and V) copies a thread a tile
  static constexpr int kStage = kKT * (kKS + kVS);     // floats a stage
  static constexpr int kSmem = kStages * kStage * 4;   // ring bytes
  static_assert(kKT <= kThreads && kKT * kCPR % kThreads == 0,
                "a tile's columns and copies must spread over the CTA");
};

// 16 bytes from global to shared memory, or 16 zero bytes when !live (no
// global byte is read then)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The pool row (block * T + token) of each column of tile x, one thread a
// column, into slot x % kStages; 0 for columns past pos, whose copies are
// zero-fills that read nothing.
template <int KT>
__device__ __forceinline__ void plan_tile(unsigned (*rows_s)[KT],
                                          const int* tbl, int x, int pos,
                                          int T) {
  const int tid = threadIdx.x;
  if (tid < KT) {
    const int c = x * KT + tid;
    rows_s[x % kStages][tid] =
        c <= pos ? (unsigned)tbl[c / T] * (unsigned)T + (unsigned)(c % T) : 0u;
  }
}

// Tile x's K and V lines of one head into stage x % kStages of the ring:
// 16-byte copies, consecutive threads on consecutive chunks of a line.  A
// thread copies chunk ch of columns col0, col0 + kColStep, ..., so its
// addresses are a few bases plus constant offsets.
template <int D>
__device__ __forceinline__ void issue_tile(
    float* ring, const unsigned (*rows_s)[PagedCfg<D>::kKT], const float* kp,
    const float* vp, int x, int pos, long long row_stride, long long head_off) {
  using C = PagedCfg<D>;
  constexpr int kColStep = kThreads / C::kCPR;
  const unsigned col0 = threadIdx.x / C::kCPR, ch = threadIdx.x % C::kCPR;
  float* sk = ring + (x % kStages) * C::kStage + col0 * C::kKS + 4 * ch;
  float* sv = ring + (x % kStages) * C::kStage + C::kKT * C::kKS + col0 * C::kVS + 4 * ch;
  const unsigned* rows = rows_s[x % kStages] + col0;
  const float* kh = kp + head_off + 4 * ch;
  const float* vh = vp + head_off + 4 * ch;
  const int c0 = x * C::kKT + (int)col0;
#pragma unroll
  for (int r = 0; r < C::kCopies; ++r) {
    const long long src = (long long)rows[r * kColStep] * row_stride;
    const bool live = c0 + r * kColStep <= pos;
    cp_async16(sk + r * kColStep * C::kKS, kh + src, live);
    cp_async16(sv + r * kColStep * C::kVS, vh + src, live);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const float* __restrict__ q,
                           const float* __restrict__ kp,
                           const float* __restrict__ vp,
                           const int* __restrict__ tables,
                           const int* __restrict__ positions,
                           float* __restrict__ o, int H, int T, int MB,
                           float scale) {
  using C = PagedCfg<D>;
  constexpr int G = C::kG, DL = C::kDL, CW = C::kCW, KT = C::kKT,
                VL = C::kVL, KS = C::kKS, VS = C::kVS;
  extern __shared__ float4 ring4[];
  float* ring = reinterpret_cast<float*>(ring4);
  // pool row of each column of a tile, by slot: below 2^32, since a pool of
  // 2^32 rows of H * D >= 8 floats would not fit on a card
  __shared__ unsigned rows_s[kStages][KT];
  __shared__ __align__(16) float q_s[D];
  __shared__ float m_s[kWarps], l_s[kWarps];
  __shared__ float acc_s[kWarps][D];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* tbl = tables + (long long)b * MB;
  const int pos = max(0, min(positions[b], MB * T - 1));
  const int ntiles = pos / KT + 1;
  const long long row_stride = (long long)H * D;  // one token of a block
  const long long head_off = (long long)h * D;

  if (tid < D) q_s[tid] = q[((long long)b * H + h) * D + tid];
  // scoring role: column jc of the warp's share, part g: q's and K's
  // 16-byte chunks g, g + G, g + 2G, ...
  const int jc = lane / G, g = lane % G;
  // P V role: dims dv .. dv + VL - 1, the share's columns grp, grp + groups, ...
  const int dv = (lane % (D / VL)) * VL, grp = lane / (D / VL);

  for (int x = 0; x < kStages && x < ntiles; ++x) plan_tile<KT>(rows_s, tbl, x, pos, T);
  __syncthreads();
#pragma unroll
  for (int x = 0; x < kStages - 1; ++x) {
    if (x < ntiles) issue_tile<D>(ring, rows_s, kp, vp, x, pos, row_stride, head_off);
    cp_async_commit();
  }

  float m = -1e30f, l = 0.f, acc[VL];
#pragma unroll
  for (int k = 0; k < VL; ++k) acc[k] = 0.f;
  for (int x = 0; x < ntiles; ++x) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile x landed
    // everyone's copies of tile x landed; tile x - 1's stage and the rows
    // of tile x + kStages - 1 are free to overwrite and read
    __syncthreads();
    if (x + kStages - 1 < ntiles)
      issue_tile<D>(ring, rows_s, kp, vp, x + kStages - 1, pos, row_stride, head_off);
    cp_async_commit();
    if (x + kStages < ntiles) plan_tile<KT>(rows_s, tbl, x + kStages, pos, T);

    const int c0 = x * KT + warp * CW;  // the warp's first column
    if (c0 > pos) continue;              // warp-uniform: nothing live
    const float* sk = ring + (x % kStages) * C::kStage + warp * CW * KS;
    const float* sv = ring + (x % kStages) * C::kStage + KT * KS + warp * CW * VS;

    const float* kr = sk + jc * KS;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < DL / 4; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + 4 * (g + G * i));
      const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * (g + G * i));
      part = fmaf(qv.x, kv.x, part);
      part = fmaf(qv.y, kv.y, part);
      part = fmaf(qv.z, kv.z, part);
      part = fmaf(qv.w, kv.w, part);
    }
#pragma unroll
    for (int w = 1; w < G; w <<= 1) part += __shfl_xor_sync(kFull, part, w);
    const bool live = c0 + jc <= pos;
    const float s = live ? part * scale : -1e30f;
    float mx = s;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.f;
    l = fmaf(l, corr, g == 0 ? p : 0.f);
#pragma unroll
    for (int k = 0; k < VL; ++k) acc[k] *= corr;
#pragma unroll
    for (int jj = 0; jj < CW / C::kGroups; ++jj) {
      const int j = jj * C::kGroups + grp;
      const float pj = __shfl_sync(kFull, p, j * G);
      const float* vr = sv + j * VS + dv;
      if constexpr (VL == 4) {
        const float4 vv = *reinterpret_cast<const float4*>(vr);
        acc[0] = fmaf(pj, vv.x, acc[0]);
        acc[1] = fmaf(pj, vv.y, acc[1]);
        acc[2] = fmaf(pj, vv.z, acc[2]);
        acc[3] = fmaf(pj, vv.w, acc[3]);
      } else if constexpr (VL == 2) {
        const float2 vv = *reinterpret_cast<const float2*>(vr);
        acc[0] = fmaf(pj, vv.x, acc[0]);
        acc[1] = fmaf(pj, vv.y, acc[1]);
      } else {
        acc[0] = fmaf(pj, vr[0], acc[0]);
      }
    }
    m = m_new;
  }

  // the warp's carry: o summed over its lane groups, l over its lanes
#pragma unroll
  for (int w = D; w < 32; w <<= 1) acc[0] += __shfl_xor_sync(kFull, acc[0], w);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(kFull, l, w);
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  if (grp == 0) {
#pragma unroll
    for (int k = 0; k < VL; ++k) acc_s[warp][dv + k] = acc[k];
  }
  __syncthreads();
  if (tid < D) {  // the warps' carries merged in warp order
    float mt = m_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, m_s[w]);
    float a = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w] - mt);
      a = fmaf(acc_s[w][tid], f, a);
      den = fmaf(l_s[w], f, den);
    }
    o[((long long)b * H + h) * D + tid] = a / den;  // column 0 is live: den > 0
  }
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory past 48 KB must be allowed for each kernel on each
// device: done at the first launch on a device, then remembered.
template <int D>
cudaError_t allow_smem() {
  constexpr int smem = PagedCfg<D>::kSmem;
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(paged_attention_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices)
    allowed[dev].store(true, std::memory_order_release);
  return err;
}

template <int D>
cudaError_t launch(const float* q, const float* kp, const float* vp,
                   const int* tables, const int* positions, float* o, int B,
                   int H, int T, int MB, float scale, cudaStream_t s) {
  const cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  paged_attention_kernel<D><<<grid, kThreads, PagedCfg<D>::kSmem, s>>>(
      q, kp, vp, tables, positions, o, H, T, MB, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: contiguous float32 [b, h, d]; k_pool, v_pool: contiguous float32
// [num_blocks, t, h, d], 16-byte aligned; tables: contiguous int32 [b, mb]
// of block ids in [0, num_blocks); positions: int32 [b].  scale:
// 1 / sqrt(d).  Returns a cudaError_t.
int sparknet_paged_attention(const void* q, const void* k_pool,
                             const void* v_pool, const void* tables,
                             const void* positions, void* o, int b, int h,
                             int d, int t, int mb, float scale,
                             void* stream) {
  // mb * t + 128: the last tile's column indices stay in int range
  if (b <= 0 || b > 65535 || h <= 0 || t <= 0 || mb <= 0 ||
      (long long)mb * t > INT32_MAX - 128 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k_pool);
  const float* vf = static_cast<const float*>(v_pool);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 8: return (int)launch<8>(qf, kf, vf, tb, ps, of, b, h, t, mb, scale, st);
    case 16: return (int)launch<16>(qf, kf, vf, tb, ps, of, b, h, t, mb, scale, st);
    case 32: return (int)launch<32>(qf, kf, vf, tb, ps, of, b, h, t, mb, scale, st);
    case 64: return (int)launch<64>(qf, kf, vf, tb, ps, of, b, h, t, mb, scale, st);
    case 128: return (int)launch<128>(qf, kf, vf, tb, ps, of, b, h, t, mb, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

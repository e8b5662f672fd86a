// Paged decode attention for Hopper (sm_90a): one query token a row against
// a block-paged K/V pool.
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_kernels.py::_paged_kernel
// (launched by _paged_pallas).  Inputs, float32 except the int32 tables
// (the pools may also be bfloat16 or float16: see the end of this note):
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
// The head dims are the zoo's (8 for transformer, 16 for charlm) and 32,
// 64, 128 and 256 (at D = 256: 16 columns a tile, 8 lanes a column, 104 KB
// of ring), and above 256 any multiple of 128 lanes whose shared memory
// fits a block (the chunked kernel further down); any other raises in the
// wrapper (ops/kernels.py) and returns cudaErrorInvalidValue here, as does
// a pool not 16-byte aligned.
//
// Pools of bfloat16 or float16 (the TPU kernel casts each block it loads,
// :804-805) are never copied or cast as a whole: an instance on the pools'
// storage type copies their lines as stored into the ring (half the bytes,
// the same 16-byte chunks) and converts each value to float32 as it reads
// it from shared memory; q and o stay float32 (the wrapper casts q).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 3;  // K/V tiles in the shared-memory ring
constexpr unsigned kFull = 0xffffffffu;

// T: the pools' storage type (float, __nv_bfloat16 or __half); the ring
// holds pool lines as stored, and each value is converted to float32 as it
// is read from shared memory
template <int D, typename T>
struct PagedCfg {
  static constexpr int kG = D <= 32 ? 1 : D / 32;      // lanes a column, scoring
  static constexpr int kDL = D / kG;                   // dims a lane, scoring
  static constexpr int kCW = 32 / kG;                  // columns a warp a tile
  static constexpr int kKT = kWarps * kCW;             // columns a tile
  static constexpr int kVL = D < 32 ? 1 : D / 32;      // dims a lane, P V
  static constexpr int kGroups = D < 32 ? 32 / D : 1;  // lane groups, P V
  static constexpr int kEPC = 16 / (int)sizeof(T);     // elements a 16-byte chunk
  static constexpr int kKS = D + kEPC * kG;            // K row stride, elements
  static constexpr int kVS = D;                        // V row stride, elements
  static constexpr int kCPR = D / kEPC;                // 16-byte chunks a row
  static constexpr int kCopies = kKT * kCPR / kThreads;  // K (and V) copies a thread a tile
  static constexpr int kStage = kKT * (kKS + kVS);     // elements a stage
  static constexpr int kSmem = kStages * kStage * (int)sizeof(T);  // ring bytes
  static_assert(kKT <= kThreads && kKT * kCPR % kThreads == 0,
                "a tile's columns and copies must spread over the CTA");
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// four consecutive elements of shared memory as float32 (16-byte aligned
// for float, 8-byte for the 16-bit types)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (std::is_same<T, float>::value) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    return make_float4(to_f32(p[0]), to_f32(p[1]), to_f32(p[2]), to_f32(p[3]));
  }
}

// 16 bytes from global to shared memory, or 16 zero bytes when !live (no
// global byte is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
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
template <int D, typename T>
__device__ __forceinline__ void issue_tile(
    T* ring, const unsigned (*rows_s)[PagedCfg<D, T>::kKT], const T* kp,
    const T* vp, int x, int pos, long long row_stride, long long head_off) {
  using C = PagedCfg<D, T>;
  constexpr int kColStep = kThreads / C::kCPR;
  const unsigned col0 = threadIdx.x / C::kCPR, ch = threadIdx.x % C::kCPR;
  T* sk = ring + (x % kStages) * C::kStage + col0 * C::kKS + C::kEPC * ch;
  T* sv = ring + (x % kStages) * C::kStage + C::kKT * C::kKS + col0 * C::kVS + C::kEPC * ch;
  const unsigned* rows = rows_s[x % kStages] + col0;
  const T* kh = kp + head_off + C::kEPC * ch;
  const T* vh = vp + head_off + C::kEPC * ch;
  const int c0 = x * C::kKT + (int)col0;
#pragma unroll
  for (int r = 0; r < C::kCopies; ++r) {
    const long long src = (long long)rows[r * kColStep] * row_stride;
    const bool live = c0 + r * kColStep <= pos;
    cp_async16(sk + r * kColStep * C::kKS, kh + src, live);
    cp_async16(sv + r * kColStep * C::kVS, vh + src, live);
  }
}

// A column's score part: the fmaf sum of a lane's DL dims of q (float32 in
// shared memory) and of the column's K row, its 16-byte chunks g, g + G,
// g + 2G, ...; then the G parts of the column summed by xor shuffles.
template <int G, int DL, typename KV>
__device__ __forceinline__ float score_part(const float* q_s, const KV* kr, int g) {
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < DL / 4; ++i) {
    const float4 qv = *reinterpret_cast<const float4*>(q_s + 4 * (g + G * i));
    const float4 kv = load4(kr + 4 * (g + G * i));
    part = fmaf(qv.x, kv.x, part);
    part = fmaf(qv.y, kv.y, part);
    part = fmaf(qv.z, kv.z, part);
    part = fmaf(qv.w, kv.w, part);
  }
#pragma unroll
  for (int w = 1; w < G; w <<= 1) part += __shfl_xor_sync(kFull, part, w);
  return part;
}

// The four warps' carries (O at acc_s + w * D, and m, l) merged in warp
// order by exp(m_w - max m) into o[0, D).  Column 0 is live, so den > 0.
__device__ __forceinline__ void merge_carries(const float* acc_s, const float* m_s,
                                              const float* l_s, float* o, int D) {
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float mt = m_s[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, m_s[w]);
    float a = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_s[w] - mt);
      a = fmaf(acc_s[w * D + d], f, a);
      den = fmaf(l_s[w], f, den);
    }
    o[d] = a / den;
  }
}

template <int D, typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const float* __restrict__ q,
                           const KV* __restrict__ kp,
                           const KV* __restrict__ vp,
                           const int* __restrict__ tables,
                           const int* __restrict__ positions,
                           float* __restrict__ o, int H, int T, int MB,
                           float scale) {
  using C = PagedCfg<D, KV>;
  constexpr int G = C::kG, DL = C::kDL, CW = C::kCW, KT = C::kKT,
                VL = C::kVL, KS = C::kKS, VS = C::kVS;
  extern __shared__ float4 ring4[];
  KV* ring = reinterpret_cast<KV*>(ring4);
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

  for (int d = tid; d < D; d += kThreads) q_s[d] = q[((long long)b * H + h) * D + d];
  // scoring role: column jc of the warp's share, part g: q's and K's
  // 16-byte chunks g, g + G, g + 2G, ...
  const int jc = lane / G, g = lane % G;
  // P V role: dims dv .. dv + VL - 1, the share's columns grp, grp + groups, ...
  const int dv = (lane % (D / VL)) * VL, grp = lane / (D / VL);

  for (int x = 0; x < kStages && x < ntiles; ++x) plan_tile<KT>(rows_s, tbl, x, pos, T);
  __syncthreads();
#pragma unroll
  for (int x = 0; x < kStages - 1; ++x) {
    if (x < ntiles) issue_tile<D, KV>(ring, rows_s, kp, vp, x, pos, row_stride, head_off);
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
      issue_tile<D, KV>(ring, rows_s, kp, vp, x + kStages - 1, pos, row_stride, head_off);
    cp_async_commit();
    if (x + kStages < ntiles) plan_tile<KT>(rows_s, tbl, x + kStages, pos, T);

    const int c0 = x * KT + warp * CW;  // the warp's first column
    if (c0 > pos) continue;              // warp-uniform: nothing live
    const KV* sk = ring + (x % kStages) * C::kStage + warp * CW * KS;
    const KV* sv = ring + (x % kStages) * C::kStage + KT * KS + warp * CW * VS;

    const float part = score_part<G, DL>(q_s, sk + jc * KS, g);
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
      const KV* vr = sv + j * VS + dv;
      if constexpr (VL % 4 == 0) {
#pragma unroll
        for (int u = 0; u < VL; u += 4) {
          const float4 vv = load4(vr + u);
          acc[u] = fmaf(pj, vv.x, acc[u]);
          acc[u + 1] = fmaf(pj, vv.y, acc[u + 1]);
          acc[u + 2] = fmaf(pj, vv.z, acc[u + 2]);
          acc[u + 3] = fmaf(pj, vv.w, acc[u + 3]);
        }
      } else if constexpr (VL == 2 && std::is_same<KV, float>::value) {
        const float2 vv = *reinterpret_cast<const float2*>(vr);
        acc[0] = fmaf(pj, vv.x, acc[0]);
        acc[1] = fmaf(pj, vv.y, acc[1]);
      } else {
#pragma unroll
        for (int u = 0; u < VL; ++u) acc[u] = fmaf(pj, to_f32(vr[u]), acc[u]);
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
  merge_carries(&acc_s[0][0], m_s, l_s, o + ((long long)b * H + h) * D, D);
}

// ---------------------------------------------------------------------------
// Heads wider than 256 lanes: D = nc * kDC (the pools are allocated at a
// multiple of kDC lanes, ops/kernels.py kernel_head_dim).  A CTA still
// takes one (row, head) and each warp keeps one online softmax over all D
// lanes, but the pool's lanes are read a chunk at a time: the ring's items
// are a tile's K chunks 0 .. nc - 1, then its V chunks, each KT columns of
// kDC lanes, through two stages (the item after the one being used is in
// flight).  The chunk's lane roles are the D = 128 instance's (G = 4 lanes
// a column scoring 32 dims each, 8 columns a warp, 32 a tile; 4 dims a
// lane in P V).  A column's score is the sum of its chunks' partial dot
// products, added in chunk order; after the last K chunk the warp updates
// its max, l and the rescale of O, and each V chunk adds P V into O's
// chunk.  O (4 warps x D floats) lives in shared memory, each lane reading
// and writing only its own lanes, and q is staged there once: 2 x 18 KB of
// ring plus 20 D bytes, 46 KB at D = 512 (float32 pools).  The exactness
// contract holds as above: every sum in an order fixed by the position.
// These widths are correctness first: no shipped configuration reaches
// them, and the tile's K lines are read once for the scores and the V
// lines once for P V, as at the narrow widths.
constexpr int kDC = 128;  // lanes a chunk
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

template <typename T>
struct PagedWideCfg {
  using C = PagedCfg<kDC, T>;
  static constexpr int kStage = C::kKT * C::kKS;  // elements: one K or V chunk
  static constexpr int kRing = 2 * kStage * (int)sizeof(T);
  // bytes: the ring, q [D] and the warps' O [kWarps, D], float32
  static int smem(int D) { return kRing + (1 + kWarps) * D * (int)sizeof(float); }
};

// Item i of tile x into ring stage i % 2: K chunk i (i < nc) or V chunk
// i - nc, as issue_tile copies a narrow tile (16-byte copies, columns past
// pos zero-filled).
template <typename T>
__device__ __forceinline__ void issue_chunk(T* ring, const unsigned* rows_s,
                                            const T* kp, const T* vp, int x,
                                            int i, int nc, int pos,
                                            long long row_stride,
                                            long long head_off) {
  using C = PagedCfg<kDC, T>;
  constexpr int kColStep = kThreads / C::kCPR;
  const unsigned col0 = threadIdx.x / C::kCPR, ch = threadIdx.x % C::kCPR;
  T* dst = ring + (i % 2) * PagedWideCfg<T>::kStage + col0 * C::kKS + C::kEPC * ch;
  const T* src = (i < nc ? kp : vp) + head_off + (i % nc) * kDC + C::kEPC * ch;
  const int c0 = x * C::kKT + (int)col0;
#pragma unroll
  for (int r = 0; r < C::kCopies; ++r) {
    const long long off = (long long)rows_s[col0 + r * kColStep] * row_stride;
    cp_async16(dst + r * kColStep * C::kKS, src + off, c0 + r * kColStep <= pos);
  }
}

template <typename KV>
__global__ void __launch_bounds__(kThreads)
    paged_attention_wide_kernel(const float* __restrict__ q,
                                const KV* __restrict__ kp,
                                const KV* __restrict__ vp,
                                const int* __restrict__ tables,
                                const int* __restrict__ positions,
                                float* __restrict__ o, int H, int T, int MB,
                                int D, float scale) {
  using C = PagedCfg<kDC, KV>;
  constexpr int G = C::kG, DL = C::kDL, CW = C::kCW, KT = C::kKT, VL = C::kVL,
                RS = C::kKS;
  static_assert(C::kGroups == 1 && VL == 4, "P V: 4 dims a lane of a chunk");
  extern __shared__ float4 smem4[];
  KV* ring = reinterpret_cast<KV*>(smem4);
  float* q_s = reinterpret_cast<float*>(ring + 2 * PagedWideCfg<KV>::kStage);
  float* acc_s = q_s + D;  // [kWarps][D]
  __shared__ unsigned rows_s[KT];
  __shared__ float m_s[kWarps], l_s[kWarps];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int* tbl = tables + (long long)b * MB;
  const int pos = max(0, min(positions[b], MB * T - 1));
  const int ntiles = pos / KT + 1;
  const int nc = D / kDC, nitems = 2 * nc;
  const long long row_stride = (long long)H * D;
  const long long head_off = (long long)h * D;

  for (int d = tid; d < D; d += kThreads) q_s[d] = q[((long long)b * H + h) * D + d];
  for (int d = tid; d < kWarps * D; d += kThreads) acc_s[d] = 0.f;
  const int jc = lane / G, g = lane % G;  // scoring: column jc, part g
  const int dv = lane * VL;               // P V: dims dv .. dv + 3 of a chunk
  float* acc = acc_s + warp * D;
  float m = -1e30f, l = 0.f;

  for (int x = 0; x < ntiles; ++x) {
    __syncthreads();  // every copy of tile x - 1 has read its rows
    if (tid < KT) {
      const int c = x * KT + tid;
      rows_s[tid] = c <= pos ? (unsigned)tbl[c / T] * (unsigned)T + (unsigned)(c % T) : 0u;
    }
    __syncthreads();
    issue_chunk<KV>(ring, rows_s, kp, vp, x, 0, nc, pos, row_stride, head_off);
    cp_async_commit();
    const int c0 = x * KT + warp * CW;  // the warp's first column
    const bool live = c0 + jc <= pos;
    float s = 0.f, p = 0.f;
    for (int i = 0; i < nitems; ++i) {
      if (i + 1 < nitems)
        issue_chunk<KV>(ring, rows_s, kp, vp, x, i + 1, nc, pos, row_stride, head_off);
      cp_async_commit();
      cp_async_wait<1>();  // this thread's copies of item i landed
      __syncthreads();     // everyone's
      const KV* st = ring + (i % 2) * PagedWideCfg<KV>::kStage + warp * CW * RS;
      if (c0 <= pos) {  // warp-uniform: a live column in the warp's share
        if (i < nc) {   // K chunk i: the column's partial score
          s += score_part<G, DL>(q_s + i * kDC, st + jc * RS, g);
          if (i == nc - 1) {  // the scores are whole: the online softmax
            const float sc = live ? s * scale : -1e30f;
            float mx = sc;
#pragma unroll
            for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
            const float m_new = fmaxf(m, mx);
            const float corr = expf(m - m_new);
            p = live ? expf(sc - m_new) : 0.f;
            l = fmaf(l, corr, g == 0 ? p : 0.f);
            for (int cv = 0; cv < nc; ++cv) {
              float4* a = reinterpret_cast<float4*>(acc + cv * kDC + dv);
              float4 av = *a;
              av.x *= corr;
              av.y *= corr;
              av.z *= corr;
              av.w *= corr;
              *a = av;
            }
            m = m_new;
          }
        } else {  // V chunk i - nc: O's chunk += P V
          float4* a = reinterpret_cast<float4*>(acc + (i - nc) * kDC + dv);
          float4 av = *a;
#pragma unroll
          for (int j = 0; j < CW; ++j) {
            const float pj = __shfl_sync(kFull, p, j * G);
            const float4 vv = load4(st + j * RS + dv);
            av.x = fmaf(pj, vv.x, av.x);
            av.y = fmaf(pj, vv.y, av.y);
            av.z = fmaf(pj, vv.z, av.z);
            av.w = fmaf(pj, vv.w, av.w);
          }
          *a = av;
        }
      }
      __syncthreads();  // stage i % 2 is refilled at item i + 2
    }
  }

#pragma unroll
  for (int w = 16; w > 0; w >>= 1) l += __shfl_xor_sync(kFull, l, w);
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  merge_carries(acc_s, m_s, l_s, o + ((long long)b * H + h) * D, D);
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory past 48 KB must be allowed for each kernel on each
// device: done at the first launch on a device, then remembered.
template <int D, typename T>
cudaError_t allow_smem() {
  constexpr int smem = PagedCfg<D, T>::kSmem;
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(paged_attention_kernel<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices)
    allowed[dev].store(true, std::memory_order_release);
  return err;
}

template <int D, typename T>
cudaError_t launch(const float* q, const void* kp, const void* vp,
                   const int* tables, const int* positions, float* o, int B,
                   int H, int Tk, int MB, float scale, cudaStream_t s) {
  const cudaError_t err = allow_smem<D, T>();
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  paged_attention_kernel<D, T><<<grid, kThreads, PagedCfg<D, T>::kSmem, s>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), tables,
      positions, o, H, Tk, MB, scale);
  return cudaGetLastError();
}

// the wide kernel: its shared memory grows with D, so the allowance is
// raised to the largest size launched so far on the device
template <typename T>
cudaError_t launch_wide(const float* q, const void* kp, const void* vp,
                        const int* tables, const int* positions, float* o, int B,
                        int H, int Tk, int MB, int D, float scale, cudaStream_t s) {
  const int smem = PagedWideCfg<T>::smem(D);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  static std::atomic<int> allowed[kMaxDevices];
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= kMaxDevices || allowed[dev].load(std::memory_order_acquire) < smem) {
      err = cudaFuncSetAttribute(paged_attention_wide_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) {
        int seen = allowed[dev].load(std::memory_order_acquire);
        while (seen < smem && !allowed[dev].compare_exchange_weak(seen, smem)) {
        }
      }
    }
  }
  paged_attention_wide_kernel<T><<<dim3(H, B), kThreads, smem, s>>>(
      q, static_cast<const T*>(kp), static_cast<const T*>(vp), tables, positions, o,
      H, Tk, MB, D, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(int d, const float* q, const void* kp, const void* vp,
                         const int* tables, const int* positions, float* o,
                         int B, int H, int Tk, int MB, float scale,
                         cudaStream_t s) {
  if (d > 256)
    return d % kDC ? cudaErrorInvalidValue
                   : launch_wide<T>(q, kp, vp, tables, positions, o, B, H, Tk, MB, d,
                                    scale, s);
  switch (d) {
    case 8: return launch<8, T>(q, kp, vp, tables, positions, o, B, H, Tk, MB, scale, s);
    case 16: return launch<16, T>(q, kp, vp, tables, positions, o, B, H, Tk, MB, scale, s);
    case 32: return launch<32, T>(q, kp, vp, tables, positions, o, B, H, Tk, MB, scale, s);
    case 64: return launch<64, T>(q, kp, vp, tables, positions, o, B, H, Tk, MB, scale, s);
    case 128: return launch<128, T>(q, kp, vp, tables, positions, o, B, H, Tk, MB, scale, s);
    case 256: return launch<256, T>(q, kp, vp, tables, positions, o, B, H, Tk, MB, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: contiguous float32 [b, h, d]; k_pool, v_pool: contiguous [num_blocks,
// t, h, d] of kv_dtype (0 float32, 1 bfloat16, 2 float16), 16-byte aligned;
// tables: contiguous int32 [b, mb] of block ids in [0, num_blocks);
// positions: int32 [b].  scale: 1 / sqrt of the true head dim.  Returns a
// cudaError_t.
int sparknet_paged_attention(const void* q, const void* k_pool,
                             const void* v_pool, const void* tables,
                             const void* positions, void* o, int b, int h,
                             int d, int t, int mb, int kv_dtype, float scale,
                             void* stream) {
  // mb * t + 128: the last tile's column indices stay in int range
  if (b <= 0 || b > 65535 || h <= 0 || t <= 0 || mb <= 0 ||
      (long long)mb * t > INT32_MAX - 128 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kv_dtype) {
    case 0: return (int)launch_width<float>(d, qf, k_pool, v_pool, tb, ps, of, b, h, t, mb, scale, st);
    case 1: return (int)launch_width<__nv_bfloat16>(d, qf, k_pool, v_pool, tb, ps, of, b, h, t, mb, scale, st);
    case 2: return (int)launch_width<__half>(d, qf, k_pool, v_pool, tb, ps, of, b, h, t, mb, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Flash attention for Hopper (sm_90a): the forward (blocked online softmax)
// and its backward (further down), both on the tensor cores with float32
// accuracy.
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_kernels.py::_flash_kernel
// (launched by _flash_pallas).  For q, k, v of shape [B, H, S, D], float32:
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h, j] / sqrt(D)) v[b, h, j]
//
// with columns j > i masked when causal.  The [S, S] score matrix is never
// materialised: K and V are walked in tiles with a running max m and a
// running denominator l per query row, as the TPU kernel walks them in
// 128-wide steps (the flash-attention recurrence):
//
//   m' = max(m, max_j s_j);  p_j = exp(s_j - m');  corr = exp(m - m')
//   l' = l * corr + sum_j p_j;  o' = o * corr + sum_j p_j v_j
//
// and o / l is written at the end, and, when the caller asks for it, each
// row's log-sum-exp m + log l (the backward recomputes P from it; writing
// it changes nothing else).  m starts at -inf, as in the TPU kernel
// (:274); key 0 is live for every row, so m is finite after the first tile,
// and a fully masked tile changes nothing bit for bit (corr = 1, p = 0).  A
// masked column contributes exactly 0 (exp(-inf) = 0), which is what the
// TPU kernel's -1e30 gives; a causal tile of queries stops after the key
// tile that holds its last row's diagonal (the TPU kernel's early stop,
// :279), and a warp skips the key tiles past its own last row.
//
// What bounds it: operations.  4 * S^2 * D flops per (batch, head), halved
// when causal, against 3 reads and 1 write of [S, D]: at S = 2048, D = 64
// that is 2048 flops a byte, far above the card's balance.  Both products
// (S = Q K^T and O += P V) run on the tensor cores as
// mma.sync.m16n8k8.tf32 with a 3xTF32 split (CUTLASS's
// OpMultiplyAddFastF32): each float32 operand a becomes a_hi (a rounded to
// TF32) and a_lo = a - a_hi, and a_lo b_hi + a_hi b_lo + a_hi b_hi (small
// terms first) are summed in float32.  One TF32 product keeps about 3
// decimal digits and fails the float32 gate (rtol 1e-5); three keep about
// 21 bits (tests/test_torch_port_attention.py emulates both).  So the least
// time is 3 TF32 products per float32 product at the dense TF32 rate (495
// TFLOP/s on an H100 SXM, 165 TFLOP/s of float32 work): 0.208 ms at
// [4, 16, 2048, 64] causal.  At the char LM's prefill shape ([32, 4, 128,
// 16]) the work is tiny and the kernel is bound by latency and its launch.
//
// The design (mma.sync, not wgmma: a first tensor-core version):
//
//  - one CTA of 4 warps per (batch * head, 64-query tile); a warp owns 16
//    query rows, the M of the m16n8k8 product.  The query tiles of a causal
//    grid run heaviest first (blockIdx.y reversed, with blockIdx.x the
//    batch * head index, so every fibre's longest tile starts in the first
//    wave and no long tile is left for the tail);
//  - K/V tiles of BK keys (64; 32 at D = 128 and 256) are staged in dynamic shared
//    memory with cp.async, double buffered, so the next tile's loads fly
//    while this one is multiplied.  The ragged tail is bounded by index
//    (cp.async zero-fills rows past S), not padded in memory;
//  - the k index of each m16n8k8 product is permuted (logical k = t and t+4
//    of a quad's lane t taken from dims or keys 2t and 2t+1), which is free
//    since the product sums over k.  For S = Q K^T it makes a lane's two B
//    values adjacent (one 8-byte shared load, rows padded to D + 8 words so
//    a warp's loads hit 32 distinct banks).  For O += P V it makes the C
//    fragment of S (lane t holds score columns 2t, 2t+1) exactly the A
//    fragment that P needs, so P never leaves registers (no shared-memory
//    slab, no shuffles); V's rows are padded to D + 4 words;
//  - Q (pre-scaled by 1/sqrt(D)) stays in registers as float32 for D <= 64
//    and is split at each use; at D = 128 and 256 it is staged in shared
//    memory (at D = 256 Q and two K/V stages take 206 KB: one CTA an SM);
//  - the split is three integer and float operations (split() below), not
//    cvt.rna.tf32.f32, which sm_90 emulates in about five each: the split
//    is most of the kernel's instructions;
//  - the products are not chained in the tensor cores' own accumulator,
//    which loses bits (1.1x the gate at D = 128, and P V's error grows with
//    S: PERF.md): each k-step of Q K^T, and each 4 k-steps of P V, are
//    summed from zero on the tensor cores and added to S or O with a
//    float32 round-to-nearest add (kPvGroup);
//  - up to 255 registers a thread, 2 CTAs an SM: a 168-register cap for 3
//    spilled and was no faster;
//  - the softmax runs on the fragments: row max by two quad shuffles, one
//    expf per score, one rescale of the O fragment per tile; the row sum is
//    kept per lane and summed across the quad once, at the end.
//
// A query row's output depends only on its own (b, h) fibre and row: an
// m16n8k8 product computes each C element from its own A row, and a CTA's
// work does not depend on B.  So a row's result is the same bits alone or
// in any batch, which the token phase's "interleaved == alone" needs.
//
// The head dims are the zoo's (8 for transformer, 16 for charlm) and 32,
// 64, 128 and 256 (a head between them is zero-padded by the wrapper,
// ops/kernels.py), and above 256 any multiple of kDC = 128 lanes, run by
// the chunked kernels (flash_forward_wide_kernel and the wide walks of the
// backward, below; the wrapper pads a wider head to the next multiple);
// any other returns cudaErrorInvalidValue here.  At D = 256 the O
// accumulator alone is 128 registers a thread: ptxas's spills are printed
// by chip_smoke.py and kept in PERF.md.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

// k-steps of P V summed on the tensor cores before each float32 add
constexpr int kPvGroup = 4;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per CTA

template <int D>
struct FlashCfg {
  static constexpr int kBK = D <= 64 ? 64 : 32;  // keys a tile
  static constexpr bool kQRegs = D <= 64;        // Q fragments in registers
  static constexpr int kKS = D == 8 ? 24 : D + 8;  // K row stride, words
  static constexpr int kVS = D + 4;                // V row stride, words
  static constexpr int kQS = D + 8;                // Q row stride, words
  static constexpr int kStage = kBK * (kKS + kVS);  // floats a K/V stage
  static constexpr int kSmem =
      (2 * kStage + (kQRegs ? 0 : kBQ * kQS)) * (int)sizeof(float);
};

// x = hi + lo to about 2^-21 relative, as CUTLASS's OpMultiplyAddFastF32
// splits it: hi is x rounded to TF32 (to nearest, ties away: add half a
// TF32 ulp to the bits, clear the 13 bits TF32 drops), lo = x - hi exactly
// in float32, handed to the tensor core as it is (an m16n8k8 tf32 product
// reads the top 19 bits of each operand, so lo is truncated to TF32).
// Three integer/float operations instead of two cvt.rna.tf32.f32, which
// sm_90 emulates in about five each.  x is finite.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, chained in the tensor cores' accumulator, small
// terms first; b = (b0, b1) as float32
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec16, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (vec16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// D lanes of rows [r0, r0 + rows) of a fibre of row stride ld (D, or the
// whole head when D is one chunk of it) into shared memory at row stride
// `stride`; rows past S are zero-filled.  vec16: 16-byte copies (every
// pointer 16-byte aligned), else 4-byte ones.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* src, int r0, int rows,
                                          int S, bool vec16, int ld = D) {
  const int w = vec16 ? 4 : 1;
  const int per_row = D / w;
  for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
    const int row = c / per_row;
    const int col = (c % per_row) * w;
    const bool valid = r0 + row < S;
    const float* p = src + (valid ? (long long)(r0 + row) * ld + col : 0);
    cp_async(dst + row * stride + col, p, vec16, valid);
  }
}

// A warp's key tile of scores s (rows r0 = row g and r1 = g + 8 of its 16,
// keys j0 + nt*8 + 2t + (e & 1)): keys past each row's last live key (its
// diagonal when causal, else S - 1) to -inf.
template <int NT>
__device__ __forceinline__ void mask_scores(float (&s)[NT][4], int j0, int t,
                                            int last0, int last1) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j0 + nt * 8 + 2 * t + (e & 1);
      if (key > (e < 2 ? last0 : last1)) s[nt][e] = -INFINITY;
    }
  }
}

// The online softmax over one key tile of a warp's scores s, then O += P
// V: V's tile at `vs` (row stride VS), acc the warp's O fragments over KD
// 8-lane steps, (m, l) each row's running max and (lane-partial) sum.
template <int NT, int KD, int VS>
__device__ __forceinline__ void softmax_pv(float (&s)[NT][4], float (&acc)[KD][4],
                                           float& m0, float& m1, float& l0,
                                           float& l1, const float* vs, int g,
                                           int t) {
  static_assert(NT % kPvGroup == 0, "P V groups must tile a key tile");
  float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    mt0 = fmaxf(mt0, fmaxf(s[nt][0], s[nt][1]));
    mt1 = fmaxf(mt1, fmaxf(s[nt][2], s[nt][3]));
  }
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, w));
    mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, w));
  }
  const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
  const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    s[nt][0] = expf(s[nt][0] - mn0);
    s[nt][1] = expf(s[nt][1] - mn0);
    s[nt][2] = expf(s[nt][2] - mn1);
    s[nt][3] = expf(s[nt][3] - mn1);
    ps0 += s[nt][0] + s[nt][1];
    ps1 += s[nt][2] + s[nt][3];
  }
  l0 = l0 * corr0 + ps0;
  l1 = l1 * corr1 + ps1;
  m0 = mn0;
  m1 = mn1;
#pragma unroll
  for (int dn = 0; dn < KD; ++dn) {
    acc[dn][0] *= corr0;
    acc[dn][1] *= corr0;
    acc[dn][2] *= corr1;
    acc[dn][3] *= corr1;
  }
  // O += P V, k = keys permuted as for S: the C fragment of s[kt] is the A
  // fragment of P (row g: keys 2t, 2t+1; row g + 8 likewise).  kPvGroup
  // k-steps are summed on the tensor cores from zero, then added to O in
  // float32.
#pragma unroll
  for (int kt0 = 0; kt0 < NT; kt0 += kPvGroup) {
    uint32_t ph[kPvGroup][4], pl[kPvGroup][4];
#pragma unroll
    for (int q = 0; q < kPvGroup; ++q) {
      split(s[kt0 + q][0], ph[q][0], pl[q][0]);
      split(s[kt0 + q][2], ph[q][1], pl[q][1]);
      split(s[kt0 + q][1], ph[q][2], pl[q][2]);
      split(s[kt0 + q][3], ph[q][3], pl[q][3]);
    }
#pragma unroll
    for (int dn = 0; dn < KD; ++dn) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < kPvGroup; ++q) {
        const float* v0 = vs + ((kt0 + q) * 8 + 2 * t) * VS + g;
        mma_3xtf32(d, ph[q], pl[q], v0[dn * 8], v0[VS + dn * 8]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] = __fadd_rn(acc[dn][e], d[e]);
    }
  }
}

// The end of a warp's rows: l summed over the quad, o = acc / l written at
// lanes col0 + [0, KD * 8) of rows r0 and r1 (row stride ld, at ob), and,
// when lse is not null, each row's log-sum-exp m + log l.
template <int KD>
__device__ __forceinline__ void write_rows(const float (&acc)[KD][4], float m0,
                                           float m1, float l0, float l1,
                                           float* ob, float* lse, int ld,
                                           int col0, int r0, int r1, int S,
                                           int t) {
#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  if (lse != nullptr && t == 0) {  // m and l are the quad's, on every lane
    if (r0 < S) lse[r0] = m0 + logf(l0);
    if (r1 < S) lse[r1] = m1 + logf(l1);
  }
#pragma unroll
  for (int dn = 0; dn < KD; ++dn) {
    const int col = col0 + dn * 8 + 2 * t;
    if (r0 < S) {
      ob[(long long)r0 * ld + col] = acc[dn][0] / l0;
      ob[(long long)r0 * ld + col + 1] = acc[dn][1] / l0;
    }
    if (r1 < S) {
      ob[(long long)r1 * ld + col] = acc[dn][2] / l1;
      ob[(long long)r1 * ld + col + 1] = acc[dn][3] / l1;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_forward_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int causal,
                         float scale, int vec16) {
  using C = FlashCfg<D>;
  constexpr int BK = C::kBK, NT = BK / 8, KD = D / 8;
  static_assert(NT % kPvGroup == 0, "P V groups must tile a key tile");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + 2 * C::kStage;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;  // quad (row) and lane in quad
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const long long base = (long long)blockIdx.x * S * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  const int wrow = q0 + 16 * warp;  // the warp's first row
  const int r0 = wrow + g, r1 = r0 + 8;
  // keys [0, kend) are read by some row of this CTA
  const int kend = causal ? min(q0 + kBQ, S) : S;
  const int ntiles = (kend + BK - 1) / BK;

  if constexpr (!C::kQRegs) load_rows<D>(qs, C::kQS, qb, q0, kBQ, S, vec16);
  load_rows<D>(smem, C::kKS, kb, 0, BK, S, vec16);
  load_rows<D>(smem + BK * C::kKS, C::kVS, vb, 0, BK, S, vec16);
  cp_async_commit();

  // A fragments of Q (k permuted: [0], [2] at dims 2t, 2t+1 of row g;
  // [1], [3] of row g + 8), pre-scaled; split at each use
  float qf[C::kQRegs ? KD : 1][4];
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const int col = kk * 8 + 2 * t;
      const float* p0 = qb + (long long)r0 * D + col;
      const float* p1 = qb + (long long)r1 * D + col;
      qf[kk][0] = r0 < S ? p0[0] * scale : 0.f;
      qf[kk][1] = r1 < S ? p1[0] * scale : 0.f;
      qf[kk][2] = r0 < S ? p0[1] * scale : 0.f;
      qf[kk][3] = r1 < S ? p1[1] * scale : 0.f;
    }
  }

  float acc[KD][4];
#pragma unroll
  for (int dn = 0; dn < KD; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int last0 = causal ? min(r0, S - 1) : S - 1;
  const int last1 = causal ? min(r1, S - 1) : S - 1;

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * BK;
    if (it + 1 < ntiles) {
      float* nk = smem + ((it + 1) & 1) * C::kStage;
      load_rows<D>(nk, C::kKS, kb, j0 + BK, BK, S, vec16);
      load_rows<D>(nk + BK * C::kKS, C::kVS, vb, j0 + BK, BK, S, vec16);
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile (and Q) has landed
    __syncthreads();
    const float* ks = smem + (it & 1) * C::kStage;
    const float* vs = ks + BK * C::kKS;

    if (!causal || j0 <= wrow + 15) {  // warp-uniform: a live key for a row
      float s[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ah[4], al[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) split(qf[kk][e], ah[e], al[e]);
        } else {
          const float2 a0 = *reinterpret_cast<const float2*>(
              qs + (16 * warp + g) * C::kQS + kk * 8 + 2 * t);
          const float2 a1 = *reinterpret_cast<const float2*>(
              qs + (16 * warp + g + 8) * C::kQS + kk * 8 + 2 * t);
          split(a0.x * scale, ah[0], al[0]);
          split(a1.x * scale, ah[1], al[1]);
          split(a0.y * scale, ah[2], al[2]);
          split(a1.y * scale, ah[3], al[3]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          // B = K^T: lane (g, t) holds key nt*8 + g at dims 2t, 2t+1
          const float2 b = *reinterpret_cast<const float2*>(
              ks + (nt * 8 + g) * C::kKS + kk * 8 + 2 * t);
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          mma_3xtf32(d, ah, al, b.x, b.y);
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = __fadd_rn(s[nt][e], d[e]);
        }
      }
      // s[nt][e]: row e < 2 ? r0 : r1, key j0 + nt*8 + 2t + (e & 1)
      if (j0 + BK > S || (causal && j0 + BK - 1 > wrow))
        mask_scores<NT>(s, j0, t, last0, last1);
      softmax_pv<NT, KD, C::kVS>(s, acc, m0, m1, l0, l1, vs, g, t);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  write_rows<KD>(acc, m0, m1, l0, l1, o + base,
                 lse == nullptr ? nullptr : lse + (long long)blockIdx.x * S, D,
                 0, r0, r1, S, t);
}

// ---------------------------------------------------------------------------
// Heads wider than 256 lanes (the forward, then both walks of the backward
// further down).  The head is D = nc * kDC lanes (the wrapper zero-pads it
// to a multiple of kDC), and a third grid axis runs over its nc chunks of
// output lanes: a CTA computes the scores over all D dims, reading Q and K
// one chunk at a time through shared memory (S's k-steps in the order of
// the narrow instances: each summed from zero, then added in float32), and
// accumulates only its own chunk of O.  Every chunk's CTA forms the same
// scores, softmax and l bit for bit; chunk 0 writes the lse.  A query row's
// result still depends only on its own fibre, with no atomics: two
// launches, and a batch entry alone or in its batch, give the same bits.
//
// What it costs: each of the nc CTAs of a query tile recomputes S, so Q K^T
// is done nc times (about (nc + 1) / 2 times the narrow kernel's work at
// D = 512, causal or not), and Q is read again for every key tile.  The
// tiles are the D = 128 instance's (32 keys a tile, Q and K chunks at row
// stride kDC + 8, V at kDC + 4): two Q/K stages and one V tile take 121 KB,
// one CTA an SM.  These widths are correctness first: no shipped
// configuration reaches them.
constexpr int kDC = 128;  // lanes a chunk

struct WideCfg {
  static constexpr int kBK = 32;                  // keys a tile
  static constexpr int kQKS = kDC + 8;            // Q and K chunk row stride
  static constexpr int kVS = kDC + 4;             // V row stride
  static constexpr int kStageQK = (kBQ + kBK) * kQKS;  // floats a Q/K stage
  static constexpr int kSmem = (2 * kStageQK + kBK * kVS) * (int)sizeof(float);
};

__global__ void __launch_bounds__(kThreads, 1)
    flash_forward_wide_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o,
                              float* __restrict__ lse, int S, int D, int causal,
                              float scale, int vec16) {
  using C = WideCfg;
  constexpr int BK = C::kBK, NT = BK / 8, KD = kDC / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* vs = smem + 2 * C::kStageQK;

  const int nc = D / kDC, oc = blockIdx.z;  // chunks, and this CTA's own
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const long long base = (long long)blockIdx.x * S * D;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base + oc * kDC;
  const int wrow = q0 + 16 * warp;
  const int r0 = wrow + g, r1 = r0 + 8;
  const int kend = causal ? min(q0 + kBQ, S) : S;
  const int ntiles = (kend + BK - 1) / BK;
  const int nsteps = ntiles * nc;  // step it * nc + cc: chunk cc of tile it

  auto load_qk = [&](int f) {
    float* st = smem + (f & 1) * C::kStageQK;
    const int cc = f % nc;
    load_rows<kDC>(st, C::kQKS, qb + cc * kDC, q0, kBQ, S, vec16, D);
    load_rows<kDC>(st + kBQ * C::kQKS, C::kQKS, kb + cc * kDC, f / nc * BK, BK,
                   S, vec16, D);
  };
  load_qk(0);
  load_rows<kDC>(vs, C::kVS, vb, 0, BK, S, vec16, D);
  cp_async_commit();

  float acc[KD][4];
#pragma unroll
  for (int dn = 0; dn < KD; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int last0 = causal ? min(r0, S - 1) : S - 1;
  const int last1 = causal ? min(r1, S - 1) : S - 1;

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * BK;
    const bool live = !causal || j0 <= wrow + 15;  // warp-uniform
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      const int f = it * nc + cc;
      if (f + 1 < nsteps) load_qk(f + 1);
      cp_async_commit();
      cp_async_wait_one();  // step f (and, at cc = 0, this tile's V) landed
      __syncthreads();
      if (live) {
        const float* qs = smem + (f & 1) * C::kStageQK;
        const float* ks = qs + kBQ * C::kQKS;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          uint32_t ah[4], al[4];
          const float2 a0 = *reinterpret_cast<const float2*>(
              qs + (16 * warp + g) * C::kQKS + kk * 8 + 2 * t);
          const float2 a1 = *reinterpret_cast<const float2*>(
              qs + (16 * warp + g + 8) * C::kQKS + kk * 8 + 2 * t);
          split(a0.x * scale, ah[0], al[0]);
          split(a1.x * scale, ah[1], al[1]);
          split(a0.y * scale, ah[2], al[2]);
          split(a1.y * scale, ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const float2 b = *reinterpret_cast<const float2*>(
                ks + (nt * 8 + g) * C::kQKS + kk * 8 + 2 * t);
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma_3xtf32(d, ah, al, b.x, b.y);
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = __fadd_rn(s[nt][e], d[e]);
          }
        }
      }
      __syncthreads();  // stage f & 1 is refilled at step f + 2
    }
    if (live) {
      if (j0 + BK > S || (causal && j0 + BK - 1 > wrow))
        mask_scores<NT>(s, j0, t, last0, last1);
      softmax_pv<NT, KD, C::kVS>(s, acc, m0, m1, l0, l1, vs, g, t);
    }
    __syncthreads();  // V's tile is refilled next
    if (it + 1 < ntiles) load_rows<kDC>(vs, C::kVS, vb, j0 + BK, BK, S, vec16, D);
    cp_async_commit();
  }
  write_rows<KD>(acc, m0, m1, l0, l1, o + base,
                 lse == nullptr || oc != 0 ? nullptr : lse + (long long)blockIdx.x * S,
                 D, oc * kDC, r0, r1, S, t);
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory past 48 KB must be allowed for each kernel on each
// device: done at the first launch on a device, then remembered in the
// caller's flags (one per device; a static array beside each launch).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, std::atomic<bool>* allowed) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices)
    allowed[dev].store(true, std::memory_order_release);
  return err;
}


template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int bh, int S, int causal, float scale,
                   int vec16, cudaStream_t s) {
  constexpr int smem = FlashCfg<D>::kSmem;
  static std::atomic<bool> allowed[kMaxDevices];
  const cudaError_t err = allow_smem(flash_forward_kernel<D>, smem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + kBQ - 1) / kBQ);
  flash_forward_kernel<D><<<grid, kThreads, smem, s>>>(q, k, v, o, lse, S,
                                                        causal, scale, vec16);
  return cudaGetLastError();
}

// the forward at a head wider than 256 lanes (flash_forward_wide_kernel)
cudaError_t launch_wide(const float* q, const float* k, const float* v, float* o,
                        float* lse, int bh, int S, int D, int causal, float scale,
                        int vec16, cudaStream_t s) {
  static std::atomic<bool> allowed[kMaxDevices];
  const cudaError_t err = allow_smem(flash_forward_wide_kernel, WideCfg::kSmem, allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + kBQ - 1) / kBQ, D / kDC);
  flash_forward_wide_kernel<<<grid, kThreads, WideCfg::kSmem, s>>>(
      q, k, v, o, lse, S, D, causal, scale, vec16);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (B3'): dQ, dK, dV of o = softmax(scale q k^T) v, from the saved
// q, k, v, o, the forward's lse and the upstream gradient dO:
//
//   P = exp(scale q k^T - lse)   (0 where masked)
//   delta_i = sum_d dO[i, d] o[i, d]
//   dV = P^T dO;  dS = P * (dO v^T - delta);  dQ = scale dS k;
//   dK = scale dS^T q
//
// Replaces sparknet_tpu/ops/pallas_kernels.py::_flash_diff_bwd, which on the
// TPU is XLA's VJP of the unblocked attention_xla (it builds the [S, S]
// scores).  Here P and dS are recomputed a tile at a time in registers.
// Three launches: delta (one warp a row); dK and dV, one CTA per (fibre,
// key tile) walking the query tiles that can see its keys; dQ, one CTA per
// (fibre, query tile, heaviest causal tiles first) walking the key tiles
// its rows can see.  dK/dV and dQ sum over different axes, so one walk
// would need atomics across CTAs; two walks let each CTA own its outputs
// and take every sum in an order fixed by the shapes (over d in k-steps,
// then over the tiles in index order): two runs give the same bits, and a
// fibre's gradients do not depend on the other fibres of its batch.
//
// What bounds it: operations.  Five [S, S, D] products (about 10 S^2 D
// flops a fibre, halved when causal); S = q k^T and dO v^T are recomputed
// in both walks, so the kernels do 7.  All seven run on the tensor cores as
// the forward's: mma.sync.m16n8k8.tf32 in a 3xTF32 split (split(),
// mma_tf32()), 165 TFLOP/s of float32-accurate work at most.
//
// Both walks are shaped like the forward: 4 warps, a warp owns 16 rows of
// the product's M (query rows in the dQ walk, keys in the dK/dV walk), and
// the walked tiles come through two cp.async stages.  A tile of either
// walk is two products with k = the head dims, then one or two with k = the
// walked rows:
//
//  - dims_product(): S = Q K^T and dP = dO V^T (dQ walk), S^T = K Q^T and
//    dP^T = V dO^T (dK/dV walk).  A and B are rows of tiles in shared memory
//    (row stride D + 4 words) read with k = dims t and t + 4 of each
//    8-dim step, the m16n8k8 layout as it is: a warp's scalar loads of
//    lane (g, t) hit bank 4g + t, 32 distinct banks;
//  - the elementwise step on the C fragments: P = exp(scale s - lse) (0
//    where masked) and dS = P (dP - delta), with lse and delta of the
//    fragment's rows (dQ walk: two rows a lane, in registers) or columns
//    (dK/dV walk: from the query tile's lse and delta in shared memory);
//  - rows_product(): dQ += dS K, dV += P^T dO, dK += dS^T Q.  Their k is
//    the walked rows, permuted as the forward's P V (logical k = t, t + 4
//    of lane t are rows 2t, 2t + 1), so the C fragment of P or dS is the A
//    fragment as it stands: P and dS never leave registers.  B is read as
//    the forward reads V (rows 2t, 2t + 1, dim g: bank 8t + g);
//  - in both, kBwdGroup k-steps are chained on the tensor cores from zero,
//    their small terms first (mma_3xtf32_steps), and added in float32.
//    The forward sums each k-step of Q K^T from zero: four chained k-steps
//    issue a quarter of its float32 adds and meet the same gates.
//
// A causal warp skips the tiles that none of its rows can see (the skip is
// warp-uniform, as the forward's), and masks only the tiles that cross its
// diagonal or the ragged end.  Accumulators are D / 8 fragments a thread,
// two of them (dK, dV) in the dK/dV walk: 128 registers at D = 128; at D =
// 256 two warps share 16 keys and each keeps dK and dV of half the dims
// (kDS), computing S^T and dP^T both: every head dim runs on the tensor
// cores.
//
// Tiles (BwdCfg): the dQ walk's K/V tiles of kKT keys, the dK/dV walk's
// Q/dO tiles of kQT queries: 64 up to D = 32, 32 above (16 for the dQ walk
// at D = 256), so that two CTAs share an SM up to D = 64 (one at 128 and
// 256, whose tiles fill 135 and 200 KB).  32-row tiles keep D = 64 off
// spills and were 10 % faster there than 64; at D = 128 two CTAs an SM, by
// 16-row tiles or by one cp.async stage, were slower than one; walked
// tiles split once a CTA into hi and lo planes (no split a warp) were
// slower at D = 64 (PERF.md).

constexpr int kBwdThreads = 256;  // the delta kernel's
// k-steps a backward product chains on the tensor cores before each float32
// add (mma_3xtf32_steps)
constexpr int kBwdGroup = 4;

template <int D>
struct BwdCfg {
  static constexpr int kRS = D + 4;                           // row stride, words
  static constexpr int kKT = D <= 32 ? 64 : D <= 128 ? 32 : 16;  // dQ walk: keys a tile
  static constexpr int kDS = D == 256 ? 2 : 1;  // dK/dV walk: warps sharing 16 keys
  static constexpr int kKC = 16 * kWarps / kDS;  // dK/dV walk: keys a CTA
  static constexpr int kQT = D <= 32 ? 64 : 32;  // dK/dV walk: queries a tile
  static constexpr int kStageQ = 2 * kKT * kRS;             // K, V
  static constexpr int kStageKV = 2 * kQT * kRS + 2 * kQT;  // Q, dO, lse, delta
  static constexpr int kSmemQ = (2 * kStageQ + 2 * kBQ * kRS) * (int)sizeof(float);
  static constexpr int kSmemKV = (2 * kStageKV + 2 * kKC * kRS) * (int)sizeof(float);
  static_assert(kStageKV % 4 == 0, "16-byte aligned stages");
};

// d += the 3xTF32 products of G k-steps, chained on the tensor cores: the
// 2G small terms (a_lo b_hi, a_hi b_lo) first, then the G large ones.  The
// accumulator truncates what is added to it, so a small term added after a
// large one loses the bits it carries: in that order (the forward's) two
// chained k-steps miss the dQ gate; in this one four meet it.
template <int G>
__device__ __forceinline__ void mma_3xtf32_steps(float (&d)[4],
                                                 const uint32_t (&ah)[G][4],
                                                 const uint32_t (&al)[G][4],
                                                 const uint32_t (&bh)[G][2],
                                                 const uint32_t (&bl)[G][2]) {
#pragma unroll
  for (int u = 0; u < G; ++u) {
    mma_tf32(d, al[u], bh[u][0], bh[u][1]);
    mma_tf32(d, ah[u], bl[u][0], bl[u][1]);
  }
#pragma unroll
  for (int u = 0; u < G; ++u) mma_tf32(d, ah[u], bh[u][0], bh[u][1]);
}

// c = A B^T over the D dims: A the 16 rows at `a`, B the NT * 8 rows at `b`
// (shared memory, row stride D + 4).  Each kBwdGroup 8-dim k-steps are
// summed from zero (mma_3xtf32_steps), then added to c in float32.  With
// kZero false, c is not zeroed first: a head wider than one chunk adds its
// chunks' products in order, the sums of one product over all its dims.
template <int D, int NT, bool kZero = true>
__device__ __forceinline__ void dims_product(float (&c)[NT][4], const float* a,
                                             const float* b, int g, int t) {
  constexpr int RS = D + 4, G = D / 8 < kBwdGroup ? D / 8 : kBwdGroup;
  if constexpr (kZero) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
  }
#pragma unroll
  for (int kk0 = 0; kk0 < D / 8; kk0 += G) {
    // A: rows g and g + 8 at dims kk*8 + t ([0], [1]) and + 4 ([2], [3])
    uint32_t ah[G][4], al[G][4];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float* a0 = a + g * RS + (kk0 + u) * 8 + t;
      split(a0[0], ah[u][0], al[u][0]);
      split(a0[8 * RS], ah[u][1], al[u][1]);
      split(a0[4], ah[u][2], al[u][2]);
      split(a0[8 * RS + 4], ah[u][3], al[u][3]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // B^T: row nt*8 + g at dims kk*8 + t and + 4
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int u = 0; u < G; ++u) {
        const float* b0 = b + (nt * 8 + g) * RS + (kk0 + u) * 8 + t;
        split(b0[0], bh[u][0], bl[u][0]);
        split(b0[4], bh[u][1], bl[u][1]);
      }
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32_steps<G>(d, ah, al, bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[nt][e] = __fadd_rn(c[nt][e], d[e]);
    }
  }
}

// acc += F B: F's C fragments f (16 rows by the NT * 8 walked rows, from
// dims_product) as A fragments, B the walked rows at `b` (shared memory,
// row stride D + 4) over ND * 8 dims.  k = walked rows 2t, 2t + 1 for lane
// t (the forward's P V); each kBwdGroup k-steps summed from zero
// (mma_3xtf32_steps), then added to acc in float32.
template <int D, int NT, int ND>
__device__ __forceinline__ void rows_product(float (&acc)[ND][4],
                                             const float (&f)[NT][4],
                                             const float* b, int g, int t) {
  constexpr int RS = D + 4, G = NT < kBwdGroup ? NT : kBwdGroup;
  static_assert(NT % G == 0, "k-step groups must tile a walked tile");
#pragma unroll
  for (int kt0 = 0; kt0 < NT; kt0 += G) {
    uint32_t fh[G][4], fl[G][4];
#pragma unroll
    for (int q = 0; q < G; ++q) {
      split(f[kt0 + q][0], fh[q][0], fl[q][0]);
      split(f[kt0 + q][2], fh[q][1], fl[q][1]);
      split(f[kt0 + q][1], fh[q][2], fl[q][2]);
      split(f[kt0 + q][3], fh[q][3], fl[q][3]);
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float* b0 = b + ((kt0 + q) * 8 + 2 * t) * RS + dn * 8 + g;
        split(b0[0], bh[q][0], bl[q][0]);
        split(b0[RS], bh[q][1], bl[q][1]);
      }
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32_steps<G>(d, fh, fl, bh, bl);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dn][e] = __fadd_rn(acc[dn][e], d[e]);
    }
  }
}

// The dK/dV walk's elementwise step on a warp's tile: S^T (st) and dP^T
// (dpt), keys key0/key1 by queries i0 + nt*8 + 2t + (e & 1), become P^T =
// exp(scale s - lse) (0 where masked: past S, or above the diagonal when
// causal; checked only on an edge tile) and dS^T = P^T (dP^T - delta), with
// lse and delta of the query tile at ls and dls in shared memory.
template <int NT>
__device__ __forceinline__ void dkv_probs(float (&st)[NT][4], float (&dpt)[NT][4],
                                          const float* ls, const float* dls,
                                          int i0, int key0, int key1, int S,
                                          int causal, bool edge, float scale,
                                          int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * t;
    const float2 l = *reinterpret_cast<const float2*>(ls + c);
    const float2 dl = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = i0 + c + (e & 1);
      const bool live =
          !edge || (query < S && (!causal || query >= (e < 2 ? key0 : key1)));
      const float p = live ? expf(fmaf(st[nt][e], scale, -(e & 1 ? l.y : l.x))) : 0.f;
      st[nt][e] = p;
      dpt[nt][e] = p * (dpt[nt][e] - (e & 1 ? dl.y : dl.x));
    }
  }
}

// The dQ walk's elementwise step on a warp's tile: S (s), rows r0/r1 by keys
// j0 + nt*8 + 2t + (e & 1), becomes dS = P (dP - delta), P = exp(scale s -
// lse) (0 past each row's last live key; checked only on an edge tile).
template <int NT>
__device__ __forceinline__ void dq_probs(float (&s)[NT][4], const float (&dp)[NT][4],
                                         int j0, int last0, int last1, float lse0,
                                         float lse1, float dl0, float dl1,
                                         bool edge, float scale, int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e >= 2;
      const int key = j0 + nt * 8 + 2 * t + (e & 1);
      const bool live = !edge || key <= (hi ? last1 : last0);
      const float p = live ? expf(fmaf(s[nt][e], scale, -(hi ? lse1 : lse0))) : 0.f;
      s[nt][e] = p * (dp[nt][e] - (hi ? dl1 : dl0));
    }
  }
}

// A warp's ND 8-lane steps of rows r0 and r1 (acc, times `mult`) into
// out[row * ld + col0 + ...], rows past S left out.
template <int ND>
__device__ __forceinline__ void write_pairs(const float (&acc)[ND][4], float mult,
                                            float* out, long long ld, long long col0,
                                            int r0, int r1, int S, int t) {
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    const long long col = col0 + dn * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<float2*>(out + r0 * ld + col) =
          make_float2(mult * acc[dn][0], mult * acc[dn][1]);
    if (r1 < S)
      *reinterpret_cast<float2*>(out + r1 * ld + col) =
          make_float2(mult * acc[dn][2], mult * acc[dn][3]);
  }
}

// delta[row] = sum_d dO[row, d] o[row, d]: one warp a row, lanes over d,
// then a fixed xor tree
__global__ void __launch_bounds__(kBwdThreads)
    flash_backward_delta_kernel(const float* __restrict__ o,
                                const float* __restrict__ dout,
                                float* __restrict__ delta, long long rows,
                                int D) {
  const long long row = (long long)blockIdx.x * (kBwdThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(dout[row * D + d], o[row * D + d], acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) delta[row] = acc;
}

// the dK/dV walk's query tile at i0 into a stage: Q, dO (kQT rows), then
// lse and delta (kQT each; 4-byte copies, a fibre's rows are not 16-byte
// aligned); rows past S are zero
template <int D>
__device__ __forceinline__ void load_query_tile(float* st, const float* qb,
                                                const float* dob, const float* lb,
                                                const float* db, int i0, int S) {
  using C = BwdCfg<D>;
  constexpr int QT = C::kQT;
  load_rows<D>(st, C::kRS, qb, i0, QT, S, true);
  load_rows<D>(st + QT * C::kRS, C::kRS, dob, i0, QT, S, true);
  float* ls = st + 2 * QT * C::kRS;
  for (int c = threadIdx.x; c < 2 * QT; c += kThreads) {
    const int row = i0 + c % QT;
    const bool valid = row < S;
    cp_async(ls + c, (c < QT ? lb : db) + (valid ? row : 0), false, valid);
  }
}

// dK and dV of keys [k0, k0 + kKC) of fibre blockIdx.x: warp w owns keys
// k0 + 16 (w / kDS) + [0, 16) and the dims [D / kDS * (w % kDS), + D / kDS)
// of their gradients; it walks the query tiles that can see its keys.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_backward_dkv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int S, int causal, float scale) {
  using C = BwdCfg<D>;
  constexpr int QT = C::kQT, NT = QT / 8, RS = C::kRS, DS = C::kDS;
  constexpr int KC = C::kKC, DW = D / DS, ND = DW / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem + 2 * C::kStageKV;
  float* vs = ks + KC * RS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / DS, d0 = DW * (warp % DS);
  const int k0 = blockIdx.y * KC;
  const int wkey = k0 + 16 * kg;  // the warp's first key
  const int key0 = wkey + g, key1 = key0 + 8;
  const long long base = (long long)blockIdx.x * S * D;
  const long long rbase = (long long)blockIdx.x * S;
  const float *qb = q + base, *dob = dout + base;
  const float *lb = lse + rbase, *db = delta + rbase;
  // queries above k0 cannot see these keys when causal
  const int istart = causal ? k0 / QT * QT : 0;
  const int ntiles = (S - istart + QT - 1) / QT;

  load_rows<D>(ks, RS, k + base, k0, KC, S, true);
  load_rows<D>(vs, RS, v + base, k0, KC, S, true);
  load_query_tile<D>(smem, qb, dob, lb, db, istart, S);
  cp_async_commit();

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int i0 = istart + it * QT;
    if (it + 1 < ntiles)
      load_query_tile<D>(smem + ((it + 1) & 1) * C::kStageKV, qb, dob, lb, db,
                         i0 + QT, S);
    cp_async_commit();
    cp_async_wait_one();  // this tile (and K, V) has landed
    __syncthreads();
    const float* qs = smem + (it & 1) * C::kStageKV;
    const float* dos = qs + QT * RS;
    const float* ls = dos + QT * RS;
    const float* dls = ls + QT;

    if (!causal || i0 + QT - 1 >= wkey) {  // warp-uniform: a query sees a key
      float st[NT][4], dpt[NT][4];
      dims_product<D, NT>(st, ks + 16 * kg * RS, qs, g, t);
      dims_product<D, NT>(dpt, vs + 16 * kg * RS, dos, g, t);
      // st[nt][e]: key e < 2 ? key0 : key1, query i0 + nt*8 + 2t + (e & 1)
      const bool edge = i0 + QT > S || (causal && i0 < wkey + 15);
      dkv_probs<NT>(st, dpt, ls, dls, i0, key0, key1, S, causal, edge, scale, t);
      rows_product<D, NT, ND>(acc_v, st, dos + d0, g, t);
      rows_product<D, NT, ND>(acc_k, dpt, qs + d0, g, t);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  write_pairs<ND>(acc_k, scale, dk + base, D, d0, key0, key1, S, t);
  write_pairs<ND>(acc_v, 1.f, dv + base, D, d0, key0, key1, S, t);
}

// dQ of query rows [q0, q0 + kBQ) of fibre blockIdx.x, heaviest causal
// tiles first: warp w owns rows q0 + 16 w + [0, 16) and walks the K/V tiles
// its rows can see.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_backward_dq_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int S, int causal,
                             float scale) {
  using C = BwdCfg<D>;
  constexpr int BK = C::kKT, NT = BK / 8, KD = D / 8, RS = C::kRS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + 2 * C::kStageQ;
  float* dos = qs + kBQ * RS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const long long base = (long long)blockIdx.x * S * D;
  const long long rbase = (long long)blockIdx.x * S;
  const float *kb = k + base, *vb = v + base;
  const int wrow = q0 + 16 * warp;  // the warp's first row
  const int r0 = wrow + g, r1 = r0 + 8;
  // keys [0, kend) are seen by some row of this CTA
  const int kend = causal ? min(q0 + kBQ, S) : S;
  const int ntiles = (kend + BK - 1) / BK;

  load_rows<D>(qs, RS, q + base, q0, kBQ, S, true);
  load_rows<D>(dos, RS, dout + base, q0, kBQ, S, true);
  load_rows<D>(smem, RS, kb, 0, BK, S, true);
  load_rows<D>(smem + BK * RS, RS, vb, 0, BK, S, true);
  cp_async_commit();

  const float lse0 = r0 < S ? lse[rbase + r0] : 0.f;
  const float lse1 = r1 < S ? lse[rbase + r1] : 0.f;
  const float dl0 = r0 < S ? delta[rbase + r0] : 0.f;
  const float dl1 = r1 < S ? delta[rbase + r1] : 0.f;
  const int last0 = causal ? min(r0, S - 1) : S - 1;
  const int last1 = causal ? min(r1, S - 1) : S - 1;
  float acc[KD][4];
#pragma unroll
  for (int dn = 0; dn < KD; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * BK;
    if (it + 1 < ntiles) {
      float* nk = smem + ((it + 1) & 1) * C::kStageQ;
      load_rows<D>(nk, RS, kb, j0 + BK, BK, S, true);
      load_rows<D>(nk + BK * RS, RS, vb, j0 + BK, BK, S, true);
    }
    cp_async_commit();
    cp_async_wait_one();  // this tile (and Q, dO) has landed
    __syncthreads();
    const float* ks = smem + (it & 1) * C::kStageQ;
    const float* vs = ks + BK * RS;

    if (!causal || j0 <= wrow + 15) {  // warp-uniform: a live key for a row
      float s[NT][4], dp[NT][4];
      dims_product<D, NT>(s, qs + 16 * warp * RS, ks, g, t);
      dims_product<D, NT>(dp, dos + 16 * warp * RS, vs, g, t);
      // s[nt][e]: row e < 2 ? r0 : r1, key j0 + nt*8 + 2t + (e & 1); dS in s
      const bool edge = j0 + BK > S || (causal && j0 + BK - 1 > wrow);
      dq_probs<NT>(s, dp, j0, last0, last1, lse0, lse1, dl0, dl1, edge, scale, t);
      rows_product<D, NT, KD>(acc, s, ks, g, t);
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

  write_pairs<KD>(acc, scale, dq + base, D, 0, r0, r1, S, t);
}

// The backward's two walks at a head of D = nc * kDC lanes, D > 256: a
// third grid axis over the nc chunks of each walk's outputs.  A tile of
// either walk forms S and dP over all the dims, each chunk of its operands
// streamed through one shared-memory stage (dims_product without zeroing,
// chunk by chunk: the narrow instances' order of sums over the dims), then
// P and dS, then the rows products into the CTA's own chunk, whose operand
// rows (Q and dO, or K) come in a second buffer with the tile.  The stage
// is single-buffered: it takes 101 KB (the walked tile's two chunks and
// the CTA's own rows' two chunks), and a second one would not fit beside
// the dK/dV walk's 34 KB own-chunk buffer (the dQ walk, 17 KB, keeps the
// same shape: these widths are correctness first).  Tiles and warps are
// the D = 128 instance's: 64
// keys a dK/dV CTA against 32-query tiles, 64 queries a dQ CTA against
// 32-key tiles; each warp owns 16 rows and kDC lanes of its outputs.
struct WideBwdCfg {
  static constexpr int kRS = kDC + 4;   // row stride, words
  static constexpr int kKC = kBQ;       // dK/dV walk: keys a CTA
  static constexpr int kQT = 32;        // dK/dV walk: queries a tile
  static constexpr int kKT = 32;        // dQ walk: keys a tile
  // dK/dV walk: stage K, V (kKC rows), Q, dO (kQT rows); own Q, dO; lse, delta
  static constexpr int kStageKV = 2 * (kKC + kQT) * kRS;
  static constexpr int kSmemKV = (kStageKV + 2 * kQT * kRS + 2 * kQT) * (int)sizeof(float);
  // dQ walk: stage Q, dO (kBQ rows), K, V (kKT rows); own K
  static constexpr int kStageQ = 2 * (kBQ + kKT) * kRS;
  static constexpr int kSmemQ = (kStageQ + kKT * kRS) * (int)sizeof(float);
};

__global__ void __launch_bounds__(kThreads, 1)
    flash_backward_dkv_wide_kernel(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ delta,
                                   float* __restrict__ dk, float* __restrict__ dv,
                                   int S, int D, int causal, float scale) {
  using C = WideBwdCfg;
  constexpr int QT = C::kQT, NT = QT / 8, RS = C::kRS, KC = C::kKC, ND = kDC / 8;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;  // the stage: K, V, Q, dO chunks
  float* vs = ks + KC * RS;
  float* qs = vs + KC * RS;
  float* dos = qs + QT * RS;
  float* qo = smem + C::kStageKV;  // the own chunk of Q and dO, lse, delta
  float* doo = qo + QT * RS;
  float* ls = doo + QT * RS;
  float* dls = ls + QT;

  const int nc = D / kDC, oc = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.y * KC;
  const int wkey = k0 + 16 * warp;
  const int key0 = wkey + g, key1 = key0 + 8;
  const long long base = (long long)blockIdx.x * S * D;
  const long long rbase = (long long)blockIdx.x * S;
  const float *qb = q + base, *dob = dout + base, *kb = k + base, *vb = v + base;
  const float *lb = lse + rbase, *db = delta + rbase;
  const int istart = causal ? k0 / QT * QT : 0;
  const int ntiles = (S - istart + QT - 1) / QT;

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dn][e] = acc_v[dn][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int i0 = istart + it * QT;
    const bool seen = !causal || i0 + QT - 1 >= wkey;  // warp-uniform
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      if (cc == 0) {  // the tile's own chunk, lse and delta, read after the walk
        load_rows<kDC>(qo, RS, qb + oc * kDC, i0, QT, S, true, D);
        load_rows<kDC>(doo, RS, dob + oc * kDC, i0, QT, S, true, D);
        for (int c = threadIdx.x; c < 2 * QT; c += kThreads) {
          const int row = i0 + c % QT;
          const bool valid = row < S;
          cp_async(ls + c, (c < QT ? lb : db) + (valid ? row : 0), false, valid);
        }
      }
      load_rows<kDC>(ks, RS, kb + cc * kDC, k0, KC, S, true, D);
      load_rows<kDC>(vs, RS, vb + cc * kDC, k0, KC, S, true, D);
      load_rows<kDC>(qs, RS, qb + cc * kDC, i0, QT, S, true, D);
      load_rows<kDC>(dos, RS, dob + cc * kDC, i0, QT, S, true, D);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (seen) {
        dims_product<kDC, NT, false>(st, ks + 16 * warp * RS, qs, g, t);
        dims_product<kDC, NT, false>(dpt, vs + 16 * warp * RS, dos, g, t);
      }
      __syncthreads();  // the stage is refilled next
    }
    if (seen) {
      const bool edge = i0 + QT > S || (causal && i0 < wkey + 15);
      dkv_probs<NT>(st, dpt, ls, dls, i0, key0, key1, S, causal, edge, scale, t);
      rows_product<kDC, NT, ND>(acc_v, st, doo, g, t);
      rows_product<kDC, NT, ND>(acc_k, dpt, qo, g, t);
    }
    __syncthreads();  // the own chunk is refilled next
  }

  write_pairs<ND>(acc_k, scale, dk + base, D, oc * kDC, key0, key1, S, t);
  write_pairs<ND>(acc_v, 1.f, dv + base, D, oc * kDC, key0, key1, S, t);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_backward_dq_wide_kernel(const float* __restrict__ q,
                                  const float* __restrict__ k,
                                  const float* __restrict__ v,
                                  const float* __restrict__ dout,
                                  const float* __restrict__ lse,
                                  const float* __restrict__ delta,
                                  float* __restrict__ dq, int S, int D,
                                  int causal, float scale) {
  using C = WideBwdCfg;
  constexpr int BK = C::kKT, NT = BK / 8, KD = kDC / 8, RS = C::kRS;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;  // the stage: Q, dO, K, V chunks
  float* dos = qs + kBQ * RS;
  float* ks = dos + kBQ * RS;
  float* vs = ks + BK * RS;
  float* ko = smem + C::kStageQ;  // the own chunk of K

  const int nc = D / kDC, oc = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const long long base = (long long)blockIdx.x * S * D;
  const long long rbase = (long long)blockIdx.x * S;
  const float *qb = q + base, *dob = dout + base, *kb = k + base, *vb = v + base;
  const int wrow = q0 + 16 * warp;
  const int r0 = wrow + g, r1 = r0 + 8;
  const int kend = causal ? min(q0 + kBQ, S) : S;
  const int ntiles = (kend + BK - 1) / BK;

  const float lse0 = r0 < S ? lse[rbase + r0] : 0.f;
  const float lse1 = r1 < S ? lse[rbase + r1] : 0.f;
  const float dl0 = r0 < S ? delta[rbase + r0] : 0.f;
  const float dl1 = r1 < S ? delta[rbase + r1] : 0.f;
  const int last0 = causal ? min(r0, S - 1) : S - 1;
  const int last1 = causal ? min(r1, S - 1) : S - 1;
  float acc[KD][4];
#pragma unroll
  for (int dn = 0; dn < KD; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * BK;
    const bool seen = !causal || j0 <= wrow + 15;  // warp-uniform
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    for (int cc = 0; cc < nc; ++cc) {
      if (cc == 0) load_rows<kDC>(ko, RS, kb + oc * kDC, j0, BK, S, true, D);
      load_rows<kDC>(qs, RS, qb + cc * kDC, q0, kBQ, S, true, D);
      load_rows<kDC>(dos, RS, dob + cc * kDC, q0, kBQ, S, true, D);
      load_rows<kDC>(ks, RS, kb + cc * kDC, j0, BK, S, true, D);
      load_rows<kDC>(vs, RS, vb + cc * kDC, j0, BK, S, true, D);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (seen) {
        dims_product<kDC, NT, false>(s, qs + 16 * warp * RS, ks, g, t);
        dims_product<kDC, NT, false>(dp, dos + 16 * warp * RS, vs, g, t);
      }
      __syncthreads();  // the stage is refilled next
    }
    if (seen) {
      const bool edge = j0 + BK > S || (causal && j0 + BK - 1 > wrow);
      dq_probs<NT>(s, dp, j0, last0, last1, lse0, lse1, dl0, dl1, edge, scale, t);
      rows_product<kDC, NT, KD>(acc, s, ko, g, t);
    }
    __syncthreads();  // the own chunk is refilled next
  }

  write_pairs<KD>(acc, scale, dq + base, D, oc * kDC, r0, r1, S, t);
}

template <int D>
cudaError_t launch_backward(const float* q, const float* k, const float* v,
                            const float* o, const float* lse,
                            const float* dout, float* dq, float* dk,
                            float* dv, float* delta, int bh, int S,
                            int causal, float scale, cudaStream_t s) {
  using C = BwdCfg<D>;
  static std::atomic<bool> allowed_kv[kMaxDevices], allowed_q[kMaxDevices];
  cudaError_t err = allow_smem(flash_backward_dkv_kernel<D>, C::kSmemKV, allowed_kv);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_backward_dq_kernel<D>, C::kSmemQ, allowed_q);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)bh * S;
  constexpr int kRowsABlock = kBwdThreads / 32;
  flash_backward_delta_kernel
      <<<(unsigned)((rows + kRowsABlock - 1) / kRowsABlock), kBwdThreads, 0, s>>>(
          o, dout, delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_backward_dkv_kernel<D>
      <<<dim3(bh, (S + C::kKC - 1) / C::kKC), kThreads, C::kSmemKV, s>>>(
          q, k, v, dout, lse, delta, dk, dv, S, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_backward_dq_kernel<D>
      <<<dim3(bh, (S + kBQ - 1) / kBQ), kThreads, C::kSmemQ, s>>>(
          q, k, v, dout, lse, delta, dq, S, causal, scale);
  return cudaGetLastError();
}

// the three launches of the backward at a head wider than 256 lanes: the
// delta pass, then the wide walks
cudaError_t launch_backward_wide(const float* q, const float* k, const float* v,
                                 const float* o, const float* lse,
                                 const float* dout, float* dq, float* dk,
                                 float* dv, float* delta, int bh, int S, int D,
                                 int causal, float scale, cudaStream_t s) {
  using C = WideBwdCfg;
  static std::atomic<bool> allowed_kv[kMaxDevices], allowed_q[kMaxDevices];
  cudaError_t err = allow_smem(flash_backward_dkv_wide_kernel, C::kSmemKV, allowed_kv);
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_backward_dq_wide_kernel, C::kSmemQ, allowed_q);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)bh * S;
  constexpr int kRowsABlock = kBwdThreads / 32;
  flash_backward_delta_kernel
      <<<(unsigned)((rows + kRowsABlock - 1) / kRowsABlock), kBwdThreads, 0, s>>>(
          o, dout, delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_backward_dkv_wide_kernel
      <<<dim3(bh, (S + C::kKC - 1) / C::kKC, D / kDC), kThreads, C::kSmemKV, s>>>(
          q, k, v, dout, lse, delta, dk, dv, S, D, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_backward_dq_wide_kernel
      <<<dim3(bh, (S + kBQ - 1) / kBQ, D / kDC), kThreads, C::kSmemQ, s>>>(
          q, k, v, dout, lse, delta, dq, S, D, causal, scale);
  return cudaGetLastError();
}

// the launch of head dim d: the instances of every head dim the wrapper
// takes up to 256 lanes (ops/kernels.py ATTENTION_HEAD_DIMS); a wider head
// goes to the wide kernels before this switch
#define SPARKNET_FLASH_DISPATCH(d, CALL) \
  switch (d) {                           \
    case 8: return (int)CALL(8);         \
    case 16: return (int)CALL(16);       \
    case 32: return (int)CALL(32);       \
    case 64: return (int)CALL(64);       \
    case 128: return (int)CALL(128);     \
    case 256: return (int)CALL(256);     \
    default: return (int)cudaErrorInvalidValue; \
  }

// bh fibres on the grid's x axis, s rows in tiles of `tile` on its y axis,
// a wide head's chunks on its z axis
bool shape_ok(long long bh, long long s, int d, int tile) {
  return bh > 0 && s > 0 && bh <= INT32_MAX && s <= INT32_MAX / 256 &&
         (s + tile - 1) / tile <= 65535 && d > 0 &&
         (d <= 256 || (d % kDC == 0 && d / kDC <= 65535));
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous float32 [bh, s, d] on the device (bh = batch *
// heads).  lse: float32 [bh, s], written with each row's log-sum-exp of
// scale q k^T (the backward's input) when not null.  causal: 0 or 1.
// scale: the factor on q k^T (1 / sqrt of the true head dim).  d: 8, 16,
// 32, 64, 128, 256, or a multiple of 128 above 256.  Returns a
// cudaError_t.
int sparknet_flash_attention_forward(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     long long bh, long long s, int d,
                                     int causal, float scale, void* stream) {
  if (!shape_ok(bh, s, d, kBQ)) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbh = (int)bh, ns = (int)s, c = causal ? 1 : 0;
  // 16-byte copies need every fibre 16-byte aligned: d is a multiple of 4,
  // so the base pointers decide
  const int vec16 =
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0 ? 1 : 0;
  if (d > 256) return (int)launch_wide(qf, kf, vf, of, lf, nbh, ns, d, c, scale, vec16, st);
#define SPARKNET_FWD(D) launch<D>(qf, kf, vf, of, lf, nbh, ns, c, scale, vec16, st)
  SPARKNET_FLASH_DISPATCH(d, SPARKNET_FWD)
#undef SPARKNET_FWD
}

// The gradients of the forward above.  q, k, v, o, dout (the upstream
// gradient), dq, dk, dv: contiguous float32 [bh, s, d] (q, k, v and dout
// 16-byte aligned); lse: float32
// [bh, s] as the forward wrote it; delta: float32 [bh, s] of scratch.  The
// other arguments as the forward's.  Returns a cudaError_t.
int sparknet_flash_attention_backward(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* dq, void* dk, void* dv,
                                      void* delta, long long bh, long long s,
                                      int d, int causal, float scale,
                                      void* stream) {
  // 32-key tiles at D = 256; 16-byte loads of every fibre
  if (!shape_ok(bh, s, d, BwdCfg<256>::kKC) ||
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(o);
  const float* lf = static_cast<const float*>(lse);
  const float* gf = static_cast<const float*>(dout);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  float* df = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbh = (int)bh, ns = (int)s, c = causal ? 1 : 0;
  if (d > 256)
    return (int)launch_backward_wide(qf, kf, vf, of, lf, gf, dqf, dkf, dvf, df, nbh,
                                     ns, d, c, scale, st);
#define SPARKNET_BWD(D) \
  launch_backward<D>(qf, kf, vf, of, lf, gf, dqf, dkf, dvf, df, nbh, ns, c, scale, st)
  SPARKNET_FLASH_DISPATCH(d, SPARKNET_BWD)
#undef SPARKNET_BWD
}

const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

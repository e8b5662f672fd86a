// Flash attention for Hopper (sm_90a): the forward (blocked online softmax)
// on the tensor cores with float32 accuracy, and its backward (further
// down) in float32 FMAs.
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
// ops/kernels.py); any other returns cudaErrorInvalidValue here.  At D =
// 256 the O accumulator alone is 128 registers a thread: ptxas's spills
// are printed by chip_smoke.py and kept in PERF.md.

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

// rows [r0, r0 + rows) of a [S, D] fibre into shared memory at row stride
// `stride`; rows past S are zero-filled.  vec16: 16-byte copies (every
// pointer 16-byte aligned), else 4-byte ones.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* src, int r0, int rows,
                                          int S, bool vec16) {
  const int w = vec16 ? 4 : 1;
  const int per_row = D / w;
  for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
    const int row = c / per_row;
    const int col = (c % per_row) * w;
    const bool valid = r0 + row < S;
    const float* p = src + (valid ? (long long)(r0 + row) * D + col : 0);
    cp_async(dst + row * stride + col, p, vec16, valid);
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
      if (j0 + BK > S || (causal && j0 + BK - 1 > wrow)) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + nt * 8 + 2 * t + (e & 1);
            if (key > (e < 2 ? last0 : last1)) s[nt][e] = -INFINITY;
          }
        }
      }
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
      // O += P V, k = keys permuted as for S: the C fragment of s[kt] is
      // the A fragment of P (row g: keys 2t, 2t+1; row g + 8 likewise).
      // kPvGroup k-steps are summed on the tensor cores from zero, then
      // added to O in float32.
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
            const float* v0 = vs + ((kt0 + q) * 8 + 2 * t) * C::kVS + g;
            mma_3xtf32(d, ph[q], pl[q], v0[dn * 8], v0[C::kVS + dn * 8]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[dn][e] = __fadd_rn(acc[dn][e], d[e]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int w = 1; w <= 2; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  float* ob = o + base;
  if (lse != nullptr && t == 0) {  // m and l are the quad's, on every lane
    const long long rb = (long long)blockIdx.x * S;
    if (r0 < S) lse[rb + r0] = m0 + logf(l0);
    if (r1 < S) lse[rb + r1] = m1 + logf(l1);
  }
#pragma unroll
  for (int dn = 0; dn < KD; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r0 < S) {
      ob[(long long)r0 * D + col] = acc[dn][0] / l0;
      ob[(long long)r0 * D + col + 1] = acc[dn][1] / l0;
    }
    if (r1 < S) {
      ob[(long long)r1 * D + col] = acc[dn][2] / l1;
      ob[(long long)r1 * D + col + 1] = acc[dn][3] / l1;
    }
  }
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
// scores).  Here P and dS are recomputed a tile at a time and never leave
// shared memory.  Three launches: delta (one warp a row); dK and dV, one
// CTA per (fibre, key tile) walking the query tiles that can see its keys;
// dQ, one CTA per (fibre, query tile) walking the key tiles its rows can
// see.  Each CTA owns its outputs, so there are no atomics, and every sum
// is taken in an order fixed by the shapes (over d, then over the tiles in
// index order): two runs give the same bits, and a fibre's gradients do
// not depend on the other fibres of its batch.
//
// What bounds it: operations.  Five [S, S, D] products (about 10 S^2 D
// flops a fibre, halved when causal; S = q k^T and dO v^T are computed in
// both walks, so the kernels do 7).  This version does them as float32
// FMAs (exact to float32, not on the tensor cores), register-tiled so that
// a thread's shared-memory loads are 16-byte vectors each feeding several
// FMAs: the scores of a BQ x BK tile as 16 x 16 threads of TM x TN (each
// d-step of 4 loads TM + TM + TN + TN vectors for 8 TM TN FMAs), and the
// gradient tiles as threads of a few keys (or rows) by vectors of dims.

constexpr int kBwdThreads = 256;

// the tiles of one head dim: a BQ x BK score tile over 16 x 16 threads,
// float vectors of V along d
template <int D_, int BQ_, int BK_, int V_>
struct BwdTiles {
  static constexpr int kBQ = BQ_, kBK = BK_, kV = V_;
  static constexpr int kTM = BQ_ / 16, kTN = BK_ / 16;  // score microtile
  static constexpr int kDX = D_ / V_ < 16 ? D_ / V_ : 16;  // threads along d
  static constexpr int kNV = D_ / (V_ * kDX);             // vectors a thread
  static constexpr int kKC = BK_ * kDX / kBwdThreads;     // keys a thread (dK, dV)
  static constexpr int kRQ = BQ_ * kDX / kBwdThreads;     // rows a thread (dQ)
  static constexpr int kRS = D_ + 4;   // Q, dO, K, V row stride, words
  static constexpr int kPS = BK_ + 4;  // P and dS row stride (the dK/dV walk)
  static constexpr int kTS = BQ_ + 4;  // dS^T row stride (the dQ walk)
  static constexpr int kTiles = (2 * BQ_ + 2 * BK_) * kRS;
  static constexpr int kSmemKV = (kTiles + 2 * BQ_ * kPS + 2 * BQ_) * (int)sizeof(float);
  static constexpr int kSmemQ = (kTiles + BK_ * kTS + 2 * BQ_) * (int)sizeof(float);
  static_assert(BQ_ % 16 == 0 && BK_ % 16 == 0, "score tiles of 16 x 16 threads");
  static_assert(kDX * kNV * V_ == D_ && kKC >= 1 && kRQ >= 1 &&
                    (kBwdThreads / kDX) * kKC == BK_ &&
                    (kBwdThreads / kDX) * kRQ == BQ_,
                "gradient tiles must spread over the CTA");
  static_assert(kKC == 1 || kKC == 2 || kKC == 4, "vector loads of keys");
  static_assert(kRQ == 1 || kRQ == 2 || kRQ == 4, "vector loads of rows");
};

template <int D> struct BwdCfg;
template <> struct BwdCfg<8> : BwdTiles<8, 64, 64, 2> {};
template <> struct BwdCfg<16> : BwdTiles<16, 64, 64, 4> {};
template <> struct BwdCfg<32> : BwdTiles<32, 64, 64, 4> {};
template <> struct BwdCfg<64> : BwdTiles<64, 64, 64, 4> {};
template <> struct BwdCfg<128> : BwdTiles<128, 64, 64, 4> {};
template <> struct BwdCfg<256> : BwdTiles<256, 32, 32, 4> {};

// N consecutive floats of shared memory (N * 4-byte aligned) into registers
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    static_assert(N == 1, "vectors of 1, 2 or 4");
    out[0] = p[0];
  }
}

// rows [r0, r0 + rows) of a [S, D] fibre (16-byte aligned) into shared
// memory at row stride D + 4, by 16-byte vectors; rows past S are zero
template <int D>
__device__ __forceinline__ void bwd_load_rows(float* dst, const float* src,
                                              int r0, int rows, int S) {
  constexpr int kPerRow = D / 4;
  for (int c = threadIdx.x; c < rows * kPerRow; c += kBwdThreads) {
    const int row = c / kPerRow, col = (c % kPerRow) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + row < S)
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + row) * D + col);
    *reinterpret_cast<float4*>(dst + row * (D + 4) + col) = x;
  }
}

// shared memory of both walks: K, V (BK rows), Q, dO (BQ rows), then P and
// dS ([BQ, BK + 4], the dK/dV walk) or dS^T ([BK, BQ + 4], the dQ walk),
// then lse and delta of the query tile
template <int D>
struct BwdSmem {
  float *ks, *vs, *qs, *dos, *ps, *dss, *lse_s, *delta_s;
  __device__ BwdSmem(float* smem, bool for_dq) {
    using C = BwdCfg<D>;
    ks = smem;
    vs = ks + C::kBK * C::kRS;
    qs = vs + C::kBK * C::kRS;
    dos = qs + C::kBQ * C::kRS;
    ps = dos + C::kBQ * C::kRS;
    dss = for_dq ? ps : ps + C::kBQ * C::kPS;
    lse_s = for_dq ? ps + C::kBK * C::kTS : dss + C::kBQ * C::kPS;
    delta_s = lse_s + C::kBQ;
  }
};

template <int D>
__device__ __forceinline__ void bwd_load_query_tile(
    const BwdSmem<D>& sm, const float* qb, const float* dob, const float* lse,
    const float* delta, int i0, int S) {
  constexpr int BQ = BwdCfg<D>::kBQ;
  bwd_load_rows<D>(sm.qs, qb, i0, BQ, S);
  bwd_load_rows<D>(sm.dos, dob, i0, BQ, S);
  if (threadIdx.x < BQ) {
    const int r = i0 + threadIdx.x;
    sm.lse_s[threadIdx.x] = r < S ? lse[r] : 0.f;
    sm.delta_s[threadIdx.x] = r < S ? delta[r] : 0.f;
  }
}

// P and dS of query rows [i0, i0 + BQ) against keys [j0, j0 + BK), from the
// tiles in shared memory: into P and dS row-major (the dK/dV walk), or into
// dS^T (the dQ walk).  Thread (ty, tx) of 16 x 16: rows ty + 16 i, keys
// tx + 16 j; each score is a float32 FMA chain over d in order, the same in
// both walks.
template <int D, bool kForDq>
__device__ __forceinline__ void bwd_scores(const BwdSmem<D>& sm, int i0,
                                           int j0, int S, int causal,
                                           float scale) {
  using C = BwdCfg<D>;
  constexpr int TM = C::kTM, TN = C::kTN, V = C::kV, RS = C::kRS;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[TM][TN], dp[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += V) {
    float q[TM][V], g[TM][V], kk[TN][V], vv[TN][V];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      lds<V>(sm.qs + (ty + 16 * i) * RS + d, q[i]);
      lds<V>(sm.dos + (ty + 16 * i) * RS + d, g[i]);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      lds<V>(sm.ks + (tx + 16 * j) * RS + d, kk[j]);
      lds<V>(sm.vs + (tx + 16 * j) * RS + d, vv[j]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e)
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(q[i][e], kk[j][e], s[i][j]);
          dp[i][j] = fmaf(g[i][e], vv[j][e], dp[i][j]);
        }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i, row = i0 + r;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = tx + 16 * j, key = j0 + c;
      const bool live = key < S && row < S && (!causal || key <= row);
      const float p = live ? expf(s[i][j] * scale - sm.lse_s[r]) : 0.f;
      const float ds = p * (dp[i][j] - sm.delta_s[r]);
      if constexpr (kForDq) {
        sm.dss[c * C::kTS + r] = ds;
      } else {
        sm.ps[r * C::kPS + c] = p;
        sm.dss[r * C::kPS + c] = ds;
      }
    }
  }
}

// delta[row] = sum_d dO[row, d] o[row, d]: one warp a row, lanes over d,
// then a fixed xor tree
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_backward_delta_kernel(const float* __restrict__ o,
                                const float* __restrict__ dout,
                                float* __restrict__ delta, long long rows) {
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

// dK and dV of keys [j0, j0 + BK) of fibre blockIdx.x.  Thread: keys
// cy KC .. cy KC + KC - 1 (cy = tid / DX) by the V-vectors of dims
// V (dx + DX m) (dx = tid % DX).
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_backward_dkv_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              int S, int causal, float scale) {
  using C = BwdCfg<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, RS = C::kRS, PS = C::kPS;
  constexpr int KC = C::kKC, NV = C::kNV, V = C::kV, DX = C::kDX;
  extern __shared__ float4 smem4[];
  const BwdSmem<D> sm(reinterpret_cast<float*>(smem4), false);
  const int j0 = blockIdx.y * BK;
  const long long base = (long long)blockIdx.x * S * D;
  const long long rbase = (long long)blockIdx.x * S;
  const int dx = threadIdx.x % DX, cy = threadIdx.x / DX;
  bwd_load_rows<D>(sm.ks, k + base, j0, BK, S);
  bwd_load_rows<D>(sm.vs, v + base, j0, BK, S);
  float acc_k[KC][NV][V], acc_v[KC][NV][V];
#pragma unroll
  for (int u = 0; u < KC; ++u)
#pragma unroll
    for (int m = 0; m < NV; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e) acc_k[u][m][e] = acc_v[u][m][e] = 0.f;
  // rows above j0 cannot see these keys when causal
  for (int i0 = causal ? j0 / BQ * BQ : 0; i0 < S; i0 += BQ) {
    __syncthreads();  // the last tile's readers are done
    bwd_load_query_tile<D>(sm, q + base, dout + base, lse + rbase,
                           delta + rbase, i0, S);
    __syncthreads();
    bwd_scores<D, false>(sm, i0, j0, S, causal, scale);
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float p[KC], ds[KC];
      lds<KC>(sm.ps + r * PS + cy * KC, p);
      lds<KC>(sm.dss + r * PS + cy * KC, ds);
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        float g[V], x[V];
        lds<V>(sm.dos + r * RS + V * (dx + DX * m), g);
        lds<V>(sm.qs + r * RS + V * (dx + DX * m), x);
#pragma unroll
        for (int u = 0; u < KC; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            acc_v[u][m][e] = fmaf(p[u], g[e], acc_v[u][m][e]);
            acc_k[u][m][e] = fmaf(ds[u], x[e], acc_k[u][m][e]);
          }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < KC; ++u) {
    const int key = j0 + cy * KC + u;
    if (key >= S) continue;
#pragma unroll
    for (int m = 0; m < NV; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const long long at = base + (long long)key * D + V * (dx + DX * m) + e;
        dk[at] = scale * acc_k[u][m][e];
        dv[at] = acc_v[u][m][e];
      }
  }
}

// dQ of query rows [i0, i0 + BQ) of fibre blockIdx.x, heaviest causal
// tiles first.  Thread: rows ry RQ .. ry RQ + RQ - 1 (ry = tid / DX) by the
// V-vectors of dims V (dx + DX m).
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
    flash_backward_dq_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dq, int S, int causal,
                             float scale) {
  using C = BwdCfg<D>;
  constexpr int BQ = C::kBQ, BK = C::kBK, RS = C::kRS, TS = C::kTS;
  constexpr int RQ = C::kRQ, NV = C::kNV, V = C::kV, DX = C::kDX;
  extern __shared__ float4 smem4[];
  const BwdSmem<D> sm(reinterpret_cast<float*>(smem4), true);
  const int i0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const long long base = (long long)blockIdx.x * S * D;
  const long long rbase = (long long)blockIdx.x * S;
  const int dx = threadIdx.x % DX, ry = threadIdx.x / DX;
  bwd_load_query_tile<D>(sm, q + base, dout + base, lse + rbase,
                         delta + rbase, i0, S);
  float acc[RQ][NV][V];
#pragma unroll
  for (int u = 0; u < RQ; ++u)
#pragma unroll
    for (int m = 0; m < NV; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[u][m][e] = 0.f;
  const int kend = causal ? min(i0 + BQ, S) : S;
  for (int j0 = 0; j0 < kend; j0 += BK) {
    __syncthreads();  // the last tile's readers are done
    bwd_load_rows<D>(sm.ks, k + base, j0, BK, S);
    bwd_load_rows<D>(sm.vs, v + base, j0, BK, S);
    __syncthreads();
    bwd_scores<D, true>(sm, i0, j0, S, causal, scale);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float ds[RQ];
      lds<RQ>(sm.dss + c * TS + ry * RQ, ds);
#pragma unroll
      for (int m = 0; m < NV; ++m) {
        float kk[V];
        lds<V>(sm.ks + c * RS + V * (dx + DX * m), kk);
#pragma unroll
        for (int u = 0; u < RQ; ++u)
#pragma unroll
          for (int e = 0; e < V; ++e) acc[u][m][e] = fmaf(ds[u], kk[e], acc[u][m][e]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < RQ; ++u) {
    const int row = i0 + ry * RQ + u;
    if (row >= S) continue;
#pragma unroll
    for (int m = 0; m < NV; ++m)
#pragma unroll
      for (int e = 0; e < V; ++e)
        dq[base + (long long)row * D + V * (dx + DX * m) + e] = scale * acc[u][m][e];
  }
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
  flash_backward_delta_kernel<D>
      <<<(unsigned)((rows + kRowsABlock - 1) / kRowsABlock), kBwdThreads, 0, s>>>(
          o, dout, delta, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_backward_dkv_kernel<D>
      <<<dim3(bh, (S + C::kBK - 1) / C::kBK), kBwdThreads, C::kSmemKV, s>>>(
          q, k, v, dout, lse, delta, dk, dv, S, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_backward_dq_kernel<D>
      <<<dim3(bh, (S + C::kBQ - 1) / C::kBQ), kBwdThreads, C::kSmemQ, s>>>(
          q, k, v, dout, lse, delta, dq, S, causal, scale);
  return cudaGetLastError();
}

// the launch of head dim d: the instances of every head dim the wrapper
// takes (ops/kernels.py ATTENTION_HEAD_DIMS)
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

// bh fibres on the grid's x axis, s rows in tiles of `tile` on its y axis
bool shape_ok(long long bh, long long s, int tile) {
  return bh > 0 && s > 0 && bh <= INT32_MAX && s <= INT32_MAX / 256 &&
         (s + tile - 1) / tile <= 65535;
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous float32 [bh, s, d] on the device (bh = batch *
// heads).  lse: float32 [bh, s], written with each row's log-sum-exp of
// scale q k^T (the backward's input) when not null.  causal: 0 or 1.
// scale: the factor on q k^T (1 / sqrt of the true head dim).  Returns a
// cudaError_t.
int sparknet_flash_attention_forward(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     long long bh, long long s, int d,
                                     int causal, float scale, void* stream) {
  if (!shape_ok(bh, s, kBQ)) return (int)cudaErrorInvalidValue;
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
  // 32-row query tiles at D = 256; 16-byte loads of every fibre
  if (!shape_ok(bh, s, BwdCfg<256>::kBQ) ||
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
#define SPARKNET_BWD(D) \
  launch_backward<D>(qf, kf, vf, of, lf, gf, dqf, dkf, dvf, df, nbh, ns, c, scale, st)
  SPARKNET_FLASH_DISPATCH(d, SPARKNET_BWD)
#undef SPARKNET_BWD
}

const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

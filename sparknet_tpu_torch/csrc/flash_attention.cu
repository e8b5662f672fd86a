// Flash attention forward (blocked online softmax) for Hopper (sm_90a), on
// the tensor cores with float32 accuracy.
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
// and o / l is written at the end.  m starts at -inf, as in the TPU kernel
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
//  - K/V tiles of BK keys (64; 32 at D = 128) are staged in dynamic shared
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
//    and is split at each use; at D = 128 it is staged in shared memory;
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
// The head dims are the zoo's (8 for transformer, 16 for charlm) and 32, 64
// and 128; any other raises in the wrapper (ops/kernels.py) and returns
// cudaErrorInvalidValue here.

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
                         int S, int causal, float scale, int vec16) {
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
// device: done at the first launch on a device, then remembered.
template <int D>
cudaError_t allow_smem() {
  constexpr int smem = FlashCfg<D>::kSmem;
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(flash_forward_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < kMaxDevices)
    allowed[dev].store(true, std::memory_order_release);
  return err;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int bh, int S, int causal, float scale, int vec16,
                   cudaStream_t s) {
  constexpr int smem = FlashCfg<D>::kSmem;
  const cudaError_t err = allow_smem<D>();
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (S + kBQ - 1) / kBQ);
  flash_forward_kernel<D><<<grid, kThreads, smem, s>>>(q, k, v, o, S, causal,
                                                        scale, vec16);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: contiguous float32 [bh, s, d] on the device (bh = batch *
// heads).  causal: 0 or 1.  scale: 1 / sqrt(d).  Returns a cudaError_t.
int sparknet_flash_attention_forward(const void* q, const void* k,
                                     const void* v, void* o, long long bh,
                                     long long s, int d, int causal,
                                     float scale, void* stream) {
  if (bh <= 0 || s <= 0 || bh > INT32_MAX || s > INT32_MAX / 128 ||
      (s + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbh = (int)bh, ns = (int)s, c = causal ? 1 : 0;
  // 16-byte copies need every fibre 16-byte aligned: d is a multiple of 4,
  // so the base pointers decide
  const int vec16 =
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15) == 0 ? 1 : 0;
  switch (d) {
    case 8: return (int)launch<8>(qf, kf, vf, of, nbh, ns, c, scale, vec16, st);
    case 16: return (int)launch<16>(qf, kf, vf, of, nbh, ns, c, scale, vec16, st);
    case 32: return (int)launch<32>(qf, kf, vf, of, nbh, ns, c, scale, vec16, st);
    case 64: return (int)launch<64>(qf, kf, vf, of, nbh, ns, c, scale, vec16, st);
    case 128: return (int)launch<128>(qf, kf, vf, of, nbh, ns, c, scale, vec16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

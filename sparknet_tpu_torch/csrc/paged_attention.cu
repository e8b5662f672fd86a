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
// starts at -1e30 (:818).  Here:
//
//  - one CTA of 128 threads per (row b, head h).  It reads its row's table
//    entries and position from global memory (the scalar prefetch's
//    counterpart) and stops after column pos[b]: a wholly masked block
//    leaves m, l and o unchanged in the TPU kernel (p = exp(-1e30 - m) = 0,
//    corr = 1), so the work is O(position), as the JAX module says, and the
//    null block, stale lines and other rows' blocks are never read.  pos is
//    clamped to [0, MB * T - 1]; the decoders never pass anything outside;
//  - the columns go in passes of P = 128 / G keys (G = D / 16 threads a key,
//    1 for D <= 16).  Scoring: each G-lane group reads one key's D floats
//    (the group's reads are consecutive words of one cache line) and sums
//    its partial dot product with xor shuffles; masked columns of the last
//    pass score -1e30, as in the TPU kernel.  The pass max is a block
//    reduction; then p = exp(s - m') goes to shared memory.  Accumulating:
//    thread (d, slice) adds p_c * V[c, d] over the slice's keys of the pass
//    (reads of V coalesced along d) and keeps its own partial sum of p,
//    both rescaled by corr = exp(m - m') each pass; the 128 / D slices are
//    summed once at the end and divided;
//  - exactness contract (pallas_kernels.py:740-751): a row's output depends
//    only on its own q, table and position.  Nothing reduces across rows:
//    every sum of a CTA is over its own row's columns, in an order fixed by
//    its position alone, so interleaved decode gives the same bits as
//    decoding alone.
//
// What bounds it: bytes.  Each live column costs 2 * D floats of K and V
// against 4 * D flops, far below the card's balance; the least time is the
// live K/V bytes (sum over rows of (pos + 1) * H * D * 8) over the memory
// rate.  At the char LM's decode shape ([32, 4, 16], T = 8, MB = 16) that is
// at most 2 MB, under a microsecond, so the kernel's few microseconds of
// latency and the host's launch decide; chip_smoke.py also times one
// long-context shape (B 64, H 16, D 64, T 16, MB 128) where the pool is
// 1.07 GB.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int D>
struct PagedCfg {
  static constexpr int kDPT = D < 16 ? D : 16;  // dims a thread, scoring
  static constexpr int kG = D / kDPT;           // threads a key, scoring
  static constexpr int kP = kThreads / kG;      // keys a pass
  static constexpr int kSlices = kThreads / D;  // key slices, accumulating
};

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
  constexpr int G = C::kG, DPT = C::kDPT, P = C::kP, SL = C::kSlices;
  __shared__ float p_s[P];
  __shared__ float red[kWarps];
  __shared__ float acc_s[kThreads];
  __shared__ float l_s[SL];

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int* tbl = tables + (long long)b * MB;
  const int pos = max(0, min(positions[b], MB * T - 1));
  const long long row_stride = (long long)H * D;  // one token of a block
  const long long head_off = (long long)h * D;

  // scoring role: key kidx of the pass, dims g, g + G, ...
  const int g = tid % G, kidx = tid / G;
  float qr[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) qr[i] = q[((long long)b * H + h) * D + g + G * i];
  // accumulating role: dim d over keys slice, slice + SL, ...
  const int d = tid % D, slice = tid / D;

  float m = -1e30f, acc = 0.f, lpart = 0.f;
  for (int c0 = 0; c0 <= pos; c0 += P) {
    const int c = c0 + kidx;
    const bool live = c <= pos;
    float part = 0.f;
    if (live) {
      const float* kr = kp + ((long long)tbl[c / T] * T + c % T) * row_stride + head_off;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], kr[g + G * i], part);
    }
#pragma unroll
    for (int w = G / 2; w > 0; w >>= 1) part += __shfl_xor_sync(0xffffffffu, part, w);
    const float s = live ? part * scale : -1e30f;

    float mx = s;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    if ((tid & 31) == 0) red[tid >> 5] = mx;
    __syncthreads();
    float mt = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, red[w]);
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    if (g == 0) p_s[kidx] = expf(s - m_new);
    __syncthreads();

    acc *= corr;
    lpart *= corr;
    for (int kk = slice; kk < P && c0 + kk <= pos; kk += SL) {
      const int cc = c0 + kk;
      const float p = p_s[kk];
      const float vv = vp[((long long)tbl[cc / T] * T + cc % T) * row_stride + head_off + d];
      acc = fmaf(p, vv, acc);
      lpart += p;
    }
    m = m_new;
    __syncthreads();  // p_s and red are rewritten by the next pass
  }
  acc_s[tid] = acc;
  if (d == 0) l_s[slice] = lpart;
  __syncthreads();
  if (tid < D) {
    float a = 0.f, l = 0.f;
#pragma unroll
    for (int sl = 0; sl < SL; ++sl) {
      a += acc_s[sl * D + tid];
      l += l_s[sl];
    }
    o[((long long)b * H + h) * D + tid] = a / l;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* kp, const float* vp,
                   const int* tables, const int* positions, float* o, int B,
                   int H, int T, int MB, float scale, cudaStream_t s) {
  const dim3 grid(H, B);
  paged_attention_kernel<D><<<grid, kThreads, 0, s>>>(q, kp, vp, tables,
                                                     positions, o, H, T, MB,
                                                     scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: contiguous float32 [b, h, d]; k_pool, v_pool: contiguous float32
// [num_blocks, t, h, d]; tables: contiguous int32 [b, mb] of block ids in
// [0, num_blocks); positions: int32 [b].  scale: 1 / sqrt(d).  Returns a
// cudaError_t.
int sparknet_paged_attention(const void* q, const void* k_pool,
                             const void* v_pool, const void* tables,
                             const void* positions, void* o, int b, int h,
                             int d, int t, int mb, float scale,
                             void* stream) {
  if (b <= 0 || b > 65535 || h <= 0 || t <= 0 || mb <= 0 ||
      (long long)mb * t > INT32_MAX)
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

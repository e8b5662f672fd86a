// Flash attention forward (blocked online softmax) for Hopper (sm_90a).
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
// (:274); key 0 is live for every row, so m is finite after the first tile.
// A masked column contributes exactly 0 (exp(-inf) = 0), which is what the
// TPU kernel's -1e30 gives; the kernel simply skips columns past the row's
// last live key (causal) or past S (the ragged tail), and a causal tile of
// queries stops after the key tile that holds its last row's diagonal (the
// TPU kernel's early stop, :279).
//
// What the TPU kernel keeps and where: its BlockSpec((1, Sk, D)) holds the
// whole K/V fibre of one (batch, head) in VMEM.  A Hopper block has no such
// room, so K and V go through shared memory one tile at a time:
//
//  - one CTA per (batch * head, 64-query tile); a query row belongs to a
//    group of G = D / 16 consecutive threads (G = 1 for D <= 16), each
//    holding 16 of its D dims (q pre-scaled, and the output accumulator) in
//    registers, dims g, g + G, g + 2G, ... for lane g, so the group's
//    shared-memory reads at one key are G consecutive words (no bank
//    conflicts) and every row of the CTA reads the same words (broadcast);
//  - a tile of BK keys (64, or 32 for D = 128, so K + V tiles fit the 48 KB
//    of static shared memory) is loaded by the whole CTA, coalesced, with
//    the ragged tail bounded (not padded in memory: rows past S read as 0
//    and are never live);
//  - the tile's BK scores are kept in registers (each a G-lane partial dot
//    product summed with xor shuffles, so every lane of the group holds the
//    same bits), then one exp per score and one rescale of the accumulator
//    per tile.
//
// What bounds it: operations.  4 * S^2 * D flops per (batch, head), halved
// when causal, against 3 reads and 1 write of [S, D]: at S = 2048, D = 64
// that is 2048 flops a byte, far above the card's balance, so the least
// time is flops over the f32 rate (67 TFLOP/s outside the tensor cores).
// This first version is scalar f32 FMA with one shared-memory read per FMA,
// so it can reach at most about a quarter of that rate; tensor cores (TF32
// or bf16 wgmma) are a later PR's work, and change the arithmetic.  At the
// char LM's prefill shape ([32, 4, 128, 16]) the work is about 1 us at the
// f32 rate; 256 CTAs of 64 threads, each key a 16-long dependent FMA chain,
// leave the kernel latency-bound there (PERF.md has the times).
//
// The head dims are the zoo's (8 for transformer, 16 for charlm) and 32, 64
// and 128; any other raises in the wrapper (ops/kernels.py) and returns
// cudaErrorInvalidValue here.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;  // query rows per CTA

template <int D>
struct FlashCfg {
  static constexpr int kDPT = D < 16 ? D : 16;               // dims a thread
  static constexpr int kG = D / kDPT;                        // threads a row
  static constexpr int kBK = D * 64 <= 4096 ? 64 : 4096 / D;  // keys a tile
  static constexpr int kThreads = kBQ * kG;
};

template <int D>
__global__ void __launch_bounds__(FlashCfg<D>::kThreads)
    flash_forward_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int causal, float scale) {
  using C = FlashCfg<D>;
  constexpr int G = C::kG, DPT = C::kDPT, BK = C::kBK;
  __shared__ float ks[BK * D];
  __shared__ float vs[BK * D];

  const int tid = threadIdx.x;
  const int g = tid % G;
  const int row = blockIdx.x * kBQ + tid / G;
  const long long base = (long long)blockIdx.y * S * D;
  const bool valid = row < S;
  // the row's last live key; rows past S (the ragged tail of the last
  // tile) compute on zeros and write nothing, but take part in the
  // shuffles and barriers
  const int row_last = causal ? min(row, S - 1) : S - 1;
  // keys [0, kend) are read by some row of this CTA
  const int kend = causal ? min((int)blockIdx.x * kBQ + kBQ, S) : S;

  float qr[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) {
    qr[i] = valid ? q[base + (long long)row * D + g + G * i] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int j0 = 0; j0 < kend; j0 += BK) {
    __syncthreads();  // the previous tile is consumed
    const int n = min(BK, S - j0) * D;
    const long long off = base + (long long)j0 * D;
    for (int idx = tid; idx < BK * D; idx += C::kThreads) {
      ks[idx] = idx < n ? k[off + idx] : 0.f;
      vs[idx] = idx < n ? v[off + idx] : 0.f;
    }
    __syncthreads();

    float s[BK];
    float mt = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) part = fmaf(qr[i], ks[jj * D + g + G * i], part);
#pragma unroll
      for (int w = G / 2; w > 0; w >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, w);
      s[jj] = j0 + jj <= row_last ? part : -INFINITY;
      mt = fmaxf(mt, s[jj]);
    }
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll
    for (int jj = 0; jj < BK; ++jj) {
      const float p = expf(s[jj] - m_new);
      psum += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vs[jj * D + g + G * i], acc[i]);
    }
    l = l * corr + psum;
    m = m_new;
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[base + (long long)row * D + g + G * i] = acc[i] / l;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int bh, int S, int causal, float scale, cudaStream_t s) {
  const dim3 grid((S + kBQ - 1) / kBQ, bh);
  flash_forward_kernel<D><<<grid, FlashCfg<D>::kThreads, 0, s>>>(
      q, k, v, o, S, causal, scale);
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
  if (bh <= 0 || s <= 0 || bh > 65535 || s > INT32_MAX / 128)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nbh = (int)bh, ns = (int)s, c = causal ? 1 : 0;
  switch (d) {
    case 8: return (int)launch<8>(qf, kf, vf, of, nbh, ns, c, scale, st);
    case 16: return (int)launch<16>(qf, kf, vf, of, nbh, ns, c, scale, st);
    case 32: return (int)launch<32>(qf, kf, vf, of, nbh, ns, c, scale, st);
    case 64: return (int)launch<64>(qf, kf, vf, of, nbh, ns, c, scale, st);
    case 128: return (int)launch<128>(qf, kf, vf, of, nbh, ns, c, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

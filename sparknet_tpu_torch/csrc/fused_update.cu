// One-pass Caffe optimizer update over flat arenas, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_kernels.py::_fused_kernel
// (launched by _fused_update_pallas), with the math of _fused_prologue and
// _fused_rule_math.  The params, grads and one or two history slots of a
// whole model are each one flat arena of T elements (T a multiple of the
// 2048-element tile; every blob is padded to whole tiles, so a tile never
// spans two blobs: solvers/arena.py).  Per element, in Caffe's ApplyUpdate
// order (ref: sgd_solver.cpp:102-117):
//
//   g  = g * clip_scale                 (when clip_gradients > 0)
//   g  = g / iter_size                  (when iter_size > 1)
//   g += decay[tile] * w  (L2)  or  decay[tile] * sign(w)  (L1)
//   lr = rate * lr_mult[tile]
//   then one of SGD, Nesterov, AdaGrad, RMSProp, AdaDelta, Adam, and
//   w -= dw, written back in place with the slots.
//
// rate, clip_scale and Adam's bias correction come in a [3] float32 vector
// on the device, so nothing waits on the host; the per-tile lr_mult and
// folded weight_decay * decay_mult come from two [T / 2048] tables, which
// each thread reads itself (the counterpart of the TPU kernel's scalar
// prefetch).  The rule and the regularization are template constants fixed
// at launch; clip and iter_size are uniform branches.
//
// What bounds it: bytes.  Each param and slot element is read and written
// once and each grad element read once, (2 + 2 * slots + 1) * T * sizeof(T)
// bytes (fused_update_hbm_bytes in the TPU package), at 2 to 20 flops per
// element.  For the AlexNet arena (60,965,224 params, 61,018,112 after
// padding, 244.1 MB in f32) at 3.35 TB/s: SGD f32 1.22 GB, 0.364 ms; Adam /
// AdaDelta f32 1.71 GB, 0.510 ms; half of each in bf16 (reckoned, not
// measured).  The design streams: one thread per 16 bytes of each arena
// (4 f32 or 8 bf16 elements, one 16-byte vector load or store per arena),
// neighbouring threads on neighbouring addresses; math is float32 in
// registers for both storage types, cast back once at the store.
//
// Exactness: every operation is an explicit round-to-nearest intrinsic in
// the order of _fused_rule_math and of the plain version fused_update_torch,
// so no FMA contraction moves a bit; sqrt and division are IEEE
// (__fsqrt_rn, __fdiv_rn).  The kernel writes w and the slots in place (the
// TPU kernel's input_output_aliases) and never writes g.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // ARENA_TILE: elements per lr/decay table entry

enum Rule { kSGD = 0, kNesterov, kAdaGrad, kRMSProp, kAdaDelta, kAdam };
enum Reg { kNone = 0, kL1, kL2 };

struct Statics {
  float momentum, one_plus_momentum, one_minus_momentum;
  float momentum2, one_minus_momentum2;
  float rms_decay, one_minus_rms_decay;
  float delta;
  float iter_size;
  int clip;
  int divide;  // iter_size > 1
};

// 16 bytes of an arena <-> N floats
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __halves2bfloat162(__float2bfloat16(v[2 * i]),
                                __float2bfloat16(v[2 * i + 1]));
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

__device__ __forceinline__ float sign_of(float w) {
  return (float)((0.f < w) - (w < 0.f));
}

template <typename T, int RULE, int REG>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(T* __restrict__ w, const T* __restrict__ g,
                    T* __restrict__ s0, T* __restrict__ s1,
                    const float* __restrict__ tile_lr,
                    const float* __restrict__ tile_decay,
                    const float* __restrict__ scalars, long long n_vec,
                    Statics st) {
  constexpr int N = Pack<T>::N;
  constexpr int SLOTS = (RULE == kAdaDelta || RULE == kAdam) ? 2 : 1;
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= n_vec) return;
  const long long e0 = v * N;
  const long long tile = e0 / kTile;  // N divides kTile: one tile a thread
  const float lr = __fmul_rn(scalars[0], tile_lr[tile]);
  const float clip_scale = scalars[1];
  const float corr = scalars[2];
  const float decay = tile_decay[tile];

  float wv[N], gv[N], a[N], b[N];
  Pack<T>::load(w + e0, wv);
  Pack<T>::load(g + e0, gv);
  Pack<T>::load(s0 + e0, a);
  if (SLOTS == 2) Pack<T>::load(s1 + e0, b);

#pragma unroll
  for (int i = 0; i < N; ++i) {
    float gi = gv[i];
    if (st.clip) gi = __fmul_rn(gi, clip_scale);
    if (st.divide) gi = __fdiv_rn(gi, st.iter_size);
    if (REG == kL1) gi = __fadd_rn(gi, __fmul_rn(decay, sign_of(wv[i])));
    if (REG == kL2) gi = __fadd_rn(gi, __fmul_rn(decay, wv[i]));
    float dw;
    if (RULE == kSGD) {
      a[i] = __fadd_rn(__fmul_rn(st.momentum, a[i]), __fmul_rn(lr, gi));
      dw = a[i];
    } else if (RULE == kNesterov) {
      const float h_new =
          __fadd_rn(__fmul_rn(st.momentum, a[i]), __fmul_rn(lr, gi));
      dw = __fsub_rn(__fmul_rn(st.one_plus_momentum, h_new),
                     __fmul_rn(st.momentum, a[i]));
      a[i] = h_new;
    } else if (RULE == kAdaGrad) {
      a[i] = __fadd_rn(a[i], __fmul_rn(gi, gi));
      dw = __fdiv_rn(__fmul_rn(lr, gi), __fadd_rn(__fsqrt_rn(a[i]), st.delta));
    } else if (RULE == kRMSProp) {
      a[i] = __fadd_rn(__fmul_rn(st.rms_decay, a[i]),
                       __fmul_rn(__fmul_rn(st.one_minus_rms_decay, gi), gi));
      dw = __fdiv_rn(__fmul_rn(lr, gi), __fadd_rn(__fsqrt_rn(a[i]), st.delta));
    } else if (RULE == kAdaDelta) {
      a[i] = __fadd_rn(__fmul_rn(st.momentum, a[i]),
                       __fmul_rn(__fmul_rn(st.one_minus_momentum, gi), gi));
      const float val = __fmul_rn(
          gi, __fsqrt_rn(__fdiv_rn(__fadd_rn(b[i], st.delta),
                                   __fadd_rn(a[i], st.delta))));
      b[i] = __fadd_rn(__fmul_rn(st.momentum, b[i]),
                       __fmul_rn(__fmul_rn(st.one_minus_momentum, val), val));
      dw = __fmul_rn(lr, val);
    } else {  // kAdam
      a[i] = __fadd_rn(__fmul_rn(st.momentum, a[i]),
                       __fmul_rn(st.one_minus_momentum, gi));
      b[i] = __fadd_rn(__fmul_rn(st.momentum2, b[i]),
                       __fmul_rn(__fmul_rn(st.one_minus_momentum2, gi), gi));
      dw = __fdiv_rn(__fmul_rn(__fmul_rn(lr, corr), a[i]),
                     __fadd_rn(__fsqrt_rn(b[i]), st.delta));
    }
    wv[i] = __fsub_rn(wv[i], dw);
  }
  Pack<T>::store(w + e0, wv);
  Pack<T>::store(s0 + e0, a);
  if (SLOTS == 2) Pack<T>::store(s1 + e0, b);
}

template <typename T, int RULE>
cudaError_t launch_reg(int reg, int blocks, void* w, const void* g, void* s0,
                       void* s1, const float* lr, const float* decay,
                       const float* scalars, long long n_vec,
                       const Statics& st, cudaStream_t stream) {
  T* wt = static_cast<T*>(w);
  const T* gt = static_cast<const T*>(g);
  T* a = static_cast<T*>(s0);
  T* b = static_cast<T*>(s1);
  switch (reg) {
    case kNone:
      fused_update_kernel<T, RULE, kNone><<<blocks, kThreads, 0, stream>>>(
          wt, gt, a, b, lr, decay, scalars, n_vec, st);
      break;
    case kL1:
      fused_update_kernel<T, RULE, kL1><<<blocks, kThreads, 0, stream>>>(
          wt, gt, a, b, lr, decay, scalars, n_vec, st);
      break;
    case kL2:
      fused_update_kernel<T, RULE, kL2><<<blocks, kThreads, 0, stream>>>(
          wt, gt, a, b, lr, decay, scalars, n_vec, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int rule, int reg, int blocks, void* w, const void* g,
                   void* s0, void* s1, const float* lr, const float* decay,
                   const float* scalars, long long n_vec, const Statics& st,
                   cudaStream_t stream) {
#define SPARKNET_RULE_CASE(R)                                               \
  case R:                                                                   \
    return launch_reg<T, R>(reg, blocks, w, g, s0, s1, lr, decay, scalars,  \
                            n_vec, st, stream);
  switch (rule) {
    SPARKNET_RULE_CASE(kSGD)
    SPARKNET_RULE_CASE(kNesterov)
    SPARKNET_RULE_CASE(kAdaGrad)
    SPARKNET_RULE_CASE(kRMSProp)
    SPARKNET_RULE_CASE(kAdaDelta)
    SPARKNET_RULE_CASE(kAdam)
    default:
      break;
  }
#undef SPARKNET_RULE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Elements per lr/decay table entry; the wrapper checks it against the
// arena layout's tile.
int sparknet_fused_update_tile(void) { return kTile; }

// w, g, s0 (and s1 for AdaDelta/Adam, else ignored): contiguous [total]
// arenas on the device, 16-byte aligned, all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1); total a multiple of the tile.  tile_lr, tile_decay:
// [total / tile] f32; scalars: [3] f32 = (rate, clip_scale, adam_corr).
// rule: 0 SGD, 1 Nesterov, 2 AdaGrad, 3 RMSProp, 4 AdaDelta, 5 Adam; reg:
// 0 none, 1 L1, 2 L2.  The "one_*" constants are computed by the caller in
// double precision and rounded once, as the reference computes them.
// Returns a cudaError_t.
int sparknet_fused_update(void* w, const void* g, void* s0, void* s1,
                          const float* tile_lr, const float* tile_decay,
                          const float* scalars, long long total, int rule,
                          int reg, int clip, int iter_size, float momentum,
                          float one_plus_momentum, float one_minus_momentum,
                          float momentum2, float one_minus_momentum2,
                          float rms_decay, float one_minus_rms_decay,
                          float delta, int is_bf16, void* stream) {
  if (total <= 0 || total % kTile != 0 || iter_size < 1 || rule < 0 ||
      rule > kAdam || reg < 0 || reg > kL2) {
    return (int)cudaErrorInvalidValue;
  }
  const int n = is_bf16 ? Pack<__nv_bfloat16>::N : Pack<float>::N;
  const long long n_vec = total / n;
  const long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
  Statics st;
  st.momentum = momentum;
  st.one_plus_momentum = one_plus_momentum;
  st.one_minus_momentum = one_minus_momentum;
  st.momentum2 = momentum2;
  st.one_minus_momentum2 = one_minus_momentum2;
  st.rms_decay = rms_decay;
  st.one_minus_rms_decay = one_minus_rms_decay;
  st.delta = delta;
  st.iter_size = (float)iter_size;
  st.clip = clip;
  st.divide = iter_size > 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = launch<__nv_bfloat16>(rule, reg, (int)blocks, w, g, s0, s1, tile_lr,
                                tile_decay, scalars, n_vec, st, s);
  } else {
    err = launch<float>(rule, reg, (int)blocks, w, g, s0, s1, tile_lr,
                        tile_decay, scalars, n_vec, st, s);
  }
  return (int)err;
}

const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

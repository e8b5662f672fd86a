// One-pass Caffe optimizer update over flat arenas, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparknet_tpu/ops/pallas_kernels.py::_fused_kernel
// (launched by _fused_update_pallas), with the math of _fused_prologue and
// _fused_rule_math.  The params and one or two history slots of a whole
// model are each one flat arena of T elements (T a multiple of the
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
// The gradient is a table of segments, not an arena.  A segment is one
// blob's gradient where autograd left it: its device pointer (16-byte
// aligned, or null for a blob that got no gradient), its element type (f32
// or bf16) and its element count.  Segment i covers the tiles from its
// first tile to the next segment's; a per-tile int32 pair (segment, first
// tile of that segment), made once per layout, tells each thread where its
// gradient lies: element e of the arena reads element e - first_tile * 2048
// of its segment.  Elements at or past the count (the blob's pad zone) and
// every element of a null segment read 0, so the update of a pad zone or of
// a blob without a gradient is the one a zero-filled grad arena gives.  A
// segment's value is converted to the arena's type first (f32 -> bf16 rounds
// to nearest even, bf16 -> f32 is exact), as packing it into a grad arena of
// that type would.  So the update is bit for bit the one of the packed grad
// arena, and the packed arena is itself the one-segment table (tile table
// null: every tile in segment 0 from tile 0).
//
// The table rides in the launch's parameter block, by value (a
// __grid_constant__ struct of kMaxSegs segments, 3,960 bytes of parameters
// in all, within the 4 KB kernel parameter limit of every CUDA 12
// toolkit), so nothing is uploaded a step and a CUDA graph captures the
// launch whole.  A table of 32 slots (632 bytes) timed the same by graph
// replay on the H100 at the cifar10_quick, char LM and AlexNet arenas, so
// there is one size.  A table of more than kMaxSegs segments is cut into
// runs of kMaxSegs and each run launched over its tiles.  A warp
// spans 128 (f32) or 256 (bf16) elements of one tile, so its segment index
// is uniform and the indexed constant load broadcasts.
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
// AdaDelta f32 1.71 GB, 0.510 ms; half of each in bf16.  The design
// streams: one thread per 16 bytes of each arena (4 f32 or 8 bf16 elements,
// one 16-byte vector load or store per arena), neighbouring threads on
// neighbouring addresses; the gradient is read with streaming (evict-first)
// loads, since nothing reads it again; math is float32 in registers for both
// storage types, cast back once at the store.  Reading the gradients where
// they lie saves the grad arena's zero fill and one copy a blob (a write
// and a read and write of the arena's bytes, and one launch a blob) in
// front of the kernel.  On a small arena the kernel is one wave, and its
// time is the launch plus the chain tile table -> segment -> gradient;
// the tables and the other arenas are loaded while that chain runs.
//
// Exactness: every operation is an explicit round-to-nearest intrinsic in
// the order of _fused_rule_math and of the plain version fused_update_torch,
// so no FMA contraction moves a bit; sqrt and division are IEEE
// (__fsqrt_rn, __fdiv_rn).  The kernel writes w and the slots in place (the
// TPU kernel's input_output_aliases) and never writes a gradient.
//
// The C entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() after the launches (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;  // ARENA_TILE: elements per lr/decay table entry
// segments a launch's parameter block holds: 240 x 16 bytes plus the other
// arguments stay under the 4,096-byte kernel parameter limit
constexpr int kMaxSegs = 240;

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

// one blob's gradient: where it lies, its element count, its type
struct Seg {
  const void* ptr;  // null: the blob got no gradient, read as 0
  int count;
  int is_bf16;
};
static_assert(sizeof(Seg) == 16, "a segment is 16 bytes");

struct SegTable {
  Seg seg[kMaxSegs];
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
  // f32 -> the arena's type and back: exact
  __device__ __forceinline__ static float round(float x) { return x; }
};

__device__ __forceinline__ void bf16x2_to_float(unsigned int u, float* v) {
  __nv_bfloat162 h;
  *reinterpret_cast<unsigned int*>(&h) = u;
  const float2 f = __bfloat1622float2(h);
  v[0] = f.x;
  v[1] = f.y;
}

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    bf16x2_to_float(q.x, v);
    bf16x2_to_float(q.y, v + 2);
    bf16x2_to_float(q.z, v + 4);
    bf16x2_to_float(q.w, v + 6);
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
  // f32 -> bf16 (round to nearest even) -> f32, as packing an f32 gradient
  // into a bf16 grad arena rounds it
  __device__ __forceinline__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// N gradient values of a segment from its element k (a multiple of N) on,
// as floats in the arena's type T: 0 past the count and for a null segment;
// whole vectors by streaming 16-byte (or 8-byte) loads, the blob's last
// partial vector element by element
template <typename T>
__device__ __forceinline__ void load_grad(const Seg& sg, long long k,
                                          float* gv) {
  constexpr int N = Pack<T>::N;
  const long long count = sg.count;
  if (sg.ptr == nullptr || k >= count) {
#pragma unroll
    for (int i = 0; i < N; ++i) gv[i] = 0.f;
    return;
  }
  if (sg.is_bf16) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(sg.ptr) + k;
    if (k + N <= count) {
      if (N == 8) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
        bf16x2_to_float(q.x, gv);
        bf16x2_to_float(q.y, gv + 2);
        bf16x2_to_float(q.z, gv + 4);
        bf16x2_to_float(q.w, gv + 6);
      } else {
        const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
        bf16x2_to_float(q.x, gv);
        bf16x2_to_float(q.y, gv + 2);
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        gv[i] = k + i < count ? __bfloat162float(p[i]) : 0.f;
      }
    }
    return;  // bf16 -> f32 -> T is exact for both arena types
  }
  const float* p = static_cast<const float*>(sg.ptr) + k;
  if (k + N <= count) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
      const float4 q = __ldcs(reinterpret_cast<const float4*>(p) + j);
      gv[4 * j] = q.x;
      gv[4 * j + 1] = q.y;
      gv[4 * j + 2] = q.z;
      gv[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) gv[i] = k + i < count ? p[i] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) gv[i] = Pack<T>::round(gv[i]);
}

__device__ __forceinline__ float sign_of(float w) {
  return (float)((0.f < w) - (w < 0.f));
}

// Vectors [vec0, vec1) of the arenas, the tiles of segments [seg0, seg0 +
// kMaxSegs) of the table.  tile_seg: [n_tiles] int2 (segment, its first
// tile), or null for the one-segment table.
template <typename T, int RULE, int REG>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(T* __restrict__ w, T* __restrict__ s0, T* __restrict__ s1,
                    const float* __restrict__ tile_lr,
                    const float* __restrict__ tile_decay,
                    const int2* __restrict__ tile_seg,
                    const float* __restrict__ scalars, long long vec0,
                    long long vec1, int seg0, Statics st,
                    const __grid_constant__ SegTable segs) {
  constexpr int N = Pack<T>::N;
  constexpr int SLOTS = (RULE == kAdaDelta || RULE == kAdam) ? 2 : 1;
  const long long v = vec0 + (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= vec1) return;
  const long long e0 = v * N;
  const long long tile = e0 / kTile;  // N divides kTile: one tile a thread
  // the head of the gradient's chain first; the rest loads beside it
  const int2 ts = tile_seg != nullptr ? tile_seg[tile] : make_int2(0, 0);
  const float lr = __fmul_rn(scalars[0], tile_lr[tile]);
  const float clip_scale = scalars[1];
  const float corr = scalars[2];
  const float decay = tile_decay[tile];

  float wv[N], gv[N], a[N], b[N];
  Pack<T>::load(w + e0, wv);
  Pack<T>::load(s0 + e0, a);
  if (SLOTS == 2) Pack<T>::load(s1 + e0, b);
  const Seg sg = segs.seg[ts.x - seg0];
  load_grad<T>(sg, e0 - (long long)ts.y * kTile, gv);

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

// the kernel's launch arguments other than the rule's template constants
struct Launch {
  int blocks;
  void* w;
  void* s0;
  void* s1;
  const float* lr;
  const float* decay;
  const int2* tile_seg;
  const float* scalars;
  long long vec0, vec1;
  int seg0;
  Statics st;
  cudaStream_t stream;
};

template <typename T, int RULE, int REG>
void launch_one(const Launch& l, const SegTable& segs) {
  fused_update_kernel<T, RULE, REG><<<l.blocks, kThreads, 0, l.stream>>>(
      static_cast<T*>(l.w), static_cast<T*>(l.s0), static_cast<T*>(l.s1),
      l.lr, l.decay, l.tile_seg, l.scalars, l.vec0, l.vec1, l.seg0, l.st,
      segs);
}

template <typename T, int RULE>
cudaError_t launch_reg(int reg, const Launch& l, const SegTable& segs) {
  switch (reg) {
    case kNone:
      launch_one<T, RULE, kNone>(l, segs);
      break;
    case kL1:
      launch_one<T, RULE, kL1>(l, segs);
      break;
    case kL2:
      launch_one<T, RULE, kL2>(l, segs);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int rule, int reg, const Launch& l, const SegTable& segs) {
#define SPARKNET_RULE_CASE(R) \
  case R:                     \
    return launch_reg<T, R>(reg, l, segs);
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

// rows [0, n) of the host table into a SegTable (the rest null), then one
// launch over l's tiles
cudaError_t launch_table(int is_bf16, int rule, int reg, const Launch& l,
                         const long long* rows, int n) {
  SegTable table;
  for (int i = 0; i < kMaxSegs; ++i) {
    table.seg[i].ptr = i < n ? reinterpret_cast<const void*>(rows[4 * i]) : nullptr;
    table.seg[i].count = i < n ? (int)rows[4 * i + 1] : 0;
    table.seg[i].is_bf16 = i < n ? (int)rows[4 * i + 2] : 0;
  }
  return is_bf16 ? launch<__nv_bfloat16>(rule, reg, l, table)
                 : launch<float>(rule, reg, l, table);
}

}  // namespace

extern "C" {

// Elements per lr/decay table entry; the wrapper checks it against the
// arena layout's tile.
int sparknet_fused_update_tile(void) { return kTile; }

// Segments one launch takes; a longer table is launched in runs of these.
int sparknet_fused_update_max_segments(void) { return kMaxSegs; }

// w, s0 (and s1 for AdaDelta/Adam, else ignored): contiguous [total]
// arenas on the device, 16-byte aligned, all f32 (is_bf16 = 0) or all bf16
// (is_bf16 = 1); total a multiple of the tile.  tile_lr, tile_decay:
// [total / tile] f32; scalars: [3] f32 = (rate, clip_scale, adam_corr).
// segs: n_segs rows of 4 int64 in host memory, (device pointer of the
// gradient or 0, element count, 1 if bf16 else 0, first tile), the first
// tiles rising from 0, each count within its tiles, each pointer 16-byte
// aligned; tile_seg: [total / tile] pairs of int32 (segment, first tile of
// the segment) on the device, or null when n_segs is 1 (the packed grad
// arena: one segment of total elements at tile 0).  rule: 0 SGD, 1
// Nesterov, 2 AdaGrad, 3 RMSProp, 4 AdaDelta, 5 Adam; reg: 0 none, 1 L1, 2
// L2.  The "one_*" constants are computed by the caller in double precision
// and rounded once, as the reference computes them.  Launches
// ceil(n_segs / kMaxSegs) kernels; returns a cudaError_t.
int sparknet_fused_update(void* w, void* s0, void* s1, const float* tile_lr,
                          const float* tile_decay, const int* tile_seg,
                          const float* scalars, long long total,
                          const long long* segs, int n_segs, int rule,
                          int reg, int clip, int iter_size, float momentum,
                          float one_plus_momentum, float one_minus_momentum,
                          float momentum2, float one_minus_momentum2,
                          float rms_decay, float one_minus_rms_decay,
                          float delta, int is_bf16, void* stream) {
  if (total <= 0 || total % kTile != 0 || iter_size < 1 || rule < 0 ||
      rule > kAdam || reg < 0 || reg > kL2 || n_segs < 1 ||
      (tile_seg == nullptr && n_segs != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_tiles = total / kTile;
  for (int i = 0; i < n_segs; ++i) {
    const long long ptr = segs[4 * i], count = segs[4 * i + 1];
    const long long type = segs[4 * i + 2], first = segs[4 * i + 3];
    const long long end = i + 1 < n_segs ? segs[4 * (i + 1) + 3] : n_tiles;
    if ((i == 0 && first != 0) || end <= first || end > n_tiles ||
        count < 0 || count > (end - first) * kTile || count > INT32_MAX ||
        ptr % 16 != 0 || (type != 0 && type != 1)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const int n = is_bf16 ? Pack<__nv_bfloat16>::N : Pack<float>::N;
  const long long vec_per_tile = kTile / n;
  Launch l;
  l.w = w;
  l.s0 = s0;
  l.s1 = s1;
  l.lr = tile_lr;
  l.decay = tile_decay;
  l.tile_seg = reinterpret_cast<const int2*>(tile_seg);
  l.scalars = scalars;
  l.st.momentum = momentum;
  l.st.one_plus_momentum = one_plus_momentum;
  l.st.one_minus_momentum = one_minus_momentum;
  l.st.momentum2 = momentum2;
  l.st.one_minus_momentum2 = one_minus_momentum2;
  l.st.rms_decay = rms_decay;
  l.st.one_minus_rms_decay = one_minus_rms_decay;
  l.st.delta = delta;
  l.st.iter_size = (float)iter_size;
  l.st.clip = clip;
  l.st.divide = iter_size > 1;
  l.stream = static_cast<cudaStream_t>(stream);
  for (int c0 = 0; c0 < n_segs; c0 += kMaxSegs) {
    const int c1 = c0 + kMaxSegs < n_segs ? c0 + kMaxSegs : n_segs;
    const long long t0 = segs[4 * c0 + 3];
    const long long t1 = c1 < n_segs ? segs[4 * c1 + 3] : n_tiles;
    l.vec0 = t0 * vec_per_tile;
    l.vec1 = t1 * vec_per_tile;
    l.seg0 = c0;
    const long long blocks = (l.vec1 - l.vec0 + kThreads - 1) / kThreads;
    if (blocks > INT32_MAX) return (int)cudaErrorInvalidValue;
    l.blocks = (int)blocks;
    const cudaError_t err =
        launch_table(is_bf16, rule, reg, l, segs + 4 * c0, c1 - c0);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

const char* sparknet_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

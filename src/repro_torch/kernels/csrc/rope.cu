// The rotary embedding of q or k for Hopper (sm_90a), in one pass.
//
// Not a port of a Pallas kernel: the JAX package applies the rotary
// embedding as jnp expressions (src/repro/models/attention.py), and so did
// the port until this kernel (kernels/ref.py::rope_ref, its plain version).
//
// x (B, S, H, hd) in bf16 or fp32, contiguous; cos/sin fp32 tables of
// (1 or B, S, >= rot/2) (a batch stride of 0 where one row of tables serves
// every batch row: RoPE's (1, S, .) and M-RoPE's (B, S, .) alike). The first
// rot = hd * rotary_pct dims of each head rotate, as halves x1 and x2:
//     out1 = x1 * c - x2 * s,   out2 = x2 * c + x1 * s,
// and the other hd - rot dims are copied through.
//
// What bounds it on an H100: bytes. A call reads x once and writes the
// output once (the tables, one row a token for all H heads, stay in L2),
// a few flops an element: at a serving layer's q and k, (32, 7845, 16 + 8,
// 128) bf16, 3.08 GB, 0.92 ms at 3.35 TB/s. The eager expression it
// replaces runs about ten kernels over fp32 temporaries the size of x, with
// the half-slices strided and the tables broadcast, ~10x those bytes.
//
// What the design does about it.
//  * One thread owns one pack of P elements of the row of a token (P = 8:
//    16-byte vectors of bf16, two of fp32) for all H heads: a rotation pack
//    (the P dims j.. of x1 and the P dims of x2 beside them) or a
//    pass-through pack. It loads the token's P cos and P sin once and walks
//    all H heads, kHeadGroup at a time: every load of a group starts
//    before any store, so each thread keeps 2 * kHeadGroup vectors in
//    flight. A serving round's B * S * (packs a token) threads fill the
//    132 SMs many times over.
//  * Consecutive threads own consecutive packs of a token, then of the
//    next token: at every head a warp reads and writes whole 32-byte
//    sectors of x and out.
//  * The wrapper passes `vec` where every pack is whole and 16-byte
//    aligned (rot/2 and hd multiples of 8, x and the tables on 16 bytes,
//    the tables' strides multiples of 4 floats); else the kernel's scalar
//    instance (P = 1) runs, one element a pack, for any width.
//  * x and out move with the streaming hint (each byte is used once a
//    call: evict first); the tables through the read-only path.
//
// Rounding. Each product is one __fmul_rn and each combination one
// __fsub_rn / __fadd_rn (no FMA contraction), and the store rounds to
// nearest even into x's dtype: bit for bit the eager expression's fp32
// products, difference and sum, then its cast.
//
// The entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kPack = 8;        // elements of a vector pack
constexpr int kHeadGroup = 4;   // heads whose loads start together

// flags of rope_fwd
constexpr int kBf16 = 1, kVec = 2;

struct RopeArgs {
  const void* x;
  const float* cos;
  const float* sin;
  void* out;
  int64_t tokens;      // B * S
  int64_t seq;         // S
  int64_t cos_sb, cos_ss, sin_sb, sin_ss;   // table strides, in floats
  int heads;
  int hd;
  int rot;
  int rot_packs;       // rot / 2 / P
  int pass_packs;      // (hd - rot) / P
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// P elements of T as raw 16-byte vectors (P = kPack) or one scalar (P = 1).
template <typename T, int P>
struct Raw {
  static constexpr int count = P * sizeof(T) / 16;
  uint4 v[count];
};
template <typename T>
struct Raw<T, 1> {
  T v[1];
};

template <typename T, int P>
__device__ __forceinline__ void load_raw(const T* p, Raw<T, P>& r) {
  if constexpr (P == 1) {
    r.v[0] = p[0];
  } else {
#pragma unroll
    for (int c = 0; c < Raw<T, P>::count; ++c)
      r.v[c] = __ldcs(reinterpret_cast<const uint4*>(p) + c);
  }
}

template <typename T, int P>
__device__ __forceinline__ void store_raw(T* p, const Raw<T, P>& r) {
  if constexpr (P == 1) {
    p[0] = r.v[0];
  } else {
#pragma unroll
    for (int c = 0; c < Raw<T, P>::count; ++c)
      __stcs(reinterpret_cast<uint4*>(p) + c, r.v[c]);
  }
}

template <typename T, int P>
__device__ __forceinline__ const T* elems(const Raw<T, P>& r) {
  return reinterpret_cast<const T*>(r.v);
}

template <typename T, int P>
__device__ __forceinline__ T* elems(Raw<T, P>& r) {
  return reinterpret_cast<T*>(r.v);
}

// P floats of a table row (two float4 where P = kPack)
template <int P>
__device__ __forceinline__ void load_table(const float* p, float (&v)[P]) {
  if constexpr (P == 1) {
    v[0] = __ldg(p);
  } else {
#pragma unroll
    for (int c = 0; c < P / 4; ++c) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p) + c);
      v[4 * c] = f.x;
      v[4 * c + 1] = f.y;
      v[4 * c + 2] = f.z;
      v[4 * c + 3] = f.w;
    }
  }
}

// Rotate G heads' packs: x1 at x + h * hd, x2 rot/2 further on.
template <typename T, int P, int G>
__device__ __forceinline__ void rotate_heads(const T* x, T* out, int h0,
                                             int hd, int half,
                                             const float (&c)[P],
                                             const float (&s)[P]) {
  Raw<T, P> a[G], b[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_raw(x + (h0 + g) * hd, a[g]);
    load_raw(x + (h0 + g) * hd + half, b[g]);
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Raw<T, P> o1, o2;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const float x1 = to_f32(elems(a[g])[k]);
      const float x2 = to_f32(elems(b[g])[k]);
      elems(o1)[k] = from_f32<T>(
          __fsub_rn(__fmul_rn(x1, c[k]), __fmul_rn(x2, s[k])));
      elems(o2)[k] = from_f32<T>(
          __fadd_rn(__fmul_rn(x2, c[k]), __fmul_rn(x1, s[k])));
    }
    store_raw(out + (h0 + g) * hd, o1);
    store_raw(out + (h0 + g) * hd + half, o2);
  }
}

// Copy G heads' packs through.
template <typename T, int P, int G>
__device__ __forceinline__ void copy_heads(const T* x, T* out, int h0,
                                           int hd) {
  Raw<T, P> a[G];
#pragma unroll
  for (int g = 0; g < G; ++g) load_raw(x + (h0 + g) * hd, a[g]);
#pragma unroll
  for (int g = 0; g < G; ++g) store_raw(out + (h0 + g) * hd, a[g]);
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreads) rope_kernel(const RopeArgs a) {
  const int slots = a.rot_packs + a.pass_packs;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= a.tokens * slots) return;
  const int64_t token = i / slots;
  const int slot = static_cast<int>(i - token * slots);
  const int64_t row = token * a.heads * a.hd;
  const T* x = static_cast<const T*>(a.x) + row;
  T* out = static_cast<T*>(a.out) + row;
  const int heads = a.heads;
  int h = 0;
  if (slot < a.rot_packs) {
    const int j = slot * P;
    const int half = a.rot / 2;
    const int64_t bi = token / a.seq, si = token - bi * a.seq;
    float c[P], s[P];
    load_table(a.cos + bi * a.cos_sb + si * a.cos_ss + j, c);
    load_table(a.sin + bi * a.sin_sb + si * a.sin_ss + j, s);
    for (; h + kHeadGroup <= heads; h += kHeadGroup)
      rotate_heads<T, P, kHeadGroup>(x + j, out + j, h, a.hd, half, c, s);
    for (; h < heads; ++h)
      rotate_heads<T, P, 1>(x + j, out + j, h, a.hd, half, c, s);
  } else {
    const int p = a.rot + (slot - a.rot_packs) * P;
    for (; h + kHeadGroup <= heads; h += kHeadGroup)
      copy_heads<T, P, kHeadGroup>(x + p, out + p, h, a.hd);
    for (; h < heads; ++h) copy_heads<T, P, 1>(x + p, out + p, h, a.hd);
  }
}

template <typename T>
cudaError_t launch(RopeArgs a, bool vec, cudaStream_t stream) {
  const int p = vec ? kPack : 1;
  a.rot_packs = a.rot / 2 / p;
  a.pass_packs = (a.hd - a.rot) / p;
  const int64_t threads = a.tokens * (a.rot_packs + a.pass_packs);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec)
    rope_kernel<T, kPack><<<grid, kThreads, 0, stream>>>(a);
  else
    rope_kernel<T, 1><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rope_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out (batch, seq, heads, hd) contiguous, bf16 (flags & kBf16) or fp32;
// cos/sin fp32 rows of >= rot/2 floats at b * *_sb + s * *_ss (strides in
// floats, 0 where a table broadcasts); rot even, 2 <= rot <= hd. kVec
// where rot/2 and hd are multiples of 8, x, out and the tables start on 16
// bytes and the tables' strides are multiples of 4. out must not alias x.
int rope_fwd(const void* x, const float* cos, const float* sin, void* out,
             long long batch, long long seq, int heads, int hd, int rot,
             long long cos_sb, long long cos_ss, long long sin_sb,
             long long sin_ss, int flags, void* stream) {
  const RopeArgs a{x,      cos,    sin,    out,   batch * seq, seq,
                   cos_sb, cos_ss, sin_sb, sin_ss, heads,      hd,
                   rot,    0,      0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (flags & kVec) != 0;
  const cudaError_t err = (flags & kBf16) ? launch<bf16>(a, vec, s)
                                          : launch<float>(a, vec, s);
  return static_cast<int>(err);
}

}  // extern "C"

// Causal flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel: causal (optionally
// sliding-window) softmax(q k^T / sqrt(hd)) v with the running max m, sum l
// and accumulator kept in fp32, KV tiles past the causal or window edge
// skipped, tiles on the edge masked per element with the finite score -1e30,
// and the output divided by max(l, 1e-30), in q's dtype.
//
// What bounds it on an H100. Causal attention over S keys takes
// 4 * B * H * S^2 * hd / 2 flops; at the zamba2-2.7b path's shapes (B = 2,
// S = 2048, H = 32, hd = 80, bf16) that is 4.3e10, 43 us at the tensor
// cores' 989 TFLOP/s, against 84 MB of q/k/v/o, 25 us at 3.35 TB/s: the
// operations bound it. This first kernel does its products in fp32 on the
// CUDA cores (67 TFLOP/s at most), as the TPU kernel upcasts to fp32 before
// its products, so it keeps the reference's arithmetic and runs well above
// that bound; a tensor-core (mma/wgmma) form is a later change.
//
// Design (FA2-style). One block of 256 threads per (batch*head, 64-query
// tile); it walks the live 64-key tiles in order. The q tile (scaled by
// 1/sqrt(hd) as the TPU kernel does, before the product) stays in shared
// memory, transposed; each key tile is staged with K transposed and V as it
// is. Thread (ty, tx) computes the 4x4 block of scores of rows 4ty..4ty+3
// and keys 4tx..4tx+3 with float4 reads, the 16 threads of a row group
// reduce the row max and sum with shuffles, P goes through shared memory,
// and the same thread accumulates rows 4ty..4ty+3 of P.V over the columns
// tx, tx+16, ... of hd. GQA is a head-index map (kv head = h / (Hq/Hkv)):
// K and V are never repeated. The -1e30 mask is kept finite: a row that is
// fully masked inside a live tile gets p = exp(0) = 1 junk, which the row's
// first real maximum multiplies by exp(-1e30 - m) = 0, as on the TPU; with
// -inf it would be NaN. Keys past S are zeroed and causally masked, and
// rows past S are not written, so S needs no divisibility.
//
// hd is a template parameter: 32, 80 or 128 (the ported configs' head dims:
// 32 in the smoke configs, 80 in zamba2-2.7b, 128 in internlm2-1.8b). Every
// entry point launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kLdT = kBQ + 4;    // row stride of the transposed q and k tiles
constexpr int kLdP = kBK + 1;    // row stride of P
constexpr float kNeg = -1e30f;

static_assert(kBQ == kBK, "the transposed q and k tiles share kLdT");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int HD>
constexpr int smem_bytes() {
  return (2 * HD * kLdT + kBK * HD + kBQ * kLdP) * 4;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Hq,
                 int Hkv, int window, float scale) {
  constexpr int kCols = HD / 16;   // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                // [HD][kLdT]
  float* ks = qs + HD * kLdT;      // [HD][kLdT]
  float* vs = ks + HD * kLdT;      // [kBK][HD]
  float* ps = vs + kBK * HD;       // [kBQ][kLdP]

  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int bh = blockIdx.y;
  const int bi = bh / Hq, hi = bh % Hq;
  const int hk = hi / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long q_rs = static_cast<long long>(Hq) * HD;
  const long long k_rs = static_cast<long long>(Hkv) * HD;
  const T* qb = q + (static_cast<long long>(bi) * S * Hq + hi) * HD;
  const T* kb = k + (static_cast<long long>(bi) * S * Hkv + hk) * HD;
  const T* vb = v + (static_cast<long long>(bi) * S * Hkv + hk) * HD;
  T* ob = o + (static_cast<long long>(bi) * S * Hq + hi) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, cc = i % HD, pos = q0 + r;
    qs[cc * kLdT + r] = pos < S ? to_f32(qb[pos * q_rs + cc]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) acc[i][jj] = 0.f;
  }

  const int q_last = min(q0 + kBQ, S) - 1;
  const int n_kt = q_last / kBK + 1;   // tiles up to the last row's diagonal
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    // left of every row's window: no live score (the TPU kernel's pl.when)
    if (window > 0 && k0 + kBK - 1 < q0 - window + 1) continue;
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, cc = i % HD, pos = k0 + r;
      const bool ok = pos < S;
      ks[cc * kLdT + r] = ok ? to_f32(kb[pos * k_rs + cc]) : 0.f;
      vs[r * HD + cc] = ok ? to_f32(vb[pos * k_rs + cc]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qs[d * kLdT + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&ks[d * kLdT + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty * 4 + i;
      const int qp = q0 + row;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rel = qp - (k0 + tx * 4 + j);
        const bool live = rel >= 0 && (window == 0 || rel < window);
        s[i][j] = live ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[row * kLdP + tx * 4 + j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty * 4 + i) * kLdP + kk];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float vv = vs[kk * HD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] = fmaf(p[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj)
      ob[qp * q_rs + tx + 16 * jj] = from_f32<T>(acc[i][jj] / denom);
  }
}

template <int HD, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Hq, int Hkv, int window, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  flash_fwd_kernel<HD, T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Hq, Hkv, window,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int B, int S, int Hq, int Hkv, int hd, int window,
                      float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<32, T>(q, k, v, o, B, S, Hq, Hkv, window, scale, stream);
    case 80:
      return launch<80, T>(q, k, v, o, B, S, Hq, Hkv, window, scale, stream);
    case 128:
      return launch<128, T>(q, k, v, o, B, S, Hq, Hkv, window, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o (B, S, Hq, hd); k, v (B, S, Hkv, hd); all contiguous, all fp32 or all
// bf16 (bf16 != 0). Hq a multiple of Hkv; hd in {32, 80, 128};
// window 0 for plain causal attention.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int hd, int window,
                        float scale, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0 ||
      static_cast<long long>(B) * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      bf16 ? launch_hd<__nv_bfloat16>(q, k, v, o, B, S, Hq, Hkv, hd, window,
                                      scale, st)
           : launch_hd<float>(q, k, v, o, B, S, Hq, Hkv, hd, window, scale,
                              st);
  return static_cast<int>(err);
}

}  // extern "C"

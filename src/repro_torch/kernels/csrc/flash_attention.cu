// Causal flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel: causal (optionally
// sliding-window) softmax(q k^T / sqrt(hd)) v with the running max m, sum l
// and accumulator kept in fp32, KV tiles past the causal or window edge
// skipped (the TPU kernel's pl.when), tiles on the edge masked per element
// with the finite score -1e30, and the output divided by max(l, 1e-30), in
// q's dtype. GQA is a head-index map (kv head = h / (Hq / Hkv)): K and V are
// never repeated. Keys past S are zero and masked, rows past S are not
// written, so S needs no divisibility. hd is a template parameter: 16, 32,
// 64, 80 or 128 for fp32, every head dim of the repo's configs (full and
// smoke), and 64, 80 or 128 for bf16, every full-size config's; the wrapper
// zero-pads any other hd <= 128 up to the next instance of its dtype, which
// is exact (zero columns add nothing to q.k, and the padded V columns fill
// only output columns it drops). A fully masked row inside a live tile
// gets p = exp(0) = 1 junk, which the row's first real maximum multiplies by
// exp(-1e30 - m) = 0, as on the TPU; with -inf it would be NaN.
//
// Two kernels, one per dtype (the entry point's bf16 flag):
//  - flash_fwd_kernel_wgmma: bf16, at hd 64, 80 and 128, so every served
//    prefill (smoke configs' hd 16 and 32 run zero-padded to 64);
//  - flash_fwd_kernel: fp32, on the CUDA cores.
//
// What bounds it on an H100. Causal attention over S keys takes
// 4 * B * H * S^2 * hd / 2 flops; at the zamba2-2.7b path's shapes (B = 2,
// S = 2048, H = 32, hd = 80, bf16) that is 4.3e10, 43 us at the tensor
// cores' 989 TFLOP/s, against 84 MB of q/k/v/o, 25 us at 3.35 TB/s: the
// tensor cores' rate bounds the function at every served shape. P enters
// P.V as two bf16 halves (below), so the kernel's own tensor work is 1.5x
// the function's; and the softmax costs about seven instructions a score
// (scale, max, subtract, exp2, the two conversions of the split, the
// rescale's share), as long as the products at hd 80. Measured (PERF.md
// section 6): the consumers' ALU phases, one warp a scheduler each while
// the other warpgroup is held issuing its wgmmas, now bound it; see there.
//
// Arithmetic of the bf16 kernel (the contract of the tensor-core design
// against the TPU kernel):
//  - q scale: the TPU kernel multiplies q by 1/sqrt(hd) in fp32 before the
//    product; the tensor cores need q in bf16, so the kernel forms the
//    product of the bf16 q and k (each product exact in fp32) and scales the
//    fp32 score. That moves each score by fp32 rounding only.
//  - base 2: p = exp2(s * scale * log2(e) - m') with the scale and log2(e)
//    folded into one multiply, m' the running max in those units: the same
//    exponential up to fp32 rounding of its argument (ex2.approx.ftz, the
//    approximation exp2f uses, with results below 2^-126 flushed to zero).
//  - P in bf16: rounding P to bf16 loses 8 bits and can flip the bf16 output
//    where |o| > 1. So P = hi + lo, hi = bf16(P), lo = bf16(P - hi), and
//    P.V is two products: P then enters with ~16 bits. l is summed from the
//    same hi + lo that enters P.V. A single bf16 P, measured as a variant,
//    used 0.742 of the one-ULP budget at the served shape and can move o by
//    up to 2^-9 of its size (PERF.md section 6), so the split stays.
//
// flash_fwd_kernel_wgmma, the FA3 shape on Hopper's own units:
//  - Work items are (batch, head, 128-query tile), the TPU kernel's block.
//    A persistent grid of one CTA per SM walks them in a fixed snake order,
//    the tiles with the most live KV tiles first (the last query tile of
//    every head, then the one before, ...), so the causal tail is spread
//    over the SMs instead of ending in a wave of short blocks.
//  - A CTA is three warpgroups. One thread of the first (the producer, its
//    registers cut to 24 by setmaxnreg) issues TMA loads: the item's Q tile
//    once, and 64-key K and V tiles into a ring of two stages, each stage
//    with a full and an empty mbarrier for K and for V, so S = Q K^T can
//    start before V has landed. Producer and consumers walk the same
//    live-tile range (kt_lo..kt_hi, the window's left edge and the
//    diagonal), so the ring's counts agree by construction.
//  - Two consumer warpgroups (setmaxnreg 240) own 64 query rows each,
//    wgmma's M. S = Q K^T is wgmma m64n64k16 with both operands in shared
//    memory (K-major), hd / 16 k-steps. P.V is one wgmma m64n{hd}k16 per
//    16 keys and half, P's hi and lo as the A operand from registers (the
//    S accumulator's layout is the A fragment's) and V from shared memory
//    as an MN-major B spanning its 64-column slabs. The row sum l is the
//    same hi and lo times a B of ones (m64n8k16) on the tensor cores,
//    accumulated and rescaled as O is. P.V of a tile is issued with S of
//    the next one, and the warpgroups take turns to issue on two named
//    barriers, so one's softmax runs under the other's products.
//  - The key tile is 64, not 128: at 128, S, P's hi and lo and O are live
//    together (192 registers at hd 128) and ptxas spilled and serialized
//    the wgmmas (C7512) at every hd; at 64 nothing spills.
//  - Tiles left of the diagonal and inside the window skip the mask, by a
//    branch on the warpgroup's rows; the rescale of O and l is skipped when
//    no row of the warp moved its max (the factor is then exactly 1).
//  - Tensor maps are 4-D (hd, H, S, B), innermost first, so a box that runs
//    past S reads zeros of its own batch, never the next batch's rows. They
//    are encoded on each call (cuTensorMapEncodeTiled, fetched through the
//    runtime's driver entry point, so the library links no -lcuda) and
//    passed as __grid_constant__ parameters. Every tile is stored in shared
//    memory as 64-column slabs of 128-byte rows with the 128-byte swizzle,
//    the layout wgmma reads: hd 64 one slab, hd 128 two; hd 80 two, the
//    second a box whose columns 80-127 lie past hd and which TMA fills with
//    zeros, the k-steps of S stopping at 80 and P.V an n80 product, so the
//    operands are never padded in device memory.
//  - Each KV tile's order inside a work item is fixed and nothing is summed
//    by atomics, so two identical calls give the same bits.
//  - The output is written from the fp32 accumulator, divided by
//    max(l, 1e-30) and rounded to bf16, by direct stores; rows past S are
//    not written.
//
// flash_fwd_kernel (fp32, the CUDA-core kernel): it keeps the TPU
// kernel's arithmetic (q scaled in fp32 before fp32 products on the CUDA
// cores) and serves fp32 checks. One block of 256 threads per (batch*head,
// 64-query tile); thread (ty, tx) computes the 4x4 block of scores of rows
// 4ty..4ty+3 and keys 4tx..4tx+3, the 16 threads of a row group reduce the
// row max and sum with shuffles, P goes through shared memory, and the same
// thread accumulates rows 4ty..4ty+3 of P.V over the columns tx, tx+16, ...
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError(), or the code of a failed tensor-map encode.

#include <cuda.h>   // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile

// ----------------------------------------------- fp32, on the CUDA cores

constexpr int kThreads = 256;
constexpr int kLdT = kBQ + 4;    // row stride of the transposed q and k tiles
constexpr int kLdP = kBK + 1;    // row stride of P

static_assert(kBQ == kBK, "the transposed q and k tiles share kLdT");

template <int HD>
constexpr int smem_bytes() {
  return (2 * HD * kLdT + kBK * HD + kBQ * kLdP) * 4;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int Hq, int Hkv, int window, float scale) {
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
  const float* qb = q + (static_cast<long long>(bi) * S * Hq + hi) * HD;
  const float* kb = k + (static_cast<long long>(bi) * S * Hkv + hk) * HD;
  const float* vb = v + (static_cast<long long>(bi) * S * Hkv + hk) * HD;
  float* ob = o + (static_cast<long long>(bi) * S * Hq + hi) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, cc = i % HD, pos = q0 + r;
    qs[cc * kLdT + r] = pos < S ? qb[pos * q_rs + cc] * scale : 0.f;
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
      ks[cc * kLdT + r] = ok ? kb[pos * k_rs + cc] : 0.f;
      vs[r * HD + cc] = ok ? vb[pos * k_rs + cc] : 0.f;
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
      ob[qp * q_rs + tx + 16 * jj] = acc[i][jj] / denom;
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Hq, int Hkv, int window,
                       float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  flash_fwd_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq, Hkv,
      window, scale);
  return cudaGetLastError();
}

// ------------------------ bf16 at hd 64, 80, 128: wgmma fed by TMA (FA3)

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 2^x on the SFU (ex2.approx.ftz: the approximation exp2f uses, with
// results below 2^-126 flushed to zero instead of kept subnormal)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), for two
// neighbours at once: the bf16 pairs (the first in the low half) that enter
// P.V, one packed conversion a half
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(p0 - __low2float(h), p1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

constexpr int kWgRows = 128;      // query rows of a work item
constexpr int kWgKeys = 64;       // keys of a KV tile
constexpr int kWgStages = 2;      // the K/V ring's depth
constexpr int kWgThreads = 384;   // producer warpgroup, two consumer ones
constexpr int kRowBytes = 128;    // a 128-byte-swizzled row: 64 bf16
constexpr int kSlabCols = 64;     // columns of one slab
constexpr int kQSlab = kWgRows * kRowBytes;   // one slab of a Q tile
constexpr int kKvSlab = kWgKeys * kRowBytes;  // one slab of a K or V tile
constexpr int kTurn0 = 1;         // named barriers 1, 2: the consumers' turns
constexpr int kConsumerWarps = 8;   // arrivals on an empty barrier
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

template <int HD>
struct WgShape {
  static constexpr int kSlabs = (HD + kSlabCols - 1) / kSlabCols;
  static constexpr int kKSteps = HD / 16;            // k-steps of Q K^T
  static constexpr int kQTile = kSlabs * kQSlab;
  static constexpr int kKvTile = kSlabs * kKvSlab;   // a K or a V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kWgStages * kKvTile;
  static constexpr int kOnes = kV + kWgStages * kKvTile;   // 16 x 64 ones
  static constexpr int kBar = kOnes + 16 * kRowBytes;
  // 2 + 4 * kWgStages mbarriers, and room to align the base to 1024
  static constexpr int kBytes = kBar + 128 + 1024;
  static_assert(HD == 64 || HD == 80 || HD == 128, "wgmma instances");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity. A wait
// of more than 2^34 cycles (about 10 s) can only be a broken ring: it
// traps, so the launch fails with an error instead of hanging the card.
constexpr long long kHangCycles = 1LL << 34;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > kHangCycles) __trap();
}

// one box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an asynchronous wgmma reads or writes: the compiler
// may neither move their uses across this point nor reuse them before it.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// A K-major operand (Q or K) of 64-column slabs `slab` bytes apart:
// 128-byte rows, 8-row atoms 1024 bytes apart; a k-step of 16 columns is
// 32 bytes inside the row's swizzle span.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int slab,
                                                int ks) {
  return smem_desc(tile + (ks / 4) * slab + (ks % 4) * 32, 16,
                   8 * kRowBytes);
}

// V as an MN-major B: 16 keys (two 8-row atoms, 1024 bytes apart), the
// 64-column MN atoms (slabs) `slab` bytes apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk,
                                                 uint32_t slab) {
  return smem_desc(tile + kk * 16 * kRowBytes, slab, 8 * kRowBytes);
}

// d (+)= A B, A (64x16) and B (16x64) K-major in shared memory; the
// first k-step (scale_d 0) overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, A (64x16) from registers, B (16x8) MN-major in shared
// memory (scale-d is a predicate, set from an operand of 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A (64x16) from registers, B (16x64) MN-major in shared
// memory (scale-d is a predicate, set from an operand of 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A (64x16) from registers, B (16x80) MN-major in shared
// memory (scale-d is a predicate, set from an operand of 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[40],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B, A (64x16) from registers, B (16x128) MN-major in shared
// memory (scale-d is a predicate, set from an operand of 1)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

struct WorkItem {
  int b, h, hk, q0, kt_lo, kt_hi;
};

// Item idx: query tile n_qt - 1 - idx / (B Hq) of head idx % (B Hq), so the
// tiles with the most live KV tiles come first; its live KV tiles from the
// first that reaches the first row's window to the last row's diagonal.
__device__ __forceinline__ WorkItem work_item(int idx, int n_qt, int B, int S,
                                              int Hq, int group, int window) {
  WorkItem it;
  const int n_bh = B * Hq;
  const int qt = n_qt - 1 - idx / n_bh;
  const int bh = idx % n_bh;
  it.b = bh / Hq;
  it.h = bh % Hq;
  it.hk = it.h / group;
  it.q0 = qt * kWgRows;
  it.kt_hi = (min(it.q0 + kWgRows, S) - 1) / kWgKeys;
  it.kt_lo = window > 0 ? max(0, it.q0 - window + 1) / kWgKeys : 0;
  return it;
}

// The item of round r for this CTA: a snake over the grid, so each CTA's
// sum of live tiles is close to the others'.
__device__ __forceinline__ int item_index(int r) {
  const int g = gridDim.x;
  return r * g + ((r & 1) ? g - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x));
}

// o += P V for one KV tile, per 16-key step hi then lo, one product of
// N = hd over the 64-column slabs of V; and l += P 1, the row sums of the
// same hi and lo on the tensor cores (an n8 product with a B of ones:
// every column of l holds the sum)
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 2], float (&l)[4],
                                        uint32_t (&pa)[kWgKeys / 16][4],
                                        uint32_t (&pl)[kWgKeys / 16][4],
                                        uint32_t vt, uint32_t ones) {
  const uint64_t d1 = mnmajor_desc(ones, 0, 0);
#pragma unroll
  for (int kk = 0; kk < kWgKeys / 16; ++kk) {
    const uint64_t d0 = mnmajor_desc(vt, kk, kKvSlab);
    wgmma_rs(o, pa[kk], d0);
    wgmma_rs(o, pl[kk], d0);
    wgmma_rs(l, pa[kk], d1);
    wgmma_rs(l, pl[kk], d1);
  }
}

// S = Q K^T for one KV tile: hd / 16 k-steps of m64n64k16, the first
// overwriting the accumulators
template <int HD>
__device__ __forceinline__ void s_tile(float (&s)[kWgKeys / 2], uint32_t q,
                                       uint32_t kt) {
#pragma unroll
  for (int ks = 0; ks < WgShape<HD>::kKSteps; ++ks) {
    const uint64_t da = kmajor_desc(q, kQSlab, ks);
    const uint64_t db = kmajor_desc(kt, kKvSlab, ks);
    wgmma_ss(s, da, db, ks > 0);
  }
}

// Scale, mask and the row max of one S tile in base 2 (scores, m and the
// -1e30 mask in units of log2 e): element e of n-tile i is row (e < 2 ?
// row0 : row1), key k0 + 8i + 2tq + (e & 1). kEdge: the tile crosses the
// diagonal or the window's left edge for some row of the warpgroup, so it
// is masked per element (keys past S lie past every row's diagonal); the
// others skip the mask altogether. Updates m; corr is the factor that
// takes the old m's sums to the new m.
template <bool kEdge>
__device__ __forceinline__ void tile_max(float (&s)[kWgKeys / 2],
                                         float (&m)[2], float (&corr)[2],
                                         int row0, int row1, int k0, int tq,
                                         int window, float scale_log2) {
  // four running maxima a row (element e of n-tile i goes to chain
  // (e & 1) + 2 (i & 1) of row e >> 1), so the chains are short; a max is
  // exact in any order
  float mx4[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mx4[r][c] = kNeg;
#pragma unroll
  for (int i = 0; i < kWgKeys / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * i + e] * scale_log2;
      if constexpr (kEdge) {
        const int rel = (e < 2 ? row0 : row1) - (k0 + 8 * i + 2 * tq + (e & 1));
        const bool live = rel >= 0 && (window == 0 || rel < window);
        x = live ? x : kNeg;
      }
      s[4 * i + e] = x;
      float& acc = mx4[e >> 1][(e & 1) + 2 * (i & 1)];
      acc = fmaxf(acc, x);
    }
  float mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(fmaxf(mx4[r][0], mx4[r][1]), fmaxf(mx4[r][2], mx4[r][3]));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
}

// tile_max with the edge decided for the whole warpgroup (from its first
// row rw), as a branch: the masked and the plain code are separate blocks
__device__ __forceinline__ void tile_max(float (&s)[kWgKeys / 2],
                                         float (&m)[2], float (&corr)[2],
                                         int row0, int row1, int k0, int rw,
                                         int tq, int window,
                                         float scale_log2) {
  if (k0 + kWgKeys - 1 > rw || (window > 0 && rw + 63 - k0 >= window))
    tile_max<true>(s, m, corr, row0, row1, k0, tq, window, scale_log2);
  else
    tile_max<false>(s, m, corr, row0, row1, k0, tq, window, scale_log2);
}

// P = exp2(s - m) as hi + lo, the A operand of P V: per 16-key step kk,
// (a0, a1, a2, a3) = (n-tile 2kk rows g | g+8, n-tile 2kk+1 rows g | g+8),
// the S accumulator's own layout
__device__ __forceinline__ void tile_p(const float (&s)[kWgKeys / 2],
                                       const float (&m)[2],
                                       uint32_t (&pa)[kWgKeys / 16][4],
                                       uint32_t (&pl)[kWgKeys / 16][4]) {
#pragma unroll
  for (int i = 0; i < kWgKeys / 8; ++i) {
    const int kk = i / 2, hi2 = (i & 1) * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      split_pair(ex2(s[4 * i + 2 * r] - m[r]), ex2(s[4 * i + 2 * r + 1] - m[r]),
                 pa[kk][hi2 + r], pl[kk][hi2 + r]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, int B, int S, int Hq, int Hkv,
                       int window, float scale_log2, int n_items) {
  using Sh = WgShape<HD>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (smem_addr(wg_smem) + 1023u) & ~1023u;
  const uint32_t q_tile = base + Sh::kQ;
  const uint32_t bars = base + Sh::kBar;
  // mbarriers: q_full, q_empty, then per stage k_full, k_empty, v_full,
  // v_empty
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int st) { return bars + 16 + 32 * st; };
  auto k_empty = [&](int st) { return bars + 24 + 32 * st; };
  auto v_full = [&](int st) { return bars + 32 + 32 * st; };
  auto v_empty = [&](int st) { return bars + 40 + 32 * st; };
  const int n_qt = (S + kWgRows - 1) / kWgRows;
  const int group = Hq / Hkv;

  // the ones operand of the row sums, written once (bf16 1.0 pairs) and
  // made visible to the tensor cores' (async) proxy
  const uint32_t ones = base + Sh::kOnes;
  for (int i = threadIdx.x; i < 16 * kRowBytes / 4; i += kWgThreads)
    asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ones + 4 * i),
                 "r"(0x3F803F80u)
                 : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, kConsumerWarps);
    for (int st = 0; st < kWgStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(k_empty(st), kConsumerWarps);
      mbar_init(v_full(st), 1);
      mbar_init(v_empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup's index, warp-uniform in the compiler's eyes
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ------------------------------------------------------ the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int t = 0, n = 0;
      for (int r = 0; r * static_cast<int>(gridDim.x) < n_items; ++r) {
        const int idx = item_index(r);
        if (idx >= n_items) continue;
        const WorkItem it = work_item(idx, n_qt, B, S, Hq, group, window);
        mbar_wait(q_empty, (n & 1) ^ 1);
        mbar_expect_tx(q_full, Sh::kQTile);
#pragma unroll
        for (int s = 0; s < Sh::kSlabs; ++s)
          tma_load(q_tile + s * kQSlab, &tq, q_full, s * kSlabCols, it.h,
                   it.q0, it.b);
        for (int kt = it.kt_lo; kt <= it.kt_hi; ++kt, ++t) {
          const int st = t % kWgStages;
          const uint32_t ph = (t / kWgStages) & 1;
          const uint32_t kt_s = base + Sh::kK + st * Sh::kKvTile;
          const uint32_t vt_s = base + Sh::kV + st * Sh::kKvTile;
          mbar_wait(k_empty(st), ph ^ 1);
          mbar_expect_tx(k_full(st), Sh::kKvTile);
#pragma unroll
          for (int s = 0; s < Sh::kSlabs; ++s)
            tma_load(kt_s + s * kKvSlab, &tk, k_full(st), s * kSlabCols,
                     it.hk, kt * kWgKeys, it.b);
          mbar_wait(v_empty(st), ph ^ 1);
          mbar_expect_tx(v_full(st), Sh::kKvTile);
#pragma unroll
          for (int s = 0; s < Sh::kSlabs; ++s)
            tma_load(vt_s + s * kKvSlab, &tv, v_full(st), s * kSlabCols,
                     it.hk, kt * kWgKeys, it.b);
        }
        ++n;
      }
    }
  } else {
    // ---------------------------------------------------- the consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int w = role - 1;                  // consumer warpgroup 0 or 1
    const int tid = threadIdx.x % 128;
    const int wq = tid / 32, lane = tid % 32;
    const int g = lane / 4, tq = lane % 4;   // accumulator row, column pair
    const long long q_rs = static_cast<long long>(Hq) * HD;
    const uint32_t q_desc = q_tile + 64 * w * kRowBytes;   // its 64 rows
    if (w == 1) named_arrive(kTurn0);        // warpgroup 0 issues first
    int t = 0, n = 0;
    // acc: rows (g, g + 8) x columns 8i + 2tq (+1) in acc[4i + 2 (row) + col];
    // l: the same rows' sums of what entered P V, every column alike
    float acc[HD / 2], l[4], s[kWgKeys / 2];
    uint32_t pa[kWgKeys / 16][4], pl[kWgKeys / 16][4];
    for (int r = 0; r * static_cast<int>(gridDim.x) < n_items; ++r) {
      const int idx = item_index(r);
      if (idx >= n_items) continue;
      const WorkItem it = work_item(idx, n_qt, B, S, Hq, group, window);
      const int rw = it.q0 + 64 * w;         // the warpgroup's first row
      const int row0 = rw + 16 * wq + g, row1 = row0 + 8;
      float m[2] = {kNeg, kNeg}, corr[2];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) l[i] = 0.f;

      // the first KV tile: S = Q K^T alone, in this warpgroup's turn
      int st = t % kWgStages;
      uint32_t ph = (t / kWgStages) & 1;
      mbar_wait(q_full, n & 1);
      mbar_wait(k_full(st), ph);
      named_sync(kTurn0 + w);
      wg_fence();
      s_tile<HD>(s, q_desc, base + Sh::kK + st * Sh::kKvTile);
      wg_commit();
      named_arrive(kTurn0 + (1 - w));
      wg_wait<0>();
      pin(s);
      if (lane == 0) {
        mbar_arrive(k_empty(st));
        if (it.kt_lo == it.kt_hi) mbar_arrive(q_empty);
      }
      tile_max(s, m, corr, row0, row1, it.kt_lo * kWgKeys, rw, tq, window,
               scale_log2);
      tile_p(s, m, pa, pl);

      // every further tile: S of this tile and P V of the one before, in
      // this warpgroup's turn; the softmax runs under the other's products
      for (int kt = it.kt_lo + 1; kt <= it.kt_hi; ++kt) {
        const int pst = st;
        const uint32_t pph = ph;
        ++t;
        st = t % kWgStages;
        ph = (t / kWgStages) & 1;
        mbar_wait(k_full(st), ph);
        mbar_wait(v_full(pst), pph);
        named_sync(kTurn0 + w);
        pin(acc);
        pin(l);
        wg_fence();
        s_tile<HD>(s, q_desc, base + Sh::kK + st * Sh::kKvTile);
        wg_commit();
        pv_tile<HD>(acc, l, pa, pl, base + Sh::kV + pst * Sh::kKvTile, ones);
        wg_commit();
        named_arrive(kTurn0 + (1 - w));
        wg_wait<1>();
        pin(s);
        if (lane == 0) {
          mbar_arrive(k_empty(st));
          if (kt == it.kt_hi) mbar_arrive(q_empty);
        }
        tile_max(s, m, corr, row0, row1, kt * kWgKeys, rw, tq, window,
                 scale_log2);
        wg_wait<0>();                        // the previous P V
        pin(acc);
        pin(l);
        pin(pa);
        pin(pl);
        if (lane == 0) mbar_arrive(v_empty(pst));
        tile_p(s, m, pa, pl);
        // rescale to the new max, unless no row of the warp moved (corr
        // is then 1.0 exactly and the products would change nothing)
        if (!__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) {
#pragma unroll
          for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
          for (int i = 0; i < 4; ++i) l[i] *= corr[(i >> 1) & 1];
        }
      }

      // the last tile's P V, in this warpgroup's turn
      mbar_wait(v_full(st), ph);
      named_sync(kTurn0 + w);
      pin(acc);
      pin(l);
      wg_fence();
      pv_tile<HD>(acc, l, pa, pl, base + Sh::kV + st * Sh::kKvTile, ones);
      wg_commit();
      named_arrive(kTurn0 + (1 - w));
      wg_wait<0>();
      pin(acc);
      pin(l);
      pin(pa);
      pin(pl);
      if (lane == 0) mbar_arrive(v_empty(st));
      ++t;

      // o = acc / max(l, 1e-30) in bf16; rows past S are not written
      bf16* ob = o + (static_cast<long long>(it.b) * S * Hq + it.h) * HD;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = rr == 0 ? row0 : row1;
        if (row >= S) continue;
        const float denom = fmaxf(l[2 * rr], 1e-30f);
        bf16* orow = ob + row * q_rs + 2 * tq;
#pragma unroll
        for (int i = 0; i < HD / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
              __floats2bfloat162_rn(acc[4 * i + 2 * rr] / denom,
                                    acc[4 * i + 2 * rr + 1] / denom);
      }
      ++n;
    }
    if (w == 0) named_sync(kTurn0);   // warpgroup 1's first arrival
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Error codes of the tensor maps, beside CUDA's own (all below 10000)
constexpr int kNoEncoder = 20000;   // no cuTensorMapEncodeTiled
constexpr int kEncodeError = 10000;  // + the CUresult of a failed encode

// (B, S, H, hd) bf16 as a 4-D map (hd, H, S, B), innermost first, boxes of
// 64 columns x 1 head x rows x 1 batch, 128-byte swizzle; what lies
// past hd or S reads as zeros
int encode_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H,
                int HD, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {HD * e, static_cast<cuuint64_t>(H) * HD * e,
                                 static_cast<cuuint64_t>(S) * H * HD * e};
  const cuuint32_t box[4] = {kSlabCols, 1, static_cast<cuuint32_t>(rows),
                             1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Hq, int Hkv, int window, float scale,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, q, B, S, Hq, HD, kWgRows);
  if (err == 0) err = encode_bshd(&tk, k, B, S, Hkv, HD, kWgKeys);
  if (err == 0) err = encode_bshd(&tv, v, B, S, Hkv, HD, kWgKeys);
  if (err != 0) return err;
  const long long n_items =
      static_cast<long long>(B) * Hq * ((S + kWgRows - 1) / kWgRows);
  if (n_items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  constexpr int bytes = WgShape<HD>::kBytes;
  cerr = cudaFuncSetAttribute(flash_fwd_kernel_wgmma<HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  flash_fwd_kernel_wgmma<HD><<<grid, kWgThreads, bytes, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), B, S, Hq, Hkv, window,
      scale * 1.44269504088896341f, static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

// fp32 on the CUDA cores at every instance; bf16 on the wgmma kernel, whose
// instances are hd 64, 80 and 128 (the wrapper zero-pads a smaller hd to 64)
template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Hq, int Hkv, int window, float scale, int is_bf16,
           cudaStream_t stream) {
  if (!is_bf16)
    return static_cast<int>(
        launch_f32<HD>(q, k, v, o, B, S, Hq, Hkv, window, scale, stream));
  if constexpr (HD >= 64)
    return launch_wgmma<HD>(q, k, v, o, B, S, Hq, Hkv, window, scale,
                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  if (err == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through the driver entry point";
  if (err >= kEncodeError && err < kNoEncoder)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = "
           "code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o (B, S, Hq, hd); k, v (B, S, Hkv, hd); all contiguous, all fp32 or all
// bf16 (bf16 != 0; then 16-byte aligned). Hq a multiple of Hkv; hd in
// {16, 32, 64, 80, 128} for fp32, {64, 80, 128} for bf16; window 0 for plain
// causal attention.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int hd, int window,
                        float scale, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0 ||
      static_cast<long long>(B) * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16:
      return launch<16>(q, k, v, o, B, S, Hq, Hkv, window, scale, bf16, st);
    case 32:
      return launch<32>(q, k, v, o, B, S, Hq, Hkv, window, scale, bf16, st);
    case 64:
      return launch<64>(q, k, v, o, B, S, Hq, Hkv, window, scale, bf16, st);
    case 80:
      return launch<80>(q, k, v, o, B, S, Hq, Hkv, window, scale, bf16, st);
    case 128:
      return launch<128>(q, k, v, o, B, S, Hq, Hkv, window, scale, bf16,
                         st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

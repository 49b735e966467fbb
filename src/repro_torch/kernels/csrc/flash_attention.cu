// Causal flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_flash_kernel: causal (optionally
// sliding-window) softmax(q k^T / sqrt(hd)) v with the running max m, sum l
// and accumulator kept in fp32, KV tiles past the causal or window edge
// skipped (the TPU kernel's pl.when), tiles on the edge masked per element
// with the finite score -1e30, and the output divided by max(l, 1e-30), in
// q's dtype. GQA is a head-index map (kv head = h / (Hq / Hkv)): K and V are
// never repeated. Keys past S are zeroed and masked, rows past S are not
// written, so S needs no divisibility. hd is a template parameter: 16, 32,
// 64, 80 or 128, every head dim of the repo's configs (full and smoke); the
// wrapper zero-pads any other hd <= 128 up to the next of these, which is
// exact (zero columns add nothing to q.k, and the padded V columns fill only
// output columns it drops). A fully masked row inside a live tile
// gets p = exp(0) = 1 junk, which the row's first real maximum multiplies by
// exp(-1e30 - m) = 0, as on the TPU; with -inf it would be NaN.
//
// What bounds it on an H100. Causal attention over S keys takes
// 4 * B * H * S^2 * hd / 2 flops; at the zamba2-2.7b path's shapes (B = 2,
// S = 2048, H = 32, hd = 80, bf16) that is 4.3e10, 43 us at the tensor
// cores' 989 TFLOP/s, against 84 MB of q/k/v/o, 25 us at 3.35 TB/s: the
// tensor cores' rate bounds it. Measured: 0.340 ms for the bf16 instance,
// 2.6x cuDNN's attention through PyTorch (PERF.md section 6).
//
// bf16 instance (flash_fwd_kernel_mma, the one the served models use).
// FA2-style on the tensor cores. One block of 4 warps owns a 64-query tile
// of one (batch, head); each warp owns 16 query rows. The q tile and
// double-buffered 64-key K and V tiles are copied into shared memory with
// 16-byte cp.async (zero-filled past S), so the next K/V tile's copy runs
// under this tile's math. Both products are mma.sync.m16n8k16 with bf16
// operands and fp32 accumulators; fragments come from shared memory by
// ldmatrix (V with .trans). S stays in registers; the online softmax (m, l,
// the correction) is fp32 per row, with quad shuffles for the row max and
// sum. P stays in registers as the A operand of P.V.
// Arithmetic against the TPU kernel:
//  - q scale: the TPU kernel multiplies q by 1/sqrt(hd) in fp32 before the
//    product; the tensor cores need q in bf16, so this kernel forms the
//    product of the bf16 q and k (each product exact in fp32) and scales the
//    fp32 score. That moves each score by fp32 rounding only.
//  - base 2: p = exp2(s * scale * log2(e) - m') with the scale and log2(e)
//    folded into one multiply, m' the running max in those units: the same
//    exponential up to fp32 rounding of its argument (exp2f, no fast math).
//  - P in bf16: rounding P to bf16 loses 8 bits and can flip the bf16 output
//    where |o| > 1. So P = hi + lo, hi = bf16(P), lo = bf16(P - hi), and
//    P.V is two MMAs: P then enters with ~16 bits. l is summed from the
//    same hi + lo that enters P.V. A single bf16 P, measured as a variant,
//    used 0.742 of the one-ULP budget at the served shape and can move o by
//    up to 2^-9 of its size (PERF.md section 6), so the split stays.
// The next step, if this still loses to cuDNN's attention: the FA3 shape,
// wgmma from shared memory fed by TMA under mbarriers, with a producer warp
// and two consumer warpgroups ping-ponging softmax and MMA.
//
// fp32 instance (flash_fwd_kernel, the CUDA-core kernel): it keeps the TPU
// kernel's arithmetic (q scaled in fp32 before fp32 products on the CUDA
// cores) and serves fp32 checks. One block of 256 threads per (batch*head,
// 64-query tile); thread (ty, tx) computes the 4x4 block of scores of rows
// 4ty..4ty+3 and keys 4tx..4tx+3, the 16 threads of a row group reduce the
// row max and sum with shuffles, P goes through shared memory, and the same
// thread accumulates rows 4ty..4ty+3 of P.V over the columns tx, tx+16, ...
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ------------------------------------------ bf16, on the tensor cores

using bf16 = __nv_bfloat16;
constexpr int kMmaWarps = 4;                 // 16 query rows each
constexpr int kMmaThreads = kMmaWarps * 32;

// bf16 elements per shared row: hd plus 16 bytes, so the 8 rows an
// ldmatrix phase reads fall in 8 different groups of 4 banks (16 bytes):
// a row of (hd + 8) * 2 bytes is 2k+1 groups of 16 bytes for every hd that
// is a multiple of 16 (hd 16: 48 B = 3 groups, rows r at groups 3r mod 8;
// 32: 5; 64: 9, i.e. r; 80: 11; 128: 17), an odd stride, so r -> r(2k+1)
// mod 8 is a permutation of the 8 groups
template <int HD>
__host__ __device__ constexpr int mma_ld() {
  return HD + 8;
}

// q tile, then K[2] and V[2]
template <int HD>
__host__ __device__ constexpr int mma_smem_bytes() {
  return 5 * kBK * mma_ld<HD>() * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled when !ok (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// p as two bf16 halves: hi = bf16(p), lo = bf16(p - hi). Returns the fp32
// value of what enters P.V, hi + lo (exact in fp32).
__device__ __forceinline__ float split_p(float p, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(p);
  const float h = __bfloat162float(hi);
  lo = __float2bfloat16_rn(p - h);
  return h + __bfloat162float(lo);
}

// two bf16 values as one register, the first in the low half
__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  const __nv_bfloat162 v = __halves2bfloat162(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// hd <= 80: 3 blocks (12 warps) per SM within the register file; hd 128's
// shared tiles leave room for 2
template <int HD>
__global__ void __launch_bounds__(kMmaThreads, HD <= 80 ? 3 : 2)
flash_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                     int Hq, int Hkv, int window, float scale) {
  constexpr int kLd = mma_ld<HD>();
  constexpr int kTile = kBK * kLd;      // elements of one 64-row tile
  constexpr int kChunks = HD / 8;       // 16-byte chunks per row
  constexpr int kKSteps = HD / 16;      // k-steps of Q.K^T
  constexpr int kNT = HD / 8;           // n-tiles of 8 columns of the output
  static_assert(HD % 16 == 0 && kNT % 2 == 0, "hd a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // [64][kLd]
  bf16* ks = qs + kTile;                           // [2][64][kLd]
  bf16* vs = ks + 2 * kTile;                       // [2][64][kLd]

  const int qt = gridDim.x - 1 - blockIdx.x;   // the longest rows first
  const int bh = blockIdx.y;
  const int bi = bh / Hq, hi = bh % Hq;
  const int hk = hi / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tg = lane % 4;      // mma fragment row, column pair
  const long long q_rs = static_cast<long long>(Hq) * HD;
  const long long k_rs = static_cast<long long>(Hkv) * HD;
  const bf16* qb = q + (static_cast<long long>(bi) * S * Hq + hi) * HD;
  const bf16* kb = k + (static_cast<long long>(bi) * S * Hkv + hk) * HD;
  const bf16* vb = v + (static_cast<long long>(bi) * S * Hkv + hk) * HD;
  bf16* ob = o + (static_cast<long long>(bi) * S * Hq + hi) * HD;

  // the live key tiles: up to the last row's diagonal, from the first tile
  // that reaches the first row's window (the TPU kernel's pl.when skip)
  const int kt_hi = (min(q0 + kBQ, S) - 1) / kBK;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  auto load_tile = [&](bf16* dst, const bf16* src, long long rs, int r0) {
    for (int i = tid; i < kBK * kChunks; i += kMmaThreads) {
      const int r = i / kChunks, ch = i % kChunks, pos = r0 + r;
      const bool ok = pos < S;
      cp_async16(dst + r * kLd + ch * 8, src + (ok ? pos * rs + ch * 8 : 0),
                 ok);
    }
  };

  load_tile(qs, qb, q_rs, q0);
  load_tile(ks, kb, k_rs, kt_lo * kBK);
  load_tile(vs, vb, k_rs, kt_lo * kBK);
  cp_async_commit();

  // this thread's two rows: gr and gr + 8 of the warp's 16
  const int row0 = q0 + warp * 16 + gr, row1 = row0 + 8;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[kKSteps][4];
  // ldmatrix.x4 row addresses: lane l feeds row l % 8 of matrix l / 8
  const int lm = lane / 8, lr = lane % 8;
  const float scale_log2 = scale * 1.44269504088896341f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int buf = (kt - kt_lo) & 1;
    if (kt < kt_hi) {
      load_tile(ks + (buf ^ 1) * kTile, kb, k_rs, (kt + 1) * kBK);
      load_tile(vs + (buf ^ 1) * kTile, vb, k_rs, (kt + 1) * kBK);
    }
    cp_async_commit();   // possibly empty: one group per tile all the same
    cp_async_wait1();    // this tile (and q) landed; the next may be in flight
    __syncthreads();
    if (kt == kt_lo) {
      // A fragments of q: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
#pragma unroll
      for (int s = 0; s < kKSteps; ++s)
        ldsm_x4(qf[s], smem_addr(qs + (warp * 16 + lane % 16) * kLd + s * 16
                                 + (lane / 16) * 8));
    }
    const bf16* kt_s = ks + buf * kTile;
    const bf16* vt_s = vs + buf * kTile;

    // S = q k^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int s = 0; s < kKSteps; ++s) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // K is [key][hd], i.e. B^T row-major: matrices (keys 16j..+7 |
        // 16j+8..+15) x (hd 16s..+7 | 16s+8..+15)
        uint32_t b[4];
        ldsm_x4(b, smem_addr(kt_s + (16 * j + 8 * (lm >> 1) + lr) * kLd
                             + s * 16 + 8 * (lm & 1)));
        mma16816(sc[2 * j], qf[s], b[0], b[1]);
        mma16816(sc[2 * j + 1], qf[s], b[2], b[3]);
      }
    }

    // scale, mask, online softmax in base 2 (scores, m and the -1e30 mask
    // in units of log2 e); element e of n-tile j is row (e < 2 ? row0 :
    // row1), key k0 + 8j + 2tg + (e & 1)
    const int k0 = kt * kBK;
    const bool edge = k0 + kBK - 1 > q0 || k0 + kBK - 1 >= S ||
                      (window > 0 && k0 < q0 + kBQ - window);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (edge) {
          const int rel = (e < 2 ? row0 : row1) - (k0 + 8 * j + 2 * tg
                                                   + (e & 1));
          const bool live = rel >= 0 && (window == 0 || rel < window);
          x = live ? x : kNeg;
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }

    // P as the A operand of P.V, per 16-key step: (a0, a1, a2, a3) =
    // (n-tile 2kk rows gr | gr+8, n-tile 2kk+1 rows gr | gr+8)
    uint32_t pa[4][4], pl[4][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      bf16 h4[4], l4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rs[e >> 1] += split_p(exp2f(sc[j][e] - m[e >> 1]), h4[e], l4[e]);
      const int kk = j / 2, hi2 = (j & 1) * 2;
      pa[kk][hi2] = pack2(h4[0], h4[1]);
      pa[kk][hi2 + 1] = pack2(h4[2], h4[3]);
      pl[kk][hi2] = pack2(l4[0], l4[1]);
      pl[kk][hi2 + 1] = pack2(l4[2], l4[3]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];

    // acc += P V: V is [key][hd] = B row-major, so ldmatrix.trans;
    // matrices (keys 16kk..+7 | 16kk+8..+15) x (hd 16jj..+7 | 16jj+8..+15)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int jj = 0; jj < kNT / 2; ++jj) {
        uint32_t b[4];
        ldsm_x4_t(b, smem_addr(vt_s + (16 * kk + 8 * (lm & 1) + lr) * kLd
                               + 16 * jj + 8 * (lm >> 1)));
        mma16816(acc[2 * jj], pa[kk], b[0], b[1]);
        mma16816(acc[2 * jj + 1], pa[kk], b[2], b[3]);
        mma16816(acc[2 * jj], pl[kk], b[0], b[1]);
        mma16816(acc[2 * jj + 1], pl[kk], b[2], b[3]);
      }
    }
    __syncthreads();   // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row0 : row1;
    if (row >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = ob + row * q_rs + 2 * tg;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(acc[j][2 * r] / denom,
                                acc[j][2 * r + 1] / denom);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Hq, int Hkv, int window,
                       float scale, cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel_mma<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * Hq);
  flash_fwd_kernel_mma<HD><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Hq, Hkv, window,
      scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Hq, int Hkv, int window, float scale,
                   int is_bf16, cudaStream_t stream) {
  if (!is_bf16)
    return launch_f32<HD>(q, k, v, o, B, S, Hq, Hkv, window, scale, stream);
  return launch_mma<HD>(q, k, v, o, B, S, Hq, Hkv, window, scale, stream);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, o (B, S, Hq, hd); k, v (B, S, Hkv, hd); all contiguous, all fp32 or all
// bf16 (bf16 != 0; then 16-byte aligned). Hq a multiple of Hkv; hd in
// {16, 32, 64, 80, 128}; window 0 for plain causal attention.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int Hq, int Hkv, int hd, int window,
                        float scale, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || Hkv < 1 || Hq % Hkv != 0 || window < 0 ||
      static_cast<long long>(B) * Hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 16:
      return static_cast<int>(launch<16>(q, k, v, o, B, S, Hq, Hkv, window,
                                         scale, bf16, st));
    case 32:
      return static_cast<int>(launch<32>(q, k, v, o, B, S, Hq, Hkv, window,
                                         scale, bf16, st));
    case 64:
      return static_cast<int>(launch<64>(q, k, v, o, B, S, Hq, Hkv, window,
                                         scale, bf16, st));
    case 80:
      return static_cast<int>(launch<80>(q, k, v, o, B, S, Hq, Hkv, window,
                                         scale, bf16, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, o, B, S, Hq, Hkv, window,
                                          scale, bf16, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

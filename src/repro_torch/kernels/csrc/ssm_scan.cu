// Selective scan (Mamba1/Mamba2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::_scan_kernel.
// For each group g (a batch row) and channel d it runs the recurrence
//     h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t x_t) B_t ,   y_t = h_t . C_t
// over t = 0..S-1 from h_{-1} = 0, and returns y (G, S, D) fp32 (without the
// D.x skip and the gate, which the caller adds) and h_final (G, D, N) fp32.
// The (S, D, N) state trajectory never reaches device memory. Two kernels:
//
//  - ssm_scan_kernel (entry ssm_scan): the recurrence step by step on the
//    CUDA cores, for any A (the general form, Mamba1's, and A constant
//    along N). Its note follows.
//  - ssm_scan_kernel_ssd (entry ssm_scan_heads): Mamba2's per-head form,
//    dt and A one value per head of P channels, as chunked products on the
//    tensor cores (wgmma) fed by TMA, the state carried across chunks. Its
//    note is above its code, below.
//
// ssm_scan_kernel. Two forms of A, told apart by A's N stride:
//  - per channel (N stride 0): Mamba2's A is per head, so constant along N.
//    The decay exp(dt_t * a_d) is computed once per (t, channel) and applied
//    to all N states: G*S*D exponentials instead of G*S*D*N.
//  - general (a contiguous (D, N) block): Mamba1's dense A; one exponential
//    per (t, channel, state).
// Both compute the same expf of the same product and write the state update
// as fmaf(decay, h, (dt x) * b), so for the same values of A they give the
// same h bit for bit.
//
// What bounds it on an H100. At the zamba2-2.7b path's shapes (G = 2,
// S = 2048, D = 5120, N = 64; dt fp32, x/B/C bf16, A per channel) the
// kernel reads ~127 MB and writes ~87 MB once: 64 us at 3.35 TB/s. It does
// 3 fp32 operations per (t, d, n) (dx*b, the state FMA, the y FMA):
// 4.0e9 lane instructions, 120 us at the CUDA cores' 67 TFLOP/s (an FMA
// counted as 2 flops), and 2.1e7 exponentials (5 us at the special-function
// rate). So the fp32 instruction rate bounds this form at 0.120 ms.
// The general form adds G*S*D*N exponentials (1.34e9 at those shapes:
// 0.321 ms). Measured: 0.544 ms for the per-channel form (PERF.md section 6).
//
// ssm_scan_kernel's design. The TPU grid walks S in order and carries a
// (dblk, N) state tile in VMEM scratch across grid steps. Here one block
// owns (g, 32 channels)
// and walks all of S in a loop inside the block, so nothing carries between
// blocks. Lane l of every warp is channel d0 + l; warp w holds the 8 states
// 8w..8w+7 of its channel in registers, so a block has ceil(N / 8) warps,
// no lane idles, and every lane of a warp reads the same B_t, C_t values
// (shared-memory broadcasts). Tiles of 16 time steps of dt, x, B and C are
// copied into shared memory with 16-byte cp.async, double-buffered, so the
// next tile loads under this tile's recurrence. A prep pass per tile
// upcasts x, B, C to fp32 and forms dt*x and, per channel, the decay. Each
// lane writes its 8-state partial of y_t to shared memory; the N-sum is one
// pass per tile that adds the warps' partials in warp order and stores y in
// coalesced rows. That order differs from XLA's, so y agrees with the plain
// version to fp32 rounding, not bit for bit. Channels past D and states
// past N are masked (dt = 0, x = B = C = 0: their state stays 0), and the
// last tile may be short: there is no divisibility requirement on S, D or
// N. expf without fast math: the exponent feeds every later state.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch, or the code of a failed
// tensor-map encode.

#include <cuda.h>   // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 16;          // time steps per staged tile
constexpr int kC = 32;          // channels per block: one per lane
constexpr int kSPL = 8;         // states per lane (and per warp)
constexpr int kMaxWarps = 16;   // N <= 128

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void set_zero(float& v) { v = 0.f; }
__device__ __forceinline__ void set_zero(__nv_bfloat16& v) {
  v = __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Bytes of one staged tile (dt, x, B, C) for np padded states.
template <typename TX, typename TBC>
__host__ __device__ constexpr int raw_bytes(int np) {
  return kT * kC * (4 + static_cast<int>(sizeof(TX))) +
         2 * kT * np * static_cast<int>(sizeof(TBC));
}

// Two staged tiles, then fp32 decay (or dt), dt*x, B, C, and the warps'
// partial sums of y.
template <typename TX, typename TBC>
__host__ __device__ constexpr int smem_bytes(int nw) {
  return 2 * raw_bytes<TX, TBC>(nw * kSPL) +
         4 * (2 * kT * kC + 2 * kT * nw * kSPL + nw * kT * kC);
}

// Copy rows [0, kT) x columns [0, cols) of src (row stride src_rs) into dst
// (row stride cols), zero past `rows` rows and `valid` columns: a 16-byte
// cp.async per chunk that lies inside and is aligned, else plain loads.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, long long src_rs,
                                      int rows, int valid, int cols) {
  constexpr int E = 16 / sizeof(T);
  const int chunks = cols / E;
  for (int i = threadIdx.x; i < kT * chunks; i += blockDim.x) {
    const int r = i / chunks, col = (i % chunks) * E;
    T* sd = dst + r * cols + col;
    const T* gs = src + r * src_rs + col;
    const int n_ok = r < rows ? min(E, valid - col) : 0;
    if (n_ok == E && (reinterpret_cast<uintptr_t>(gs) & 15) == 0) {
      cp_async16(sd, gs);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        if (e < n_ok)
          sd[e] = gs[e];
        else
          set_zero(sd[e]);
      }
    }
  }
}

// PER_CHANNEL: A's N stride is 0. TX: x's type; TBC: B's and C's.
template <bool PER_CHANNEL, typename TX, typename TBC>
__global__ void __launch_bounds__(kMaxWarps * 32)
ssm_scan_kernel(const float* __restrict__ dt, const TX* __restrict__ x,
                const float* __restrict__ a, long long a_gs, long long a_ds,
                long long a_ns, const TBC* __restrict__ b,
                const TBC* __restrict__ c, float* __restrict__ y,
                float* __restrict__ hfin, int S, int D, int N) {
  const int nw = blockDim.x / 32;   // warps = state groups of 8
  const int np = nw * kSPL;         // N padded to a multiple of 8
  const int rb = raw_bytes<TX, TBC>(np);
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_dec = reinterpret_cast<float*>(smem + 2 * rb);  // [kT][kC]
  float* s_dx = s_dec + kT * kC;                            // [kT][kC]
  float* s_b = s_dx + kT * kC;                              // [kT][np]
  float* s_c = s_b + kT * np;                               // [kT][np]
  float* s_part = s_c + kT * np;                            // [nw][kT][kC]

  const int g = blockIdx.y;
  const int d0 = blockIdx.x * kC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = d0 + lane;
  const int d_valid = min(kC, D - d0);
  const long long gsd = static_cast<long long>(g) * S * D;
  const long long gsn = static_cast<long long>(g) * S * N;
  const float* ag = a + static_cast<long long>(g) * a_gs;

  // per channel: this lane's a_d (the prep pass's entries of lane l are
  // channel d0 + l, as blockDim is a multiple of 32); general: the a of
  // this lane's 8 states
  float a_st[kSPL];
  float a_d = 0.f;
  if (PER_CHANNEL) {
    a_d = d < D ? ag[d * a_ds] : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < kSPL; ++j) {
      const int n = warp * kSPL + j;
      a_st[j] = (d < D && n < N) ? ag[d * a_ds + n * a_ns] : 0.f;
    }
  }
  float h[kSPL];
#pragma unroll
  for (int j = 0; j < kSPL; ++j) h[j] = 0.f;

  auto tile_ptrs = [&](int k, float*& r_dt, TX*& r_x, TBC*& r_b,
                       TBC*& r_c) {
    unsigned char* r = smem + (k & 1) * rb;
    r_dt = reinterpret_cast<float*>(r);
    r_x = reinterpret_cast<TX*>(r_dt + kT * kC);
    r_b = reinterpret_cast<TBC*>(r_x + kT * kC);
    r_c = r_b + kT * np;
  };
  auto stage_tile = [&](int k) {
    float* r_dt;
    TX* r_x;
    TBC *r_b, *r_c;
    tile_ptrs(k, r_dt, r_x, r_b, r_c);
    const int t0 = k * kT, tn = min(kT, S - t0);
    const long long sd = gsd + static_cast<long long>(t0) * D + d0;
    const long long sn = gsn + static_cast<long long>(t0) * N;
    stage(r_dt, dt + sd, D, tn, d_valid, kC);
    stage(r_x, x + sd, D, tn, d_valid, kC);
    stage(r_b, b + sn, N, tn, N, np);
    stage(r_c, c + sn, N, tn, N, np);
  };

  const int n_tiles = (S + kT - 1) / kT;
  stage_tile(0);
  cp_async_commit();
  if (n_tiles > 1) stage_tile(1);
  cp_async_commit();
  for (int k = 0; k < n_tiles; ++k) {
    const int t0 = k * kT, tn = min(kT, S - t0);
    cp_async_wait1();   // tile k landed; tile k + 1 may be in flight
    __syncthreads();    // for every thread; the last tile's N-sum is done
    {
      float* r_dt;
      TX* r_x;
      TBC *r_b, *r_c;
      tile_ptrs(k, r_dt, r_x, r_b, r_c);
      for (int i = tid; i < kT * kC; i += blockDim.x) {
        const float dtv = r_dt[i];
        s_dx[i] = dtv * to_f32(r_x[i]);
        s_dec[i] = PER_CHANNEL ? expf(dtv * a_d) : dtv;
      }
      for (int i = tid; i < kT * np; i += blockDim.x) {
        s_b[i] = to_f32(r_b[i]);
        s_c[i] = to_f32(r_c[i]);
      }
    }
    __syncthreads();    // the prepared tile is visible; its buffer is free
    if (k + 2 < n_tiles) stage_tile(k + 2);
    cp_async_commit();  // possibly empty: one group per tile all the same

    const float* bw = s_b + warp * kSPL;
    const float* cw = s_c + warp * kSPL;
    float* pw = s_part + warp * kT * kC + lane;
#pragma unroll 4
    for (int tt = 0; tt < tn; ++tt) {
      const float dec = s_dec[tt * kC + lane];   // decay, or dt (general)
      const float dx = s_dx[tt * kC + lane];
      float bv[kSPL], cv[kSPL];
#pragma unroll
      for (int j = 0; j < kSPL; j += 4) {
        const float4 b4 = *reinterpret_cast<const float4*>(bw + tt * np + j);
        const float4 c4 = *reinterpret_cast<const float4*>(cw + tt * np + j);
        bv[j] = b4.x, bv[j + 1] = b4.y, bv[j + 2] = b4.z, bv[j + 3] = b4.w;
        cv[j] = c4.x, cv[j + 1] = c4.y, cv[j + 2] = c4.z, cv[j + 3] = c4.w;
      }
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kSPL; ++j) {
        const float decay = PER_CHANNEL ? dec : expf(dec * a_st[j]);
        h[j] = fmaf(decay, h[j], dx * bv[j]);
        part = fmaf(h[j], cv[j], part);
      }
      pw[tt * kC] = part;
    }
    __syncthreads();

    // y_t = the warps' partials added in warp order, stored in rows
    for (int i = tid; i < kT * kC; i += blockDim.x) {
      const int tt = i / kC, cc = i % kC;
      if (tt < tn && cc < d_valid) {
        float sum = s_part[i];
        for (int w = 1; w < nw; ++w) sum += s_part[w * kT * kC + i];
        y[gsd + static_cast<long long>(t0 + tt) * D + d0 + cc] = sum;
      }
    }
  }

  if (d < D) {
#pragma unroll
    for (int j = 0; j < kSPL; ++j) {
      const int n = warp * kSPL + j;
      if (n < N) hfin[(static_cast<long long>(g) * D + d) * N + n] = h[j];
    }
  }
}

template <bool PER_CHANNEL, typename TX, typename TBC>
cudaError_t launch(const void* dt, const void* x, const void* a,
                   long long a_gs, long long a_ds, long long a_ns,
                   const void* b, const void* c, void* y, void* hfin, int G,
                   int S, int D, int N, cudaStream_t stream) {
  const int nw = (N + kSPL - 1) / kSPL;
  const int bytes = smem_bytes<TX, TBC>(nw);
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_kernel<PER_CHANNEL, TX, TBC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((D + kC - 1) / kC, G);
  ssm_scan_kernel<PER_CHANNEL, TX, TBC><<<grid, nw * 32, bytes, stream>>>(
      static_cast<const float*>(dt), static_cast<const TX*>(x),
      static_cast<const float*>(a), a_gs, a_ds, a_ns,
      static_cast<const TBC*>(b), static_cast<const TBC*>(c),
      static_cast<float*>(y), static_cast<float*>(hfin), S, D, N);
  return cudaGetLastError();
}

template <bool PER_CHANNEL>
cudaError_t launch_types(const void* dt, const void* x, const void* a,
                         long long a_gs, long long a_ds, long long a_ns,
                         const void* b, const void* c, void* y, void* hfin,
                         int G, int S, int D, int N, int x_bf16, int bc_bf16,
                         cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (x_bf16 && bc_bf16)
    return launch<PER_CHANNEL, bf, bf>(dt, x, a, a_gs, a_ds, a_ns, b, c, y,
                                       hfin, G, S, D, N, stream);
  if (x_bf16)
    return launch<PER_CHANNEL, bf, float>(dt, x, a, a_gs, a_ds, a_ns, b, c,
                                          y, hfin, G, S, D, N, stream);
  if (bc_bf16)
    return launch<PER_CHANNEL, float, bf>(dt, x, a, a_gs, a_ds, a_ns, b, c,
                                          y, hfin, G, S, D, N, stream);
  return launch<PER_CHANNEL, float, float>(dt, x, a, a_gs, a_ds, a_ns, b, c,
                                           y, hfin, G, S, D, N, stream);
}


// ------------------------------------- ssm_scan_kernel_ssd: Mamba2 on wgmma
//
// What it computes. Mamba2's form of the scan: dt and A are one value per
// head h of P channels (dt_h (G, S, H), a_h (H,)), and B, C one (S, N) pair
// per batch row g shared by the heads: the function ssm_scan computes with
// dt and A repeated over each head's channels, from a zero state, y (G, S,
// H*P) fp32 and h_final (G, H*P, N) fp32.
//
// The chunked form (Mamba2's state-space duality). Cut S into chunks of
// L = 64 steps. Inside a chunk, with cs_t the running sum of dt_t a from
// the chunk's start (t inclusive) and h_prev the state before it,
//     y_t   = sum_{s<=t} (C_t . B_s) exp(cs_t - cs_s) dt_s x_s
//             + exp(cs_t) C_t . h_prev
//     h_new = exp(cs_end) h_prev + sum_s exp(cs_end - cs_s) dt_s x_s B_s
// which is the recurrence unrolled over the chunk. Per (g, h, chunk) that
// is four products on the tensor cores: G = C B^T (64 x 64 over N); Y +=
// M' X with M' = G . exp(cs_t - cs_s) dt_s [s <= t] (over the 64 steps);
// Y_inter = C h_prev^T (over N), its rows scaled by exp(cs_t); and the
// state h_new^T = exp(cs_end) h_prev^T + W^T X with W = exp(cs_end - cs_s)
// dt_s B_s (over the 64 steps). Only the last two touch the carried state.
//
// Precision (held to the plain loop at 1e-5 of each array's scale):
//  - x, B, C in bf16 (the served path) enter the products as they are, so
//    C B^T and every product with X are exact products summed in fp32.
//  - The fp32 factors M', W and h_prev enter as two bf16 halves, hi =
//    bf16(v) and lo = bf16(v - hi) (about 16 bits), each times the exact
//    bf16 operand: the split flash attention uses for P. The carried state
//    itself stays fp32 in registers: exp(cs_end) h_prev is an fp32 scale,
//    and only the chunk's drive W^T X goes through the split.
//  - fp32 x, B or C (the fp32 smoke configs) are cut once, before the
//    scan, by ssm_split_bf16_kernel into three bf16 pieces v0 + v1 + v2
//    that add up to v exactly, so they too enter exactly. A product of two
//    split operands takes the pairs of pieces whose orders add up to 2 or
//    less (five of the factor's two halves and X's three pieces, six of
//    C's and B's pieces); the pairs left out are 2^-24 of it or less. (Two
//    pieces of fp32 operands, about 16 bits each, came too close to the
//    1e-5 band.)
//  - cs is summed in fp64 from the fp32 products dt_t * a (the plain
//    loop's rounding of each step's exponent) and kept as two floats, so
//    cs_t - cs_s is exact to fp32 rounding of the difference whatever the
//    size of cs. Each decay is one expf of a difference, never a quotient
//    of two exponentials (which overflows). expf, not fast math: the decays
//    feed every later state. The M' entries above the diagonal are
//    selected away, never multiplied.
//  - Inside a work item the chunks and every sum run in a fixed order and
//    nothing is added by atomics, so two identical calls give the same
//    bits. It sums in another order than ssm_scan_kernel, so its h_final
//    is not that kernel's bit for bit.
//
// What bounds it on an H100. At the zamba2-2.7b path's shapes (G = 2,
// S = 2048, H = 80, P = 64, N = 64; x/B/C bf16) the function moves about
// 131 MB (x 41.9, dt 1.3, B and C 1.0, y 83.9, h_final 2.6): 0.039 ms at
// 3.35 TB/s. The four products with the hi + lo split are 18.8 GFLOP of
// bf16 tensor work (0.019 ms at 989 TFLOP/s) and the decays 1.1e7
// exponentials (3 us): the bytes bound it. A work item's chunks are a
// chain, so the grid's fill matters: 160 items on 132 SMs at that shape,
// 80 at a tensor-parallel rank's.
//
// Design, Hopper's units as flash_fwd_kernel_wgmma uses them:
//  - A work item is one (batch row, head). A persistent grid of at most
//    one CTA per SM walks the items: CTA b's first consumer warpgroup takes
//    items b, b + 2 grid, ..., the second b + grid, b + 3 grid, ..., so the
//    first items spread over the SMs before any SM takes two.
//  - A CTA is three warpgroups. In the first (registers cut to 24 by
//    setmaxnreg) lane 0 of warp j issues the TMA loads of consumer
//    warpgroup j's items: each chunk's X (64 steps x P of the head, as a
//    box of the 4-D map (P, H, S, G)), B and C (64 x N, boxes of the 3-D
//    maps (N, S, G)) into a ring of stages under a full and an empty
//    mbarrier each. S stays its own dimension, so a box past S reads zeros
//    of its own batch row; columns past P or N read zeros too: the widths
//    are padded to 64 in shared memory, never in device memory. Every tile
//    is 64 rows of 128 bytes with the 128-byte swizzle, the layout wgmma
//    reads.
//  - Each consumer warpgroup (setmaxnreg 240) walks its items' chunks in
//    order and carries h^T (N x P, 64 x 64 fp32: 32 registers a thread).
//    Per chunk each warp reads its 64 dt values (plain loads, prefetched a
//    chunk ahead), forms cs by a warp scan and writes cs, dt_s, exp(cs_t)
//    and exp(cs_end - cs_s) dt_s to its own scratch. Then: group A, G =
//    C B^T (both K-major from shared memory) and Y = C h_prev^T (h_prev's
//    hi and lo staged in shared memory, an MN-major B); meanwhile W^T's
//    fragments, B read transposed by ldmatrix, times its factor, split.
//    Then h^T is scaled by exp(cs_end) and Y's rows by exp(cs_t). Group
//    B, h^T += W^T X (W^T from registers, X an MN-major B); meanwhile M'
//    formed from G's accumulators, which are in the A operand's layout;
//    group C, Y += M' X. While group C runs, the new h^T is staged as
//    h_prev's hi and lo for the next chunk. Y's rows are stored from the
//    registers as 16-byte runs (a pair of threads swaps halves); rows past
//    S are not written.
//  - h_prev is zeroed in shared memory at an item's start, so Y_inter
//    runs on every chunk: a wgmma under a branch (first chunk or not)
//    made ptxas inject warpgroup arrivals (C7519), and was slower
//    (PERF.md section 6).
//  - C's 8-row blocks are loaded in the order (0, 7, 1, 6, 2, 5, 3, 4)
//    (c_block), so each consumer warp holds an early and a late block of
//    the chunk's steps and the same share of M''s lower triangle: in
//    order, warp 3 held four times warp 0's exponentials and the
//    warpgroup waited for it (PERF.md section 6).
//  - Widths: P and N multiples of 8 up to 64 (a TMA row is 16-byte
//    aligned): P 64 (zamba2-2.7b) and 32 (its smoke config), N 64 and 16.
//    Every product runs at the full 64 on those zero columns (a smaller N
//    costs no fewer k-steps: only the smoke config has one).
//  - N above 64, up to 128 (granite-4.0-h's 128): two 64-column state
//    tiles (NH = 2). The state's columns n evolve apart (h_t[:, n] takes
//    B_t[n] alone) and y_t = sum_n h_t[:, n] C_t[n] is a sum over them, so
//    the item's state is cut in two: both consumer warpgroups take the
//    same item, warpgroup j the state columns 64 j.., and each runs the
//    chunk above on its half (its ring loads the boxes of B and C at
//    column 64 j, and X for both): C B^T and C h_prev^T contract over
//    its 64 states, h^T is its 64 x P half. The item's y is the sum of
//    the two halves' Y: each warpgroup writes the rows it does not store
//    to shared memory (a buffer per chunk parity), both meet at a named
//    barrier of the 256 consumer threads, and each adds the other's rows
//    to its own and stores them (warpgroup j the rows of rr = j: the
//    stores split evenly). Two terms add the same in either order, so y
//    is the same bits whichever warpgroup stores it. The CTA holds one
//    item at a time, so an item costs about what a 64-state item does,
//    and the grid walks G H items, not G H / 2: at granite-4.0-h's layer
//    in its serving cell (G = 32, S = 7845, H = 64, P = 64, N = 128) the
//    function moves 6.42 GB, 1.92 ms at 3.35 TB/s, and the kernel takes
//    6.60 ms (PERF.md section 6), each chunk's chain of products exposed.
//    The entry point refuses other widths.

using bf16 = __nv_bfloat16;

constexpr int kL = 64;                 // steps per chunk: wgmma's M
constexpr int kRowB = 128;             // a 128-byte-swizzled row: 64 bf16
constexpr int kTileB = kL * kRowB;     // a 64 x 64 bf16 tile
constexpr int kSsdThreads = 384;       // producer warpgroup, two consumers
constexpr int kSsdProducerRegs = 24, kSsdConsumerRegs = 240;
constexpr int kSsdWidth = 64;          // P, N at most
constexpr int kScratchF = 5 * kL;      // floats of a warp's scratch
constexpr int kScratchB = 4 * kScratchF * 4;   // a warpgroup's four warps
constexpr int kSmemMax = 232448;       // a block's shared memory on sm_90
constexpr int kBarB = 128;             // 2 warpgroups x 3 stages x 2 x 8
// NH = 2: Y's rows a warpgroup hands the other, per chunk parity and
// warpgroup: 16 floats a thread
constexpr int kXchgF = 16 * 128;

// NX, NB: bf16 pieces of x and of b/c (1: bf16 operands; 3: fp32 ones,
// v = v0 + v1 + v2 exactly); NH: 64-column state tiles (1: N <= 64, 2:
// N <= 128, one a warpgroup)
template <int NX, int NB, int NH>
struct SsdShape {
  // a stage: X's pieces, B's, C's
  static constexpr int kXOff = 0;
  static constexpr int kBOff = NX * kTileB;
  static constexpr int kCOff = kBOff + NB * kTileB;
  static constexpr int kStageB = kCOff + NB * kTileB;
  // a warpgroup's block: the ring, h_prev's hi and lo, the warps' scratch
  static constexpr int kFixedB = 2 * kTileB + kScratchB;
  // the two halves' exchange of Y's rows (NH = 2), after both blocks
  static constexpr int kXchgB = NH == 2 ? 4 * kXchgF * 4 : 0;
  static constexpr int kFit =
      ((kSmemMax - 1024 - kBarB - kXchgB) / 2 - kFixedB) / kStageB;
  static constexpr int kStages = kFit < 3 ? kFit : 3;
  static constexpr int kHprev = kStages * kStageB;
  static constexpr int kScratch = kHprev + 2 * kTileB;
  static constexpr int kWgB = kScratch + kScratchB;
  static constexpr int kXchg = 2 * kWgB;
  static constexpr int kBar = kXchg + kXchgB;
  static constexpr int kBytes = kBar + kBarB + 1024;
  static_assert(kStages >= 1 && kBytes <= kSmemMax, "shared memory");
  static_assert(kWgB % 1024 == 0, "tiles 1024-byte aligned");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// one box of a 3-D or 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// a consumer warpgroup's own named barrier (1 or 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
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
__device__ __forceinline__ void pin(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void pin(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
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

// A K-major operand of one 64-column tile (C as A, B as B: rows of 128
// bytes over the contracted N, 8-row atoms 1024 bytes apart); k-step ks
// of 16 columns is 32 bytes inside the row's swizzle span
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int ks) {
  return smem_desc(tile + ks * 32, 16, 8 * kRowB);
}

// An MN-major B of one 64-column tile (X, h_prev: rows over the
// contracted dimension, 128 bytes over P): k-step kk is 16 rows, two
// 8-row atoms 1024 bytes apart
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 16 * kRowB, kTileB, 8 * kRowB);
}

// d (+)= A B, m64n64k16, A and B K-major in shared memory; scale_d 0
// overwrites d
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

// d (+)= A B, m64n64k16, A K-major and B MN-major in shared memory
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B, m64n64k16, A from registers, B MN-major in shared memory
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

// four 8 x 8 bf16 matrices from shared memory, each transposed into the
// fragment layout (lanes 8i..8i+7 give the row addresses of matrix i)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// v0, v1 as two bf16 halves, hi = bf16(v) and lo = bf16(v - hi), each a
// packed pair (v0 in the low half): the A operand of the split products
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the tensor maps of x's, b's and c's pieces (c's in boxes of 8 rows)
struct SsdMaps {
  CUtensorMap x[3], b[3], c[3];
};

// The 8-row block m of a C tile in shared memory holds the chunk's rows
// 8 c_block(m)..: (0, 7, 1, 6, 2, 5, 3, 4), so consumer warp w, whose
// accumulator rows are the blocks 2w and 2w + 1, owns the chunk's rows
// 8w.. and 8 (7 - w)..: every warp then has the same share of M''s lower
// triangle (18 exponentials a thread, where rows in order give warp 3 32
// and warp 0 8, and the warpgroup waits for warp 3).
__device__ __forceinline__ int c_block(int m) {
  return (m & 1) ? 7 - m / 2 : m / 2;
}

// The item of round r of consumer warpgroup j (and of the producer warp
// that feeds it): two items at a time a CTA with one state tile, one with
// two (both warpgroups on the item)
template <int NH>
__device__ __forceinline__ long long ssd_item(int r, int j) {
  const long long step = NH == 1 ? 2LL * r + j : r;
  return blockIdx.x + step * static_cast<long long>(gridDim.x);
}

// Two state halves' Y (NH = 2): consumer warpgroup J hands the other its
// accumulator rows rr = 1 - J through shared memory, meets it at named
// barrier 3 (the 256 consumer threads), and adds the other's rows rr = J
// to its own. J is a template argument so that yv is indexed by
// constants: an index known only at run time puts the accumulators in
// local memory, and ptxas then serializes the wgmmas (C7514).
template <int J>
__device__ __forceinline__ void exchange_rows(float (&yv)[32], float* mine,
                                              const float* theirs) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      mine[(2 * i + c) * 128] = yv[4 * i + 2 * (1 - J) + c];
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 2; ++c)
      yv[4 * i + 2 * J + c] += theirs[(2 * i + c) * 128];
}

template <int NX, int NB, int NH>
__global__ void __launch_bounds__(kSsdThreads, 1)
ssm_scan_kernel_ssd(const __grid_constant__ SsdMaps maps,
                    const float* __restrict__ dt, const float* __restrict__ a,
                    float* __restrict__ y, float* __restrict__ hfin, int S,
                    int H, int P, int N, int n_items) {
  using Sh = SsdShape<NX, NB, NH>;
  extern __shared__ __align__(1024) unsigned char ssd_smem[];
  const uint32_t base = (smem_addr(ssd_smem) + 1023u) & ~1023u;
  const uint32_t bars = base + Sh::kBar;
  // mbarriers of warpgroup j's stage st: full, then empty
  auto full = [&](int j, int st) { return bars + 16 * (3 * j + st); };
  auto empty = [&](int j, int st) { return bars + 16 * (3 * j + st) + 8; };
  const int n_ch = (S + kL - 1) / kL;

  if (threadIdx.x == 0) {
    for (int j = 0; j < 2; ++j)
      for (int st = 0; st < Sh::kStages; ++st) {
        mbar_init(full(j, st), 1);
        mbar_init(empty(j, st), 4);   // one arrival per consumer warp
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 0) {
    // ------------------------------------------------------ the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kSsdProducerRegs));
    const int j = threadIdx.x / 32;
    if (j < 2 && threadIdx.x % 32 == 0) {
      const uint32_t wg = base + j * Sh::kWgB;
      int t = 0;
      const int n0 = NH == 2 ? kSsdWidth * j : 0;   // this ring's states
      for (int r = 0;; ++r) {
        const long long idx = ssd_item<NH>(r, j);
        if (idx >= n_items) break;
        const int g = static_cast<int>(idx / H), h = static_cast<int>(idx % H);
        for (int k = 0; k < n_ch; ++k, ++t) {
          const int st = t % Sh::kStages;
          const uint32_t ph = (t / Sh::kStages) & 1;
          const uint32_t sb = wg + st * Sh::kStageB;
          mbar_wait(empty(j, st), ph ^ 1);
          mbar_expect_tx(full(j, st), Sh::kStageB);
#pragma unroll
          for (int i = 0; i < NX; ++i)
            tma_load4(sb + Sh::kXOff + i * kTileB, &maps.x[i], full(j, st), 0,
                      h, k * kL, g);
#pragma unroll
          for (int i = 0; i < NB; ++i) {
            tma_load3(sb + Sh::kBOff + i * kTileB, &maps.b[i], full(j, st), n0,
                      k * kL, g);
#pragma unroll
            for (int m = 0; m < 8; ++m)
              tma_load3(sb + Sh::kCOff + i * kTileB + m * 8 * kRowB,
                        &maps.c[i], full(j, st), n0, k * kL + 8 * c_block(m),
                        g);
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kSsdConsumerRegs));
  const int j = role - 1;                       // consumer warpgroup 0 or 1
  const int tid = threadIdx.x % 128;
  const int wq = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, tq = lane % 4;       // accumulator row, col pair
  const uint32_t wg = base + j * Sh::kWgB;
  const uint32_t hp_hi = wg + Sh::kHprev, hp_lo = hp_hi + kTileB;
  // this warp's scratch: cs (hi, lo), dt, exp(cs_end - cs) dt, exp(cs)
  float* scr = reinterpret_cast<float*>(
      ssd_smem + (wg - smem_addr(ssd_smem)) + Sh::kScratch) + wq * kScratchF;
  float* s_hi = scr;
  float* s_lo = scr + kL;
  float* s_dt = scr + 2 * kL;
  float* s_f = scr + 3 * kL;
  float* s_e = scr + 4 * kL;
  const int D = H * P;
  // rows of this thread's accumulators: n (of h^T) = row0, row0 + 8; and
  // of G, M' and Y the chunk's steps t = tr0, tr1 (c_block)
  const int row0 = 16 * wq + g8;
  const int tr0 = 8 * wq + g8, tr1 = 8 * (7 - wq) + g8;
  // ldmatrix: lane l gives row (l % 8) of matrix l / 8, whose steps are
  // 8 (l / 16) + 16 kk.. and whose states are the 8-column block 2 wq +
  // (l / 8) % 2 of B
  const int lm = lane / 8, lr = lane % 8;
  const uint32_t ld_off = (8 * (lm >> 1) + lr) * kRowB +
                          (((2 * wq + (lm & 1)) ^ lr) << 4);
  int t = 0;
  float hT[32] = {}, yv[32] = {}, gv[32] = {};
  uint32_t wa[4][4], wl[4][4], pa[4][4], pl[4][4];
  for (int r = 0;; ++r) {
    const long long idx = ssd_item<NH>(r, j);
    if (idx >= n_items) break;
    const int g = static_cast<int>(idx / H), h = static_cast<int>(idx % H);
    const float av = a[h];
    const float* dth = dt + static_cast<long long>(g) * S * H + h;
    auto load_dt = [&](int tt) {
      return tt < S ? __ldg(dth + static_cast<long long>(tt) * H) : 0.f;
    };
#pragma unroll
    for (int i = 0; i < 32; ++i) hT[i] = 0.f;
    float dn0 = load_dt(2 * lane), dn1 = load_dt(2 * lane + 1);
    // h_prev = 0 for the item's first chunk, once every warp's last group
    // A has read the last item's: Y_inter then runs on every chunk (a
    // wgmma under a branch makes ptxas inject warpgroup arrivals)
    wg_sync(1 + j);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const uint32_t off = (row0 + 8 * rr) * kRowB + ((i ^ g8) << 4) +
                             4 * tq;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hp_hi + off), "r"(0)
                     : "memory");
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hp_lo + off), "r"(0)
                     : "memory");
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    wg_sync(1 + j);
    for (int k = 0; k < n_ch; ++k, ++t) {
      const int st = t % Sh::kStages;
      const uint32_t ph = (t / Sh::kStages) & 1;
      const uint32_t sb = wg + st * Sh::kStageB;
      const uint32_t xs = sb + Sh::kXOff, bs = sb + Sh::kBOff;
      const uint32_t cs = sb + Sh::kCOff;
      const int t0 = k * kL;

      // cs by a warp scan in fp64; lane l holds steps 2l and 2l + 1
      const float d0 = dn0, d1 = dn1;
      if (k + 1 < n_ch) {
        dn0 = load_dt(t0 + kL + 2 * lane);
        dn1 = load_dt(t0 + kL + 2 * lane + 1);
      }
      const float da0 = d0 * av, da1 = d1 * av;
      double inc = static_cast<double>(da0) + static_cast<double>(da1);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double o = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += o;
      }
      double ex = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) ex = 0.0;
      const double c0 = ex + da0, c1 = c0 + da1;
      const double cend = __shfl_sync(0xffffffffu, c1, 31);
      __syncwarp();   // the last chunk's readers of the scratch are done
      {
        const float h0 = static_cast<float>(c0), h1 = static_cast<float>(c1);
        s_hi[2 * lane] = h0;
        s_hi[2 * lane + 1] = h1;
        s_lo[2 * lane] = static_cast<float>(c0 - h0);
        s_lo[2 * lane + 1] = static_cast<float>(c1 - h1);
        s_dt[2 * lane] = d0;
        s_dt[2 * lane + 1] = d1;
        s_f[2 * lane] = expf(static_cast<float>(cend - c0)) * d0;
        s_f[2 * lane + 1] = expf(static_cast<float>(cend - c1)) * d1;
        s_e[2 * lane] = expf(h0);
        s_e[2 * lane + 1] = expf(h1);
      }
      __syncwarp();
      const float dec_end = expf(static_cast<float>(cend));

      // group A: G = C B^T, and Y = C h_prev^T (0 on the first chunk). A
      // product of pieces i and f is taken where i + f <= 2 (the rest are
      // 2^-24 of it or less)
      mbar_wait(full(j, st), ph);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int f = 0; f < NB && i + f <= 2; ++f)
            wgmma_ss(gv, kmajor(cs + i * kTileB, ks),
                     kmajor(bs + f * kTileB, ks), ks + i + f > 0);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < NB; ++i)
#pragma unroll
          for (int f = 0; f < 2 && i + f <= 2; ++f)
            wgmma_ss_mn(yv, kmajor(cs + i * kTileB, ks),
                        mnmajor(f ? hp_lo : hp_hi, ks), ks + i + f > 0);
      wg_commit();

      // meanwhile: W^T's fragments, B read transposed (row n = state,
      // column = step s), times exp(cs_end - cs_s) dt_s, split into hi and
      // lo
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bq[NB][4];
#pragma unroll
        for (int i = 0; i < NB; ++i)
          ldsm_x4_t(bq[i], bs + i * kTileB + kk * 16 * kRowB + ld_off);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = 16 * kk + 8 * (q >> 1) + 2 * tq;
          const float2 f = *reinterpret_cast<const float2*>(s_f + s);
          // B's pieces added from the smallest: the fp32 value exactly
          float v0 = bf_lo(bq[NB - 1][q]), v1 = bf_hi(bq[NB - 1][q]);
#pragma unroll
          for (int i = NB - 2; i >= 0; --i) {
            v0 += bf_lo(bq[i][q]);
            v1 += bf_hi(bq[i][q]);
          }
          split_pair(f.x * v0, f.y * v1, wa[kk][q], wl[kk][q]);
        }
      }
      wg_wait<0>();
      pin(gv);
      pin(yv);

      // h^T decays over the chunk, Y's rows by exp(cs_t): accumulators
      // are scaled only while no wgmma is in flight (else ptxas injects a
      // warpgroup arrival that waits for the group in flight)
#pragma unroll
      for (int i = 0; i < 32; ++i) hT[i] *= dec_end;
      {
        const float e0 = s_e[tr0], e1 = s_e[tr1];
#pragma unroll
        for (int i = 0; i < 32; ++i) yv[i] *= (i & 2) ? e1 : e0;
      }

      // group B: h^T += W^T X
      pin(hT);
      pin(wa);
      pin(wl);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          wgmma_rs(hT, wa[kk], mnmajor(xs + i * kTileB, kk));
          if (i < 2) wgmma_rs(hT, wl[kk], mnmajor(xs + i * kTileB, kk));
        }
      wg_commit();

      // meanwhile: M' from G, split
      {
        const int tr[2] = {tr0, tr1};
        const float th[2] = {s_hi[tr0], s_hi[tr1]};
        const float tl[2] = {s_lo[tr0], s_lo[tr1]};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int kk = i / 2, q2 = (i & 1) * 2;
          float m[4] = {0.f, 0.f, 0.f, 0.f};
          const int s0 = 8 * i + 2 * tq;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            // steps s = 8i.. all past row block wq (rr 0) or 7 - wq (rr 1)
            if (i > (rr ? 7 - wq : wq)) continue;
            const float2 sh = *reinterpret_cast<const float2*>(s_hi + s0);
            const float2 sl = *reinterpret_cast<const float2*>(s_lo + s0);
            const float2 sd = *reinterpret_cast<const float2*>(s_dt + s0);
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float arg = (th[rr] - (c ? sh.y : sh.x)) +
                                (tl[rr] - (c ? sl.y : sl.x));
              const float v = gv[4 * i + 2 * rr + c] * expf(arg) *
                              (c ? sd.y : sd.x);
              m[2 * rr + c] = s0 + c <= tr[rr] ? v : 0.f;
            }
          }
          split_pair(m[0], m[1], pa[kk][q2], pl[kk][q2]);
          split_pair(m[2], m[3], pa[kk][q2 + 1], pl[kk][q2 + 1]);
        }
      }

      // group C: Y += M' X
      pin(yv);
      pin(pa);
      pin(pl);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          wgmma_rs(yv, pa[kk], mnmajor(xs + i * kTileB, kk));
          if (i < 2) wgmma_rs(yv, pl[kk], mnmajor(xs + i * kTileB, kk));
        }
      wg_commit();

      // meanwhile: the new h^T staged as the next chunk's h_prev (rows n,
      // 128 bytes over p, swizzled), once every warp's group A has read
      // the last one
      wg_wait<1>();
      pin(hT);
      pin(wa);
      pin(wl);
      if (k + 1 < n_ch) {
        wg_sync(1 + j);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            uint32_t hi, lo;
            split_pair(hT[4 * i + 2 * rr], hT[4 * i + 2 * rr + 1], hi, lo);
            const uint32_t off = (row0 + 8 * rr) * kRowB + ((i ^ g8) << 4) +
                                 4 * tq;
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hp_hi + off),
                         "r"(hi)
                         : "memory");
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(hp_lo + off),
                         "r"(lo)
                         : "memory");
          }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync(1 + j);
      }
      wg_wait<0>();
      pin(yv);
      pin(pa);
      pin(pl);
      if (lane == 0) mbar_arrive(empty(j, st));

      if constexpr (NH == 2) {
        // the two state halves' Y added (buffers by chunk parity: the
        // other warpgroup may still read the last chunk's)
        float* xchg = reinterpret_cast<float*>(
            ssd_smem + (base - smem_addr(ssd_smem)) + Sh::kXchg);
        float* mine = xchg + (2 * (t & 1) + j) * kXchgF + tid;
        const float* theirs = xchg + (2 * (t & 1) + 1 - j) * kXchgF + tid;
        if (j == 0)
          exchange_rows<0>(yv, mine, theirs);
        else
          exchange_rows<1>(yv, mine, theirs);
      }

      // y: rows past S are not written, columns past P are not stored. A
      // full-width head takes no per-column test, and the two threads of a
      // pair swap halves, so each stores 4 neighbouring columns as one
      // 16-byte store (eight a row pair, not sixteen 8-byte ones: PERF.md
      // section 6)
      float* yg = y + static_cast<long long>(g) * S * D + h * P + 2 * tq;
      const bool ev = (tq & 1) == 0;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        if (NH == 2 && rr != j) continue;   // the other warpgroup's rows
        const int tt = t0 + (rr ? tr1 : tr0);
        float* yrow = yg + static_cast<long long>(tt) * D;
        if (P == kSsdWidth) {
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float a0 = yv[8 * m + 2 * rr], a1 = yv[8 * m + 2 * rr + 1];
            const float b0 = yv[8 * m + 4 + 2 * rr];
            const float b1 = yv[8 * m + 4 + 2 * rr + 1];
            const float r0 = __shfl_xor_sync(0xffffffffu, ev ? b0 : a0, 1);
            const float r1 = __shfl_xor_sync(0xffffffffu, ev ? b1 : a1, 1);
            if (tt < S)
              *reinterpret_cast<float4*>(yrow + 16 * m + (ev ? 0 : 6)) =
                  ev ? make_float4(a0, a1, r0, r1)
                     : make_float4(r0, r1, b0, b1);
          }
        } else if (tt < S) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            if (8 * i + 2 * tq < P)
              *reinterpret_cast<float2*>(yrow + 8 * i) =
                  make_float2(yv[4 * i + 2 * rr], yv[4 * i + 2 * rr + 1]);
        }
      }
    }

    // h_final (g, h P + p, n) from h^T (n, p): this warpgroup's states
    float* hg = hfin + (static_cast<long long>(g) * D + h * P) * N;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int n = row0 + 8 * rr + (NH == 2 ? kSsdWidth * j : 0);
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int p = 8 * i + 2 * tq + c;
          if (p < P)
            hg[static_cast<long long>(p) * N + n] = hT[4 * i + 2 * rr + c];
        }
    }
  }
}

// fp32 -> three bf16 pieces, v0 = bf16(v), v1 = bf16(v - v0), v2 =
// bf16(v - v0 - v1), each difference exact in fp32, so v = v0 + v1 + v2
// exactly (for |v| above 2^-110; below, bf16's subnormals round v2): the
// fp32 operands of the per-head scan, in `out` as three planes of n
__global__ void ssm_split_bf16_kernel(const float* __restrict__ src,
                                      bf16* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float r = src[i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const bf16 v = __float2bfloat16_rn(r);
      out[k * n + i] = v;
      r -= __bfloat162float(v);
    }
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

// A bf16 tensor as a map of `rank` dims (innermost first), boxes of 64 x
// `rows` along dims 0 and `rows_dim`, 1 elsewhere, 128-byte swizzle; what
// lies past a dim reads as zeros
int encode(CUtensorMap* map, const void* ptr, int rank,
           const cuuint64_t* dims, int rows_dim, int rows = kL) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  cuuint64_t strides[3];
  cuuint64_t st = dims[0] * sizeof(bf16);
  for (int i = 0; i + 1 < rank; ++i) {
    strides[i] = st;
    st *= dims[i + 1];
  }
  cuuint32_t box[4] = {1, 1, 1, 1};
  box[0] = kSsdWidth;
  box[rows_dim] = static_cast<cuuint32_t>(rows);
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
         dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

// x (G, S, H, P) as (P, H, S, G); b or c (G, S, N) as (N, S, G)
int encode_x(CUtensorMap* map, const void* x, int G, int S, int H, int P) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(P),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(G)};
  return encode(map, x, 4, dims, 2);
}

int encode_bc(CUtensorMap* map, const void* b, int G, int S, int N,
              int rows = kL) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(G)};
  return encode(map, b, 3, dims, 1, rows);
}

template <int NX, int NB, int NH>
int launch_ssd(const void* dt, const void* const* x, const void* a,
               const void* const* b, const void* const* c, void* y,
               void* hfin, int G, int S, int H, int P, int N,
               cudaStream_t stream) {
  SsdMaps maps;
  int err = 0;
  for (int i = 0; i < 3 && err == 0; ++i) {
    // absent pieces: the first piece's map, never read
    err = encode_x(&maps.x[i], x[i < NX ? i : 0], G, S, H, P);
    if (err == 0) err = encode_bc(&maps.b[i], b[i < NB ? i : 0], G, S, N);
    if (err == 0) err = encode_bc(&maps.c[i], c[i < NB ? i : 0], G, S, N, 8);
  }
  if (err != 0) return err;
  const long long n_items = static_cast<long long>(G) * H;
  int dev = 0, sms = 0;
  cudaError_t cerr = cudaGetDevice(&dev);
  if (cerr == cudaSuccess)
    cerr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  constexpr int bytes = SsdShape<NX, NB, NH>::kBytes;
  cerr = cudaFuncSetAttribute(ssm_scan_kernel_ssd<NX, NB, NH>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int grid = static_cast<int>(n_items < sms ? n_items : sms);
  ssm_scan_kernel_ssd<NX, NB, NH><<<grid, kSsdThreads, bytes, stream>>>(
      maps, static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<float*>(y), static_cast<float*>(hfin), S, H, P, N,
      static_cast<int>(n_items));
  return static_cast<int>(cudaGetLastError());
}

template <int NH>
int launch_pieces(const void* dt, const void* const* x, int nx,
                  const void* a, const void* const* b, const void* const* c,
                  int nb, void* y, void* hfin, int G, int S, int H, int P,
                  int N, cudaStream_t st) {
  if (nx == 3 && nb == 3)
    return launch_ssd<3, 3, NH>(dt, x, a, b, c, y, hfin, G, S, H, P, N, st);
  if (nx == 3)
    return launch_ssd<3, 1, NH>(dt, x, a, b, c, y, hfin, G, S, H, P, N, st);
  if (nb == 3)
    return launch_ssd<1, 3, NH>(dt, x, a, b, c, y, hfin, G, S, H, P, N, st);
  return launch_ssd<1, 1, NH>(dt, x, a, b, c, y, hfin, G, S, H, P, N, st);
}

}  // namespace

extern "C" {

const char* ssm_scan_error_string(int err) {
  if (err == kNoEncoder)
    return "cuTensorMapEncodeTiled not found through the driver entry point";
  if (err >= kEncodeError && err < kNoEncoder)
    return "cuTensorMapEncodeTiled refused a tensor map (CUresult = "
           "code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dt (G, S, D) fp32; x (G, S, D) fp32 or bf16; a fp32, element (g, d, n) at
// a + g * a_gs + d * a_ds + n * a_ns (a_ns 0: one decay per channel);
// b, c (G, S, N) fp32 or bf16 (both the same); y (G, S, D) and hfin
// (G, D, N) fp32. dt, x, b, c, y, hfin contiguous. 1 <= N <= 128.
int ssm_scan(const void* dt, const void* x, const void* a, long long a_gs,
             long long a_ds, long long a_ns, const void* b, const void* c,
             void* y, void* hfin, int G, int S, int D, int N, int x_bf16,
             int bc_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || S < 1 || D < 1 || N < 1 || N > kMaxWarps * kSPL ||
      G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      a_ns == 0
          ? launch_types<true>(dt, x, a, a_gs, a_ds, a_ns, b, c, y, hfin, G,
                               S, D, N, x_bf16, bc_bf16, st)
          : launch_types<false>(dt, x, a, a_gs, a_ds, a_ns, b, c, y, hfin, G,
                                S, D, N, x_bf16, bc_bf16, st);
  return static_cast<int>(err);
}


// Mamba2's per-head form: dt (G, S, H) fp32, a (H,) fp32; x (G, S, H * P)
// and b, c (G, S, N) as bf16 pieces, 1 (bf16 operands) or 3 (fp32 ones,
// from ssm_split_bf16), in nx and nb pointers of the arrays x, b and c;
// y (G, S, H * P) and hfin (G, H * P, N) fp32. All contiguous, the
// pieces 16-byte aligned; P a multiple of 8 in [8, 64], N one in [8,
// 128] (above 64: two state tiles).
int ssm_scan_heads(const void* dt, const void* const* x, int nx,
                   const void* a, const void* const* b,
                   const void* const* c, int nb, void* y, void* hfin, int G,
                   int S, int H, int P, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || S < 1 || H < 1 || P < 8 || P > kSsdWidth || P % 8 != 0 ||
      N < 8 || N > 2 * kSsdWidth || N % 8 != 0 ||
      static_cast<long long>(G) * H > 0x7fffffffLL || (nx != 1 && nx != 3) ||
      (nb != 1 && nb != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  if (N > kSsdWidth)
    return launch_pieces<2>(dt, x, nx, a, b, c, nb, y, hfin, G, S, H, P, N,
                            st);
  return launch_pieces<1>(dt, x, nx, a, b, c, nb, y, hfin, G, S, H, P, N,
                          st);
}

// n fp32 values of src as three bf16 pieces, planes of n in out (the fp32
// operands of ssm_scan_heads); returns cudaGetLastError() of the launch
int ssm_split_bf16(const void* src, void* out, long long n, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n + 255) / 256;
  ssm_split_bf16_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096),
                          256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<bf16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

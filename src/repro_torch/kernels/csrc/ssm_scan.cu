// Selective scan (Mamba1/Mamba2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::_scan_kernel.
// For each group g (a batch row) and channel d it runs the recurrence
//     h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t x_t) B_t ,   y_t = h_t . C_t
// over t = 0..S-1 from h_{-1} = 0, and returns y (G, S, D) fp32 (without the
// D.x skip and the gate, which the caller adds) and h_final (G, D, N) fp32.
// The (S, D, N) state trajectory never reaches device memory.
//
// Two forms of A, told apart by A's N stride:
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
// rate). So the fp32 instruction rate bounds the served form at 0.120 ms.
// The general form adds G*S*D*N exponentials (1.34e9 at those shapes:
// 0.321 ms). Measured: 0.545 ms for the served form (PERF.md section 6).
//
// Design. The TPU grid walks S in order and carries a (dblk, N) state tile
// in VMEM scratch across grid steps. Here one block owns (g, 32 channels)
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
// returns cudaGetLastError() of its launch.

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

}  // namespace

extern "C" {

const char* ssm_scan_error_string(int err) {
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

}  // extern "C"

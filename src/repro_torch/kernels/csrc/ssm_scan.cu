// Selective scan (Mamba1/Mamba2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py::_scan_kernel.
// For each group g (a batch row) and channel d it runs the recurrence
//     h_t = exp(dt_t * A) (.) h_{t-1} + (dt_t x_t) B_t ,   y_t = h_t . C_t
// over t = 0..S-1 from h_{-1} = 0, and returns y (G, S, D) fp32 (without the
// D.x skip and the gate, which the caller adds) and h_final (G, D, N) fp32.
// The (S, D, N) state trajectory never reaches device memory.
//
// What bounds it on an H100. The kernel reads dt, x (G, S, D), B, C (G, S, N)
// and A (D, N) once and writes y and h_final once: at the zamba2-2.7b path's
// shapes (G = 2, S = 2048, D = 5120, N = 64; dt fp32, x/B/C bf16) that is
// ~215 MB, 64 us at 3.35 TB/s. It also takes G*S*D*N = 1.34e9 exponentials,
// each several instructions with expf's range reduction (no fast math: the
// exponent feeds every later state), plus 3 FMAs per (t, d, n). So the
// instruction issue rate, not the bytes, bounds it.
//
// Design. The TPU grid walks S in order and carries a (dblk, N) state tile in
// VMEM scratch across grid steps. Here one block owns (g, 32 channels) and
// walks all of S in a loop inside the block, so nothing carries between
// blocks. Each of the block's 8 warps carries 4 channels; lane l holds the
// states n = l, l + 32, ... of each of them in registers (N <= 128). B_t and
// C_t are the same for every channel of a group, so a tile of 32 time steps
// of B, C, dt and x is staged in shared memory, and each y_t goes through
// shared memory so y leaves in coalesced rows. y_t's sum over N is a lane's
// own states, then a butterfly of warp shuffles: another order than XLA's,
// so y agrees with the plain version to fp32 rounding, not bit for bit.
// Channels past D and states past N are masked (A = 0, B = C = 0: their
// state stays 0), and the last time tile may be short: there is no
// divisibility requirement on S or D.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChanPerWarp = 4;
constexpr int kChan = kWarps * kChanPerWarp;   // channels per block
constexpr int kT = 32;                         // time steps per staged tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// NPL: states per lane (N <= 32 * NPL). TX: x's type; TBC: B's and C's.
template <int NPL, typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ dt, const TX* __restrict__ x,
                const float* __restrict__ a, long long a_gstride,
                const TBC* __restrict__ b, const TBC* __restrict__ c,
                float* __restrict__ y, float* __restrict__ hfin, int S, int D,
                int N) {
  constexpr int kN = NPL * 32;
  __shared__ float s_dt[kT][kChan];
  __shared__ float s_x[kT][kChan];
  __shared__ float s_y[kT][kChan];
  __shared__ float s_b[kT][kN];
  __shared__ float s_c[kT][kN];

  const int g = blockIdx.y;
  const int d0 = blockIdx.x * kChan;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const long long gsd = static_cast<long long>(g) * S * D;
  const long long gsn = static_cast<long long>(g) * S * N;
  const float* ag = a + static_cast<long long>(g) * a_gstride;

  float h[kChanPerWarp][NPL];
  float av[kChanPerWarp][NPL];
#pragma unroll
  for (int ci = 0; ci < kChanPerWarp; ++ci) {
    const int d = d0 + warp * kChanPerWarp + ci;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = lane + 32 * j;
      av[ci][j] = (d < D && n < N)
                      ? ag[static_cast<long long>(d) * N + n] : 0.f;
      h[ci][j] = 0.f;
    }
  }

  for (int t0 = 0; t0 < S; t0 += kT) {
    const int tn = min(kT, S - t0);
    __syncthreads();   // the previous tile's readers are done
    for (int i = tid; i < kT * kChan; i += kThreads) {
      const int tt = i / kChan, cc = i % kChan, d = d0 + cc;
      const bool ok = tt < tn && d < D;
      const long long off = gsd + static_cast<long long>(t0 + tt) * D + d;
      s_dt[tt][cc] = ok ? dt[off] : 0.f;
      s_x[tt][cc] = ok ? to_f32(x[off]) : 0.f;
    }
    for (int i = tid; i < kT * kN; i += kThreads) {
      const int tt = i / kN, nn = i % kN;
      const bool ok = tt < tn && nn < N;
      const long long off = gsn + static_cast<long long>(t0 + tt) * N + nn;
      s_b[tt][nn] = ok ? to_f32(b[off]) : 0.f;
      s_c[tt][nn] = ok ? to_f32(c[off]) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      float bv[NPL], cv[NPL];
#pragma unroll
      for (int j = 0; j < NPL; ++j) {
        bv[j] = s_b[tt][lane + 32 * j];
        cv[j] = s_c[tt][lane + 32 * j];
      }
#pragma unroll
      for (int ci = 0; ci < kChanPerWarp; ++ci) {
        const int cc = warp * kChanPerWarp + ci;
        const float dtv = s_dt[tt][cc];
        const float dx = dtv * s_x[tt][cc];
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < NPL; ++j) {
          const float decay = expf(dtv * av[ci][j]);
          h[ci][j] = decay * h[ci][j] + dx * bv[j];
          part += h[ci][j] * cv[j];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (lane == 0) s_y[tt][cc] = part;
      }
    }
    __syncthreads();
    for (int i = tid; i < kT * kChan; i += kThreads) {
      const int tt = i / kChan, cc = i % kChan, d = d0 + cc;
      if (tt < tn && d < D)
        y[gsd + static_cast<long long>(t0 + tt) * D + d] = s_y[tt][cc];
    }
  }

#pragma unroll
  for (int ci = 0; ci < kChanPerWarp; ++ci) {
    const int d = d0 + warp * kChanPerWarp + ci;
#pragma unroll
    for (int j = 0; j < NPL; ++j) {
      const int n = lane + 32 * j;
      if (d < D && n < N)
        hfin[(static_cast<long long>(g) * D + d) * N + n] = h[ci][j];
    }
  }
}

template <int NPL, typename TX, typename TBC>
cudaError_t launch(const void* dt, const void* x, const void* a,
                   long long a_gstride, const void* b, const void* c,
                   void* y, void* hfin, int G, int S, int D, int N,
                   cudaStream_t stream) {
  dim3 grid((D + kChan - 1) / kChan, G);
  ssm_scan_kernel<NPL, TX, TBC><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(dt), static_cast<const TX*>(x),
      static_cast<const float*>(a), a_gstride, static_cast<const TBC*>(b),
      static_cast<const TBC*>(c), static_cast<float*>(y),
      static_cast<float*>(hfin), S, D, N);
  return cudaGetLastError();
}

template <int NPL>
cudaError_t launch_npl(const void* dt, const void* x, const void* a,
                       long long a_gstride, const void* b, const void* c,
                       void* y, void* hfin, int G, int S, int D, int N,
                       int x_bf16, int bc_bf16, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  if (x_bf16 && bc_bf16)
    return launch<NPL, bf, bf>(dt, x, a, a_gstride, b, c, y, hfin, G, S, D,
                               N, stream);
  if (x_bf16)
    return launch<NPL, bf, float>(dt, x, a, a_gstride, b, c, y, hfin, G, S,
                                  D, N, stream);
  if (bc_bf16)
    return launch<NPL, float, bf>(dt, x, a, a_gstride, b, c, y, hfin, G, S,
                                  D, N, stream);
  return launch<NPL, float, float>(dt, x, a, a_gstride, b, c, y, hfin, G, S,
                                   D, N, stream);
}

}  // namespace

extern "C" {

const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dt (G, S, D) fp32; x (G, S, D) fp32 or bf16; a: group g's (D, N) fp32
// block starts at a + g * a_gstride (0 for one A shared by every group);
// b, c (G, S, N) fp32 or bf16 (both the same); y (G, S, D) and hfin
// (G, D, N) fp32. All contiguous. 1 <= N <= 128.
int ssm_scan(const void* dt, const void* x, const void* a,
             long long a_gstride, const void* b, const void* c, void* y,
             void* hfin, int G, int S, int D, int N, int x_bf16, int bc_bf16,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || S < 1 || D < 1 || N < 1 || N > 128 || G > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (N <= 32)
    err = launch_npl<1>(dt, x, a, a_gstride, b, c, y, hfin, G, S, D, N,
                        x_bf16, bc_bf16, st);
  else if (N <= 64)
    err = launch_npl<2>(dt, x, a, a_gstride, b, c, y, hfin, G, S, D, N,
                        x_bf16, bc_bf16, st);
  else
    err = launch_npl<4>(dt, x, a, a_gstride, b, c, y, hfin, G, S, D, N,
                        x_bf16, bc_bf16, st);
  return static_cast<int>(err);
}

}  // extern "C"

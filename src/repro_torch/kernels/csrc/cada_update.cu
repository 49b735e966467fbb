// Fused CADA/AMSGrad server step and the rule-LHS norms for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the JAX package:
//   * amsgrad_kernel         <- src/repro/kernels/cada_update.py::_amsgrad_kernel
//   * batched_diff_sq_kernel <- src/repro/kernels/cada_update.py::_batched_diff_sq_kernel
//                               and, launched with one row (R = 1),
//                               src/repro/kernels/cada_update.py::_diff_sq_kernel
//   * batched_sq_kernel      <- src/repro/kernels/cada_update.py::_batched_sq_kernel
//
// What bounds them on an H100: all are streaming passes with O(1) flops per
// byte, so device-memory bytes bound them (28 B/element for the fp32 AMSGrad
// step, 8 B/element/row for the fp32 difference norm, 4 for the one-operand
// norm). At the paper MLP's size (n_flat = 101,776, M = 10) the operands
// total 2.9, 8.1 and 4.1 MB, well inside the 50 MB L2, and the bound is
// ~1-3 us: below one launch. So the design aims at few launches and exact,
// run-to-run identical sums, not at bandwidth tricks (no TMA, no vector
// loads; warp-contiguous scalar loads already fill whole 32-byte sectors).
//
// Determinism. The TPU kernels carry their sums across a sequential grid.
// Here blocks run in no fixed order, so every block writes its partial sum
// to scratch and a second kernel adds the partials in a fixed order. There
// are no float atomics: Σupd² (which feeds every gate's RHS) and the rule
// LHS norms are bitwise the same on every run.
//
// Row independence. The batched norms' chunking depends on n only, never on
// the row count R, and rows never mix: a row's result is the same whether it
// sits in a (M, n) dense plane or a (C, n) cohort plane. The one-operand
// norm shares the difference norm's grid and second pass, so it reads one
// plane instead of subtracting a plane of zeros (half the bytes).
//
// Rounding. The AMSGrad arithmetic uses explicit round-to-nearest intrinsics
// (no FMA contraction), in the operation order of the plain PyTorch version
// (repro_torch/kernels/ref.py::amsgrad_ref), so θ', h' and v̂' equal the plain
// version's bit for bit on the card; only Σupd²'s summation order differs.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// torch.maximum semantics: NaN in either operand propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Fixed-order block sum (warp shuffles, then warp 0 over the warp sums).
// The result is valid in thread 0. blockDim.x must be kThreads.
__device__ float block_sum(float v) {
  __shared__ float warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// One grid-stride pass of the paper's eqs. (2a)-(2c), ε inside the root:
//   h' = β1·h + (1−β1)·g;  v = β2·v̂ + (1−β2)·g²;  v̂' = max(v, v̂)
//   upd = −lr·h'/√(ε + v̂');  θ' = θ + upd
// Math is fp32; h and v̂ are stored as M (fp32 or bf16) and the STORED,
// rounded moment drives upd. Each block writes its Σupd² to partials.
template <typename M>
__global__ void __launch_bounds__(kThreads)
amsgrad_kernel(const float* __restrict__ theta, const M* __restrict__ h,
               const M* __restrict__ vhat, const float* __restrict__ grad,
               float* __restrict__ theta_out, M* __restrict__ h_out,
               M* __restrict__ vhat_out, float* __restrict__ partials,
               int64_t n, float lr, float b1, float c1, float b2, float c2,
               float eps) {
  float acc = 0.f;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float g = grad[i];
    const float h32 = to_f32(h[i]);
    const float vh32 = to_f32(vhat[i]);
    const M h_new = from_f32<M>(__fadd_rn(__fmul_rn(b1, h32), __fmul_rn(c1, g)));
    const float v = __fadd_rn(__fmul_rn(b2, vh32), __fmul_rn(__fmul_rn(c2, g), g));
    const M vh_new = from_f32<M>(nan_max(v, vh32));
    const float upd = __fdiv_rn(__fmul_rn(-lr, to_f32(h_new)),
                                __fsqrt_rn(__fadd_rn(eps, to_f32(vh_new))));
    theta_out[i] = __fadd_rn(theta[i], upd);
    h_out[i] = h_new;
    vhat_out[i] = vh_new;
    acc = __fadd_rn(acc, __fmul_rn(upd, upd));
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// Per-(row, column-chunk) partial of Σ_j (a_rj − b_rj)² in fp32. blockIdx.x
// is the row, blockIdx.y the chunk; chunk c covers columns c·256 + t +
// k·(chunks·256), a split fixed by n alone.
template <typename A, typename B>
__global__ void __launch_bounds__(kThreads)
batched_diff_sq_kernel(const A* __restrict__ a, const B* __restrict__ b,
                       float* __restrict__ partials, int64_t n) {
  const int64_t row = blockIdx.x;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const A* ar = a + row * n;
  const B* br = b + row * n;
  float acc = 0.f;
  const int64_t stride = (int64_t)chunks * blockDim.x;
  for (int64_t j = (int64_t)chunk * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const float d = __fsub_rn(to_f32(ar[j]), to_f32(br[j]));
    acc = __fadd_rn(acc, __fmul_rn(d, d));
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[row * chunks + chunk] = s;
}

// One-operand form: per-(row, chunk) partial of Σ_j a_rj², the same split.
template <typename A>
__global__ void __launch_bounds__(kThreads)
batched_sq_kernel(const A* __restrict__ a, float* __restrict__ partials,
                  int64_t n) {
  const int64_t row = blockIdx.x;
  const int chunk = blockIdx.y;
  const int chunks = gridDim.y;
  const A* ar = a + row * n;
  float acc = 0.f;
  const int64_t stride = (int64_t)chunks * blockDim.x;
  for (int64_t j = (int64_t)chunk * blockDim.x + threadIdx.x; j < n;
       j += stride) {
    const float v = to_f32(ar[j]);
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[row * chunks + chunk] = s;
}

// Second pass: out[r] = Σ_c partials[r·count + c], in a fixed order.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const float* __restrict__ partials, int count,
                    float* __restrict__ out) {
  const float* p = partials + (int64_t)blockIdx.x * count;
  float acc = 0.f;
  for (int i = threadIdx.x; i < count; i += blockDim.x) acc += p[i];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename A, typename B>
cudaError_t launch_batched(const void* a, const void* b, void* partials,
                           void* out, int64_t rows, int64_t n, int chunks,
                           cudaStream_t stream) {
  const dim3 grid((unsigned)rows, (unsigned)chunks);
  batched_diff_sq_kernel<A, B><<<grid, kThreads, 0, stream>>>(
      static_cast<const A*>(a), static_cast<const B*>(b),
      static_cast<float*>(partials), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const float*>(partials), chunks, static_cast<float*>(out));
  return cudaGetLastError();
}

template <typename A>
cudaError_t launch_batched_sq(const void* a, void* partials, void* out,
                              int64_t rows, int64_t n, int chunks,
                              cudaStream_t stream) {
  const dim3 grid((unsigned)rows, (unsigned)chunks);
  batched_sq_kernel<A><<<grid, kThreads, 0, stream>>>(
      static_cast<const A*>(a), static_cast<float*>(partials), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<(unsigned)rows, kThreads, 0, stream>>>(
      static_cast<const float*>(partials), chunks, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cada_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// θ, g fp32 (n,); h, v̂ fp32 or bf16 (moments_bf16); partials fp32 (blocks,);
// sq_out fp32 (1,). Outputs must not alias inputs.
int cada_amsgrad(const void* theta, const void* h, const void* vhat,
                 const void* grad, void* theta_out, void* h_out,
                 void* vhat_out, void* partials, void* sq_out, long long n,
                 int blocks, float lr, float b1, float c1, float b2, float c2,
                 float eps, int moments_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t = static_cast<const float*>(theta);
  const float* g = static_cast<const float*>(grad);
  float* to = static_cast<float*>(theta_out);
  float* part = static_cast<float*>(partials);
  if (moments_bf16) {
    amsgrad_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        t, static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(vhat), g, to,
        static_cast<__nv_bfloat16*>(h_out),
        static_cast<__nv_bfloat16*>(vhat_out), part, n, lr, b1, c1, b2, c2,
        eps);
  } else {
    amsgrad_kernel<float><<<blocks, kThreads, 0, s>>>(
        t, static_cast<const float*>(h), static_cast<const float*>(vhat), g,
        to, static_cast<float*>(h_out), static_cast<float*>(vhat_out), part,
        n, lr, b1, c1, b2, c2, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, s>>>(part, blocks,
                                             static_cast<float*>(sq_out));
  return static_cast<int>(cudaGetLastError());
}

// a, b (rows, n) contiguous, each fp32 or bf16 (a_bf16 / b_bf16);
// partials fp32 (rows, chunks); out fp32 (rows,).
int cada_batched_diff_sq(const void* a, const void* b, void* partials,
                         void* out, long long rows, long long n, int chunks,
                         int a_bf16, int b_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_bf16 && b_bf16)
    err = launch_batched<__nv_bfloat16, __nv_bfloat16>(a, b, partials, out,
                                                       rows, n, chunks, s);
  else if (a_bf16)
    err = launch_batched<__nv_bfloat16, float>(a, b, partials, out, rows, n,
                                               chunks, s);
  else if (b_bf16)
    err = launch_batched<float, __nv_bfloat16>(a, b, partials, out, rows, n,
                                               chunks, s);
  else
    err = launch_batched<float, float>(a, b, partials, out, rows, n, chunks,
                                       s);
  return static_cast<int>(err);
}

// a (rows, n) contiguous, fp32 or bf16 (a_bf16); partials fp32
// (rows, chunks); out fp32 (rows,).
int cada_batched_sq(const void* a, void* partials, void* out, long long rows,
                    long long n, int chunks, int a_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      a_bf16 ? launch_batched_sq<__nv_bfloat16>(a, partials, out, rows, n,
                                                chunks, s)
             : launch_batched_sq<float>(a, partials, out, rows, n, chunks, s);
  return static_cast<int>(err);
}

}  // extern "C"

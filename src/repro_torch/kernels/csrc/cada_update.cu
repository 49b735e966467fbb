// Fused CADA/AMSGrad server step, the rule-LHS norms and eq. (3)'s
// order-fixed row mean for Hopper (sm_90a).
//
// Replaces four Pallas TPU kernels of the JAX package, and one op that is a
// `fori_loop` there, not Pallas:
//   * amsgrad_kernel  <- src/repro/kernels/cada_update.py::_amsgrad_kernel
//                        (:34)
//   * row_sq_kernel   <- two operands: src/repro/kernels/cada_update.py::
//                        _batched_diff_sq_kernel and, launched with one row
//                        (R = 1), ::_diff_sq_kernel; one operand:
//                        ::_batched_sq_kernel
//   * row_mean_kernel <- src/repro/kernels/ops.py::eq3_row_mean (:126), the
//                        server's eq. (3) aggregate with its row order
//                        fixed (see the kernel's own note below)
//
// What bounds them on an H100: all are streaming passes that read each byte
// once and do O(1) flops per element, so device-memory bytes bound them:
// 28 B/element for the fp32 AMSGrad step (22 with bf16 θ and g), 8 B per
// element and row for the fp32 difference norm, 4 for the one-operand norm.
// At the paper MLP's size (n_flat = 101,776, M = 10) the operands total
// 2.9, 8.1 and 4.1 MB, inside the 50 MB L2, and the bound (~1-3 us) is below
// one launch: there the cost is the launch and the memory round trips of
// one pass. At LM widths (n ~ 1e8-1e9) the pass is bound by the 3.35 TB/s
// of HBM, reached only with enough bytes in flight on every SM.
//
// What the design does about it.
//  * One launch per call. Each block writes its partial sum to a workspace
//    and takes a ticket from an integer atomic add (acquire-release) on a
//    counter; the block that draws the last ticket adds the partials and
//    resets the counter to 0 (last_block_sum). No second kernel, no float
//    atomics. The ticket and the read of the partials are two round trips
//    to L2 after the last block's pass, about a third of the call at the
//    main path's size (PERF.md section 6, tools/cada_variants.py); an
//    acquire-release ticket costs less there than a fence and a relaxed
//    atomic.
//  * Vector accesses. A thread handles packs of consecutive elements: the
//    row norms 8 (one 16-byte vector of bf16, two of fp32), the AMSGrad
//    step 4 (one 16-byte vector of fp32, 8 bytes of bf16): its per-element
//    arithmetic (a correctly rounded divide and root) is long enough that
//    at the main path's n_flat 8 elements a thread on 50 blocks cost more
//    than 4 on 100. Two packs are loaded before either is computed, so a
//    thread keeps up to 8 vectors of the step's four operands in flight
//    (an SM holds hundreds of KB outstanding, several times what HBM's
//    latency-bandwidth product needs). Vector accesses carry the streaming
//    hint (__ldcs/__stcs, evict first): the bytes are used once per call,
//    and the hint made the bf16-θ step at LM widths faster and cost
//    nothing elsewhere.
//  * TMA, wgmma and cp.async staging do not apply: a pass that reads each
//    byte once and does a few flops per element gains nothing from staging
//    in shared memory or from the tensor cores. Its bandwidth comes from
//    bytes in flight, which plain vector loads give.
//
// Determinism. The split of the elements over blocks and threads depends
// on n alone (the grid sizes are functions of n, never of the card's SM
// count or of R): thread t of a grid of T threads owns packs t, t + T, ...,
// and the last pack may be short. A thread adds its elements in order, the
// block adds its threads in a fixed tree (block_sum), and the last block
// adds the partials in block index order, through the same tree. Whether a
// pack is loaded as vectors or as scalars (the wrapper passes `vec`, true
// where every operand, and every row of a plane, starts on 16 bytes) does
// not change what a thread adds or in what order. So Σupd² and the row
// norms are bitwise the same on every run, for a view at any offset as for
// an aligned buffer, and a row's norm is the same in an (R, n) plane as
// alone in a (1, n) one (a row never mixes with another).
//
// The workspace (the counters and the partials) is allocated and zeroed
// once per (device, stream) by the wrapper and reused by every launch on
// that stream. It is safe to reuse because launches on one stream run one
// after another and each leaves every counter it used at 0; the partials
// are written before they are read in every launch. A fixed buffer is also
// what a CUDA graph of the caller's step needs.
//
// Rounding. The AMSGrad arithmetic uses explicit round-to-nearest intrinsics
// (no FMA contraction), in the operation order of the plain PyTorch version
// (repro_torch/kernels/ref.py::amsgrad_ref), so θ', h' and v̂' equal the plain
// version's bit for bit on the card for θ and g in fp32 or bf16 and moments
// in fp32 or bf16; only Σupd²'s summation order differs.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
// elements per pack: AMSGrad 4 (16 bytes of fp32, 8 of bf16), the row
// norms 8 (16 bytes of bf16, 32 of fp32)
constexpr int kAmsgradPack = 4;
constexpr int kRowPack = 8;
constexpr int kUnroll = 2;   // packs a thread loads before computing

// flags of cada_amsgrad
constexpr int kThetaBf16 = 1, kGradBf16 = 2, kMomentsBf16 = 4, kVec = 8;

// torch.maximum semantics: NaN in either operand propagates.
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// A pack of P elements of type T moves as one or two 16-byte vectors, or
// one 8-byte vector where it is 8 bytes (four bf16).
template <int kBytes>
struct Vec;
template <>
struct Vec<8> {
  using type = uint2;
  static constexpr int count = 1;
};
template <>
struct Vec<16> {
  using type = uint4;
  static constexpr int count = 1;
};
template <>
struct Vec<32> {
  using type = uint4;
  static constexpr int count = 2;
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

// x rounded to nearest into T, as fp32 (exact)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// The first `cnt` elements at p, as fp32 (exact); the rest 0. Vector loads
// where `vec` and the pack is whole, with the streaming hint (each byte is
// read once: evict first).
template <int P, typename T>
__device__ __forceinline__ void load_pack(const T* p, bool vec, int cnt,
                                          float (&v)[P]) {
  if (vec && cnt == P) {
    using V = Vec<P * sizeof(T)>;
    typename V::type raw[V::count];
#pragma unroll
    for (int c = 0; c < V::count; ++c)
      raw[c] = __ldcs(reinterpret_cast<const typename V::type*>(p) + c);
    const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
    for (int k = 0; k < P; ++k) v[k] = to_f32(e[k]);
    return;
  }
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = k < cnt ? to_f32(p[k]) : 0.f;
}

// Store the first `cnt` of v at p, each rounded to nearest into p's type
// (vector stores with the streaming hint where `vec` and the pack is whole).
template <int P, typename T>
__device__ __forceinline__ void store_pack(T* p, bool vec, int cnt,
                                           const float (&v)[P]) {
  if (vec && cnt == P) {
    using V = Vec<P * sizeof(T)>;
    typename V::type raw[V::count];
    T* e = reinterpret_cast<T*>(raw);
#pragma unroll
    for (int k = 0; k < P; ++k) e[k] = from_f32<T>(v[k]);
#pragma unroll
    for (int c = 0; c < V::count; ++c)
      __stcs(reinterpret_cast<typename V::type*>(p) + c, raw[c]);
    return;
  }
#pragma unroll
  for (int k = 0; k < P; ++k)
    if (k < cnt) p[k] = from_f32<T>(v[k]);
}

// Elements of pack q of an n-element operand (0 past the end).
template <int P>
__device__ __forceinline__ int pack_count(int64_t q, int64_t packs,
                                          int64_t n) {
  if (q >= packs) return 0;
  const int64_t left = n - q * P;
  return left < P ? static_cast<int>(left) : P;
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

// A ticket: atomically counter += 1, returning the old value, with
// acquire-release semantics at device scope. The release makes this
// thread's earlier stores (its block's partial) visible to whoever
// acquires a later value of the counter; the acquire makes every earlier
// ticket holder's partial visible to this thread.
__device__ __forceinline__ unsigned take_ticket(unsigned* counter) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// The one-launch grid reduction. Every thread of each of `count` blocks
// calls it, with its block's sum s valid in thread 0 and `index` the block's
// place among the count. Thread 0 stores the partial and takes a ticket
// (release: the partial is visible before the ticket). The block with the
// last ticket (acquire: it sees every partial; its other threads see them
// after the barrier) adds partials[0..count) in index order (thread t: t,
// t + kThreads, ..., then block_sum), reading them from L2 (__ldcg, never
// an L1 line); it writes *out and sets the counter back to 0 once every
// partial has been read (block_sum's barrier).
__device__ void last_block_sum(float s, float* partials, int count, int index,
                               unsigned* counter, float* out) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[index] = s;
    last = take_ticket(counter) == static_cast<unsigned>(count - 1);
  }
  __syncthreads();
  if (!last) return;
  float v = 0.f;
  for (int i = threadIdx.x; i < count; i += kThreads)
    v = __fadd_rn(v, __ldcg(partials + i));
  const float total = block_sum(v);
  if (threadIdx.x == 0) {
    *out = total;
    *counter = 0u;
  }
}

struct AmsgradArgs {
  const void *theta, *h, *vhat, *grad;
  void *theta_out, *h_out, *vhat_out;
  float* partials;
  unsigned* counter;
  float* sq_out;
  int64_t n;
  float lr, b1, c1, b2, c2, eps;
  bool vec;
};

// The paper's eqs. (2a)-(2c), ε inside the root, per element:
//   h' = β1·h + (1−β1)·g;  v = β2·v̂ + (1−β2)·g²;  v̂' = max(v, v̂)
//   upd = −lr·h'/√(ε + v̂');  θ' = θ + upd
// The math is fp32. θ (T) and g (G) are fp32 or bf16, h and v̂ (M) are
// stored fp32 or bf16, and the STORED, rounded moment drives upd; θ' is
// rounded once, from the fp32 θ + upd, into θ's type. Σupd² is summed from
// the fp32 upd.
template <typename T, typename M, typename G>
__global__ void __launch_bounds__(kThreads)
amsgrad_kernel(const AmsgradArgs a) {
  constexpr int P = kAmsgradPack;
  const T* theta = static_cast<const T*>(a.theta);
  const M* h = static_cast<const M*>(a.h);
  const M* vhat = static_cast<const M*>(a.vhat);
  const G* grad = static_cast<const G*>(a.grad);
  const int64_t n = a.n, packs = (n + P - 1) / P;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float acc = 0.f;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       p < packs; p += kUnroll * stride) {
    float th[kUnroll][P], hh[kUnroll][P], vh[kUnroll][P],
        g[kUnroll][P];
    int cnt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * stride;
      cnt[u] = pack_count<P>(q, packs, n);
      const int64_t e = q * P;
      load_pack(theta + e, a.vec, cnt[u], th[u]);
      load_pack(h + e, a.vec, cnt[u], hh[u]);
      load_pack(vhat + e, a.vec, cnt[u], vh[u]);
      load_pack(grad + e, a.vec, cnt[u], g[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (cnt[u] == 0) break;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float gk = g[u][k];
        const float h_new = round_to<M>(
            __fadd_rn(__fmul_rn(a.b1, hh[u][k]), __fmul_rn(a.c1, gk)));
        const float v = __fadd_rn(__fmul_rn(a.b2, vh[u][k]),
                                  __fmul_rn(__fmul_rn(a.c2, gk), gk));
        const float vh_new = round_to<M>(nan_max(v, vh[u][k]));
        const float upd = __fdiv_rn(__fmul_rn(-a.lr, h_new),
                                    __fsqrt_rn(__fadd_rn(a.eps, vh_new)));
        th[u][k] = __fadd_rn(th[u][k], upd);
        hh[u][k] = h_new;
        vh[u][k] = vh_new;
        if (k < cnt[u]) acc = __fadd_rn(acc, __fmul_rn(upd, upd));
      }
      const int64_t e = (p + u * stride) * P;
      store_pack(static_cast<T*>(a.theta_out) + e, a.vec, cnt[u], th[u]);
      store_pack(static_cast<M*>(a.h_out) + e, a.vec, cnt[u], hh[u]);
      store_pack(static_cast<M*>(a.vhat_out) + e, a.vec, cnt[u], vh[u]);
    }
  }
  last_block_sum(block_sum(acc), a.partials, gridDim.x, blockIdx.x, a.counter,
                 a.sq_out);
}

struct RowArgs {
  const void *a, *b;   // b unused by the one-operand form
  float* partials;     // (rows, chunks)
  unsigned* counters;  // (rows,)
  float* out;          // (rows,)
  int64_t n;
  bool vec;
};

// Per-row Σ_j (a_rj − b_rj)² (kTwo) or Σ_j a_rj² in fp32. blockIdx.x is the
// row, blockIdx.y the chunk: chunk c owns packs c·kThreads + t + k·(chunks·
// kThreads) of its row, a split fixed by n alone. The last chunk block of a
// row to finish adds the row's partials (per-row ticket counter).
template <typename A, typename B, bool kTwo>
__global__ void __launch_bounds__(kThreads)
row_sq_kernel(const RowArgs r) {
  constexpr int P = kRowPack;
  const int64_t row = blockIdx.x;
  const int chunks = gridDim.y;
  const int64_t n = r.n, packs = (n + P - 1) / P;
  const A* ar = static_cast<const A*>(r.a) + row * n;
  const B* br = static_cast<const B*>(r.b) + row * n;
  const int64_t stride = static_cast<int64_t>(chunks) * kThreads;
  float acc = 0.f;
  for (int64_t p = static_cast<int64_t>(blockIdx.y) * kThreads + threadIdx.x;
       p < packs; p += kUnroll * stride) {
    float va[kUnroll][P], vb[kUnroll][P];
    int cnt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t q = p + u * stride;
      cnt[u] = pack_count<P>(q, packs, n);
      load_pack(ar + q * P, r.vec, cnt[u], va[u]);
      if (kTwo) load_pack(br + q * P, r.vec, cnt[u], vb[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float d = kTwo ? __fsub_rn(va[u][k], vb[u][k]) : va[u][k];
        if (k < cnt[u]) acc = __fadd_rn(acc, __fmul_rn(d, d));
      }
  }
  last_block_sum(block_sum(acc), r.partials + row * chunks, chunks,
                 blockIdx.y, r.counters + row, r.out + row);
}

// Eq. (3)'s order-fixed row mean: out[j] = (Σ over r from R−1 down to 0 of
// plane[r, j]) · rcp, in fp32, for an (R, n) fp32 or bf16 plane.
//
// The order is the contract. The sum starts from +0.0 and adds the rows in
// descending order, each add rounded on its own (__fadd_rn: nvcc cannot
// contract it), then multiplies once by rcp = fp32(1) / fp32(m_total)
// (__fmul_rn), as repro_torch/kernels/ref.py::eq3_row_mean_ref does. So
// the result equals the plain version bit for bit, and an all-zero row
// changes no bit: +0.0 added to any sum is that sum (the sum is never
// −0.0: it starts at +0.0 and no add of two values reaches −0.0 unless
// both are). That is what lets a plane with its zero rows dropped give the
// same bits.
//
// What bounds it: bytes. Each element is read once and each output written
// once, (R·size + 4) bytes per column: at the paper MLP's (10, 101,776)
// fp32 4.5 MB (1.3 us at 3.35 TB/s, below one launch), at the LM trainer's
// (2, 616,581,120) fp32 7.4 GB (2.21 ms).
//
// Design: one thread owns a pack of kRowPack adjacent columns (16-byte
// vectors where every row starts on 16 bytes, scalar loads of the same
// pack otherwise) and walks the rows; there is no reduction across
// threads, so no ticket and no workspace. Loads of kRowGroup rows are
// issued before their adds, so a thread has that many vectors in flight
// while the adds stay in order.
constexpr int kRowGroup = 4;

struct MeanArgs {
  const void* plane;
  float* out;
  int64_t rows, n;
  float rcp;
  bool vec;
};

template <typename A>
__global__ void __launch_bounds__(kThreads)
row_mean_kernel(const MeanArgs m) {
  constexpr int P = kRowPack;
  const int64_t n = m.n, packs = (n + P - 1) / P;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const A* plane = static_cast<const A*>(m.plane);
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       q < packs; q += stride) {
    const int cnt = pack_count<P>(q, packs, n);
    float acc[P];
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = 0.f;
    for (int64_t top = m.rows - 1; top >= 0; top -= kRowGroup) {
      float v[kRowGroup][P];
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g)
        if (top - g >= 0)
          load_pack(plane + (top - g) * n + q * P, m.vec, cnt, v[g]);
#pragma unroll
      for (int g = 0; g < kRowGroup; ++g)
        if (top - g >= 0)
#pragma unroll
          for (int k = 0; k < P; ++k) acc[k] = __fadd_rn(acc[k], v[g][k]);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = __fmul_rn(acc[k], m.rcp);
    store_pack(m.out + q * P, m.vec, cnt, acc);
  }
}

template <typename T, typename M, typename G>
cudaError_t launch_amsgrad(const AmsgradArgs& a, int blocks,
                           cudaStream_t s) {
  amsgrad_kernel<T, M, G><<<blocks, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, typename M>
cudaError_t amsgrad_by_grad(const AmsgradArgs& a, int blocks, int flags,
                            cudaStream_t s) {
  return (flags & kGradBf16) ? launch_amsgrad<T, M, bf16>(a, blocks, s)
                             : launch_amsgrad<T, M, float>(a, blocks, s);
}

template <typename T>
cudaError_t amsgrad_by_moments(const AmsgradArgs& a, int blocks, int flags,
                               cudaStream_t s) {
  return (flags & kMomentsBf16) ? amsgrad_by_grad<T, bf16>(a, blocks, flags, s)
                                : amsgrad_by_grad<T, float>(a, blocks, flags,
                                                            s);
}

template <typename A, typename B, bool kTwo>
cudaError_t launch_rows(const RowArgs& r, int64_t rows, int chunks,
                        cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(chunks));
  row_sq_kernel<A, B, kTwo><<<grid, kThreads, 0, s>>>(r);
  return cudaGetLastError();
}

template <typename A>
cudaError_t launch_mean(const MeanArgs& m, int blocks, cudaStream_t s) {
  row_mean_kernel<A><<<blocks, kThreads, 0, s>>>(m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cada_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// θ, θ' (n,) fp32 or bf16 (flags & kThetaBf16); g (n,) fp32 or bf16
// (kGradBf16); h, v̂, h', v̂' fp32 or bf16 (kMomentsBf16); kVec where every
// operand starts on 16 bytes. counter: one zeroed unsigned; partials fp32
// (blocks,); sq_out fp32 (1,). Outputs must not alias inputs.
int cada_amsgrad(const void* theta, const void* h, const void* vhat,
                 const void* grad, void* theta_out, void* h_out,
                 void* vhat_out, void* counter, void* partials, void* sq_out,
                 long long n, int blocks, float lr, float b1, float c1,
                 float b2, float c2, float eps, int flags, void* stream) {
  const AmsgradArgs a{theta, h, vhat, grad, theta_out, h_out, vhat_out,
                      static_cast<float*>(partials),
                      static_cast<unsigned*>(counter),
                      static_cast<float*>(sq_out), n, lr, b1, c1, b2, c2, eps,
                      (flags & kVec) != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      (flags & kThetaBf16) ? amsgrad_by_moments<bf16>(a, blocks, flags, s)
                           : amsgrad_by_moments<float>(a, blocks, flags, s);
  return static_cast<int>(err);
}

// a, b (rows, n) contiguous, each fp32 or bf16 (a_bf16 / b_bf16); vec where
// every row of both starts on 16 bytes; counters (rows,) zeroed unsigned;
// partials fp32 (rows, chunks); out fp32 (rows,).
int cada_batched_diff_sq(const void* a, const void* b, void* counters,
                         void* partials, void* out, long long rows,
                         long long n, int chunks, int a_bf16, int b_bf16,
                         int vec, void* stream) {
  const RowArgs r{a, b, static_cast<float*>(partials),
                  static_cast<unsigned*>(counters), static_cast<float*>(out),
                  n, vec != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_bf16 && b_bf16)
    err = launch_rows<bf16, bf16, true>(r, rows, chunks, s);
  else if (a_bf16)
    err = launch_rows<bf16, float, true>(r, rows, chunks, s);
  else if (b_bf16)
    err = launch_rows<float, bf16, true>(r, rows, chunks, s);
  else
    err = launch_rows<float, float, true>(r, rows, chunks, s);
  return static_cast<int>(err);
}

// a (rows, n) contiguous, fp32 or bf16 (a_bf16); the rest as above.
int cada_batched_sq(const void* a, void* counters, void* partials, void* out,
                    long long rows, long long n, int chunks, int a_bf16,
                    int vec, void* stream) {
  const RowArgs r{a, a, static_cast<float*>(partials),
                  static_cast<unsigned*>(counters), static_cast<float*>(out),
                  n, vec != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      a_bf16 ? launch_rows<bf16, bf16, false>(r, rows, chunks, s)
             : launch_rows<float, float, false>(r, rows, chunks, s);
  return static_cast<int>(err);
}

// plane (rows, n) contiguous, fp32 or bf16 (a_bf16); out fp32 (n,); vec
// where every row of the plane and out start on 16 bytes; rcp the fp32
// reciprocal of m_total. blocks: the grid (a grid-stride loop covers the
// rest).
int cada_row_mean(const void* plane, void* out, long long rows, long long n,
                  float rcp, int blocks, int a_bf16, int vec, void* stream) {
  const MeanArgs m{plane, static_cast<float*>(out), rows, n, rcp, vec != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = a_bf16 ? launch_mean<bf16>(m, blocks, s)
                                 : launch_mean<float>(m, blocks, s);
  return static_cast<int>(err);
}

}  // extern "C"

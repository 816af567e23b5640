// coherence_dots: one pass over the probe-gradient history H [W, D] and the
// current probe gradient g [D], fp32:
//   dots[w] = <H[w], g>,  hist_sq[w] = <H[w], H[w]>,  g_sq = <g, g>.
//
// Replaces the Pallas kernel src/repro/kernels/coherence.py::coherence_dots
// (_kernel), the Definition-1 reduction of the coherence monitor
// (core/coherence.py::observe, called by engine/hooks.py::CoherenceHook).
//
// Bound on an H100: memory. A call reads H and g once, (W + 1) * D * 4
// bytes, against 4 * W * D + 2 * D flops: half a flop per byte, far below the
// card's ~20 fp32 flops per byte. The floor is those bytes over 3.35 TB/s
// (3.6 us at W = 8, D = 335,872).
//
// Design. The TPU kernel walks a sequential grid over D and adds into the
// same [W] output blocks. GPU blocks run in parallel, and float atomics would
// make the sums depend on the order blocks finish, while mu feeds the
// staleness controller and the Theorem-1 stepsize (training state), which
// must replay bit for bit. So the reduction has two stages in fixed order:
//   stage 1: block b owns a contiguous chunk of D. Each thread reads g once
//     (16-byte vectors where D % 4 == 0 and the pointers are aligned, else
//     scalars) and each of up to kRows history rows at the same offsets,
//     all loads issued before the first add (a bytes-bound pass needs them
//     in flight together), keeping a dot and a square partial per row and
//     one g^2 partial in registers. The block reduces them with warp
//     shuffles, then across warps through shared memory, and writes 2W + 1
//     partials to column b of a [2W + 1, nblocks] workspace. W > kRows runs
//     as blockIdx.y row groups (each group re-reads g; only group 0 writes
//     g^2).
//   stage 2: one block sums each workspace row over its nblocks partials,
//     one warp per row: lane l loads partials l, l + 32, ... (all loads in
//     flight together), adds them in that order, then a shuffle tree.
// The grid depends only on (W, D) and whether the operands allow 16-byte
// loads, so two calls on the same inputs are equal bit for bit. Offsets are
// size_t; the chunk bound masks the ragged tail.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;            // history rows per block (row group)
constexpr size_t kMaxBlocks = 1024;  // stage-1 blocks along D
constexpr int kStage2Threads = 1024;
constexpr int kPerLane = static_cast<int>(kMaxBlocks / 32);

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__device__ __forceinline__ float dot_t(float acc, T a, T b);
template <>
__device__ __forceinline__ float dot_t<float4>(float acc, float4 a, float4 b) {
  return dot4(acc, a, b);
}
template <>
__device__ __forceinline__ float dot_t<float>(float acc, float a, float b) {
  return fmaf(a, b, acc);
}

// T is float4 (vector path, n = D / 4 units) or float (n = D units). R is
// the row-group size (a power of two >= the group's rows, at most kRows).
// Every thread issues all of its loads before the first add: rows past the
// group's end re-read its last row (cache hits) and are dropped by select,
// so no branch sits between a load and the next.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, 2)
coherence_stage1(float* __restrict__ partials, const float* __restrict__ hist,
                 const float* __restrict__ g, int w, size_t d, size_t n,
                 size_t chunk) {
  const int r0 = blockIdx.y * R;
  const int rows = min(R, w - r0);
  const bool with_g = blockIdx.y == 0;
  const size_t begin = static_cast<size_t>(blockIdx.x) * chunk;
  const size_t end = min(n, begin + chunk);
  const T* gv = reinterpret_cast<const T*>(g);
  const T* hv[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    hv[r] = reinterpret_cast<const T*>(
        hist + static_cast<size_t>(r0 + min(r, rows - 1)) * d);

  float dots[R], sqs[R], gsq = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) dots[r] = sqs[r] = 0.f;

  for (size_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const T gi = __ldg(gv + i);
    T h[R];
#pragma unroll
    for (int r = 0; r < R; ++r) h[r] = __ldg(hv[r] + i);
    gsq = dot_t<T>(gsq, gi, gi);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      dots[r] = dot_t<T>(dots[r], h[r], gi);
      sqs[r] = dot_t<T>(sqs[r], h[r], h[r]);
    }
  }

  // Block reduction in fixed order: shuffle tree within each warp, then
  // warp 0..kWarps-1 in order through shared memory.
  __shared__ float red[kWarps][2 * R + 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float a = warp_sum(dots[r]);
    const float b = warp_sum(sqs[r]);
    if (lane == 0) {
      red[warp][r] = a;
      red[warp][R + r] = b;
    }
  }
  const float gs = warp_sum(gsq);
  if (lane == 0) red[warp][2 * R] = gs;
  __syncthreads();

  // Workspace [2W + 1, nblocks]: column b of this block's partials.
  const size_t nblocks = gridDim.x;
  const int k = threadIdx.x;
  if (k < 2 * rows + (with_g ? 1 : 0)) {
    int src, dst;
    if (k < rows) {
      src = k;
      dst = r0 + k;
    } else if (k < 2 * rows) {
      src = R + (k - rows);
      dst = w + r0 + (k - rows);
    } else {
      src = 2 * R;
      dst = 2 * w;
    }
    float acc = 0.f;
    for (int i = 0; i < kWarps; ++i) acc += red[i][src];
    partials[static_cast<size_t>(dst) * nblocks + blockIdx.x] = acc;
  }
}

// One warp per output column; lane l loads partials l, l + 32, ... of its
// column (all of them before adding, so the loads overlap), adds them in
// that order, then a shuffle tree.
__global__ void __launch_bounds__(kStage2Threads)
coherence_stage2(float* __restrict__ out, const float* __restrict__ partials,
                 int cols, int nblocks) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k = warp; k < cols; k += kStage2Threads / 32) {
    const float* col = partials + static_cast<size_t>(k) * nblocks;
    float v[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int b = lane + 32 * j;
      v[j] = b < nblocks ? col[b] : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc += v[j];
    acc = warp_sum(acc);
    if (lane == 0) out[k] = acc;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Stage-1 blocks along D: one float4 (or float) per thread per block is
// enough work to keep the loads in flight; capped so stage 2 stays short.
size_t stage1_blocks(size_t n) {
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks > 0 ? blocks : 1;
}

size_t units(size_t d, bool vec) { return vec ? d / 4 : d; }

template <typename T>
void launch_stage1(int r, dim3 grid, cudaStream_t st, float* ws,
                   const float* h, const float* g, int w, size_t d, size_t n,
                   size_t chunk) {
  switch (r) {
    case 1:
      coherence_stage1<T, 1><<<grid, kThreads, 0, st>>>(ws, h, g, w, d, n, chunk);
      break;
    case 2:
      coherence_stage1<T, 2><<<grid, kThreads, 0, st>>>(ws, h, g, w, d, n, chunk);
      break;
    case 4:
      coherence_stage1<T, 4><<<grid, kThreads, 0, st>>>(ws, h, g, w, d, n, chunk);
      break;
    case 8:
      coherence_stage1<T, 8><<<grid, kThreads, 0, st>>>(ws, h, g, w, d, n, chunk);
      break;
    default:
      coherence_stage1<T, kRows><<<grid, kThreads, 0, st>>>(ws, h, g, w, d, n, chunk);
  }
}

}  // namespace

// Floats of workspace a call on (W, D) may need: (2W + 1) * nblocks for the
// scalar path, which has at least as many blocks as the vector path.
extern "C" long long repro_coherence_workspace_f32(int w, long long d) {
  if (w <= 0 || d <= 0) return 0;
  return static_cast<long long>(stage1_blocks(static_cast<size_t>(d)) *
                                (2 * static_cast<size_t>(w) + 1));
}

// out: [2W + 1] = dots[0..W), hist_sq[0..W), g_sq. workspace: at least
// repro_coherence_workspace_f32(w, d) floats. Returns cudaGetLastError()
// after the launches (0 = cudaSuccess).
extern "C" int repro_coherence_f32(void* out, void* workspace,
                                   const void* hist, const void* g, int w,
                                   long long d, void* stream) {
  if (w <= 0 || d <= 0) return 0;
  const size_t dd = static_cast<size_t>(d);
  const bool vec = dd % 4 == 0 && aligned16(hist) && aligned16(g);
  const size_t n = units(dd, vec);
  const size_t blocks = stage1_blocks(n);
  const size_t chunk = (n + blocks - 1) / blocks;
  // Row-group size: the smallest power of two >= W, at most kRows.
  const int r = w > 8 ? kRows : w > 4 ? 8 : w > 2 ? 4 : w;
  const unsigned groups = static_cast<unsigned>((w + r - 1) / r);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  const float* h = static_cast<const float*>(hist);
  const float* gp = static_cast<const float*>(g);
  const dim3 grid(static_cast<unsigned>(blocks), groups);
  if (vec) {
    launch_stage1<float4>(r, grid, st, ws, h, gp, w, dd, n, chunk);
  } else {
    launch_stage1<float>(r, grid, st, ws, h, gp, w, dd, n, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  coherence_stage2<<<1, kStage2Threads, 0, st>>>(
      static_cast<float*>(out), ws, 2 * w + 1, static_cast<int>(blocks));
  return static_cast<int>(cudaGetLastError());
}

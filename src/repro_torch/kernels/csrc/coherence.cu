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
// must replay bit for bit. So every sum has a fixed order, in two grids:
//   - coherence_partials. The grid is sized to the card, not to the data:
//     the wrapper (kernels/coherence.py::choose_grid) gives at most 2 blocks
//     an SM (what __launch_bounds__ keeps resident) and at most kMaxBlocks,
//     so all of D streams in one wave. Block b owns the contiguous units
//     [b * chunk, (b + 1) * chunk) (16-byte float4 units where D % 4 == 0
//     and the pointers are aligned, else floats). A thread walks its
//     block's chunk kThreads units apart, U trips an iteration (Tune<R>):
//     every load of the iteration (g and each of the group's rows, U trips)
//     is issued before the first add, masked loads reading zero past the
//     chunk. A trip's four products add as a tree, the U trips as a tree,
//     and the iteration's value goes into a three-level cascade: level 0
//     takes `fold` iterations, then adds into level 1, which adds into
//     level 2 every `fold` of its own, so a thread's chain grows as
//     3 * cbrt(iterations), not as the iterations (R = 16: one level, see
//     Tune<16>). The block reduces its threads' values with warp shuffle
//     trees, then its 8 warps as a tree through shared memory, and writes
//     its 2R + 1 partials to column b of a [2W + 1, blocks] workspace. W > R
//     runs as blockIdx.y row groups (each group re-reads g; only group 0
//     writes g^2).
//   - coherence_final, one block of 32 warps: warp w sums columns w,
//     w + 32, ...; lane l takes the partials of blocks l, l + 32, ...,
//     l + 224 (zero past `blocks`) as an 8-slot tree, then a shuffle tree.
// Both grids are programmatic dependent launches: a grid's blocks may start
// before the grid ahead of it in the stream ends, and wait for it
// (griddepcontrol.wait) before they touch memory, so the final grid's block
// is resident when the partials are written and the next call's blocks when
// this call's final sum ends. A last-block reduction in the first grid (an
// integer ticket after a fence) was measured and dropped: its fence and
// atomic cost more than the second grid (PERF.md, section 6).
// Longest chain of roundings from a term to its output (the normwise
// tolerance of the tests and of chip_smoke.py, COHERENCE_C = 64): a trip's
// tree 3 (float4; 1 for floats), the U tree log2(U), the cascade
// 2 * (fold - 1) + ceil(I / fold^2) - 1 + 2 for I iterations, the warp tree
// 5, the warps' tree 3, the final 8-slot tree 3 and shuffle tree 5
// (kernels/coherence.py::chain_length).
// The grid depends only on (W, D, 16-byte alignment, SM count), so two
// calls on the same inputs are equal bit for bit. Offsets are size_t; the
// chunk bound masks the ragged tail. The kernels allocate nothing: the
// wrapper passes the workspace.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 2;      // __launch_bounds__ of coherence_partials
constexpr int kRows = 16;            // history rows per block (row group)
constexpr int kSlots = 8;            // partials a lane of the final sum takes
constexpr int kMaxBlocks = 32 * kSlots;
constexpr int kFinalThreads = 1024;
constexpr int kFinalWarps = kFinalThreads / 32;

// Per row-group size R: U trips an iteration, L cascade levels. Mirrored by
// kernels/coherence.py::TUNE.
template <int R> struct Tune;
template <> struct Tune<1> { static constexpr int U = 4, L = 3; };
template <> struct Tune<2> { static constexpr int U = 4, L = 3; };
template <> struct Tune<4> { static constexpr int U = 2, L = 3; };
template <> struct Tune<8> { static constexpr int U = 2, L = 3; };
// 17 float4 loads and 33 sums a thread leave no registers for more levels;
// W > 8 runs at the DNN width, one or two iterations a thread.
template <> struct Tune<16> { static constexpr int U = 1, L = 1; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// A trip's products as a tree: (x x' + y y') + (z z' + w w').
__device__ __forceinline__ float trip(float4 a, float4 b) {
  return fmaf(a.x, b.x, a.y * b.y) + fmaf(a.z, b.z, a.w * b.w);
}
__device__ __forceinline__ float trip(float a, float b) { return a * b; }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// v[0] = the tree sum of v[0..N) (N a power of two): halves added pairwise.
template <int N>
__device__ __forceinline__ void tree(float* v) {
#pragma unroll
  for (int h = N / 2; h > 0; h /= 2) {
#pragma unroll
    for (int j = 0; j < h; ++j) v[j] += v[j + h];
  }
}

struct Args {
  float* out;            // [2W + 1]
  float* partials;       // [2W + 1, blocks]
  const float* hist;     // [W, D]
  const float* g;        // [D]
  int w, blocks, fold;
  size_t d, n, chunk;
};

// T is float4 (vector path, n = D / 4 units) or float (n = D units). R is
// the row-group size (a power of two >= the group's rows, at most kRows).
// Rows past the group's end re-read its last row (cache hits) and are
// dropped when the partials are written, so no branch sits between a load
// and the next.
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
coherence_partials(const Args a) {
  constexpr int U = Tune<R>::U, L = Tune<R>::L, K = 2 * R + 1;
  static_assert(L == 1 || L == 3, "one cascade level or three");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int r0 = blockIdx.y * R;
  const int rows = min(R, a.w - r0);
  const size_t begin = static_cast<size_t>(blockIdx.x) * a.chunk;
  const size_t end = min(a.n, begin + a.chunk);
  const T* gv = reinterpret_cast<const T*>(a.g);
  const T* hv[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    hv[r] = reinterpret_cast<const T*>(a.hist + static_cast<size_t>(r0 + min(r, rows - 1)) * a.d);

  // Outputs k: dots 0..R-1, squares R..2R-1, g^2 at 2R. acc[l][k] is level l.
  float acc[L][K];
#pragma unroll
  for (int l = 0; l < L; ++l)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[l][k] = 0.f;
  int c1 = 0, c2 = 0;

  for (size_t base = begin + threadIdx.x; base < end; base += U * kThreads) {
    T gi[U], h[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = base + static_cast<size_t>(u) * kThreads;
      const bool ok = i < end;
      gi[u] = ok ? __ldg(gv + i) : zero<T>();
#pragma unroll
      for (int r = 0; r < R; ++r) h[u][r] = ok ? __ldg(hv[r] + i) : zero<T>();
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = k % R;  // the row of output k (R is a power of two)
      float v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = k < R       ? trip(h[u][j], gi[u])
             : k < 2 * R ? trip(h[u][j], h[u][j])
                         : trip(gi[u], gi[u]);
      }
      tree<U>(v);
      acc[0][k] += v[0];
    }
    if constexpr (L == 3) {
      if (++c1 == a.fold) {
        c1 = 0;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          acc[1][k] += acc[0][k];
          acc[0][k] = 0.f;
        }
        if (++c2 == a.fold) {
          c2 = 0;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            acc[2][k] += acc[1][k];
            acc[1][k] = 0.f;
          }
        }
      }
    }
  }

  // Block reduction in fixed order: the cascade's levels (top down), a
  // shuffle tree in each warp, then the 8 warps as a tree.
  __shared__ float red[kWarps][K];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = acc[L - 1][k];
#pragma unroll
    for (int l = L - 2; l >= 0; --l) s += acc[l][k];
    s = warp_sum(s);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();

  // Workspace [2W + 1, blocks]: column blockIdx.x of this block's partials.
  const int t = threadIdx.x;
  if (t < 2 * rows + (blockIdx.y == 0 ? 1 : 0)) {
    int src, dst;
    if (t < rows) {
      src = t;
      dst = r0 + t;
    } else if (t < 2 * rows) {
      src = R + (t - rows);
      dst = a.w + r0 + (t - rows);
    } else {
      src = 2 * R;
      dst = 2 * a.w;
    }
    float v[kWarps];
#pragma unroll
    for (int i = 0; i < kWarps; ++i) v[i] = red[i][src];
    tree<kWarps>(v);
    a.partials[static_cast<size_t>(dst) * a.blocks + blockIdx.x] = v[0];
  }
}

// Warp w sums columns w, w + 32, ... (CPW of them a pass, all their loads
// issued before the first add); lane l takes partials l, l + 32, ... (zero
// past `blocks`) as a tree, then the shuffle tree.
template <int CPW>
__global__ void __launch_bounds__(kFinalThreads) coherence_final(const Args a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cols = 2 * a.w + 1;
  for (int c0 = warp; c0 < cols; c0 += CPW * kFinalWarps) {
    float v[CPW][kSlots];
#pragma unroll
    for (int c = 0; c < CPW; ++c)
#pragma unroll
      for (int s = 0; s < kSlots; ++s) {
        const int k = c0 + c * kFinalWarps, b = lane + 32 * s;
        v[c][s] = k < cols && b < a.blocks
                      ? __ldcg(a.partials + static_cast<size_t>(k) * a.blocks + b)
                      : 0.f;
      }
#pragma unroll
    for (int c = 0; c < CPW; ++c) {
      tree<kSlots>(v[c]);
      const float x = warp_sum(v[c][0]);
      const int k = c0 + c * kFinalWarps;
      if (lane == 0 && k < cols) a.out[k] = x;
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
cudaError_t launch_partials(int r, cudaLaunchConfig_t* cfg, const Args& a) {
  switch (r) {
    case 1: return cudaLaunchKernelEx(cfg, coherence_partials<T, 1>, a);
    case 2: return cudaLaunchKernelEx(cfg, coherence_partials<T, 2>, a);
    case 4: return cudaLaunchKernelEx(cfg, coherence_partials<T, 4>, a);
    case 8: return cudaLaunchKernelEx(cfg, coherence_partials<T, 8>, a);
    default: return cudaLaunchKernelEx(cfg, coherence_partials<T, kRows>, a);
  }
}

}  // namespace

// out: [2W + 1] = dots[0..W), hist_sq[0..W), g_sq. workspace: at least
// (2W + 1) * blocks floats. blocks (<= 256) and chunk cover the D / 4
// (vector) or D units with blocks * chunk >= units; fold >= 1. Returns
// cudaGetLastError() after the launches (0 = cudaSuccess), or
// cudaErrorInvalidValue for a grid that does not cover D.
extern "C" int repro_coherence_f32(void* out, void* workspace, const void* hist,
                                   const void* g, int w, long long d, int blocks,
                                   long long chunk, int fold, void* stream) {
  if (w <= 0 || d <= 0) return 0;
  const size_t dd = static_cast<size_t>(d);
  // 16-byte units where D % 4 == 0 and both pointers are 16-byte aligned
  // (the wrapper's grid follows the same rule).
  const bool vec = dd % 4 == 0 && aligned16(hist) && aligned16(g);
  const size_t n = vec ? dd / 4 : dd;
  if (blocks < 1 || blocks > kMaxBlocks || chunk < 1 || fold < 1 ||
      static_cast<size_t>(blocks) * static_cast<size_t>(chunk) < n)
    return static_cast<int>(cudaErrorInvalidValue);
  // Row-group size: the smallest power of two >= W, at most kRows.
  const int r = w > 8 ? kRows : w > 4 ? 8 : w > 2 ? 4 : w;
  const Args a{static_cast<float*>(out), static_cast<float*>(workspace),
               static_cast<const float*>(hist), static_cast<const float*>(g), w,
               blocks, fold, dd, n, static_cast<size_t>(chunk)};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>((w + r - 1) / r));
  cfg.blockDim = dim3(kThreads);
  cudaError_t err = vec ? launch_partials<float4>(r, &cfg, a) : launch_partials<float>(r, &cfg, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One pass of the final grid's warps covers 32 columns (W <= 15) with
  // CPW = 1, 64 (W <= 31) with 2; more columns take more passes.
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kFinalThreads);
  err = 2 * w + 1 <= kFinalWarps ? cudaLaunchKernelEx(&cfg, coherence_final<1>, a)
                                 : cudaLaunchKernelEx(&cfg, coherence_final<2>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// flash_attention: attention over a whole sequence, blockwise with an
// online softmax:
//   out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, n] * scale) . v[b, j, n]
// with n = h / (H / Hkv) (GQA), q [B, Sq, H, hd], k/v [B, Sk, Hkv, hd] and
// out [B, Sq, H, hd], all in one dtype (fp32 or bf16), computed in fp32.
// Query row i sits at position i + Sk - Sq (right-aligned to the keys). A
// key j counts when causal is off and window is 0 (bidirectional), else
// when j <= pos(i), and with window > 0 also when j > pos(i) - window.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (_kernel), reached in both packages only through the
// dispatcher (kernels/dispatch.py::flash_attention). The TPU kernel walks a
// (B*H, q blocks, kv blocks) grid whose kv axis runs in order on one core,
// carrying (m, l, acc) in VMEM scratch from one kv block to the next.
//
// Bound on an H100: max(FLOPs / peak, bytes / 3.35 TB/s), with FLOPs =
// 4 * B * H * hd * (attended q.k pairs) (scores and weighted sum, two flops
// a multiply-add) and bytes = q, k, v and out once. At training and prefill
// lengths the operations bound it. This first design runs on the fp32
// pipes (no tensor cores), so it reaches at most the fp32 rate; wgmma and
// TMA are later work.
//
// Design. One block of 8 warps per (batch x head, tile of 32 query rows);
// the TPU grid's sequential kv axis becomes a loop inside the block over
// key tiles of 32 rows. Each tile of K and V is staged through shared
// memory as fp32 (converted from bf16 on the way in); the query tile sits
// in shared memory for the whole sweep. A warp owns 4 query rows and lane
// j scores key j of the tile against them (float4 reads: the query row is
// a broadcast, K rows are padded to an odd number of float4s so the lanes
// hit distinct banks); the row max and sum are warp butterflies, which
// leave every lane with the same bits. The running (m, l, acc) stay in
// fp32 registers: lane d holds acc elements d, d + 32, ... of its rows (any
// hd <= 256). Masked keys get probability 0 outright; key tiles that the
// causal or window mask leaves empty for every row of the block are never
// loaded. The output is acc / max(l, 1e-30), as the TPU kernel divides.
// Every sum runs in a fixed order and there are no atomics, so two calls on
// the same inputs are equal bit for bit. The ragged ends of Sq, Sk and hd
// are masked here, so no shape needs padding by the caller. Offsets are
// size_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;                  // R: query rows a warp owns
constexpr int kBlockQ = kWarps * kRowsPerWarp;   // query rows a block
constexpr int kBlockK = 32;                      // key rows a tile, one a lane
constexpr float kMinusBig = -1e30f;

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float x) {
  p[i] = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, sk, heads, hkv, hd;
  int causal, window;
  float scale;
};

// Shared-memory row widths: hd4 = hd rounded up to a float4; K rows hold an
// odd number of float4s (conflict-free float4 reads across lanes).
__host__ __device__ __forceinline__ int row4(int hd) { return (hd + 3) & ~3; }
__host__ __device__ __forceinline__ int kstride(int hd) {
  const int h4 = row4(hd);
  return ((h4 / 4) % 2) ? h4 : h4 + 4;
}

// T: operand and output type; DPL = ceil(hd / 32) acc elements a lane.
template <typename T, int DPL>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd, hd4 = row4(hd), ks = kstride(hd);
  float* s_q = smem;                        // [kBlockQ][hd4]
  float* s_k = s_q + kBlockQ * hd4;         // [kBlockK][ks]
  float* s_v = s_k + kBlockK * ks;          // [kBlockK][hd4]

  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  T* out = static_cast<T*>(a.out);

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int n = h / (a.heads / a.hkv);      // the kv head this q head reads
  const int q0 = blockIdx.x * kBlockQ;
  const int off = a.sk - a.sq;              // q row i is at position i + off
  const bool masked = a.causal || a.window > 0;

  for (int e = threadIdx.x; e < kBlockQ * hd4; e += kThreads) {
    const int r = e / hd4, d = e % hd4, i = q0 + r;
    s_q[e] = (i < a.sq && d < hd)
        ? load_f32(q, ((static_cast<size_t>(b) * a.sq + i) * a.heads + h) * hd + d)
        : 0.f;
  }

  // The key tiles some row of this block attends to.
  const int last = min(q0 + kBlockQ, a.sq) - 1;
  const int kend = masked ? min(a.sk, last + off + 1) : a.sk;
  const int kbeg = a.window > 0 ? max(0, q0 + off - a.window + 1) : 0;
  const int t_beg = kbeg / kBlockK, t_end = (kend + kBlockK - 1) / kBlockK;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = warp * kRowsPerWarp;
  float acc[kRowsPerWarp][DPL], m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kMinusBig;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int t = t_beg; t < t_end; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the previous tile is consumed (and s_q is stored)
    for (int e = threadIdx.x; e < kBlockK * hd4; e += kThreads) {
      const int j = e / hd4, d = e % hd4, kj = k0 + j;
      float kx = 0.f, vx = 0.f;
      if (kj < a.sk && d < hd) {
        const size_t idx = ((static_cast<size_t>(b) * a.sk + kj) * a.hkv + n) * hd + d;
        kx = load_f32(k, idx);
        vx = load_f32(v, idx);
      }
      s_k[j * ks + d] = kx;
      s_v[j * hd4 + d] = vx;
    }
    __syncthreads();

    // Scores: lane j against key k0 + j, for the warp's rows.
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(s_k + lane * ks);
    for (int d4 = 0; d4 < hd4 / 4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qq = reinterpret_cast<const float4*>(s_q + (r0 + r) * hd4)[d4];
        s[r] = fmaf(qq.x, kk.x, s[r]);
        s[r] = fmaf(qq.y, kk.y, s[r]);
        s[r] = fmaf(qq.z, kk.z, s[r]);
        s[r] = fmaf(qq.w, kk.w, s[r]);
      }
    }

    // Online softmax, one row at a time; s[r] becomes the probability.
    const int kp = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = q0 + r0 + r, qp = i + off;
      bool ok = kp < a.sk && i < a.sq;
      if (masked) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && kp > qp - a.window;
      const float sc = s[r] * a.scale;
      const float m_new = fmaxf(m[r], warp_max(ok ? sc : kMinusBig));
      const float alpha = expf(m[r] - m_new);
      const float p = ok ? expf(sc - m_new) : 0.f;
      l[r] = fmaf(l[r], alpha, warp_sum(p));
      m[r] = m_new;
#pragma unroll
      for (int i2 = 0; i2 < DPL; ++i2) acc[r][i2] *= alpha;
      s[r] = p;
    }

    // Weighted sum of the tile's V rows, in key order.
    for (int j = 0; j < kBlockK; ++j) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
      for (int i2 = 0; i2 < DPL; ++i2) {
        const int d = lane + 32 * i2;
        const float vv = d < hd4 ? s_v[j * hd4 + d] : 0.f;
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i2] = fmaf(pj[r], vv, acc[r][i2]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int i = q0 + r0 + r;
    if (i >= a.sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const size_t base = ((static_cast<size_t>(b) * a.sq + i) * a.heads + h) * hd;
#pragma unroll
    for (int i2 = 0; i2 < DPL; ++i2) {
      const int d = lane + 32 * i2;
      if (d < hd) store_f32(out, base + d, acc[r][i2] / den);
    }
  }
}

template <typename T, int DPL>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int hd4 = row4(a.hd);
  const size_t bytes =
      (static_cast<size_t>(kBlockQ) * hd4 + static_cast<size_t>(kBlockK) * kstride(a.hd) +
       static_cast<size_t>(kBlockK) * hd4) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, batch * a.heads);
  flash_attention_kernel<T, DPL><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dpl(const Args& a, int batch, cudaStream_t stream) {
  const int dpl = (a.hd + 31) / 32;
  if (dpl <= 1) return launch<T, 1>(a, batch, stream);
  if (dpl <= 2) return launch<T, 2>(a, batch, stream);
  if (dpl <= 3) return launch<T, 3>(a, batch, stream);
  if (dpl <= 4) return launch<T, 4>(a, batch, stream);
  if (dpl <= 6) return launch<T, 6>(a, batch, stream);
  return launch<T, 8>(a, batch, stream);
}

}  // namespace

// out [B, Sq, H, hd]; q [B, Sq, H, hd]; k, v [B, Sk, Hkv, hd] — contiguous,
// on the current device, fp32 (bf16 = 0) or bf16 (bf16 = 1). hd <= 256,
// H % Hkv == 0, B * H <= 65535, and Sq <= Sk when a mask applies (every
// query row then has a key). Returns a cudaError_t.
extern "C" int repro_flash_attention(void* out, const void* q, const void* k,
                                     const void* v, int bf16, int batch, int sq,
                                     int sk, int heads, int hkv, int hd,
                                     int causal, int window, float scale,
                                     cudaStream_t stream) {
  if (batch <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || heads % hkv != 0 || hd <= 0 ||
      hd > 256 || window < 0 || static_cast<long long>(batch) * heads > 65535 ||
      ((causal || window > 0) && sq > sk))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, out, sq, sk, heads, hkv, hd, causal, window, scale};
  return bf16 ? launch_dpl<__nv_bfloat16>(a, batch, stream)
              : launch_dpl<float>(a, batch, stream);
}

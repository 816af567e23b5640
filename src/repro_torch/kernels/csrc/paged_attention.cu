// paged_attention: one-token decode attention read in place from the packed
// page pool of the serving plane, fp32:
//   out[s, h] = softmax_r(q[s, h] . K[s, r] / sqrt(hd)) . V[s, r]
// over the valid ring rows r of slot s plus the slot's new token, for one
// layer. Pages are [P + 1, T, W] (page P is the null page); row t of page
// `pid` holds one cache token of one slot, and the layer's K (V) block for
// kv head n starts at column k_col + n * hd (v_col + n * hd), with
// k_col = k_off + layer * Hkv * hd. tables [S, PPS] maps slot s's page slot
// j to a page id; pos [S] is each slot's absolute decode position.
//
// Replaces the Pallas kernel src/repro/kernels/paged_attention.py::
// paged_attention (_kernel), called once per layer on every decode step of
// the serving plane (serving/cache.py::PagedKV.attend, via
// models/transformer.py::decode_step_paged).
//
// Masks. With the ring invariant (position p in row p % tokens) row r of a
// slot at position pos holds
//   spos(r) = pos - 1 - ((pos - 1 - r) mod tokens),
// negative for rows never written. A row counts when r < tokens (a last
// page's padded rows drop out when T does not divide tokens), spos >= 0,
// r is not the cursor row pos % tokens, its page is not the null page
// (lazily allocated slots), and, with a window, spos > pos - window. The
// new token's K/V always counts. The cursor-row test is the one place this
// kernel departs from _kernel: once a ring has wrapped (pos >= tokens) the
// cursor row holds position pos - tokens, which _kernel keeps unless a
// window <= tokens drops it, so _kernel attends over tokens + 1 positions
// there while the JAX oracle and the gather -> decode route (which
// overwrite that row with the new token) attend over tokens. This kernel
// computes the oracle's function.
//
// Bound on an H100: memory. A call reads the K and V blocks of the valid
// rows, 2 * hd * 4 bytes per row and kv head, plus q, k_new, v_new, and
// writes out; ~4 flops per K/V element read and query head, against the
// card's ~20 fp32 flops per byte.
//
// Design. A decode step has one query row per head, so there is no matrix
// product to feed tensor cores; the work is a stream of K/V row segments.
// One block of 8 warps per (slot, kv head, group of up to 8 query heads).
// Each warp walks its own rows of the slot's page table (rows w, w + 8,
// ...), U = 4 rows at a time with all their loads issued first, and keeps
// an online softmax (m, l, acc) for its G query heads in registers: lane d
// holds q, acc and the loaded K/V elements d, d + 32, ... of a head (any
// hd <= 256), a row's score is a butterfly shuffle reduction, so the main
// loop has no shared memory and no barrier. At the end the 8 warps' states
// and the new token (scored by warp 0) are merged through shared memory in
// a fixed order: out = acc / max(l, 1e-30). Every sum runs in a fixed
// order and there are no atomics, so two calls on the same inputs are equal
// bit for bit. Masked rows and null pages are never read. Offsets are
// size_t (a full deepseek-7b pool passes 2^31 elements).
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsInFlight = 4;  // U: rows a warp loads before using them
constexpr int kMaxGroup = 8;      // G: query heads per block
constexpr float kMinusBig = -1e30f;

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Is ring row r of a slot at position p counted? (see the header)
__device__ __forceinline__ bool row_counts(int r, int p, int tokens,
                                           int window) {
  if (r >= tokens) return false;
  int md = (p - 1 - r) % tokens;
  if (md < 0) md += tokens;
  const int spos = p - 1 - md;
  return spos >= 0 && md != tokens - 1 && (window <= 0 || spos > p - window);
}

struct Args {
  float* out;
  const float* q;
  const float* k_new;
  const float* v_new;
  const float* pages;
  const int* tables;
  const int* pos;
  int heads, hkv, hd, pps, page_tokens;
  long long width, k_col, v_col;
  int tokens, window, null_page;
  float scale;
};

// G query heads a block (a power of two <= kMaxGroup), DPL = ceil(hd / 32)
// elements of a row per lane.
template <int G, int DPL>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Args a) {
  extern __shared__ float smem[];
  const int s = blockIdx.x, n = blockIdx.y;
  const int g = a.heads / a.hkv;
  const int h0 = blockIdx.z * G;          // first query head of the group
  const int gh = min(G, g - h0);          // heads this block computes
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = a.hd;
  const int p = a.pos[s];

  const float* qbase =
      a.q + (static_cast<size_t>(s) * a.heads + static_cast<size_t>(n) * g + h0) * hd;
  float qr[G][DPL], acc[G][DPL], m[G], l[G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      qr[h][i] = (h < gh && d < hd) ? qbase[h * hd + d] * a.scale : 0.f;
      acc[h][i] = 0.f;
    }
    m[h] = kMinusBig;
    l[h] = 0.f;
  }

  const int* trow = a.tables + static_cast<size_t>(s) * a.pps;
  const size_t page_stride = static_cast<size_t>(a.page_tokens) * a.width;
  const size_t kc = static_cast<size_t>(a.k_col) + static_cast<size_t>(n) * hd;
  const size_t vc = static_cast<size_t>(a.v_col) + static_cast<size_t>(n) * hd;
  const int nrows = min(a.pps * a.page_tokens, a.tokens);

  for (int base = warp; base < nrows; base += kWarps * kRowsInFlight) {
    float kr[kRowsInFlight][DPL], vr[kRowsInFlight][DPL];
    bool ok[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = base + u * kWarps;
      ok[u] = false;
      const float* row = a.pages;
      if (r < nrows && row_counts(r, p, a.tokens, a.window)) {
        const int j = r / a.page_tokens;
        const int pid = trow[j];
        if (pid != a.null_page) {
          ok[u] = true;
          row = a.pages + static_cast<size_t>(pid) * page_stride +
                static_cast<size_t>(r - j * a.page_tokens) * a.width;
        }
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const bool in = ok[u] && d < hd;
        kr[u][i] = in ? row[kc + d] : 0.f;
        vr[u][i] = in ? row[vc + d] : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      if (!ok[u]) continue;               // uniform across the warp
#pragma unroll
      for (int h = 0; h < G; ++h) {
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) dot = fmaf(qr[h][i], kr[u][i], dot);
        dot = warp_allsum(dot);
        const float m_new = fmaxf(m[h], dot);
        const float al = expf(m[h] - m_new);
        const float pr = expf(dot - m_new);
        l[h] = l[h] * al + pr;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[h][i] = fmaf(acc[h][i], al, pr * vr[u][i]);
        m[h] = m_new;
      }
    }
  }

  // Merge: warp states and the new token, in a fixed order.
  float* sm_acc = smem;                                  // [kWarps][G][DPL*32]
  float* sm_m = sm_acc + kWarps * G * DPL * 32;          // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;                       // [kWarps][G]
  float* sm_new = sm_l + kWarps * G;                     // [G] new-token score
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      sm_acc[((warp * G + h) * DPL + i) * 32 + lane] = acc[h][i];
    if (lane == 0) {
      sm_m[warp * G + h] = m[h];
      sm_l[warp * G + h] = l[h];
    }
  }
  const size_t nrow = (static_cast<size_t>(s) * a.hkv + n) * hd;
  if (warp == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) dot = fmaf(qr[h][i], a.k_new[nrow + d], dot);
      }
      dot = warp_allsum(dot);
      if (lane == 0) sm_new[h] = dot;
    }
  }
  __syncthreads();

  float* obase =
      a.out + (static_cast<size_t>(s) * a.heads + static_cast<size_t>(n) * g + h0) * hd;
  for (int e = threadIdx.x; e < gh * DPL * 32; e += kThreads) {
    const int h = e / (DPL * 32);
    const int i = (e / 32) % DPL, ln = e % 32;
    const int d = ln + 32 * i;
    if (d >= hd) continue;
    const float sn = sm_new[h];
    float mx = sn;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + h]);
    float den = expf(sn - mx);
    float num = den * a.v_new[nrow + d];
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w * G + h] - mx);
      den = fmaf(sm_l[w * G + h], c, den);
      num = fmaf(sm_acc[((w * G + h) * DPL + i) * 32 + ln], c, num);
    }
    obase[h * hd + d] = num / fmaxf(den, 1e-30f);
  }
}

template <int G, int DPL>
int launch(const Args& a, int slots, cudaStream_t stream) {
  const int g = a.heads / a.hkv;
  const size_t bytes =
      (static_cast<size_t>(kWarps) * G * DPL * 32 + 2 * kWarps * G + G) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<G, DPL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(slots, a.hkv, (g + G - 1) / G);
  paged_attention_kernel<G, DPL><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int G>
int launch_dpl(const Args& a, int slots, cudaStream_t stream) {
  const int dpl = (a.hd + 31) / 32;
  if (dpl <= 1) return launch<G, 1>(a, slots, stream);
  if (dpl <= 2) return launch<G, 2>(a, slots, stream);
  if (dpl <= 3) return launch<G, 3>(a, slots, stream);
  if (dpl <= 4) return launch<G, 4>(a, slots, stream);
  return launch<G, 8>(a, slots, stream);
}

}  // namespace

// out [S, H, hd]; q [S, H, hd]; k_new, v_new [S, Hkv, hd]; pages
// [P + 1, T, W]; tables [S, PPS] int32; pos [S] int32 (>= 0) — all
// contiguous, fp32 unless noted, on the current device; hd <= 256. Returns
// a cudaError_t.
extern "C" int repro_paged_attention_f32(
    float* out, const float* q, const float* k_new, const float* v_new,
    const float* pages, const int* tables, const int* pos, int slots,
    int heads, int hkv, int hd, int pps, int page_tokens, long long width,
    long long k_col, long long v_col, int tokens, int window, int null_page,
    cudaStream_t stream) {
  if (slots <= 0 || hkv <= 0 || hd <= 0 || hd > 256 || heads % hkv != 0 ||
      pps < 0 || page_tokens <= 0 || tokens <= 0 || hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 1/sqrt(hd) rounded once from double, as the Pallas kernel's Python
  // constant is.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const Args a{out, q, k_new, v_new, pages, tables, pos, heads, hkv, hd, pps,
               page_tokens, width, k_col, v_col, tokens, window, null_page,
               scale};
  const int g = heads / hkv;
  if (g <= 1) return launch_dpl<1>(a, slots, stream);
  if (g <= 2) return launch_dpl<2>(a, slots, stream);
  if (g <= 4) return launch_dpl<4>(a, slots, stream);
  return launch_dpl<kMaxGroup>(a, slots, stream);
}

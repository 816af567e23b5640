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
// card's ~20 fp32 flops per byte. At the serve cell's shape (8 slots, 8 kv
// heads, ~176 valid rows) a call moves ~6.5 MB: under 2 us at 3.35 TB/s,
// so its time is a chain of latencies (launch, a page-table read, the K/V
// reads, the merge) and how much of the card takes part.
//
// Design. A decode step has one query row per head, so there is no matrix
// product to feed tensor cores; the work is a stream of K/V row segments.
// Split-KV: each (slot, kv head) is split into n_split chunks of its rows
// [0, min(pos, tokens)) (the only rows that can hold a token), so work
// follows what a slot really holds; n_split comes from the shapes alone
// (the wrapper's chooser puts about 2 blocks on each SM, in one wave).
// Grid (n_split, kv head x group of up to 8 q heads, slot), 8 warps a
// block. A block first issues every load that does not need the slot's
// position: the position, the slot's page-table row and its q rows, all at
// once (cp.async). Then warp w owns the rows w, w + 8, ... of each
// sub-chunk of up to 64 rows (32 when hd > 128) from end to end, with no
// block barrier: a lane per row resolves its mask and page; the rows' K and
// V segments are copied into shared memory with cp.async, 16 bytes a lane
// (4 when a segment is not 16-byte aligned), all in flight at once; a quad
// of lanes scores each row for all the block's q heads (a K row is read
// once); the warp's online softmax (butterflies across the quads: every
// lane holds the same max and sum) and its weighted sum of the V rows (a V
// row is read once, rows in order) stay in registers. The 8 warps' states
// meet once, in warp order, and the chunk writes its partial (acc, m, l)
// per head to a workspace; a chunk with no valid row writes (0, -1e30, 0),
// which contributes nothing. A second kernel, a thread per (slot, q head,
// element), scores the new token while the chunks finish, then merges the
// chunks in split order, eight chunks' loads in flight at a time:
// out = acc / max(l, 1e-30). Both kernels are programmatic dependent
// launches, so each grid's launch overlaps the tail of the one before it;
// each waits (griddepcontrol.wait) before it reads what that grid writes.
// The loops over a block's q heads run over G = 1, 2, 4 or 8 (the group
// rounded up; the extra heads' q rows are zero and are never written out),
// so they have no branches. Every sum runs in a fixed order and there are
// no atomics, so two calls on the same inputs are equal bit for bit.
// Masked rows and null pages are never read. Offsets are size_t (a full
// deepseek-7b pool passes 2^31 elements).
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMergeThreads = 256;   // >= hd: a thread per element
constexpr int kMaxGroup = 8;      // q heads a block
constexpr int kMergeBatch = 8;    // chunks whose loads the merge keeps in flight
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// global -> shared, asynchronously, N = 4 or 16 bytes; zero-filled when !full.
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool full) {
  if (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(smem_u32(dst)), "l"(src), "r"(full ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

struct Args {
  float* out;
  const float* q;
  const float* k_new;
  const float* v_new;
  const float* pages;
  const int* tables;
  const int* pos;
  float* ws;  // [S, Hkv, n_split, G, hd + 2]: a chunk's (acc[hd], m, l) per head
  int heads, hkv, hd, pps, page_tokens;
  long long width, k_col, v_col;
  int tokens, window, null_page, n_split;
  int sub;    // rows a sub-chunk
  int vec;    // 16-byte copies of K/V (hd, width and column offsets multiples of 4)
  int qvec;   // 16-byte copies of q (hd a multiple of 4, q aligned)
  float scale;
};

// Shared-memory row widths: hdp = hd rounded up to 4 floats; K rows hold
// 4 (mod 8) float4s, so the two rows that a phase of 8 lanes reads (a quad
// on each, 4 consecutive float4s) fall in distinct banks.
__host__ __device__ __forceinline__ int row4(int hd) { return (hd + 3) & ~3; }
__host__ __device__ __forceinline__ int kstride(int hd) {
  const int h4 = row4(hd) / 4;
  return 4 * (h4 + (12 - h4 % 8) % 8);
}

// The split kernel's shared memory, in floats.
__host__ __device__ __forceinline__ size_t split_smem_floats(int hd, int sub, int pps) {
  return static_cast<size_t>(kMaxGroup) * row4(hd) + static_cast<size_t>(sub) * kstride(hd) +
         static_cast<size_t>(sub) * row4(hd) + 2 * kWarps * kMaxGroup + row4(pps);
}

// One chunk of one (slot, kv head, group of q heads): its partial state.
// Warp w owns the rows w, w + 8, ..., w + 56 of every sub-chunk from end to
// end (their pages, copies, scores, softmax and weighted sum), so a
// sub-chunk needs no block barrier; the warps' states meet once, at the end.
// G: the group's q heads rounded up to 1, 2, 4 or 8 (heads past the group's
// own have zero q rows and are never written out), so the loops over heads
// have no branches; DI: float4 columns a lane holds in the weighted sum
// (hd <= 128: 1).
template <int G, int DI>
__global__ void __launch_bounds__(kThreads) paged_split_kernel(const Args a) {
  // Wait for the grid ahead in the stream (its writes may be this call's
  // inputs), then let the merge kernel launch: it scores the new token from
  // those inputs, then waits for this grid to finish.
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd, hdp = row4(hd), u4 = hdp / 4, ks = kstride(hd), sub = a.sub;
  float* s_q = smem;                        // [kMaxGroup][hdp]
  float* s_k = s_q + kMaxGroup * hdp;       // [sub][ks]
  float* s_v = s_k + sub * ks;              // [sub][hdp]
  float* s_red = s_k;                       // [kWarps][kMaxGroup][hdp], at the end
  float* s_ml = s_v + sub * hdp;            // [kWarps][kMaxGroup][2]: each warp's (m, l), then (weight, l)
  int* s_tab = reinterpret_cast<int*>(s_ml + 2 * kWarps * kMaxGroup);  // [pps]

  const int c = blockIdx.x, s = blockIdx.z;
  const int g = a.heads / a.hkv, groups = (g + kMaxGroup - 1) / kMaxGroup;
  const int n = blockIdx.y / groups, h0 = (blockIdx.y % groups) * kMaxGroup;
  const int gh = min(kMaxGroup, g - h0);   // q heads of this block
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane >> 2, part = lane & 3;

  // Everything that does not depend on the position, in flight at once:
  // the position, the slot's page-table row, the group's q rows.
  const int p = a.pos[s];
  const int* trow = a.tables + static_cast<size_t>(s) * a.pps;
  for (int j = tid; j < a.pps; j += kThreads) cp_async<4>(s_tab + j, trow + j, true);
  const float* qbase = a.q + (static_cast<size_t>(s) * a.heads + static_cast<size_t>(n) * g + h0) * hd;
  if (a.qvec) {
    for (int e = tid; e < kMaxGroup * u4; e += kThreads) {
      const int h = e / u4, d = (e % u4) * 4;
      cp_async<16>(s_q + h * hdp + d, qbase + (h < gh ? h * hd + d : 0), h < gh);
    }
  } else {
    for (int e = tid; e < kMaxGroup * hdp; e += kThreads) {
      const int h = e / hdp, d = e % hdp;
      const bool in = h < gh && d < hd;
      cp_async<4>(s_q + e, qbase + (in ? h * hd + d : 0), in);
    }
  }
  cp_async_wait_all();

  // The chunk: rows [0, min(pos, tokens)) (rows past them hold no token
  // yet) cut into n_split runs of ceil(rows / n_split).
  const int rows = min(min(a.pps * a.page_tokens, a.tokens), p);
  const int len = (rows + a.n_split - 1) / a.n_split;
  const int r_beg = min(rows, c * len), r_end = min(rows, r_beg + len);
  const size_t page_stride = static_cast<size_t>(a.page_tokens) * a.width;
  const size_t kc = static_cast<size_t>(a.k_col) + static_cast<size_t>(n) * hd;
  const size_t vc = static_cast<size_t>(a.v_col) + static_cast<size_t>(n) * hd;
  __syncthreads();    // s_tab and s_q are in

  // This warp's running state: (m, l) per head (the same in every lane)
  // and the weighted sum, lane l holding the float4 columns l + 32i.
  float m_w[G], l_w[G];
  float4 acc[DI][G];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m_w[h] = kMinusBig;
    l_w[h] = 0.f;
#pragma unroll
    for (int i = 0; i < DI; ++i) acc[i][h] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int r0 = r_beg; r0 < r_end; r0 += sub) {
    const int nsub = min(sub, r_end - r0);
    const int mine = (nsub - warp + kWarps - 1) / kWarps;  // this warp's rows: warp + 8q, q < mine
    if (mine <= 0) continue;
    // Lane q < 8 resolves row warp + 8q: its offset in the pool, or -1
    // when it is masked or on the null page.
    long long at = -1;
    if (lane < mine) {
      const int r = r0 + warp + kWarps * lane;
      if (row_counts(r, p, a.tokens, a.window)) {
        const int jp = r / a.page_tokens;
        const int pid = s_tab[jp];
        if (pid != a.null_page)
          at = static_cast<long long>(static_cast<size_t>(pid) * page_stride +
                                      static_cast<size_t>(r - jp * a.page_tokens) * a.width);
      }
    }
    __syncwarp();     // the previous sub-chunk's reads of these rows are done
    // The rows' K and V segments, all in flight at once; zeros for rows
    // that do not count and for the padding columns.
    for (int q = 0; q < mine; ++q) {
      const int j = warp + kWarps * q;
      const long long aq = __shfl_sync(0xffffffffu, at, q);
      const float* row = a.pages + (aq >= 0 ? aq : 0);
      if (a.vec) {
        for (int d = 4 * lane; d < hdp; d += 128) {
          cp_async<16>(s_k + j * ks + d, row + (aq >= 0 ? kc + d : 0), aq >= 0);
          cp_async<16>(s_v + j * hdp + d, row + (aq >= 0 ? vc + d : 0), aq >= 0);
        }
      } else {
        for (int d = lane; d < hdp; d += 32) {
          const bool full = aq >= 0 && d < hd;
          cp_async<4>(s_k + j * ks + d, row + (full ? kc + d : 0), full);
          cp_async<4>(s_v + j * hdp + d, row + (full ? vc + d : 0), full);
        }
      }
    }
    cp_async_wait_all();
    __syncwarp();     // every lane's copies are visible to the warp

    // Scores: quad q scores row warp + 8q, each lane over every fourth
    // float4 of it, for all heads at once; the quad's partial sums meet in
    // two shuffles. -inf for rows that do not count.
    const long long aq = __shfl_sync(0xffffffffu, at, quad);
    const bool ok = quad < mine && aq >= 0;
    const float4* kr = reinterpret_cast<const float4*>(s_k + (ok ? warp + kWarps * quad : warp) * ks);
    float x[G];
#pragma unroll
    for (int h = 0; h < G; ++h) x[h] = 0.f;
    for (int d4 = part; d4 < u4; d4 += 4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int h = 0; h < G; ++h) {
        const float4 qq = reinterpret_cast<const float4*>(s_q + h * hdp)[d4];
        x[h] = fmaf(qq.x, kk.x, x[h]);
        x[h] = fmaf(qq.y, kk.y, x[h]);
        x[h] = fmaf(qq.z, kk.z, x[h]);
        x[h] = fmaf(qq.w, kk.w, x[h]);
      }
    }
    // Online softmax over the warp's rows (butterflies across the quads:
    // every lane ends with the same max and sum), then the weighted sum of
    // its V rows in order, all heads at once (a V row is read once).
    float pr[G];
#pragma unroll
    for (int h = 0; h < G; ++h) {
      x[h] += __shfl_xor_sync(0xffffffffu, x[h], 1);
      x[h] += __shfl_xor_sync(0xffffffffu, x[h], 2);
      const float sc = ok ? x[h] * a.scale : -INFINITY;
      float mx = sc;
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m_w[h], mx);
      const float alpha = expf(m_w[h] - m_new);
      pr[h] = expf(sc - m_new);
      float sum = pr[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      sum += __shfl_xor_sync(0xffffffffu, sum, 8);
      sum += __shfl_xor_sync(0xffffffffu, sum, 16);
      l_w[h] = fmaf(l_w[h], alpha, sum);
      m_w[h] = m_new;
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        acc[i][h].x *= alpha;
        acc[i][h].y *= alpha;
        acc[i][h].z *= alpha;
        acc[i][h].w *= alpha;
      }
    }
    for (int q = 0; q < mine; ++q) {
      const int j = warp + kWarps * q;
      float pq[G];
#pragma unroll
      for (int h = 0; h < G; ++h) pq[h] = __shfl_sync(0xffffffffu, pr[h], 4 * q);
#pragma unroll
      for (int i = 0; i < DI; ++i) {
        const int d4 = lane + 32 * i;
        if (d4 < u4) {
          const float4 vv = reinterpret_cast<const float4*>(s_v + j * hdp)[d4];
#pragma unroll
          for (int h = 0; h < G; ++h) {
            acc[i][h].x = fmaf(pq[h], vv.x, acc[i][h].x);
            acc[i][h].y = fmaf(pq[h], vv.y, acc[i][h].y);
            acc[i][h].z = fmaf(pq[h], vv.z, acc[i][h].z);
            acc[i][h].w = fmaf(pq[h], vv.w, acc[i][h].w);
          }
        }
      }
    }
  }
  __syncthreads();    // every warp is done with K and V (s_red reuses them)

  // The warps' states meet in warp order: M = max m_w, and acc and l as
  // sums of each warp's scaled by exp(m_w - M); then the chunk's partial
  // state per head is written: (acc[hd], m, l).
#pragma unroll
  for (int h = 0; h < G; ++h) {
#pragma unroll
    for (int i = 0; i < DI; ++i) {
      const int d4 = lane + 32 * i;
      if (d4 < u4) reinterpret_cast<float4*>(s_red + (warp * kMaxGroup + h) * hdp)[d4] = acc[i][h];
    }
    if (lane == 0) {
      s_ml[(warp * kMaxGroup + h) * 2] = m_w[h];
      s_ml[(warp * kMaxGroup + h) * 2 + 1] = l_w[h];
    }
  }
  __syncthreads();
  // Each warp's weight exp(m_w - M) per head, once; then (acc, m, l).
  const size_t gs = static_cast<size_t>(hd) + 2;
  float* w = a.ws + (((static_cast<size_t>(s) * a.hkv + n) * a.n_split + c) * g + h0) * gs;
  if (tid < gh) {
    float mx = kMinusBig;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) mx = fmaxf(mx, s_ml[(r * kMaxGroup + tid) * 2]);
    float l = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) {
      const float f = expf(s_ml[(r * kMaxGroup + tid) * 2] - mx);
      l = fmaf(s_ml[(r * kMaxGroup + tid) * 2 + 1], f, l);
      s_ml[(r * kMaxGroup + tid) * 2] = f;
    }
    w[tid * gs + hd] = mx;
    w[tid * gs + hd + 1] = l;
  }
  __syncthreads();
  for (int e = tid; e < gh * hd; e += kThreads) {
    const int h = e / hd, d = e % hd;
    float x = 0.f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r)
      x = fmaf(s_red[(r * kMaxGroup + h) * hdp + d], s_ml[(r * kMaxGroup + h) * 2], x);
    w[h * gs + d] = x;
  }
}

// The new token and the chunks' partial states of one (slot, q head),
// merged in split order: a thread per element.
__global__ void __launch_bounds__(kMergeThreads) paged_merge_kernel(const Args a) {
  __shared__ float s_dot[kMergeThreads / 32];
  const int hq = blockIdx.x, s = blockIdx.y;
  const int g = a.heads / a.hkv, n = hq / g;
  const int hd = a.hd, d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const size_t nrow = (static_cast<size_t>(s) * a.hkv + n) * hd;

  // The new token's score, while the split kernel runs (inputs only): the
  // products, a butterfly in each warp, the warps in order.
  float x = d < hd ? a.q[(static_cast<size_t>(s) * a.heads + hq) * hd + d] * a.k_new[nrow + d]
                   : 0.f;
  x = warp_allsum(x);
  if (lane == 0) s_dot[warp] = x;
  const float vn = d < hd ? a.v_new[nrow + d] : 0.f;
  __syncthreads();
  float dot = 0.f;
  for (int w = 0; w < (hd + 31) / 32; ++w) dot += s_dot[w];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the chunks are written
  if (d >= hd) return;

  const size_t gs = static_cast<size_t>(hd) + 2;
  const float* w = a.ws + ((static_cast<size_t>(s) * a.hkv + n) * a.n_split * g + hq % g) * gs;
  const size_t cstride = static_cast<size_t>(g) * gs;   // one chunk to the next
  // Running (max, denominator, numerator), starting from the new token.
  float mx = dot * a.scale, den = 1.f, num = vn;
  for (int c0 = 0; c0 < a.n_split; c0 += kMergeBatch) {
    float m[kMergeBatch], l[kMergeBatch], xs[kMergeBatch];
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const bool in = c0 + u < a.n_split;
      const float* wc = w + (in ? (c0 + u) * cstride : 0);
      m[u] = in ? wc[hd] : kMinusBig;
      l[u] = in ? wc[hd + 1] : 0.f;
      xs[u] = in ? wc[d] : 0.f;
    }
    float bm = mx;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) bm = fmaxf(bm, m[u]);
    const float f = expf(mx - bm);
    den *= f;
    num *= f;
#pragma unroll
    for (int u = 0; u < kMergeBatch; ++u) {
      const float fu = expf(m[u] - bm);
      den = fmaf(l[u], fu, den);
      num = fmaf(xs[u], fu, num);
    }
    mx = bm;
  }
  a.out[(static_cast<size_t>(s) * a.heads + hq) * hd + d] = num / fmaxf(den, 1e-30f);
}

using SplitKernel = void (*)(Args);

// The split kernel's instance for a padded group size and columns a lane.
SplitKernel pick_split(int g, int di) {
  if (di == 1) {
    if (g == 1) return paged_split_kernel<1, 1>;
    if (g == 2) return paged_split_kernel<2, 1>;
    if (g == 4) return paged_split_kernel<4, 1>;
    return paged_split_kernel<8, 1>;
  }
  if (g == 1) return paged_split_kernel<1, 2>;
  if (g == 2) return paged_split_kernel<2, 2>;
  if (g == 4) return paged_split_kernel<4, 2>;
  return paged_split_kernel<8, 2>;
}

}  // namespace

// out [S, H, hd]; q [S, H, hd]; k_new, v_new [S, Hkv, hd]; pages
// [P + 1, T, W]; tables [S, PPS] int32; pos [S] int32 (>= 0); ws [S, Hkv,
// n_split, H / Hkv, hd + 2] scratch — all contiguous, fp32 unless noted, on
// the current device; hd <= 256, n_split >= 1. Returns a cudaError_t.
extern "C" int repro_paged_attention_f32(
    float* out, const float* q, const float* k_new, const float* v_new,
    const float* pages, const int* tables, const int* pos, float* ws, int slots,
    int heads, int hkv, int hd, int pps, int page_tokens, long long width,
    long long k_col, long long v_col, int tokens, int window, int null_page,
    int n_split, cudaStream_t stream) {
  if (slots <= 0 || slots > 65535 || hkv <= 0 || hd <= 0 || hd > 256 ||
      heads % hkv != 0 || pps < 0 || page_tokens <= 0 || tokens <= 0 || n_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int g = heads / hkv, groups = (g + kMaxGroup - 1) / kMaxGroup;
  if (static_cast<long long>(hkv) * groups > 65535 || heads > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  const int sub = hd <= 128 ? 64 : 32;
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const int vec = hd % 4 == 0 && width % 4 == 0 && k_col % 4 == 0 && v_col % 4 == 0 &&
                  aligned(pages);
  const int qvec = hd % 4 == 0 && aligned(q);
  // 1/sqrt(hd) rounded once from double, as the Pallas kernel's Python
  // constant is.
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(hd)));
  const Args a{out, q, k_new, v_new, pages, tables, pos, ws, heads, hkv, hd, pps,
               page_tokens, width, k_col, v_col, tokens, window, null_page,
               n_split, sub, vec, qvec, scale};
  const size_t bytes = split_smem_floats(hd, sub, pps) * sizeof(float);
  const int gmax = min(g, kMaxGroup);
  const auto split = pick_split(gmax <= 1 ? 1 : gmax <= 2 ? 2 : gmax <= 4 ? 4 : 8, hd <= 128 ? 1 : 2);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Both kernels are programmatic dependent launches: a grid's blocks may
  // start before the grid ahead of it in the stream ends, and wait for it
  // (griddepcontrol.wait) before they read anything it may write.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.stream = stream;
  cfg.gridDim = dim3(n_split, hkv * groups, slots);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cudaError_t err = cudaLaunchKernelEx(&cfg, split, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.gridDim = dim3(heads, slots);
  cfg.blockDim = dim3((hd + 31) / 32 * 32);
  cfg.dynamicSmemBytes = 0;
  err = cudaLaunchKernelEx(&cfg, paged_merge_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

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
// Here the sequential kv axis becomes a loop inside each block.
//
// Bound on an H100: max(FLOPs / peak, bytes / 3.35 TB/s), with FLOPs =
// 4 * B * H * hd * (attended q.k pairs) (scores and weighted sum, two flops
// a multiply-add) and bytes = q, k, v and out once. At training and prefill
// lengths the operations bound it: the bf16 tensor-core rate for bf16
// operands, the fp32 rate for fp32 ones.
//
// bf16 operands: the tensor cores (flash_mma_kernel). One block of 4 warps
// per 64 query rows of one (batch, q head); a warp owns 16 rows. (A block
// per kv head serving its whole GQA group from one K/V tile measured slower
// on the H100, as did two m16 tiles a warp, for its registers.) K and V
// stream through shared memory in tiles of 64 keys (32 when hd > 128),
// double-buffered with cp.async; rows
// are padded by 16 bytes so ldmatrix reads hit distinct banks. S = Q.K^T
// and O += P.V run as mma.sync m16n8k16 (bf16 in, fp32 accumulate), fed by
// ldmatrix (.trans for V). The online softmax works on the S fragments in
// registers: a thread holds two rows, and a row's max and sum are shuffles
// within its quad of lanes, in a fixed order. P stays exact: the m16n8 C
// fragment of S is the k16 A fragment of P, fed as a bf16 pair hi = bf16(p),
// lo = bf16(p - hi) in two products against the same V tile, so P.V keeps
// about 16 bits of p (products exact, fp32 sums) and the kernel computes the
// TPU kernel's function, which upcasts to fp32. The hd axis is zero-padded
// to a multiple of 16 in shared memory (hd 80: 5 k16 steps, 10 n8 tiles);
// keys past Sk are zero-filled and masked. Blocks of the last query rows,
// which attend over the most keys, launch first; a key tile empty for every
// row of a block is never loaded, and one empty for every row of a warp is
// skipped by that warp (a no-op on its state).
//
// fp32 operands: the fp32 pipes (flash_attention_kernel), since tensor
// cores would mean TF32, a different result. One block of 8 warps per
// (batch x head, tile of 32 query rows); the kv sweep is a loop over key
// tiles of 32 rows staged through shared memory; the query tile sits in
// shared memory for the whole sweep. A warp owns 4 query rows and lane j
// scores key j of the tile against them (float4 reads: the query row is a
// broadcast, K rows are padded to an odd number of float4s so the lanes hit
// distinct banks); the row max and sum are warp butterflies, which leave
// every lane with the same bits. The running (m, l, acc) stay in fp32
// registers: lane d holds acc elements d, d + 32, ... of its rows (any hd
// <= 256). Masked keys get probability 0 outright; key tiles that the
// causal or window mask leaves empty for every row of the block are never
// loaded.
//
// Both: the output is acc / max(l, 1e-30), as the TPU kernel divides. Every
// sum runs in a fixed order and there are no atomics, so two calls on the
// same inputs are equal bit for bit. The ragged ends of Sq, Sk and hd are
// masked here, so no shape needs padding by the caller. Offsets are size_t.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;                  // R: query rows a warp owns
constexpr int kBlockQ = kWarps * kRowsPerWarp;   // query rows a block
constexpr int kBlockK = 32;                      // key rows a tile, one a lane
constexpr float kMinusBig = -1e30f;

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
  int vec;  // bf16 path: 16-byte copies (hd % 8 == 0, aligned bases)
};

// Shared-memory row widths: hd4 = hd rounded up to a float4; K rows hold an
// odd number of float4s (conflict-free float4 reads across lanes).
__host__ __device__ __forceinline__ int row4(int hd) { return (hd + 3) & ~3; }
__host__ __device__ __forceinline__ int kstride(int hd) {
  const int h4 = row4(hd);
  return ((h4 / 4) % 2) ? h4 : h4 + 4;
}

// fp32 operands on the fp32 pipes; DPL = ceil(hd / 32) acc elements a lane.
template <int DPL>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd, hd4 = row4(hd), ks = kstride(hd);
  float* s_q = smem;                        // [kBlockQ][hd4]
  float* s_k = s_q + kBlockQ * hd4;         // [kBlockK][ks]
  float* s_v = s_k + kBlockK * ks;          // [kBlockK][hd4]

  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  float* out = static_cast<float*>(a.out);

  const int bh = blockIdx.y;
  const int b = bh / a.heads, h = bh % a.heads;
  const int n = h / (a.heads / a.hkv);      // the kv head this q head reads
  const int q0 = blockIdx.x * kBlockQ;
  const int off = a.sk - a.sq;              // q row i is at position i + off
  const bool masked = a.causal || a.window > 0;

  for (int e = threadIdx.x; e < kBlockQ * hd4; e += kThreads) {
    const int r = e / hd4, d = e % hd4, i = q0 + r;
    s_q[e] = (i < a.sq && d < hd)
        ? q[((static_cast<size_t>(b) * a.sq + i) * a.heads + h) * hd + d]
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
        kx = k[idx];
        vx = v[idx];
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
      if (d < hd) out[base + d] = acc[r][i2] / den;
    }
  }
}

template <int DPL>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const int hd4 = row4(a.hd);
  const size_t bytes =
      (static_cast<size_t>(kBlockQ) * hd4 + static_cast<size_t>(kBlockK) * kstride(a.hd) +
       static_cast<size_t>(kBlockK) * hd4) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, batch * a.heads);
  flash_attention_kernel<DPL><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_dpl(const Args& a, int batch, cudaStream_t stream) {
  const int dpl = (a.hd + 31) / 32;
  if (dpl <= 1) return launch<1>(a, batch, stream);
  if (dpl <= 2) return launch<2>(a, batch, stream);
  if (dpl <= 3) return launch<3>(a, batch, stream);
  if (dpl <= 4) return launch<4>(a, batch, stream);
  if (dpl <= 6) return launch<6>(a, batch, stream);
  return launch<8>(a, batch, stream);
}

// ---- bf16 operands: tensor cores -----------------------------------------

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows a block: 16 a warp

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !full.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b: m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x0, x1) -> bf16 pairs hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split(float x0, float x1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// hd padded to HDP (a multiple of 16); BK keys a tile.
template <int HDP, int BK>
__global__ void __launch_bounds__(kThreads) flash_mma_kernel(const Args a) {
  constexpr int LDS = HDP + 8;      // shared row stride: 16 B of padding
  constexpr int CH = HDP / 8;       // 16-byte chunks a row
  constexpr int NS = BK / 8;        // n8 tiles of a warp's S
  constexpr int KQ = HDP / 16;      // k16 steps of Q.K^T
  constexpr int NO = HDP / 8;       // n8 tiles of a warp's O
  constexpr bool kQRegs = HDP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kRows][LDS]
  __nv_bfloat16* s_k = s_q + kRows * LDS;                           // [2][BK][LDS]
  __nv_bfloat16* s_v = s_k + 2 * BK * LDS;                          // [2][BK][LDS]

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  const int hd = a.hd, g = a.heads / a.hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The block's batch, q head, kv head and first query row; the last
  // rows (the most keys) have the lowest blockIdx.y.
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads, n = h / g;
  const int i0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int nrows = min(kRows, a.sq - i0);          // rows that exist

  const int off = a.sk - a.sq;                       // row i at position i + off
  const bool masked = a.causal || a.window > 0;
  const int kend = masked ? min(a.sk, i0 + nrows - 1 + off + 1) : a.sk;
  const int kbeg = a.window > 0 ? max(0, i0 + off - a.window + 1) : 0;
  const int t_beg = kbeg / BK, t_end = (kend + BK - 1) / BK;

  // Q tile -> shared (zero rows past the block's rows, zero columns past hd).
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    __nv_bfloat16* dst = s_q + r * LDS + c;
    const bool ok = r < nrows && c < hd;
    const size_t src =
        ok ? ((static_cast<size_t>(b) * a.sq + i0 + r) * a.heads + h) * hd + c : 0;
    if (a.vec) {
      cp_async16(dst, q + src, ok);
    } else {
#pragma unroll
      for (int x = 0; x < 8; ++x) dst[x] = (ok && c + x < hd) ? q[src + x] : zero;
    }
  }
  // K and V tile t -> buffer buf (zero rows past Sk, zero columns past hd).
  auto load_kv = [&](int t, int buf) {
    __nv_bfloat16* dk = s_k + buf * BK * LDS;
    __nv_bfloat16* dv = s_v + buf * BK * LDS;
    for (int e = tid; e < BK * CH; e += kThreads) {
      const int j = e / CH, c = (e % CH) * 8, kj = t * BK + j;
      const bool ok = kj < a.sk && c < hd;
      const size_t src = ok ? ((static_cast<size_t>(b) * a.sk + kj) * a.hkv + n) * hd + c : 0;
      if (a.vec) {
        cp_async16(dk + j * LDS + c, k + src, ok);
        cp_async16(dv + j * LDS + c, v + src, ok);
      } else {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const bool in = ok && c + x < hd;
          dk[j * LDS + c + x] = in ? k[src + x] : zero;
          dv[j * LDS + c + x] = in ? v[src + x] : zero;
        }
      }
    }
  };

  // This warp's rows: positions [w_lo, w_hi]; this thread's two rows
  // (lane / 4 and lane / 4 + 8 of the warp's 16) at positions pa, pb.
  const int wr0 = warp * 16;
  const bool w_any = wr0 < nrows;
  const int w_lo = i0 + wr0 + off;
  const int w_hi = i0 + min(wr0 + 15, nrows - 1) + off;
  const int ra = wr0 + (lane >> 2);
  const int pa = i0 + ra + off, pb = pa + 8;
  const int cq = 2 * (lane & 3);                     // this thread's first column in an n8 tile

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float ma = kMinusBig, mb = kMinusBig, la = 0.f, lb = 0.f;
  unsigned qf[kQRegs ? KQ : 1][4];

  load_kv(t_beg, 0);
  cp_async_commit();
  for (int t = t_beg; t < t_end; ++t) {
    const int buf = (t - t_beg) & 1;
    if (t + 1 < t_end) {
      load_kv(t + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and, the first time, Q) is in shared memory
    if constexpr (kQRegs) {
      if (t == t_beg) {
#pragma unroll
        for (int kq = 0; kq < KQ; ++kq)
          ldsm_x4(qf[kq], s_q + (wr0 + (lane & 15)) * LDS + kq * 16 + (lane >> 4) * 8);
      }
    }
    const int k0 = t * BK;
    const bool skip = !w_any || (masked && k0 > w_hi) ||
                      (a.window > 0 && k0 + BK - 1 <= w_lo - a.window);
    if (!skip) {
      const __nv_bfloat16* tk = s_k + buf * BK * LDS;
      const __nv_bfloat16* tv = s_v + buf * BK * LDS;
      // S = Q . K^T for the warp's 16 rows and the tile's BK keys.
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
        unsigned af[4];
        if constexpr (kQRegs) {
#pragma unroll
          for (int x = 0; x < 4; ++x) af[x] = qf[kq][x];
        } else {
          ldsm_x4(af, s_q + (wr0 + (lane & 15)) * LDS + kq * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int jp = 0; jp < NS / 2; ++jp) {
          unsigned kb[4];
          ldsm_x4(kb, tk + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS + kq * 16 +
                          ((lane >> 3) & 1) * 8);
          mma(s[2 * jp], af, kb[0], kb[1]);
          mma(s[2 * jp + 1], af, kb[2], kb[3]);
        }
      }
      // Online softmax on the fragments: s[j][0..1] are row ra, s[j][2..3]
      // row ra + 8, keys k0 + 8j + cq + {0, 1}. Masked scores are -inf.
      const bool edge = k0 + BK > a.sk || (masked && k0 + BK - 1 > w_lo) ||
                        (a.window > 0 && k0 <= w_hi - a.window);
      float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * a.scale;
          if (edge) {
            const int kj = k0 + 8 * j + cq + (e & 1), p = e < 2 ? pa : pb;
            bool ok = kj < a.sk;
            if (masked) ok = ok && kj <= p;
            if (a.window > 0) ok = ok && kj > p - a.window;
            if (!ok) x = -INFINITY;
          }
          s[j][e] = x;
          if (e < 2) xa = fmaxf(xa, x); else xb = fmaxf(xb, x);
        }
      }
      const float na = fmaxf(ma, quad_max(xa)), nb = fmaxf(mb, quad_max(xb));
      const float alpha_a = __expf(ma - na), alpha_b = __expf(mb - nb);
      float sa = 0.f, sb = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = __expf(s[j][0] - na);
        s[j][1] = __expf(s[j][1] - na);
        s[j][2] = __expf(s[j][2] - nb);
        s[j][3] = __expf(s[j][3] - nb);
        sa += s[j][0];
        sa += s[j][1];
        sb += s[j][2];
        sb += s[j][3];
      }
      la = fmaf(la, alpha_a, quad_sum(sa));
      lb = fmaf(lb, alpha_b, quad_sum(sb));
      ma = na;
      mb = nb;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][0] *= alpha_a;
        o[j][1] *= alpha_a;
        o[j][2] *= alpha_b;
        o[j][3] *= alpha_b;
      }
      // O += P . V: the S fragments of keys 16kk..16kk+15 are the A
      // fragment of P, fed as hi and lo bf16 parts.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned ph[4], pl[4];
        split(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
        split(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
        split(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
        split(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < NO / 2; ++dp) {
          unsigned vb[4];
          ldsm_x4_t(vb, tv + (kk * 16 + (lane & 15)) * LDS + dp * 16 + (lane >> 4) * 8);
          mma(o[2 * dp], ph, vb[0], vb[1]);
          mma(o[2 * dp], pl, vb[0], vb[1]);
          mma(o[2 * dp + 1], ph, vb[2], vb[3]);
          mma(o[2 * dp + 1], pl, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with buffer buf
  }
  cp_async_wait<0>();

  const float da = fmaxf(la, 1e-30f), db = fmaxf(lb, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = ra + 8 * half;
    if (r >= nrows) continue;
    const float den = half ? db : da;
    __nv_bfloat16* orow =
        out + ((static_cast<size_t>(b) * a.sq + i0 + r) * a.heads + h) * hd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = 8 * j + cq;
      if (c >= hd) continue;
      const float x0 = o[j][2 * half] / den, x1 = o[j][2 * half + 1] / den;
      if (a.vec) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(x0, x1);
      } else {
        orow[c] = __float2bfloat16(x0);
        if (c + 1 < hd) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int HDP>
int launch_mma(const Args& a, int batch, cudaStream_t stream) {
  constexpr int BK = HDP <= 128 ? 64 : 32;
  const size_t bytes =
      (static_cast<size_t>(kRows) + 4 * BK) * (HDP + 8) * sizeof(__nv_bfloat16);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_mma_kernel<HDP, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (a.sq + kRows - 1) / kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(batch * a.heads, tiles);
  flash_mma_kernel<HDP, BK><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_hd(const Args& a, int batch, cudaStream_t stream) {
  if (a.hd <= 32) return launch_mma<32>(a, batch, stream);
  if (a.hd <= 64) return launch_mma<64>(a, batch, stream);
  if (a.hd <= 80) return launch_mma<80>(a, batch, stream);
  if (a.hd <= 96) return launch_mma<96>(a, batch, stream);
  if (a.hd <= 128) return launch_mma<128>(a, batch, stream);
  if (a.hd <= 160) return launch_mma<160>(a, batch, stream);
  if (a.hd <= 192) return launch_mma<192>(a, batch, stream);
  return launch_mma<256>(a, batch, stream);
}

}  // namespace tc

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
  // 16-byte copies need hd % 8 == 0 and 16-byte aligned bases.
  const auto aligned = [](const void* p) {
    return reinterpret_cast<size_t>(p) % 16 == 0;
  };
  const int vec = hd % 8 == 0 && aligned(q) && aligned(k) && aligned(v) && aligned(out);
  const Args a{q, k, v, out, sq, sk, heads, hkv, hd, causal, window, scale, vec};
  if (!bf16) return launch_dpl(a, batch, stream);
  return tc::launch_hd(a, batch, stream);
}

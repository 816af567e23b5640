// fused_update: EF split + weighted stale delivery + Adam in one pass over
// flat fp32 [D] views.
//
// Replaces the Pallas kernel src/repro/kernels/fused_update.py::fused_update
// (_kernel_plain, _kernel_ef, _kernel_ef_mom), the megakernel tail of the
// gradient-ring modes (core/stale_sync.py: fused_tail, and the compressed
// sync tail). For every element of D it
//   1. (ef) splits the R accumulator rows against their thresholds,
//      keep = |acc| >= thr[r], sent = keep ? acc : 0, resid = acc - sent,
//      and (ef_mom) zeroes the DGC momentum where keep holds;
//   2. delivers u = sum_r w[r] * delivered[r], where delivered[r] is this
//      step's sent[r] for a fresh row (fresh[r] > 0, or every row when
//      fresh is null) and the gathered ring row stale[r] otherwise;
//   3. runs bias-corrected Adam on (p, m, v) with u as the gradient and the
//      LR factor multiplied in last: p' = p - scale * update.
//
// Bound on an H100: memory. Per element of D a call reads p, m, v and the
// ring rows it delivers (all R for `plain`; with EF only the R - F rows that
// are not fresh, since a fresh row delivers sent), plus R accumulator rows
// (plus R momentum rows), and writes p', m', v' and u (plus R sent and R
// resid rows, plus R momentum rows), against ~15 + 3R flops: under one flop
// per byte. At R = 8, D = 335,872 that is 15 D floats for `plain` (20.2 MB,
// 6.0 us at 3.35 TB/s); with F = 4 fresh rows 7 D + 3 R D + (R - F) D for
// `ef` (47.0 MB, 14.0 us) and that plus 2 R D for `ef_mom` (68.5 MB,
// 20.5 us); the sync tail's single always-fresh row (R = 1, no ring) moves
// 10 D (13.4 MB, 4.0 us).
//
// Design: every operand is read once and every output written once, and a
// ring row is read only where it is delivered (fresh is per row, so the
// branch is the same for a whole warp); the split, the delivery and the
// Adam step stay in registers. One thread owns
// a 16-byte chunk of D and loops over the R rows in a fixed order, so u is
// the same sum on every run, with no atomics. weights, thr, fresh and scale
// come in as device pointers, because the engine computes them on the device
// every step (the realized delays, the top-k threshold, the LR factor):
// passing them by value would force a host sync per step. The Adam scalars
// come by value from kernels/ref.py::adam_scalars. Every operation is an
// explicitly rounded intrinsic in the plain version's order (no contracted
// multiply-add), so sent + resid == acc bit for bit and the rest tracks the
// plain version op for op. 128-bit loads and stores run where D is a
// multiple of 4 and every pointer is 16-byte aligned; otherwise the scalar
// variant runs. Both walk D in a grid-stride loop whose bound masks the
// ragged tail, with size_t offsets.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 8192;

struct AdamScalars {
  float lr, b1, b2, eps, omb1, omb2, bc1, bc2;
};

// Null pointers mark the operands a variant does not use.
struct Operands {
  const float* p;
  const float* m;
  const float* v;
  const float* stale;    // [R, D]; null with EF when fresh is null
  const float* weights;  // [R]
  const float* acc;      // [R, D] (ef)
  const float* thr;      // [R] (ef)
  const float* fresh;    // [R] (ef); null: every row is fresh
  const float* mom;      // [R, D] (ef_mom)
  const float* scale;    // [1]
  float* p_out;
  float* m_out;
  float* v_out;
  float* u_out;
  float* sent_out;   // [R, D] (ef)
  float* resid_out;  // [R, D] (ef)
  float* mom_out;    // [R, D] (ef_mom)
  int rows;
  size_t d;
};

__device__ __forceinline__ void adam_one(float p, float m, float v, float u,
                                         float scale, const AdamScalars& s,
                                         float* p_out, float* m_out,
                                         float* v_out) {
  const float m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, u));
  const float v2 =
      __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, u), u));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, s.bc2)), s.eps);
  const float update = __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(m2, s.bc1)), denom);
  *p_out = __fsub_rn(p, __fmul_rn(scale, update));
  *m_out = m2;
  *v_out = v2;
}

// One row's value for one element: the split and the momentum mask where
// the variant has them, and the value the row delivers (sent for a fresh
// row, whose ring value st the caller leaves unloaded).
template <bool EF, bool MOM>
__device__ __forceinline__ float row_one(float st, float a, float t,
                                         bool fresh, float mo, float* sent,
                                         float* resid, float* mom_new) {
  if (!EF) return st;
  const bool keep = fabsf(a) >= t;
  const float s = keep ? a : 0.f;
  *sent = s;
  *resid = __fsub_rn(a, s);
  if (MOM) *mom_new = keep ? 0.f : mo;
  return fresh ? s : st;
}

// Is row r fresh? Only EF has fresh rows; a null fresh marks every row.
template <bool EF>
__device__ __forceinline__ bool row_fresh(const float* fresh, int r) {
  return EF && (fresh == nullptr || __ldg(fresh + r) > 0.f);
}

template <bool EF, bool MOM>
__global__ void fused_update_vec4(Operands o, AdamScalars s) {
  const size_t n4 = o.d / 4;
  const float scale = __ldg(o.scale);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < o.rows; ++r) {
      const size_t off = static_cast<size_t>(r) * n4 + i;
      const float w = __ldg(o.weights + r);
      const bool fr = row_fresh<EF>(o.fresh, r);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f), st = a, mo = a, se = a,
             re = a, mn = a;
      if (!fr) st = __ldg(reinterpret_cast<const float4*>(o.stale) + off);
      float t = 0.f;
      if (EF) {
        a = __ldg(reinterpret_cast<const float4*>(o.acc) + off);
        t = __ldg(o.thr + r);
      }
      if (MOM) mo = __ldg(reinterpret_cast<const float4*>(o.mom) + off);
      float4 dl;
      dl.x = row_one<EF, MOM>(st.x, a.x, t, fr, mo.x, &se.x, &re.x, &mn.x);
      dl.y = row_one<EF, MOM>(st.y, a.y, t, fr, mo.y, &se.y, &re.y, &mn.y);
      dl.z = row_one<EF, MOM>(st.z, a.z, t, fr, mo.z, &se.z, &re.z, &mn.z);
      dl.w = row_one<EF, MOM>(st.w, a.w, t, fr, mo.w, &se.w, &re.w, &mn.w);
      if (EF) {
        reinterpret_cast<float4*>(o.sent_out)[off] = se;
        reinterpret_cast<float4*>(o.resid_out)[off] = re;
      }
      if (MOM) reinterpret_cast<float4*>(o.mom_out)[off] = mn;
      u.x = __fadd_rn(u.x, __fmul_rn(w, dl.x));
      u.y = __fadd_rn(u.y, __fmul_rn(w, dl.y));
      u.z = __fadd_rn(u.z, __fmul_rn(w, dl.z));
      u.w = __fadd_rn(u.w, __fmul_rn(w, dl.w));
    }
    const float4 pp = __ldg(reinterpret_cast<const float4*>(o.p) + i);
    const float4 mm = __ldg(reinterpret_cast<const float4*>(o.m) + i);
    const float4 vv = __ldg(reinterpret_cast<const float4*>(o.v) + i);
    float4 po, mo2, vo;
    adam_one(pp.x, mm.x, vv.x, u.x, scale, s, &po.x, &mo2.x, &vo.x);
    adam_one(pp.y, mm.y, vv.y, u.y, scale, s, &po.y, &mo2.y, &vo.y);
    adam_one(pp.z, mm.z, vv.z, u.z, scale, s, &po.z, &mo2.z, &vo.z);
    adam_one(pp.w, mm.w, vv.w, u.w, scale, s, &po.w, &mo2.w, &vo.w);
    reinterpret_cast<float4*>(o.p_out)[i] = po;
    reinterpret_cast<float4*>(o.m_out)[i] = mo2;
    reinterpret_cast<float4*>(o.v_out)[i] = vo;
    reinterpret_cast<float4*>(o.u_out)[i] = u;
  }
}

template <bool EF, bool MOM>
__global__ void fused_update_scalar(Operands o, AdamScalars s) {
  const float scale = __ldg(o.scale);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < o.d; i += stride) {
    float u = 0.f;
    for (int r = 0; r < o.rows; ++r) {
      const size_t off = static_cast<size_t>(r) * o.d + i;
      const bool fr = row_fresh<EF>(o.fresh, r);
      float a = 0.f, st = 0.f, mo = 0.f, se = 0.f, re = 0.f, mn = 0.f,
            t = 0.f;
      if (!fr) st = o.stale[off];
      if (EF) {
        a = o.acc[off];
        t = __ldg(o.thr + r);
      }
      if (MOM) mo = o.mom[off];
      const float dl = row_one<EF, MOM>(st, a, t, fr, mo, &se, &re, &mn);
      if (EF) {
        o.sent_out[off] = se;
        o.resid_out[off] = re;
      }
      if (MOM) o.mom_out[off] = mn;
      u = __fadd_rn(u, __fmul_rn(__ldg(o.weights + r), dl));
    }
    adam_one(o.p[i], o.m[i], o.v[i], u, scale, s, o.p_out + i, o.m_out + i,
             o.v_out + i);
    o.u_out[i] = u;
  }
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned blocks_for(size_t n) {
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

template <bool EF, bool MOM>
void launch(const Operands& o, const AdamScalars& s, cudaStream_t st) {
  const bool vec = o.d % 4 == 0 && aligned16(o.p) && aligned16(o.m) &&
                   aligned16(o.v) && aligned16(o.stale) && aligned16(o.acc) &&
                   aligned16(o.mom) && aligned16(o.p_out) &&
                   aligned16(o.m_out) && aligned16(o.v_out) &&
                   aligned16(o.u_out) && aligned16(o.sent_out) &&
                   aligned16(o.resid_out) && aligned16(o.mom_out);
  if (vec) {
    fused_update_vec4<EF, MOM><<<blocks_for(o.d / 4), kThreads, 0, st>>>(o, s);
  } else {
    fused_update_scalar<EF, MOM><<<blocks_for(o.d), kThreads, 0, st>>>(o, s);
  }
}

}  // namespace

// One entry point for the three variants: acc == nullptr runs `plain`
// (thr, fresh, mom and the sent/resid/mom outputs unused), mom == nullptr
// runs `ef`, otherwise `ef_mom`. With EF, fresh == nullptr makes every row
// fresh, and stale is then unused (it may be null). Scalars are the fp32
// values of kernels/ref.py::adam_scalars. Returns cudaGetLastError() after
// the launch (0 = cudaSuccess).
extern "C" int repro_fused_update_f32(
    const void* p, const void* m, const void* v, const void* stale,
    const void* weights, const void* acc, const void* thr, const void* fresh,
    const void* mom, const void* scale, void* p_out, void* m_out, void* v_out,
    void* u_out, void* sent_out, void* resid_out, void* mom_out, int rows,
    long long d, float lr, float b1, float b2, float eps, float omb1,
    float omb2, float bc1, float bc2, void* stream) {
  if (d <= 0) return 0;
  const bool ef = acc != nullptr;
  const bool ef_mom = ef && mom != nullptr;
  const Operands o{
      static_cast<const float*>(p),      static_cast<const float*>(m),
      static_cast<const float*>(v),      static_cast<const float*>(stale),
      static_cast<const float*>(weights), static_cast<const float*>(acc),
      static_cast<const float*>(thr),    static_cast<const float*>(fresh),
      static_cast<const float*>(ef_mom ? mom : nullptr),
      static_cast<const float*>(scale),  static_cast<float*>(p_out),
      static_cast<float*>(m_out),        static_cast<float*>(v_out),
      static_cast<float*>(u_out),
      static_cast<float*>(ef ? sent_out : nullptr),
      static_cast<float*>(ef ? resid_out : nullptr),
      static_cast<float*>(ef_mom ? mom_out : nullptr),
      rows,
      static_cast<size_t>(d)};
  const AdamScalars s{lr, b1, b2, eps, omb1, omb2, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ef_mom) {
    launch<true, true>(o, s, st);
  } else if (ef) {
    launch<true, false>(o, s, st);
  } else {
    launch<false, false>(o, s, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// fused_adam: one bias-corrected Adam step over flat fp32 [D] views,
// (p, m, v, g) -> (p', m', v').
//
// Replaces the Pallas kernel src/repro/kernels/fused_adam.py::fused_adam
// (_kernel). The simulate engine runs all P workers' Adam as one call over
// the packed [P * D] view (core/staleness.py, packed_fused_step), with p = 0
// so that p' is the delta.
//
// Bound on an H100: memory. A call reads p, m, v, g and writes p', m', v',
// 7 * D * 4 bytes, against ~15 flops and one square root per element: about
// half a flop per byte, far below the card's ~20 fp32 flops per byte. The
// floor is those bytes over 3.35 TB/s (about 22.5 us at D = 2,686,976).
//
// Design: every byte is touched once and the step's scalars come in by
// value, so nothing but the seven streams reaches device memory. One thread
// owns a 16-byte chunk (128-bit loads and stores where D is a multiple of 4
// and every pointer is 16-byte aligned; otherwise the scalar variant runs),
// in a grid-stride loop whose bound masks the ragged tail. The arithmetic
// uses explicitly rounded intrinsics, one rounding per operation in the
// order of the plain version (kernels/ref.py): no fused multiply-add is
// contracted, so the kernel tracks the plain version op for op.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 8192;

struct AdamScalars {
  float lr, b1, b2, eps, omb1, omb2, bc1, bc2;
};

__device__ __forceinline__ void adam_one(float p, float m, float v, float g,
                                         const AdamScalars& s, float* p_out,
                                         float* m_out, float* v_out) {
  const float m2 = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
  const float v2 =
      __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v2, s.bc2)), s.eps);
  const float update = __fdiv_rn(__fmul_rn(s.lr, __fdiv_rn(m2, s.bc1)), denom);
  *p_out = __fsub_rn(p, update);
  *m_out = m2;
  *v_out = v2;
}

__global__ void fused_adam_vec4(const float* __restrict__ p,
                                const float* __restrict__ m,
                                const float* __restrict__ v,
                                const float* __restrict__ g,
                                float* __restrict__ p_out,
                                float* __restrict__ m_out,
                                float* __restrict__ v_out, size_t d,
                                AdamScalars s) {
  const size_t n4 = d / 4;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 pp = __ldg(reinterpret_cast<const float4*>(p) + i);
    const float4 mm = __ldg(reinterpret_cast<const float4*>(m) + i);
    const float4 vv = __ldg(reinterpret_cast<const float4*>(v) + i);
    const float4 gg = __ldg(reinterpret_cast<const float4*>(g) + i);
    float4 po, mo, vo;
    adam_one(pp.x, mm.x, vv.x, gg.x, s, &po.x, &mo.x, &vo.x);
    adam_one(pp.y, mm.y, vv.y, gg.y, s, &po.y, &mo.y, &vo.y);
    adam_one(pp.z, mm.z, vv.z, gg.z, s, &po.z, &mo.z, &vo.z);
    adam_one(pp.w, mm.w, vv.w, gg.w, s, &po.w, &mo.w, &vo.w);
    reinterpret_cast<float4*>(p_out)[i] = po;
    reinterpret_cast<float4*>(m_out)[i] = mo;
    reinterpret_cast<float4*>(v_out)[i] = vo;
  }
}

__global__ void fused_adam_scalar(const float* __restrict__ p,
                                  const float* __restrict__ m,
                                  const float* __restrict__ v,
                                  const float* __restrict__ g,
                                  float* __restrict__ p_out,
                                  float* __restrict__ m_out,
                                  float* __restrict__ v_out, size_t d,
                                  AdamScalars s) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < d; i += stride) {
    adam_one(p[i], m[i], v[i], g[i], s, p_out + i, m_out + i, v_out + i);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

unsigned blocks_for(size_t n) {
  size_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

}  // namespace

// Scalars are the fp32 values of kernels/ref.py::adam_scalars. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int repro_fused_adam_f32(const void* p, const void* m,
                                    const void* v, const void* g, void* p_out,
                                    void* m_out, void* v_out, long long d,
                                    float lr, float b1, float b2, float eps,
                                    float omb1, float omb2, float bc1,
                                    float bc2, void* stream) {
  if (d <= 0) return 0;
  const size_t n = static_cast<size_t>(d);
  const AdamScalars s{lr, b1, b2, eps, omb1, omb2, bc1, bc2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pi = static_cast<const float*>(p);
  const float* mi = static_cast<const float*>(m);
  const float* vi = static_cast<const float*>(v);
  const float* gi = static_cast<const float*>(g);
  float* po = static_cast<float*>(p_out);
  float* mo = static_cast<float*>(m_out);
  float* vo = static_cast<float*>(v_out);
  const bool vec = n % 4 == 0 && aligned16(pi) && aligned16(mi) &&
                   aligned16(vi) && aligned16(gi) && aligned16(po) &&
                   aligned16(mo) && aligned16(vo);
  if (vec) {
    fused_adam_vec4<<<blocks_for(n / 4), kThreads, 0, st>>>(pi, mi, vi, gi, po, mo, vo, n, s);
  } else {
    fused_adam_scalar<<<blocks_for(n), kThreads, 0, st>>>(pi, mi, vi, gi, po, mo, vo, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// sparsify_topk: the error-feedback split of [R, D] fp32 rows against one
// threshold per row, sent = |acc| >= thr[row] ? acc : 0, resid = acc - sent.
//
// Replaces the Pallas kernel src/repro/kernels/sparsify.py::sparsify_topk
// (_kernel), the compensation layer's split (compensate/__init__.py,
// Compensator.sparsify_packed): the per-source EF sparsifier of the
// gradient-ring modes off the megakernel path (SGD and the other non-Adam
// optimizers, kernels="off" and megakernel="off") and of the simulate engine
// under compress=. The top-k threshold itself is chosen outside the kernel
// (compensate/sparsify.py::topk_threshold).
//
// Bound on an H100: memory. A call reads acc once and writes sent and resid
// once, 3 * R * D * 4 bytes, against two operations per element: far below
// one flop per byte. At R = 8, D = 335,872 that is 32.2 MB, 9.6 us at
// 3.35 TB/s.
//
// Design: every byte is touched once. The threshold comes in as a device
// pointer, since it is computed on the device each step. blockIdx.y picks
// the row, so each block reads its row's threshold once; within the row one
// thread owns a 16-byte chunk (128-bit loads and stores where D is a
// multiple of 4 and every pointer is 16-byte aligned; otherwise the scalar
// variant runs), in a grid-stride loop whose bound masks the ragged tail,
// with size_t offsets. resid is one rounded subtraction of sent from acc,
// which is exact: sent + resid == acc bit for bit.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 4096;
constexpr long long kMaxRows = 65535;  // gridDim.y

__device__ __forceinline__ void split_one(float a, float t, float* sent,
                                          float* resid) {
  const float s = fabsf(a) >= t ? a : 0.f;
  *sent = s;
  *resid = __fsub_rn(a, s);
}

__global__ void sparsify_vec4(const float* __restrict__ acc,
                              const float* __restrict__ thr,
                              float* __restrict__ sent,
                              float* __restrict__ resid, size_t d) {
  const size_t n4 = d / 4;
  const size_t row = blockIdx.y;
  const float t = __ldg(thr + row);
  const float4* a4 = reinterpret_cast<const float4*>(acc + row * d);
  float4* s4 = reinterpret_cast<float4*>(sent + row * d);
  float4* r4 = reinterpret_cast<float4*>(resid + row * d);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 a = __ldg(a4 + i);
    float4 s, r;
    split_one(a.x, t, &s.x, &r.x);
    split_one(a.y, t, &s.y, &r.y);
    split_one(a.z, t, &s.z, &r.z);
    split_one(a.w, t, &s.w, &r.w);
    s4[i] = s;
    r4[i] = r;
  }
}

__global__ void sparsify_scalar(const float* __restrict__ acc,
                                const float* __restrict__ thr,
                                float* __restrict__ sent,
                                float* __restrict__ resid, size_t d) {
  const size_t row = blockIdx.y;
  const float t = __ldg(thr + row);
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < d; i += stride) {
    const size_t off = row * d + i;
    split_one(acc[off], t, sent + off, resid + off);
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

// acc, sent, resid [rows, d]; thr [rows]. Returns cudaGetLastError() after
// the launch (0 = cudaSuccess), or cudaErrorInvalidValue for more rows than
// one grid dimension holds.
extern "C" int repro_sparsify_f32(const void* acc, const void* thr,
                                  void* sent, void* resid, long long rows,
                                  long long d, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if (rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(acc);
  const float* t = static_cast<const float*>(thr);
  float* s = static_cast<float*>(sent);
  float* r = static_cast<float*>(resid);
  if (n % 4 == 0 && aligned16(a) && aligned16(s) && aligned16(r)) {
    const dim3 grid(blocks_for(n / 4), static_cast<unsigned>(rows));
    sparsify_vec4<<<grid, kThreads, 0, st>>>(a, t, s, r, n);
  } else {
    const dim3 grid(blocks_for(n), static_cast<unsigned>(rows));
    sparsify_scalar<<<grid, kThreads, 0, st>>>(a, t, s, r, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// stale_accum: out[D] = params[D] + sum_s w[s] * buffer[s, D], fp32.
//
// Replaces the Pallas kernel src/repro/kernels/stale_accum.py::stale_accum
// (_kernel), the delayed-update delivery of the simulate engine's packed ring
// (core/staleness.py, S = 1: the caches plus the arrived row).
//
// Bound on an H100: memory. A call reads params and S buffer rows and writes
// out once, (S + 2) * D * 4 bytes, against 2 * S * D flops: well under one
// flop per byte, far below the card's ~20 fp32 flops per byte. The floor is
// those bytes over 3.35 TB/s (about 9.6 us for S = 1 at D = 2,686,976).
//
// Design: every byte is touched once. One thread owns a 16-byte chunk of D
// and loops over the S slots in a fixed order, so the sum is deterministic
// and needs no atomics. Loads and stores are 128-bit where D is a multiple
// of 4 and the pointers are 16-byte aligned; otherwise the scalar variant
// runs. Both walk D in a grid-stride loop whose bound masks the ragged tail,
// with size_t offsets so S * D may exceed 2^31.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxBlocks = 8192;

__global__ void stale_accum_vec4(float* __restrict__ out,
                                 const float* __restrict__ params,
                                 const float* __restrict__ buffer,
                                 const float* __restrict__ weights,
                                 int slots, size_t d) {
  const size_t n4 = d / 4;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < slots; ++s) {
      const float w = __ldg(weights + s);
      const float4 b =
          __ldg(reinterpret_cast<const float4*>(buffer + s * d) + i);
      acc.x += w * b.x;
      acc.y += w * b.y;
      acc.z += w * b.z;
      acc.w += w * b.w;
    }
    const float4 p = __ldg(reinterpret_cast<const float4*>(params) + i);
    reinterpret_cast<float4*>(out)[i] =
        make_float4(p.x + acc.x, p.y + acc.y, p.z + acc.z, p.w + acc.w);
  }
}

__global__ void stale_accum_scalar(float* __restrict__ out,
                                   const float* __restrict__ params,
                                   const float* __restrict__ buffer,
                                   const float* __restrict__ weights,
                                   int slots, size_t d) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < d; i += stride) {
    float acc = 0.f;
    for (int s = 0; s < slots; ++s) acc += __ldg(weights + s) * buffer[s * d + i];
    out[i] = params[i] + acc;
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

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int repro_stale_accum_f32(void* out, const void* params,
                                     const void* buffer, const void* weights,
                                     int slots, long long d, void* stream) {
  if (d <= 0) return 0;
  const size_t n = static_cast<size_t>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  const float* p = static_cast<const float*>(params);
  const float* b = static_cast<const float*>(buffer);
  const float* w = static_cast<const float*>(weights);
  if (n % 4 == 0 && aligned16(o) && aligned16(p) && aligned16(b)) {
    stale_accum_vec4<<<blocks_for(n / 4), kThreads, 0, st>>>(o, p, b, w, slots, n);
  } else {
    stale_accum_scalar<<<blocks_for(n), kThreads, 0, st>>>(o, p, b, w, slots, n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K11: the u32 op-chain and copy probe.
//
// Replaces scripts/micro_vpu.py:kern (the Pallas probe that calibrated the
// TPU's vector-unit op budget): every element of a [L, B, N1, N2] u32
// array goes through a chain of k dependent 32-bit operations, or is
// copied:
//
//   copy:   out = x
//   addmul: acc = acc * 2654435761 + (i | 1)                  (2 ops a step)
//   shift:  acc = ((acc >> (1 + i % 5)) | (acc << 3)) & 0x7FFFFFFF (3 ops)
//   cmpadd: s = acc + c; c = (s < c) + i; acc = s             (3 ops)
//
// all with u32 wraparound.  Bound on the H100: copy by device memory
// (each element read and written once, 8 bytes); the chains by the
// integer pipe (addmul is one IMAD a step, so it measures the card's
// 32-bit multiply-add rate, the rate that bounds the 64-bit modular
// kernels K1-K7).  Each thread takes four elements with one 16-byte load
// and one 16-byte store, in a grid-stride loop.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

template <int KIND>
__device__ __forceinline__ uint32_t chain(uint32_t v, int k) {
  uint32_t acc = v;
  if (KIND == 1) {
#pragma unroll 8
    for (int i = 0; i < k; ++i) acc = acc * 2654435761u + (uint32_t)(i | 1);
  } else if (KIND == 2) {
    int sh = 1;
#pragma unroll 5
    for (int i = 0; i < k; ++i) {
      acc = ((acc >> sh) | (acc << 3)) & 0x7FFFFFFFu;
      sh = sh == 5 ? 1 : sh + 1;
    }
  } else if (KIND == 3) {
    uint32_t c = v;
#pragma unroll 8
    for (int i = 0; i < k; ++i) {
      uint32_t s = acc + c;
      c = (s < c ? 1u : 0u) + (uint32_t)i;
      acc = s;
    }
  }
  return acc;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
u32_chain_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                 long long n4, int k) {
  for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
       i += (long long)gridDim.x * THREADS) {
    uint4 v = x[i];
    if (KIND != 0) {
      v.x = chain<KIND>(v.x, k);
      v.y = chain<KIND>(v.y, k);
      v.z = chain<KIND>(v.z, k);
      v.w = chain<KIND>(v.w, k);
    }
    out[i] = v;
  }
}

}  // namespace

// kind: 0 copy, 1 addmul, 2 shift, 3 cmpadd; n4 = elements / 4.
extern "C" int mf_u32_chain(const void* x, void* out, long long n4, int kind,
                            int k, void* stream) {
  long long want = (n4 + THREADS - 1) / THREADS;
  int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (blocks < 1) blocks = 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* in = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  switch (kind) {
    case 0: u32_chain_kernel<0><<<blocks, THREADS, 0, s>>>(in, o, n4, k); break;
    case 1: u32_chain_kernel<1><<<blocks, THREADS, 0, s>>>(in, o, n4, k); break;
    case 2: u32_chain_kernel<2><<<blocks, THREADS, 0, s>>>(in, o, n4, k); break;
    case 3: u32_chain_kernel<3><<<blocks, THREADS, 0, s>>>(in, o, n4, k); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

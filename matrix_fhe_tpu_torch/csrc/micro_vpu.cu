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
// kernels K2-K7).  The chains take one 16-byte vector a thread in a
// grid-stride loop over at most 132 x 16 blocks.  The copy takes a block
// for each tile of 4 x 256 16-byte vectors, each thread with its four
// independent loads in flight before its stores, and lets the block
// scheduler fill the card (on the H100 a persistent grid of one wave of
// resident blocks walking the tiles was slower than Tensor.copy_).  The
// copy takes any element count (its last n % 4 elements one by one); the
// chains take 4n.
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
    v.x = chain<KIND>(v.x, k);
    v.y = chain<KIND>(v.y, k);
    v.z = chain<KIND>(v.z, k);
    v.w = chain<KIND>(v.w, k);
    out[i] = v;
  }
}

// the copy: a block a tile of COPY_UNROLL x 256 vectors, each thread's
// loads all in flight before its stores; block 0 copies the last n % 4
// elements one by one
constexpr int COPY_UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
u32_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out,
                long long n) {
  const long long n4 = n / 4;
  const long long t0 = blockIdx.x * static_cast<long long>(THREADS) * COPY_UNROLL;
  uint4 v[COPY_UNROLL];
#pragma unroll
  for (int u = 0; u < COPY_UNROLL; ++u) {
    const long long i = t0 + u * THREADS + threadIdx.x;
    if (i < n4) v[u] = x[i];
  }
#pragma unroll
  for (int u = 0; u < COPY_UNROLL; ++u) {
    const long long i = t0 + u * THREADS + threadIdx.x;
    if (i < n4) out[i] = v[u];
  }
  const long long i = 4 * n4 + threadIdx.x;
  if (blockIdx.x == 0 && i < n)
    reinterpret_cast<uint32_t*>(out)[i] = reinterpret_cast<const uint32_t*>(x)[i];
}

template <int KIND>
int launch_chain(const uint4* x, uint4* out, long long n, int k,
                 cudaStream_t s) {
  if (n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  long long want = (n4 + THREADS - 1) / THREADS;
  int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  if (blocks < 1) blocks = 1;
  u32_chain_kernel<KIND><<<blocks, THREADS, 0, s>>>(x, out, n4, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 copy, 1 addmul, 2 shift, 3 cmpadd; n elements, any count for the
// copy and 4n for the chains (both pointers 16-byte aligned).
extern "C" int mf_u32_chain(const void* x, void* out, long long n, int kind,
                            int k, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* in = static_cast<const uint4*>(x);
  uint4* o = static_cast<uint4*>(out);
  switch (kind) {
    case 0: {
      const long long tile = static_cast<long long>(THREADS) * COPY_UNROLL;
      const long long tiles = (n / 4 + tile - 1) / tile;
      if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
      u32_copy_kernel<<<static_cast<int>(tiles < 1 ? 1 : tiles), THREADS, 0, s>>>(in, o, n);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return launch_chain<1>(in, o, n, k, s);
    case 2: return launch_chain<2>(in, o, n, k, s);
    case 3: return launch_chain<3>(in, o, n, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

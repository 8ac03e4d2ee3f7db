// Kernel B3: indexed episode gather fused with the little-endian bit unpack,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel hanabi_sad_tpu/ops/experimental/pallas_replay.py:
// gather_unpack_pallas (pallas_call at line 68, kernel _kernel), which
// scalar-prefetches the sampled indices, lets the BlockSpec index map fetch
// the selected episode's packed rows into VMEM and writes them unpacked, so
// the gathered packed bytes never exist on their own.
//
// Layout: packed is [cap, T, Pi, NB] uint8; idx is [B] int64;
// out is [B, T, Pi, NB * 8] float32, bit k of byte j -> feature 8j + k (the
// layout of replay/bitpack.py:unpack_bits). An episode holds E = T * Pi * NB
// bytes, and byte e of episode b unpacks to floats 8 * (b * E + e) ... + 7:
// the output is linear in the packed byte, so it needs no row arithmetic.
//
// Block layout: grid (ceil(E / THREADS), B). Each block reads its own entry
// of idx (this replaces the TPU's scalar prefetch), each thread one packed
// byte, and writes its 8 floats as two float4 stores: a warp reads 32
// consecutive bytes and writes 1 KB of consecutive floats. The output base
// of every byte is a multiple of 32 bytes, so the float4 stores are aligned.
//
// Index bounds, as JAX's `packed[idx]` reads them: an index in [-cap, -1]
// counts from the end (cap + idx); what still lies outside [0, cap) is
// clamped into it (-cap - 2 reads episode 0, cap + 3 reads episode cap - 1).
// The kernel never reads outside the buffer. The sampler
// (replay/prioritized.py:sample_indices) never produces such an index.
//
// Bound: at the flagship shape (B = 64 of cap = 65,536, T = 80, Pi = 2,
// NB = 110) it reads 1.1 MB and writes 36 MB: bound by bytes written,
// 0.011 ms at 3.35 TB/s. It does no arithmetic to speak of.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) gather_unpack_kernel(
    const uint8_t* __restrict__ packed, const long long* __restrict__ idx,
    float4* __restrict__ out, long long cap, long long episode_bytes) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= episode_bytes) return;
  long long src = idx[blockIdx.y];
  if (src < 0) src += cap;
  src = src < 0 ? 0 : (src >= cap ? cap - 1 : src);
  const unsigned v = packed[src * episode_bytes + e];
  const long long o = 2 * ((long long)blockIdx.y * episode_bytes + e);
  out[o] = make_float4((float)(v & 1u), (float)((v >> 1) & 1u), (float)((v >> 2) & 1u),
                       (float)((v >> 3) & 1u));
  out[o + 1] = make_float4((float)((v >> 4) & 1u), (float)((v >> 5) & 1u),
                           (float)((v >> 6) & 1u), (float)((v >> 7) & 1u));
}

}  // namespace

// Launches the gather + unpack of B episodes on `stream`. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int gather_unpack_u8_f32(const uint8_t* packed, const long long* idx, float* out,
                                    long long cap, long long episode_bytes, int B,
                                    void* stream) {
  if (B <= 0 || cap <= 0 || episode_bytes <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (episode_bytes + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)B);
  gather_unpack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      packed, idx, reinterpret_cast<float4*>(out), cap, episode_bytes);
  return (int)cudaGetLastError();
}

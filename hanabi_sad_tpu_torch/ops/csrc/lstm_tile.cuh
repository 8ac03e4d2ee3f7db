// Pieces shared by the float32 LSTM kernels of lstm_seq.cu (B1) and
// lstm_bwd.cu (B2's backward), for Hopper (sm_90a); lstm_bf16.cu takes its
// constants, cp.async groups, sigmoid and cooperative launcher from here.
//
// The two persistent recurrence kernels have one shape: a block owns 32 batch
// rows x 16 hidden units, keeps the matching slice of W_hh resident in shared
// memory for every time step, and at each step multiplies a [32, K] slice of
// a sequence that other blocks wrote in the step before (h_{t-1} forward,
// dG_{t+1} backward) by that slice. `TileProduct` is that product. The K
// range is cut into chunks of 16; the block's 8 warps take the chunks in
// turn (split K), each warp streams its own chunks through a 4-stage
// cp.async ring of its own, and each lane holds a TM x TN register tile. The
// 8 partial sums are then added in a fixed order through shared memory, so
// the result is the same from run to run (no atomics anywhere).

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace lstm {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 32;          // batch rows of a block's tile
constexpr int UNITS = 16;         // hidden units of a block's tile
constexpr int KC = 16;            // depth of one chunk of the recurrent product
constexpr int A_STRIDE = KC + 4;  // floats per staged row: 80 B, 16-B aligned, no bank conflicts
constexpr int STAGES = 4;
constexpr int STAGE_FLOATS = ROWS * A_STRIDE;
constexpr int RING_FLOATS = WARPS * STAGES * STAGE_FLOATS;

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies of floats into shared memory with cp.async. `four_l2` reads through
// L2 only (cp.async.cg): it is used for data that other blocks of the same
// launch wrote before a grid barrier, which a stale L1 line must not hide.
struct Stage {
  __device__ static void one(float* s, const float* g) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g) : "memory");
  }
  __device__ static void four(float* s, const float* g) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g) : "memory");
  }
  __device__ static void four_l2(float* s, const float* g) { four(s, g); }
};

// acc[TM][TN] = A[row0 : row0 + 32, 0 : K] . Ws[0 : K, 0 : N], one lane's
// share of the warp's chunks. A is row-major with leading dimension lda;
// rows at or past nrows read row nrows - 1 (their results are dropped). Ws
// is [K][N] in shared memory. ring holds this block's cp.async stages
// (RING_FLOATS). K must be a multiple of KC.
//
// Lane layout: NCG = N / TN column groups by NRG = 32 / NCG row groups.
// Lane (ry, cx) holds rows ry + NRG * i and columns (n / 4) * 4 * NCG +
// 4 * cx + n % 4, so its float4 reads of a staged row and of a Ws row are
// free of bank conflicts.
template <int N, int TM, int TN>
struct TileProduct {
  static constexpr int NCG = N / TN;
  static constexpr int NRG = 32 / NCG;
  static_assert(TN % 4 == 0 && N % TN == 0, "a lane holds float4 column groups");
  static_assert(NRG * NCG == 32 && NRG * TM == ROWS, "the warp's lanes cover the tile");
  static constexpr int RED_FLOATS = WARPS * ROWS * N;
  static_assert(RED_FLOATS <= RING_FLOATS, "the partial sums fit in the ring");

  __device__ static int row(int i) { return (threadIdx.x & 31) / NCG + NRG * i; }
  __device__ static int col(int n) { return (n / 4) * 4 * NCG + 4 * ((threadIdx.x & 31) % NCG) + n % 4; }

  __device__ static void run(const float* A, int lda, int K, int row0, int nrows, const float* Ws,
                             float* ring, float (&acc)[TM][TN]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int ry = lane / NCG, cx = lane % NCG;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) acc[i][n] = 0.0f;
    const int nch = K / KC;
    const int mine = warp < nch ? (nch - warp + WARPS - 1) / WARPS : 0;
    float* my_ring = ring + warp * STAGES * STAGE_FLOATS;

    // Chunk m of this warp is K range [(warp + m * WARPS) * KC, + KC): 32 rows
    // of 4 float4, 4 copies a lane.
    auto load = [&](int m) {
      const int k0 = (warp + m * WARPS) * KC;
      float* st = my_ring + (m % STAGES) * STAGE_FLOATS;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int q = lane + 32 * s, r = q >> 2, k4 = (q & 3) * 4;
        int gr = row0 + r;
        gr = gr < nrows ? gr : nrows - 1;
        Stage::four_l2(st + r * A_STRIDE + k4, A + (size_t)gr * lda + k0 + k4);
      }
    };

    for (int m = 0; m < STAGES - 1; ++m) {
      if (m < mine) load(m);
      cp_async_commit();
    }
    for (int m = 0; m < mine; ++m) {
      cp_async_wait<STAGES - 2>();  // chunk m has landed
      __syncwarp();                 // ... for every lane, and stage m - 1 is free
      if (m + STAGES - 1 < mine) load(m + STAGES - 1);
      cp_async_commit();
      const float* st = my_ring + (m % STAGES) * STAGE_FLOATS;
      const float* w = Ws + (size_t)(warp + m * WARPS) * KC * N;
#pragma unroll
      for (int kk = 0; kk < KC; kk += 4) {
        float4 a[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = *reinterpret_cast<const float4*>(st + (ry + NRG * i) * A_STRIDE + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float b[TN];
#pragma unroll
          for (int h = 0; h < TN / 4; ++h) {
            const float4 v = *reinterpret_cast<const float4*>(w + (kk + j) * N + h * 4 * NCG + 4 * cx);
            b[4 * h] = v.x;
            b[4 * h + 1] = v.y;
            b[4 * h + 2] = v.z;
            b[4 * h + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float av = j == 0 ? a[i].x : j == 1 ? a[i].y : j == 2 ? a[i].z : a[i].w;
#pragma unroll
            for (int n = 0; n < TN; ++n) acc[i][n] = fmaf(av, b[n], acc[i][n]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncwarp();
  }

  // Writes this lane's partial sums to red[warp][row][col] (red aliases the
  // ring: call after a __syncthreads that follows run).
  __device__ static void store(const float (&acc)[TM][TN], float* red) {
    float* mine = red + (threadIdx.x >> 5) * ROWS * N;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int n = 0; n < TN; ++n) mine[row(i) * N + col(n)] = acc[i][n];
  }

  // The sum over the warps, in warp order, of element (r, c).
  __device__ static float sum(const float* red, int r, int c) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * ROWS * N + r * N + c];
    return s;
  }
};

// Shared memory of a persistent kernel: the resident weight slice (k_rows x
// N floats) and the ring, which doubles as the buffer of partial sums.
inline size_t persistent_smem_bytes(int k_rows, int n) {
  return sizeof(float) * ((size_t)k_rows * n + RING_FLOATS);
}

// Launches a persistent kernel cooperatively: one block per (row tile, unit
// tile) up to what the card holds at once, every unit tile present, the row
// tiles shared out in turn. Returns a CUDA error code, never falls back:
// cudaErrorCooperativeLaunchTooLarge if not even one row of unit tiles fits.
inline cudaError_t launch_persistent(const void* kernel, int row_tiles, int unit_tiles, size_t smem,
                                     void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return err;
  const long long max_blocks = (long long)per_sm * sms;
  if (max_blocks < unit_tiles) return cudaErrorCooperativeLaunchTooLarge;
  const long long per_row = max_blocks / unit_tiles;
  const int gx = (int)(row_tiles < per_row ? row_tiles : per_row);
  return cudaLaunchCooperativeKernel(kernel, dim3(gx, unit_tiles), dim3(THREADS), args, smem, stream);
}

}  // namespace lstm

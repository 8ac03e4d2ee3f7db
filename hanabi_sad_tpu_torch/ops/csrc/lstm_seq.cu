// Kernel B1: the multi-layer LSTM over a sequence in float32, for Hopper
// (sm_90a); its bfloat16 route is lstm_bf16.cu, on the tensor cores. Two
// kernels:
//
//   lstm_gates_kernel       the gates product of SGEMM class, with the cell
//                           update in its epilogue (CELL) or without it;
//   lstm_recurrence_kernel  a persistent kernel that runs every time step of
//                           one layer with its W_hh slice resident in shared
//                           memory, one grid barrier per step.
//
// Replaces the TPU kernel hanabi_sad_tpu/ops/experimental/pallas_lstm.py:
// lstm_seq_pallas (pallas_call at line 166, kernel _kernel at 62-133), which
// runs every time step and layer in one program with the weights resident in
// VMEM, so that they are read once and not once per step. The wrapper
// (ops/lstm_seq.py) drives these kernels so:
//
//   T = 1 (eval, rollout): one lstm_gates_kernel<CELL> per layer over
//     K = [x | h_prev], [w_ih; w_hh], which writes h and c and never stores
//     the 4H gate pre-activations;
//   T > 1 (learner): per layer, lstm_gates_kernel without the cell computes
//     Gx = X . w_ih + b for all T * B rows at once, then one
//     lstm_recurrence_kernel adds h_{t-1} . w_hh step by step. So a call is
//     2 L launches, and W_hh is read from device memory once per layer.
//
// With `act` / `cseq` (save pointers, the forward of B2) the same kernels also
// store the gate activations i, f, g, o and the cell states for the backward
// kernel (lstm_bwd.cu); what they compute is unchanged, so the outputs are the
// same bits with and without them.
//
// Layouts: x [M, K0] and h [M, H] row-major; w_ih [K0, 4H], w_hh [H, 4H],
// b [4H], gate order i, f, g, o (the JAX package's); sequences [T, B, ...].
//
// Bound: a forward does 2 * T * L * B * 2H * 4H operations in float32 outside
// the tensor cores (67 TFLOP/s): 0.125 ms at the eval shape (T=1, B=1000,
// H=512, L=2), 1.28 ms at the learner shape (T=80, B=128); bytes are a tenth
// of that. No TF32: the float32 path stays float32 (plain FMA).
//
// Design of the gates kernel: a 128 x 128 output tile per block (128 rows by
// 32 hidden units x 4 gates, so a thread's 8 x 8 accumulators hold all four
// gates of 2 units for 8 rows and the cell update happens in registers),
// K tiles of 16 double-buffered with cp.async (A transposed into shared
// memory by 4-byte copies, W by 16-byte copies). At the eval shape it is
// 8 x 16 = 128 blocks for 132 SMs. The projection without the cell sums
// each K tile apart before adding it (two levels of accumulation, twice the
// registers, one block per SM): with one running sum over its K, B1 at the
// learner shape lay further from float64 than the plain version, whose
// products cuBLAS splits.
//
// Design of the recurrence kernel: a block owns 32 rows x 16 units and keeps
// W_hh[:, those units' 64 gate columns] (H x 64 floats, 128 KB at H = 512) in
// dynamic shared memory for all T steps. Each step it reads h_{t-1} for its
// rows through L2 (written by other blocks in the step before), multiplies it
// with lstm_tile.cuh's split-K TileProduct, adds the partial sums in a fixed
// order, adds Gx_t, applies the cell update and writes h_t and c_t; then a
// grid barrier. At the learner shape it is 4 x 32 = 128 blocks, one per SM,
// launched cooperatively; with more rows than fit, each block takes several
// row tiles a step.
//
// The saved cell states (save_c, cseq) are c as stored, the c that the next
// step reads (the bfloat16 route saves float(bf16(c)); here that is c).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "lstm_tile.cuh"

namespace {

using namespace lstm;
namespace cg = cooperative_groups;

constexpr int GM = 128;          // rows of a gates tile
constexpr int GU = 32;           // hidden units of a gates tile (times 4 gates)
constexpr int GN = 4 * GU;       // columns of a gates tile
constexpr int GK = 16;           // depth of a gates K tile
constexpr int GA_STRIDE = GM + 4;

// CELL: h_out = o * tanh(c), c_out = f * c_prev + i * g from gates = [a0 |
// a1] . [w0; w1] + b, and y (if given) = h_out too. Without CELL: gates_out
// = a0 . w0 + b ([M, 4H] float). save_act [M, 4H] and save_c [M, H], if given,
// receive the activations and c_out.
template <bool CELL>
__global__ void __launch_bounds__(THREADS, CELL ? 2 : 1) lstm_gates_kernel(
    const float* __restrict__ a0, const float* __restrict__ w0, int k0,
    const float* __restrict__ a1, const float* __restrict__ w1, int k1,
    const float* __restrict__ bias, const float* __restrict__ c_prev,
    float* __restrict__ gates_out, float* __restrict__ h_out, float* __restrict__ c_out,
    float* __restrict__ y, float* __restrict__ save_act, float* __restrict__ save_c, int M, int H) {
  __shared__ __align__(16) float As[2][GK][GA_STRIDE];  // As[.][k][m]
  __shared__ __align__(16) float Ws[2][GK][GN];         // Ws[.][k][g * GU + j]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * GM, u0 = blockIdx.y * GU;
  const int G = 4 * H, nk = (k0 + k1) / GK;

  auto load_tile = [&](int kt, int buf) {
    int kb = kt * GK;
    const float* a = a0;
    const float* w = w0;
    int lda = k0;
    if (kb >= k0) {
      a = a1;
      w = w1;
      kb -= k0;
      lda = k1;
    }
#pragma unroll
    for (int s = 0; s < GM * GK / THREADS; ++s) {
      const int e = tid + THREADS * s, r = e / GK, kk = e % GK;
      int gr = m0 + r;
      gr = gr < M ? gr : M - 1;
      Stage::one(&As[buf][kk][r], a + (size_t)gr * lda + kb + kk);
    }
#pragma unroll
    for (int s = 0; s < GK * GN / 4 / THREADS; ++s) {
      const int q = tid + THREADS * s, kk = q / (GN / 4), c = (q % (GN / 4)) * 4;
      const int g = c / GU, j = c % GU;
      Stage::four(&Ws[buf][kk][c], w + (size_t)(kb + kk) * G + g * H + u0 + j);
    }
  };

  // Thread (ty, tx): rows ty * 4 + {0..3} and 64 + ty * 4 + {0..3}; units
  // u0 + 2 tx + {0, 1}, all four gates: acc[i][2 g + e].
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[i][n] = 0.0f;

  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int b = kt & 1;
    // Without the cell (the projection), each K tile is summed apart and
    // then added: two levels of accumulation (see above).
    float part[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < 8; ++n) part[i][n] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 lo = *reinterpret_cast<const float4*>(&As[b][kk][ty * 4]);
      const float4 hi = *reinterpret_cast<const float4*>(&As[b][kk][64 + ty * 4]);
      const float a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
      float w[8];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float2 v = *reinterpret_cast<const float2*>(&Ws[b][kk][g * GU + tx * 2]);
        w[2 * g] = v.x;
        w[2 * g + 1] = v.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          if (CELL)
            acc[i][n] = fmaf(a[i], w[n], acc[i][n]);
          else
            part[i][n] = fmaf(a[i], w[n], part[i][n]);
        }
    }
    if (!CELL) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[i][n] += part[i][n];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int u = u0 + tx * 2 + e;
      float pre[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) pre[g] = acc[i][2 * g + e] + bias[g * H + u];
      if (!CELL) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gates_out[(size_t)row * G + g * H + u] = pre[g];
        continue;
      }
      const size_t at = (size_t)row * H + u;
      const float ig = sigmoid_f(pre[0]), fg = sigmoid_f(pre[1]);
      const float gg = tanhf(pre[2]), og = sigmoid_f(pre[3]);
      const float c_new = fg * c_prev[at] + ig * gg, h_st = og * tanhf(c_new);
      c_out[at] = c_new;
      h_out[at] = h_st;
      if (y != nullptr) y[at] = h_st;
      if (save_act != nullptr) {
        float* s = save_act + (size_t)row * G + u;
        s[0] = ig;
        s[H] = fg;
        s[2 * H] = gg;
        s[3 * H] = og;
      }
      if (save_c != nullptr) save_c[at] = c_new;
    }
  }
}

// One layer over T steps. gx [T, B, 4H] = x . w_ih + b; h0, c0 [B, H];
// hseq [T, B, H] receives every h_t; h_last, c_last [B, H] receive hT and cT
// (c_last holds the running c of the block's own elements between steps).
// act [T, B, 4H] and cseq [T, B, H] (may be null) receive the activations
// and every c_t.
__global__ void __launch_bounds__(THREADS, 1) lstm_recurrence_kernel(
    const float* __restrict__ gx, const float* h0, const float* __restrict__ c0,
    const float* __restrict__ w_hh, float* hseq, float* __restrict__ h_last,
    float* __restrict__ c_last, float* __restrict__ act, float* __restrict__ cseq, int T, int B,
    int H) {
  constexpr int N = 4 * UNITS;
  using P = TileProduct<N, 8, 8>;
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                   // [H][N]: Ws[k][g * UNITS + u] = w_hh[k][g * H + u0 + u]
  float* ring = smem + (size_t)H * N;  // cp.async stages, then the partial sums

  const int tid = threadIdx.x;
  const int u0 = blockIdx.y * UNITS, G = 4 * H;
  const int row_tiles = (B + ROWS - 1) / ROWS;
  for (int q = tid; q < H * N / 4; q += THREADS) {
    const int k = q / (N / 4), c = (q % (N / 4)) * 4, g = c / UNITS, u = c % UNITS;
    Stage::four(Ws + k * N + c, w_hh + (size_t)k * G + g * H + u0 + u);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t) {
    const float* h_prev = t == 0 ? h0 : hseq + (size_t)(t - 1) * B * H;
    for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
      const int r0 = rt * ROWS;
      float acc[8][8];
      P::run(h_prev, H, H, r0, B, Ws, ring, acc);
      __syncthreads();
      P::store(acc, ring);
      __syncthreads();
      for (int p = tid; p < ROWS * UNITS; p += THREADS) {
        const int r = p / UNITS, u = p % UNITS, row = r0 + r;
        if (row >= B) continue;
        const int U = u0 + u;
        const float* gx_row = gx + ((size_t)t * B + row) * G;
        float pre[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) pre[g] = P::sum(ring, r, g * UNITS + u) + gx_row[g * H + U];
        const size_t at = (size_t)row * H + U;
        const float ig = sigmoid_f(pre[0]), fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]), og = sigmoid_f(pre[3]);
        const float c_prev = t == 0 ? c0[at] : c_last[at];
        const float c_new = fg * c_prev + ig * gg, h_st = og * tanhf(c_new);
        c_last[at] = c_new;
        hseq[(size_t)t * B * H + at] = h_st;
        if (t == T - 1) h_last[at] = h_st;
        if (act != nullptr) {
          float* s = act + ((size_t)t * B + row) * G + U;
          s[0] = ig;
          s[H] = fg;
          s[2 * H] = gg;
          s[3 * H] = og;
        }
        if (cseq != nullptr) cseq[(size_t)t * B * H + at] = c_new;
      }
      __syncthreads();  // the sums are read before the ring is refilled
    }
    if (t + 1 < T) grid.sync();
  }
}

}  // namespace

// Launches lstm_gates_kernel on `stream`. With c_prev (CELL): gates over
// [a0 | a1] . [w0; w1] + bias, the cell update, h_out, c_out, y (may be null),
// save_act / save_c (may be null); gates_out is ignored. Without c_prev:
// gates_out = a0 . w0 + bias, and a1, w1, k1 and the cell pointers are
// ignored. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lstm_gates_f32(const float* a0, const float* w0, int k0, const float* a1,
                              const float* w1, int k1, const float* bias, const float* c_prev,
                              float* gates_out, float* h_out, float* c_out, float* y,
                              float* save_act, float* save_c, int M, int H, void* stream) {
  const bool cell = c_prev != nullptr;
  if (!cell) k1 = 0;
  if (M <= 0 || H <= 0 || H % GU != 0 || k0 <= 0 || k0 % GK != 0 || k1 < 0 || k1 % GK != 0)
    return (int)cudaErrorInvalidValue;
  if (cell && (k1 == 0 || h_out == nullptr || c_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (!cell && gates_out == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((M + GM - 1) / GM, H / GU);
  cudaStream_t s = (cudaStream_t)stream;
  if (cell)
    lstm_gates_kernel<true><<<grid, THREADS, 0, s>>>(a0, w0, k0, a1, w1, k1, bias, c_prev, nullptr, h_out,
                                                     c_out, y, save_act, save_c, M, H);
  else
    lstm_gates_kernel<false><<<grid, THREADS, 0, s>>>(a0, w0, k0, nullptr, nullptr, 0, bias, nullptr,
                                                      gates_out, nullptr, nullptr, nullptr, nullptr, nullptr,
                                                      M, H);
  return (int)cudaGetLastError();
}

// Launches lstm_recurrence_kernel cooperatively on `stream` (see above).
// Returns a CUDA error code: nonzero if the launch was refused (shared
// memory, or more unit tiles than the card holds at once).
extern "C" int lstm_recurrence_f32(const float* gx, const float* h0, const float* c0,
                                   const float* w_hh, float* hseq, float* h_last, float* c_last,
                                   float* act, float* cseq, int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % GU != 0) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&gx, (void*)&h0, (void*)&c0, (void*)&w_hh, (void*)&hseq, (void*)&h_last,
                  (void*)&c_last, (void*)&act, (void*)&cseq, (void*)&T, (void*)&B, (void*)&H};
  const cudaError_t err = launch_persistent((const void*)lstm_recurrence_kernel, (B + ROWS - 1) / ROWS,
                                            H / UNITS, persistent_smem_bytes(H, 4 * UNITS), args,
                                            (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The multiple of which H must be.
extern "C" int lstm_h_multiple() { return GU; }

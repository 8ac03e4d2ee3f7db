// Kernels B1 and B2's backward in bfloat16, on Hopper's tensor cores (sm_90a):
//
//   lstm_gates_bf16       B1's gates product, with the cell update in its
//                         epilogue (T = 1) or without it (the input projection
//                         of all T * B rows);
//   lstm_recurrence_bf16  B1's persistent kernel over the T steps of a layer;
//   lstm_bwd_bf16         B2's persistent BPTT kernel over the steps of a layer.
//
// They replace the bfloat16 route of the TPU kernel hanabi_sad_tpu/ops/
// experimental/pallas_lstm.py:lstm_seq_pallas (pallas_call at 166, _kernel at
// 62-133: jnp.dot of the bfloat16 x and h with w_ih and w_hh summed in float32
// at 103-105, h and c stored in xs.dtype at 112-113) and of its VJP
// (lstm_seq_pallas_diff, custom_vjp at 212-230). The wrapper is
// ops/lstm_seq.py; the float32 routes are lstm_seq.cu and lstm_bwd.cu, which
// share the layouts and the order of the launches described there.
//
// Semantics, as pallas_lstm.py's kernel computes them for a bfloat16 xs: the
// products of the bfloat16 values summed in float32 (mma.sync m16n8k16, bf16
// in, f32 accumulate), the bias added in float32, the cell in float32, h and c
// rounded to bfloat16 (nearest even) at every step, the next step reading the
// rounded values. The saved activations (act) are float32 and the saved cell
// states (cseq, save_c) are float(bf16(c)), the c that the next step read.
// B2's backward computes in float32 from what the forward saved: its product
// dG_{t+1} . W_hh^T takes each float32 dG value as three bfloat16 terms hi +
// mid + lo (lstm_mma.cuh:split3_bf16), whose sum is the value exactly, times
// the bfloat16 W_hh, so every product is exact.
//
// Sums on the tensor core. mma.sync cuts its exact sum to float32 toward zero
// and aligns its accumulator input with the products, so a long running sum
// kept in the accumulator loses bits at every step. The projection therefore
// sums each k-step from zero and adds it in float32 (lstm_mma.cuh:
// mma_bf16_add); the recurrence keeps a warp's few k-steps (4 at H = 512) in
// the accumulator before the warps' partial sums are added in float32, and
// the one-step gates keep their running sum there (their outputs are rounded
// to bfloat16, and the forward's error does not compound). The backward's
// error compounds over T steps, and there the cut's bias toward zero was what
// put dG further from float64 than a float32 product: its hi terms' k-step
// sums are rounded to nearest (lstm_mma.cuh:mma_bf16_rn), and the mid and lo
// terms, 2^-8 of the value and less, run in the accumulator.
//
// Bound at the learner shape (T=80, B=128, H=512, L=2): a forward is 43 GFLOP
// in the projection and 21 in the recurrence, 0.065 ms at the tensor cores'
// 989 TFLOP/s; at the rollout shape [1, 2048], 17 GFLOP, 0.017 ms. The
// persistent kernels are T dependent steps, each a grid barrier and a round
// trip through L2, so a step's latency and not the rate bounds them.
//
// Design.
//  * Gates: a 128-row x 32-unit tile per block (128 columns: 4 gates x 32
//    units), 8 warps as 2 x 4, each warp 64 rows x 8 units of all four gates.
//    A warp's four n8 fragments are the four gates of the same 8 units, so a
//    lane's accumulators hold i, f, g and o of its units and the cell update
//    happens in registers. K tiles of 64 through a 3-stage ring of 16-byte
//    cp.async copies of bfloat16 rows; ldmatrix from rows padded by 16 bytes
//    (no bank conflicts), ldmatrix.trans for the [k][n] weight tile.
//  * Recurrence: lstm_seq.cu's shape: a block owns 32 rows x 16 units, a grid
//    barrier per step. Its W_hh slice ([H, 64] bfloat16, 64 KB) lives in
//    registers as mma B fragments for all T steps, each warp holding the
//    k-steps s = warp + 8 j (split K, H <= 512). Each step a warp reads its
//    k-range of h_{t-1} for the 32 rows straight into A fragments with 8-byte
//    loads through L2 (the k permutation of lstm_mma.cuh), runs its products
//    and writes its partial sums to shared memory; the 8 partial sums are then
//    added in warp order, so the result is the same from run to run.
//  * Backward: a block owns 16 rows x 32 units and keeps W_hh[its units, :]
//    (W_hh^T's [4H, 32] slice, 128 KB in bfloat16) in shared memory. Each
//    step every warp streams its K chunks of dG_{t+1}'s 16 rows (float32)
//    through a 4-stage cp.async ring of its own, splits each value into three
//    bfloat16 terms in registers and runs the terms' products against the
//    same B fragment; the warps' partial sums are added in warp order. dG
//    read through L2 per step: 16 unit tiles x B rows x 4H x 4 bytes = 16 MiB
//    at the learner shape (the float32 kernel's 16-unit tiles read 32 MiB).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_mma.cuh"
#include "lstm_tile.cuh"

namespace {

using namespace lstm;
namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// Shapes the bfloat16 route takes: H a multiple of H_MULTIPLE (the gates' K
// tile) and at most H_MAX (the recurrence's W_hh slice in registers, the
// backward's in shared memory).
constexpr int H_MULTIPLE = 64;
constexpr int H_MAX = 512;

// --- gates ------------------------------------------------------------------
constexpr int GM = 128;              // rows of a tile
constexpr int GU = 32;               // hidden units of a tile
constexpr int GN = 4 * GU;           // columns of a tile: wq * 32 + gate * 8 + j -> unit u0 + wq * 8 + j
constexpr int GK = 64;               // depth of a K tile
constexpr int G_STAGES = 3;
constexpr int GA_LD = GK + 8;        // bfloat16 per staged row of x|h: 144 B
constexpr int GW_LD = GN + 8;        // bfloat16 per staged row of W: 272 B
constexpr int GA_ELEMS = GM * GA_LD;
constexpr int GW_ELEMS = GK * GW_LD;
constexpr size_t G_SMEM = sizeof(bf16) * G_STAGES * (GA_ELEMS + GW_ELEMS);
static_assert(H_MULTIPLE % GK == 0 && H_MULTIPLE % GU == 0, "H tiles evenly");

// CELL: h_out = o * tanh(c), c_out = f * c_prev + i * g from gates = [a0 | a1]
// . [w0; w1] + bias, y (if given) = h_out too, save_act [M, 4H] and save_c
// [M, H] (if given) the activations and float(c_out). Without CELL:
// gates_out [M, 4H] = a0 . w0 + bias.
template <bool CELL>
__global__ void __launch_bounds__(THREADS, CELL ? 2 : 1) gates_kernel(
    const bf16* __restrict__ a0, const bf16* __restrict__ w0, int k0, const bf16* __restrict__ a1,
    const bf16* __restrict__ w1, int k1, const bf16* __restrict__ bias, const bf16* __restrict__ c_prev,
    float* __restrict__ gates_out, bf16* __restrict__ h_out, bf16* __restrict__ c_out, bf16* __restrict__ y,
    float* __restrict__ save_act, float* __restrict__ save_c, int M, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [G_STAGES][GM][GA_LD]
  bf16* Ws = As + G_STAGES * GA_ELEMS;            // [G_STAGES][GK][GW_LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wq = warp >> 1;  // rows wm * 64 + [0, 64), units wq * 8 + [0, 8)
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * GM, u0 = blockIdx.y * GU;
  const int G = 4 * H, nk = (k0 + k1) / GK;

  auto load_tile = [&](int kt, int stage) {
    int kb = kt * GK;
    const bf16* a = a0;
    const bf16* w = w0;
    int lda = k0;
    if (kb >= k0) {
      a = a1;
      w = w1;
      kb -= k0;
      lda = k1;
    }
    bf16* as = As + stage * GA_ELEMS;
    bf16* ws = Ws + stage * GW_ELEMS;
#pragma unroll
    for (int s = 0; s < GM * GK / 8 / THREADS; ++s) {
      const int q = tid + THREADS * s, r = q / (GK / 8), c = (q % (GK / 8)) * 8;
      int gr = m0 + r;
      gr = gr < M ? gr : M - 1;  // rows past M read row M - 1; their results are dropped
      cp_async16(as + r * GA_LD + c, a + (size_t)gr * lda + kb + c);
    }
#pragma unroll
    for (int s = 0; s < GK * GN / 8 / THREADS; ++s) {
      const int q = tid + THREADS * s, k = q / (GN / 8), c = (q % (GN / 8)) * 8;
      const int cq = c / 32, gate = (c / 8) % 4;
      cp_async16(ws + k * GW_LD + c, w + (size_t)(kb + k) * G + gate * H + u0 + cq * 8);
    }
  };

  // acc[mi][gate][.]: rows wm * 64 + mi * 16 + {g, g + 8}, units wq * 8 + 2t + {0, 1}.
  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < nk) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<G_STAGES - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();                // ... every thread's, and tile kt - 1's stage is free
    if (kt + G_STAGES - 1 < nk) load_tile(kt + G_STAGES - 1, (kt + G_STAGES - 1) % G_STAGES);
    cp_async_commit();
    const bf16* as = As + (kt % G_STAGES) * GA_ELEMS + wm * 64 * GA_LD;
    const bf16* ws = Ws + (kt % G_STAGES) * GW_ELEMS + wq * 32;
#pragma unroll
    for (int kk = 0; kk < GK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(a[mi], as + (mi * 16 + (lane & 15)) * GA_LD + kk + (lane >> 4) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4_trans(b[2 * p][0], b[2 * p][1], b[2 * p + 1][0], b[2 * p + 1][1],
                          ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * GW_LD + p * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (CELL)
            mma_bf16(acc[mi][j], a[mi], b[j][0], b[j][1]);
          else
            mma_bf16_add(acc[mi][j], a[mi], b[j][0], b[j][1]);
        }
    }
  }
  cp_async_wait<0>();

  const int u = u0 + wq * 8 + 2 * t;  // this lane's units u, u + 1
  float bs[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + j * H + u));
    bs[j][0] = v.x;
    bs[j][1] = v.y;
  }
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + 8 * half;
      if (row >= M) continue;
      float pre[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) pre[j][e] = acc[mi][j][2 * half + e] + bs[j][e];
      if (!CELL) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(gates_out + (size_t)row * G + j * H + u) = make_float2(pre[j][0], pre[j][1]);
        continue;
      }
      const size_t at = (size_t)row * H + u;
      const float2 cp = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(c_prev + at));
      float act[4][2], c_new[2], h_new[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        act[0][e] = sigmoid_f(pre[0][e]);
        act[1][e] = sigmoid_f(pre[1][e]);
        act[2][e] = tanhf(pre[2][e]);
        act[3][e] = sigmoid_f(pre[3][e]);
        c_new[e] = act[1][e] * (e == 0 ? cp.x : cp.y) + act[0][e] * act[2][e];
        h_new[e] = act[3][e] * tanhf(c_new[e]);
      }
      const __nv_bfloat162 c_st = __floats2bfloat162_rn(c_new[0], c_new[1]);
      const __nv_bfloat162 h_st = __floats2bfloat162_rn(h_new[0], h_new[1]);
      *reinterpret_cast<__nv_bfloat162*>(c_out + at) = c_st;
      *reinterpret_cast<__nv_bfloat162*>(h_out + at) = h_st;
      if (y != nullptr) *reinterpret_cast<__nv_bfloat162*>(y + at) = h_st;
      if (save_act != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(save_act + (size_t)row * G + j * H + u) = make_float2(act[j][0], act[j][1]);
      }
      if (save_c != nullptr) *reinterpret_cast<float2*>(save_c + at) = __bfloat1622float2(c_st);
    }
  }
}

// --- recurrence --------------------------------------------------------------
constexpr int R_ROWS = 32;                 // batch rows of a block's tile
constexpr int R_UNITS = 16;                // hidden units of a block's tile
constexpr int R_COLS = 4 * R_UNITS;        // its columns: gate * R_UNITS + unit
constexpr int R_KS = H_MAX / 16 / WARPS;   // k-steps of 16 a warp holds
constexpr int R_RED_LD = R_COLS + 8;       // floats per row of a warp's partial sums
constexpr size_t R_SMEM = sizeof(float) * WARPS * R_ROWS * R_RED_LD;

// One layer over T steps. gx [T, B, 4H] = x . w_ih + b (float); h0, c0 [B, H];
// hseq [T, B, H] receives every h_t; h_last, c_last [B, H] hT and cT (c_last
// holds the running c of the block's own elements between steps); act
// [T, B, 4H] and cseq [T, B, H] (may be null) the activations and every c_t.
__global__ void __launch_bounds__(THREADS, 1) recurrence_kernel(
    const float* __restrict__ gx, const bf16* h0, const bf16* __restrict__ c0, const bf16* __restrict__ w_hh,
    bf16* hseq, bf16* __restrict__ h_last, bf16* __restrict__ c_last, float* __restrict__ act,
    float* __restrict__ cseq, int T, int B, int H) {
  extern __shared__ __align__(16) float red[];  // [WARPS][R_ROWS][R_RED_LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int u0 = blockIdx.y * R_UNITS, G = 4 * H, nks = H / 16;
  const int row_tiles = (B + R_ROWS - 1) / R_ROWS;

  // This warp's k-steps s = warp + WARPS * j of the W_hh slice as B
  // fragments, k permuted (lstm_mma.cuh): wb[j][n][0] holds rows 16 s + 4t,
  // +1 and wb[j][n][1] rows 16 s + 4t + 2, +3 of the block's column 8 n + g.
  uint32_t wb[R_KS][8][2];
#pragma unroll
  for (int j = 0; j < R_KS; ++j) {
    const int s = warp + WARPS * j;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = 8 * n + g;
      const bf16* w = w_hh + (size_t)(16 * s + 4 * t) * G + (col / R_UNITS) * H + u0 + col % R_UNITS;
      wb[j][n][0] = s < nks ? pack_bf16(w[0], w[G]) : 0u;
      wb[j][n][1] = s < nks ? pack_bf16(w[2 * (size_t)G], w[3 * (size_t)G]) : 0u;
    }
  }

  cg::grid_group grid = cg::this_grid();
  for (int step = 0; step < T; ++step) {
    const bf16* h_prev = step == 0 ? h0 : hseq + (size_t)(step - 1) * B * H;
    for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
      const int r0 = rt * R_ROWS;
      // The epilogue's inputs first, so that their loads overlap the product
      // (loaded before the grid barrier instead, they delayed it): this
      // thread's elements p = tid + THREADS i, row r0 + p / R_UNITS, unit
      // u0 + p % R_UNITS.
      float gxv[2][4], c_in[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = tid + THREADS * i, row = min(r0 + p / R_UNITS, B - 1), U = u0 + p % R_UNITS;
        const float* gx_row = gx + ((size_t)step * B + row) * G + U;
#pragma unroll
        for (int q = 0; q < 4; ++q) gxv[i][q] = gx_row[q * H];
        c_in[i] = __bfloat162float(step == 0 ? c0[(size_t)row * H + U] : c_last[(size_t)row * H + U]);
      }
      // h_{t-1}'s rows r0 .. r0 + 31 over this warp's k-steps, through L2
      // (other blocks wrote them before the last grid barrier).
      uint32_t a[R_KS][2][4];
#pragma unroll
      for (int j = 0; j < R_KS; ++j) {
        const int s = warp + WARPS * j;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = min(r0 + mi * 16 + g + 8 * half, B - 1);
            uint2 v = make_uint2(0u, 0u);
            if (s < nks) v = __ldcg(reinterpret_cast<const uint2*>(h_prev + (size_t)row * H + 16 * s + 4 * t));
            a[j][mi][half] = v.x;
            a[j][mi][2 + half] = v.y;
          }
      }
      float acc[2][8][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < R_KS; ++j) {
        if (warp + WARPS * j >= nks) break;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < 8; ++n) mma_bf16(acc[mi][n], a[j][mi], wb[j][n][0], wb[j][n][1]);
      }
      float* mine = red + warp * R_ROWS * R_RED_LD;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int r = mi * 16 + g, c = 8 * n + 2 * t;
          *reinterpret_cast<float2*>(mine + r * R_RED_LD + c) = make_float2(acc[mi][n][0], acc[mi][n][1]);
          *reinterpret_cast<float2*>(mine + (r + 8) * R_RED_LD + c) = make_float2(acc[mi][n][2], acc[mi][n][3]);
        }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = tid + THREADS * i, r = p / R_UNITS, u = p % R_UNITS, row = r0 + r;
        if (row >= B) continue;
        const int U = u0 + u;
        float pre[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float s = 0.0f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) s += red[(w * R_ROWS + r) * R_RED_LD + q * R_UNITS + u];
          pre[q] = s + gxv[i][q];
        }
        const size_t at = (size_t)row * H + U;
        const float ig = sigmoid_f(pre[0]), fg = sigmoid_f(pre[1]);
        const float gg = tanhf(pre[2]), og = sigmoid_f(pre[3]);
        const float c_new = fg * c_in[i] + ig * gg;
        const bf16 c_st = __float2bfloat16_rn(c_new), h_st = __float2bfloat16_rn(og * tanhf(c_new));
        c_last[at] = c_st;
        hseq[(size_t)step * B * H + at] = h_st;
        if (step == T - 1) h_last[at] = h_st;
        if (act != nullptr) {
          float* s = act + ((size_t)step * B + row) * G + U;
          s[0] = ig;
          s[H] = fg;
          s[2 * H] = gg;
          s[3 * H] = og;
        }
        if (cseq != nullptr) cseq[(size_t)step * B * H + at] = __bfloat162float(c_st);
      }
      __syncthreads();  // the partial sums are read before the next tile's
    }
    if (step + 1 < T) grid.sync();
  }
}

// --- backward ----------------------------------------------------------------
constexpr int D_ROWS = 16;                                 // batch rows of a block's tile
constexpr int D_UNITS = 32;                                // hidden units of a block's tile
constexpr int D_KC = 32;                                   // K of one chunk of dG (2 k-steps)
constexpr int D_STAGES = 4;
constexpr int D_CHUNK_FLOATS = D_ROWS * D_KC;              // rows of 8 16-byte pieces, swizzled
constexpr int D_RING_FLOATS = WARPS * D_STAGES * D_CHUNK_FLOATS;
constexpr int D_RED_LD = D_UNITS + 8;                      // floats per row of a warp's partial sums
static_assert(WARPS * D_ROWS * D_RED_LD <= D_RING_FLOATS, "the partial sums fit in the ring");

// Row stride of the shared W_hh slice in bfloat16: 4H + 16 puts the rows of
// a fragment's 8 columns 32 bytes apart modulo 128, so the 8-byte reads of a
// half warp hit distinct banks.
__host__ __device__ inline int bwd_w_ld(int H) { return 4 * H + 16; }
inline size_t bwd_smem_bytes(int H) {
  return sizeof(float) * D_RING_FLOATS + sizeof(bf16) * (size_t)D_UNITS * bwd_w_ld(H);
}

// The 16-byte piece c of row r of a staged chunk: pieces of odd rows are
// swapped by halves, so that rows g and g + 1 of a quarter warp's 16-byte
// reads fall in opposite halves of the banks.
__device__ __forceinline__ int piece(int r, int c) { return r * D_KC + ((c ^ ((r & 1) << 2)) << 2); }

// dout [T, B, H]; gh, gc [B, H] or null (zeros); act [T, B, 4H] the gate
// activations; cseq [T, B, H] the cell states; c0 [B, H]; w_hh [H, 4H].
// Writes dg [T, B, 4H], dh0 and dc0 [B, H] (dc0 holds the carry dc * f of
// the block's own elements between steps).
__global__ void __launch_bounds__(THREADS, 1) bwd_kernel(
    const float* __restrict__ dout, const float* __restrict__ gh, const float* __restrict__ gc,
    const float* __restrict__ act, const float* __restrict__ cseq, const bf16* __restrict__ c0,
    const bf16* __restrict__ w_hh, float* dg, float* __restrict__ dh0, float* __restrict__ dc0, int T, int B,
    int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);      // cp.async stages, then the partial sums
  bf16* Ws = reinterpret_cast<bf16*>(ring + D_RING_FLOATS);  // [D_UNITS][w_ld]: Ws[n][k] = w_hh[u0 + n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int u0 = blockIdx.y * D_UNITS, G = 4 * H, w_ld = bwd_w_ld(H);
  const int row_tiles = (B + D_ROWS - 1) / D_ROWS;
  const int nch = G / D_KC;
  const int mine = warp < nch ? (nch - warp + WARPS - 1) / WARPS : 0;  // chunks warp + WARPS m
  float* my_ring = ring + warp * D_STAGES * D_CHUNK_FLOATS;

  for (int q = tid; q < D_UNITS * (G / 8); q += THREADS) {
    const int n = q / (G / 8), c = (q % (G / 8)) * 8;
    cp_async16(Ws + n * w_ld + c, w_hh + (size_t)(u0 + n) * G + c);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  // step = -1 is the last product alone: dh0 = dG_0 . W_hh^T.
  for (int step = T - 1; step >= -1; --step) {
    const bool rec = step < T - 1;
    for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
      const int r0 = rt * D_ROWS;
      // The epilogue's inputs first: this thread's elements p = tid +
      // THREADS i, row r0 + p / D_UNITS, unit u0 + p % D_UNITS.
      float d_out[2] = {}, a4[2][4] = {}, ct[2] = {}, c_prev[2] = {}, carry[2] = {};
      if (step >= 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int p = tid + THREADS * i, row = min(r0 + p / D_UNITS, B - 1), U = u0 + p % D_UNITS;
          const size_t at = (size_t)row * H + U;
          d_out[i] = dout[(size_t)step * B * H + at];
          if (!rec && gh != nullptr) d_out[i] += gh[at];
          const float* a = act + ((size_t)step * B + row) * G + U;
#pragma unroll
          for (int q = 0; q < 4; ++q) a4[i][q] = a[q * H];
          ct[i] = cseq[(size_t)step * B * H + at];
          c_prev[i] = step > 0 ? cseq[(size_t)(step - 1) * B * H + at] : __bfloat162float(c0[at]);
          carry[i] = rec ? dc0[at] : (gc != nullptr ? gc[at] : 0.0f);
        }
      }
      if (rec) {
        const float* A = dg + (size_t)(step + 1) * B * G;
        // Chunk m of this warp: K range [(warp + m WARPS) D_KC, + D_KC) of
        // rows r0 .. r0 + 15, 4 copies a lane.
        auto load = [&](int m) {
          const int k0 = (warp + m * WARPS) * D_KC;
          float* st = my_ring + (m % D_STAGES) * D_CHUNK_FLOATS;
#pragma unroll
          for (int s = 0; s < D_ROWS * D_KC / 4 / 32; ++s) {
            const int q = lane + 32 * s, r = q >> 3, c = q & 7;
            const int row = min(r0 + r, B - 1);
            cp_async16(st + piece(r, c), A + (size_t)row * G + k0 + 4 * c);
          }
        };
        // acc: the hi terms' k-step sums, each rounded (mma_bf16_rn) and
        // added in float32; lo: the mid and lo terms' products, 2^-8 of the
        // value and less, summed on the tensor core.
        float acc[4][4], lo[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = lo[n][e] = 0.0f;
#pragma unroll
        for (int m = 0; m < D_STAGES - 1; ++m) {
          if (m < mine) load(m);
          cp_async_commit();
        }
        for (int m = 0; m < mine; ++m) {
          cp_async_wait<D_STAGES - 2>();  // chunk m has landed
          __syncwarp();                   // ... for every lane, and chunk m - 1's stage is free
          if (m + D_STAGES - 1 < mine) load(m + D_STAGES - 1);
          cp_async_commit();
          const float* st = my_ring + (m % D_STAGES) * D_CHUNK_FLOATS;
          const bf16* wk = Ws + (warp + m * WARPS) * D_KC + 4 * t;
#pragma unroll
          for (int ks = 0; ks < D_KC / 16; ++ks) {
            const float4 x = *reinterpret_cast<const float4*>(st + piece(g, 4 * ks + t));
            const float4 y = *reinterpret_cast<const float4*>(st + piece(g + 8, 4 * ks + t));
            uint32_t a[3][4];  // a[term]: the A fragment of hi, mid, lo (rows g: x, g + 8: y)
            split3_bf16(x.x, x.y, a[0][0], a[1][0], a[2][0]);
            split3_bf16(y.x, y.y, a[0][1], a[1][1], a[2][1]);
            split3_bf16(x.z, x.w, a[0][2], a[1][2], a[2][2]);
            split3_bf16(y.z, y.w, a[0][3], a[1][3], a[2][3]);
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const uint2 b = *reinterpret_cast<const uint2*>(wk + (8 * n + g) * w_ld + 16 * ks);
              float d[4];
              mma_bf16_rn(d, a[0], b.x, b.y);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
              mma_bf16(lo[n], a[2], b.x, b.y);
              mma_bf16(lo[n], a[1], b.x, b.y);
            }
          }
        }
        cp_async_wait<0>();
        __syncthreads();  // every warp is done with its ring before it holds the partial sums
        float* red = ring + warp * D_ROWS * D_RED_LD;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = 8 * n + 2 * t;
          *reinterpret_cast<float2*>(red + g * D_RED_LD + c) = make_float2(acc[n][0] + lo[n][0], acc[n][1] + lo[n][1]);
          *reinterpret_cast<float2*>(red + (g + 8) * D_RED_LD + c) =
              make_float2(acc[n][2] + lo[n][2], acc[n][3] + lo[n][3]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = tid + THREADS * i, r = p / D_UNITS, u = p % D_UNITS, row = r0 + r;
        if (row >= B) continue;
        const size_t at = (size_t)row * H + u0 + u;
        float dh_rec = 0.0f;
        if (rec) {
#pragma unroll
          for (int w = 0; w < WARPS; ++w) dh_rec += ring[(w * D_ROWS + r) * D_RED_LD + u];
        }
        if (step < 0) {
          dh0[at] = dh_rec;
          continue;
        }
        const float dh = d_out[i] + dh_rec;
        const float ig = a4[i][0], fg = a4[i][1], gg = a4[i][2], og = a4[i][3];
        const float tc = tanhf(ct[i]);
        const float dc = dh * og * (1.0f - tc * tc) + carry[i];
        float* d = dg + ((size_t)step * B + row) * G + u0 + u;
        d[0] = dc * gg * ig * (1.0f - ig);
        d[H] = dc * c_prev[i] * fg * (1.0f - fg);
        d[2 * H] = dc * ig * (1.0f - gg * gg);
        d[3 * H] = dh * tc * og * (1.0f - og);
        dc0[at] = dc * fg;
      }
      __syncthreads();  // the partial sums are read before the ring is refilled
    }
    if (step >= 0) grid.sync();
  }
}

bool h_ok(int H) { return H > 0 && H % H_MULTIPLE == 0 && H <= H_MAX; }

}  // namespace

// Launches the bfloat16 gates kernel on `stream`: with c_prev (CELL), gates
// over [a0 | a1] . [w0; w1] + bias, the cell update, h_out, c_out, y (may be
// null), save_act / save_c (may be null); gates_out is ignored. Without
// c_prev: gates_out = a0 . w0 + bias, and a1, w1, k1 and the cell pointers
// are ignored. Every pointer 16-byte aligned, k0 and k1 multiples of 64, H as
// lstm_bf16_h_ok. Returns a CUDA error code (0 on success).
extern "C" int lstm_gates_bf16(const bf16* a0, const bf16* w0, int k0, const bf16* a1, const bf16* w1, int k1,
                               const bf16* bias, const bf16* c_prev, float* gates_out, bf16* h_out, bf16* c_out,
                               bf16* y, float* save_act, float* save_c, int M, int H, void* stream) {
  const bool cell = c_prev != nullptr;
  if (!cell) k1 = 0;
  if (M <= 0 || !h_ok(H) || k0 <= 0 || k0 % GK != 0 || k1 < 0 || k1 % GK != 0) return (int)cudaErrorInvalidValue;
  if (cell && (k1 == 0 || h_out == nullptr || c_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (!cell && gates_out == nullptr) return (int)cudaErrorInvalidValue;
  const void* kernel = cell ? (const void*)gates_kernel<true> : (const void*)gates_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + GM - 1) / GM, H / GU);
  cudaStream_t s = (cudaStream_t)stream;
  if (cell)
    gates_kernel<true><<<grid, THREADS, G_SMEM, s>>>(a0, w0, k0, a1, w1, k1, bias, c_prev, nullptr, h_out, c_out,
                                                     y, save_act, save_c, M, H);
  else
    gates_kernel<false><<<grid, THREADS, G_SMEM, s>>>(a0, w0, k0, nullptr, nullptr, 0, bias, nullptr, gates_out,
                                                      nullptr, nullptr, nullptr, nullptr, nullptr, M, H);
  return (int)cudaGetLastError();
}

// Launches the bfloat16 recurrence kernel cooperatively on `stream`: gx, act
// and cseq float, the rest bfloat16. Returns a CUDA error code: nonzero if H
// is refused or the launch is (more unit tiles than the card holds at once).
extern "C" int lstm_recurrence_bf16(const float* gx, const bf16* h0, const bf16* c0, const bf16* w_hh, bf16* hseq,
                                    bf16* h_last, bf16* c_last, float* act, float* cseq, int T, int B, int H,
                                    void* stream) {
  if (T <= 0 || B <= 0 || !h_ok(H)) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&gx, (void*)&h0, (void*)&c0, (void*)&w_hh, (void*)&hseq, (void*)&h_last,
                  (void*)&c_last, (void*)&act, (void*)&cseq, (void*)&T, (void*)&B, (void*)&H};
  const cudaError_t err = launch_persistent((const void*)recurrence_kernel, (B + R_ROWS - 1) / R_ROWS,
                                            H / R_UNITS, R_SMEM, args, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches the bfloat16 backward kernel cooperatively on `stream`: c0 and w_hh
// bfloat16 (a bfloat16 forward's), the rest float. gh and gc may be null.
// Returns a CUDA error code as lstm_recurrence_bf16.
extern "C" int lstm_bwd_bf16(const float* dout, const float* gh, const float* gc, const float* act,
                             const float* cseq, const bf16* c0, const bf16* w_hh, float* dg, float* dh0, float* dc0,
                             int T, int B, int H, void* stream) {
  if (T <= 0 || B <= 0 || !h_ok(H)) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&dout, (void*)&gh, (void*)&gc, (void*)&act, (void*)&cseq, (void*)&c0,
                  (void*)&w_hh, (void*)&dg, (void*)&dh0, (void*)&dc0, (void*)&T, (void*)&B, (void*)&H};
  const cudaError_t err = launch_persistent((const void*)bwd_kernel, (B + D_ROWS - 1) / D_ROWS, H / D_UNITS,
                                            bwd_smem_bytes(H), args, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The shapes the bfloat16 route takes: H a multiple of lstm_bf16_h_multiple()
// and at most lstm_bf16_h_max().
extern "C" int lstm_bf16_h_multiple() { return H_MULTIPLE; }
extern "C" int lstm_bf16_h_max() { return H_MAX; }

// Kernel B1: one LSTM cell step of one layer, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel hanabi_sad_tpu/ops/experimental/pallas_lstm.py:
// lstm_seq_pallas (pallas_call at line 166, kernel _kernel), which runs every
// time step and layer of a multi-layer LSTM in one launch with the weights
// resident in VMEM. Here the wrapper (ops/lstm_seq.py) launches this kernel
// once per (time step, layer); h and c ping-pong between two buffers, so no
// block ever reads a row that another block is writing.
//
// Layout: x, h_prev, c_prev, h_out, c_out, y are [B, H] row-major; w_ih and
// w_hh are [H, 4H] (in_dim == H); b is [4H]; gate order i, f, g, o.
//
// Block layout: grid (ceil(B/BM), H/BN). A block owns BM rows x BN hidden
// units for all four gates: columns j, H+j, 2H+j, 3H+j of w_ih / w_hh. It
// accumulates x.w_ih + h.w_hh over K = 2H in float32 FMA (no TF32) from
// shared-memory tiles, adds b, applies the gate nonlinearities and the cell
// update in registers and writes h and c, so the 4H gate pre-activations
// never reach device memory. Rows past B are masked (B = 1000 is not a
// multiple of BM).
//
// Bound: at the eval shape (T=1, L=2, B=1000, H=512) one call does
// 2 * L * B * 2H * 4H = 8.39 GFLOP, 0.125 ms at the card's 67 TFLOP/s of
// float32 outside the tensor cores, against about 37 MB of traffic
// (weights 16.8 MB, activations and state 20 MB) = 0.011 ms at 3.35 TB/s.
// So it is bound by float32 arithmetic. This first design does nothing about
// that yet: it is plain FMA on the CUDA cores, correctness first.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 32;       // rows of the batch per block
constexpr int BN = 32;       // hidden units per block (times 4 gates)
constexpr int BK = 32;       // depth of a shared-memory tile
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = BM * BN / THREADS;  // 4

__device__ __forceinline__ float sigmoid_f(float v) { return 1.0f / (1.0f + expf(-v)); }

__global__ void __launch_bounds__(THREADS) lstm_cell_kernel(
    const float* __restrict__ x, const float* __restrict__ h_prev,
    const float* __restrict__ c_prev, const float* __restrict__ w_ih,
    const float* __restrict__ w_hh, const float* __restrict__ bias,
    float* __restrict__ h_out, float* __restrict__ c_out, float* __restrict__ y,
    int B, int H) {
  __shared__ float a_tile[BK][BM + 1];   // a_tile[k][m]: rows of [x | h]
  __shared__ float w_tile[BK][4 * BN];   // w_tile[k][g * BN + j]

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int j = tid % BN;                          // hidden unit in the tile
  const int m0 = (tid / BN) * ROWS_PER_THREAD;     // first row in the tile
  const int G = 4 * H;

  float acc[ROWS_PER_THREAD][4];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[r][g] = 0.0f;

  for (int k0 = 0; k0 < 2 * H; k0 += BK) {
    // H is a multiple of BK, so a tile lies wholly in the x half or the h half.
    const bool in_x = k0 < H;
    const float* a_src = in_x ? x : h_prev;
    const float* w_src = in_x ? w_ih : w_hh;
    const int kb = in_x ? k0 : k0 - H;

    for (int e = tid; e < BM * BK; e += THREADS) {
      const int m = e / BK, k = e % BK;
      const int row = row0 + m;
      a_tile[k][m] = row < B ? a_src[(size_t)row * H + kb + k] : 0.0f;
    }
    for (int e = tid; e < BK * 4 * BN; e += THREADS) {
      const int k = e / (4 * BN), q = e % (4 * BN);
      const int g = q / BN, jj = q % BN;
      w_tile[k][q] = w_src[(size_t)(kb + k) * G + g * H + col0 + jj];
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[ROWS_PER_THREAD], w[4];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r) a[r] = a_tile[k][m0 + r];
#pragma unroll
      for (int g = 0; g < 4; ++g) w[g] = w_tile[k][g * BN + j];
#pragma unroll
      for (int r = 0; r < ROWS_PER_THREAD; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = fmaf(a[r], w[g], acc[r][g]);
    }
    __syncthreads();
  }

  const int col = col0 + j;
  const float bi = bias[col], bf = bias[H + col], bg = bias[2 * H + col], bo = bias[3 * H + col];
#pragma unroll
  for (int r = 0; r < ROWS_PER_THREAD; ++r) {
    const int row = row0 + m0 + r;
    if (row >= B) continue;
    const size_t at = (size_t)row * H + col;
    const float i_g = sigmoid_f(acc[r][0] + bi);
    const float f_g = sigmoid_f(acc[r][1] + bf);
    const float g_g = tanhf(acc[r][2] + bg);
    const float o_g = sigmoid_f(acc[r][3] + bo);
    const float c_new = f_g * c_prev[at] + i_g * g_g;
    const float h_new = o_g * tanhf(c_new);
    c_out[at] = c_new;
    h_out[at] = h_new;
    if (y != nullptr) y[at] = h_new;
  }
}

}  // namespace

// Launches one cell step on `stream`; returns cudaGetLastError() after the
// launch (0 on success). y may be null; when given, it receives h_out too.
extern "C" int lstm_cell_f32(const float* x, const float* h_prev, const float* c_prev,
                             const float* w_ih, const float* w_hh, const float* bias,
                             float* h_out, float* c_out, float* y, int B, int H,
                             void* stream) {
  if (B <= 0 || H <= 0 || H % BN != 0 || H % BK != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + BM - 1) / BM, H / BN);
  lstm_cell_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, h_prev, c_prev, w_ih, w_hh, bias, h_out, c_out, y, B, H);
  return (int)cudaGetLastError();
}

// The multiple of which H must be (BN and BK divide it).
extern "C" int lstm_cell_h_multiple() { return BN > BK ? BN : BK; }

// Kernel B2's backward: the recurrence of backpropagation through time of
// one LSTM layer, over the gates that B1's forward stored, for Hopper
// (sm_90a).
//
// Replaces the backward of the TPU kernel hanabi_sad_tpu/ops/experimental/
// pallas_lstm.py:lstm_seq_pallas_diff (custom_vjp at 212-230, _diff_bwd at
// 222-227), which takes the VJP of the scan: the same gradients, here
// without recomputing the forward. For t = T-1 ... 0:
//
//   dh_t = dout_t + dG_{t+1} . W_hh^T        (g_h at t = T-1)
//   dc_t = dh_t * o_t * (1 - tanh^2 c_t) + dc_{t+1} * f_{t+1}   (g_c at T-1)
//   dG_t = [dc g i (1-i), dc c_{t-1} f (1-f), dc i (1-g^2), dh tanh(c_t) o (1-o)]
//
// and at the end dh0 = dG_0 . W_hh^T, dc0 = dc_0 * f_0. dout is the grad of
// the layer's h sequence: the grad of the outputs for the top layer, the
// upper layer's dX for a lower one. The products that do not recur (dW_ih,
// dW_hh, db, dX) are large matrix products over all T * B rows and are left
// to the wrapper (ops/lstm_seq.py), as the JAX package leaves them to XLA.
//
// Design: one persistent launch per layer with the shape of B1's recurrence
// (lstm_seq.cu). A block owns 32 rows x 16 hidden units and keeps the
// matching rows of W_hh (16 x 4H floats, stored transposed as [4H][16]:
// 128 KB at H = 512) in dynamic shared memory for all steps. Each step it
// reads dG_{t+1} for its rows through L2 (all 4H columns, written by every
// block in the step before), multiplies with lstm_tile.cuh's split-K
// TileProduct (K = 4H), adds the partial sums in a fixed order, and its
// owner threads compute dh, dc and the four dG columns of their elements.
// The carry dc * f lives in dc0, which each owner alone reads and writes.
// Then a grid barrier. No atomics: the same inputs give the same bits.
//
// Types: W_hh and c0 are float (lstm_bwd_f32) or bfloat16 (lstm_bwd_bf16),
// the weights and the initial cell of a bfloat16 forward; everything else,
// dout, gh, gc, the saved gates and cell states, dG, dh0 and dc0, is float
// in both: the backward of a bfloat16 forward is computed in float from what
// the forward saved (the cell states saved rounded to bfloat16, as the
// forward read them).
//
// Bound: the recurrent product is 2 * T * B * H * 4H operations per layer,
// a third of the backward's (2.7 GFLOP per layer at T=80, B=128, H=512,
// 0.04 ms at 67 TFLOP/s), but it is T dependent steps: it is set by the
// latency of a step (a barrier, a 256 KB read of dG per block), not by the
// card's rate.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_tile.cuh"

namespace {

using namespace lstm;
namespace cg = cooperative_groups;

// dout [T, B, H]; gh, gc [B, H] or null (zeros); act [T, B, 4H] the gate
// activations; cseq [T, B, H] the cell states; c0 [B, H]; w_hh [H, 4H].
// Writes dg [T, B, 4H], dh0 and dc0 [B, H].
template <typename Elem>
__global__ void __launch_bounds__(THREADS, 1) lstm_bwd_kernel(
    const float* __restrict__ dout, const float* __restrict__ gh, const float* __restrict__ gc,
    const float* __restrict__ act, const float* __restrict__ cseq, const Elem* __restrict__ c0,
    const Elem* __restrict__ w_hh, float* dg, float* __restrict__ dh0, float* __restrict__ dc0,
    int T, int B, int H) {
  constexpr int N = UNITS;
  using P = TileProduct<N, 4, 4>;
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;                       // [4H][N]: Ws[k][u] = w_hh[u0 + u][k]
  float* ring = smem + (size_t)4 * H * N;  // cp.async stages, then the partial sums

  const int tid = threadIdx.x;
  const int u0 = blockIdx.y * UNITS, G = 4 * H;
  const int row_tiles = (B + ROWS - 1) / ROWS;
  for (int q = tid; q < N * G; q += THREADS) {
    const int u = q / G, k = q % G;
    Ws[k * N + u] = to_f32(w_hh[(size_t)(u0 + u) * G + k]);
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  // t = -1 is the last product alone: dh0 = dG_0 . W_hh^T.
  for (int t = T - 1; t >= -1; --t) {
    const bool rec = t < T - 1;
    for (int rt = blockIdx.x; rt < row_tiles; rt += gridDim.x) {
      const int r0 = rt * ROWS;
      if (rec) {
        float acc[4][4];
        P::run(dg + (size_t)(t + 1) * B * G, G, G, r0, B, Ws, ring, acc);
        __syncthreads();
        P::store(acc, ring);
        __syncthreads();
      }
      for (int p = tid; p < ROWS * UNITS; p += THREADS) {
        const int r = p / UNITS, u = p % UNITS, row = r0 + r;
        if (row >= B) continue;
        const int U = u0 + u;
        const size_t at = (size_t)row * H + U;
        const float dh_rec = rec ? P::sum(ring, r, u) : 0.0f;
        if (t < 0) {
          dh0[at] = dh_rec;
          continue;
        }
        float dh = dout[(size_t)t * B * H + at] + dh_rec;
        if (!rec && gh != nullptr) dh += gh[at];
        const float* a = act + ((size_t)t * B + row) * G + U;
        const float ig = a[0], fg = a[H], gg = a[2 * H], og = a[3 * H];
        const float ct = cseq[(size_t)t * B * H + at];
        const float c_prev = t > 0 ? cseq[(size_t)(t - 1) * B * H + at] : to_f32(c0[at]);
        const float tc = tanhf(ct);
        float dc = dh * og * (1.0f - tc * tc);
        dc += rec ? dc0[at] : (gc != nullptr ? gc[at] : 0.0f);
        float* d = dg + ((size_t)t * B + row) * G + U;
        d[0] = dc * gg * ig * (1.0f - ig);
        d[H] = dc * c_prev * fg * (1.0f - fg);
        d[2 * H] = dc * ig * (1.0f - gg * gg);
        d[3 * H] = dh * tc * og * (1.0f - og);
        dc0[at] = dc * fg;
      }
      __syncthreads();  // the sums are read before the ring is refilled
    }
    if (t >= 0) grid.sync();
  }
}

// Launches lstm_bwd_kernel<Elem> cooperatively on `stream` (see lstm_bwd_f32).
template <typename Elem>
int launch_bwd(const float* dout, const float* gh, const float* gc, const float* act, const float* cseq,
               const Elem* c0, const Elem* w_hh, float* dg, float* dh0, float* dc0, int T, int B, int H,
               void* stream) {
  if (T <= 0 || B <= 0 || H <= 0 || H % UNITS != 0) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&dout, (void*)&gh, (void*)&gc, (void*)&act, (void*)&cseq, (void*)&c0,
                  (void*)&w_hh, (void*)&dg, (void*)&dh0, (void*)&dc0, (void*)&T, (void*)&B, (void*)&H};
  const cudaError_t err = launch_persistent((const void*)lstm_bwd_kernel<Elem>, (B + ROWS - 1) / ROWS,
                                            H / UNITS, persistent_smem_bytes(4 * H, UNITS), args,
                                            (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches lstm_bwd_kernel cooperatively on `stream` (see above). gh and gc
// may be null. Returns a CUDA error code: nonzero if the launch was refused
// (shared memory, or more unit tiles than the card holds at once).
extern "C" int lstm_bwd_f32(const float* dout, const float* gh, const float* gc, const float* act,
                            const float* cseq, const float* c0, const float* w_hh, float* dg,
                            float* dh0, float* dc0, int T, int B, int H, void* stream) {
  return launch_bwd<float>(dout, gh, gc, act, cseq, c0, w_hh, dg, dh0, dc0, T, B, H, stream);
}

// lstm_bwd_f32 for a bfloat16 forward: c0 and w_hh are bfloat16, the rest
// float.
extern "C" int lstm_bwd_bf16(const float* dout, const float* gh, const float* gc, const float* act,
                             const float* cseq, const __nv_bfloat16* c0, const __nv_bfloat16* w_hh,
                             float* dg, float* dh0, float* dc0, int T, int B, int H, void* stream) {
  return launch_bwd<__nv_bfloat16>(dout, gh, gc, act, cseq, c0, w_hh, dg, dh0, dc0, T, B, H, stream);
}

// Kernel B3: from the replay's sampled indices to the learner's Batch in one
// pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel hanabi_sad_tpu/ops/experimental/pallas_replay.py:
// gather_unpack_pallas (pallas_call at line 68, kernel _kernel), which
// scalar-prefetches the sampled indices, lets the BlockSpec index map fetch
// the selected episodes' packed rows into VMEM and writes them unpacked
// "straight to the consumer's layout". Here the consumer's layout is the
// learner Batch (agent/r2d2_agent.py:Batch), time-major and split into its
// fields, so this kernel also does what replay/prioritized.py:rows_to_batch
// does after the gather in the JAX package: the field split, the transpose
// to [T, B, ...], the gathers of the side fields and `terminal`.
//
// Inputs: packed [cap, T, Pi, NB] uint8 (per player F + A + 3h bits,
// little-endian: bit k of byte j is feature 8j + k), action [cap, T, Pi]
// int64, reward and bootstrap [cap, T] float32, seq_len [cap] float32, idx
// [B] int64. Outputs, each contiguous and written once:
//   priv_s [T, B, Pi, F], legal_move [T, B, Pi, A], own_hand [T, B, Pi, 3h]
//   float32 of 0/1; action [T, B, Pi] int64; reward, bootstrap, terminal
//   [T, B] float32, terminal = (t >= seq_len - 1); seq_len [B] float32.
//
// Index rule, as JAX's `x[idx]` reads it (ops/gather_unpack.py:jax_index):
// an index in [-cap, -1] counts from the end, what still lies outside
// [0, cap) is clamped into it. The kernel never reads outside the buffer.
//
// Bound: at the flagship shape (B = 64, T = 80, Pi = 2, F = 838, A = 21,
// h = 5, NB = 110) it writes 35.94 MB (priv_s 34,324,480 B, legal_move
// 860,160 B, own_hand 614,400 B, action 81,920 B, reward + bootstrap +
// terminal 61,440 B) and reads 1.25 MB (1,126,400 B of packed bytes and
// 124 KB of side fields and indices): 37.2 MB, bound by bytes, 11.1 us at
// 3.35 TB/s. It does no arithmetic to speak of.
//
// Design. Block (x, t) owns time step t and a run of EPB consecutive batch
// entries b0 .. b0 + EPB - 1, which is one contiguous span of every output
// field. It stages the span's packed rows (EPB x Pi x NB bytes, one
// contiguous row of Pi * NB bytes per entry, 4-byte loads where the rows
// allow them) in shared memory, unpacks each field from there, and stores
// it with aligned 16-byte stores: the span is not bound to row edges (a row
// of 838 floats is only 8-byte aligned), so a field's head and tail of at
// most 3 floats each are stored one by one. A warp stores 512 consecutive
// bytes per instruction. The same block writes the span's side fields. The
// stores are plain (cacheable): the 36 MB Batch fits the 50 MB L2, and the
// trunk's product reads priv_s right after. No reductions, so the output
// does not depend on the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int EPB = 4;  // batch entries per block

struct Dims {
  long long cap;
  int T, B, Pi, NB, F, A, H3;
};

// One bit field of the staged rows into dst[start .. start + n), where row r
// of the span (r = local entry * Pi + player) has its field at bits
// off .. off + W - 1 of staged row r. dst is 16-byte aligned.
__device__ __forceinline__ void unpack_field(float* __restrict__ dst, long long start, int n, int W,
                                             int off, const uint8_t* __restrict__ rows, int NB) {
  const long long end = start + n;
  const long long v0 = (start + 3) >> 2, v1 = end >> 2;  // whole float4s [v0, v1)
  for (long long v = v0 + threadIdx.x; v < v1; v += THREADS) {
    int g = (int)(4 * v - start);
    int r = g / W, f = g - r * W;
    float x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pos = off + f;
      x[k] = (float)((rows[r * NB + (pos >> 3)] >> (pos & 7)) & 1u);
      if (++f == W) {
        f = 0;
        ++r;
      }
    }
    reinterpret_cast<float4*>(dst)[v] = make_float4(x[0], x[1], x[2], x[3]);
  }
  // head [start, head_end) and tail [tail_begin, end), at most 3 floats each
  const long long head_end = end < 4 * v0 ? end : 4 * v0;
  const long long tail_begin = head_end > 4 * v1 ? head_end : 4 * v1;
  const int n_head = (int)(head_end - start), n_tail = (int)(end - tail_begin);
  if ((int)threadIdx.x < n_head + n_tail) {
    const long long a = (int)threadIdx.x < n_head ? start + threadIdx.x
                                                   : tail_begin + (threadIdx.x - n_head);
    const int g = (int)(a - start), r = g / W, pos = off + g - r * W;
    dst[a] = (float)((rows[r * NB + (pos >> 3)] >> (pos & 7)) & 1u);
  }
}

__global__ void __launch_bounds__(THREADS) sample_batch_kernel(
    const uint8_t* __restrict__ packed, const long long* __restrict__ action,
    const float* __restrict__ reward, const float* __restrict__ bootstrap,
    const float* __restrict__ seq_len, const long long* __restrict__ idx, float* __restrict__ priv_s,
    float* __restrict__ legal, float* __restrict__ own_hand, long long* __restrict__ out_action,
    float* __restrict__ out_reward, float* __restrict__ out_bootstrap,
    float* __restrict__ out_terminal, float* __restrict__ out_seq_len, Dims d) {
  extern __shared__ __align__(16) uint8_t rows[];  // [EPB][Pi][NB]
  __shared__ long long src[EPB];
  const int t = blockIdx.y, b0 = blockIdx.x * EPB;
  const int ne = d.B - b0 < EPB ? d.B - b0 : EPB;  // entries of this block
  if ((int)threadIdx.x < ne) {
    long long s = idx[b0 + threadIdx.x];
    if (s < 0) s += d.cap;
    src[threadIdx.x] = s < 0 ? 0 : (s >= d.cap ? d.cap - 1 : s);
  }
  __syncthreads();

  // stage the packed rows: entry e's step t is Pi * NB contiguous bytes
  const int row_bytes = d.Pi * d.NB;
  if ((row_bytes & 3) == 0 && (reinterpret_cast<uintptr_t>(packed) & 3) == 0) {
    const int words = row_bytes >> 2;
    for (int w = threadIdx.x; w < ne * words; w += THREADS) {
      const int e = w / words, k = w - e * words;
      const uint32_t* row =
          reinterpret_cast<const uint32_t*>(packed + (src[e] * d.T + t) * row_bytes);
      reinterpret_cast<uint32_t*>(rows)[w] = __ldg(row + k);
    }
  } else {
    for (int w = threadIdx.x; w < ne * row_bytes; w += THREADS) {
      const int e = w / row_bytes, k = w - e * row_bytes;
      rows[w] = __ldg(packed + (src[e] * d.T + t) * row_bytes + k);
    }
  }
  __syncthreads();

  // the three bit fields; the span of (t, b0 .. b0 + ne) is contiguous
  const long long first_row = ((long long)t * d.B + b0) * d.Pi;
  const int n_rows = ne * d.Pi;
  unpack_field(priv_s, first_row * d.F, n_rows * d.F, d.F, 0, rows, d.NB);
  unpack_field(legal, first_row * d.A, n_rows * d.A, d.A, d.F, rows, d.NB);
  unpack_field(own_hand, first_row * d.H3, n_rows * d.H3, d.H3, d.F + d.A, rows, d.NB);

  // side fields
  for (int i = threadIdx.x; i < n_rows; i += THREADS) {
    const int e = i / d.Pi, p = i - e * d.Pi;
    out_action[first_row + i] = __ldg(action + (src[e] * d.T + t) * d.Pi + p);
  }
  if ((int)threadIdx.x < ne) {
    const int e = threadIdx.x;
    const long long o = (long long)t * d.B + b0 + e;
    const long long s = src[e] * d.T + t;
    const float len = __ldg(seq_len + src[e]);
    out_reward[o] = __ldg(reward + s);
    out_bootstrap[o] = __ldg(bootstrap + s);
    out_terminal[o] = (float)t >= len - 1.0f ? 1.0f : 0.0f;
    if (t == 0) out_seq_len[b0 + e] = len;
  }
}

}  // namespace

// Launches one sample on `stream`; every output pointer is 16-byte aligned
// and every tensor contiguous (the wrapper checks). Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int sample_batch(const uint8_t* packed, const long long* action, const float* reward,
                            const float* bootstrap, const float* seq_len, const long long* idx,
                            float* priv_s, float* legal, float* own_hand, long long* out_action,
                            float* out_reward, float* out_bootstrap, float* out_terminal,
                            float* out_seq_len, long long cap, int T, int B, int Pi, int NB, int F,
                            int A, int H3, void* stream) {
  if (cap <= 0 || T <= 0 || B <= 0 || Pi <= 0 || NB <= 0 || F <= 0 || A <= 0 || H3 <= 0 ||
      F + A + H3 > 8 * NB || T > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)EPB * Pi * NB;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + EPB - 1) / EPB), (unsigned)T);
  const Dims d{cap, T, B, Pi, NB, F, A, H3};
  sample_batch_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      packed, action, reward, bootstrap, seq_len, idx, priv_s, legal, own_hand, out_action,
      out_reward, out_bootstrap, out_terminal, out_seq_len, d);
  return (int)cudaGetLastError();
}

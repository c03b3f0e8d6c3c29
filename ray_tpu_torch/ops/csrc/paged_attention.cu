// Ragged paged attention for Hopper (sm_90a): the token-major layout (K5)
// and the rectangular layout (K6), one device routine behind two kernels.
//
// Replaces, in ray_tpu/ops/paged_attention.py (kernel ids of ROADMAP.md):
//   * K5, `_rua_kernel`, behind `ragged_paged_attention_unified`: the
//     attention of every default (unified) engine tick;
//   * K6, `_rpa_kernel`, behind `ragged_paged_attention`: the attention of
//     the split path (prefill chunks, async and host-logits decode,
//     multi-step decode, speculative verify).
//
// What they compute (same as the TPU kernels and the plain PyTorch versions
// `ragged_paged_attention_unified_reference` and
// `ragged_paged_attention_reference`):
//   K5: q (T, H, hd) flat token-major; sequence s owns rows
//       cu_q_lens[s] .. cu_q_lens[s+1]; row t of s sits at absolute position
//       q_positions[s] + (t - cu_q_lens[s]). Rows past cu_q_lens[S] are
//       padding and come out as exact zeros.
//   K6: q (S, Bq, H, hd); row (s, b) sits at position q_positions[s] + b.
//       K6 takes no q_lens, so every row b < Bq of a sequence with
//       kv_lens[s] > 0 is computed, padding rows of a chunk included, as the
//       TPU kernel computes them. A sequence with kv_lens[s] == 0 is padding
//       and comes out as exact zeros (the TPU kernel's empty page loop).
//   Both: a row attends to the keys k_pos of its sequence with
//   k_pos < kv_lens[s] and k_pos <= its position; keys live in pages
//   (K, P, ps, hd) addressed through block_tables (S, max_pages). Online
//   softmax in fp32, output acc / max(l, 1e-30) in q's dtype. GQA: the
//   G = H/K query heads of a kv head read its K/V unrepeated.
//
// What bounds them on an H100: device-memory bytes. Each (row, kv head)
// reads its sequence's K/V pages once and does 4*hd flops per key and
// query head, far below the ~295 flops per byte at which the tensor cores
// would become the limit. The design therefore spends nothing on tensor
// cores and everything on keeping many K/V loads in flight:
//   * one thread block per (row, kv head, key split); its G warps are the
//     G query heads sharing that kv head, so one staged K/V tile serves all
//     of them;
//   * the block finds its sequence itself (K5: binary search over
//     cu_q_lens; K6: s = row / Bq) and walks only that sequence's pages, up
//     to min(kv_len, position + 1) keys, so no masked page is read and a
//     decode row costs O(its own context);
//   * a row's keys are split into chunks of kSplitKeys across blocks
//     (grid z), so a few decode rows with long contexts still fill the SMs
//     and do not become the tail of a batch; a row with more than one
//     chunk writes fp32 partials (m, l, unnormalised acc) and a second
//     small kernel merges them; a row with one chunk writes its output
//     directly;
//   * K/V pages are staged in shared memory in their storage type, several
//     pages per stage (about 32 KB), with 16-byte loads from every thread so
//     many loads are in flight before each barrier;
//   * each warp scores keys in groups of 8 with independent butterfly
//     reductions (instruction-level parallelism instead of one serial
//     shuffle chain per key); masked keys of a group get probability 0.
// Not done yet (later work, see PERF.md): cp.async/TMA double buffering;
// a query tile per sequence on tensor cores (mma.sync/wgmma), which would
// help the 128-row prefill chunks of K5 and K6 alike (their rows re-read
// the same pages and are bound by instruction issue, not bytes).
//
// Plain C interface, bound with ctypes. Each launcher returns the
// cudaError_t of its launches; the Python wrappers raise on non-zero and
// allocate the fp32 workspace whose size the *_workspace_bytes functions
// give.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kKeyGroup = 8;
constexpr int kStageBytes = 32 * 1024;   // K + V staged per barrier
constexpr int kSplitKeys = 256;          // keys per block (grid z chunk)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Sequence of token t (t < cu_q_lens[S]): the count of cu_q_lens[1..S] at
// or below t, clamped to S - 1 (token_seq_ids of the plain version).
__device__ __forceinline__ int seq_of(const int32_t* cu_q_lens, int S, int t) {
  int lo = 1, hi = S + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(cu_q_lens + mid) <= t) lo = mid + 1; else hi = mid;
  }
  return min(lo - 1, S - 1);
}

// Where a row of each layout belongs. locate() returns false for a padding
// row (its output is exact zeros); otherwise it sets the row's sequence and
// the number of keys the row attends to, min(kv_len, position + 1) >= 0.
struct UnifiedRows {   // K5: token-major, spans delimited by cu_q_lens
  const int32_t* kv_lens;
  const int32_t* q_positions;
  const int32_t* cu_q_lens;
  int S;
  __device__ __forceinline__ bool locate(int t, int& s, int& n_keys) const {
    if (t >= __ldg(cu_q_lens + S)) return false;
    s = seq_of(cu_q_lens, S, t);
    const int q_abs = __ldg(q_positions + s) + (t - __ldg(cu_q_lens + s));
    n_keys = max(0, min(__ldg(kv_lens + s), q_abs + 1));
    return true;
  }
};

struct RectRows {      // K6: rectangular (S, Bq), row = s * Bq + b
  const int32_t* kv_lens;
  const int32_t* q_positions;
  int Bq;
  __device__ __forceinline__ bool locate(int r, int& s, int& n_keys) const {
    s = r / Bq;
    const int kv_len = __ldg(kv_lens + s);
    if (kv_len <= 0) return false;
    n_keys = max(0, min(kv_len, __ldg(q_positions + s) + (r - s * Bq) + 1));
    return true;
  }
};

__host__ __device__ __forceinline__ int splits_for(int n_keys,
                                                   int split_keys) {
  return max(1, (n_keys + split_keys - 1) / split_keys);
}

// Stage size: a multiple of ps, about kStageBytes for K + V.
__host__ __forceinline__ int stage_keys_for(int row_bytes, int ps) {
  const int keys = (kStageBytes / (2 * row_bytes)) / ps * ps;
  return keys < ps ? ps : keys;
}

__host__ __forceinline__ int split_keys_for(int stage_keys) {
  const int keys = kSplitKeys / stage_keys * stage_keys;
  return keys < stage_keys ? stage_keys : keys;
}

// The kernels' own parameters, shared by both layouts: each pointer a
// __restrict__ parameter of the __global__ function itself, as the
// compiler schedules the inner loop best that way (a struct of the same
// values cost K5 5-9%, one card, in turns).
#define ATTN_PARAMS(T)                                                     \
  const T* __restrict__ q, const T* __restrict__ k_pages,                  \
      const T* __restrict__ v_pages,                                       \
      const int32_t* __restrict__ block_tables, T* __restrict__ out,       \
      float* __restrict__ part_acc, float* __restrict__ part_ml, int H,    \
      int K, int P, int ps, int max_pages, int stage_keys, int split_keys, \
      int n_split, float scale
#define ATTN_ARGS                                                          \
  q, k_pages, v_pages, block_tables, out, part_acc, part_ml, H, K, P, ps,  \
      max_pages, stage_keys, split_keys, n_split, scale

// The body of both kernels: block (row, kv head, key split).
// E = head_dim / 32: the head-dim elements each lane owns (lane + 32 * i).
template <typename T, int E, typename Rows>
__device__ __forceinline__ void attend_row(const Rows& rows,
                                           ATTN_PARAMS(T)) {
  constexpr int HD = 32 * E;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + (size_t)stage_keys * HD;

  const int t = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int G = H / K;
  const int lane = threadIdx.x & 31;
  const int h = kh * G + (threadIdx.x >> 5);
  T* out_row = out + ((size_t)t * H + h) * HD;

  int s, n_keys;
  if (!rows.locate(t, s, n_keys)) {   // padding (uniform across the block)
    if (split == 0) {
#pragma unroll
      for (int i = 0; i < E; ++i) store(out_row + lane + 32 * i, 0.f);
    }
    return;
  }
  const int n_splits = splits_for(n_keys, split_keys);
  if (split >= n_splits) return;
  const int k_begin = split * split_keys;
  const int k_end = min(n_keys, k_begin + split_keys);
  const int32_t* table = block_tables + (size_t)s * max_pages;

  float qv[E], acc[E];
  const T* q_row = q + ((size_t)t * H + h) * HD;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    qv[i] = to_float(q_row[lane + 32 * i]) * scale;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  const size_t page_elems = (size_t)ps * HD;
  const int vec_per_page = (int)(page_elems / VEC);
  const T* k_head = k_pages + (size_t)kh * P * page_elems;
  const T* v_head = v_pages + (size_t)kh * P * page_elems;

  for (int base = k_begin; base < k_end; base += stage_keys) {
    const int n_in = min(stage_keys, k_end - base);
    const int first_page = base / ps;     // stage_keys is a multiple of ps
    const int n_vec = ((n_in + ps - 1) / ps) * vec_per_page;
    for (int idx = threadIdx.x; idx < n_vec; idx += blockDim.x) {
      const int pg = idx / vec_per_page;
      const int w = idx - pg * vec_per_page;
      const size_t src =
          (size_t)table[first_page + pg] * page_elems + (size_t)w * VEC;
      const size_t dst = (size_t)pg * page_elems + (size_t)w * VEC;
      *reinterpret_cast<uint4*>(k_s + dst) =
          __ldg(reinterpret_cast<const uint4*>(k_head + src));
      *reinterpret_cast<uint4*>(v_s + dst) =
          __ldg(reinterpret_cast<const uint4*>(v_head + src));
    }
    __syncthreads();
    for (int j0 = 0; j0 < n_in; j0 += kKeyGroup) {
      float sc[kKeyGroup];
#pragma unroll
      for (int g = 0; g < kKeyGroup; ++g) {
        const T* kr = k_s + (size_t)min(j0 + g, n_in - 1) * HD;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < E; ++i) part += qv[i] * to_float(kr[lane + 32 * i]);
        sc[g] = part;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int g = 0; g < kKeyGroup; ++g)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
      }
      float m_new = m;
#pragma unroll
      for (int g = 0; g < kKeyGroup; ++g)
        if (j0 + g < n_in) m_new = fmaxf(m_new, sc[g]);
      const float alpha = expf(m - m_new);
      float p[kKeyGroup];
      float p_sum = 0.f;
#pragma unroll
      for (int g = 0; g < kKeyGroup; ++g) {
        // Explicit zero for keys past this stage's end (clamped rows above).
        p[g] = (j0 + g < n_in) ? expf(sc[g] - m_new) : 0.f;
        p_sum += p[g];
      }
      l = l * alpha + p_sum;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        float acc_i = acc[i] * alpha;
#pragma unroll
        for (int g = 0; g < kKeyGroup; ++g)
          acc_i += p[g] * to_float(
                       v_s[(size_t)min(j0 + g, n_in - 1) * HD + lane + 32 * i]);
        acc[i] = acc_i;
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (n_splits == 1) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < E; ++i) store(out_row + lane + 32 * i, acc[i] / denom);
    return;
  }
  const size_t slot = ((size_t)t * H + h) * n_split + split;
  float* pa = part_acc + slot * HD;
#pragma unroll
  for (int i = 0; i < E; ++i) pa[lane + 32 * i] = acc[i];
  if (lane == 0) {
    part_ml[2 * slot] = m;
    part_ml[2 * slot + 1] = l;
  }
}

// Merge the key-split partials of every row that has more than one:
// out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30).
// One block per (row, query head), one thread per head-dim element.
template <typename T, typename Rows>
__device__ __forceinline__ void merge_row(
    const Rows& rows, const float* __restrict__ part_acc,
    const float* __restrict__ part_ml, T* __restrict__ out, int H, int hd,
    int split_keys, int n_split) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  int s, n_keys;
  if (!rows.locate(t, s, n_keys)) return;
  const int n_splits = splits_for(n_keys, split_keys);
  if (n_splits == 1) return;   // written by the attention kernel directly
  const size_t slot0 = ((size_t)t * H + h) * n_split;
  float m_max = kNegInf;
  for (int i = 0; i < n_splits; ++i)
    m_max = fmaxf(m_max, part_ml[2 * (slot0 + i)]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.f, o = 0.f;
    for (int i = 0; i < n_splits; ++i) {
      const float w = expf(part_ml[2 * (slot0 + i)] - m_max);
      l += part_ml[2 * (slot0 + i) + 1] * w;
      o += part_acc[(slot0 + i) * hd + d] * w;
    }
    store(out + ((size_t)t * H + h) * hd + d, o / fmaxf(l, 1e-30f));
  }
}

// Named kernels, so that a profile tells K5 (rua_*) from K6 (rpa_*).
#define MERGE_PARAMS(T)                                                    \
  const float* __restrict__ part_acc, const float* __restrict__ part_ml,   \
      T* __restrict__ out, int H, int hd, int split_keys, int n_split
#define MERGE_ARGS part_acc, part_ml, out, H, hd, split_keys, n_split

template <typename T, int E>
__global__ void __launch_bounds__(1024)
rua_kernel(UnifiedRows rows, ATTN_PARAMS(T)) {
  attend_row<T, E>(rows, ATTN_ARGS);
}

template <typename T, int E>
__global__ void __launch_bounds__(1024)
rpa_kernel(RectRows rows, ATTN_PARAMS(T)) {
  attend_row<T, E>(rows, ATTN_ARGS);
}

template <typename T>
__global__ void rua_merge_kernel(UnifiedRows rows, MERGE_PARAMS(T)) {
  merge_row<T>(rows, MERGE_ARGS);
}

template <typename T>
__global__ void rpa_merge_kernel(RectRows rows, MERGE_PARAMS(T)) {
  merge_row<T>(rows, MERGE_ARGS);
}

template <typename T, int E>
auto attend_kernel(UnifiedRows) { return rua_kernel<T, E>; }
template <typename T, int E>
auto attend_kernel(RectRows) { return rpa_kernel<T, E>; }
template <typename T>
auto merge_kernel(UnifiedRows) { return rua_merge_kernel<T>; }
template <typename T>
auto merge_kernel(RectRows) { return rpa_merge_kernel<T>; }

struct Plan {
  int stage_keys, split_keys, n_split;
  size_t smem;
};

Plan plan_for(int row_bytes, int ps, int max_pages) {
  Plan p;
  p.stage_keys = stage_keys_for(row_bytes, ps);
  p.split_keys = split_keys_for(p.stage_keys);
  p.n_split = splits_for(max_pages * ps, p.split_keys);
  p.smem = (size_t)2 * p.stage_keys * row_bytes;
  return p;
}

long long workspace_bytes(int n_rows, int H, int ps, int hd, int max_pages,
                          int is_bf16) {
  const Plan p = plan_for(hd * (is_bf16 ? 2 : 4), ps, max_pages);
  if (p.n_split == 1) return 0;
  return (long long)n_rows * H * p.n_split * (hd + 2) *
         (long long)sizeof(float);
}

// Grid (n_rows, K, n_split) of G warps, then the merge when any row may
// have more than one key split.
template <typename T, int E, typename Rows>
cudaError_t launch(const Rows& rows, int n_rows, const void* q,
                   const void* k_pages, const void* v_pages,
                   const void* block_tables, void* out, void* workspace,
                   int H, int K, int P, int ps, int max_pages, float scale,
                   cudaStream_t stream) {
  constexpr int HD = 32 * E;
  const Plan p = plan_for(HD * (int)sizeof(T), ps, max_pages);
  auto attend = attend_kernel<T, E>(rows);
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        attend, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_pages);
  const T* vp = static_cast<const T*>(v_pages);
  const int32_t* bt = static_cast<const int32_t*>(block_tables);
  T* op = static_cast<T*>(out);
  float* part_acc = static_cast<float*>(workspace);
  float* part_ml = part_acc + (size_t)n_rows * H * p.n_split * HD;
  attend<<<dim3(n_rows, K, p.n_split), 32 * (H / K), p.smem, stream>>>(
      rows, qp, kp, vp, bt, op, part_acc, part_ml, H, K, P, ps, max_pages,
      p.stage_keys, p.split_keys, p.n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  auto merge = merge_kernel<T>(rows);
  merge<<<dim3(n_rows, H), HD, 0, stream>>>(rows, part_acc, part_ml, op, H,
                                            HD, p.split_keys, p.n_split);
  return cudaGetLastError();
}

template <typename Rows>
cudaError_t dispatch(const Rows& rows, int n_rows, int hd, int is_bf16,
                     const void* q, const void* k_pages, const void* v_pages,
                     const void* block_tables, void* out, void* workspace,
                     int H, int K, int P, int ps, int max_pages, float scale,
                     void* stream) {
  if (n_rows == 0) return cudaSuccess;
  if (K <= 0 || H % K != 0 || H / K > 32 || ps <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RPA_CASE(T_, HD_)                                                    \
  return launch<T_, HD_ / 32>(rows, n_rows, q, k_pages, v_pages,             \
                              block_tables, out, workspace, H, K, P, ps,     \
                              max_pages, scale, st);
  // Head dims with a caller: Llama-3-8B (128), the card tests' config (64).
  switch (hd) {
    case 64:
      if (is_bf16) { RPA_CASE(__nv_bfloat16, 64) }
      RPA_CASE(float, 64)
    case 128:
      if (is_bf16) { RPA_CASE(__nv_bfloat16, 128) }
      RPA_CASE(float, 128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RPA_CASE
}

}  // namespace

// The message of a cudaError_t returned by any launcher of the library.
extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of fp32 workspace rpa_unified_forward needs for these shapes (0
// when no token can need more than one key split).
extern "C" long long rpa_unified_workspace_bytes(int T_, int H, int ps,
                                                 int hd, int max_pages,
                                                 int is_bf16) {
  return workspace_bytes(T_, H, ps, hd, max_pages, is_bf16);
}

// K5: q (T, H, hd), cu_q_lens (S + 1,).
extern "C" int rpa_unified_forward(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, const void* q_positions,
    const void* cu_q_lens, void* out, void* workspace, int T_, int H, int K,
    int P, int ps, int hd, int S, int max_pages, float scale, int is_bf16,
    void* stream) {
  if (S <= 0) return (int)cudaErrorInvalidValue;
  const UnifiedRows rows{static_cast<const int32_t*>(kv_lens),
                         static_cast<const int32_t*>(q_positions),
                         static_cast<const int32_t*>(cu_q_lens), S};
  return (int)dispatch(rows, T_, hd, is_bf16, q, k_pages, v_pages,
                       block_tables, out, workspace, H, K, P, ps, max_pages,
                       scale, stream);
}

// Bytes of fp32 workspace rpa_forward needs for S * Bq rows.
extern "C" long long rpa_workspace_bytes(int S, int Bq, int H, int ps, int hd,
                                         int max_pages, int is_bf16) {
  return workspace_bytes(S * Bq, H, ps, hd, max_pages, is_bf16);
}

// K6: q (S, Bq, H, hd), one row per (s, b).
extern "C" int rpa_forward(const void* q, const void* k_pages,
                           const void* v_pages, const void* block_tables,
                           const void* kv_lens, const void* q_positions,
                           void* out, void* workspace, int S, int Bq, int H,
                           int K, int P, int ps, int hd, int max_pages,
                           float scale, int is_bf16, void* stream) {
  if (Bq <= 0) return (int)cudaErrorInvalidValue;
  const RectRows rows{static_cast<const int32_t*>(kv_lens),
                      static_cast<const int32_t*>(q_positions), Bq};
  return (int)dispatch(rows, S * Bq, hd, is_bf16, q, k_pages, v_pages,
                       block_tables, out, workspace, H, K, P, ps, max_pages,
                       scale, stream);
}

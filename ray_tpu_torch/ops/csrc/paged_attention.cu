// Unified ragged paged attention for Hopper (sm_90a), token-major layout.
//
// Replaces: ray_tpu/ops/paged_attention.py `_rua_kernel` (the Pallas TPU
// kernel behind `ragged_paged_attention_unified`, K5 in ROADMAP.md), the
// attention of every default engine tick.
//
// What it computes (same as the TPU kernel and the plain PyTorch version
// `ragged_paged_attention_unified_reference`):
//   q (T, H, hd) flat token-major; sequence s owns rows
//   cu_q_lens[s] .. cu_q_lens[s+1]; row t of s sits at absolute position
//   q_positions[s] + (t - cu_q_lens[s]) and attends to the keys k_pos of s
//   with k_pos < kv_lens[s] and k_pos <= its position; keys live in pages
//   (K, P, ps, hd) addressed through block_tables (S, max_pages). Online
//   softmax in fp32, output acc / max(l, 1e-30) in q's dtype. Rows past
//   cu_q_lens[S] are padding and come out as exact zeros. GQA: the G = H/K
//   query heads of a kv head read its K/V unrepeated.
//
// What bounds it on an H100: device-memory bytes. Each (token, kv head)
// reads its sequence's K/V pages once and does 4*hd flops per key and
// query head, far below the ~295 flops per byte at which the tensor cores
// would become the limit. The design therefore spends nothing on tensor
// cores and everything on keeping many K/V loads in flight:
//   * one thread block per (token, kv head, key split); its G warps are the
//     G query heads sharing that kv head, so one staged K/V tile serves all
//     of them;
//   * the block finds its sequence by binary search over cu_q_lens and walks
//     only that sequence's pages, up to min(kv_len, position + 1) keys, so
//     no masked page is read and a decode row costs O(its own context);
//   * a token's keys are split into chunks of kSplitKeys across blocks
//     (grid z), so a few decode rows with long contexts still fill the SMs
//     and do not become the tail of a mixed batch; a token with more than
//     one chunk writes fp32 partials (m, l, unnormalised acc) and a second
//     small kernel merges them; a token with one chunk writes its output
//     directly;
//   * K/V pages are staged in shared memory in their storage type, several
//     pages per stage (about 32 KB), with 16-byte loads from every thread so
//     many loads are in flight before each barrier;
//   * each warp scores keys in groups of 8 with independent butterfly
//     reductions (instruction-level parallelism instead of one serial
//     shuffle chain per key); masked keys of a group get probability 0.
// Not done yet (later work, see PERF.md): cp.async/TMA double buffering,
// wgmma for long prefill chunks.
//
// Plain C interface, bound with ctypes. The launcher returns the
// cudaError_t of the launches; the Python wrapper raises on non-zero and
// allocates the fp32 workspace whose size rpa_unified_workspace_bytes
// gives.

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
    if (cu_q_lens[mid] <= t) lo = mid + 1; else hi = mid;
  }
  return min(lo - 1, S - 1);
}

// Keys token t attends to: min(kv_len, position + 1), at least 0.
__device__ __forceinline__ int keys_of(const int32_t* kv_lens,
                                       const int32_t* q_positions,
                                       const int32_t* cu_q_lens, int s, int t) {
  const int q_abs = q_positions[s] + (t - cu_q_lens[s]);
  return max(0, min(kv_lens[s], q_abs + 1));
}

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

// E = head_dim / 32: the head-dim elements each lane owns (lane + 32 * i).
template <typename T, int E>
__global__ void __launch_bounds__(1024)
rua_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
           const T* __restrict__ v_pages,
           const int32_t* __restrict__ block_tables,
           const int32_t* __restrict__ kv_lens,
           const int32_t* __restrict__ q_positions,
           const int32_t* __restrict__ cu_q_lens, T* __restrict__ out,
           float* __restrict__ part_acc, float* __restrict__ part_ml,
           int H, int K, int P, int ps, int S, int max_pages,
           int stage_keys, int split_keys, int n_split, float scale) {
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

  if (t >= cu_q_lens[S]) {   // padding row (uniform across the block)
    if (split == 0) {
#pragma unroll
      for (int i = 0; i < E; ++i) store(out_row + lane + 32 * i, 0.f);
    }
    return;
  }
  const int s = seq_of(cu_q_lens, S, t);
  const int n_keys = keys_of(kv_lens, q_positions, cu_q_lens, s, t);
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
        float a = acc[i] * alpha;
#pragma unroll
        for (int g = 0; g < kKeyGroup; ++g)
          a += p[g] * to_float(
                   v_s[(size_t)min(j0 + g, n_in - 1) * HD + lane + 32 * i]);
        acc[i] = a;
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

// Merge the key-split partials of every token that has more than one:
// out = sum_i acc_i e^(m_i - M) / max(sum_i l_i e^(m_i - M), 1e-30).
// One block per (token, query head), one thread per head-dim element.
template <typename T>
__global__ void rua_merge_kernel(const int32_t* __restrict__ kv_lens,
                                 const int32_t* __restrict__ q_positions,
                                 const int32_t* __restrict__ cu_q_lens,
                                 const float* __restrict__ part_acc,
                                 const float* __restrict__ part_ml,
                                 T* __restrict__ out, int H, int hd, int S,
                                 int split_keys, int n_split) {
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  if (t >= cu_q_lens[S]) return;
  const int s = seq_of(cu_q_lens, S, t);
  const int n_splits =
      splits_for(keys_of(kv_lens, q_positions, cu_q_lens, s, t), split_keys);
  if (n_splits == 1) return;   // written by rua_kernel directly
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

template <typename T, int E>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_tables, const void* kv_lens,
                   const void* q_positions, const void* cu_q_lens, void* out,
                   void* workspace, int T_, int H, int K, int P, int ps,
                   int S, int max_pages, float scale, cudaStream_t stream) {
  constexpr int HD = 32 * E;
  const Plan p = plan_for(HD * (int)sizeof(T), ps, max_pages);
  if (p.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rua_kernel<T, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)p.smem);
    if (err != cudaSuccess) return err;
  }
  float* part_acc = static_cast<float*>(workspace);
  float* part_ml = part_acc + (size_t)T_ * H * p.n_split * HD;
  const int32_t* cu = static_cast<const int32_t*>(cu_q_lens);
  const int32_t* kv = static_cast<const int32_t*>(kv_lens);
  const int32_t* qp = static_cast<const int32_t*>(q_positions);
  rua_kernel<T, E><<<dim3(T_, K, p.n_split), 32 * (H / K), p.smem,
                     stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages),
      static_cast<const int32_t*>(block_tables), kv, qp, cu,
      static_cast<T*>(out), part_acc, part_ml, H, K, P, ps, S, max_pages,
      p.stage_keys, p.split_keys, p.n_split, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  rua_merge_kernel<T><<<dim3(T_, H), HD, 0, stream>>>(
      kv, qp, cu, part_acc, part_ml, static_cast<T*>(out), H, HD, S,
      p.split_keys, p.n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* kv_lens, const void* q_positions,
                        const void* cu_q_lens, void* out, void* workspace,
                        int T_, int H, int K, int P, int ps, int S,
                        int max_pages, float scale, cudaStream_t stream) {
#define RUA_CASE(HD_)                                                       \
  case HD_:                                                                 \
    return launch<T, HD_ / 32>(q, k_pages, v_pages, block_tables, kv_lens,  \
                               q_positions, cu_q_lens, out, workspace, T_,  \
                               H, K, P, ps, S, max_pages, scale, stream);
  switch (hd) {   // Llama-3-8B (128) and the card test's tiny config (64)
    RUA_CASE(64)
    RUA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef RUA_CASE
}

}  // namespace

extern "C" const char* rpa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of fp32 workspace rpa_unified_forward needs for these shapes (0
// when no token can need more than one key split).
extern "C" long long rpa_unified_workspace_bytes(int T_, int H, int ps,
                                                 int hd, int max_pages,
                                                 int is_bf16) {
  const Plan p = plan_for(hd * (is_bf16 ? 2 : 4), ps, max_pages);
  if (p.n_split == 1) return 0;
  return (long long)T_ * H * p.n_split * (hd + 2) * (long long)sizeof(float);
}

extern "C" int rpa_unified_forward(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_tables, const void* kv_lens, const void* q_positions,
    const void* cu_q_lens, void* out, void* workspace, int T_, int H, int K,
    int P, int ps, int hd, int S, int max_pages, float scale, int is_bf16,
    void* stream) {
  if (T_ == 0) return (int)cudaSuccess;
  if (K <= 0 || H % K != 0 || H / K > 32 || ps <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, q, k_pages, v_pages,
                                           block_tables, kv_lens, q_positions,
                                           cu_q_lens, out, workspace, T_, H,
                                           K, P, ps, S, max_pages, scale, st)
              : dispatch_hd<float>(hd, q, k_pages, v_pages, block_tables,
                                   kv_lens, q_positions, cu_q_lens, out,
                                   workspace, T_, H, K, P, ps, S, max_pages,
                                   scale, st);
  return (int)err;
}

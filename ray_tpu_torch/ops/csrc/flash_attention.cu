// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, three kernels.
//
// Replaces, in ray_tpu/ops/attention.py (kernel ids of ROADMAP.md):
//   * flash_fwd_kernel: K1 `_flash_fwd_kernel`/`_nolse` (call :520) and K2
//     `_flash_fwd_kernel_tiled`/`_nolse` (call :553);
//   * flash_bwd_dq_kernel: K3 `_flash_bwd_dq_kernel_resident` (call :616)
//     and K4 `_flash_bwd_dq_kernel` (call :738);
//   * flash_bwd_dkv_kernel: K3 `_flash_bwd_dkv_kernel_resident` (call :634)
//     and K4 `_flash_bwd_dkv_kernel` (call :771).
// The TPU kernels come in a resident and a tiled variant because K/V (or
// the q side) must fit the TPU's ~16 MB scoped VMEM; here every block walks
// its tiles through shared memory in a loop, so one kernel per pass covers
// both regimes.
//
// What they compute (as the Pallas kernels and the plain PyTorch versions
// flash_fwd_reference, flash_bwd_dq_reference, flash_bwd_dkv_reference):
// q (b, sq, h, d), k/v (b, skv, hkv, d) in the public layout, read in place;
// query head hi uses kv head hi / n_rep (n_rep = h / hkv); the causal mask is
// q_pos >= k_pos with both counted from 0 (top-left aligned when sq != skv).
//   forward: online softmax in fp32 over key tiles up to the diagonal,
//     out = acc / max(l, 1e-30) in q's dtype and, when asked, the LSE of the
//     scaled logits m + log(max(l, 1e-30)) as (b, h, sq) fp32;
//   dQ: p = exp(s·scale − lse), ds = p·(dO·Vᵀ − delta), dq += ds·K, written
//     once as dq·scale in q's dtype (delta = rowsum(dO·O) − g_lse comes in);
//   dK/dV: one block per (key tile, b·hkv) walks the group's n_rep query
//     heads and the q tiles from the diagonal on, dv += pᵀ·dO and
//     dk += dsᵀ·Q in fp32, written once (dk·scale, dv) in k's and v's dtypes:
//     no atomics and no partial buffers, so the result is deterministic.
// The logits are scaled after the product (s·scale in fp32), which equals
// the Pallas forward's (q·scale)·k up to fp32 rounding; masked logits are
// -1e30 as there, so a row's weights match the TPU kernel's. Rows past sq
// and keys past skv are masked in the kernels (no padding copies).
//
// What bounds them on an H100: operations. At the train shape (4, 2048,
// 16/8, 128) each pass does 2-4 causal (2048 x 2048 x 128) products per
// (batch, head), ~70-140 GFLOP against ~50-100 MB of reads, far above the
// ~295 flops per byte at which bf16 tensor cores become the limit. So:
//   * a block owns 64 query rows (forward, dQ) or 64 keys (dK/dV) and
//     stages each K/V (or Q/dO) tile in shared memory ONCE for all of them;
//     each of its 4 warps owns 16 of those rows;
//   * bf16 runs the products on the tensor cores, mma.sync m16n8k16 with
//     fp32 accumulators, fragments loaded with ldmatrix (.trans where the
//     contraction runs along a tile's rows); the probabilities (and ds) go
//     through shared memory as bf16 for the second product;
//   * fp32 runs the same tiles and fragment layout on the CUDA cores (FMA),
//     so the softmax and masking code is shared and fp32 stays exact to
//     fp32 rounding (no TF32);
//   * causal blocks skip key tiles above the diagonal (forward, dQ) and q
//     tiles below it (dK/dV), and the heaviest tiles are scheduled first.
// Not done yet (later work, see PERF.md): wgmma and TMA, cp.async double
// buffering of the K/V tiles, keeping P in registers between the products,
// warp specialisation.
//
// Plain C interface, bound with ctypes: each launcher returns the
// cudaError_t of its launch; the Python wrappers allocate every output and
// raise on non-zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;    // 4 warps, 16 rows each
constexpr int kTileQ = 64;       // query rows of a forward / dQ block
constexpr int kTileK = 64;       // keys of a tile (a dK/dV block's keys)
constexpr int kTileQdkv = 32;    // query rows per step of the dK/dV pass

struct Dims {
  int sq, skv, h, hkv, n_rep, causal;
  float scale;
};

// Shared-memory rows are padded by 16 bytes so that the 8 rows an ldmatrix
// (or a quad of FMA loads) touches fall in different banks.
template <typename T> struct Pad {
  static constexpr int v = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ROWS x D tile from global rows src + r * stride into shared dst (row
// stride ld), 16 bytes a thread; rows r >= n_valid are zeros.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_rows(T* dst, int ld,
                                          const T* __restrict__ src,
                                          size_t stride, int n_valid) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      val = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// ---------------------------------------------------------------- warp GEMM
//
// acc += A · B for one warp: A is its 16 x K tile (row-major, row stride
// lda), B a K x (8 NT) tile, acc the 16 x (8 NT) result in the mma.sync
// accumulator layout: with g = lane / 4 and t = lane % 4,
//   acc[j][0..1] = C[g][8j + 2t + 0..1], acc[j][2..3] = C[g + 8][same].
// B_KCONTIG: B(k, n) = b[n * ldb + k] (a tile whose rows are B's columns,
// as K in Q·Kᵀ); otherwise B(k, n) = b[k * ldb + n] (as V in P·V).

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16: tensor cores.
template <int NT, int K, bool B_KCONTIG>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4],
                                         const __nv_bfloat16* a, int lda,
                                         const __nv_bfloat16* b, int ldb) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bf[2];
      if (B_KCONTIG)
        ldsm_x2(bf, b + (8 * j + (lane & 7)) * ldb + k0 +
                        ((lane >> 3) & 1) * 8);
      else
        ldsm_x2_trans(bf, b + (k0 + (lane & 15)) * ldb + 8 * j);
      mma_bf16(acc[j], af, bf);
    }
  }
}

// fp32: CUDA cores, same accumulator layout.
template <int NT, int K, bool B_KCONTIG>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* a,
                                         int lda, const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a0 = a + g * lda;
  const float* a1 = a0 + 8 * lda;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x0 = a0[k], x1 = a1[k];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = 8 * j + 2 * t;
      const float y0 = B_KCONTIG ? b[n * ldb + k] : b[k * ldb + n];
      const float y1 = B_KCONTIG ? b[(n + 1) * ldb + k] : b[k * ldb + n + 1];
      acc[j][0] = fmaf(x0, y0, acc[j][0]);
      acc[j][1] = fmaf(x0, y1, acc[j][1]);
      acc[j][2] = fmaf(x1, y0, acc[j][2]);
      acc[j][3] = fmaf(x1, y1, acc[j][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// A warp's 16 x (8 NT) fragment into shared rows (row stride ld) as T.
template <typename T, int NT>
__device__ __forceinline__ void store_frag(T* dst, int ld,
                                           const float (&f)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    store2(dst + g * ld + 8 * j + 2 * t, f[j][0], f[j][1]);
    store2(dst + (g + 8) * ld + 8 * j + 2 * t, f[j][2], f[j][3]);
  }
}

// A warp's 16 x D fragment times `mul` into global rows row0 + r (stride
// `stride`) for the rows below n_rows.
template <typename T, int NT>
__device__ __forceinline__ void write_rows(T* __restrict__ dst, size_t stride,
                                           int row0, int n_rows,
                                           const float (&f)[NT][4],
                                           float mul0, float mul1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
    const float mul = r ? mul1 : mul0;
    T* p = dst + row * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      store2(p + 8 * j, f[j][2 * r] * mul, f[j][2 * r + 1] * mul);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- forward

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, Dims dm) {
  constexpr int LD = D + Pad<T>::v, LDP = kTileK + Pad<T>::v;
  constexpr int NK = kTileK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + kTileQ * LD;
  T* sV = sK + kTileK * LD;
  T* sP = sV + kTileK * LD;

  const int bh = blockIdx.x, bi = bh / dm.h, hi = bh % dm.h;
  const int kvh = hi / dm.n_rep;
  // Causal: the last q tiles walk the most keys; they start first.
  const int q0 =
      (dm.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kTileQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = (size_t)dm.h * D, kv_stride = (size_t)dm.hkv * D;
  const T* qb = q + ((size_t)bi * dm.sq * dm.h + hi) * D;
  const T* kb = k + ((size_t)bi * dm.skv * dm.hkv + kvh) * D;
  const T* vb = v + ((size_t)bi * dm.skv * dm.hkv + kvh) * D;
  const int row0 = q0 + warp * 16;

  load_rows<T, kTileQ, D>(sQ, LD, qb + q0 * q_stride, q_stride, dm.sq - q0);
  const int kv_end = dm.causal ? min(dm.skv, q0 + kTileQ) : dm.skv;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};
  float o[ND][4];
  zero(o);
  T* pw = sP + warp * 16 * LDP;
  for (int k0 = 0; k0 < kv_end; k0 += kTileK) {
    __syncthreads();
    load_rows<T, kTileK, D>(sK, LD, kb + k0 * kv_stride, kv_stride,
                            dm.skv - k0);
    load_rows<T, kTileK, D>(sV, LD, vb + k0 * kv_stride, kv_stride,
                            dm.skv - k0);
    __syncthreads();
    float s[NK][4];
    zero(s);
    warp_mma<NK, D, true>(s, sQ + warp * 16 * LD, LD, sK, LD);
    const bool masked = (dm.causal && k0 + kTileK - 1 > row0) ||
                        k0 + kTileK > dm.skv;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * dm.scale;
        if (masked) {
          const int row = row0 + g + 8 * (e >> 1);
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if ((dm.causal && col > row) || col >= dm.skv) x = kNegInf;
        }
        s[j][e] = x;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NK; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      const float m_new = fmaxf(m_r[r], quad_max(mx));
      const float alpha = __expf(m_r[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        s[j][2 * r] = __expf(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = __expf(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l_r[r] = alpha * l_r[r] + sum;
      m_r[r] = m_new;
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    store_frag<T, NK>(pw, LDP, s);
    __syncwarp();
    warp_mma<ND, kTileK, false>(o, pw, LDP, sV, LD);
  }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = fmaxf(quad_sum(l_r[r]), 1e-30f);
    inv[r] = 1.f / l;
    const int row = row0 + g + 8 * r;
    if (lse != nullptr && t == 0 && row < dm.sq)
      lse[(size_t)bh * dm.sq + row] = m_r[r] + logf(l);
  }
  write_rows<T, ND>(out + ((size_t)bi * dm.sq * dm.h + hi) * D, q_stride,
                    row0, dm.sq, o, inv[0], inv[1]);
}

// ---------------------------------------------------------------- dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Dims dm) {
  constexpr int LD = D + Pad<T>::v, LDP = kTileK + Pad<T>::v;
  constexpr int NK = kTileK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + kTileQ * LD;
  T* sK = sdO + kTileQ * LD;
  T* sV = sK + kTileK * LD;
  T* sS = sV + kTileK * LD;

  const int bh = blockIdx.x, bi = bh / dm.h, hi = bh % dm.h;
  const int kvh = hi / dm.n_rep;
  const int q0 =
      (dm.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kTileQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = (size_t)dm.h * D, kv_stride = (size_t)dm.hkv * D;
  const size_t q_off = ((size_t)bi * dm.sq * dm.h + hi) * D;
  const T* kb = k + ((size_t)bi * dm.skv * dm.hkv + kvh) * D;
  const T* vb = v + ((size_t)bi * dm.skv * dm.hkv + kvh) * D;
  const int row0 = q0 + warp * 16;

  load_rows<T, kTileQ, D>(sQ, LD, q + q_off + q0 * q_stride, q_stride,
                          dm.sq - q0);
  load_rows<T, kTileQ, D>(sdO, LD, dout + q_off + q0 * q_stride, q_stride,
                          dm.sq - q0);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool ok = row < dm.sq;
    lse_r[r] = ok ? lse[(size_t)bh * dm.sq + row] : 0.f;
    delta_r[r] = ok ? delta[(size_t)bh * dm.sq + row] : 0.f;
  }
  const int kv_end = dm.causal ? min(dm.skv, q0 + kTileQ) : dm.skv;
  float acc[ND][4];
  zero(acc);
  T* sw = sS + warp * 16 * LDP;
  for (int k0 = 0; k0 < kv_end; k0 += kTileK) {
    __syncthreads();
    load_rows<T, kTileK, D>(sK, LD, kb + k0 * kv_stride, kv_stride,
                            dm.skv - k0);
    load_rows<T, kTileK, D>(sV, LD, vb + k0 * kv_stride, kv_stride,
                            dm.skv - k0);
    __syncthreads();
    float s[NK][4], dp[NK][4];
    zero(s);
    zero(dp);
    warp_mma<NK, D, true>(s, sQ + warp * 16 * LD, LD, sK, LD);
    warp_mma<NK, D, true>(dp, sdO + warp * 16 * LD, LD, sV, LD);
    const bool masked = (dm.causal && k0 + kTileK - 1 > row0) ||
                        k0 + kTileK > dm.skv;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = __expf(s[j][e] * dm.scale - lse_r[r]);
        if (masked) {
          const int row = row0 + g + 8 * r;
          const int col = k0 + 8 * j + 2 * t + (e & 1);
          if ((dm.causal && col > row) || col >= dm.skv) p = 0.f;
        }
        s[j][e] = p * (dp[j][e] - delta_r[r]);
      }
    store_frag<T, NK>(sw, LDP, s);
    __syncwarp();
    warp_mma<ND, kTileK, false>(acc, sw, LDP, sK, LD);
  }
  write_rows<T, ND>(dq + q_off, q_stride, row0, dm.sq, acc, dm.scale,
                    dm.scale);
}

// ---------------------------------------------------------------- dK / dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Dims dm) {
  constexpr int BQ = kTileQdkv;
  constexpr int LD = D + Pad<T>::v, LDQ = BQ + Pad<T>::v;
  constexpr int NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + kTileK * LD;
  T* sQ = sV + kTileK * LD;
  T* sdO = sQ + BQ * LD;
  T* sP = sdO + BQ * LD;
  T* sS = sP + kTileK * LDQ;
  float* s_lse = reinterpret_cast<float*>(sS + kTileK * LDQ);
  float* s_delta = s_lse + BQ;

  const int bkv = blockIdx.x, bi = bkv / dm.hkv, kvh = bkv % dm.hkv;
  const int k0 = blockIdx.y * kTileK;   // causal: tile 0 walks most, first
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t q_stride = (size_t)dm.h * D, kv_stride = (size_t)dm.hkv * D;
  const size_t kv_off = ((size_t)bi * dm.skv * dm.hkv + kvh) * D;
  const int key0 = k0 + warp * 16;

  load_rows<T, kTileK, D>(sK, LD, k + kv_off + k0 * kv_stride, kv_stride,
                          dm.skv - k0);
  load_rows<T, kTileK, D>(sV, LD, v + kv_off + k0 * kv_stride, kv_stride,
                          dm.skv - k0);
  float dk_acc[ND][4], dv_acc[ND][4];
  zero(dk_acc);
  zero(dv_acc);
  T* pw = sP + warp * 16 * LDQ;
  T* sw = sS + warp * 16 * LDQ;
  const T* kw = sK + warp * 16 * LD;
  const T* vw = sV + warp * 16 * LD;
  // Causal: q rows below k0 see none of these keys.
  const int q_begin = dm.causal ? (k0 / BQ) * BQ : 0;
  for (int rep = 0; rep < dm.n_rep; ++rep) {
    const int hi = kvh * dm.n_rep + rep;
    const size_t q_off = ((size_t)bi * dm.sq * dm.h + hi) * D;
    const size_t row_off = ((size_t)bi * dm.h + hi) * dm.sq;
    for (int q0 = q_begin; q0 < dm.sq; q0 += BQ) {
      __syncthreads();
      load_rows<T, BQ, D>(sQ, LD, q + q_off + q0 * q_stride, q_stride,
                          dm.sq - q0);
      load_rows<T, BQ, D>(sdO, LD, dout + q_off + q0 * q_stride, q_stride,
                          dm.sq - q0);
      if (threadIdx.x < BQ) {
        const int row = q0 + threadIdx.x;
        const bool ok = row < dm.sq;
        s_lse[threadIdx.x] = ok ? lse[row_off + row] : 0.f;
        s_delta[threadIdx.x] = ok ? delta[row_off + row] : 0.f;
      }
      __syncthreads();
      // Transposed tiles: rows are this warp's 16 keys, columns the q rows.
      float st[NQ][4], dpt[NQ][4];
      zero(st);
      zero(dpt);
      warp_mma<NQ, D, true>(st, kw, LD, sQ, LD);
      warp_mma<NQ, D, true>(dpt, vw, LD, sdO, LD);
      const bool masked = (dm.causal && q0 < key0 + 15) ||
                          q0 + BQ > dm.sq || key0 + 16 > dm.skv;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qc = 8 * j + 2 * t + (e & 1);
          float p = __expf(st[j][e] * dm.scale - s_lse[qc]);
          if (masked) {
            const int key = key0 + g + 8 * (e >> 1), row = q0 + qc;
            if ((dm.causal && row < key) || row >= dm.sq || key >= dm.skv)
              p = 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - s_delta[qc]);
        }
      store_frag<T, NQ>(pw, LDQ, st);
      store_frag<T, NQ>(sw, LDQ, dpt);
      __syncwarp();
      warp_mma<ND, BQ, false>(dv_acc, pw, LDQ, sdO, LD);
      warp_mma<ND, BQ, false>(dk_acc, sw, LDQ, sQ, LD);
    }
  }
  write_rows<T, ND>(dk + kv_off, kv_stride, key0, dm.skv, dk_acc, dm.scale,
                    dm.scale);
  write_rows<T, ND>(dv + kv_off, kv_stride, key0, dm.skv, dv_acc, 1.f, 1.f);
}

// ---------------------------------------------------------------- launchers

template <typename T, int D>
size_t fwd_smem() {
  return sizeof(T) * ((size_t)(kTileQ + 2 * kTileK) * (D + Pad<T>::v) +
                      (size_t)kTileQ * (kTileK + Pad<T>::v));
}

template <typename T, int D>
size_t dq_smem() {
  return sizeof(T) * ((size_t)(2 * kTileQ + 2 * kTileK) * (D + Pad<T>::v) +
                      (size_t)kTileQ * (kTileK + Pad<T>::v));
}

template <typename T, int D>
size_t dkv_smem() {
  return sizeof(T) * ((size_t)(2 * kTileK + 2 * kTileQdkv) * (D + Pad<T>::v) +
                      (size_t)2 * kTileK * (kTileQdkv + Pad<T>::v)) +
         2 * kTileQdkv * sizeof(float);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Dims dims(int sq, int skv, int h, int hkv, int causal, float scale) {
  return Dims{sq, skv, h, hkv, h / hkv, causal, scale};
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int b, int sq, int skv, int h, int hkv,
                int causal, float scale, cudaStream_t st) {
  const size_t smem = fwd_smem<T, D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, D><<<dim3(b * h, tiles(sq, kTileQ)), kThreads, smem,
                           st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), dims(sq, skv, h, hkv, causal, scale));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int b, int sq, int skv, int h, int hkv,
                   int causal, float scale, cudaStream_t st) {
  const size_t smem = dq_smem<T, D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<dim3(b * h, tiles(sq, kTileQ)), kThreads,
                              smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), dims(sq, skv, h, hkv, causal, scale));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int b, int sq, int skv, int h,
                    int hkv, int causal, float scale, cudaStream_t st) {
  const size_t smem = dkv_smem<T, D>();
  cudaError_t err = allow_smem(flash_bwd_dkv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D><<<dim3(b * hkv, tiles(skv, kTileK)), kThreads,
                               smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv),
      dims(sq, skv, h, hkv, causal, scale));
  return cudaGetLastError();
}

bool valid(int b, int sq, int skv, int h, int hkv) {
  return b > 0 && sq > 0 && skv > 0 && hkv > 0 && h % hkv == 0 &&
         tiles(sq, kTileQ) <= 65535 && tiles(skv, kTileK) <= 65535;
}

}  // namespace

// Head dims with a caller: 128 (the bench config, Llama-3-8B) and 64 (the
// card tests' small configs); anything else is refused.
#define FLASH_DISPATCH(FN, ...)                                      \
  switch (d) {                                                       \
    case 64:                                                         \
      return (int)(is_bf16 ? FN<__nv_bfloat16, 64>(__VA_ARGS__)      \
                           : FN<float, 64>(__VA_ARGS__));            \
    case 128:                                                        \
      return (int)(is_bf16 ? FN<__nv_bfloat16, 128>(__VA_ARGS__)     \
                           : FN<float, 128>(__VA_ARGS__));           \
    default:                                                         \
      return (int)cudaErrorInvalidValue;                             \
  }

// q (b, sq, h, d), k/v (b, skv, hkv, d) -> out like q, lse (b, h, sq) fp32
// or nullptr for none.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int b, int sq, int skv,
                                int h, int hkv, int d, int causal,
                                float scale, int is_bf16, void* stream) {
  if (!valid(b, sq, skv, h, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, out, lse, b, sq, skv, h, hkv, causal, scale,
                 st)
}

// + dout like q, lse and delta (b, h, sq) fp32 -> dq like q.
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int b, int sq, int skv, int h,
                                   int hkv, int d, int causal, float scale,
                                   int is_bf16, void* stream) {
  if (!valid(b, sq, skv, h, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dq, q, k, v, dout, lse, delta, dq, b, sq, skv, h, hkv,
                 causal, scale, st)
}

// The same inputs -> dk, dv like k, v.
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int b, int sq,
                                    int skv, int h, int hkv, int d,
                                    int causal, float scale, int is_bf16,
                                    void* stream) {
  if (!valid(b, sq, skv, h, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(bwd_dkv, q, k, v, dout, lse, delta, dk, dv, b, sq, skv, h,
                 hkv, causal, scale, st)
}

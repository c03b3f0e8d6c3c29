// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV, three passes.
//
// Replaces, in ray_tpu/ops/attention.py (kernel ids of ROADMAP.md):
//   * flash_fwd_wgmma_kernel (bf16) and flash_fwd_kernel (fp32): K1
//     `_flash_fwd_kernel`/`_nolse` (call :520) and K2
//     `_flash_fwd_kernel_tiled`/`_nolse` (call :553);
//   * flash_bwd_dq_wgmma_kernel (bf16) and flash_bwd_dq_kernel (fp32): K3
//     `_flash_bwd_dq_kernel_resident` (call :616) and K4
//     `_flash_bwd_dq_kernel` (call :738);
//   * flash_bwd_dkv_wgmma_kernel (bf16) and flash_bwd_dkv_kernel (fp32): K3
//     `_flash_bwd_dkv_kernel_resident` (call :634) and K4
//     `_flash_bwd_dkv_kernel` (call :771).
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
// ~295 flops per byte at which bf16 tensor cores become the limit.
//
// The bf16 forward (flash_fwd_wgmma_kernel, head dims 64 and 128) is built
// for Hopper's own tensor-core path:
//   * one CTA = 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each, plus one producer warpgroup whose first
//     thread issues every copy; the producer gives up registers
//     (setmaxnreg.dec 24) and the consumers take them (setmaxnreg.inc 240);
//   * Q arrives once per CTA and K/V through a ring of 3 stages (a 128-key
//     K tile and V tile per stage; 224 KB of shared memory at d = 128, one
//     CTA per SM) by TMA (cp.async.bulk.tensor, 4-d tensor maps over the
//     public (b, s, h, d) layout, read in place; the K/V maps index the kv
//     head hi / n_rep). Each stage has a full
//     and an empty mbarrier: the producer waits on empty, arms full with
//     expect_tx and issues the copies; consumers wait on full by phase
//     parity and arrive on empty (one arrival per warp) only after the
//     wgmma that read the stage has retired (wgmma.wait_group 0). Rows past
//     sq and keys past skv arrive as zeros (TMA's out-of-bounds fill): the
//     key mask below still sets them to -1e30, and the epilogue writes
//     rows < sq only;
//   * 128-byte swizzle: a box's inner dimension is at most 128 bytes (64
//     bf16), so a d = 128 row is two boxes and every tile is stored as
//     64-column halves of (rows x 128 B); each wgmma descriptor addresses
//     one half (start address, SBO = 1024 B between 8-row groups, layout
//     B128), and steps of 16 columns inside a half add 32 B to the start
//     address (the hardware swizzles on the absolute address, so every
//     tile starts on a 1024-byte boundary);
//   * S = Q·Kᵀ with wgmma m64n128k16 (A = this warpgroup's Q rows, B = the K
//     tile, both K-major in shared memory) into fp32 registers. Each warp
//     of the warpgroup holds 16 rows in the mma.sync accumulator pattern,
//     so masking (-1e30, top-left causal rule), the online softmax and the
//     rescaling are the same code as the fp32 path's;
//   * O += P·V with wgmma m64n{64|128}k16, A = P from registers: two
//     adjacent n8 chunks of the S accumulator, rounded to bf16x2 in place,
//     are exactly the register-A fragment of one k16 step, so P never
//     touches shared memory; B = the V tile, MN-major (the transpose bit),
//     LBO = the 16 KB between its 64-column halves;
//   * each consumer warpgroup runs a software pipeline: iteration i issues
//     S(i) and the delayed O = alpha·O + P(i-1)·V(i-1) as two wgmma groups,
//     runs the softmax of tile i while the PV product is in flight, and
//     releases stage i-1 (and overwrites P) only after wait_group 0; so a
//     stage is held for two iterations, hence the third ring stage;
//   * ping-pong: named barriers make the two warpgroups take turns to
//     issue their products, so one's softmax runs under the other's;
//   * the softmax works in base 2 (running max of logit·log2 e), so each
//     weight is one FFMA and one ex2.approx.ftz; with __expf the same
//     kernel took 1.35x as long (PERF.md): the softmax's instructions, not
//     the products, set the pace;
//   * wgmma.fence before each product whose registers ordinary code wrote
//     (the rescaled O, P), and an empty asm on every accumulator register
//     after wgmma.wait_group so no read of S or O moves above the wait. No
//     generic-proxy write to shared memory precedes a TMA or wgmma read
//     (only the mbarrier inits, which fence.mbarrier_init publishes), so no
//     fence.proxy.async is needed;
//   * the grid puts the heaviest causal tiles first; out = acc / max(l,
//     1e-30) in bf16 and the fp32 LSE (or none) go from registers to
//     global memory for rows < sq;
//   * cuTensorMapEncodeTiled is a driver-API function: the launcher fetches
//     it once through cudaGetDriverEntryPoint(ByVersion), so the library
//     links against the CUDA runtime alone (no -lcuda). TMA needs 16-byte
//     aligned bases and strides that are multiples of 16 bytes; the Python
//     wrapper refuses other tensors.
// The bf16 dK/dV pass (flash_bwd_dkv_wgmma_kernel, head dims 64 and 128)
// is built from the same blocks:
//   * one CTA = 128 keys of one (batch, kv head): two consumer warpgroups of
//     64 keys each plus one producer warpgroup (setmaxnreg 24/240). K and V
//     arrive once per CTA by TMA; the CTA walks the group's n_rep query
//     heads (head kvh·n_rep + rep of the public layout, read in place) and,
//     per head, the 64-row q tiles from the causal diagonal on, through a
//     ring of 4 stages of (Q tile, dO tile, 64 LSE, 64 delta) with full and
//     empty mbarriers. Key tile 0 (the most causal q tiles) starts first. No
//     atomics and no partial buffers: the result is deterministic;
//   * each warpgroup computes the transposed products with its keys as the
//     M rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (wgmma m64n64k16, A = its K or V
//     rows, B = the Q or dO tile, both K-major), then Pᵀ =
//     2^(Sᵀ·scale·log2 e − LSE·log2 e) and dSᵀ = Pᵀ∘(dPᵀ − delta), with LSE
//     and delta indexed by column (query row). Rounded to bf16x2 in place,
//     two adjacent n8 chunks of Pᵀ (dSᵀ) are the register-A fragment of one
//     k16 step of dV += Pᵀ·dO (dK += dSᵀ·Q), m64n{64|128}k16, whose B is the
//     same staged dO (Q) tile read MN-major with the transpose bit (LBO =
//     the 8 KB between its 64-column halves). So each staged Q/dO tile is
//     read through two descriptors, and neither P nor dS touches shared
//     memory;
//   * LSE and delta are (b, h, sq) fp32 rows, and a row starts 16-byte
//     aligned only when sq % 4 == 0 (not at sq = 127, 300 or 1000), so no
//     tensor map reads them: the producer's first warp loads a stage's 64
//     values of each with plain loads into a buffer TMA never writes (LSE
//     times log2 e), and its 32 lanes arrive on the stage's full barrier,
//     lane 0 with the stage's TMA bytes; the arrive's release and the
//     consumers' wait's acquire order the stores. Each consumer thread
//     reads its 16 columns' values as float2s;
//   * TMA fills Q and dO rows past sq with zeros, but a zero LSE would
//     still give 2^0 = 1: every tile that the causal diagonal (row < key),
//     the row edge (row >= sq) or the key edge (key >= skv) crosses is
//     masked explicitly (per warp, so inner tiles pay nothing). A q tile
//     wholly above a warpgroup's keys (causal; warpgroup 1's keys start 64
//     later) and a warpgroup wholly past skv compute nothing and only
//     release the stage;
//   * per consumer thread at d = 128: dK and dV take 64 + 64 fp32
//     registers, Sᵀ and dPᵀ 32 + 32, the two bf16 fragments 16 + 16. Each
//     warpgroup issues Sᵀ and dPᵀ as one wgmma group and dV, dK as
//     another, waiting for each before it reads the accumulators or
//     releases the stage; the two warpgroups overlap on the tensor cores.
//     Issuing tile i's Sᵀ before tile i−1's dV/dK (the forward's
//     intra-warpgroup overlap) keeps 64 more fp32 registers live: at d =
//     128 it spilled and took ~1.4x as long, and a ring refilled by a
//     consumer warp instead of the producer warpgroup ~1.25x (PERF.md);
//   * the epilogue writes dK·scale and dV from registers in bf16, for keys
//     < skv only.
// The bf16 dQ pass (flash_bwd_dq_wgmma_kernel, head dims 64 and 128) is
// the dK/dV pass with the roles of rows and keys swapped:
//   * one CTA = 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each plus one producer warpgroup (setmaxnreg
//     24/240). Q and dO arrive once per CTA by TMA; 64-key K and V tiles
//     stream through a ring of 4 stages (the kv head hi / n_rep; under
//     causal the walk stops at min(skv, q0 + 128)). The heaviest causal
//     row tiles start first;
//   * each warpgroup computes S = Q·Kᵀ and dP = dO·Vᵀ with its rows as M
//     (wgmma m64n64k16, both K-major, the dK/dV pass's issue_ss64), then P
//     = 2^(S·scale·log2 e − LSE·log2 e) and dS = P∘(dP − delta), rounded
//     to bf16x2 in place as the register-A fragments of dQ += dS·K
//     (m64n{64|128}k16, the K tile read MN-major: issue_rs64). Neither P
//     nor dS touches shared memory;
//   * each consumer thread reads its two rows' LSE·log2 e and delta once,
//     by plain loads, before the walk (rows start 16-byte aligned only
//     when sq % 4 == 0); rows past sq, keys past skv and the causal
//     diagonal are masked explicitly, per warp, as in dK/dV. A tile wholly
//     above a warpgroup's rows (causal) and a warpgroup wholly past sq
//     compute nothing and only release the stage;
//   * per consumer thread at d = 128: dQ takes 64 fp32 registers, S and
//     dP 32 + 32, the dS fragment 16, so the forward's intra-warpgroup
//     overlap fits without a spill: S(i+1) and dP(i+1) are issued as one
//     wgmma group before dQ += dS(i)·K(i) as another, and dS(i+1) is
//     computed while the dQ product is in flight. The loop is peeled so
//     that no wgmma sits under a branch (ptxas serialises them otherwise).
//     Ping-pong of the two warpgroups took 1.3-1.6x as long (PERF.md);
//   * the epilogue writes dQ·scale from registers in bf16, rows < sq only.
// fp32 (forward, dQ and dK/dV) keeps the warp-level design:
//   * a block owns 64 query rows (forward, dQ) or 64 keys (dK/dV) and
//     stages each K/V (or Q/dO) tile in shared memory ONCE for all of them;
//     each of its 4 warps owns 16 of those rows;
//   * the products run on the CUDA cores (FMA) in the mma.sync fragment
//     layout, so the masking code matches the bf16 kernels' and fp32 stays
//     exact to fp32 rounding (no TF32); the probabilities (and ds) go
//     through shared memory for the second product;
//   * causal blocks skip key tiles above the diagonal (forward, dQ) and q
//     tiles below it (dK/dV), and the heaviest tiles are scheduled first.
// Not done yet (later work, see PERF.md): ping-pong of the dK/dV
// warpgroups, a persistent tile scheduler that hides each CTA's prologue,
// a TMA store of the outputs.
//
// Plain C interface, bound with ctypes: each launcher returns the
// cudaError_t of its launch; the Python wrappers allocate every output and
// raise on non-zero.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// fp32 shared-memory rows are padded by 16 bytes (4 floats) so that the 8
// rows a quad of FMA loads touches fall in different banks.
constexpr int kPad = 4;

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
// acc += A · B for one warp on the CUDA cores (fp32): A is its 16 x K tile
// (row-major, row stride lda), B a K x (8 NT) tile, acc the 16 x (8 NT)
// result in the mma.sync accumulator layout (also that of a wgmma
// accumulator's 16 rows per warp): with g = lane / 4 and t = lane % 4,
//   acc[j][0..1] = C[g][8j + 2t + 0..1], acc[j][2..3] = C[g + 8][same].
// B_KCONTIG: B(k, n) = b[n * ldb + k] (a tile whose rows are B's columns,
// as K in Q·Kᵀ); otherwise B(k, n) = b[k * ldb + n] (as V in P·V).
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
  static_assert(sizeof(T) == 4, "bf16 runs flash_fwd_wgmma_kernel");
  constexpr int LD = D + kPad, LDP = kTileK + kPad;
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

// ------------------------------------------------------------ bf16 forward
//
// Hopper building blocks (PTX): shared-memory addresses, mbarriers, TMA
// loads, wgmma descriptors and products.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory at dst, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (B128) in bits
// 62-63. K-major: SBO = 1024 B between 8-row groups, LBO unused (1).
// MN-major: LBO = bytes between 64-element column blocks, SBO = 1024 B
// between 8-row groups along the contraction.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Waits until at most N of this warpgroup's committed wgmma groups are
// still in flight (groups retire in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers 1 and 2 order the two consumer warpgroups' products
// (bar.sync: wait for the barrier's count; bar.arrive: count without
// waiting). 0 is __syncthreads'.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Keeps the compiler from moving reads of an accumulator above the
// wgmma.wait_group that makes it valid.
template <int NT>
__device__ __forceinline__ void fence_regs(float (&d)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

// d (64 x 128) = (scale_d ? d : 0) + A·B, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) = (scale_d ? d : 0) + A·B, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A·B, A (64 x 16) from registers, B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128) += A·B, A (64 x 16) from registers, B MN-major in shared
// memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The mbarriers of a ring of kStages stages, at `bar`: full[kStages], then
// empty[kStages], then one barrier for the tile a CTA loads once. Tile i of
// a walk uses stage i % kStages. Shared by the forward and dK/dV kernels.
template <int kStages>
struct Ring {
  static constexpr int kBarBytes = 8 * (2 * kStages + 1);
  uint32_t bar;

  __device__ __forceinline__ uint32_t full(int i) const {
    return bar + 8 * (i % kStages);
  }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return bar + 8 * (kStages + i % kStages);
  }
  __device__ __forceinline__ uint32_t once() const {
    return bar + 16 * kStages;
  }
  // Round r of a stage waits for the consumers' release of round r - 1
  // (parity 1 on a fresh barrier passes at once).
  __device__ __forceinline__ void wait_empty(int i) const {
    mbar_wait(empty(i), ((i / kStages) & 1) ^ 1);
  }
  __device__ __forceinline__ void wait_full(int i) const {
    mbar_wait(full(i), (i / kStages) & 1);
  }
};

// Everything shared between the launcher and the kernel: 128 query rows
// per CTA (2 consumer warpgroups x 64), 128 keys per ring stage, every
// tile stored as D / 64 halves of (rows x 128 B), 1024-byte aligned.
template <int D>
struct FwdTile {
  static constexpr int kRows = 128, kKeys = 128, kStages = 3;
  static constexpr int kConsumerWarps = 8;
  static constexpr int kThreads = 32 * kConsumerWarps + 128;   // + producer
  static constexpr int kHalves = D / 64;
  static constexpr int kQHalf = kRows * 128, kKVHalf = kKeys * 128;
  static constexpr int kQBytes = kHalves * kQHalf;
  static constexpr int kKVBytes = kHalves * kKVHalf;   // one K or V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOff = kQBytes + kStages * kStageBytes;
  // + the ring's barriers (the once barrier is Q's); + slack to align.
  static constexpr int kSmem = kBarOff + Ring<kStages>::kBarBytes + 1024;
};

// The copies of one CTA, issued by one thread: Q once, then K/V tile i into
// stage i % kStages once the consumers have released it.
template <int D>
struct FwdLoads : Ring<FwdTile<D>::kStages> {
  using L = FwdTile<D>;
  const CUtensorMap *tm_q, *tm_k, *tm_v;
  uint32_t sQ, sKV;
  int bi, hi, kvh, q0;

  __device__ __forceinline__ void q() const {
    mbar_expect_tx(this->once(), L::kQBytes);
    for (int h2 = 0; h2 < L::kHalves; ++h2)
      tma_load_4d(sQ + h2 * L::kQHalf, tm_q, this->once(), 64 * h2, hi, q0,
                  bi);
  }
  __device__ __forceinline__ void kv(int i) const {
    const uint32_t sK = sKV + (i % L::kStages) * L::kStageBytes;
    const uint32_t full = this->full(i);
    this->wait_empty(i);
    mbar_expect_tx(full, L::kStageBytes);
    for (int h2 = 0; h2 < L::kHalves; ++h2) {
      tma_load_4d(sK + h2 * L::kKVHalf, tm_k, full, 64 * h2, kvh,
                  i * L::kKeys, bi);
      tma_load_4d(sK + L::kKVBytes + h2 * L::kKVHalf, tm_v, full, 64 * h2,
                  kvh, i * L::kKeys, bi);
    }
  }
};

// S = Q·Kᵀ for one warpgroup's 64 rows and a 128-key K tile, issued and
// committed as one wgmma group (not waited for).
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[16][4], uint32_t sQw,
                                         uint32_t sK) {
  using L = FwdTile<D>;
  zero(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // k16 step kk: half kk / 4, 32 bytes further per step inside it.
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss(sc, desc_b128(sQw + (kk >> 2) * L::kQHalf + off, 16, 1024),
             desc_b128(sK + (kk >> 2) * L::kKVHalf + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// O = alpha·O, then O += P·V for a 128-key V tile, issued and committed as
// one wgmma group. V is MN-major; LBO = the bytes between its 64-column
// halves.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 8][4],
                                         const uint32_t (&p)[8][4],
                                         const float (&alpha)[2],
                                         uint32_t sV) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] *= alpha[e >> 1];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs(o, p[kk],
             desc_b128(sV + kk * 16 * 128, FwdTile<D>::kKVHalf, 1024));
  wgmma_commit();
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Scale, mask (-1e30 above the top-left causal diagonal and at keys >=
// skv) and exponentiate one 16-row x 128-key slice of S in place; updates
// the running max and sum of the thread's two rows and returns in alpha
// the factor that rescales their earlier output. Works in base 2: m_r is
// the running max of logit·log2(e), so that one FFMA and one ex2 give each
// weight, exp(logit − m) = 2^(s·scale·log2(e) − m_r).
__device__ __forceinline__ void softmax_tile(float (&sc)[16][4], int k0,
                                             int row0, const Dims& dm,
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2]) {
  constexpr int NK = 16, kKeys = 8 * NK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale2 = dm.scale * kLog2e;
  const bool masked =
      (dm.causal && k0 + kKeys - 1 > row0) || k0 + kKeys > dm.skv;
  if (masked) {
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + 8 * (e >> 1);
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        sc[j][e] = (dm.causal && col > row) || col >= dm.skv
                       ? kNegInf * kLog2e
                       : sc[j][e] * scale2;
      }
  }
  // Unmasked tiles scale inside the FFMA below (scale2 > 0 keeps the max).
  const float mul = masked ? 1.f : scale2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf * kLog2e;
#pragma unroll
    for (int j = 0; j < NK; ++j)
      mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
    const float m_new = fmaxf(m_r[r], quad_max(mx) * mul);
    alpha[r] = ex2(m_r[r] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      sc[j][2 * r] = ex2(fmaf(sc[j][2 * r], mul, -m_new));
      sc[j][2 * r + 1] = ex2(fmaf(sc[j][2 * r + 1], mul, -m_new));
      sum += sc[j][2 * r] + sc[j][2 * r + 1];
    }
    l_r[r] = alpha[r] * l_r[r] + sum;
    m_r[r] = m_new;
  }
}

// P as bf16 pairs: n8 chunks 2kk and 2kk + 1 of S are the register-A
// fragment of the k16 step kk (columns 16 kk .. 16 kk + 15).
template <int NK>
__device__ __forceinline__ void to_p(uint32_t (&p)[NK / 2][4],
                                     const float (&sc)[NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK / 2; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 2 * kk + (e >> 1), x = 2 * (e & 1);
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(sc[j][x], sc[j][x + 1]);
      p[kk][e] = *reinterpret_cast<const uint32_t*>(&v2);
    }
}

// One consumer warpgroup: rows q0 + 64 wg .. + 63 of the CTA, 16 per warp.
// Software pipeline over key tiles: iteration i issues S(i) = Q·K(i)ᵀ and
// then O = alpha·O + P(i-1)·V(i-1) as two wgmma groups, runs the softmax of
// S(i) once the first has retired (wait_group 1) while the second is still
// in flight, and only then (wait_group 0) releases stage i-1 and writes
// P(i) into the registers the PV product was reading.
template <int D>
__device__ __forceinline__ void fwd_consume(const FwdLoads<D>& ld,
                                            int n_tiles,
                                            __nv_bfloat16* __restrict__ out,
                                            float* __restrict__ lse,
                                            const Dims& dm) {
  using L = FwdTile<D>;
  constexpr int ND = D / 8;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row0 = ld.q0 + wg * 64 + warp * 16;
  const uint32_t sQw = ld.sQ + wg * 64 * 128;
  auto stage_k = [&](int i) {
    return ld.sKV + (i % L::kStages) * L::kStageBytes;
  };
  float m_r[2] = {kNegInf * kLog2e, kNegInf * kLog2e}, l_r[2] = {0.f, 0.f};
  float alpha[2], o[ND][4], sc[16][4];
  uint32_t p[8][4];
  zero(o);
  // Ping-pong: the warpgroups take turns to issue their products (barrier
  // 1 + wg is this one's turn), so one's softmax runs under the other's
  // products. Warpgroup 1 lets 0 start, and skips its last hand-over so
  // that every bar.sync meets exactly one bar.arrive.
  if (wg == 1) bar_arrive(1, 256);
  mbar_wait(ld.once(), 0);
  ld.wait_full(0);
  bar_sync(1 + wg, 256);
  issue_qk<D>(sc, sQw, stage_k(0));
  if (wg == 0 || n_tiles > 1) bar_arrive(2 - wg, 256);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_tile(sc, 0, row0, dm, m_r, l_r, alpha);
  to_p(p, sc);
  for (int i = 1; i < n_tiles; ++i) {
    ld.wait_full(i);
    bar_sync(1 + wg, 256);
    issue_qk<D>(sc, sQw, stage_k(i));
    issue_pv<D>(o, p, alpha, stage_k(i - 1) + L::kKVBytes);
    if (wg == 0 || i < n_tiles - 1) bar_arrive(2 - wg, 256);
    wgmma_wait<1>();
    fence_regs(sc);
    softmax_tile(sc, i * L::kKeys, row0, dm, m_r, l_r, alpha);
    wgmma_wait<0>();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(ld.empty(i - 1));
    to_p(p, sc);
  }
  issue_pv<D>(o, p, alpha, stage_k(n_tiles - 1) + L::kKVBytes);
  wgmma_wait<0>();
  fence_regs(o);
  __syncwarp();
  if (lane == 0) mbar_arrive(ld.empty(n_tiles - 1));
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = fmaxf(quad_sum(l_r[r]), 1e-30f);
    inv[r] = 1.f / l;
    const int row = row0 + g + 8 * r;
    if (lse != nullptr && t == 0 && row < dm.sq)
      lse[((size_t)ld.bi * dm.h + ld.hi) * dm.sq + row] =
          m_r[r] / kLog2e + logf(l);
  }
  write_rows<__nv_bfloat16, ND>(
      out + ((size_t)ld.bi * dm.sq * dm.h + ld.hi) * D, (size_t)dm.h * D,
      row0, dm.sq, o, inv[0], inv[1]);
}

template <int D>
__global__ void __launch_bounds__(FwdTile<D>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, Dims dm) {
  using L = FwdTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  FwdLoads<D> ld;
  ld.tm_q = &tm_q;
  ld.tm_k = &tm_k;
  ld.tm_v = &tm_v;
  ld.sQ = base;
  ld.sKV = base + L::kQBytes;
  ld.bar = base + L::kBarOff;
  const int bh = blockIdx.x;
  ld.bi = bh / dm.h;
  ld.hi = bh % dm.h;
  ld.kvh = ld.hi / dm.n_rep;
  // Causal: the last q tiles walk the most keys; they start first.
  ld.q0 = (dm.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * L::kRows;
  const int kv_end = dm.causal ? min(dm.skv, ld.q0 + L::kRows) : dm.skv;
  const int n_tiles = (kv_end + L::kKeys - 1) / L::kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(ld.full(s), 1);
      mbar_init(ld.empty(s), L::kConsumerWarps);
    }
    mbar_init(ld.once(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // One if/else for the two roles, never rejoined, so that ptxas can give
  // each its own register count.
  if (threadIdx.x >= 32 * L::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 32 * L::kConsumerWarps) {
      ld.q();
      for (int i = 0; i < n_tiles; ++i) ld.kv(i);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    fwd_consume<D>(ld, n_tiles, out, lse, dm);
  }
}

// ------------------------------------------------------------ fp32 dQ

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    Dims dm) {
  static_assert(sizeof(T) == 4, "bf16 runs flash_bwd_dq_wgmma_kernel");
  constexpr int LD = D + kPad, LDP = kTileK + kPad;
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

// ------------------------------------------------------- fp32 dK / dV

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, Dims dm) {
  static_assert(sizeof(T) == 4, "bf16 runs flash_bwd_dkv_wgmma_kernel");
  constexpr int BQ = kTileQdkv;
  constexpr int LD = D + kPad, LDQ = BQ + kPad;
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

// ------------------------------------------------ bf16 backward products
//
// The two products of the backward passes, for one warpgroup, over tiles
// stored as 64-column halves of (rows x 128 B): a 128-row tile (the dK/dV
// pass's K or V, the dQ pass's Q or dO) has its halves 16 KB apart, a
// 64-row tile (a staged Q or dO tile in dK/dV, a staged K or V tile in dQ)
// 8 KB apart.
constexpr int kHalf128 = 128 * 128, kHalf64 = 64 * 128;

// d (64 x 64) = A·Bᵀ over the head dim: A = this warpgroup's 64 rows of a
// 128-row tile (at sA, inside its half), B = a 64-row tile, both K-major.
// Issued, not committed.
template <int D>
__device__ __forceinline__ void issue_ss64(float (&d)[8][4], uint32_t sA,
                                           uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // k16 step kk: half kk / 4, 32 bytes further per step inside it.
    const uint32_t off = (kk & 3) * 32;
    wgmma_ss(d, desc_b128(sA + (kk >> 2) * kHalf128 + off, 16, 1024),
             desc_b128(sB + (kk >> 2) * kHalf64 + off, 16, 1024), kk > 0);
  }
}

// d (64 x D) += A·B: A (64 x 64) from registers, four k16 fragments; B a
// 64-row tile read MN-major (the transpose bit; LBO = the bytes between
// its 64-column halves, 16 rows = 2048 B per k16 step). Issued, not
// committed.
template <int D>
__device__ __forceinline__ void issue_rs64(float (&d)[D / 8][4],
                                           const uint32_t (&a)[4][4],
                                           uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs(d, a[kk], desc_b128(sB + kk * 16 * 128, kHalf64, 1024));
}

// ------------------------------------------------------- bf16 dK / dV
//
// See the note at the top of the file. Every tile is stored as D / 64
// halves of (rows x 128 B), 1024-byte aligned, as in the forward.
template <int D>
struct DkvTile {
  static constexpr int kKeys = 128, kRows = 64, kStages = 4;
  static constexpr int kConsumerWarps = 8;
  static constexpr int kThreads = 32 * kConsumerWarps + 128;   // + producer
  static constexpr int kHalves = D / 64;
  static constexpr int kKVHalf = kHalf128, kQHalf = kHalf64;
  static constexpr int kKVBytes = kHalves * kKVHalf;   // the K or V tile
  static constexpr int kQBytes = kHalves * kQHalf;     // a Q or dO tile
  static constexpr int kStageBytes = 2 * kQBytes;
  // Per stage its 64 rows' LSE·log2 e, then their delta (fp32), written by
  // the producer's first warp with plain stores (TMA never writes here).
  static constexpr int kRowsOff = 2 * kKVBytes + kStages * kStageBytes;
  static constexpr int kBarOff = kRowsOff + kStages * 2 * kRows * 4;
  // + the ring's barriers (the once barrier is K/V's); + slack to align.
  static constexpr int kSmem = kBarOff + Ring<kStages>::kBarBytes + 1024;
};

// Shared-memory addresses of one backward CTA's tiles and barriers: the
// tile pair it loads once at sRes (K/V for dK/dV, Q/dO for dQ), then the
// ring's stages from sStages; tile i of the walk uses stage i % kStages,
// its second tile at + kStageBytes / 2.
template <class L>
struct TileRing : Ring<L::kStages> {
  uint32_t sRes, sStages;

  __device__ __forceinline__ uint32_t stage(int i) const {
    return sStages + (i % L::kStages) * L::kStageBytes;
  }
};

// One consumer warpgroup: keys k0 + 64 wg .. + 63 of the CTA, 16 per warp,
// over every tile of the walk; then its rows of dK·scale and dV.
template <int D>
__device__ __forceinline__ void dkv_consume(
    const TileRing<DkvTile<D>>& ring, const float* rows, int bi, int kvh,
    int k0, int qt0, int n_qt, int n_tiles, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, const Dims& dm) {
  using L = DkvTile<D>;
  constexpr int ND = D / 8;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wk0 = k0 + 64 * wg, key0 = wk0 + 16 * warp;
  const uint32_t sK = ring.sRes + wg * 64 * 128, sV = sK + L::kKVBytes;
  const float scale2 = dm.scale * kLog2e;
  float dk_acc[ND][4], dv_acc[ND][4], st[8][4], dpt[8][4];
  uint32_t pa[4][4], da[4][4];
  zero(dk_acc);
  zero(dv_acc);
  zero(st);    // the first k16 step of each product ignores them (scale_d
  zero(dpt);   // 0); zeroed once so that no read is of undefined values
  if (n_tiles > 0) mbar_wait(ring.once(), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = (qt0 + i % n_qt) * L::kRows;
    ring.wait_full(i);
    // Keys past skv, and (causal) a q tile wholly above this warpgroup's
    // keys, add nothing: the stage is only released.
    if (wk0 < dm.skv && !(dm.causal && q0 + L::kRows <= wk0)) {
      const uint32_t sQ = ring.stage(i), sdO = sQ + L::kQBytes;
      wgmma_fence();
      issue_ss64<D>(st, sK, sQ);
      issue_ss64<D>(dpt, sV, sdO);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      const float* lse2 = rows + (i % L::kStages) * 2 * L::kRows;
      const float* del = lse2 + L::kRows;
      const bool masked = (dm.causal && q0 < key0 + 15) ||
                          q0 + L::kRows > dm.sq || key0 + 16 > dm.skv;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(lse2 + 8 * j + 2 * t);
        const float2 d2 =
            *reinterpret_cast<const float2*>(del + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // p = exp(s·scale − lse) = 2^(s·scale·log2 e − lse·log2 e).
          float p = ex2(fmaf(st[j][e], scale2, -((e & 1) ? l2.y : l2.x)));
          if (masked) {
            const int key = key0 + g + 8 * (e >> 1);
            const int row = q0 + 8 * j + 2 * t + (e & 1);
            if ((dm.causal && row < key) || row >= dm.sq || key >= dm.skv)
              p = 0.f;
          }
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
      to_p(pa, st);
      to_p(da, dpt);
      wgmma_fence();
      issue_rs64<D>(dv_acc, pa, sdO);
      issue_rs64<D>(dk_acc, da, sQ);
      wgmma_commit();
      wgmma_wait<0>();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(i));
  }
  fence_regs(dk_acc);
  fence_regs(dv_acc);
  const size_t kv_stride = (size_t)dm.hkv * D;
  const size_t kv_off = ((size_t)bi * dm.skv * dm.hkv + kvh) * D;
  write_rows<__nv_bfloat16, ND>(dk + kv_off, kv_stride, key0, dm.skv, dk_acc,
                                dm.scale, dm.scale);
  write_rows<__nv_bfloat16, ND>(dv + kv_off, kv_stride, key0, dm.skv, dv_acc,
                                1.f, 1.f);
}

// One CTA = 128 keys of one (batch, kv head); grid (b·hkv, key tiles), key
// tile 0 (the most causal q tiles) first.
template <int D>
__global__ void __launch_bounds__(DkvTile<D>::kThreads, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, Dims dm) {
  using L = DkvTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = ((smem_u32(smem_raw) + 1023u) & ~1023u) -
                       smem_u32(smem_raw);
  const uint32_t base = smem_u32(smem_raw) + pad;
  const TileRing<L> ring{{base + L::kBarOff}, base, base + 2 * L::kKVBytes};
  float* rows = reinterpret_cast<float*>(smem_raw + pad + L::kRowsOff);
  const int bi = blockIdx.x / dm.hkv, kvh = blockIdx.x % dm.hkv;
  const int k0 = blockIdx.y * L::kKeys;
  // Causal: q rows below k0 see none of these keys.
  const int qt0 = dm.causal ? k0 / L::kRows : 0;
  const int n_qt = max(0, (dm.sq + L::kRows - 1) / L::kRows - qt0);
  const int n_tiles = dm.n_rep * n_qt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      // The producer warp's 32 lanes arrive on full: 31 after their LSE and
      // delta stores, lane 0 with the stage's TMA bytes.
      mbar_init(ring.full(s), 32);
      mbar_init(ring.empty(s), L::kConsumerWarps);
    }
    mbar_init(ring.once(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // One if/else for the two roles, never rejoined, so that ptxas can give
  // each its own register count.
  if (threadIdx.x >= 32 * L::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 32 * L::kConsumerWarps + 32 && n_tiles > 0) {
      if (lane == 0) {
        mbar_expect_tx(ring.once(), 2 * L::kKVBytes);
        for (int h2 = 0; h2 < L::kHalves; ++h2) {
          tma_load_4d(ring.sRes + h2 * L::kKVHalf, &tm_k, ring.once(),
                      64 * h2, kvh, k0, bi);
          tma_load_4d(ring.sRes + L::kKVBytes + h2 * L::kKVHalf, &tm_v,
                      ring.once(), 64 * h2, kvh, k0, bi);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int hi = kvh * dm.n_rep + i / n_qt;
        const int q0 = (qt0 + i % n_qt) * L::kRows;
        ring.wait_empty(i);
        // LSE and delta by plain loads (a tensor map would need 4·sq to be
        // a multiple of 16 bytes); rows past sq get defined values, which
        // the consumers' mask overrides.
        const size_t off = ((size_t)bi * dm.h + hi) * dm.sq;
        float* st = rows + (i % L::kStages) * 2 * L::kRows;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = lane + 32 * half, row = q0 + r;
          const bool ok = row < dm.sq;
          st[r] = ok ? lse[off + row] * kLog2e : 0.f;
          st[L::kRows + r] = ok ? delta[off + row] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(ring.full(i), L::kStageBytes);
          const uint32_t sQ = ring.stage(i);
          for (int h2 = 0; h2 < L::kHalves; ++h2) {
            tma_load_4d(sQ + h2 * L::kQHalf, &tm_q, ring.full(i), 64 * h2,
                        hi, q0, bi);
            tma_load_4d(sQ + L::kQBytes + h2 * L::kQHalf, &tm_do,
                        ring.full(i), 64 * h2, hi, q0, bi);
          }
        } else {
          mbar_arrive(ring.full(i));
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    dkv_consume<D>(ring, rows, bi, kvh, k0, qt0, n_qt, n_tiles, dk, dv, dm);
  }
}

// ------------------------------------------------------------ bf16 dQ
//
// See the note at the top of the file: the dK/dV pass's blocks with rows
// and keys swapped. 128 query rows per CTA (2 consumer warpgroups x 64),
// 64 keys per ring stage, every tile stored as D / 64 halves of (rows x
// 128 B), 1024-byte aligned.
template <int D>
struct DqTile {
  static constexpr int kRows = 128, kKeys = 64, kStages = 4;
  static constexpr int kConsumerWarps = 8;
  static constexpr int kThreads = 32 * kConsumerWarps + 128;   // + producer
  static constexpr int kHalves = D / 64;
  static constexpr int kQHalf = kHalf128, kKVHalf = kHalf64;
  static constexpr int kQBytes = kHalves * kQHalf;     // the Q or dO tile
  static constexpr int kKVBytes = kHalves * kKVHalf;   // a K or V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOff = 2 * kQBytes + kStages * kStageBytes;
  // + the ring's barriers (the once barrier is Q's and dO's); + slack to
  // align.
  static constexpr int kSmem = kBarOff + Ring<kStages>::kBarBytes + 1024;
};

// dS = P∘(dP − delta) in place in s for one warp's 16 rows (row0 ..) and
// the 64 keys from k0, P = 2^(S·scale·log2 e − LSE·log2 e); masked
// entries (causal, keys >= skv, rows >= sq) are 0.
__device__ __forceinline__ void dq_ds(float (&s)[8][4], const float (&dp)[8][4],
                                      const float (&lse2)[2],
                                      const float (&del)[2], int row0, int k0,
                                      const Dims& dm) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float scale2 = dm.scale * kLog2e;
  const bool masked = (dm.causal && k0 + 63 > row0) || k0 + 64 > dm.skv ||
                      row0 + 16 > dm.sq;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float p = ex2(fmaf(s[j][e], scale2, -lse2[r]));
      if (masked) {
        const int row = row0 + g + 8 * r, col = k0 + 8 * j + 2 * t + (e & 1);
        if ((dm.causal && col > row) || col >= dm.skv || row >= dm.sq)
          p = 0.f;
      }
      s[j][e] = p * (dp[j][e] - del[r]);
    }
}

// One consumer warpgroup: rows q0 + 64 wg .. + 63 of the CTA, 16 per warp.
// Tiles 0 .. n_live - 1 are computed, the rest (wholly above this
// warpgroup's rows) only released. Software pipeline over the live tiles:
// iteration i issues S(i+1), dP(i+1) and then dQ += dS(i)·K(i) as two wgmma
// groups, computes dS(i+1) once the first has retired (wait_group 1) while
// the second is in flight, and only then (wait_group 0) releases stage i
// and writes dS(i+1) into the registers the dQ product was reading. The
// first S/dP and the last dQ are peeled out of the loop, so that no wgmma
// is issued under a branch: ptxas serialises every wgmma of a kernel that
// does (its C7520 note), and that form took ~1.2x as long (PERF.md).
template <int D>
__device__ __forceinline__ void dq_consume(
    const TileRing<DqTile<D>>& ring, int bi, int hi, int q0, int n_tiles,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dq, const Dims& dm) {
  using L = DqTile<D>;
  constexpr int ND = D / 8;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int wq0 = q0 + 64 * wg, row0 = wq0 + 16 * warp;
  const uint32_t sQw = ring.sRes + wg * 64 * 128;
  const uint32_t sdOw = sQw + L::kQBytes;
  // Causal: key tiles from wq0 + 64 on lie wholly above these rows.
  const int n_live =
      wq0 >= dm.sq ? 0 : dm.causal ? min(n_tiles, wq0 / 64 + 1) : n_tiles;
  float lse2[2], del[2];
  const size_t row_off = ((size_t)bi * dm.h + hi) * dm.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    const bool ok = row < dm.sq;
    lse2[r] = ok ? lse[row_off + row] * kLog2e : 0.f;
    del[r] = ok ? delta[row_off + row] : 0.f;
  }
  float acc[ND][4], s[8][4], dp[8][4];
  uint32_t da[4][4];
  zero(acc);
  zero(s);    // the first k16 step of each product ignores them (scale_d
  zero(dp);   // 0); zeroed once so that no read is of undefined values
  if (n_live > 0) {
    mbar_wait(ring.once(), 0);
    ring.wait_full(0);
    wgmma_fence();
    issue_ss64<D>(s, sQw, ring.stage(0));
    issue_ss64<D>(dp, sdOw, ring.stage(0) + L::kKVBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    dq_ds(s, dp, lse2, del, row0, 0, dm);
    to_p(da, s);
    for (int i = 0; i < n_live - 1; ++i) {
      ring.wait_full(i + 1);
      wgmma_fence();
      issue_ss64<D>(s, sQw, ring.stage(i + 1));
      issue_ss64<D>(dp, sdOw, ring.stage(i + 1) + L::kKVBytes);
      wgmma_commit();
      issue_rs64<D>(acc, da, ring.stage(i));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
      fence_regs(dp);
      dq_ds(s, dp, lse2, del, row0, (i + 1) * L::kKeys, dm);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(ring.empty(i));
      to_p(da, s);
    }
    wgmma_fence();
    issue_rs64<D>(acc, da, ring.stage(n_live - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(n_live - 1));
  }
  for (int i = n_live; i < n_tiles; ++i) {
    ring.wait_full(i);
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty(i));
  }
  write_rows<__nv_bfloat16, ND>(
      dq + ((size_t)bi * dm.sq * dm.h + hi) * D, (size_t)dm.h * D, row0,
      dm.sq, acc, dm.scale, dm.scale);
}

// One CTA = 128 query rows of one (batch, head); grid (b·h, row tiles),
// the heaviest causal row tiles first.
template <int D>
__global__ void __launch_bounds__(DqTile<D>::kThreads, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, Dims dm) {
  using L = DqTile<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const TileRing<L> ring{{base + L::kBarOff}, base, base + 2 * L::kQBytes};
  const int bi = blockIdx.x / dm.h, hi = blockIdx.x % dm.h;
  const int kvh = hi / dm.n_rep;
  const int q0 =
      (dm.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * L::kRows;
  const int kv_end = dm.causal ? min(dm.skv, q0 + L::kRows) : dm.skv;
  const int n_tiles = (kv_end + L::kKeys - 1) / L::kKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), L::kConsumerWarps);
    }
    mbar_init(ring.once(), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // One if/else for the two roles, never rejoined, so that ptxas can give
  // each its own register count.
  if (threadIdx.x >= 32 * L::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 32 * L::kConsumerWarps) {
      mbar_expect_tx(ring.once(), 2 * L::kQBytes);
      for (int h2 = 0; h2 < L::kHalves; ++h2) {
        tma_load_4d(ring.sRes + h2 * L::kQHalf, &tm_q, ring.once(), 64 * h2,
                    hi, q0, bi);
        tma_load_4d(ring.sRes + L::kQBytes + h2 * L::kQHalf, &tm_do,
                    ring.once(), 64 * h2, hi, q0, bi);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const uint32_t sK = ring.stage(i);
        ring.wait_empty(i);
        mbar_expect_tx(ring.full(i), L::kStageBytes);
        for (int h2 = 0; h2 < L::kHalves; ++h2) {
          tma_load_4d(sK + h2 * L::kKVHalf, &tm_k, ring.full(i), 64 * h2,
                      kvh, i * L::kKeys, bi);
          tma_load_4d(sK + L::kKVBytes + h2 * L::kKVHalf, &tm_v,
                      ring.full(i), 64 * h2, kvh, i * L::kKeys, bi);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    dq_consume<D>(ring, bi, hi, q0, n_tiles, lse, delta, dq, dm);
  }
}

// ---------------------------------------------------------------- launchers

template <typename T, int D>
size_t fwd_smem() {
  return sizeof(T) * ((size_t)(kTileQ + 2 * kTileK) * (D + kPad) +
                      (size_t)kTileQ * (kTileK + kPad));
}

template <typename T, int D>
size_t dq_smem() {
  return sizeof(T) * ((size_t)(2 * kTileQ + 2 * kTileK) * (D + kPad) +
                      (size_t)kTileQ * (kTileK + kPad));
}

template <typename T, int D>
size_t dkv_smem() {
  return sizeof(T) * ((size_t)(2 * kTileK + 2 * kTileQdkv) * (D + kPad) +
                      (size_t)2 * kTileK * (kTileQdkv + kPad)) +
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

// cuTensorMapEncodeTiled is a driver-API function: fetched once through the
// runtime, so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A bf16 (batch, seq, heads, d) tensor read in place as a 4-d tensor map
// (innermost first: d, heads, seq, batch); a box is 64 columns (128 bytes,
// the swizzle's width) of `box_rows` positions of one head. Positions past
// seq arrive as zeros.
bool tensor_map(CUtensorMap* map, const void* ptr, int d, int heads,
                int seq, int batch, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {2ull * d, 2ull * d * heads,
                                 2ull * d * heads * seq};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                      void* lse, int b, int sq, int skv, int h, int hkv,
                      int causal, float scale, cudaStream_t st) {
  using L = FwdTile<D>;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, D, h, sq, b, L::kRows) ||
      !tensor_map(&tk, k, D, hkv, skv, b, L::kKeys) ||
      !tensor_map(&tv, v, D, hkv, skv, b, L::kKeys))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_fwd_wgmma_kernel<D>, L::kSmem);
  if (err != cudaSuccess) return err;
  flash_fwd_wgmma_kernel<D><<<dim3(b * h, tiles(sq, L::kRows)), L::kThreads,
                              L::kSmem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out),
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

template <int D>
cudaError_t bwd_dq_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int b, int sq, int skv, int h, int hkv,
                         int causal, float scale, cudaStream_t st) {
  using L = DqTile<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, D, h, sq, b, L::kRows) ||
      !tensor_map(&tdo, dout, D, h, sq, b, L::kRows) ||
      !tensor_map(&tk, k, D, hkv, skv, b, L::kKeys) ||
      !tensor_map(&tv, v, D, hkv, skv, b, L::kKeys))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_dq_wgmma_kernel<D>, L::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wgmma_kernel<D><<<dim3(b * h, tiles(sq, L::kRows)),
                                 L::kThreads, L::kSmem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
      dims(sq, skv, h, hkv, causal, scale));
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dk, void* dv, int b,
                          int sq, int skv, int h, int hkv, int causal,
                          float scale, cudaStream_t st) {
  using L = DkvTile<D>;
  CUtensorMap tq, tk, tv, tdo;
  if (!tensor_map(&tq, q, D, h, sq, b, L::kRows) ||
      !tensor_map(&tdo, dout, D, h, sq, b, L::kRows) ||
      !tensor_map(&tk, k, D, hkv, skv, b, L::kKeys) ||
      !tensor_map(&tv, v, D, hkv, skv, b, L::kKeys))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, L::kSmem);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wgmma_kernel<D><<<dim3(b * hkv, tiles(skv, L::kKeys)),
                                  L::kThreads, L::kSmem, st>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), dims(sq, skv, h, hkv, causal, scale));
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

// f(std::integral_constant<int, D>{}) at the head dims with a caller: 128
// (the bench config, Llama-3-8B) and 64 (the card tests' small configs);
// anything else is refused.
template <typename F>
cudaError_t by_head_dim(int d, F f) {
  switch (d) {
    case 64:
      return f(std::integral_constant<int, 64>{});
    case 128:
      return f(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid(int b, int sq, int skv, int h, int hkv) {
  return b > 0 && sq > 0 && skv > 0 && hkv > 0 && h % hkv == 0 &&
         tiles(sq, kTileQ) <= 65535 && tiles(skv, kTileK) <= 65535;
}

}  // namespace

// q (b, sq, h, d), k/v (b, skv, hkv, d) -> out like q, lse (b, h, sq) fp32
// or nullptr for none. bf16 runs flash_fwd_wgmma_kernel, fp32 the
// CUDA-core flash_fwd_kernel.
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int b, int sq, int skv,
                                int h, int hkv, int d, int causal,
                                float scale, int is_bf16, void* stream) {
  if (!valid(b, sq, skv, h, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_head_dim(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return is_bf16 ? fwd_wgmma<D>(q, k, v, out, lse, b, sq, skv, h, hkv,
                                  causal, scale, st)
                   : fwd<float, D>(q, k, v, out, lse, b, sq, skv, h, hkv,
                                   causal, scale, st);
  });
}

// Dynamic shared memory of the forward kernel for head dim d (bf16 or
// fp32), for reports beside ptxas's register counts.
extern "C" int flash_fwd_smem_bytes(int d, int is_bf16) {
  if (d == 64)
    return (int)(is_bf16 ? FwdTile<64>::kSmem : fwd_smem<float, 64>());
  if (d == 128)
    return (int)(is_bf16 ? FwdTile<128>::kSmem : fwd_smem<float, 128>());
  return -1;
}

// + dout like q, lse and delta (b, h, sq) fp32 -> dq like q:
// flash_bwd_dq_wgmma_kernel (bf16) or the CUDA-core flash_bwd_dq_kernel
// (fp32).
extern "C" int flash_bwd_dq_launch(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int b, int sq, int skv, int h,
                                   int hkv, int d, int causal, float scale,
                                   int is_bf16, void* stream) {
  if (!valid(b, sq, skv, h, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_head_dim(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return is_bf16 ? bwd_dq_wgmma<D>(q, k, v, dout, lse, delta, dq, b, sq,
                                     skv, h, hkv, causal, scale, st)
                   : bwd_dq<float, D>(q, k, v, dout, lse, delta, dq, b, sq,
                                      skv, h, hkv, causal, scale, st);
  });
}

// Dynamic shared memory of the bf16 dQ kernel for head dim d, for reports
// beside ptxas's register counts.
extern "C" int flash_bwd_dq_smem_bytes(int d) {
  return d == 64 ? DqTile<64>::kSmem : d == 128 ? DqTile<128>::kSmem : -1;
}

// Dynamic shared memory of the bf16 dK/dV kernel for head dim d, for
// reports beside ptxas's register counts.
extern "C" int flash_bwd_dkv_smem_bytes(int d) {
  return d == 64 ? DkvTile<64>::kSmem : d == 128 ? DkvTile<128>::kSmem : -1;
}

// The same inputs -> dk, dv like k, v: flash_bwd_dkv_wgmma_kernel (bf16)
// or the CUDA-core flash_bwd_dkv_kernel (fp32).
extern "C" int flash_bwd_dkv_launch(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int b, int sq,
                                    int skv, int h, int hkv, int d,
                                    int causal, float scale, int is_bf16,
                                    void* stream) {
  if (!valid(b, sq, skv, h, hkv)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)by_head_dim(d, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return is_bf16 ? bwd_dkv_wgmma<D>(q, k, v, dout, lse, delta, dk, dv, b,
                                      sq, skv, h, hkv, causal, scale, st)
                   : bwd_dkv<float, D>(q, k, v, dout, lse, delta, dk, dv, b,
                                       sq, skv, h, hkv, causal, scale, st);
  });
}

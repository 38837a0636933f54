// Fused center + scale + mask + Gram for Hopper (sm_90a).
//
//     G = (diag(rowmul) · (X − mean))ᵀ (diag(rowmul) · (X − mean))
//
// X is (rows, n) float32 with unit column stride and any row stride, mean is
// (n,), rowmul is (rows,) (row mask × 1/√(count−1), 0 on padding rows); G is
// (n, n) float32 and comes out exactly symmetric.
//
// Replaces the TPU Pallas kernel spark_rapids_ml_tpu/ops/pallas_gram.py
// ::_fused_centered_gram (body _make_gram_kernel → _gram_kernel, grid maps
// _folded_triangle_maps, mirror triu(out) + triu(out, 1).T). It computes
// the same function; it is not carried over block by block.
//
// What bounds it on an H100 SXM: at the main-path bucket (8192 × 4096) the
// upper triangle is 8192·4096·4097/2 ≈ 6.9e10 multiply-adds per pass against
// 134 MB of X read and 67 MB of G written. Every precision is bound by
// operations: bfloat16_3x ≈ 0.42 ms at 989 TFLOP/s (three passes),
// bfloat16 ≈ 0.14 ms, highest ≈ 2.1 ms at 67 TFLOP/s FP32; bytes ≈ 0.06 ms
// at 3.35 TB/s.
//
// Common to every precision:
//  * Only the upper output tiles (ti ≤ tj) of a 128 × 128 tiling are
//    computed, half the operations of a full Gram. One block per upper tile,
//    indexed directly and in row-major order of the triangle, so any tile
//    count works (the TPU fold needed an even count).
//  * Rows ≥ rows and columns ≥ n count as 0, so X is never padded on the
//    host, and any row stride is taken.
//  * The block writes its tile and the mirrored tile (on a diagonal tile
//    only the elements with row ≤ col, and their mirrors), so one launch
//    yields the whole symmetric G with no separate triu pass.
//
// highest: gram_f32_kernel, full-f32 FFMA with an 8 × 8 register tile per
// thread, centring on load (TF32 is not full f32).
//
// bfloat16 / bfloat16_3x: two launches on one stream.
//  1. gram_prep_kernel, one coalesced pass over X: x̃ = (x − mean)·rowmul in
//     f32, rounded to bf16 (nearest even) as hi and, for bfloat16_3x,
//     lo = bf16(x̃ − hi), written transposed as x̃ᵀ (n × kp, K-major, rows
//     zero-padded to kp, a multiple of the 64-deep k-block) into scratch
//     the caller allocates. Each element is centred and rounded once, not
//     once for each of the T + 1 tiles that read it (33 at n = 4096). The
//     K-major copy is what TMA and wgmma read best, and its 16-byte-aligned
//     rows free the GEMM from X's stride and alignment.
//  2. gram_tc_kernel, G = x̃ᵀ·x̃ over the upper tiles, as a warp-specialised
//     TMA + mbarrier + wgmma pipeline: 384 threads; warpgroup 2 gives up its
//     registers and one of its threads issues cp.async.bulk.tensor loads of
//     128-byte-swizzled 128 × 64 bf16 panels (A = rows i0.., B = rows j0..
//     of x̃ᵀ; for bfloat16_3x also their lo panels) into a ring of stages;
//     warpgroups 0 and 1 each own 64 rows of the tile and run
//     wgmma.m64n128k16 with both operands from shared memory into f32
//     registers, keeping one k-block of wgmma in flight while they release
//     the stage before it. bfloat16_3x issues hi·hi into one accumulator
//     and hi·lo + lo·hi into a second (lo·lo dropped, as the TPU kernel
//     did); the small cross terms are summed apart from the large ones and
//     added once at the end. The epilogue stages the tile in the drained
//     ring (f32, rows padded to 129 floats against bank conflicts) and
//     writes it and its mirror with coalesced stores.
//     Tile 128 × 128: 528 upper tiles at n = 4096, exactly 4 waves on 132
//     SMs (256-edge or 128 × 256 tiles give 1.03 or 2.06 waves). Stages:
//     6 of 32 KiB (bfloat16) or 3 of 64 KiB (bfloat16_3x), 192 KiB either
//     way, one block per SM. Each tile reads its two panels over all k, so
//     L2 serves 2.2 GB (hi) or 4.4 GB (hi + lo) per bucket, 16× or 33× the
//     scratch. The row-major triangle order puts a wave on about 5 A
//     panels and all B panels, every block moving through k at the same
//     pace, so a panel's k-block should reach L2 from device memory about
//     once per wave (device-memory traffic is not measured). Measured on
//     an H100 (PERF.md): both modes read panels through L2 at about
//     8 TB/s while bfloat16_3x does three times the products per byte, so
//     the panel feed, not the tensor cores, bounds the one-pass mode.
// A wait on a pipeline barrier that outlasts 2 s traps (hopper_ptx.cuh), so a
// broken protocol fails the launch instead of hanging the card.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_ptx.cuh"

namespace {

constexpr int kModeF32 = 0;     // highest / float32
constexpr int kModeBf16 = 1;    // bfloat16 / default: one bf16 pass
constexpr int kModeBf16x3 = 2;  // bfloat16_3x: hi/lo split, three bf16 passes

constexpr int BN = 128;         // output tile edge
constexpr int THREADS = 256;    // 8 warps
constexpr int F32_BR = 8;       // rows per chunk, FFMA kernel

constexpr int PREP_TILE = 64;                  // prep pass: 64 rows × 64 columns per block
constexpr int TC_BK = 64;                      // k-block: 64 bf16 = 128 bytes, one swizzle row
constexpr int TC_PANEL_BYTES = BN * TC_BK * 2; // one 128 × 64 bf16 panel, 16 KiB
constexpr int TC_CONSUMERS = 2;                // warpgroups running wgmma, 64 tile rows each
constexpr int TC_THREADS = 128 * (TC_CONSUMERS + 1);
constexpr int TC_EPI_LD = BN + 1;              // f32 staging row of the epilogue

template <bool kSplit>
struct TcConfig {
  static constexpr int kPlanes = kSplit ? 2 : 1;                  // hi (+ lo)
  static constexpr int kStageBytes = 2 * kPlanes * TC_PANEL_BYTES;  // A and B panels
  static constexpr int kStages = kSplit ? 3 : 6;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // 1024 bytes to align the ring for the swizzle, then the ring, then a full
  // and an empty barrier per stage
  static constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
  static_assert(kRingBytes >= BN * TC_EPI_LD * 4, "epilogue staging must fit in the ring");
};

// Linear upper-triangle tile index → (ti, tj) with ti ≤ tj.
__device__ __forceinline__ void upper_tile(int t, int tiles, int& ti, int& tj) {
  int i = 0;
  while (t >= tiles - i) {
    t -= tiles - i;
    ++i;
  }
  ti = i;
  tj = i + t;
}

// (x − mean[col]) · rowmul[row], 0 outside [0, rows) × [0, n).
__device__ __forceinline__ float centered(const float* __restrict__ x, long long ldx,
                                          const float* __restrict__ mean,
                                          const float* __restrict__ rowmul, int row, int col,
                                          int rows, int n) {
  if (row >= rows || col >= n) return 0.0f;
  return (x[static_cast<long long>(row) * ldx + col] - mean[col]) * rowmul[row];
}

// Write G[gi, gj] and G[gj, gi] for an element on or above the diagonal.
__device__ __forceinline__ void store_sym(float* __restrict__ g, int n, int gi, int gj, float v) {
  if (gi < n && gj < n && gi <= gj) {
    g[static_cast<long long>(gi) * n + gj] = v;
    g[static_cast<long long>(gj) * n + gi] = v;
  }
}

// highest: full-f32 FFMA. 256 threads as 16 × 16; thread (tx, ty) owns rows
// {ty*4 .. +3, 64 + ty*4 .. +3} and columns {tx*4 .. +3, 64 + tx*4 .. +3} of
// the tile, so its shared reads are two float4s per operand per row.
__global__ void __launch_bounds__(THREADS)
gram_f32_kernel(const float* __restrict__ x, long long ldx, const float* __restrict__ mean,
                const float* __restrict__ rowmul, float* __restrict__ g, int rows, int n,
                int tiles) {
  __shared__ __align__(16) float a_s[F32_BR][BN];
  __shared__ __align__(16) float b_s[F32_BR][BN];
  int ti, tj;
  upper_tile(blockIdx.x, tiles, ti, tj);
  const int i0 = ti * BN, j0 = tj * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.0f;

  for (int r0 = 0; r0 < rows; r0 += F32_BR) {
#pragma unroll
    for (int q = 0; q < F32_BR * BN / THREADS; ++q) {
      const int e = tid + q * THREADS, rr = e / BN, cc = e % BN;
      a_s[rr][cc] = centered(x, ldx, mean, rowmul, r0 + rr, i0 + cc, rows, n);
      b_s[rr][cc] = centered(x, ldx, mean, rowmul, r0 + rr, j0 + cc, rows, n);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < F32_BR; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int gi = i0 + (u < 4 ? ty * 4 + u : 64 + ty * 4 + u - 4);
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int gj = j0 + (v < 4 ? tx * 4 + v : 64 + tx * 4 + v - 4);
      store_sym(g, n, gi, gj, acc[u][v]);
    }
  }
}

// Prep pass for the bf16 modes: block (bx, by) centres the 64 × 64 tile of X
// at rows bx·64.., columns by·64.. into shared memory (coalesced along the
// columns of X), then writes it transposed into hi[c][r] (and lo[c][r]) as
// bf16 pairs (coalesced along the rows of X). Rows in [rows, kp) write 0.
template <bool kSplit>
__global__ void __launch_bounds__(256)
gram_prep_kernel(const float* __restrict__ x, long long ldx, const float* __restrict__ mean,
                 const float* __restrict__ rowmul, __nv_bfloat16* __restrict__ hi,
                 __nv_bfloat16* __restrict__ lo, int rows, int n, int kp) {
  __shared__ float tile[PREP_TILE][PREP_TILE + 1];
  const int r0 = blockIdx.x * PREP_TILE, c0 = blockIdx.y * PREP_TILE;
  const int tx = threadIdx.x % PREP_TILE;
  for (int rr = threadIdx.x / PREP_TILE; rr < PREP_TILE; rr += 256 / PREP_TILE) {
    tile[rr][tx] = centered(x, ldx, mean, rowmul, r0 + rr, c0 + tx, rows, n);
  }
  __syncthreads();
  const int kk = 2 * (threadIdx.x % 32);
  for (int cc = threadIdx.x / 32; cc < PREP_TILE && c0 + cc < n; cc += 256 / 32) {
    const float v0 = tile[kk][cc], v1 = tile[kk + 1][cc];
    const __nv_bfloat162 h = __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
    const long long off = static_cast<long long>(c0 + cc) * kp + r0 + kk;
    *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
    if constexpr (kSplit) {
      *reinterpret_cast<__nv_bfloat162*>(lo + off) =
          __halves2bfloat162(__float2bfloat16_rn(v0 - __low2float(h)),
                             __float2bfloat16_rn(v1 - __high2float(h)));
    }
  }
}

// Tensor-core Gram over the upper tiles of x̃ᵀ (n × kp, K-major bf16), read
// through `map_hi` (and `map_lo` for bfloat16_3x). See the note at the top.
template <bool kSplit>
__global__ void __launch_bounds__(TC_THREADS, 1)
gram_tc_kernel(const __grid_constant__ CUtensorMap map_hi,
               const __grid_constant__ CUtensorMap map_lo, float* __restrict__ g, int n, int kp,
               int tiles) {
  using Cfg = TcConfig<kSplit>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - raw % 1024) % 1024);  // swizzle atoms need 1024
  const uint32_t ring = hopper::smem_addr(smem);
  const uint32_t full0 = ring + Cfg::kRingBytes;  // full barrier of stage s at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * Cfg::kStages;

  int ti, tj;
  upper_tile(blockIdx.x, tiles, ti, tj);
  const int i0 = ti * BN, j0 = tj * BN, nk = kp / TC_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < Cfg::kStages; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);               // the producer's expect_tx
      hopper::mbar_init(empty0 + 8 * s, TC_CONSUMERS);   // one per consumer warpgroup
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == TC_CONSUMERS) {
    // producer warpgroup: one thread keeps the ring full
    hopper::regs_dealloc<40>();
    if (threadIdx.x == TC_CONSUMERS * 128) {
      hopper::prefetch_tensor_map(&map_hi);
      if constexpr (kSplit) hopper::prefetch_tensor_map(&map_lo);
      int s = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        hopper::mbar_wait(empty0 + 8 * s, phase ^ 1);  // first round passes at once
        const uint32_t full = full0 + 8 * s, st = ring + s * Cfg::kStageBytes;
        const int k = kb * TC_BK;
        hopper::mbar_arrive_expect_tx(full, Cfg::kStageBytes);
        hopper::tma_load_2d(st, &map_hi, k, i0, full);
        hopper::tma_load_2d(st + TC_PANEL_BYTES, &map_hi, k, j0, full);
        if constexpr (kSplit) {
          hopper::tma_load_2d(st + 2 * TC_PANEL_BYTES, &map_lo, k, i0, full);
          hopper::tma_load_2d(st + 3 * TC_PANEL_BYTES, &map_lo, k, j0, full);
        }
        if (++s == Cfg::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: rows 64·wg .. 64·wg + 63 of the tile
    hopper::regs_alloc<232>();
    float acc[64];
    float cross[kSplit ? 64 : 1];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < (kSplit ? 64 : 1); ++i) cross[i] = 0.0f;

    const uint32_t a_off = wg * 64 * TC_BK * 2;  // this warpgroup's 64 rows of A
    int s = 0, prev = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      hopper::mbar_wait(full0 + 8 * s, phase);
      const uint32_t st = ring + s * Cfg::kStageBytes;
      const uint64_t a_hi = hopper::desc_k_major_sw128(st + a_off);
      const uint64_t b_hi = hopper::desc_k_major_sw128(st + TC_PANEL_BYTES);
      hopper::fence_operands(acc);
      if constexpr (kSplit) hopper::fence_operands(cross);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_BK / 16; ++kk) {
        hopper::wgmma_m64n128k16_bf16(acc, a_hi + 2 * kk, b_hi + 2 * kk);
        if constexpr (kSplit) {
          const uint64_t a_lo = hopper::desc_k_major_sw128(st + 2 * TC_PANEL_BYTES + a_off);
          const uint64_t b_lo = hopper::desc_k_major_sw128(st + 3 * TC_PANEL_BYTES);
          hopper::wgmma_m64n128k16_bf16(cross, a_hi + 2 * kk, b_lo + 2 * kk);
          hopper::wgmma_m64n128k16_bf16(cross, a_lo + 2 * kk, b_hi + 2 * kk);
        }
      }
      hopper::wgmma_commit();
      // the previous k-block's products are done: hand its stage back
      hopper::wgmma_wait<1>();
      hopper::fence_operands(acc);
      if constexpr (kSplit) hopper::fence_operands(cross);
      if (kb > 0 && threadIdx.x % 128 == 0) hopper::mbar_arrive(empty0 + 8 * prev);
      prev = s;
      if (++s == Cfg::kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    if constexpr (kSplit) {
      hopper::fence_operands(cross);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += cross[i];
    }

    // Epilogue. Every load has landed and both warpgroups have finished
    // reading the ring, so it is free for the f32 tile.
    hopper::named_barrier_sync(1, TC_CONSUMERS * 128);
    float* tile = reinterpret_cast<float*>(smem);
    const int t = threadIdx.x % 128;
    const int row = wg * 64 + 16 * (t / 32) + (t % 32) / 4, col = 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int b = 0; b < 2; ++b)
          tile[(row + 8 * h) * TC_EPI_LD + 8 * j + col + b] = acc[4 * j + 2 * h + b];
    hopper::named_barrier_sync(1, TC_CONSUMERS * 128);

    const int tid = threadIdx.x;  // 0 .. 255
    if (ti == tj) {
      // diagonal tile: the elements with row ≤ col and their mirrors
      for (int e = tid; e < BN * BN; e += TC_CONSUMERS * 128) {
        const int r = e / BN, c = e % BN, gi = i0 + r, gj = i0 + c;
        if (gi < n && gj < n) {
          g[static_cast<long long>(gi) * n + gj] =
              r <= c ? tile[r * TC_EPI_LD + c] : tile[c * TC_EPI_LD + r];
        }
      }
    } else {
      for (int e = tid; e < BN * BN; e += TC_CONSUMERS * 128) {
        const int r = e / BN, c = e % BN, gi = i0 + r, gj = j0 + c;
        if (gi < n && gj < n) g[static_cast<long long>(gi) * n + gj] = tile[r * TC_EPI_LD + c];
      }
      for (int e = tid; e < BN * BN; e += TC_CONSUMERS * 128) {
        const int c = e / BN, r = e % BN, gi = i0 + r, gj = j0 + c;
        if (gi < n && gj < n) g[static_cast<long long>(gj) * n + gi] = tile[r * TC_EPI_LD + c];
      }
    }
  }
}

bool valid_prep_args(int rows, int n, int kp, const void* scratch) {
  return scratch != nullptr && rows >= 0 && n > 0 && kp > 0 && kp % TC_BK == 0 && kp >= rows &&
         (n + PREP_TILE - 1) / PREP_TILE <= 65535;
}

cudaError_t launch_prep(const float* x, long long ldx, const float* mean, const float* rowmul,
                        __nv_bfloat16* hi, int rows, int n, int mode, int kp, cudaStream_t s) {
  const dim3 grid(kp / PREP_TILE, (n + PREP_TILE - 1) / PREP_TILE);
  if (mode == kModeBf16x3) {
    __nv_bfloat16* lo = hi + static_cast<long long>(n) * kp;
    gram_prep_kernel<true><<<grid, 256, 0, s>>>(x, ldx, mean, rowmul, hi, lo, rows, n, kp);
  } else {
    gram_prep_kernel<false><<<grid, 256, 0, s>>>(x, ldx, mean, rowmul, hi, nullptr, rows, n, kp);
  }
  return cudaGetLastError();
}

// Tensor map over one n × kp bf16 plane: 128 × 64 boxes, 128-byte swizzle,
// rows past n read as 0.
bool encode_plane(CUtensorMap* map, const __nv_bfloat16* plane, int n, int kp) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(kp), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(kp) * 2};
  const cuuint32_t box[2] = {TC_BK, BN};
  const cuuint32_t elem_strides[2] = {1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                                const_cast<__nv_bfloat16*>(plane), dims, strides, box,
                                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kSplit>
cudaError_t launch_tc(const __nv_bfloat16* hi, float* g, int n, int kp, int tiles,
                      unsigned blocks, cudaStream_t s) {
  CUtensorMap map_hi, map_lo;
  if (!encode_plane(&map_hi, hi, n, kp)) return cudaErrorInvalidValue;
  if (!encode_plane(&map_lo, kSplit ? hi + static_cast<long long>(n) * kp : hi, n, kp)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = TcConfig<kSplit>::kSmemBytes;
  const cudaError_t err =
      cudaFuncSetAttribute(gram_tc_kernel<kSplit>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gram_tc_kernel<kSplit><<<blocks, TC_THREADS, smem, s>>>(map_hi, map_lo, g, n, kp, tiles);
  return cudaGetLastError();
}

}  // namespace

// C entry points for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each launches on `stream` without synchronising and returns
// the cudaError_t of its launches (0 on success).

// The prep pass alone (modes 1 and 2): writes x̃ᵀ's hi plane, and for mode 2
// the lo plane after it, into `scratch` (planes × n × kp bf16).
extern "C" int tpuml_gram_prep(const void* x, long long ldx, const void* mean, const void* rowmul,
                               void* scratch, int rows, int n, int mode, int kp, void* stream) {
  if (ldx < n || (mode != kModeBf16 && mode != kModeBf16x3) ||
      !valid_prep_args(rows, n, kp, scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_prep(
      static_cast<const float*>(x), ldx, static_cast<const float*>(mean),
      static_cast<const float*>(rowmul), static_cast<__nv_bfloat16*>(scratch), rows, n, mode, kp,
      static_cast<cudaStream_t>(stream)));
}

// The whole Gram. Mode 0 is one FFMA launch and ignores `scratch` and `kp`;
// modes 1 and 2 are the prep pass into `scratch` and the tensor-core launch.
extern "C" int tpuml_fused_centered_gram(const void* x, long long ldx, const void* mean,
                                         const void* rowmul, void* g, int rows, int n, int mode,
                                         void* scratch, int kp, void* stream) {
  if (rows < 0 || n <= 0 || ldx < n) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (static_cast<long long>(n) + BN - 1) / BN;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rowmul);
  float* gf = static_cast<float*>(g);
  const int t = static_cast<int>(tiles);
  if (mode == kModeF32) {
    gram_f32_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(xf, ldx, mf, rf, gf, rows,
                                                                      n, t);
    return static_cast<int>(cudaGetLastError());
  }
  if ((mode != kModeBf16 && mode != kModeBf16x3) || !valid_prep_args(rows, n, kp, scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(scratch);
  cudaError_t err = launch_prep(xf, ldx, mf, rf, hi, rows, n, mode, kp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = mode == kModeBf16x3 ? launch_tc<true>(hi, gf, n, kp, t, static_cast<unsigned>(blocks), s)
                            : launch_tc<false>(hi, gf, n, kp, t, static_cast<unsigned>(blocks), s);
  return static_cast<int>(err);
}

// Dynamic shared memory of the tensor-core launch for a mode (0 for mode 0).
extern "C" int tpuml_gram_dynamic_smem(int mode) {
  if (mode == kModeBf16) return TcConfig<false>::kSmemBytes;
  if (mode == kModeBf16x3) return TcConfig<true>::kSmemBytes;
  return 0;
}

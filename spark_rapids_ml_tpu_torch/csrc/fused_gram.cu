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
// highest ≈ 2.1 ms at 67 TFLOP/s FP32, bytes ≈ 0.06 ms at 3.35 TB/s.
//
// What the design does about it:
//  * Only the upper output tiles (ti ≤ tj) of a BN × BN tiling are computed,
//    half the operations of a full Gram. One block per upper tile, indexed
//    directly, so any tile count works (the TPU fold needed an even count).
//  * Each block loops over the rows in chunks; this loop replaces the TPU
//    grid's sequential row axis, and nothing carries between blocks.
//  * (x − mean[col]) · rowmul[row] is applied while a chunk is loaded into
//    shared memory, and rows ≥ rows or columns ≥ n load as 0, so X is never
//    padded or copied on the host and no centred copy is materialised.
//  * The block writes its tile and the mirrored tile (on a diagonal tile only
//    the elements with row ≤ col, and their mirrors), so one launch yields the
//    whole symmetric G with no separate triu pass.
//  * bfloat16 modes run on the tensor cores through WMMA 16×16×16 with f32
//    accumulation; bfloat16_3x splits each operand into bf16 hi + lo parts on
//    load and sums hi·hi + hi·lo + lo·hi (lo·lo dropped), as the TPU kernel
//    did. highest runs full-f32 FFMA with an 8 × 8 register tile per thread
//    (TF32 is not full f32).
// This is the simple first version: no TMA, no wgmma, no software pipeline.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kModeF32 = 0;     // highest / float32
constexpr int kModeBf16 = 1;    // bfloat16 / default: one bf16 pass
constexpr int kModeBf16x3 = 2;  // bfloat16_3x: hi/lo split, three bf16 passes

constexpr int BN = 128;         // output tile edge
constexpr int THREADS = 256;    // 8 warps
constexpr int F32_BR = 8;       // rows per chunk, FFMA kernel
constexpr int BF_BR = 32;       // rows per chunk, WMMA kernel
constexpr int BF_LD = BN + 8;   // padded bf16 row of a shared panel (16-byte multiple)

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

// bfloat16 / bfloat16_3x on the tensor cores. The panels are stored row by
// row (a_hi[r][m] = x̃[r0 + r, i0 + m]), which is A = x̃_iᵀ in column-major
// and B = x̃_j in row-major, so no transpose is needed. 8 warps as 2 × 4, each
// owning a 64 × 32 slab of the tile as 4 × 2 accumulator fragments.
template <bool kSplit>
__global__ void __launch_bounds__(THREADS)
gram_bf16_kernel(const float* __restrict__ x, long long ldx, const float* __restrict__ mean,
                 const float* __restrict__ rowmul, float* __restrict__ g, int rows, int n,
                 int tiles) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 a_hi[BF_BR][BF_LD];
  __shared__ __align__(32) __nv_bfloat16 b_hi[BF_BR][BF_LD];
  __shared__ __align__(32) __nv_bfloat16 a_lo[kSplit ? BF_BR : 1][BF_LD];
  __shared__ __align__(32) __nv_bfloat16 b_lo[kSplit ? BF_BR : 1][BF_LD];
  __shared__ __align__(32) float stage[THREADS / 32][16 * 16];

  int ti, tj;
  upper_tile(blockIdx.x, tiles, ti, tj);
  const int i0 = ti * BN, j0 = tj * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int fm = 0; fm < 4; ++fm)
#pragma unroll
    for (int fn = 0; fn < 2; ++fn) wmma::fill_fragment(acc[fm][fn], 0.0f);

  for (int r0 = 0; r0 < rows; r0 += BF_BR) {
#pragma unroll 4
    for (int q = 0; q < BF_BR * BN / THREADS; ++q) {
      const int e = threadIdx.x + q * THREADS, rr = e / BN, cc = e % BN;
      const float va = centered(x, ldx, mean, rowmul, r0 + rr, i0 + cc, rows, n);
      const float vb = centered(x, ldx, mean, rowmul, r0 + rr, j0 + cc, rows, n);
      const __nv_bfloat16 ha = __float2bfloat16_rn(va);
      const __nv_bfloat16 hb = __float2bfloat16_rn(vb);
      a_hi[rr][cc] = ha;
      b_hi[rr][cc] = hb;
      if constexpr (kSplit) {
        a_lo[rr][cc] = __float2bfloat16_rn(va - __bfloat162float(ha));
        b_lo[rr][cc] = __float2bfloat16_rn(vb - __bfloat162float(hb));
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BF_BR; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int fm = 0; fm < 4; ++fm)
        wmma::load_matrix_sync(fa[fm], &a_hi[kk][wm * 64 + fm * 16], BF_LD);
#pragma unroll
      for (int fn = 0; fn < 2; ++fn)
        wmma::load_matrix_sync(fb[fn], &b_hi[kk][wn * 32 + fn * 16], BF_LD);
#pragma unroll
      for (int fm = 0; fm < 4; ++fm)
#pragma unroll
        for (int fn = 0; fn < 2; ++fn) wmma::mma_sync(acc[fm][fn], fa[fm], fb[fn], acc[fm][fn]);
      if constexpr (kSplit) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa_lo[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb_lo[2];
#pragma unroll
        for (int fm = 0; fm < 4; ++fm)
          wmma::load_matrix_sync(fa_lo[fm], &a_lo[kk][wm * 64 + fm * 16], BF_LD);
#pragma unroll
        for (int fn = 0; fn < 2; ++fn)
          wmma::load_matrix_sync(fb_lo[fn], &b_lo[kk][wn * 32 + fn * 16], BF_LD);
#pragma unroll
        for (int fm = 0; fm < 4; ++fm)
#pragma unroll
          for (int fn = 0; fn < 2; ++fn) {
            wmma::mma_sync(acc[fm][fn], fa[fm], fb_lo[fn], acc[fm][fn]);
            wmma::mma_sync(acc[fm][fn], fa_lo[fm], fb[fn], acc[fm][fn]);
          }
      }
    }
    __syncthreads();
  }

  // Each warp stages one 16 × 16 fragment at a time in its own slice of shared
  // memory, then writes the in-range upper elements and their mirrors.
  float* st = stage[warp];
#pragma unroll
  for (int fm = 0; fm < 4; ++fm)
#pragma unroll
    for (int fn = 0; fn < 2; ++fn) {
      wmma::store_matrix_sync(st, acc[fm][fn], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 16 * 16; e += 32) {
        store_sym(g, n, i0 + wm * 64 + fm * 16 + e / 16, j0 + wn * 32 + fn * 16 + e % 16, st[e]);
      }
      __syncwarp();
    }
}

}  // namespace

// C entry point for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Launches on `stream` without synchronising and returns the
// cudaError_t of the launch (0 on success).
extern "C" int tpuml_fused_centered_gram(const void* x, long long ldx, const void* mean,
                                         const void* rowmul, void* g, int rows, int n, int mode,
                                         void* stream) {
  if (rows < 0 || n <= 0 || ldx < n) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = (static_cast<long long>(n) + BN - 1) / BN;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mean);
  const float* rf = static_cast<const float*>(rowmul);
  float* gf = static_cast<float*>(g);
  const int t = static_cast<int>(tiles);
  switch (mode) {
    case kModeF32:
      gram_f32_kernel<<<grid, THREADS, 0, s>>>(xf, ldx, mf, rf, gf, rows, n, t);
      break;
    case kModeBf16:
      gram_bf16_kernel<false><<<grid, THREADS, 0, s>>>(xf, ldx, mf, rf, gf, rows, n, t);
      break;
    case kModeBf16x3:
      gram_bf16_kernel<true><<<grid, THREADS, 0, s>>>(xf, ldx, mf, rf, gf, rows, n, t);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

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
// Every precision runs in two launches on one stream: a prep pass that
// centres X once into scratch the caller allocates, then a Gram pipeline
// that reads only that scratch.
//  * The prep pass computes x̃ = (x − mean)·rowmul in f32, subtract then
//    multiply, as the plain version does, once per element and not once for
//    each of the T + 1 tiles that read it (33 at n = 4096). It takes any row
//    stride and alignment of X and writes scratch whose rows are padded to
//    a multiple of 64 with zeros (`kp`), so the Gram sees no stride, mean or
//    mask and TMA's 16-byte rules always hold.
//  * The Gram computes only the upper output tiles (ti ≤ tj) of a 128 × 128
//    tiling, half the operations of a full Gram: one block per upper tile,
//    indexed directly in row-major order of the triangle (528 tiles at
//    n = 4096, exactly 4 waves on 132 SMs; any tile count works, where the
//    TPU fold needed an even count). A warp-specialised pipeline feeds it:
//    one producer thread, in a warpgroup that gives up its registers
//    (setmaxnreg), issues cp.async.bulk.tensor loads of the A panel (scratch
//    at tile rows i0..) and the B panel (j0..) of each k-block into a ring
//    of stages with full/empty mbarriers; the consumer warpgroups compute.
//    Columns past n load as zeros from TMA's out-of-range fill. The
//    epilogue stages the f32 tile in the drained ring (rows padded to 129
//    floats against bank conflicts) and writes it and its mirror with
//    coalesced stores (on a diagonal tile only the elements with row ≤ col,
//    and their mirrors), so one call yields the whole symmetric G with no
//    separate triu pass.
//
// highest: full f32 (TF32 and the bf16 split are other precisions).
//  1. gram_prep_f32_kernel writes x̃ row-major, not transposed, as f32
//     (kp × n4, n4 = n rounded up to 4 floats for TMA's 16-byte row stride):
//     an FFMA product reads both operands along the features, which is X's
//     own orientation. Columns in [n, n4) and rows in [rows, kp) are written
//     as zeros. 134 MB read + 134 MB written at the bucket.
//  2. gram_ffma_kernel: TMA loads unswizzled [BK][128] f32 boxes, the layout
//     the thread mapping reads without bank conflicts (per k, one broadcast
//     float4 per 4 rows of A and 16 consecutive float4s per half of B). Two
//     consumer warpgroups, each thread an 8 × 8 register tile (rows
//     {ty·4..+3, 64 + ty·4..+3}, columns {tx·4..+3, 64 + tx·4..+3}), run
//     the k-loop from shared memory with LDS.128 and FFMA and no
//     __syncthreads; each warp hands a stage back with one arrival. Each G
//     element is summed in f32 in k order by one thread. BK = 32, 4 stages
//     of 32 KiB. Measured on an H100 (PERF.md): the FFMA launch runs at
//     about 0.74 of the FP32 peak, 64 FFMA to 4 LDS.128 per k-step per
//     thread; in a sweep of other shapes BK = 16 was 2-3 % slower, the
//     stage count (3, 4, 6) moved it by under 1 %, and one consumer
//     warpgroup (one warp per scheduler, 16 × 8 tiles) took twice as long.
//
// bfloat16 / bfloat16_3x:
//  1. gram_prep_kernel rounds x̃ to bf16 (nearest even) as hi and, for
//     bfloat16_3x, lo = bf16(x̃ − hi), written transposed as x̃ᵀ (n × kp,
//     K-major), the layout TMA and wgmma read best: 64 × 64 tiles of X
//     through shared memory, read along X's rows, written as bf16 pairs.
//  2. gram_tc_kernel: 128-byte-swizzled 128 × 64 bf16 panels (A = rows
//     i0.., B = rows j0.. of x̃ᵀ; for bfloat16_3x also their lo panels);
//     warpgroups 0 and 1 each own 64 rows of the tile and run
//     wgmma.m64n128k16 with both operands from shared memory into f32
//     registers, keeping one k-block of wgmma in flight while they release
//     the stage before it. bfloat16_3x issues hi·hi into one accumulator
//     and hi·lo + lo·hi into a second (lo·lo dropped, as the TPU kernel
//     did); the small cross terms are summed apart from the large ones and
//     added once at the end. Stages: 6 of 32 KiB (bfloat16) or 3 of 64 KiB
//     (bfloat16_3x), 192 KiB either way, one block per SM. Each tile reads
//     its two panels over all k, so L2 serves 2.2 GB (hi) or 4.4 GB
//     (hi + lo) per bucket, 16× or 33× the scratch. Measured on an H100
//     (PERF.md): both modes read panels through L2 at about 8 TB/s while
//     bfloat16_3x does three times the products per byte, so the panel
//     feed, not the tensor cores, bounds the one-pass mode.
//
// Deep inputs: each G element is one f32 chain in k order, whose error grows
// with its length (on an H100 at 262,144 rows the tensor-core modes were
// 1.3e-3 of max |G| from float64, against about 2e-5 at 8192 rows, and the
// FFMA chain drifts too). So no chain runs past FOLD_ROWS rows: every
// FOLD_ROWS rows of depth each consumer thread adds its 64 running sums
// into its own slots of a fold workspace the caller allocates (the first
// fold writes them), restarts its accumulators, and adds the slots back
// before the epilogue; slot e of thread t of block b is fold[(b·64 + e)·256
// + t], so a warp's accesses are coalesced and every address is one base
// plus a constant. An input of at most FOLD_ROWS rows never folds, needs
// no workspace and gets the unfolded sums bit for bit.
//
// Few upper tiles (T(T+1)/2 below the SM count, so n ≤ 1920 on an H100) and
// more than one fold: one block per upper tile would leave most SMs idle and
// walk the whole depth alone (one block for 2,097,152 rows at n = 28). Since
// every G element is one fmaf chain per fold, restarted at 0 every FOLD_ROWS
// rows counted from row 0, and the folds are summed left to right, a fold's
// partial sums do not depend on which block computes them. So the caller may
// split the rows into `runs` runs of whole folds (the second grid dimension):
//  * Split launch (every precision; the kRuns instantiation of each Gram
//    kernel, so the whole-depth one compiles as it did without runs: on an
//    H100 a single kernel for both was 10 % slower at the bf16x3 bucket):
//    block (tile, run) walks only its run's
//    folds, from the run's first row, and stores each fold's partial sums in
//    that (fold, tile)'s slots of the workspace (the same coalesced slot layout
//    as the whole-depth folds), with no epilogue. Then gram_fold_reduce_kernel
//    sums, for each element, folds 0..F−1 left to right in f32 (slot = f0,
//    then slot + f_i, as the whole-depth kernel does in place) and writes it
//    and its mirror with store_tile's rules. The result is the whole-depth
//    launch's, bit for bit.
//  * Narrow launch (highest, n ≤ NW_EDGE): gram_narrow_f32_kernel has no prep
//    pass and no scratch: one block per run reads its rows of X directly, so X
//    is read once (the prep pass reads and writes it once more and the Gram
//    reads the scratch again: 3× the bytes at 28 wide). It copies 64-row
//    chunks of X into a ring of shared memory with cp.async, three chunks in
//    flight while one is multiplied (16-byte copies where the prep pass's
//    `vec` test holds), forms x̃ = (x − mean)·rowmul in place in f32,
//    subtract then multiply, as the prep pass does, and runs
//    fmaf(x̃[k][i], x̃[k][j], acc) in k order for i ≤ j only: each compute
//    thread owns a 4 × 2 block of the upper triangle of the ⌈n/4⌉ × ⌈n/2⌉
//    block grid (56 threads at n = 28, where a 128 × 128 tile computed 21×
//    the products), over the 64 rows of every chunk; rows past `rows` are
//    zeros, as the prep pass writes them, and fmaf(0, 0, s) leaves a sum
//    unchanged (a sum that starts at +0 is never −0), so the bits are the
//    128-tile launch's. Its fold partials go to a workspace of its own layout
//    and the same reduce launch finishes the job. What bounds it: each fold
//    is 8192 dependent fmaf steps per element, and a fold's few warps (2 at
//    n = 28) leave the shared-memory latency of each step exposed, so it
//    runs near the latency of its folds, not near the bytes of X. Of the
//    shapes scripts/torch_narrow_variants.py times on an H100 (PERF.md), no
//    other thread block (2 × 4, 2 × 2, 1 × 4, 4 × 4), chunk depth or unroll
//    was faster at both 28 and 64 wide on 2,097,152 rows.
//
// A wait on a pipeline barrier that outlasts 2 s traps (hopper_ptx.cuh), so a
// broken protocol fails the launch instead of hanging the card. A run that
// starts mid-scratch starts its ring at phase 0 like any block, and its
// producer and consumers walk the same k-blocks, so the trap sees the same
// protocol.

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
constexpr int K_PAD = 64;       // the prep pass pads the scratch's depth to a multiple of this
constexpr int EPI_LD = BN + 1;  // f32 staging row of the epilogue
constexpr int FOLD_ROWS = 8192; // longest f32 chain, in rows of depth (see the note at the top)

constexpr int PREP_TILE = 64;                  // bf16 prep pass: 64 rows × 64 columns per block
constexpr int F32_PREP_ROWS = 8;               // f32 prep pass: 8 rows × 1024 columns per block,
constexpr int F32_PREP_COLS = 4 * 256;         // 4 columns per thread
constexpr int TC_BK = 64;                      // k-block: 64 bf16 = 128 bytes, one swizzle row
constexpr int TC_PANEL_BYTES = BN * TC_BK * 2; // one 128 × 64 bf16 panel, 16 KiB
constexpr int TC_CONSUMERS = 2;                // warpgroups running wgmma, 64 tile rows each
constexpr int TC_THREADS = 128 * (TC_CONSUMERS + 1);
constexpr int TC_FOLD_KB = FOLD_ROWS / TC_BK;  // k-blocks between folds

constexpr int FF_BK = 32;                            // FFMA pipeline: k-block of scratch rows,
constexpr int FF_STAGES = 4;                         // ring stages,
constexpr int FF_CONSUMERS = 256;                    // threads computing the tile (8 × 8 each)
constexpr int FF_THREADS = FF_CONSUMERS + 128;       // and the producer warpgroup
constexpr int FF_PANEL_BYTES = FF_BK * BN * 4;       // k-block × 128 columns of x̃, f32
constexpr int FF_STAGE_BYTES = 2 * FF_PANEL_BYTES;   // A and B panels
constexpr int FF_RING_BYTES = FF_STAGES * FF_STAGE_BYTES;
// 128 bytes to align the ring for TMA, the ring (which then holds the
// epilogue's staged tile), then a full and an empty barrier per stage
constexpr int FF_SMEM_BYTES = 128 + FF_RING_BYTES + 2 * FF_STAGES * 8;
constexpr int FF_FOLD_KB = FOLD_ROWS / FF_BK;         // k-blocks between folds
static_assert(K_PAD % FF_BK == 0, "the scratch depth must be whole k-blocks");
static_assert(FOLD_ROWS % FF_BK == 0 && FOLD_ROWS % TC_BK == 0, "folds fall between k-blocks");
static_assert(FF_RING_BYTES >= BN * EPI_LD * 4, "epilogue staging must fit in the ring");
static_assert(FF_SMEM_BYTES <= 232448, "shared memory of one block");
static_assert(FF_CONSUMERS == 256 && TC_CONSUMERS * 128 == 256, "fold slots per block");

constexpr int NW_EDGE = 64;   // narrow route: n ≤ this
constexpr int NW_TR = 4;      // a compute thread's block of the triangle: NW_TR rows
constexpr int NW_TC = 2;      // × NW_TC columns
constexpr int NW_ROWS = 64;   // rows of X in a chunk
constexpr int NW_STAGES = 4;  // chunks in the ring: 3 in flight while one multiplies
constexpr int NW_UNROLL = 16;  // rows of the k-loop unrolled
constexpr int NW_SLOTS = NW_TR * NW_TC;  // sums per compute thread

// Compute threads of the narrow kernel at width n: the upper-triangle blocks
// of the ⌈n/NW_TR⌉ × ⌈n/NW_TC⌉ block grid (row block b holds the column
// blocks bj ≥ ⌊NW_TR·b / NW_TC⌋, those with NW_TC·bj + NW_TC − 1 ≥ NW_TR·b).
constexpr int narrow_threads(int n) {
  int p = 0;
  for (int b = 0; b < (n + NW_TR - 1) / NW_TR; ++b) p += (n + NW_TC - 1) / NW_TC - NW_TR * b / NW_TC;
  return p;
}
constexpr int NW_THREADS = (narrow_threads(NW_EDGE) + 31) / 32 * 32;  // 288: 272 compute at n = 64
constexpr int NW_LOADS = (NW_ROWS * NW_EDGE / 4 + NW_THREADS - 1) / NW_THREADS;  // float4s a thread
static_assert(FOLD_ROWS % NW_ROWS == 0, "a chunk never straddles a fold");

// Slot layouts of the fold workspace, by the kernel that writes it
constexpr int kLayoutFfma = 0;
constexpr int kLayoutTc = 1;
constexpr int kLayoutNarrow = 2;

template <bool kSplit>
struct TcConfig {
  static constexpr int kPlanes = kSplit ? 2 : 1;                  // hi (+ lo)
  static constexpr int kStageBytes = 2 * kPlanes * TC_PANEL_BYTES;  // A and B panels
  static constexpr int kStages = kSplit ? 3 : 6;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // 1024 bytes to align the ring for the swizzle, then the ring, then a full
  // and an empty barrier per stage
  static constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
  static_assert(kRingBytes >= BN * EPI_LD * 4, "epilogue staging must fit in the ring");
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

// This consumer thread's first slot in slot set `set` (see the note at the
// top); its slot e is FOLD_SLOTS·e further on. A whole-depth launch keeps one
// set per block (blockIdx.x), a split launch one per (fold, upper tile):
// fold · tiles + tile.
constexpr int FOLD_SLOTS = 256;  // consumer threads per block, both pipelines
__device__ __forceinline__ float* fold_slots(float* fold, long long set, int consumer) {
  return fold + set * 64 * FOLD_SLOTS + consumer;
}

// The k-blocks [kb0, kb1) of this block's run: all nk of them in a
// whole-depth launch (one run), else run blockIdx.y's share of whole folds.
__device__ __forceinline__ void run_kblocks(int nk, int fold_kb, int& kb0, int& kb1) {
  const long long folds = (nk + fold_kb - 1) / fold_kb;
  kb0 = static_cast<int>(blockIdx.y * folds / gridDim.y) * fold_kb;
  kb1 = min(nk, static_cast<int>((blockIdx.y + 1) * folds / gridDim.y) * fold_kb);
}

// Where slot e of consumer thread t of a 128 × 128 tile's block keeps its
// sum: the element (r, c) of the tile, as each pipeline's epilogue stages it.
template <int kLayout>
__device__ __forceinline__ void tile_slot_element(int t, int e, int& r, int& c) {
  if constexpr (kLayout == kLayoutFfma) {
    const int tx = t % 16, ty = t / 16, u = e / 8, v = e % 8;
    r = (u / 4) * 64 + ty * 4 + u % 4;
    c = (v / 4) * 64 + tx * 4 + v % 4;
  } else {
    const int wg = t / 128, tt = t % 128;
    r = wg * 64 + 16 * (tt / 32) + (tt % 32) / 4 + 8 * ((e / 2) % 2);
    c = 8 * (e / 4) + 2 * (tt % 4) + e % 2;
  }
}

// The narrow route's compute thread p: the NW_TR × NW_TC block (bi, bj) of
// the upper triangle of the block grid (rows NW_TR·bi.., columns NW_TC·bj..;
// see narrow_threads), enumerated row by row; false past the last block.
__device__ __forceinline__ bool narrow_block(int p, int n, int& bi, int& bj) {
  const int rb = (n + NW_TR - 1) / NW_TR, cb = (n + NW_TC - 1) / NW_TC;
  for (int b = 0; b < rb; ++b) {
    const int first = NW_TR * b / NW_TC, count = cb - first;
    if (p < count) {
      bi = b;
      bj = first + p;
      return true;
    }
    p -= count;
  }
  return false;
}

// NW floats of shared memory at p (p aligned to NW floats) into v.
template <int NW>
__device__ __forceinline__ void load_floats(const float* p, float (&v)[NW]) {
  if constexpr (NW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (NW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// (x − mean[col]) · rowmul[row], 0 outside [0, rows) × [0, n).
__device__ __forceinline__ float centered(const float* __restrict__ x, long long ldx,
                                          const float* __restrict__ mean,
                                          const float* __restrict__ rowmul, int row, int col,
                                          int rows, int n) {
  if (row >= rows || col >= n) return 0.0f;
  return (x[static_cast<long long>(row) * ldx + col] - mean[col]) * rowmul[row];
}

// Epilogue: write the staged 128 × 128 tile (rows EPI_LD floats apart) at
// (i0, j0) of G and its mirror at (j0, i0), `threads` threads with index
// `tid` storing along G's rows; on a diagonal tile the elements with
// row ≤ col and their mirrors.
__device__ __forceinline__ void store_tile(const float* tile, float* __restrict__ g, int n, int i0,
                                           int j0, int tid, int threads) {
  if (i0 == j0) {
    for (int e = tid; e < BN * BN; e += threads) {
      const int r = e / BN, c = e % BN, gi = i0 + r, gj = i0 + c;
      if (gi < n && gj < n) {
        g[static_cast<long long>(gi) * n + gj] =
            r <= c ? tile[r * EPI_LD + c] : tile[c * EPI_LD + r];
      }
    }
    return;
  }
  for (int e = tid; e < BN * BN; e += threads) {
    const int r = e / BN, c = e % BN, gi = i0 + r, gj = j0 + c;
    if (gi < n && gj < n) g[static_cast<long long>(gi) * n + gj] = tile[r * EPI_LD + c];
  }
  for (int e = tid; e < BN * BN; e += threads) {
    const int c = e / BN, r = e % BN, gi = i0 + r, gj = j0 + c;
    if (gi < n && gj < n) g[static_cast<long long>(gj) * n + gi] = tile[r * EPI_LD + c];
  }
}

// Prep pass for highest: block (bx, by) writes rows bx·8.. × columns
// by·1024.. of the f32 scratch xs (kp × n4, row-major), 4 columns a thread
// as one float4 store. X is read as float4 where it is 16-byte aligned with
// a row stride of whole float4s (`vec`), else one float at a time. Rows in
// [rows, kp) and columns in [n, n4) write 0.
__global__ void __launch_bounds__(256)
gram_prep_f32_kernel(const float* __restrict__ x, long long ldx, const float* __restrict__ mean,
                     const float* __restrict__ rowmul, float* __restrict__ xs, int rows, int n,
                     int n4, bool vec) {
  const int c = blockIdx.y * F32_PREP_COLS + 4 * threadIdx.x;
  if (c >= n4) return;
  float m[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = c + q < n ? mean[c + q] : 0.0f;
#pragma unroll
  for (int rr = 0; rr < F32_PREP_ROWS; ++rr) {
    const int r = blockIdx.x * F32_PREP_ROWS + rr;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (r < rows) {
      const float* xr = x + static_cast<long long>(r) * ldx + c;
      const float s = rowmul[r];
      if (vec && c + 4 <= n) {
        const float4 t = *reinterpret_cast<const float4*>(xr);
        v[0] = (t.x - m[0]) * s;
        v[1] = (t.y - m[1]) * s;
        v[2] = (t.z - m[2]) * s;
        v[3] = (t.w - m[3]) * s;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < n) v[q] = (xr[q] - m[q]) * s;
        }
      }
    }
    *reinterpret_cast<float4*>(xs + static_cast<long long>(r) * n4 + c) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Full-f32 Gram over the upper tiles of the prep pass's scratch (kp × n4,
// f32), read through `map`: over the whole depth, or with kRuns over
// blockIdx.y's run of whole folds (a split launch). See the note at the top.
template <bool kRuns>
__global__ void __launch_bounds__(FF_THREADS, 1)
gram_ffma_kernel(const __grid_constant__ CUtensorMap map, float* __restrict__ g,
                 float* __restrict__ fold, int n, int kp, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  uint8_t* smem = smem_raw + ((128 - raw % 128) % 128);
  const uint32_t ring = hopper::smem_addr(smem);
  const uint32_t full0 = ring + FF_RING_BYTES;  // full barrier of stage s at full0 + 8 s
  const uint32_t empty0 = full0 + 8 * FF_STAGES;

  int ti, tj;
  upper_tile(blockIdx.x, tiles, ti, tj);
  const int i0 = ti * BN, j0 = tj * BN, nk = kp / FF_BK;
  int kb0 = 0, kb1 = nk;
  if constexpr (kRuns) run_kblocks(nk, FF_FOLD_KB, kb0, kb1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < FF_STAGES; ++s) {
      hopper::mbar_init(full0 + 8 * s, 1);                  // the producer's expect_tx
      hopper::mbar_init(empty0 + 8 * s, FF_CONSUMERS / 32);  // one per consumer warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= FF_CONSUMERS) {
    // producer warpgroup: one thread keeps the ring full
    hopper::regs_dealloc<40>();
    if (threadIdx.x == FF_CONSUMERS) {
      hopper::prefetch_tensor_map(&map);
      int s = 0;
      uint32_t phase = 0;
      for (int kb = kb0; kb < kb1; ++kb) {
        hopper::mbar_wait(empty0 + 8 * s, phase ^ 1);  // first round passes at once
        const uint32_t full = full0 + 8 * s, st = ring + s * FF_STAGE_BYTES;
        const int k = kb * FF_BK;
        hopper::mbar_arrive_expect_tx(full, FF_STAGE_BYTES);
        hopper::tma_load_2d(st, &map, i0, k, full);
        hopper::tma_load_2d(st + FF_PANEL_BYTES, &map, j0, k, full);
        if (++s == FF_STAGES) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: thread (tx, ty) owns rows ty·4 .. +3, 64 + ty·4 .. +3 and
  // columns tx·4 .. +3, 64 + tx·4 .. +3 of the tile
  hopper::regs_alloc<232>();
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.0f;

  const float* ring_f = reinterpret_cast<const float*>(smem);
  int s = 0;
  uint32_t phase = 0;
  // the k-loop in segments of FF_FOLD_KB k-blocks, folding between them, so
  // the hot loop is the unfolded one
  for (int k0 = kb0; k0 < kb1; k0 += FF_FOLD_KB) {
    const int k1 = min(kb1, k0 + FF_FOLD_KB);
    for (int kb = k0; kb < k1; ++kb) {
      hopper::mbar_wait(full0 + 8 * s, phase);
      const float* a = ring_f + s * (FF_STAGE_BYTES / 4);
      const float* b = a + FF_BK * BN;
#pragma unroll
      for (int k = 0; k < FF_BK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + k * BN + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(a + k * BN + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(b + k * BN + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(b + k * BN + 64 + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
      // this warp has read the stage: hand it back
      __syncwarp();
      if (tid % 32 == 0) hopper::mbar_arrive(empty0 + 8 * s);
      if (++s == FF_STAGES) {
        s = 0;
        phase ^= 1;
      }
    }
    if constexpr (kRuns) {
      // this fold's partial sums, into its own slots
      float* slots = fold_slots(
          fold, static_cast<long long>(k0 / FF_FOLD_KB) * gridDim.x + blockIdx.x, tid);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          slots[(8 * u + v) * FOLD_SLOTS] = acc[u][v];
          acc[u][v] = 0.0f;
        }
    } else if (k1 < nk) {
      float* slots = fold_slots(fold, blockIdx.x, tid);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          float* slot = slots + (8 * u + v) * FOLD_SLOTS;
          *slot = k0 == 0 ? acc[u][v] : *slot + acc[u][v];
          acc[u][v] = 0.0f;
        }
    }
  }
  if constexpr (kRuns) return;  // gram_fold_reduce_kernel sums the folds
  if (nk > FF_FOLD_KB) {
    const float* slots = fold_slots(fold, blockIdx.x, tid);
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int v = 0; v < 8; ++v) acc[u][v] = slots[(8 * u + v) * FOLD_SLOTS] + acc[u][v];
  }

  // Epilogue. Every load has landed; once every consumer has finished
  // reading the ring it is free for the f32 tile.
  hopper::named_barrier_sync(1, FF_CONSUMERS);
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int r = (u / 4) * 64 + ty * 4 + u % 4;
#pragma unroll
    for (int v = 0; v < 8; ++v) tile[r * EPI_LD + (v / 4) * 64 + tx * 4 + v % 4] = acc[u][v];
  }
  hopper::named_barrier_sync(1, FF_CONSUMERS);
  store_tile(tile, g, n, i0, j0, tid, FF_CONSUMERS);
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
template <bool kSplit, bool kRuns>
__global__ void __launch_bounds__(TC_THREADS, 1)
gram_tc_kernel(const __grid_constant__ CUtensorMap map_hi,
               const __grid_constant__ CUtensorMap map_lo, float* __restrict__ g,
               float* __restrict__ fold, int n, int kp, int tiles) {
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
  int kb0 = 0, kb1 = nk;
  if constexpr (kRuns) run_kblocks(nk, TC_FOLD_KB, kb0, kb1);

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
      for (int kb = kb0; kb < kb1; ++kb) {
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
    // the k-loop in segments of TC_FOLD_KB k-blocks, folding between them, so
    // the hot loop is the unfolded one
    for (int k0 = kb0; k0 < kb1; k0 += TC_FOLD_KB) {
      const int k1 = min(kb1, k0 + TC_FOLD_KB);
      for (int kb = k0; kb < k1; ++kb) {
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
        if (kb > kb0 && threadIdx.x % 128 == 0) hopper::mbar_arrive(empty0 + 8 * prev);
        prev = s;
        if (++s == Cfg::kStages) {
          s = 0;
          phase ^= 1;
        }
      }
      if (kRuns || k1 < nk) {
        // the accumulators are read only once every issued wgmma is done
        hopper::wgmma_wait<0>();
        hopper::fence_operands(acc);
        if constexpr (kSplit) hopper::fence_operands(cross);
        // a split launch stores each fold's partial sums in their own slots
        float* slots = fold_slots(
            fold,
            kRuns ? static_cast<long long>(k0 / TC_FOLD_KB) * gridDim.x + blockIdx.x
                  : static_cast<long long>(blockIdx.x),
            threadIdx.x);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          float v = acc[i];
          if constexpr (kSplit) {
            v += cross[i];
            cross[i] = 0.0f;
          }
          float* slot = slots + i * FOLD_SLOTS;
          *slot = kRuns ? v : k0 == 0 ? v : *slot + v;
          acc[i] = 0.0f;
        }
      }
    }
    if constexpr (kRuns) return;  // gram_fold_reduce_kernel sums the folds
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    if constexpr (kSplit) {
      hopper::fence_operands(cross);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += cross[i];
    }
    if (nk > TC_FOLD_KB) {
      const float* slots = fold_slots(fold, blockIdx.x, threadIdx.x);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = slots[i * FOLD_SLOTS] + acc[i];
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
          tile[(row + 8 * h) * EPI_LD + 8 * j + col + b] = acc[4 * j + 2 * h + b];
    hopper::named_barrier_sync(1, TC_CONSUMERS * 128);
    store_tile(tile, g, n, i0, j0, threadIdx.x, TC_CONSUMERS * 128);
  }
}

// The float4s a thread of the narrow kernel copies and centres, the same in
// every chunk: float4 q is chunk row lr, columns lc..+3 with (lr, lc) =
// (e / quads, 4·(e % quads)), e = tid + q·NW_THREADS, stepped from q = 0
// without a division (NW_THREADS = step_r·quads + step_c / 4).
struct NarrowStage {
  int lr0, lc0, step_r, step_c, ld;
  __device__ __forceinline__ void next(int& lr, int& lc) const {
    lr += step_r;
    lc += step_c;
    if (lc >= ld) {
      lc -= ld;
      ++lr;
    }
  }
};

// Starts the copies of X's rows [r0, min(r0 + NW_ROWS, r1)) into a ring stage
// (`stage`: rows `ld` floats apart; `mul`: their rowmul) and commits them as
// one group (an empty one past r1). Columns past n land as zeros: one 16-byte
// copy a float4 where X's rows are whole float4s (`vec`), else four 4-byte
// ones.
__device__ __forceinline__ void narrow_issue(const float* __restrict__ x, long long ldx,
                                             const float* __restrict__ rowmul, int n, bool vec,
                                             int r0, int r1, const NarrowStage& st,
                                             uint32_t stage, uint32_t mul) {
  int lr = st.lr0, lc = st.lc0;
#pragma unroll
  for (int q = 0; q < NW_LOADS; ++q, st.next(lr, lc)) {
    const int r = r0 + lr;
    if (lr >= NW_ROWS || r >= r1) continue;
    const float* xr = x + static_cast<long long>(r) * ldx + lc;
    const uint32_t dst = stage + 4u * (lr * st.ld + lc);
    if (vec) {
      hopper::cp_async_16(dst, xr, 4u * static_cast<uint32_t>(min(4, n - lc)));
    } else {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        hopper::cp_async_4(dst + 4u * v, lc + v < n ? xr + v : x, lc + v < n ? 4u : 0u);
      }
    }
  }
  if (threadIdx.x < NW_ROWS && r0 + static_cast<int>(threadIdx.x) < r1) {
    hopper::cp_async_4(mul + 4u * threadIdx.x, rowmul + r0 + threadIdx.x, 4u);
  }
  hopper::cp_async_commit();
}

// Dynamic shared memory of the narrow launch at width n: NW_STAGES stages of
// NW_ROWS rows of ⌈n/4⌉ float4s, and their rowmuls.
int narrow_smem_bytes(int n) { return NW_STAGES * NW_ROWS * ((n + 3) / 4 * 4 + 1) * 4; }

// Narrow full-f32 Gram (highest, n ≤ NW_EDGE), straight from X: block b
// walks run b's whole folds (gridDim.x runs of `folds`) in chunks of NW_ROWS
// rows, NW_STAGES − 1 chunks of copies in flight ahead of the one it
// multiplies, and stores each fold's partial sums, slot e of thread p at
// fold[(f·NW_SLOTS + e)·NW_THREADS + p]. See the note at the top.
__global__ void __launch_bounds__(NW_THREADS)
gram_narrow_f32_kernel(const float* __restrict__ x, long long ldx, const float* __restrict__ mean,
                       const float* __restrict__ rowmul, float* __restrict__ fold, int rows, int n,
                       int folds, bool vec) {
  extern __shared__ __align__(16) float nw_ring[];  // stages, then their rowmuls
  __shared__ float mean_s[NW_EDGE];
  const int tid = threadIdx.x;
  const int quads = (n + 3) / 4, ld = 4 * quads, stage_floats = NW_ROWS * ld;
  const float* mul_s = nw_ring + NW_STAGES * stage_floats;
  const uint32_t ring = hopper::smem_addr(nw_ring);
  const uint32_t mul0 = ring + 4u * NW_STAGES * stage_floats;
  for (int c = tid; c < ld; c += NW_THREADS) mean_s[c] = c < n ? mean[c] : 0.0f;
  const NarrowStage st{tid / quads, 4 * (tid % quads), NW_THREADS / quads,
                       4 * (NW_THREADS % quads), ld};
  int bi = 0, bj = 0;
  const bool computes = narrow_block(tid, n, bi, bj);
  const int i = NW_TR * bi, j = NW_TC * bj;

  // this run's rows: whole folds, so its chunks never straddle a fold
  const int r_begin =
      static_cast<int>(blockIdx.x * static_cast<long long>(folds) / gridDim.x) * FOLD_ROWS;
  const int r_end = min(
      rows,
      static_cast<int>((blockIdx.x + 1) * static_cast<long long>(folds) / gridDim.x) * FOLD_ROWS);
  const int chunks = (r_end - r_begin + NW_ROWS - 1) / NW_ROWS;
  for (int c = 0; c < NW_STAGES - 1; ++c) {
    narrow_issue(x, ldx, rowmul, n, vec, r_begin + c * NW_ROWS, r_end, st,
                 ring + 4u * c * stage_floats, mul0 + 4u * c * NW_ROWS);
  }

  float acc[NW_TR][NW_TC];
#pragma unroll
  for (int u = 0; u < NW_TR; ++u)
#pragma unroll
    for (int v = 0; v < NW_TC; ++v) acc[u][v] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    hopper::cp_async_wait<NW_STAGES - 2>();  // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's have, and chunk c − 1's stage is free
    const int ahead = c + NW_STAGES - 1, s = c % NW_STAGES;
    narrow_issue(x, ldx, rowmul, n, vec, r_begin + ahead * NW_ROWS, r_end, st,
                 ring + 4u * (ahead % NW_STAGES) * stage_floats,
                 mul0 + 4u * (ahead % NW_STAGES) * NW_ROWS);
    float* xs = nw_ring + s * stage_floats;
    const float* ms = mul_s + s * NW_ROWS;
    const int r0 = r_begin + c * NW_ROWS, depth = min(NW_ROWS, r_end - r0);
    int lr = st.lr0, lc = st.lc0;
#pragma unroll
    for (int q = 0; q < NW_LOADS; ++q, st.next(lr, lc)) {
      if (lr < NW_ROWS) {
        // x̃ = (x − mean)·rowmul in place, subtract then multiply, as the
        // prep pass; rows past r_end are zeros, as the prep pass writes them
        float4* p = reinterpret_cast<float4*>(xs + lr * ld + lc);
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (lr < depth) {
          v = *p;
          const float s_r = ms[lr];
          v.x = lc < n ? (v.x - mean_s[lc]) * s_r : 0.0f;
          v.y = lc + 1 < n ? (v.y - mean_s[lc + 1]) * s_r : 0.0f;
          v.z = lc + 2 < n ? (v.z - mean_s[lc + 2]) * s_r : 0.0f;
          v.w = lc + 3 < n ? (v.w - mean_s[lc + 3]) * s_r : 0.0f;
        }
        *p = v;
      }
    }
    __syncthreads();
    if (computes) {
      const float* p = xs;
#pragma unroll NW_UNROLL
      for (int k = 0; k < NW_ROWS; ++k, p += ld) {
        float av[NW_TR], bv[NW_TC];
        load_floats(p + i, av);
        load_floats(p + j, bv);
#pragma unroll
        for (int u = 0; u < NW_TR; ++u)
#pragma unroll
          for (int v = 0; v < NW_TC; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
      }
      if ((r0 + NW_ROWS) % FOLD_ROWS == 0 || c == chunks - 1) {
        // the last chunk of fold r0 / FOLD_ROWS: its partial sums
        float* slots = fold + static_cast<long long>(r0 / FOLD_ROWS) * NW_SLOTS * NW_THREADS + tid;
#pragma unroll
        for (int u = 0; u < NW_TR; ++u)
#pragma unroll
          for (int v = 0; v < NW_TC; ++v) {
            slots[(NW_TC * u + v) * NW_THREADS] = acc[u][v];
            acc[u][v] = 0.0f;
          }
      }
    }
  }
  hopper::cp_async_wait<0>();  // the trailing empty groups
}

// Sums the fold partials of a split or narrow launch and writes G. Block
// (tile, e) takes slot e of every thread of that upper tile's slot sets;
// thread t sums its slot over folds 0..folds−1 left to right in f32 (slot = f0,
// then slot + f_i: the whole-depth kernels' in-place order) and writes the
// element and its mirror, on a diagonal tile only where row ≤ col (store_tile's
// rules). kLayout names the kernel whose slots it reads.
template <int kLayout>
__global__ void __launch_bounds__(kLayout == kLayoutNarrow ? NW_THREADS : FOLD_SLOTS)
gram_fold_reduce_kernel(const float* __restrict__ fold, float* __restrict__ g, int n, int tiles,
                        int folds) {
  constexpr int kSlots = kLayout == kLayoutNarrow ? NW_SLOTS : 64;
  constexpr int kThreads = kLayout == kLayoutNarrow ? NW_THREADS : FOLD_SLOTS;
  const int t = threadIdx.x, e = blockIdx.y;
  int ti = 0, tj = 0, r, c;
  if constexpr (kLayout == kLayoutNarrow) {
    int bi, bj;
    if (!narrow_block(t, n, bi, bj)) return;
    r = NW_TR * bi + e / NW_TC;
    c = NW_TC * bj + e % NW_TC;
  } else {
    upper_tile(blockIdx.x, tiles, ti, tj);
    tile_slot_element<kLayout>(t, e, r, c);
  }
  if (ti == tj && r > c) return;
  const int gi = ti * BN + r, gj = tj * BN + c;
  if (gi >= n || gj >= n) return;
  const long long per_fold = static_cast<long long>(gridDim.x) * kSlots * kThreads;
  const float* s = fold + (static_cast<long long>(blockIdx.x) * kSlots + e) * kThreads + t;
  float sum = s[0];
#pragma unroll 8
  for (int f = 1; f < folds; ++f) sum = sum + s[f * per_fold];
  g[static_cast<long long>(gi) * n + gj] = sum;
  g[static_cast<long long>(gj) * n + gi] = sum;
}

int round4(int n) { return (n + 3) / 4 * 4; }

bool valid_shape(int rows, int n, int kp) {
  return rows >= 0 && n > 0 && kp > 0 && kp % K_PAD == 0 && kp >= rows &&
         (n + PREP_TILE - 1) / PREP_TILE <= 65535;
}

bool valid_prep_args(int rows, int n, int kp, const void* scratch) {
  return scratch != nullptr && valid_shape(rows, n, kp);
}

bool vec4(const float* x, long long ldx) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && ldx % 4 == 0;
}

cudaError_t launch_prep(const float* x, long long ldx, const float* mean, const float* rowmul,
                        void* scratch, int rows, int n, int mode, int kp, cudaStream_t s) {
  if (mode == kModeF32) {
    const int n4 = round4(n);
    const bool vec = vec4(x, ldx);
    const dim3 grid(kp / F32_PREP_ROWS, (n4 + F32_PREP_COLS - 1) / F32_PREP_COLS);
    gram_prep_f32_kernel<<<grid, 256, 0, s>>>(x, ldx, mean, rowmul, static_cast<float*>(scratch),
                                               rows, n, n4, vec);
    return cudaGetLastError();
  }
  __nv_bfloat16* hi = static_cast<__nv_bfloat16*>(scratch);
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
cudaError_t launch_tc(const __nv_bfloat16* hi, float* g, float* fold, int n, int kp, int tiles,
                      dim3 grid, cudaStream_t s) {
  CUtensorMap map_hi, map_lo;
  if (!encode_plane(&map_hi, hi, n, kp)) return cudaErrorInvalidValue;
  if (!encode_plane(&map_lo, kSplit ? hi + static_cast<long long>(n) * kp : hi, n, kp)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = TcConfig<kSplit>::kSmemBytes;
  const auto kernel = grid.y > 1 ? gram_tc_kernel<kSplit, true> : gram_tc_kernel<kSplit, false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, TC_THREADS, smem, s>>>(map_hi, map_lo, g, fold, n, kp, tiles);
  return cudaGetLastError();
}

// The FFMA Gram over the f32 scratch (kp × n4): unswizzled 128 × BK boxes,
// columns past n4 read as 0.
cudaError_t launch_ffma(const float* xs, float* g, float* fold, int n, int kp, int tiles,
                        dim3 grid, cudaStream_t s) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(round4(n)), static_cast<cuuint64_t>(kp)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(round4(n)) * 4};
  const cuuint32_t box[2] = {BN, FF_BK};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUtensorMap map;
  if (cuTensorMapEncodeTiled(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(xs),
                             dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return cudaErrorInvalidValue;
  }
  const auto kernel = grid.y > 1 ? gram_ffma_kernel<true> : gram_ffma_kernel<false>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FF_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, FF_THREADS, FF_SMEM_BYTES, s>>>(map, g, fold, n, kp, tiles);
  return cudaGetLastError();
}

// The reduce launch of a split or narrow Gram: one block per (upper tile,
// slot).
template <int kLayout>
cudaError_t launch_reduce(const float* fold, float* g, int n, int tiles, int folds,
                          cudaStream_t s) {
  constexpr bool narrow = kLayout == kLayoutNarrow;
  const unsigned blocks = static_cast<unsigned>(tiles) * (tiles + 1) / 2;
  gram_fold_reduce_kernel<kLayout><<<dim3(blocks, narrow ? NW_SLOTS : 64),
                                     narrow ? NW_THREADS : FOLD_SLOTS, 0, s>>>(fold, g, n, tiles,
                                                                             folds);
  return cudaGetLastError();
}

long long fold_count(int kp) { return (static_cast<long long>(kp) + FOLD_ROWS - 1) / FOLD_ROWS; }

}  // namespace

// C entry points for ctypes. Pointers are device pointers; `stream` is a
// cudaStream_t. Each launches on `stream` without synchronising and returns
// the cudaError_t of its launches (0 on success).

// The prep pass alone, into `scratch`: for mode 0 x̃ as f32 (kp × n4,
// n4 = n rounded up to 4); for modes 1 and 2 x̃ᵀ's hi plane, and for mode 2
// the lo plane after it, as bf16 (planes × n × kp).
extern "C" int tpuml_gram_prep(const void* x, long long ldx, const void* mean, const void* rowmul,
                               void* scratch, int rows, int n, int mode, int kp, void* stream) {
  if (ldx < n || mode < kModeF32 || mode > kModeBf16x3 ||
      !valid_prep_args(rows, n, kp, scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_prep(
      static_cast<const float*>(x), ldx, static_cast<const float*>(mean),
      static_cast<const float*>(rowmul), scratch, rows, n, mode, kp,
      static_cast<cudaStream_t>(stream)));
}

// The whole Gram, in `runs` runs of whole folds of FOLD_ROWS rows (see the
// note at the top); the caller chooses the route and the run count.
//  * narrow = 0, runs = 1: the prep pass into `scratch` (as tpuml_gram_prep),
//    then the FFMA (mode 0) or tensor-core (modes 1, 2) launch that reads it,
//    one block per upper tile over the whole depth.
//  * narrow = 0, runs > 1 (at most the fold count): the same, with the rows
//    split across blocks, then the reduce launch.
//  * narrow = 1 (mode 0, n ≤ 64): the narrow launch on X itself, `runs`
//    blocks, then the reduce launch; `scratch` is not read and may be null.
// `fold` is the fold workspace, tpuml_gram_fold_floats(n, folds, runs, narrow)
// floats; a whole-depth launch of at most FOLD_ROWS rows does not read it and
// it may be null.
extern "C" int tpuml_fused_centered_gram(const void* x, long long ldx, const void* mean,
                                         const void* rowmul, void* g, int rows, int n, int mode,
                                         void* scratch, int kp, void* fold, int runs, int narrow,
                                         void* stream) {
  const long long folds = kp > 0 ? fold_count(kp) : 0;
  if (ldx < n || mode < kModeF32 || mode > kModeBf16x3 || !valid_shape(rows, n, kp) ||
      runs < 1 || runs > folds || (!narrow && (scratch == nullptr || runs > 65535)) ||
      ((kp > FOLD_ROWS || runs > 1 || narrow) && fold == nullptr) ||
      (narrow && (mode != kModeF32 || n > NW_EDGE || rows < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(n) + BN - 1) / BN;
  const long long blocks = tiles * (tiles + 1) / 2;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  float* ff = static_cast<float*>(fold);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gf = static_cast<float*>(g);
  const int t = static_cast<int>(tiles), f = static_cast<int>(folds);
  cudaError_t err;
  if (narrow) {
    const int smem = narrow_smem_bytes(n);
    err = cudaFuncSetAttribute(gram_narrow_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gram_narrow_f32_kernel<<<runs, NW_THREADS, smem, s>>>(
        xf, ldx, static_cast<const float*>(mean), static_cast<const float*>(rowmul), ff, rows, n,
        f, vec4(xf, ldx));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(launch_reduce<kLayoutNarrow>(ff, gf, n, 1, f, s));
  }
  err = launch_prep(xf, ldx, static_cast<const float*>(mean), static_cast<const float*>(rowmul),
                    scratch, rows, n, mode, kp, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(runs));
  if (mode == kModeF32) {
    err = launch_ffma(static_cast<const float*>(scratch), gf, ff, n, kp, t, grid, s);
  } else {
    const __nv_bfloat16* hi = static_cast<const __nv_bfloat16*>(scratch);
    err = mode == kModeBf16x3 ? launch_tc<true>(hi, gf, ff, n, kp, t, grid, s)
                              : launch_tc<false>(hi, gf, ff, n, kp, t, grid, s);
  }
  if (err != cudaSuccess || runs == 1) return static_cast<int>(err);
  return static_cast<int>(mode == kModeF32 ? launch_reduce<kLayoutFfma>(ff, gf, n, t, f, s)
                                           : launch_reduce<kLayoutTc>(ff, gf, n, t, f, s));
}

// Floats of the fold workspace of an n-wide Gram of `folds` folds in `runs`
// runs: a whole-depth launch (runs = 1) 64 slots for each of the 256 consumer
// threads of each upper tile's block, summed in place; a split launch those
// for each (fold, upper tile); a narrow launch NW_SLOTS slots for each of its
// NW_THREADS threads for each fold.
extern "C" long long tpuml_gram_fold_floats(int n, int folds, int runs, int narrow) {
  const long long tiles = (static_cast<long long>(n) + BN - 1) / BN;
  if (narrow) return static_cast<long long>(folds) * NW_SLOTS * NW_THREADS;
  return (runs > 1 ? folds : 1) * tiles * (tiles + 1) / 2 * 64 * FOLD_SLOTS;
}

// Dynamic shared memory of a mode's Gram launch.
extern "C" int tpuml_gram_dynamic_smem(int mode) {
  if (mode == kModeF32) return FF_SMEM_BYTES;
  if (mode == kModeBf16) return TcConfig<false>::kSmemBytes;
  if (mode == kModeBf16x3) return TcConfig<true>::kSmemBytes;
  return 0;
}

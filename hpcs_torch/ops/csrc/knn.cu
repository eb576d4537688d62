// Kernel B1: the k nearest neighbours of every point of a batch of clouds.
//
// Replaces hpcs_tpu/ops/pallas/knn_pallas.py::_knn_kernel.  For x [B, N, D]
// fp32 (or bf16, below) it writes idx [B, N, k] int32: nearest first, the point itself
// included, ties broken toward the smallest index.  The ranking score of
// column j for row i is 2 x_i.x_j - |x_j|^2, x_i.x_j and |x_j|^2 each one
// chain of fp32 FMAs in dimension order on the CUDA cores (never TF32), so
// the N x N score matrix never reaches device memory.
//
// What bounds it on an H100: the score FMAs, 2 B N^2 D operations (2.1
// GFLOP at B=16, N=1024, D=63) against 67 TFLOP/s of fp32, plus one compare
// per score to select; it reads only B N D values.  At D = 3 the scores cost
// little and the selection is the work.
//
// Two launches.  knn_prep_kernel reads x once (bf16 converted to fp32 on
// load: exact, so the bf16 route is the fp32 route on x.float() bit for bit)
// into a scratch copy xp [B, N, dx], each row zero-padded to dx, a multiple
// of the staged depth DC, so that every 16 bytes of it are aligned, and
// |x_j|^2 [B, N] once per point.  knn_kernel then runs one block per (cloud,
// tile of TR rows), of a Tile chosen by shared memory (plan_of):
//
// * Scores.  The row tile sits in shared memory as [TR][dx] (row-major, as
//   xp).  The cloud streams through in tiles of TC columns, each cut into
//   slices of DC dimensions that cp.async brings into a ring of STAGES
//   [TC][DC] buffers, the next STAGES - 1 slices in flight while the FMAs
//   run on this one.  Each thread holds a 4 x 8 register tile (rows
//   rt + RT i, columns ct + CT j); per 4 dimensions it loads 4 + 8 float4s
//   (the lanes of a warp form an RTW x CTW grid, so the row loads are
//   broadcasts) for 128 FMAs.  Padded strides keep every float4 load free
//   of bank conflicts.  A tile's scores go to shared memory, [TR][N] for the
//   block's rows.  At D > 4 and N <= 1024 a block is 8 warps over 32 rows,
//   so the cloud is read from L2 once per 32 rows.  At D <= 4 a column is
//   one float4 of xp: each thread loads its 8 columns from L2 into
//   registers a tile ahead, and there is no ring.
// * Selection, one warp per row (a warp takes RTW rows at once, so that
//   their loads and shuffles overlap), in three steps whose work does not
//   depend on the order of the columns.  (s, i) ranks above (s', i') if
//   s > s', or s == s' and i < i': a total order, so ties go to the smallest
//   index whatever order the columns arrive in, as the TPU kernel's
//   first-argmax does.  NaN scores never rank.
//   1. Lane l's maximum is the best of the columns l, l + 32, ...: the
//      score epilogue keeps each thread's best column (its columns are all
//      congruent mod 32), and lane l combines those of its class.  These 32
//      maxima are distinct columns, so the k-th best of them, T, ranks at or
//      below the row's k-th best: every column of the result ranks at or
//      above T.  A bitonic sort of the 32 maxima across the warp gives T.
//   2. Each lane scans its columns for those at or above T (near k of them
//      on any order of the columns: on a line of points, whose scores rise
//      up to the row's own column, the lane maxima are the 32 nearest),
//      marking them a bit each (no branch and no shuffle per column), then
//      reads them out into four register slots.  Where fewer than k lanes
//      saw a score, T is the empty slot (-inf, INT_MAX) and every non-NaN
//      column goes in.
//   3. The slots are gathered into the row's own (now dead) score row in
//      lane order; the first 32 are sorted across the warp (bitonic) and
//      the rest merged in 32 at a time (a bitonic merge).  A row where a
//      lane holds more than four is selected again by select_rescan, which
//      compacts the columns by ballot and merges them 32 at a time.  Lane
//      q < k then holds the q-th best; a slot no score reached reports -1.
//   tests/test_torch_knn_select.py replays these steps lane by lane.
//
// A launch may cover a range of query rows, ranked against all N points
// (the point-sharded forward's rows of the gathered cloud): the row tiles
// then start at the range's first row, and each score and selection is the
// whole launch's, bit for bit (a score's FMA chain is the same in any tile).
//
// The shapes knn_kernel refuses (k > 32, D > 64 or N > 4096) take the wide
// route below: the same prep, then knn_wide_kernel, row tiles with a
// streamed selection, or, for k > 256, the radix route: the same score
// sweep's keys stored a group of rows at a time, then a radix select a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <algorithm>
#include <atomic>
#include <climits>
#include <cmath>
#include <type_traits>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int PREP_THREADS = 128;  // knn_prep_kernel's block
constexpr int PREP_POINTS = 32;    // and its points
constexpr int MAX_D = 64;
constexpr int MAX_K = 32;
constexpr int MAX_N = 4096;
constexpr int MAX_SMEM = 227 * 1024;   // a block's shared memory on the H100
constexpr int SM_SMEM = 228 * 1024;    // an SM's, of which each block reserves 1 KiB more
constexpr int SM_THREADS = 2048;
constexpr int BUF = 64;                // a row's candidate buffer
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The layout of knn_kernel<Tile<RTW, DC, WR, STAGES>>: a warp's lanes span
// RTW rows and CTW = 32 / RTW columns; the block's warps, WR along the rows
// and 4 along the columns, span TR = 4 RT rows and TC = 8 CT columns (each
// thread 4 x 8: rows rt + RT i, columns ct + CT j); the ring holds STAGES
// slices of DC dimensions at a padded stride S (S / 4 odd: consecutive
// columns' float4s fall in different banks).
template <int RTW_, int DC_, int WR, int STAGES_>
struct Tile {
  static constexpr int RTW = RTW_, DC = DC_, STAGES = STAGES_;
  static constexpr int WARPS = 4 * WR;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int CTW = 32 / RTW;
  static constexpr int RT = WR * RTW;
  static constexpr int CT = 4 * CTW;
  static constexpr int TR = 4 * RT;
  static constexpr int TC = 8 * CT;
  static constexpr int S = (DC / 4) % 2 ? DC : DC + 4;
  static constexpr int CHUNKS = TC * DC / 4 / THREADS;  // 16-byte copies a thread, a slice
  static_assert(TC * DC / 4 % THREADS == 0, "a slice is whole 16-byte copies per thread");
  static_assert(STAGES * TC * S >= 2 * WARPS * RTW * BUF, "the candidate buffers fit the ring");
  static_assert(STAGES * TC * S >= 2 * TR * CT, "the threads' maxima fit the ring");
  static_assert(TC >= 256, "a score row holds 128 gathered candidates and their indices");
  // the row tile's stride (dx / 4 odd) and the score rows' (CTW mod 32: the
  // RTW x CTW lanes of an epilogue store hit 32 banks)
  __host__ __device__ static int sa(int dx) { return (dx / 4) % 2 ? dx : dx + 4; }
  __host__ __device__ static int srow(int n) { return round_up(n, TC) + CTW; }
  __host__ static size_t smem(int n, int dx) {
    return sizeof(float) * ((size_t)TR * srow(n) + (size_t)TR * sa(dx) + STAGES * TC * S);
  }
};

// The instantiations, by plan: D <= 4 (one slice a tile) and D > 4, from
// the largest row tile down (each a fallback for larger N).
using Tile0 = Tile<4, 4, 1, 2>;   // D <= 4: 16 rows, 3 blocks an SM at N = 1024
using Tile1 = Tile<2, 4, 1, 2>;
using Tile2 = Tile<1, 4, 1, 2>;
using Tile3 = Tile<4, 16, 2, 4>;  // D > 4: 32 rows, 8 warps, 4 slices in flight
using Tile4 = Tile<4, 16, 1, 2>;
using Tile5 = Tile<2, 8, 1, 2>;
constexpr int TILES = 6;

template <class F>
auto with_tile(int t, F&& f) {
  switch (t) {
    case 0: return f(Tile0{});
    case 1: return f(Tile1{});
    case 2: return f(Tile2{});
    case 3: return f(Tile3{});
    case 4: return f(Tile4{});
    default: return f(Tile5{});
  }
}

// (s, i) ranks above (s2, i2); bitwise, not short-circuit, so that it
// compiles to predicates and no branch
__device__ __forceinline__ bool above(float s, int i, float s2, int i2) {
  return (s > s2) | ((s == s2) & (i < i2));  // false whenever s is NaN
}

// Sorts one (s, i) per lane across the warp, best first (a bitonic network),
// for R rows at once.
template <int R>
__device__ __forceinline__ void warp_sort(float (&s)[R], int (&i)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2) {
      // blocks of `size` lanes alternate direction; the lower lane of a pair
      // keeps the better in a descending block
      const bool keep_better = ((lane & size) == 0) == ((lane & stride) == 0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float os = __shfl_xor_sync(FULL, s[r], stride);
        const int oi = __shfl_xor_sync(FULL, i[r], stride);
        if (keep_better ? above(os, oi, s[r], i[r]) : above(s[r], i[r], os, oi)) {
          s[r] = os;
          i[r] = oi;
        }
      }
    }
  }
}

// Merges the sorted 32 (cs, ci) into the warp's sorted best 32 (qs, qi).
__device__ __forceinline__ void warp_merge(float& qs, int& qi, float cs, int ci, int lane) {
  const float rs = __shfl_sync(FULL, cs, 31 - lane);  // the chunk reversed: q[l] against
  const int ri = __shfl_sync(FULL, ci, 31 - lane);    // c[31 - l] keeps the best 32, bitonic
  if (above(rs, ri, qs, qi)) {
    qs = rs;
    qi = ri;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride /= 2) {
    const float os = __shfl_xor_sync(FULL, qs, stride);
    const int oi = __shfl_xor_sync(FULL, qi, stride);
    if ((lane & stride) == 0 ? above(os, oi, qs, qi) : above(qs, qi, os, oi)) {
      qs = os;
      qi = oi;
    }
  }
}

struct Best {
  float s;
  int i;
};

// Sorts a chunk of 32 (one a lane) and merges it into the best 32 so far.
// Out of line: one copy of the network serves every row, which keeps the
// selection small in the instruction cache.
__device__ __noinline__ Best merge_chunk(Best q, float cs, int ci, int lane) {
  float s[1] = {cs};
  int i[1] = {ci};
  warp_sort<1>(s, i, lane);
  warp_merge(q.s, q.i, s[0], i[0], lane);
  return q;
}

// The best 32 of a row's columns at or above T = (ts, ti), for a row where a
// lane holds more than four of them: the columns compacted by ballot, 32 at a
// time, into the row's buffer (bs, bi: 64 entries), and merged 32 at a time.
__device__ __noinline__ Best select_rescan(const float* srow, int n, float ts, int ti, float* bs,
                                           int* bi, int lane) {
  const unsigned below_lane = (1u << lane) - 1u;
  Best q{-INFINITY, INT_MAX};
  int count = 0;
  for (int c = lane; c < round_up(n, 32); c += 32) {
    const float v = srow[c];
    const bool cand = (c < n) & ((v > ts) | ((v == ts) & (c <= ti)));
    const unsigned mask = __ballot_sync(FULL, cand);
    if (cand) {
      const int p = count + __popc(mask & below_lane);
      bs[p] = v;
      bi[p] = c;
    }
    count += __popc(mask);
    if (count >= 32) {
      __syncwarp();
      const float cs = bs[lane];
      const int ci = bi[lane];
      const bool carry = lane < count - 32;
      const float xs = carry ? bs[32 + lane] : 0.f;
      const int xi = carry ? bi[32 + lane] : 0;
      __syncwarp();
      if (carry) {
        bs[lane] = xs;
        bi[lane] = xi;
      }
      count -= 32;
      q = merge_chunk(q, cs, ci, lane);
    }
  }
  __syncwarp();
  if (count > 0)
    q = merge_chunk(q, lane < count ? bs[lane] : -INFINITY, lane < count ? bi[lane] : INT_MAX, lane);
  __syncwarp();
  return q;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(valid ? 16 : 0));  // source size 0: zero fill
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// xp [points, dx] (x converted to fp32, zero-padded) and sq [points] = |x_j|^2
// (one FMA chain in dimension order).  A block takes PREP_POINTS points: its
// warps read and write whole rows (coalesced, all loads in flight at once),
// and a thread a point makes |x_j|^2 from shared memory (rows at an odd
// stride: no bank conflicts).
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
knn_prep_kernel(const T* __restrict__ x, float* __restrict__ xp, float* __restrict__ sq,
                int points, int d, int dx) {
  constexpr int PER_WARP = PREP_POINTS / (PREP_THREADS / 32);
  __shared__ float rows[PREP_POINTS * (MAX_D + 1)];
  const int ds = d | 1;
  const int p0 = blockIdx.x * PREP_POINTS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float v[PER_WARP][2];
#pragma unroll
  for (int m = 0; m < PER_WARP; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + warp * PER_WARP + m, q = lane + 32 * h;
      v[m][h] = p < points && q < d ? to_float(x[(size_t)p * d + q]) : 0.f;
    }
#pragma unroll
  for (int m = 0; m < PER_WARP; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (lane + 32 * h < d) rows[(warp * PER_WARP + m) * ds + lane + 32 * h] = v[m][h];
  __syncthreads();
  if (tid < PREP_POINTS && p0 + tid < points) {
    float s = 0.f;
    for (int q = 0; q < d; ++q) s = fmaf(rows[tid * ds + q], rows[tid * ds + q], s);
    sq[p0 + tid] = s;
  }
#pragma unroll
  for (int m = 0; m < PER_WARP; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = p0 + warp * PER_WARP + m, q = lane + 32 * h;
      if (p < points && q < dx) xp[(size_t)p * dx + q] = v[m][h];
    }
}

template <class L>
__global__ void __launch_bounds__(L::THREADS, L::THREADS == 128 ? 3 : 1)
knn_kernel(const float* __restrict__ xp, const float* __restrict__ sq, int* __restrict__ idx,
           int n, int dx, int k, int row_begin, int rows) {
  constexpr int RTW = L::RTW, DC = L::DC, STAGES = L::STAGES;
  extern __shared__ float4 smem4[];
  const int srow = L::srow(n), sa = L::sa(dx);
  float* scores = reinterpret_cast<float*>(smem4);  // [TR][srow]
  float* rowt = scores + L::TR * srow;              // [TR][sa]
  float* ring = rowt + L::TR * sa;  // [STAGES][TC][S] slices (D > 4), then maxima and buffers

  const int b = blockIdx.y;
  const int row0 = row_begin + blockIdx.x * L::TR;
  const int row_end = row_begin + rows;
  const float* xb = xp + (size_t)b * n * dx;
  const float* sqb = sq + (size_t)b * n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp / 4 * RTW + lane / L::CTW;       // rows rt + RT i
  const int ct = warp % 4 * L::CTW + lane % L::CTW;    // columns ct + CT j

  // the row tile (16 floats of a row a copy at most: dx <= 64)
  for (int q = tid; q < L::TR * 16; q += L::THREADS) {
    const int r = q / 16, part = q % 16;
    const bool valid = row0 + r < row_end;
    if (part * 4 < dx)
      cp_async16(rowt + r * sa + part * 4, valid ? xb + (size_t)(row0 + r) * dx + part * 4 : xb,
                 valid);
  }
  float acc[4][8];
  float sqv[8];
  // step 1 of the selection rides on the epilogue: the best of this
  // thread's columns (ct + CT j, all congruent to ct mod 32) in each of its
  // rows, in column order
  float lm_s[4];
  int lm_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lm_s[i] = -INFINITY;
    lm_i[i] = INT_MAX;
  }
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  };
  // 4 dimensions of the 4 x 8 sums, each sum's chain in dimension order
  auto fma4 = [&](const float4 (&a)[4], const float4 (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, v[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, v[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, v[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, v[j].w, acc[i][j]);
  };
  // the tile's scores, 2 x_i.x_j - |x_j|^2, and the running maxima
  auto epilogue = [&](int c0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + ct + L::CT * j;
        const float v = __fsub_rn(__fmul_rn(2.f, acc[i][j]), sqv[j]);
        scores[(rt + L::RT * i) * srow + c] = v;
        const bool better = (c < n) & above(v, c, lm_s[i], lm_i[i]);
        lm_s[i] = better ? v : lm_s[i];
        lm_i[i] = better ? c : lm_i[i];
      }
  };
  const int ntiles = (n + L::TC - 1) / L::TC;

  if constexpr (DC == 4) {
    // D <= 4: a column is one float4 of xp, so each thread loads its 8
    // columns and their |x_j|^2 straight from L2 into registers, a tile
    // ahead: no ring and no barrier in the loop
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();  // the row tile
    float4 a[4], vn[8];
    float sn[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(rowt + (rt + L::RT * i) * sa);
    auto fetch = [&](int c0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + ct + L::CT * j;
        vn[j] = c < n ? __ldg(reinterpret_cast<const float4*>(xb) + c) : make_float4(0, 0, 0, 0);
        sn[j] = c < n ? __ldg(sqb + c) : 0.f;
      }
    };
    fetch(0);
    for (int tile = 0; tile < ntiles; ++tile) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        v[j] = vn[j];
        sqv[j] = sn[j];
      }
      fetch((tile + 1) * L::TC);  // (past the last tile: nothing)
      clear();
      fma4(a, v);
      epilogue(tile * L::TC);
    }
  } else {
    // slice s of the sweep: column tile s / nslices, dimensions DC (s % nslices) ..
    const int nslices = dx / DC;
    const int total = ntiles * nslices;
    auto load_slice = [&](int s) {
      if (s < total) {
        float* dst = ring + s % STAGES * L::TC * L::S;
        const int c0 = s / nslices * L::TC, d0 = s % nslices * DC;
#pragma unroll
        for (int m = 0; m < L::CHUNKS; ++m) {
          const int q = tid + m * L::THREADS;
          const int col = q / (DC / 4), part = q % (DC / 4);
          const bool valid = c0 + col < n;
          cp_async16(dst + col * L::S + part * 4,
                     valid ? xb + (size_t)(c0 + col) * dx + d0 + part * 4 : xb, valid);
        }
      }
      cp_async_commit();  // (an empty group past the end keeps the count)
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) load_slice(s);  // with the row tile in group 0
    float sqn[8];  // |x_j|^2 of the next tile's columns (loaded a tile ahead)
#pragma unroll
    for (int j = 0; j < 8; ++j) sqn[j] = ct + L::CT * j < n ? sqb[ct + L::CT * j] : 0.f;
    for (int s = 0, tile = 0, slice = 0; s < total; ++s) {
      cp_async_wait<STAGES - 2>();  // slice s has landed
      __syncthreads();              // for every thread; and slice s - 1 is consumed
      load_slice(s + STAGES - 1);   // into slice s - 1's buffer
      if (slice == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = (tile + 1) * L::TC + ct + L::CT * j;
          sqv[j] = sqn[j];
          sqn[j] = c < n ? sqb[c] : 0.f;
        }
        clear();
      }
      const float* st = ring + s % STAGES * L::TC * L::S;
#pragma unroll
      for (int q = 0; q < DC / 4; ++q) {
        float4 a[4], v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(rowt + (rt + L::RT * i) * sa + slice * DC + 4 * q);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = *reinterpret_cast<const float4*>(st + (ct + L::CT * j) * L::S + 4 * q);
        fma4(a, v);
      }
      if (slice + 1 == nslices) {
        epilogue(tile * L::TC);
        ++tile;
        slice = 0;
      } else {
        ++slice;
      }
    }
  }
  cp_async_wait<0>();
  // the threads' maxima, [TR][CT], in the ring (free once every thread is
  // past the last slice)
  float* lms = ring;
  int* lmi = reinterpret_cast<int*>(ring + L::TR * L::CT);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lms[(rt + L::RT * i) * L::CT + ct] = lm_s[i];
    lmi[(rt + L::RT * i) * L::CT + ct] = lm_i[i];
  }
  __syncthreads();  // every score and maximum is written

  // selection: warp w owns rows w RTW + r of the tile, r < RTW, taken
  // together so that their loads and shuffles overlap; the candidate
  // buffers reuse the ring
  constexpr int R = RTW;
  float* srows = scores + warp * R * srow;        // this warp's rows
  float* bs = ring + warp * R * BUF;              // [R][BUF] this warp's buffers
  int* bi = reinterpret_cast<int*>(ring + L::WARPS * R * BUF) + warp * R * BUF;
  const unsigned below_lane = (1u << lane) - 1u;
  // 1. lane l's best column of l, l + 32, ... (the maxima of the CT / 32
  // threads that held them), then T = the k-th best of the 32
  float ms[R], ts[R];
  int mi[R], ti[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ms[r] = -INFINITY;
    mi[r] = INT_MAX;
#pragma unroll
    for (int m = lane; m < L::CT; m += 32) {
      const float v = lms[(warp * R + r) * L::CT + m];
      const int c = lmi[(warp * R + r) * L::CT + m];
      const bool better = above(v, c, ms[r], mi[r]);
      ms[r] = better ? v : ms[r];
      mi[r] = better ? c : mi[r];
    }
  }
  __syncthreads();  // every warp has its maxima: the buffers may take the ring
  warp_sort<R>(ms, mi, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ts[r] = __shfl_sync(FULL, ms[r], k - 1);
    ti[r] = __shfl_sync(FULL, mi[r], k - 1);
  }
  // 2. this lane's columns at or above T, (v, c) == T included: near k in a
  // row, about one a lane.  The scan keeps, per 32 column groups, a bit a
  // group (no branch, no shuffle, a one-op chain per row); each block of
  // bits is then read out into four register slots (sl_s, sl_i), and cn
  // counts every candidate of the lane.
  float sl_s[R][4];
  int sl_i[R][4], cn[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      sl_s[r][q] = -INFINITY;
      sl_i[r][q] = INT_MAX;
    }
    cn[r] = 0;
  }
  const int ng = (n + 31) / 32;
  for (int g0 = 0; g0 < ng; g0 += 32) {
    unsigned bits[R];
#pragma unroll
    for (int r = 0; r < R; ++r) bits[r] = 0;
    const int g1 = min(ng, g0 + 32);
#pragma unroll 4
    for (int g = g0; g < g1; ++g) {
      const int c = g * 32 + lane;
      const unsigned bit = 1u << (g - g0);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = srows[r * srow + c];  // (the score rows run past n: masked)
        const bool cand = (c < n) & ((v > ts[r]) | ((v == ts[r]) & (c <= ti[r])));
        bits[r] |= cand ? bit : 0u;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      for (unsigned m = bits[r]; m; m &= m - 1) {  // this lane's own, in column order
        const int c = (g0 + __ffs(m) - 1) * 32 + lane;
        const float v = srows[r * srow + c];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          sl_s[r][q] = cn[r] == q ? v : sl_s[r][q];
          sl_i[r][q] = cn[r] == q ? c : sl_i[r][q];
        }
        ++cn[r];
      }
    }
  }
  // 3. a row's candidates gathered into its own score row, dead now (the
  // lanes' first slots in lane order, then their second, third, fourth:
  // scores at [0, C), indices at [128, 128 + C)); the first 32 sorted, the
  // rest merged in 32 at a time.  A row where some lane holds more than four
  // is selected again by select_rescan, from its buffer (bs, bi).
  __syncwarp();
  int count[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float* gs = srows + r * srow;
    int* gi = reinterpret_cast<int*>(gs) + 128;
    count[r] = 0;
    if (__any_sync(FULL, cn[r] > 4)) {
      count[r] = -1;
      continue;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned bq = __ballot_sync(FULL, cn[r] > q);
      if (cn[r] > q) {
        const int p = count[r] + __popc(bq & below_lane);
        gs[p] = sl_s[r][q];
        gi[p] = sl_i[r][q];
      }
      count[r] += __popc(bq);
    }
  }
  __syncwarp();
  float cs[R];
  int ci[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* gs = srows + r * srow;
    cs[r] = lane < count[r] ? gs[lane] : -INFINITY;
    ci[r] = lane < count[r] ? reinterpret_cast<const int*>(gs)[128 + lane] : INT_MAX;
  }
  warp_sort<R>(cs, ci, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float* gs = srows + r * srow;
    Best q{cs[r], ci[r]};
    for (int m = 32; m < count[r]; m += 32)  // the rest, 32 at a time
      q = merge_chunk(q, m + lane < count[r] ? gs[m + lane] : -INFINITY,
                      m + lane < count[r] ? reinterpret_cast<const int*>(gs)[128 + m + lane] : INT_MAX,
                      lane);
    if (count[r] < 0)
      q = select_rescan(gs, n, ts[r], ti[r], bs + r * BUF, bi + r * BUF, lane);
    // a slot still at INT_MAX: only NaN scores were left for it
    const int row = row0 + warp * R + r;
    if (row < row_end && lane < k)
      idx[((size_t)b * rows + row - row_begin) * k + lane] = q.i < n ? q.i : -1;
  }
}

// Lets a kernel (knn_kernel<L>, knn_wide_kernel<L>) take up to MAX_SMEM of
// shared memory: once per kernel and device.
template <auto Kernel>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The launch plan: of the tiles for this D (D <= 4 or not), the one whose
// blocks keep the most rows resident on an SM by shared memory and threads
// (the larger tile on a tie: it reads the cloud fewer times); the padded
// row width dx (a multiple of its DC) and its shared bytes.
struct Plan {
  int tile, dx;
  size_t smem;
};

__host__ inline Plan plan_of(int n, int d) {
  Plan best{-1, 0, 0};
  int best_rows = 0;
  for (int t = d <= 4 ? 0 : 3; t < (d <= 4 ? 3 : TILES); ++t) {
    with_tile(t, [&](auto tile) {
      using L = decltype(tile);
      const int dx = round_up(d, L::DC);
      const size_t smem = L::smem(n, dx);
      if (smem > (size_t)MAX_SMEM) return 0;
      const int blocks = std::min((int)(SM_SMEM / (smem + 1024)), SM_THREADS / L::THREADS);
      if (blocks * L::TR > best_rows) {
        best_rows = blocks * L::TR;
        best = Plan{t, dx, smem};
      }
      return 0;
    });
  }
  return best;
}

// A row range [row_begin, row_begin + rows) of an n-point cloud.
__host__ inline bool valid_rows(int n, int row_begin, int rows) {
  return row_begin >= 0 && rows >= 1 && row_begin <= n - rows;
}

__host__ inline bool in_domain(int b, int n, int d, int k) {
  return b >= 1 && b <= 65535 && n >= 1 && n <= MAX_N && d >= 1 && d <= MAX_D && k >= 1 &&
         k <= MAX_K && k <= n;
}

// B1 on x [b, n, d] of element type T, for rows row_begin .. row_begin +
// rows - 1; work holds n (round_up(d, 16) + 1) floats per cloud.
template <typename T>
int knn_entry(const T* x, int* idx, float* work, int b, int n, int d, int k, int row_begin,
              int rows, void* stream) {
  if (!in_domain(b, n, d, k) || !valid_rows(n, row_begin, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = plan_of(n, d);
  if (p.tile < 0) return (int)cudaErrorInvalidValue;  // (every shape of the domain has one)
  float* xp = work;
  float* sq = work + (size_t)b * n * p.dx;
  const int points = b * n;
  const int prep_blocks = (points + PREP_POINTS - 1) / PREP_POINTS;
  knn_prep_kernel<T><<<prep_blocks, PREP_THREADS, 0, s>>>(x, xp, sq, points, d, p.dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)with_tile(p.tile, [&](auto tile) {
    using L = decltype(tile);
    cudaError_t e = allow_smem<knn_kernel<L>>();
    if (e != cudaSuccess) return e;
    const dim3 grid((rows + L::TR - 1) / L::TR, b);
    knn_kernel<L><<<grid, L::THREADS, p.smem, s>>>(xp, sq, idx, n, p.dx, k, row_begin, rows);
    return cudaGetLastError();
  });
}

// ---------------------------------------------------------------------------
// The wide route: the shapes knn_kernel refuses (k > 32, D > 64 or N > 4096).
//
// knn_wide_kernel<L> computes knn_kernel's function, on the same prep and
// with the same score FMA chains (so the same scores, bit for bit), for any
// N and D and k <= WIDE_MAX_K, and keeps nothing of size N per row:
// * Row tiles.  A block takes TR query rows (a Tile<...>, as knn_kernel)
//   and streams the cloud past them in tiles of TC columns, each cut into
//   slices of DC dimensions that cp.async brings into a ring of STAGES
//   buffers: the columns' [TC][DC] and the rows' [TR][DC] (so that D is
//   unbounded), into knn_kernel's 4 x 8 register tile of FMAs (wide_sweep).
//   The cloud is read from L2 once per TR rows, not once per row.
// * A streamed selection.  Each row keeps its best 32 S so far (S = ceil(k
//   / 32)), sorted, in shared memory; its k-th, T, is the threshold.  A
//   tile's scores go to shared memory, [TR][TC]; each warp filters its
//   rows' TC scores against T, one compare a score, and compacts the
//   survivors by ballot (in column order).  While more than INSERT_MAX
//   are left, the first 32 are merged in (merge_into: a bitonic sort
//   across the warp, then a bitonic merge into each 32 of the list in
//   turn) and the rest filtered again against the raised T; the last few
//   go in one at a time (insert_one: a ballot finds the place, the list
//   shifts), each checked against T first.  Until k columns are in, T is
//   the empty slot (-inf, INT_MAX).  The ranking order (score descending,
//   then index ascending) is total, so the result does not depend on the
//   order of the tiles: a block starts at the column tile that holds its
//   own rows, where a cloud stored near its neighbours has its nearest, so
//   that T is tight from the first tile on and few later columns pass the
//   filter.  NaN scores never rank; a slot no score reached reports -1.
//   tests/test_torch_knn_stream.py replays the selection lane by lane
//   (hpcs_torch.testing.knn_stream_select).
//
// What bounds it: the score FMAs, 2 B R N D operations over R query rows,
// as knn_kernel's, against 67 TFLOP/s; the cloud crosses from L2 to shared
// memory (1 + TR / TC) R / TR times, B R N D (1 / TR + 1 / TC) 4 bytes
// (2.4 GB at B = 4, N = 8192, D = 63), against some 5-6 TB/s.  At D <= 4
// the scores cost little and the epilogue's stores and the filter are the
// work.  Two blocks of 8 warps share an SM.
//
// k > WIDE_MAX_K (a row's list would not fit beside its tile) takes the
// radix route, whose selection reads a row a fixed number of times whatever
// k and the order of the columns, and which keeps nothing of size N per row
// in shared memory, for every k <= N:
// * knn_keys_kernel<L> runs knn_wide_kernel's score sweep (wide_sweep: the
//   same ring, tile and FMA chains, so the same scores) over a group of
//   query rows, each block over a chunk of column tiles (KEYS_BLOCKS_PER_SM
//   blocks an SM), and stores each score as its order-preserving uint32
//   key (score_key: -0.0 as +0.0, NaN as 0, below -inf) to a global
//   scratch [group][N], coalesced.  A group's keys take GROUP_WORDS (128
//   MiB: on an H100 80GB HBM3 at 700 W, at N = 65,536, groups of 32 MiB,
//   held in L2, took 2 ms more over four times the launches); the rows go
//   through group by group.
// * knn_radix_kernel, one block a row, selects on the composite (key << 32
//   | ~column): distinct for every column, and larger exactly when the
//   column ranks above (score descending, then index ascending), so the k
//   largest composites are the result.  A radix select on digits of 11, 11
//   and 10 bits from the top (the key's, then the index's): a pass counts
//   the columns still in play by their digit (a histogram in shared
//   memory), a block scan finds the bucket of the need-th largest, and the
//   next pass emits the columns of larger digits while it counts the
//   bucket's by their next digit, until a bucket holds exactly what is
//   still needed, which is emitted whole.  Ties at the k-th score are
//   split by the index digits.  Once a bucket holds at most CAND_CAP
//   columns they are copied to shared memory and the row is not read again
//   (on Gaussian clouds after the first digit: the row is read twice).
//   The r = min(k, non-NaN columns) emitted composites are then put in
//   order, largest first: up to one a thread each goes to the count of
//   larger ones (every thread reads each slot: no barrier), past it through
//   a bitonic network over 2^m >= r slots (in shared memory up to SORT_CAP,
//   else in the row's scratch).  Slot q of the output gets the q-th column,
//   -1 past r.
//   tests/test_torch_knn_large_k.py replays it (hpcs_torch.testing
//   .knn_radix_route).
// What bounds it: the score FMAs, as the wide route's; past them, per
// score a 4-byte key stored and read twice, and one or two shared atomic
// adds.  On the card the selection kernel takes far longer than those
// bytes and atomics (PERF.md §6; scripts/knn_radix_variants.py).

constexpr int WIDE_MAX_K = 256;
// a tile's survivors of a row up to which they go in one at a time: an
// insertion costs S ballots and a shift, a merge of 32 some 26 steps of
// shuffles (the sort and the merge)
constexpr int INSERT_MAX = 8;
constexpr int WIDE_MAX_N = 1 << 30;  // int32 indices, with room for a tile past the end
constexpr int WIDE_MAX_D = 1 << 20;
// the radix route (k > WIDE_MAX_K)
// knn_radix_kernel's block: 256 threads, or for rows of LONG_ROW keys or
// more 1024 (one block a row: more loads in flight an SM)
constexpr int RADIX_THREADS = 256, RADIX_THREADS_LONG = 1024;
constexpr int LONG_ROW = 8192;
constexpr int RADIX_MAX_WARPS = RADIX_THREADS_LONG / 32;
constexpr int RADIX_BINS = 2048;    // the widest digit, 11 bits
constexpr int CAND_CAP = 2048;      // a bucket's columns copied to shared memory
constexpr int SORT_CAP = 4096;      // composites sorted in shared memory (a power of two)
constexpr long long GROUP_WORDS = 1LL << 25;  // a group's keys, 128 MiB
constexpr int KEYS_BLOCKS_PER_SM = 4;         // knn_keys_kernel's blocks over the card

// knn_wide_kernel's shared memory for Tile L: the ring ([STAGES][TC + TR][S]:
// columns, then rows), the tile's scores ([TR][SS], SS = TC + CTW: the
// epilogue's RTW x CTW lanes hit 32 banks), the rows' lists ([TR][slots]
// scores, then indices; slots = 32 S) and each warp's survivors' offsets
// ([WARPS][TC] bytes).
template <class L>
struct Wide {
  static constexpr int SS = L::TC + L::CTW;
  static constexpr int RPW = L::TR / L::WARPS;  // rows a warp selects
  static constexpr int STAGE = (L::TC + L::TR) * L::S;
  static_assert(L::TR % L::WARPS == 0, "a warp selects whole rows");
  static_assert(L::TC % 32 == 0 && L::TC <= 256, "a survivor's offset in the tile is a byte");
  static_assert(L::TR * L::DC / 4 <= L::THREADS, "a slice of the rows is one copy a thread");
  __host__ static size_t smem(int slots) {
    return sizeof(float) * ((size_t)L::STAGES * STAGE + (size_t)L::TR * SS) +
           (sizeof(float) + sizeof(int)) * (size_t)L::TR * slots + (size_t)L::WARPS * L::TC;
  }
};

using WideTile0 = Tile<4, 4, 2, 4>;   // D <= 4: one slice a tile
using WideTile1 = Tile<4, 16, 2, 3>;  // D > 4: 3 slices of 16 in flight
using WideTile2 = Tile<4, 16, 2, 2>;  // D > 4, larger k: 2
constexpr int WIDE_TILES = 3;

template <class F>
auto with_wide_tile(int t, F&& f) {
  switch (t) {
    case 0: return f(WideTile0{});
    case 1: return f(WideTile1{});
    default: return f(WideTile2{});
  }
}

// Sorts the 32 (cs, ci) across the warp and merges them into a row's
// sorted list (ls, li: `chunks` x 32 in shared memory), which keeps its
// best: chunk q of the list against the carry (the chunk reversed against
// the carry, lane by lane, splits the best 32 of the two from the worst 32,
// both bitonic; a half-cleaner cascade sorts each), the best 32 stored,
// the worst carried on to chunk q + 1 (past the last chunk they drop, and
// are not sorted).  Out of line, as merge_chunk.
__device__ __noinline__ void merge_into(float* ls, int* li, int chunks, float cs, int ci,
                                        int lane) {
  float s[1] = {cs};
  int i[1] = {ci};
  warp_sort<1>(s, i, lane);
  cs = s[0];
  ci = i[0];
  for (int q = 0; q < chunks; ++q) {
    float hs = ls[32 * q + lane];
    int hi = li[32 * q + lane];
    const float rs = __shfl_sync(FULL, cs, 31 - lane);
    const int ri = __shfl_sync(FULL, ci, 31 - lane);
    const bool take = above(rs, ri, hs, hi);
    cs = take ? hs : rs;  // the worse of the pair
    ci = take ? hi : ri;
    hs = take ? rs : hs;  // the better
    hi = take ? ri : hi;
    const bool carried = q + 1 < chunks;  // the last chunk's worst 32 drop out unsorted
#pragma unroll
    for (int stride = 16; stride > 0; stride /= 2) {
      const bool low = (lane & stride) == 0;  // the lower lane of a pair keeps the better
      const float os = __shfl_xor_sync(FULL, hs, stride);
      const int oi = __shfl_xor_sync(FULL, hi, stride);
      if (low ? above(os, oi, hs, hi) : above(hs, hi, os, oi)) {
        hs = os;
        hi = oi;
      }
      if (carried) {
        const float ws = __shfl_xor_sync(FULL, cs, stride);
        const int wi = __shfl_xor_sync(FULL, ci, stride);
        if (low ? above(ws, wi, cs, ci) : above(cs, ci, ws, wi)) {
          cs = ws;
          ci = wi;
        }
      }
    }
    ls[32 * q + lane] = hs;
    li[32 * q + lane] = hi;
  }
  __syncwarp();
}

// Inserts (v, c), which ranks above the list's k-th, into a row's sorted
// list (ls, li: `chunks` x 32 in shared memory): its place p is the count
// of entries above it (a ballot a chunk), and the entries from p on move
// down one slot, the chunks from the last, the last slot dropping.
__device__ __noinline__ void insert_one(float* ls, int* li, int chunks, float v, int c,
                                        int lane) {
  int p = 0;
  for (int q = 0; q < chunks; ++q)
    p += __popc(__ballot_sync(FULL, above(ls[32 * q + lane], li[32 * q + lane], v, c)));
  for (int q = chunks - 1; q >= p / 32; --q) {
    const int pos = 32 * q + lane;
    const float ps = pos > 0 ? ls[pos - 1] : 0.f;  // (chunk q - 1 is not moved yet)
    const int pi = pos > 0 ? li[pos - 1] : 0;
    __syncwarp();
    if (pos >= p) {
      ls[pos] = pos == p ? v : ps;
      li[pos] = pos == p ? c : pi;
    }
    __syncwarp();
  }
}

// The wide route's score sweep (knn_wide_kernel's and knn_keys_kernel's):
// the block's TR query rows row0 .. (rows at or past row_end read as zero)
// against `count` column tiles, tile t starting at column tile_c0(t), each
// streamed in slices of DC dimensions through the ring (the columns'
// [TC][DC], then the rows' [TR][DC]) into the 4 x 8 register tile, each
// sum's FMA chain in dimension order.  After each tile its scores,
// 2 x_i.x_j - |x_j|^2, lie in scores [TR][SS] for every thread and
// on_tile(c0) runs; the next tile's scores are stored past the next
// slice's barrier.
template <class L, class C0, class F>
__device__ __forceinline__ void wide_sweep(float* ring, float* scores, const float* __restrict__ xb,
                                           const float* __restrict__ sqb, int n, int dx, int row0,
                                           int row_end, int count, C0 tile_c0, F on_tile) {
  using W = Wide<L>;
  constexpr int DC = L::DC, STAGES = L::STAGES, TC = L::TC;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rt = warp / 4 * L::RTW + lane / L::CTW;     // rows rt + RT i
  const int ct = warp % 4 * L::CTW + lane % L::CTW;     // columns ct + CT j
  // slice s of the sweep: column tile s / nslices, dimensions DC (s % nslices) ..
  const int nslices = dx / DC;
  const long long total = (long long)count * nslices;
  auto load_slice = [&](long long s) {
    if (s < total) {
      float* dst = ring + (int)(s % STAGES) * W::STAGE;
      const int c0 = tile_c0((int)(s / nslices)), d0 = (int)(s % nslices) * DC;
#pragma unroll
      for (int m = 0; m < L::CHUNKS; ++m) {
        const int q = tid + m * L::THREADS;
        const int col = q / (DC / 4), part = q % (DC / 4);
        const bool valid = c0 + col < n;
        cp_async16(dst + col * L::S + part * 4,
                   valid ? xb + (size_t)(c0 + col) * dx + d0 + part * 4 : xb, valid);
      }
      if (tid < L::TR * (DC / 4)) {
        const int r = tid / (DC / 4), part = tid % (DC / 4);
        const bool valid = row0 + r < row_end;
        cp_async16(dst + (TC + r) * L::S + part * 4,
                   valid ? xb + (size_t)(row0 + r) * dx + d0 + part * 4 : xb, valid);
      }
    }
    cp_async_commit();  // (an empty group past the end keeps the count)
  };
  float acc[4][8], sqv[8], sqn[8];  // |x_j|^2 of this tile's and the next tile's columns
  auto load_sq = [&](int c0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + ct + L::CT * j;
      sqn[j] = c < n ? __ldg(sqb + c) : 0.f;
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_slice(s);
  load_sq(tile_c0(0));
  int tile = 0, slice = 0;
  for (long long s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();  // slice s has landed
    __syncthreads();              // for every thread; and slice s - 1 is consumed
    load_slice(s + STAGES - 1);   // into slice s - 1's buffer
    if (slice == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sqv[j] = sqn[j];
      if (tile + 1 < count) load_sq(tile_c0(tile + 1));
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* st = ring + (int)(s % STAGES) * W::STAGE;
#pragma unroll
    for (int q = 0; q < DC / 4; ++q) {
      float4 a[4], v[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(st + (TC + rt + L::RT * i) * L::S + 4 * q);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = *reinterpret_cast<const float4*>(st + (ct + L::CT * j) * L::S + 4 * q);
      // 4 dimensions of the 4 x 8 sums, each sum's chain in dimension order
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, v[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, v[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, v[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, v[j].w, acc[i][j]);
    }
    if (++slice == nslices) {
      // the tile's scores, 2 x_i.x_j - |x_j|^2, then on_tile (the next
      // tile's epilogue is past the next iteration's barrier)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          scores[(rt + L::RT * i) * W::SS + ct + L::CT * j] =
              __fsub_rn(__fmul_rn(2.f, acc[i][j]), sqv[j]);
      __syncthreads();
      on_tile(tile_c0(tile));
      slice = 0;
      ++tile;
    }
  }
  cp_async_wait<0>();
}

template <class L>
__global__ void __launch_bounds__(L::THREADS, 2)
knn_wide_kernel(const float* __restrict__ xp, const float* __restrict__ sq, int* __restrict__ idx,
                int n, int dx, int k, int row_begin, int rows) {
  using W = Wide<L>;
  constexpr int STAGES = L::STAGES, TR = L::TR, TC = L::TC, RPW = W::RPW;
  extern __shared__ float4 smem4[];
  const int slots = round_up(k, 32);
  float* ring = reinterpret_cast<float*>(smem4);  // [STAGES][TC + TR][S]
  float* scores = ring + STAGES * W::STAGE;       // [TR][SS]
  float* ls = scores + TR * W::SS;                // [TR][slots], best first
  int* li = reinterpret_cast<int*>(ls + TR * slots);
  unsigned char* offs = reinterpret_cast<unsigned char*>(li + TR * slots);  // [WARPS][TC]

  const int b = blockIdx.y;
  const int row0 = row_begin + blockIdx.x * TR;
  const int row_end = row_begin + rows;
  const float* xb = xp + (size_t)b * n * dx;
  const float* sqb = sq + (size_t)b * n;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const unsigned below_lane = (1u << lane) - 1u;

  for (int q = tid; q < TR * slots; q += L::THREADS) {  // every list empty
    ls[q] = -INFINITY;
    li[q] = INT_MAX;
  }
  // column tile t of the sweep is the cloud's tile (t0 + t) mod ntiles
  const int ntiles = (n + TC - 1) / TC;
  const int t0 = (row0 / TC) % ntiles;

  // a tile's selection: warp w takes rows w RPW .. w RPW + RPW - 1 of the tile
  auto select = [&](int c0) {
    unsigned char* off = offs + warp * TC;
#pragma unroll 1
    for (int r = 0; r < RPW; ++r) {
      const int lr = warp * RPW + r;
      if (row0 + lr >= row_end) break;
      float* rs = ls + lr * slots;
      int* ri = li + lr * slots;
      const float ts = rs[k - 1];
      const int ti = ri[k - 1];
      const float* srow = scores + lr * W::SS;
      unsigned bal[TC / 32];
      int count = 0;
#pragma unroll
      for (int m = 0; m < TC / 32; ++m) {
        const int c = c0 + 32 * m + lane;
        const bool keep = (c < n) & above(srow[32 * m + lane], c, ts, ti);
        bal[m] = __ballot_sync(FULL, keep);
        count += __popc(bal[m]);
      }
      if (count == 0) continue;
      // the survivors' offsets in the tile, in column order
      int base = 0;
#pragma unroll
      for (int m = 0; m < TC / 32; ++m) {
        if (bal[m] >> lane & 1u) off[base + __popc(bal[m] & below_lane)] = 32 * m + lane;
        base += __popc(bal[m]);
      }
      __syncwarp();
      while (count > INSERT_MAX) {
        // the first 32 merged; the rest filtered again against the raised
        // T and compacted to the front (writes land below the reads)
        merge_into(rs, ri, slots / 32, lane < count ? srow[off[lane]] : -INFINITY,
                   lane < count ? c0 + off[lane] : INT_MAX, lane);
        const float ts2 = rs[k - 1];
        const int ti2 = ri[k - 1];
        int kept = 0;
        for (int g = 32; g < count; g += 32) {
          const bool has = g + lane < count;
          const int u = has ? off[g + lane] : 0;
          const bool keep = has && above(srow[u], c0 + u, ts2, ti2);
          const unsigned kb = __ballot_sync(FULL, keep);
          if (keep) off[kept + __popc(kb & below_lane)] = u;
          kept += __popc(kb);
        }
        __syncwarp();
        count = kept;
      }
      for (int j = 0; j < count; ++j) {  // a few: one at a time, each against T
        const int u = off[j];
        if (above(srow[u], c0 + u, rs[k - 1], ri[k - 1]))
          insert_one(rs, ri, slots / 32, srow[u], c0 + u, lane);
      }
      __syncwarp();  // off is the next row's
    }
  };
  wide_sweep<L>(ring, scores, xb, sqb, n, dx, row0, row_end, ntiles,
                [&](int t) { return (t0 + t) % ntiles * TC; }, select);
  __syncwarp();
  // lane q < k of row r: the q-th best (rows of this warp only: its lists)
#pragma unroll 1
  for (int r = 0; r < RPW; ++r) {
    const int row = row0 + warp * RPW + r;
    if (row >= row_end) break;
    const int* ri = li + (warp * RPW + r) * slots;
    int* out = idx + ((size_t)b * rows + row - row_begin) * k;
    for (int q = lane; q < k; q += 32) out[q] = ri[q] < n ? ri[q] : -1;
  }
}

// The order-preserving key of a score: larger exactly when the score ranks
// above; -0.0 the key of +0.0 (knn_plain's sort holds them equal); NaN 0,
// below -inf's 0x007fffff, so that a NaN never ranks.
__device__ __forceinline__ unsigned score_key(float v) {
  unsigned u = __float_as_uint(v);
  if (v != v) return 0u;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The radix route's scores: rows row_first .. row_first + group_rows - 1 of
// cloud blockIdx.z, a block's TR of them (blockIdx.x) against its chunk of
// chunk_tiles column tiles (blockIdx.y), as keys into keys [b][group_rows]
// [stride] (a row's n keys first).  Warp w stores rows w RPW .. of each
// tile, 32 consecutive keys a store.
template <class L>
__global__ void __launch_bounds__(L::THREADS, 2)
knn_keys_kernel(const float* __restrict__ xp, const float* __restrict__ sq,
                unsigned* __restrict__ keys, long long stride, int n, int dx, int row_first,
                int group_rows, int chunk_tiles) {
  using W = Wide<L>;
  constexpr int TC = L::TC, RPW = W::RPW;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [STAGES][TC + TR][S]
  float* scores = ring + L::STAGES * W::STAGE;    // [TR][SS]

  const int b = blockIdx.z;
  const int row0 = row_first + blockIdx.x * L::TR;
  const int row_end = row_first + group_rows;
  const float* xb = xp + (size_t)b * n * dx;
  const float* sqb = sq + (size_t)b * n;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ntiles = (n + TC - 1) / TC;
  const int t_first = blockIdx.y * chunk_tiles;
  unsigned* kb = keys + (size_t)b * group_rows * stride;
  auto store = [&](int c0) {
#pragma unroll 1
    for (int r = 0; r < RPW; ++r) {
      const int lr = warp * RPW + r;
      if (row0 + lr >= row_end) break;
      const float* srow = scores + lr * W::SS;
      unsigned* krow = kb + (size_t)(row0 + lr - row_first) * stride + c0;
#pragma unroll
      for (int m = 0; m < TC / 32; ++m)
        if (c0 + 32 * m + lane < n) krow[32 * m + lane] = score_key(srow[32 * m + lane]);
    }
  };
  wide_sweep<L>(ring, scores, xb, sqb, n, dx, row0, row_end, min(chunk_tiles, ntiles - t_first),
                [&](int t) { return (t_first + t) * TC; }, store);
}

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p *= 2;
  return p;
}

// An exclusive sum over the block's T threads (warp sums in ws[T / 32]);
// ends past a barrier.
template <int T>
__device__ __forceinline__ int block_exclusive_sum(int v, int* ws) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o *= 2) {
    const int t = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < T / 32; ++w) before += w < warp ? ws[w] : 0;
  return before + incl - v;
}

// Of `bins` digits (hist: the columns still in play counted by digit), the
// one whose bucket holds the need-th largest: above < need <= above +
// hist[d], above the count in larger digits.  found[0..2] = (d, above,
// hist[d]), for every thread past the closing barrier.  Thread t scans
// digits bins - 1 - per t down, so the scan runs from the largest digit.
template <int T>
__device__ __forceinline__ void find_bucket(const int* hist, int bins, int need, int* ws,
                                            int* found) {
  const int per = bins / T;
  const int hi = bins - 1 - per * threadIdx.x;
  int s = 0;
  for (int j = 0; j < per; ++j) s += hist[hi - j];
  int acc = block_exclusive_sum<T>(s, ws);
  for (int j = 0; j < per; ++j) {
    const int h = hist[hi - j];
    if (acc < need && need <= acc + h) {  // one thread, one digit
      found[0] = hi - j;
      found[1] = acc;
      found[2] = h;
    }
    acc += h;
  }
  __syncthreads();
}

// f(key, column) over a row of n keys: a thread takes 4 consecutive columns
// a step (one 16-byte load; the row is 16-byte aligned), the block's steps
// 4 T apart, four steps' loads in flight before their keys are used.
template <int T, class F>
__device__ __forceinline__ void for_row(const unsigned* row, int n, F f) {
  constexpr int STEP = 4 * T;
  int c = 4 * threadIdx.x;
  for (; c + 3 * STEP + 4 <= n; c += 4 * STEP) {
    uint4 v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) v[m] = __ldcg(reinterpret_cast<const uint4*>(row + c + m * STEP));
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      f(v[m].x, c + m * STEP);
      f(v[m].y, c + m * STEP + 1);
      f(v[m].z, c + m * STEP + 2);
      f(v[m].w, c + m * STEP + 3);
    }
  }
  for (; c < n; c += STEP) {
    if (c + 4 <= n) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + c);
      f(v.x, c);
      f(v.y, c + 1);
      f(v.z, c + 2);
      f(v.w, c + 3);
    } else {
      for (int j = c; j < n; ++j) f(row[j], j);
    }
  }
}

// The radix route's selection, one block a row: row g of the group (its
// keys at keys [b][group_rows][stride]) into output row out_row0 + g of
// idx [b][out_rows][k].  Shared memory: the sort's 2^m composites (where
// they fit SORT_CAP), CAND_CAP candidates, RADIX_BINS counts, the scan's
// warp sums, find_bucket's result and two counters.  T threads.
template <int T>
__global__ void __launch_bounds__(T)
knn_radix_kernel(unsigned* __restrict__ keys, long long stride, int* __restrict__ idx, int n,
                 int k, int group_rows, int out_rows, int out_row0) {
  using u64 = unsigned long long;
  extern __shared__ u64 sm8[];
  const int tid = threadIdx.x;
  const int g = blockIdx.x, b = blockIdx.y;
  unsigned* row = keys + ((size_t)b * group_rows + g) * stride;
  int* out = idx + ((size_t)b * out_rows + out_row0 + g) * k;
  const int p2k = pow2_at_least(k);
  const bool shared_sort = p2k <= SORT_CAP;
  u64* sorted = shared_sort ? sm8 : reinterpret_cast<u64*>(row + round_up(n, 4));
  u64* cand = sm8 + (shared_sort ? p2k : 0);
  int* hist = reinterpret_cast<int*>(cand + CAND_CAP);
  int* ws = hist + RADIX_BINS;
  int* found = ws + RADIX_MAX_WARPS;
  int* counter = found + 3;  // [0] emitted, [1] candidates copied

  // the first digit, the key's top 11 bits (NaN's key 0 alone in digit 0)
  for (int q = tid; q < RADIX_BINS; q += T) hist[q] = 0;
  if (tid < 2) counter[tid] = 0;
  __syncthreads();
  for_row<T>(row, n, [&](unsigned key, int) { atomicAdd(&hist[key >> 21], 1); });
  __syncthreads();
  const int r = min(k, n - hist[0]);  // the columns to emit: every non-NaN one up to k
  if (r == 0) {
    for (int q = tid; q < k; q += T) out[q] = -1;
    return;
  }
  find_bucket<T>(hist, RADIX_BINS, r, ws, found);
  // the columns in play share the composite's top 64 - shp bits, `pre`; this
  // level's digit is the next w bits, of which d holds the need-th largest
  int d = found[0], above = found[1], cnt = found[2], need = r;
  int shp = 64, w = 11, ncand = 0;
  u64 pre = 0;
  bool from_row = true;
  while (true) {
    const int need_in = need - above;  // still needed from bucket d
    const int sh = shp - w;
    const bool take_all = cnt == need_in || sh == 0;  // (the last digit's bucket: one column)
    const int wn = take_all ? 0 : (sh % 32 == 10 ? 10 : 11);  // digits 11, 11, 10 a word
    const bool compact = !take_all && from_row && cnt <= CAND_CAP;
    __syncthreads();  // every thread has read found and hist
    if (!take_all)
      for (int q = tid; q < (1 << wn); q += T) hist[q] = 0;
    __syncthreads();
    const unsigned dmask = (1u << w) - 1u, nmask = (1u << wn) - 1u;
    auto visit = [&](u64 comp) {
      if (shp < 64 && (comp >> shp) != pre) return;
      const unsigned dig = (unsigned)(comp >> sh) & dmask;
      if (dig > (unsigned)d || (take_all && dig == (unsigned)d)) {
        sorted[atomicAdd(&counter[0], 1)] = comp;
      } else if (dig == (unsigned)d) {
        atomicAdd(&hist[(unsigned)(comp >> (sh - wn)) & nmask], 1);
        if (compact) cand[atomicAdd(&counter[1], 1)] = comp;
      }
    };
    if (from_row)
      for_row<T>(row, n, [&](unsigned key, int c) { visit((u64)key << 32 | (unsigned)~c); });
    else
      for (int q = tid; q < ncand; q += T) visit(cand[q]);
    __syncthreads();
    if (take_all) break;
    if (compact) {
      from_row = false;
      ncand = cnt;
    }
    pre = shp == 64 ? (u64)d : (pre << w) | (u64)d;
    shp = sh;
    w = wn;
    need = need_in;
    find_bucket<T>(hist, 1 << w, need, ws, found);
    d = found[0];
    above = found[1];
    cnt = found[2];
  }
  // the r emitted composites, largest first.  Up to one a thread: each
  // one's place is the count of larger ones (distinct: a permutation), no
  // barrier
  if (r <= T) {
    for (int q = tid; q < r; q += T) {
      const u64 v = sorted[q];
      int place = 0;
#pragma unroll 8
      for (int j = 0; j < r; ++j) place += sorted[j] > v;  // (every thread reads slot j)
      out[place] = (int)~(unsigned)v;
    }
    for (int q = r + tid; q < k; q += T) out[q] = -1;
    return;
  }
  // past it, a bitonic network over p2 >= r slots, the empty ones 0 (below
  // every column's)
  const int p2 = pow2_at_least(r);
  for (int q = r + tid; q < p2; q += T) sorted[q] = 0;
  __syncthreads();
  for (int size = 2; size <= p2; size *= 2) {
    for (int half = size / 2; half > 0; half /= 2) {
      for (int q = tid; q < p2 / 2; q += T) {
        const int i = 2 * q - (q & (half - 1)), j = i + half;  // the pair's lower slot
        const u64 a = sorted[i], c = sorted[j];
        if ((a < c) == ((i & size) == 0)) {  // blocks of `size` alternate direction
          sorted[i] = c;
          sorted[j] = a;
        }
      }
      __syncthreads();
    }
  }
  for (int q = tid; q < k; q += T) out[q] = q < r ? (int)~(unsigned)sorted[q] : -1;
}

// The wide route's prep for D > MAX_D (knn_prep_kernel stages 64 values a
// point): one warp a point, 32 values at a time, coalesced; |x_j|^2 the same
// FMA chain in dimension order (each value broadcast by a shuffle).
template <typename T>
__global__ void __launch_bounds__(PREP_THREADS)
knn_prep_wide_kernel(const T* __restrict__ x, float* __restrict__ xp, float* __restrict__ sq,
                     int points, int d, int dx) {
  const int p = blockIdx.x * (PREP_THREADS / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (p >= points) return;
  float s = 0.f;
  for (int q0 = 0; q0 < dx; q0 += 32) {
    const int q = q0 + lane;
    const float v = q < d ? to_float(x[(size_t)p * d + q]) : 0.f;
    if (q < dx) xp[(size_t)p * dx + q] = v;
    const int m = min(32, d - q0);
    for (int j = 0; j < m; ++j) {
      const float u = __shfl_sync(FULL, v, j);
      s = fmaf(u, u, s);
    }
  }
  if (lane == 0) sq[p] = s;
}

// The wide launch plan: of the tiles for this D, the one whose blocks keep
// the most rows resident on an SM by shared memory and threads (the first,
// with more slices in flight, on a tie); the padded width dx (a multiple
// of its DC) and the shared bytes, with a row list of 32 ceil(k / 32) slots
// (knn_wide_kernel) or, for k > WIDE_MAX_K, none (knn_keys_kernel).
__host__ inline Plan wide_plan_of(int d, int k) {
  const int slots = k > WIDE_MAX_K ? 0 : round_up(k, 32);
  Plan best{-1, 0, 0};
  int best_rows = 0;
  for (int t = d <= 4 ? 0 : 1; t < (d <= 4 ? 1 : WIDE_TILES); ++t) {
    with_wide_tile(t, [&](auto tile) {
      using L = decltype(tile);
      const size_t smem = Wide<L>::smem(slots);
      if (smem > (size_t)MAX_SMEM) return 0;
      const int blocks = std::min((int)(SM_SMEM / (smem + 1024)), SM_THREADS / L::THREADS);
      if (blocks * L::TR > best_rows) {
        best_rows = blocks * L::TR;
        best = Plan{t, round_up(d, L::DC), smem};
      }
      return 0;
    });
  }
  return best;
}

__host__ inline bool wide_in_domain(int b, int n, int d, int k) {
  return b >= 1 && b <= 65535 && n >= 1 && n <= WIDE_MAX_N && (long long)b * n <= INT_MAX &&
         d >= 1 && d <= WIDE_MAX_D && k >= 1 && k <= n;
}

// The radix route's scratch: a row's stride in words (its n keys, rounded
// to 16 bytes, then, where 2^m >= k passes SORT_CAP, its sort's 2^m
// composites), the rows of a group (GROUP_WORDS over the b clouds, at least
// one), and knn_radix_kernel's shared bytes.
__host__ inline long long radix_stride(int n, int k) {
  const int p2 = pow2_at_least(k);
  return round_up(n, 4) + (p2 > SORT_CAP ? 2LL * p2 : 0LL);
}

__host__ inline int radix_group(int b, int n, int k, int rows) {
  const long long g = GROUP_WORDS / ((long long)b * radix_stride(n, k));
  return (int)std::max(1LL, std::min((long long)rows, g));
}

__host__ inline size_t radix_smem(int k) {
  const int p2 = pow2_at_least(k);
  return sizeof(unsigned long long) * ((p2 <= SORT_CAP ? p2 : 0) + CAND_CAP) +
         sizeof(int) * (RADIX_BINS + RADIX_MAX_WARPS + 3 + 2);
}

// A wide launch's scratch in floats: the prep's copy and norms (n
// (round_up(d, 16) + 1) a cloud) and, for k > WIDE_MAX_K, a group's keys
// after them, 16-byte aligned.
__host__ inline long long wide_work_floats(int b, int n, int d, int k, int rows) {
  const long long prep = (long long)b * n * (round_up(d, 16) + 1);
  if (k <= WIDE_MAX_K) return prep;
  return (prep + 3) / 4 * 4 + (long long)b * radix_group(b, n, k, rows) * radix_stride(n, k);
}

// knn_keys_kernel's column chunks over a group: whole tiles, enough chunks
// that the group's row tiles and clouds make about KEYS_BLOCKS_PER_SM blocks
// an SM (at most 65,535: the grid's y).
struct Chunks {
  int tiles, count;
};

__host__ inline Chunks key_chunks(int ntiles, int row_tiles, int b, int sms) {
  const long long have = (long long)row_tiles * b;
  const long long want = (long long)KEYS_BLOCKS_PER_SM * sms;
  const int count = (int)std::min<long long>(std::min(ntiles, 65535),
                                             std::max(1LL, (want + have - 1) / have));
  const int tiles = (ntiles + count - 1) / count;
  return Chunks{tiles, (ntiles + tiles - 1) / tiles};
}

// f(std::integral_constant<int, T>) for knn_radix_kernel's block at n keys a row.
template <class F>
auto with_radix_block(int n, F&& f) {
  if (n >= LONG_ROW) return f(std::integral_constant<int, RADIX_THREADS_LONG>{});
  return f(std::integral_constant<int, RADIX_THREADS>{});
}

__host__ inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// The radix route after the prep (plan p): for each group of rows, the key
// sweep, then one selection block a row.  The keys follow the prep's copy
// and norms in work.
__host__ inline cudaError_t radix_launch(const float* xp, const float* sq, int* idx, float* work,
                                         int b, int n, const Plan& p, int k, int row_begin,
                                         int rows, cudaStream_t s) {
  unsigned* keys = reinterpret_cast<unsigned*>(work) +
                   ((size_t)b * n * p.dx + (size_t)b * n + 3) / 4 * 4;
  const long long stride = radix_stride(n, k);
  const int group = radix_group(b, n, k, rows);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  return with_wide_tile(p.tile, [&](auto tile) {
    using L = decltype(tile);
    return with_radix_block(n, [&](auto threads) {
      constexpr int T = decltype(threads)::value;
      cudaError_t e = allow_smem<knn_keys_kernel<L>>();
      if (e == cudaSuccess) e = allow_smem<knn_radix_kernel<T>>();
      if (e != cudaSuccess) return e;
      const int ntiles = (n + L::TC - 1) / L::TC;
      for (int g0 = 0; g0 < rows; g0 += group) {
        const int gr = std::min(group, rows - g0);
        const int row_tiles = (gr + L::TR - 1) / L::TR;
        const Chunks ch = key_chunks(ntiles, row_tiles, b, sms);
        knn_keys_kernel<L><<<dim3(row_tiles, ch.count, b), L::THREADS, p.smem, s>>>(
            xp, sq, keys, stride, n, p.dx, row_begin + g0, gr, ch.tiles);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
        knn_radix_kernel<T><<<dim3(gr, b), T, radix_smem(k), s>>>(keys, stride, idx, n, k, gr,
                                                                  rows, g0);
        e = cudaGetLastError();
        if (e != cudaSuccess) return e;
      }
      return cudaSuccess;
    });
  });
}

// The wide route on x [b, n, d] of element type T, for rows row_begin ..
// row_begin + rows - 1; work holds wide_work_floats(b, n, d, k, rows).
template <typename T>
int knn_wide_entry(const T* x, int* idx, float* work, int b, int n, int d, int k, int row_begin,
                   int rows, void* stream) {
  if (!wide_in_domain(b, n, d, k) || !valid_rows(n, row_begin, rows))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = wide_plan_of(d, k);
  float* xp = work;
  float* sq = work + (size_t)b * n * p.dx;
  const int points = b * n;
  if (d <= MAX_D)
    knn_prep_kernel<T><<<(points + PREP_POINTS - 1) / PREP_POINTS, PREP_THREADS, 0, s>>>(
        x, xp, sq, points, d, p.dx);
  else
    knn_prep_wide_kernel<T><<<(points + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32),
                              PREP_THREADS, 0, s>>>(x, xp, sq, points, d, p.dx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (k > WIDE_MAX_K) return (int)radix_launch(xp, sq, idx, work, b, n, p, k, row_begin, rows, s);
  return (int)with_wide_tile(p.tile, [&](auto tile) {
    using L = decltype(tile);
    cudaError_t e = allow_smem<knn_wide_kernel<L>>();
    if (e != cudaSuccess) return e;
    const dim3 grid((rows + L::TR - 1) / L::TR, b);
    knn_wide_kernel<L><<<grid, L::THREADS, p.smem, s>>>(xp, sq, idx, n, p.dx, k, row_begin, rows);
    return cudaGetLastError();
  });
}

}  // namespace

// x [b, n, d] fp32 and idx [b, rows, k] int32, both contiguous on the
// device, and work, scratch of n (round_up(d, 16) + 1) floats per cloud:
// the k nearest of all n points for each of rows row_begin .. row_begin +
// rows - 1 (rows = n, row_begin = 0: the whole cloud).  Returns the
// cudaError_t of the launches.
extern "C" int hpcs_knn(const float* x, int* idx, float* work, int b, int n, int d, int k,
                        int row_begin, int rows, void* stream) {
  return knn_entry(x, idx, work, b, n, d, k, row_begin, rows, stream);
}

// The same for x [b, n, d] bf16.
extern "C" int hpcs_knn_bf16(const __nv_bfloat16* x, int* idx, float* work, int b, int n, int d,
                             int k, int row_begin, int rows, void* stream) {
  return knn_entry(x, idx, work, b, n, d, k, row_begin, rows, stream);
}

// The launch geometry of hpcs_knn at (b, n, d, k) over `rows` rows, into
// out[11]: knn_kernel's grid x and y, threads, dynamic shared bytes, resident
// blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers,
// local (spill) bytes a thread, rows and columns of its tile, the padded row
// width dx, and knn_prep_kernel's blocks.  Returns a cudaError_t.
extern "C" int hpcs_knn_geometry(int b, int n, int d, int k, int rows, int* out) {
  if (!in_domain(b, n, d, k) || !valid_rows(n, 0, rows)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(n, d);
  return (int)with_tile(p.tile, [&](auto tile) {
    using L = decltype(tile);
    cudaError_t err = allow_smem<knn_kernel<L>>();
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, knn_kernel<L>);
    if (err != cudaSuccess) return err;
    int resident = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, knn_kernel<L>, L::THREADS,
                                                        p.smem);
    if (err != cudaSuccess) return err;
    const int values[] = {(rows + L::TR - 1) / L::TR, b, L::THREADS, (int)p.smem, resident,
                          attr.numRegs, (int)attr.localSizeBytes, L::TR, L::TC, p.dx,
                          (b * n + PREP_POINTS - 1) / PREP_POINTS};
    for (int q = 0; q < 11; ++q) out[q] = values[q];
    return cudaSuccess;
  });
}

// The wide route: x [b, n, d] fp32 and idx [b, rows, k] int32, both
// contiguous on the device, rows as hpcs_knn's and work, scratch of
// hpcs_knn_wide_work(b, n, d, k, rows) floats; any n <= 2^30 (b n <= 2^31 -
// 1), d <= 2^20 and k <= n.  Returns the cudaError_t of the launches.
extern "C" int hpcs_knn_wide(const float* x, int* idx, float* work, int b, int n, int d, int k,
                             int row_begin, int rows, void* stream) {
  return knn_wide_entry(x, idx, work, b, n, d, k, row_begin, rows, stream);
}

// The same for x [b, n, d] bf16.
extern "C" int hpcs_knn_wide_bf16(const __nv_bfloat16* x, int* idx, float* work, int b, int n,
                                  int d, int k, int row_begin, int rows, void* stream) {
  return knn_wide_entry(x, idx, work, b, n, d, k, row_begin, rows, stream);
}

// The floats of scratch hpcs_knn_wide takes at (b, n, d, k) over `rows`
// rows, into out[0]: n (round_up(d, 16) + 1) a cloud and, for k > 256, the
// radix route's keys of a group of rows.  Returns a cudaError_t.
extern "C" int hpcs_knn_wide_work(int b, int n, int d, int k, int rows, long long* out) {
  if (!wide_in_domain(b, n, d, k) || !valid_rows(n, 0, rows)) return (int)cudaErrorInvalidValue;
  *out = wide_work_floats(b, n, d, k, rows);
  return cudaSuccess;
}

// The launch geometry of hpcs_knn_wide at (b, n, d, k) over `rows` rows,
// into out[22]: the score kernel's grid x and y, threads, dynamic shared
// bytes, resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers, local (spill) bytes a thread, rows and columns of its tile,
// the padded row width dx, the prep kernel's blocks, the ring's stages and
// a row list's slots (32 S; 0 on the radix route); then 1 for the radix
// route (k > 256), else 0, and for it: knn_keys_kernel's column chunks (its
// grid's y; the clouds its z), the rows of a group (grid x above: their row
// tiles), the groups, and knn_radix_kernel's threads, shared bytes,
// resident blocks per SM, registers and local bytes (its grid: a group's
// rows by b).  The
// wide kernel reports 1 chunk, one group of all rows and zeros.  Returns a
// cudaError_t.
extern "C" int hpcs_knn_wide_geometry(int b, int n, int d, int k, int rows, int* out) {
  if (!wide_in_domain(b, n, d, k) || !valid_rows(n, 0, rows)) return (int)cudaErrorInvalidValue;
  const Plan p = wide_plan_of(d, k);
  const int prep = d <= MAX_D ? (b * n + PREP_POINTS - 1) / PREP_POINTS
                              : (b * n + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32);
  const bool radix = k > WIDE_MAX_K;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  int sel[5] = {0, 0, 0, 0, 0};
  if (radix) {
    err = with_radix_block(n, [&](auto threads) {
      constexpr int T = decltype(threads)::value;
      cudaFuncAttributes attr;
      const size_t smem = radix_smem(k);
      cudaError_t e = allow_smem<knn_radix_kernel<T>>();
      if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, knn_radix_kernel<T>);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sel[2], knn_radix_kernel<T>, T, smem);
      sel[0] = T;
      sel[1] = (int)smem;
      sel[3] = attr.numRegs;
      sel[4] = (int)attr.localSizeBytes;
      return e;
    });
    if (err != cudaSuccess) return (int)err;
  }
  return (int)with_wide_tile(p.tile, [&](auto tile) {
    using L = decltype(tile);
    cudaFuncAttributes attr;
    int resident = 0;
    auto query = [&](auto kernel, cudaError_t allowed) {
      cudaError_t q = allowed;
      if (q == cudaSuccess) q = cudaFuncGetAttributes(&attr, kernel);
      if (q == cudaSuccess)
        q = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, L::THREADS, p.smem);
      return q;
    };
    const cudaError_t e = radix ? query(knn_keys_kernel<L>, allow_smem<knn_keys_kernel<L>>())
                                : query(knn_wide_kernel<L>, allow_smem<knn_wide_kernel<L>>());
    if (e != cudaSuccess) return e;
    const int group = radix ? radix_group(b, n, k, rows) : rows;
    const int row_tiles = (group + L::TR - 1) / L::TR;
    const int chunks = radix ? key_chunks((n + L::TC - 1) / L::TC, row_tiles, b, sms).count : 1;
    const int values[] = {row_tiles, b, L::THREADS, (int)p.smem, resident, attr.numRegs,
                          (int)attr.localSizeBytes, L::TR, L::TC, p.dx, prep, L::STAGES,
                          radix ? 0 : round_up(k, 32), radix ? 1 : 0, chunks, group,
                          (rows + group - 1) / group, sel[0], sel[1], sel[2], sel[3], sel[4]};
    for (int q = 0; q < 22; ++q) out[q] = values[q];
    return cudaSuccess;
  });
}

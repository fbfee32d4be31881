// Batched symmetric eigendecomposition by parallel-order cyclic Jacobi,
// one thread block per matrix, for NVIDIA Hopper (sm_90a).
//
// Replaces: sella_tpu/ops/pallas_eigh.py::_jacobi_kernel (driven there by
// jacobi_eigh_tpu). The plain PyTorch version of the same algorithm is
// sella_tpu_torch/ops/linalg.py::jacobi_eigh, which the wrapper in
// sella_tpu_torch/ops/jacobi_eigh.py uses for CPU tensors and which the
// tests hold this kernel against.
//
// What it computes: for each (n, n) matrix, `sweeps` sweeps of (m - 1)
// rounds (m = n rounded up to even; an odd n is padded with one decoupled
// 1e30 diagonal entry that stays an exact eigenpair and sorts last). Each
// round applies m/2 simultaneous classical-angle Givens rotations to the
// disjoint index pairs of the round-robin tournament schedule (the same
// pairs in the same order as the plain version: pair_schedule() in the
// wrapper states them), from the left and the right, and accumulates the
// right rotations into V. Eigenvalues come out ascending with their
// eigenvector columns in matching order. The solve is float32; input is
// float32 or float64 read through the caller's strides, output is written
// in the caller's dtype.
//
// What bounds it on this card. By the card's peaks it is bound by
// operations: 27.1 GFLOP at (1024, 72, 72) over 67 TFLOP/s of float32 is
// 0.405 ms, against 0.013 ms for the 43 MB it moves. A Givens rotation is
// scalar work on pairs, so the tensor cores do not apply. In practice two
// SM limits sit well above that bound and close to each other. Shared
// memory serves one 128-byte wavefront a clock an SM, and a round reads
// and writes every entry it rotates. The schedulers start four warp
// instructions a clock an SM, and a 2x2 block of A costs about 30
// instructions for its 16 arithmetic ones. Builds with parts taken out,
// timed on the card (PERF.md section 6), showed that rotating V in
// shared memory ran at 90% of the wavefront rate, and that a 128-bit
// load of 8 distinct table entries by a warp costs 4 wavefronts, not 1.
//
// What the design does about it, for the main path's size (m = 72, a
// compile-time constant; jacobi_eigh_fixed below).
// * A stays in shared memory for the whole solve with original labels and
//   is updated in place: a round moves each entry of A once each way and
//   nothing else. Device memory is read once and written once; the casts
//   and the strided read are part of that one pass.
// * V is not in shared memory at all. Its rows are independent and a
//   round only mixes the two columns of each pair, so each of the 288
//   threads keeps, for two rows of V, the entries of both members of five
//   consecutive pair slots in registers (20 values), rotates them with
//   the (c, s) it loads anyway for its blocks of A, and hands one entry a
//   row to each neighbour when the tournament advances (two shuffles a
//   row). That removes 40% of the shared-memory traffic of a round and
//   halves the block's shared memory (23 KB), at 56 registers a thread:
//   registers, not shared memory, now set four blocks an SM, and 1024
//   matrices are 1.94 waves of 528.
// * The blocks of A are a 36 x 36 grid of (row pair, column pair). Warp
//   w owns column pairs 4w .. 4w + 3 for the whole solve, so a lane's
//   column angle and indices sit in registers through the round; the
//   lane's five row pairs are consecutive slots, whose table entries are
//   one 128-bit load each. No item index is ever divided: m, the strides
//   and the trip counts are constants and the loops unroll.
// * The row stride S is the least S >= m with S mod 8 == 4 (76 for 72).
//   In one step the 8 lane groups of a warp touch rows 5 slots apart and
//   its 4 lanes a group touch neighbouring columns; labels of neighbouring
//   slots are neighbours, so rows land 5 * 76 = 28 (mod 32) banks apart:
//   {0, 28, 24, ..., 4}, the 4 columns fill the gaps, and all 32 lanes
//   hit different banks, except in the step where the slot table wraps
//   from label m - 1 to label 1.
// * The slot table advances by one step a round (a counter with a wrap),
//   not by a modulo per item.
// * Angles: one thread per pair computes (c, s) from the pre-round
//   diagonal block and writes (c, s, p, q) to a 16-byte table entry; a
//   barrier; the update; a barrier. Other blocks on the SM fill the gaps.
//   Having every warp compute all angles itself and hand them out with
//   shuffles would save a barrier and cost nine times the divisions and
//   square roots; and shuffles go through the same pipe as shared-memory
//   loads (handing the table out by shuffle was measured 24% slower than
//   loading it).
// * Symmetry is not used: updating only j >= i and mirroring saves loads
//   and arithmetic on A but not the stores, unbalances the grid between
//   warps, reads only one triangle of an input that is symmetric only to
//   rounding, and shared memory no longer limits the blocks an SM.
// * The TPU kernel's layout (pairs adjacent, data moved by a fixed
//   permutation each round) is what V now has, in registers, where the
//   move is a register rename and two shuffles. For A it was not taken:
//   moving A needs a second copy or two more barriers a round, and in
//   place the permutation is index arithmetic paid once per table entry.
// * No fast-math: t must be exactly 0 for the odd-n pad, and the angle
//   uses IEEE division and square root like the plain version.
//
// Every other n <= 128 (jacobi_eigh_any): m read at run time, A and V
// both in shared memory (up to 136 KB at n = 128), the same tiles of 8
// row pairs x 4 column pairs dealt to 8 warps round-robin, V's row pairs
// as further rows of the grid rotated from the right only.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kTileUnits = 8;  // row pairs per warp tile
constexpr int kTileCols = 4;   // column pairs per warp tile
// Resident blocks an SM of the compile-time-m kernel: caps it at 56
// registers. Five (40 registers) spills V and was measured 15% slower.
constexpr int kFixedMinBlocks = 4;

// Row stride in words: least S >= m with S % 8 == 4 (see the note above).
__host__ __device__ constexpr int row_stride(int m) {
  return ((m + 3) / 8) * 8 + 4;
}

// Player at slot j of the round-robin schedule after rmod steps: slot 0
// is fixed, the other m - 1 players move one slot to the right a round.
// 0 <= rmod < m - 1, so one conditional add wraps.
__device__ __forceinline__ int player(int j, int rmod, int m) {
  if (j == 0) return 0;
  int x = j - 1 - rmod;
  if (x < 0) x += m - 1;
  return 1 + x;
}

// Sort key with NaN last, so ranks stay a permutation.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na == nb) ? ia < ib : nb;
  return a < b || (a == b && ia < ib);
}

// One 2x2 block: rows at word offsets rp, rq of `X`, columns p2, q2.
// LEFT: rotate the rows by (ci, si) first (A); always rotate the columns
// by (cj, sj) (A and V).
template <bool LEFT>
__device__ __forceinline__ void rotate_block(float* __restrict__ X, int rp,
                                             int rq, float ci, float si,
                                             int p2, int q2, float cj,
                                             float sj) {
  float a00 = X[rp + p2], a01 = X[rp + q2];
  float a10 = X[rq + p2], a11 = X[rq + q2];
  if (LEFT) {
    // row p <- c r_p - s r_q, row q <- s r_p + c r_q
    const float l00 = ci * a00 - si * a10, l01 = ci * a01 - si * a11;
    const float l10 = si * a00 + ci * a10, l11 = si * a01 + ci * a11;
    a00 = l00; a01 = l01; a10 = l10; a11 = l11;
  }
  X[rp + p2] = cj * a00 - sj * a01;
  X[rp + q2] = sj * a00 + cj * a01;
  X[rq + p2] = cj * a10 - sj * a11;
  X[rq + q2] = sj * a10 + cj * a11;
}

// One pass over device memory: strided read, cast to float32, pad an odd
// n with a decoupled 1e30 entry. The faster index follows whichever
// stride is 1. V (m rows of S words) is set to the identity if given.
template <typename T, int THREADS>
__device__ __forceinline__ void load_matrix(const T* __restrict__ Ab,
                                            long long sr, long long sc,
                                            float* __restrict__ A,
                                            float* __restrict__ V, int n,
                                            int m, int S) {
  const bool col_major = (sr == 1 && sc != 1);
  for (int t = threadIdx.x; t < m * m; t += THREADS) {
    const int hi = t / m, lo = t % m;
    const int r = col_major ? lo : hi, c = col_major ? hi : lo;
    float a;
    if (r < n && c < n) {
      a = static_cast<float>(Ab[r * sr + c * sc]);
    } else {
      a = (r == c) ? 1e30f : 0.0f;
    }
    A[r * S + c] = a;
    if (V != nullptr) V[r * S + c] = (r == c) ? 1.0f : 0.0f;
  }
}

// The angle phase of a round: thread i < h computes the rotation of pair
// i from the pre-round matrix and writes (c, s, p, q) to tbl[i].
template <int THREADS>
__device__ __forceinline__ void compute_angles(const float* __restrict__ A,
                                               float4* __restrict__ tbl,
                                               int h, int m, int S,
                                               int rmod) {
  for (int i = threadIdx.x; i < h; i += THREADS) {
    const int p = player(i, rmod, m);
    const int q = player(m - 1 - i, rmod, m);
    const float app = A[p * S + p];
    const float aqq = A[q * S + q];
    const float apq = A[p * S + q];
    float c = 1.0f, s = 0.0f;  // a_pq == 0: no rotation
    if (apq != 0.0f) {
      // classical angle: tan(2 theta) = 2 a_pq / (a_qq - a_pp)
      const float tau = (aqq - app) / (2.0f * apq);
      const float t = (tau == 0.0f)
                          ? 1.0f  // a_pp == a_qq: rotate 45 degrees
                          : copysignf(1.0f, tau) /
                                (fabsf(tau) + sqrtf(1.0f + tau * tau));
      c = 1.0f / sqrtf(1.0f + t * t);
      s = t * c;
    }
    tbl[i] = make_float4(c, s, __int_as_float(p), __int_as_float(q));
  }
}

// Ascending order of the diagonal, ties by label (a stable argsort):
// inv[rank] = label, and rnk[label] = rank if rnk is given.
template <int THREADS>
__device__ __forceinline__ void rank_diagonal(const float* __restrict__ A,
                                              int* __restrict__ inv,
                                              int* __restrict__ rnk, int m,
                                              int S) {
  for (int k = threadIdx.x; k < m; k += THREADS) {
    const float dk = A[k * S + k];
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      rank += before(A[j * S + j], j, dk, k) ? 1 : 0;
    }
    inv[rank] = k;
    if (rnk != nullptr) rnk[k] = rank;
  }
}

// ---------------------------------------------------------------------
// Any even m <= 128, read at run time: A and V in shared memory, a warp
// per tile of 8 units x 4 column pairs, tiles dealt round-robin.
// ---------------------------------------------------------------------
constexpr int kAnyThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kAnyThreads, 3)
jacobi_eigh_any(const T* __restrict__ A_in, long long sb, long long sr,
                long long sc, T* __restrict__ w_out, T* __restrict__ V_out,
                int n, int m, int sweeps) {
  extern __shared__ __align__(16) float smem[];
  const int h = m / 2;
  const int S = row_stride(m);
  float* A = smem;                 // m rows of S words
  float* V = A + m * S;            // m rows of S words, rows = input basis
  float4* tbl = reinterpret_cast<float4*>(V + m * S);  // h: (c, s, p, q)
  int* inv = reinterpret_cast<int*>(tbl + h);          // m: rank -> label

  const int tid = threadIdx.x;
  load_matrix<T, kAnyThreads>(A_in + static_cast<long long>(blockIdx.x) * sb,
                              sr, sc, A, V, n, m, S);
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int ul = lane / kTileCols, jl = lane % kTileCols;
  const int n_ut = (2 * h + kTileUnits - 1) / kTileUnits;
  const int n_jt = (h + kTileCols - 1) / kTileCols;

  const int rounds = sweeps * (m - 1);
  int rmod = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    compute_angles<kAnyThreads>(A, tbl, h, m, S, rmod);
    __syncthreads();
    // 2x2 blocks of A (units below h: rotation pair u, both sides) and of
    // V (units h..2h-1: rows u - h and u, right side only). All touched
    // entries are disjoint.
    for (int it = warp; it < n_ut * n_jt; it += kAnyThreads / 32) {
      const int ut = it / n_jt, jt = it - ut * n_jt;
      const int u = ut * kTileUnits + ul, j = jt * kTileCols + jl;
      if (j < h) {
        const float4 col = tbl[j];
        const int p2 = __float_as_int(col.z), q2 = __float_as_int(col.w);
        if (u < h) {
          const float4 row = tbl[u];
          rotate_block<true>(A, __float_as_int(row.z) * S,
                             __float_as_int(row.w) * S, row.x, row.y, p2, q2,
                             col.x, col.y);
        } else if (u < 2 * h) {
          rotate_block<false>(V, (u - h) * S, u * S, 1.0f, 0.0f, p2, q2,
                              col.x, col.y);
        }
      }
    }
    __syncthreads();
    rmod = (rmod + 1 == m - 1) ? 0 : rmod + 1;
  }

  rank_diagonal<kAnyThreads>(A, inv, nullptr, m, S);
  __syncthreads();

  T* wb = w_out + static_cast<long long>(blockIdx.x) * n;
  T* Vb = V_out + static_cast<long long>(blockIdx.x) * n * n;
  for (int c = tid; c < n; c += kAnyThreads) {
    const int k = inv[c];
    wb[c] = static_cast<T>(A[k * S + k]);
  }
  for (int t = tid; t < n * n; t += kAnyThreads) {
    const int r = t / n, c = t - r * n;
    Vb[t] = static_cast<T>(V[r * S + inv[c]]);
  }
}

size_t smem_bytes_any(int m) {
  return sizeof(float) * 2 * static_cast<size_t>(m) * row_stride(m) +
         sizeof(float4) * (m / 2) + sizeof(int) * m;
}

// ---------------------------------------------------------------------
// Compile-time m (the main path's 72): A in shared memory, V in registers.
// ---------------------------------------------------------------------
// H = M / 2 pairs. The block has H / 4 warps; warp w owns column pairs
// 4w .. 4w + 3 (lane % 4) of A for the whole solve. Lane group g = lane / 4
// owns the kUnits consecutive pair slots g * kUnits + k of A's rows, and,
// for the two V rows 4w + lane % 4 and that plus H, the V entries of both
// members of those slots. So the (c, s) a lane loads to rotate its A
// blocks from the left are the ones that rotate its V entries, and V
// costs no shared-memory traffic but the hand-over below.
//
// V is held by slot, not by label: top[k] is the entry in the column of
// the label now at slot g * kUnits + k, bot[k] the one at the mirrored
// slot M - 1 - (g * kUnits + k); the two are a rotation pair. Between
// rounds every label but slot 0's moves one slot to the right, so the
// registers shift by one and each lane hands its last top entry to the
// next group and its first bottom entry to the previous one (one shuffle
// each per row).
template <typename T, int M>
__global__ void __launch_bounds__(M / 2 / kTileCols * 32, kFixedMinBlocks)
jacobi_eigh_fixed(const T* __restrict__ A_in, long long sb, long long sr,
                  long long sc, T* __restrict__ w_out, T* __restrict__ V_out,
                  int n, int /*m*/, int sweeps) {
  constexpr int H = M / 2;
  constexpr int S = row_stride(M);
  constexpr int THREADS = H / kTileCols * 32;
  constexpr int kGroups = 32 / kTileCols;               // 8 lane groups
  constexpr int kUnits = (H + kGroups - 1) / kGroups;   // slots per group
  constexpr unsigned kFull = 0xffffffffu;
  static_assert(M % (2 * kTileCols) == 0, "whole column tiles");
  static_assert((kGroups - 1) * kUnits < H, "every group owns a slot");
  static_assert((S * kUnits) % 8 == 4, "rows of a step on distinct banks");

  extern __shared__ __align__(16) float smem[];
  float* A = smem;                                     // M rows of S words
  float4* tbl = reinterpret_cast<float4*>(A + M * S);  // H: (c, s, p, q)
  int* inv = reinterpret_cast<int*>(tbl + H);          // M: rank -> label
  int* rnk = inv + M;                                  // M: label -> rank

  const int tid = threadIdx.x;
  load_matrix<T, THREADS>(A_in + static_cast<long long>(blockIdx.x) * sb, sr,
                          sc, A, nullptr, n, M, S);

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane / kTileCols, jl = lane % kTileCols;
  const int j = warp * kTileCols + jl;   // column pair of A; first V row
  const int u0 = g * kUnits;             // first pair slot of this lane

  // V = identity, by slot: at round 0 slot s holds label s.
  float top[2][kUnits], bot[2][kUnits];
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = j + r * H;
      top[r][k] = (row == u0 + k) ? 1.0f : 0.0f;
      bot[r][k] = (row == M - 1 - (u0 + k)) ? 1.0f : 0.0f;
    }
  }
  __syncthreads();

  const int rounds = sweeps * (M - 1);
  int rmod = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    compute_angles<THREADS>(A, tbl, H, M, S, rmod);
    __syncthreads();

    const float4 col = tbl[j];
    const int p2 = __float_as_int(col.z), q2 = __float_as_int(col.w);
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if (u0 + k < H) {
        const float4 row = tbl[u0 + k];
        rotate_block<true>(A, __float_as_int(row.z) * S,
                           __float_as_int(row.w) * S, row.x, row.y, p2, q2,
                           col.x, col.y);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float vp = top[r][k], vq = bot[r][k];
          top[r][k] = row.x * vp - row.y * vq;
          bot[r][k] = row.y * vp + row.x * vq;
        }
      }
    }

    // Labels move one slot to the right; slot 0 stays, slot M - 1 wraps
    // to slot 1. The last group owns slot H - 1 (its top[0]) and H (its
    // bot[0]) only.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float up = __shfl_up_sync(kFull, top[r][kUnits - 1], kTileCols);
      const float dn = __shfl_down_sync(kFull, bot[r][0], kTileCols);
      const float t0 = top[r][0], b0 = bot[r][0];
#pragma unroll
      for (int k = kUnits - 1; k >= 2; --k) top[r][k] = top[r][k - 1];
      top[r][1] = (g == 0) ? b0 : t0;
      top[r][0] = (g == 0) ? t0 : up;
#pragma unroll
      for (int k = 0; k + 1 < kUnits; ++k) bot[r][k] = bot[r][k + 1];
      bot[r][kUnits - 1] = dn;
      if (g == kGroups - 1) bot[r][0] = t0;
    }
    __syncthreads();
    rmod = (rmod + 1 == M - 1) ? 0 : rmod + 1;
  }

  rank_diagonal<THREADS>(A, inv, rnk, M, S);
  __syncthreads();
  T* wb = w_out + static_cast<long long>(blockIdx.x) * n;
  T* Vb = V_out + static_cast<long long>(blockIdx.x) * n * n;
  for (int c = tid; c < n; c += THREADS) {
    const int k = inv[c];
    wb[c] = static_cast<T>(A[k * S + k]);
  }
  __syncthreads();
  // A is done: its rows take V, each entry at the rank of its label.
#pragma unroll
  for (int k = 0; k < kUnits; ++k) {
    if (u0 + k < H) {
      const int ct = rnk[player(u0 + k, rmod, M)];
      const int cb = rnk[player(M - 1 - (u0 + k), rmod, M)];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        A[(j + r * H) * S + ct] = top[r][k];
        A[(j + r * H) * S + cb] = bot[r][k];
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < n * n; t += THREADS) {
    const int r = t / n, c = t - r * n;
    Vb[t] = static_cast<T>(A[r * S + c]);
  }
}

template <int M>
constexpr size_t smem_bytes_fixed() {
  return sizeof(float) * M * row_stride(M) + sizeof(float4) * (M / 2) +
         sizeof(int) * 2 * M;
}

struct Variant {
  const void* fn;
  int threads;
  size_t smem;
};

// The kernel that serves padded size m in dtype T.
template <typename T>
Variant variant_of(int m) {
  if (m == 72) {
    return {reinterpret_cast<const void*>(jacobi_eigh_fixed<T, 72>),
            72 / 2 / kTileCols * 32, smem_bytes_fixed<72>()};
  }
  return {reinterpret_cast<const void*>(jacobi_eigh_any<T>), kAnyThreads,
          smem_bytes_any(m)};
}

// Opt in to the shared memory a block needs (above 48 KB from m = 78) and
// ask for the largest shared-memory carveout.
cudaError_t prepare(const Variant& v) {
  cudaError_t err = cudaFuncSetAttribute(
      v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(v.smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      v.fn, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// A: `batch` matrices (n, n) of float32 (is_double == 0) or float64, read
// at A[b * sb + r * sr + c * sc] (strides in elements, of any size).
// w: (batch, n) and V: (batch, n, n), contiguous, of A's type.
// Returns the cudaError_t of the launch (0 on success); launches nothing
// for batch == 0.
extern "C" int sella_jacobi_eigh(const void* A, long long sb, long long sr,
                                 long long sc, void* w, void* V, int batch,
                                 int n, int sweeps, int is_double,
                                 void* stream) {
  if (n < 1 || n > kMaxN || batch < 0 || sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  int m = n + (n & 1);
  const Variant v = is_double ? variant_of<double>(m) : variant_of<float>(m);
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&A, &sb, &sr, &sc, &w, &V, &n, &m, &sweeps};
  err = cudaLaunchKernel(v.fn, dim3(batch), dim3(v.threads), args, v.smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What a launch of size n runs with, for the timing scripts:
// out[0] = resident blocks per SM, out[1] = registers per thread,
// out[2] = dynamic shared bytes per block, out[3] = threads per block.
extern "C" int sella_jacobi_eigh_occupancy(int n, int is_double, int* out) {
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  const int m = n + (n & 1);
  const Variant v = is_double ? variant_of<double>(m) : variant_of<float>(m);
  cudaError_t err = prepare(v);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, v.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, v.fn,
                                                      v.threads, v.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = static_cast<int>(v.smem);
  out[3] = v.threads;
  return 0;
}

// Batched symmetric eigendecomposition by parallel-order cyclic Jacobi,
// one thread block per matrix, for NVIDIA Hopper (sm_90a).
//
// Replaces: sella_tpu/ops/pallas_eigh.py::_jacobi_kernel (driven there by
// jacobi_eigh_tpu). The plain PyTorch version of the same algorithm is
// sella_tpu_torch/ops/linalg.py::jacobi_eigh, which the wrapper in
// sella_tpu_torch/ops/jacobi_eigh.py uses for CPU tensors and which the
// tests hold this kernel against.
//
// What it computes: for each (n, n) matrix, 8 sweeps of (m - 1) rounds
// (m = n rounded up to even; an odd n is padded with one decoupled 1e30
// diagonal entry that stays an exact eigenpair and sorts last). Each round
// applies m/2 simultaneous Givens rotations to disjoint index pairs taken
// from the round-robin tournament schedule, from the left and the right,
// and accumulates the right rotations into V. Eigenvalues come out
// ascending with their eigenvector columns in matching order, in float32.
//
// What bounds it on this card: not FLOPs. For m = 72 there are
// 8 * 71 = 568 dependent rounds per matrix, each a pass over the whole
// matrix with a barrier between the angle computation and the update.
// The time is the latency of those rounds and the shared-memory traffic
// of each pass (about 8 * m^2 words per round).
//
// What the design does about it: A and V stay in shared memory for the
// whole solve (2 * 72 * 72 * 4 B = 41.5 KB for the bench shape, 128 KB at
// the n = 128 limit), so device memory is read once and written once.
// Each round is two phases separated by __syncthreads(): one thread per
// pair computes the rotation from the diagonal and the pair coupling, then
// every thread updates whole 2x2 blocks (left and right rotation fused, so
// A is read and written once per round) and pairs of V columns. The
// pairing of a round is index arithmetic on the round number; the TPU
// kernel's rolls and relabelling permutation have no counterpart here.
// Blocks are independent, so the batch fills the 132 SMs; about five
// blocks of 41.5 KB fit on one SM at m = 72.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 128;

// Player at slot j of the round-robin schedule after r rotations: slot 0
// is fixed, the other m - 1 players move one slot to the right per round.
__device__ __forceinline__ int player(int j, int rmod, int m) {
  if (j == 0) return 0;
  return 1 + (j - 1 - rmod + (m - 1)) % (m - 1);
}

// Sort key with NaN last, so ranks stay a permutation.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return (na == nb) ? ia < ib : nb;
  return a < b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kThreads)
jacobi_eigh_kernel(const float* __restrict__ A_in, float* __restrict__ w_out,
                   float* __restrict__ V_out, int n, int m, int sweeps) {
  extern __shared__ float smem[];
  const int h = m / 2;
  float* A = smem;                 // m * m, row-major
  float* V = A + m * m;            // m * m, rows = input basis
  float* cs = V + m * m;           // h rotation cosines
  float* sn = cs + h;              // h rotation sines
  int* pp = reinterpret_cast<int*>(sn + h);  // h first members
  int* qq = pp + h;                          // h second members
  int* inv = qq + h;                         // m: output slot -> label

  const int b = blockIdx.x;
  const float* Ab = A_in + static_cast<size_t>(b) * n * n;

  for (int t = threadIdx.x; t < m * m; t += blockDim.x) {
    const int r = t / m, c = t % m;
    float a;
    if (r < n && c < n) {
      a = Ab[r * n + c];
    } else {
      a = (r == c) ? 1e30f : 0.0f;  // odd-n pad: decoupled huge entry
    }
    A[t] = a;
    V[t] = (r == c) ? 1.0f : 0.0f;
  }
  __syncthreads();

  const int rounds = sweeps * (m - 1);
  for (int rd = 0; rd < rounds; ++rd) {
    const int rmod = rd % (m - 1);
    // Phase 1: one rotation per pair, from the pre-round matrix.
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      const int p = player(i, rmod, m);
      const int q = player(m - 1 - i, rmod, m);
      const float app = A[p * m + p];
      const float aqq = A[q * m + q];
      const float apq = A[p * m + q];
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
      cs[i] = c;
      sn[i] = s;
      pp[i] = p;
      qq[i] = q;
    }
    __syncthreads();

    // Phase 2: 2x2 blocks of A (rows of pair i, columns of pair j),
    // then pairs of V columns. All touched entries are disjoint.
    const int nblk = h * h;
    const int total = nblk + m * h;
    for (int t = threadIdx.x; t < total; t += blockDim.x) {
      if (t < nblk) {
        const int i = t / h, j = t % h;
        const int p = pp[i], q = qq[i], p2 = pp[j], q2 = qq[j];
        const float ci = cs[i], si = sn[i], cj = cs[j], sj = sn[j];
        const float a00 = A[p * m + p2], a01 = A[p * m + q2];
        const float a10 = A[q * m + p2], a11 = A[q * m + q2];
        // left rotation: row p <- c r_p - s r_q, row q <- s r_p + c r_q
        const float l00 = ci * a00 - si * a10, l01 = ci * a01 - si * a11;
        const float l10 = si * a00 + ci * a10, l11 = si * a01 + ci * a11;
        // right rotation on the columns of pair j
        A[p * m + p2] = cj * l00 - sj * l01;
        A[p * m + q2] = sj * l00 + cj * l01;
        A[q * m + p2] = cj * l10 - sj * l11;
        A[q * m + q2] = sj * l10 + cj * l11;
      } else {
        const int u = t - nblk;
        const int r = u / h, j = u % h;
        const int p2 = pp[j], q2 = qq[j];
        const float cj = cs[j], sj = sn[j];
        const float v0 = V[r * m + p2], v1 = V[r * m + q2];
        V[r * m + p2] = cj * v0 - sj * v1;
        V[r * m + q2] = sj * v0 + cj * v1;
      }
    }
    __syncthreads();
  }

  // Ascending order, ties by label (a stable argsort of the diagonal).
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    const float dk = A[k * m + k];
    int rank = 0;
    for (int j = 0; j < m; ++j) {
      rank += before(A[j * m + j], j, dk, k) ? 1 : 0;
    }
    inv[rank] = k;
  }
  __syncthreads();

  float* wb = w_out + static_cast<size_t>(b) * n;
  float* Vb = V_out + static_cast<size_t>(b) * n * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int k = inv[c];
    wb[c] = A[k * m + k];
  }
  for (int t = threadIdx.x; t < n * n; t += blockDim.x) {
    const int r = t / n, c = t % n;
    Vb[t] = V[r * m + inv[c]];
  }
}

size_t smem_bytes(int m) {
  const int h = m / 2;
  return sizeof(float) * (2 * static_cast<size_t>(m) * m + 2 * h) +
         sizeof(int) * (2 * h + m);
}

}  // namespace

// A: (batch, n, n) float32, contiguous. w: (batch, n). V: (batch, n, n).
// Returns the cudaError_t of the launch (0 on success); launches nothing
// for batch == 0.
extern "C" int sella_jacobi_eigh_f32(const float* A, float* w, float* V,
                                     int batch, int n, int sweeps,
                                     void* stream) {
  if (n < 1 || n > kMaxN || batch < 0 || sweeps < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const int m = n + (n & 1);
  const size_t bytes = smem_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      jacobi_eigh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  jacobi_eigh_kernel<<<batch, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(A, w, V, n, m,
                                                            sweeps);
  return static_cast<int>(cudaGetLastError());
}

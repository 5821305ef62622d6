// SLS column-wise backward Riccati, gains only, for NVIDIA Hopper (sm_90a).
// Bound to PyTorch through a plain C interface (ctypes) by
// robust_nonlinear_mpc_torch/ops/fused_backward.py, which also holds the
// plain torch twin.
//
// Replaces robust_nonlinear_mpc_tpu/ops/pallas_sls.py `_backward_kernel`
// (wrapper `_backward_K_batched`): the same maths as `backward_solve_folded`,
// K only. For lane b and column j < N+1, from S = sym(Gf' diag(eta_f[j]) Gf
// + Q_reg_f), for k = N-1 down to j:
//   Cxx = Gx' diag(eta[k, j]) Gx + Q_reg,   Cuu = Gu' diag(eta[k, j]) Gu + R_reg
//   H = sym(Cuu + B'SB),  F = B'SA,  K[k, j] = -H^{-1} F
//   S <- sym(Cxx + A'SA + F'K)
// and K[k, j] = 0 for j > k.
//
// Design. One thread block per (lane, column): B (N+1) independent blocks,
// 8,192 at the bench's B = 512, N = 15. Each block walks only its own active
// stages k = N-1 .. j, so the triangular skip that the column-blocked torch
// kernels buy with segments comes for free (the reference's prange over
// columns). Nothing is carried between blocks. Shared memory holds S, A_k,
// SA, the stage's Cxx + A'SA, B_k, SB, F, K, H and its inverse, the stage's
// eta row and the constraint blocks Gx, Gu: 19 KB in float64 at the rocket's
// widths (nx = 17, nu = 4, ni = 42), dynamic, so wider problems fit up to
// the card's 227 KB. The nu x nu solve is the blockwise-Schur inverse of
// newton.cuh on the symmetrized H. S is symmetrized at every stage, as in
// the folded torch kernel (the Pallas kernel skips it; the same omission in
// the Newton kernel broke long horizons in float32).
//
// The curvature is built inside the kernel from eta and G, not by a matmul
// prologue: the prologue would write Cxx and Cuu for every (lane, stage,
// column) to device memory, 142 MB in float32 at B = 512, N = 15, and the
// kernel would read them back. Building them here costs 2 ni nx^2 = 24 kFLOP
// per active (k, j) pair, more than the recursion's own 28 kFLOP, but only
// eta (19 MB) is read.
//
// Bound: operations. At B = 512, N = 15 in float32 the kernel must read A,
// B, eta, eta_f (32 MB) and write K (33 MB), 65 MB or 19 us at 3.35 TB/s;
// it does 3.4 GFLOP (120 active (k, j) pairs of about 53 kFLOP per lane,
// plus the 16 terminal matrices), 51 us at the 67 TFLOP/s float32 peak
// (chip_smoke.kernel_bound). The stages of a column are sequential, with
// six barriers each, so a block is latency-bound; the many independent
// blocks are what fill the card.

#include "newton.cuh"
#include "occupancy.cuh"

namespace {

constexpr int BWD_THREADS = 128;
constexpr int MAX_SMEM = 227 * 1024;

size_t smem_elems(int nx, int nu, int ni, int ni_f) {
  const size_t nxx = (size_t)nx * nx, nxu = (size_t)nx * nu, nuu = (size_t)nu * nu;
  return 4 * nxx + 4 * nxu + 2 * nuu + (size_t)(ni > ni_f ? ni : ni_f) + (size_t)ni * (nx + nu);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) backward_K_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ Gx,
    const T* __restrict__ Gu, const T* __restrict__ Gf, const T* __restrict__ eta,
    const T* __restrict__ eta_f, const T* __restrict__ Qr, const T* __restrict__ Rr,
    const T* __restrict__ Qrf, T* __restrict__ K, int N, int nx, int nu, int ni, int ni_f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const int J = N + 1;
  const int j = blockIdx.x % J;
  const size_t b = blockIdx.x / J;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * nu;
  T* S = sm;
  T* Ak = S + nxx;
  T* SA = Ak + nxx;
  T* M = SA + nxx;  // Cxx, then Cxx + A'SA
  T* Bk = M + nxx;
  T* SB = Bk + nxu;
  T* F = SB + nxu;
  T* Ks = F + nxu;
  T* H = Ks + nxu;  // Cuu, then Cuu + B'SB
  T* Hi = H + nuu;
  T* e = Hi + nuu;  // the eta row of the current stage (eta_f[j] at first)
  T* Gxs = e + (ni > ni_f ? ni : ni_f);
  T* Gus = Gxs + ni * nx;

  for (int i = tid; i < ni * nx; i += BWD_THREADS) Gxs[i] = Gx[i];
  for (int i = tid; i < ni * nu; i += BWD_THREADS) Gus[i] = Gu[i];
  for (int i = tid; i < ni_f; i += BWD_THREADS) e[i] = eta_f[(b * J + j) * ni_f + i];
  T* K_b = K + b * (size_t)N * J * nxu;
  const int k_lo = j < N ? j : N;  // stages below the column's first are zero
  for (int i = tid; i < k_lo * nxu; i += BWD_THREADS)
    K_b[((size_t)(i / nxu) * J + j) * nxu + i % nxu] = T(0);
  __syncthreads();

  // terminal value matrix S = sym(Gf' diag(eta_f[j]) Gf + Q_reg_f)
  for (int idx = tid; idx < nxx; idx += BWD_THREADS) {
    const int a = idx / nx, c = idx % nx;
    T s = T(0);
    for (int r = 0; r < ni_f; ++r) s += e[r] * (Gf[r * nx + a] * Gf[r * nx + c]);
    M[idx] = s + Qrf[idx];
  }
  __syncthreads();
  for (int idx = tid; idx < nxx; idx += BWD_THREADS) {
    const int a = idx / nx, c = idx % nx;
    S[idx] = T(0.5) * (M[a * nx + c] + M[c * nx + a]);
  }
  __syncthreads();

  for (int k = N - 1; k >= j; --k) {
    // 1: the stage's A, B and eta row
    const size_t st = b * N + k;
    for (int i = tid; i < nxx; i += BWD_THREADS) Ak[i] = A[st * nxx + i];
    for (int i = tid; i < nxu; i += BWD_THREADS) Bk[i] = B[st * nxu + i];
    for (int i = tid; i < ni; i += BWD_THREADS) e[i] = eta[(st * N + j) * ni + i];
    __syncthreads();

    // 2: SA = S A, SB = S B, M = Cxx, H = Cuu
    for (int idx = tid; idx < 2 * nxx + nxu + nuu; idx += BWD_THREADS) {
      if (idx < nxx) {
        const int i = idx / nx, c = idx % nx;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += S[i * nx + l] * Ak[l * nx + c];
        SA[idx] = s;
      } else if (idx < nxx + nxu) {
        const int i2 = idx - nxx, i = i2 / nu, v = i2 % nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += S[i * nx + l] * Bk[l * nu + v];
        SB[i2] = s;
      } else if (idx < 2 * nxx + nxu) {
        const int i2 = idx - nxx - nxu, a = i2 / nx, c = i2 % nx;
        T s = T(0);
        for (int r = 0; r < ni; ++r) s += e[r] * (Gxs[r * nx + a] * Gxs[r * nx + c]);
        M[i2] = s + Qr[i2];
      } else {
        const int i2 = idx - 2 * nxx - nxu, u = i2 / nu, v = i2 % nu;
        T s = T(0);
        for (int r = 0; r < ni; ++r) s += e[r] * (Gus[r * nu + u] * Gus[r * nu + v]);
        H[i2] = s + Rr[i2];
      }
    }
    __syncthreads();

    // 3: H += B'SB, F = B'SA, M += A'SA (as (SA)'A: S is symmetric)
    for (int idx = tid; idx < nuu + nxu + nxx; idx += BWD_THREADS) {
      if (idx < nuu) {
        const int u = idx / nu, v = idx % nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += SB[l * nu + u] * Bk[l * nu + v];
        H[idx] += s;
      } else if (idx < nuu + nxu) {
        const int i2 = idx - nuu, u = i2 / nx, c = i2 % nx;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += SB[l * nu + u] * Ak[l * nx + c];
        F[i2] = s;
      } else {
        const int i2 = idx - nuu - nxu, a = i2 / nx, c = i2 % nx;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += SA[l * nx + a] * Ak[l * nx + c];
        M[i2] += s;
      }
    }
    __syncthreads();

    // 4: the inverse of sym(H)
    if (tid == 0) {
      T Hs[rnm::MAXNU * rnm::MAXNU];
      for (int u = 0; u < nu; ++u)
        for (int v = 0; v < nu; ++v) Hs[u * nu + v] = T(0.5) * (H[u * nu + v] + H[v * nu + u]);
      rnm::spd_inv_dispatch<T>(Hs, Hi, nu);
    }
    __syncthreads();

    // 5: K[k, j] = -H^{-1} F
    for (int idx = tid; idx < nxu; idx += BWD_THREADS) {
      const int u = idx / nx, c = idx % nx;
      T s = T(0);
      for (int v = 0; v < nu; ++v) s += Hi[u * nu + v] * F[v * nx + c];
      Ks[idx] = -s;
      K_b[((size_t)k * J + j) * nxu + idx] = -s;
    }
    __syncthreads();

    // 6: S = sym(Cxx + A'SA + F'K)
    for (int idx = tid; idx < nxx; idx += BWD_THREADS) {
      const int a = idx / nx, c = idx % nx;
      T mac = M[a * nx + c], mca = M[c * nx + a];
      for (int u = 0; u < nu; ++u) {
        mac += F[u * nx + a] * Ks[u * nx + c];
        mca += F[u * nx + c] * Ks[u * nx + a];
      }
      S[idx] = T(0.5) * (mac + mca);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_backward_K(const T* A, const T* B, const T* Gx, const T* Gu, const T* Gf,
                      const T* eta, const T* eta_f, const T* Qr, const T* Rr, const T* Qrf,
                      T* K, int Bsz, int N, int nx, int nu, int ni, int ni_f,
                      cudaStream_t stream) {
  if (Bsz < 1 || N < 1 || nx < 1 || nu < 1 || nu > rnm::MAXNU || ni < 1 || ni_f < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_elems(nx, nu, ni, ni_f) * sizeof(T);
  const long long blocks = (long long)Bsz * (N + 1);
  if (bytes > (size_t)MAX_SMEM || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      backward_K_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  backward_K_kernel<T><<<(unsigned)blocks, BWD_THREADS, bytes, stream>>>(
      A, B, Gx, Gu, Gf, eta, eta_f, Qr, Rr, Qrf, K, N, nx, nu, ni, ni_f);
  return (int)cudaGetLastError();
}

}  // namespace

#define RNM_BK_ARGS(T)                                                                 \
  const T *A, const T *B, const T *Gx, const T *Gu, const T *Gf, const T *eta,         \
      const T *eta_f, const T *Qr, const T *Rr, const T *Qrf, T *K, int Bsz, int N,    \
      int nx, int nu, int ni, int ni_f, void *stream

extern "C" {

int rnm_backward_K_f32(RNM_BK_ARGS(float)) {
  return launch_backward_K<float>(A, B, Gx, Gu, Gf, eta, eta_f, Qr, Rr, Qrf, K, Bsz, N, nx,
                                  nu, ni, ni_f, (cudaStream_t)stream);
}

int rnm_backward_K_f64(RNM_BK_ARGS(double)) {
  return launch_backward_K<double>(A, B, Gx, Gu, Gf, eta, eta_f, Qr, Rr, Qrf, K, Bsz, N,
                                   nx, nu, ni, ni_f, (cudaStream_t)stream);
}

// dims = (N, nx, nu, ni, ni_f, nw)
int rnm_backward_K_info_f32(const int* d, int* out) {
  return rnm::kernel_info(backward_K_kernel<float>, BWD_THREADS,
                          smem_elems(d[1], d[2], d[3], d[4]) * sizeof(float), out);
}
int rnm_backward_K_info_f64(const int* d, int* out) {
  return rnm::kernel_info(backward_K_kernel<double>, BWD_THREADS,
                          smem_elems(d[1], d[2], d[3], d[4]) * sizeof(double), out);
}

}  // extern "C"

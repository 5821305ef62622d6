// SLS column-wise backward Riccati, gains only, for NVIDIA Hopper (sm_90a).
// Bound to PyTorch through a plain C interface (ctypes) by
// robust_nonlinear_mpc_torch/ops/fused_backward.py, which also holds the
// plain torch twin.
//
// Replaces robust_nonlinear_mpc_tpu/ops/pallas_sls.py `_backward_kernel`
// (wrapper `_backward_K_batched`): the same maths as `backward_solve_folded`,
// K only. For lane b and column j < N, from S = sym(Gf' diag(eta_f[j]) Gf
// + Q_reg_f), for k = N-1 down to j:
//   Cxx = Gx' diag(eta[k, j]) Gx + Q_reg,   Cuu = Gu' diag(eta[k, j]) Gu + R_reg
//   H = sym(Cuu + B'SB),  F = B'SA,  K[k, j] = -H^{-1} F
//   S <- sym(Cxx + A'SA + F'K)
// and K[k, j] = 0 for j > k (the terminal column j = N is all zero).
//
// Design: one warp per (lane, column), a warp-synchronous chain.
//   * A block holds one lane and up to 8 warps. Column j walks N - j
//     stages, so warp w takes the columns N-1-p and p of each pair p = w,
//     w + warps, ...: every pair is N + 1 stages, and at N = 15 the eight
//     warps of a block do 16, 16, ..., 16 and 8 stages.
//   * Inside a stage only `__syncwarp` orders the lanes. The one block
//     barrier is at the start, after the block copies Gx, Gu, Gf, Q_reg and
//     R_reg into shared memory and zeroes K for j > k.
//   * Lane c owns column c of the stage's (nx + nu)-square Hessian
//     Z = [A B]' S [A B] + blkdiag(Cxx, Cuu): its x block is Cxx + A'SA,
//     its lower left block F, its u block Cuu + B'SB. The lane keeps its
//     column of [A B], then of S [A B], then of Z in registers; each shared
//     load is a 16-byte broadcast of a row (S, [A B], [Gx Gu]) that feeds
//     four (float64: two) multiply-adds of every lane. The curvature is the
//     x block for lanes c < nx and the u block for lanes nx <= c < nx + nu
//     (read at the Gu offset of the same rows), so no cross term is built.
//   * Every lane with a gain column forms sym(H) from the Z columns in
//     shared memory and inverts it in registers (newton.cuh's blockwise
//     Schur inverse), then K[:, c] = -H^{-1} F[:, c]; no single-thread phase.
//   * S = sym(Cxx + A'SA + F'K): each lane writes its column of the sum and
//     reads the transposed one back, once a stage (S is symmetrized at every
//     stage, as in the folded torch kernel; the Pallas kernel skips it, and
//     the same omission in the Newton kernel broke long horizons in float32).
//   * The next stage's eta row is fetched by `cp.async` at the head of a
//     stage into a two-slot ring; its A and B once the stage has read the
//     current ones, so the fetch overlaps the gains, the update of S and the
//     next curvature. Nothing on the chain waits on device memory.
//   * Each model's (nx, nu) is its own instantiation (RNM_BY_WIDTH: rocket,
//     quadrotor, pendulum); other nx <= 32, nu <= 4 take the general path.
//     Float32 is held to 64 registers, 4 blocks (lanes) an SM: B = 512 in
//     one wave; float64 takes two, the general path half as many
//     (`Residency`).
// Shared memory per block (`BwdLayout`): 50 KB in float32 at the rocket's
// widths with 8 warps; where a layout does not fit, fewer warps take the
// pairs in turn.
//
// Bound: operations. At B = 512, N = 15 in float32 the kernel must read A,
// B, the active eta rows and eta_f (22 MB) and write K (33 MB), about 17 us
// at 3.35 TB/s; the least work is 2.3 GFLOP (120 active (k, j) pairs of
// about 36 kFLOP per lane, each symmetric product counted on one triangle
// plus one scaling of each row, and N terminal matrices), 35 us at the
// 67 TFLOP/s float32 peak (chip_smoke.kernel_bound). The kernel computes
// the symmetric products whole (a lane per column: one triangle would save
// no warp instructions). A warp's chain is latency-bound; the 32 warps of
// four lanes an SM hide each other's latency.

#include "newton.cuh"
#include "occupancy.cuh"

namespace {

constexpr int BWD_WARPS = 8;
constexpr int MAX_SMEM = 227 * 1024;

// Shared-memory layout, in words of T; every region is a multiple of 4
// words, so 16-byte aligned. Block: Gc (ni rows of ld: Gx at 0, Gu at nxp,
// then a tail of nxp that the u lanes' row reads run into), Gf (ni_f rows of
// nxp), Q_reg (nx rows of nxp), R_reg (4 x 4). Per warp: [A B] (nx rows of
// ld: A at 0, B at nxp), the eta ring (2 slots of nep; eta_f at a column's
// start), S (nx rows of nxp), Z (nx + nu rows of ld, row c = column c).
struct BwdLayout {
  int nxp, ld, nep, block, warp;
  __host__ __device__ BwdLayout(int nx, int nu, int ni, int ni_f) {
    nxp = rnm::pad4(nx);
    ld = nxp + 4;
    nep = rnm::pad4(ni > ni_f ? ni : ni_f);
    block = ni * ld + nxp + ni_f * nxp + nx * nxp + 16;
    warp = nx * ld + 2 * nep + nx * nxp + (nx + nu) * ld;
  }
  size_t words(int warps) const { return (size_t)block + (size_t)warps * warp; }
};

// Warps a block runs: one per column pair, at most BWD_WARPS, fewer where
// the layout would not fit (0: not even one).
int bwd_warps(int N, int nx, int nu, int ni, int ni_f, size_t size) {
  const BwdLayout L(nx, nu, ni, ni_f);
  int w = (N + 1) / 2 < BWD_WARPS ? (N + 1) / 2 : BWD_WARPS;
  while (w > 0 && L.words(w) * size > (size_t)MAX_SMEM) --w;
  return w;
}

// the symmetric nu x nu inverse in registers (leading dimension NU)
template <typename T, int NUC, int NU>
__device__ __forceinline__ void inv_small(const T* H, T* Hi, int nu) {
  if constexpr (NUC > 0) {
    rnm::spd_inv<T, NUC>(H, NU, Hi, NU);
  } else {
    switch (nu) {
      case 1: rnm::spd_inv<T, 1>(H, NU, Hi, NU); break;
      case 2: rnm::spd_inv<T, 2>(H, NU, Hi, NU); break;
      case 3: rnm::spd_inv<T, 3>(H, NU, Hi, NU); break;
      default: rnm::spd_inv<T, 4>(H, NU, Hi, NU); break;
    }
  }
}

template <typename T, int NXC, int NUC>
__global__ void __launch_bounds__(32 * BWD_WARPS, (rnm::Residency<T, NXC>::blocks))
    backward_K_kernel(const T* __restrict__ A, const T* __restrict__ B,
                      const T* __restrict__ Gx, const T* __restrict__ Gu,
                      const T* __restrict__ Gf, const T* __restrict__ eta,
                      const T* __restrict__ eta_f, const T* __restrict__ Qr,
                      const T* __restrict__ Rr, const T* __restrict__ Qrf, T* __restrict__ K,
                      int N, int nx_, int nu_, int ni, int ni_f) {
  constexpr int NX = NXC > 0 ? NXC : rnm::MAXNX;
  constexpr int NU = NUC > 0 ? NUC : rnm::MAXNU;
  // loops over the register columns unroll at a model's widths; on the
  // general path they stay rolled (their arrays live on the stack), which
  // keeps its build short
  constexpr int UNR = NXC > 0 ? 64 : 1;
  const int nx = NXC > 0 ? NXC : nx_;
  const int nu = NUC > 0 ? NUC : nu_;
  const BwdLayout L(nx, nu, ni, ni_f);
  const int nxp = L.nxp, ld = L.ld;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Gc = reinterpret_cast<T*>(smem_raw);
  T* Gfs = Gc + ni * ld + nxp;
  T* Qs = Gfs + ni_f * nxp;
  T* Rs = Qs + nx * nxp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  T* AB = Rs + 16 + (size_t)warp * L.warp;
  T* er = AB + nx * ld;
  T* S = er + 2 * L.nep;
  T* Zs = S + nx * nxp;
  const size_t b = blockIdx.x;
  const int J = N + 1, nxu = nx * nu;

  for (int i = tid; i < ni * nx; i += blockDim.x) Gc[(i / nx) * ld + i % nx] = Gx[i];
  for (int i = tid; i < ni * nu; i += blockDim.x) Gc[(i / nu) * ld + nxp + i % nu] = Gu[i];
  for (int i = tid; i < ni_f * nx; i += blockDim.x) Gfs[(i / nx) * nxp + i % nx] = Gf[i];
  for (int i = tid; i < nx * nx; i += blockDim.x) Qs[(i / nx) * nxp + i % nx] = Qr[i];
  for (int i = tid; i < nu * nu; i += blockDim.x) Rs[(i / nu) * 4 + i % nu] = Rr[i];
  T* K_b = K + b * (size_t)N * J * nxu;
  for (int k = 0; k < N; ++k) {  // columns j > k are zero
    T* z = K_b + ((size_t)k * J + k + 1) * nxu;
    for (int i = tid; i < (N - k) * nxu; i += blockDim.x) z[i] = T(0);
  }
  __syncthreads();

  // S = sym(X), X in Zs by columns (row c = column c): S[c][i] = (X[i][c] +
  // X[c][i]) / 2 by lane c
  auto sym_to_S = [&]() {
    if (lane < nx) {
      T xr[NX], s[NX];
      rnm::load_row<T, NX>(Zs + lane * ld, xr, nx);
#pragma unroll UNR
      for (int i = 0; i < NX; ++i)
        if (i < nx) s[i] = T(0.5) * (xr[i] + Zs[i * ld + lane]);
      rnm::store_row<T, NX>(S + lane * nxp, s, nx);
    }
  };

  auto column = [&](int j) {
    const T* eta_j = eta + (b * N * (size_t)N + j) * ni;  // + k N ni: stage k's row
    auto fetch_ab = [&](int k) {
      const T* Ak = A + (b * N + k) * (size_t)(nx * nx);
      const T* Bk = B + (b * N + k) * (size_t)nxu;
      for (int i = lane; i < nx * nx; i += 32)
        rnm::cp_async_elem(AB + (i / nx) * ld + i % nx, Ak + i);
      for (int i = lane; i < nxu; i += 32)
        rnm::cp_async_elem(AB + (i / nu) * ld + nxp + i % nu, Bk + i);
    };
    __syncwarp();  // the previous column's reads are done
    rnm::copy_async(er + (N & 1) * L.nep, eta_f + (b * J + j) * ni_f, ni_f, lane, 32);
    rnm::cp_async_commit();
    rnm::copy_async(er + ((N - 1) & 1) * L.nep, eta_j + (size_t)(N - 1) * N * ni, ni, lane, 32);
    fetch_ab(N - 1);
    rnm::cp_async_commit();
    rnm::cp_async_wait<1>();
    __syncwarp();

    // terminal: X = Gf' diag(eta_f[j]) Gf + Q_reg_f, column c by lane c
    if (lane < nx) {
      const int c = lane;
      const T* e = er + (N & 1) * L.nep;
      T x[NX];
#pragma unroll UNR
      for (int i = 0; i < NX; ++i)
        if (i < nx) x[i] = Qrf[i * nx + c];
#pragma unroll 2
      for (int r = 0; r < ni_f; ++r) {
        const T g = e[r] * Gfs[r * nxp + c];
        T row[NX];
        rnm::load_row<T, NX>(Gfs + r * nxp, row, nx);
#pragma unroll UNR
        for (int i = 0; i < NX; ++i)
          if (i < nx) x[i] += g * row[i];
      }
      rnm::store_row<T, NX>(Zs + c * ld, x, nx);
    }
    __syncwarp();
    sym_to_S();

    for (int k = N - 1; k >= j; --k) {
      rnm::cp_async_wait<0>();
      __syncwarp();
      if (k > j)
        rnm::copy_async(er + ((k - 1) & 1) * L.nep, eta_j + (size_t)(k - 1) * N * ni, ni, lane,
                        32);
      rnm::cp_async_commit();
      const T* e = er + (k & 1) * L.nep;

      // Z[:, c] = [A B]' S [A B][:, c] + the curvature column, by lane c
      for (int c = lane; c < nx + nu; c += 32) {
        const bool isx = c < nx;
        const int oc = isx ? c : nxp + c - nx;  // the column's slot in a row
        T sab[NX];
        {
          T abc[NX];
#pragma unroll UNR
          for (int m = 0; m < NX; ++m)
            if (m < nx) abc[m] = AB[m * ld + oc];
#pragma unroll UNR
          for (int l = 0; l < NX; ++l)
            if (l < nx) {
              T sr[NX];
              rnm::load_row<T, NX>(S + l * nxp, sr, nx);
              T s = T(0);
#pragma unroll UNR
              for (int m = 0; m < NX; ++m)
                if (m < nx) s += sr[m] * abc[m];
              sab[l] = s;
            }
        }
        // the curvature: x lanes read the Gx part of each row, u lanes the
        // Gu part (their first nu entries)
        T zx[NX], zu[NU];
        {
          const int ro = isx ? 0 : nxp;
          T cv[NX];
#pragma unroll UNR
          for (int i = 0; i < NX; ++i) cv[i] = T(0);
#pragma unroll 2
          for (int r = 0; r < ni; ++r) {
            const T g = e[r] * Gc[r * ld + oc];
            T row[NX];
            rnm::load_row<T, NX>(Gc + r * ld + ro, row, nx);
#pragma unroll UNR
            for (int i = 0; i < NX; ++i)
              if (i < nx) cv[i] += g * row[i];
          }
          const int qc = isx ? c : 0, ru = isx ? 0 : c - nx;
#pragma unroll UNR
          for (int i = 0; i < NX; ++i)
            if (i < nx) zx[i] = isx ? cv[i] + Qs[i * nxp + qc] : T(0);
#pragma unroll UNR
          for (int v = 0; v < NU; ++v)
            if (v < nu) zu[v] = isx ? T(0) : cv[v] + Rs[v * 4 + ru];
        }
#pragma unroll UNR
        for (int l = 0; l < NX; ++l)
          if (l < nx) {
            T ar[NX], br[NU];
            rnm::load_row<T, NX>(AB + l * ld, ar, nx);
            rnm::load_row<T, NU>(AB + l * ld + nxp, br, nu);
#pragma unroll UNR
            for (int i = 0; i < NX; ++i)
              if (i < nx) zx[i] += ar[i] * sab[l];
#pragma unroll UNR
            for (int v = 0; v < NU; ++v)
              if (v < nu) zu[v] += br[v] * sab[l];
          }
        rnm::store_row<T, NX>(Zs + c * ld, zx, nx);
        rnm::store_row<T, NU>(Zs + c * ld + nxp, zu, nu);
      }
      __syncwarp();
      // [A B] and S are read: the next stage's A and B may land
      if (k > j) fetch_ab(k - 1);
      rnm::cp_async_commit();

      // K[:, c] = -sym(H)^{-1} F[:, c] and X[:, c] = M[:, c] + F' K[:, c]
      if (lane < nx) {
        const int c = lane;
        T H[NU * NU], Hi[NU * NU], F[NU], kk[NU];
#pragma unroll UNR
        for (int u = 0; u < NU; ++u)
#pragma unroll UNR
          for (int v = 0; v < NU; ++v)
            if (u < nu && v < nu)
              H[u * NU + v] = T(0.5) * (Zs[(nx + v) * ld + nxp + u] + Zs[(nx + u) * ld + nxp + v]);
        inv_small<T, NUC, NU>(H, Hi, nu);
        rnm::load_row<T, NU>(Zs + c * ld + nxp, F, nu);
        T* K_kj = K_b + ((size_t)k * J + j) * nxu;
#pragma unroll UNR
        for (int u = 0; u < NU; ++u)
          if (u < nu) {
            T s = T(0);
#pragma unroll UNR
            for (int v = 0; v < NU; ++v)
              if (v < nu) s += Hi[u * NU + v] * F[v];
            kk[u] = -s;
            K_kj[u * nx + c] = -s;
          }
        T x[NX];
        rnm::load_row<T, NX>(Zs + c * ld, x, nx);
#pragma unroll UNR
        for (int i = 0; i < NX; ++i)
          if (i < nx) {
            T fi[NU];
            rnm::load_row<T, NU>(Zs + i * ld + nxp, fi, nu);
#pragma unroll UNR
            for (int u = 0; u < NU; ++u)
              if (u < nu) x[i] += fi[u] * kk[u];
          }
        rnm::store_row<T, NX>(Zs + c * ld, x, nx);
      }
      __syncwarp();
      sym_to_S();
    }
  };

  const int P = (N + 1) / 2;
  for (int p = warp; p < P; p += warps) {
    column(N - 1 - p);
    if (p != N - 1 - p) column(p);
  }
}

template <typename T>
auto bwd_kernel(int nx, int nu) {
  RNM_BY_WIDTH(backward_K_kernel, T, nx, nu);
}

template <typename T>
int launch_backward_K(const T* A, const T* B, const T* Gx, const T* Gu, const T* Gf,
                      const T* eta, const T* eta_f, const T* Qr, const T* Rr, const T* Qrf,
                      T* K, int Bsz, int N, int nx, int nu, int ni, int ni_f,
                      cudaStream_t stream) {
  if (Bsz < 1 || N < 1 || nx < 1 || nx > rnm::MAXNX || nu < 1 || nu > rnm::MAXNU || ni < 1 ||
      ni_f < 1)
    return (int)cudaErrorInvalidValue;
  const int warps = bwd_warps(N, nx, nu, ni, ni_f, sizeof(T));
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = BwdLayout(nx, nu, ni, ni_f).words(warps) * sizeof(T);
  auto kernel = bwd_kernel<T>(nx, nu);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<Bsz, 32 * warps, bytes, stream>>>(A, B, Gx, Gu, Gf, eta, eta_f, Qr, Rr, Qrf, K, N,
                                              nx, nu, ni, ni_f);
  return (int)cudaGetLastError();
}

template <typename T>
int info_backward_K(const int* d, int* out) {
  const int warps = bwd_warps(d[0], d[1], d[2], d[3], d[4], sizeof(T));
  if (warps < 1) return (int)cudaErrorInvalidValue;
  return rnm::kernel_info(bwd_kernel<T>(d[1], d[2]), 32 * warps,
                          BwdLayout(d[1], d[2], d[3], d[4]).words(warps) * sizeof(T), out);
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
int rnm_backward_K_info_f32(const int* d, int* out) { return info_backward_K<float>(d, out); }
int rnm_backward_K_info_f64(const int* d, int* out) { return info_backward_K<double>(d, out); }

}  // extern "C"

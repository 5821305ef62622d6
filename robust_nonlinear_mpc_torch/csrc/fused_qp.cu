// Fused Riccati Newton solves of the interior-point QP, for NVIDIA Hopper
// (sm_90a). Bound to PyTorch through a plain C interface (ctypes) by
// robust_nonlinear_mpc_torch/ops/fused_qp.py, which also holds the plain
// torch twin of each kernel.
//
// What each kernel replaces:
//   factor_predictor_kernel -> robust_nonlinear_mpc_tpu/ops/pallas_qp.py
//                              `_factor_predictor_kernel` (with the windowed
//                              `_factor_bwd_win_kernel` path: this kernel
//                              runs any N in one stage loop)
//   resolve_kernel          -> robust_nonlinear_mpc_tpu/ops/pallas_qp.py
//                              `_resolve_kernel` (and `_resolve_bwd_win_kernel`)
//   forward_sweep           -> the shared `_forward_loop` / `_newton_fwd_win_kernel`
//
// Design. One thread block per QP (lane): any batch size, no padding lanes.
// The current stage's P, A, P*A, Fxx (nx x nx) and B, P*B, Fxu', K (nx x nu)
// live in shared memory; the threads of the block spread over the entries
// of each product. The nu x nu gain system is solved by a closed-form
// recursive blockwise-Schur inverse of the symmetrized, trace-regularized
// Fuu plus one refinement pass, as in the Pallas kernel; P is symmetrized
// at every stage (skipping it lets asymmetric roundoff compound over long
// horizons). The forward sweep runs in the same kernel.
//
// Bound: latency. Per stage a lane does about 4*nx^3 FMAs over 17x17 blocks
// (nx = 17, nu = 4 for the rocket) in a handful of dependent phases, and the
// stages are strictly sequential over N, so the time is the chain of
// barriers and shared-memory round trips, not bytes or FLOPs. Later work:
// tensor-core (wgmma) products, several lanes per block to fill the warps,
// and CUDA-graph capture of the whole IPM iteration.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAXNX = 32;
constexpr int MAXNU = 4;
constexpr int THREADS = 256;

__device__ __forceinline__ int tri_index(int u, int v, int nu) {
  // upper-triangle (u <= v) position in the row-major `_tri(nu)` order
  return u * nu - (u * (u - 1)) / 2 + (v - u);
}

// Inverse of a symmetric positive-definite n x n matrix (row-major, leading
// dimension ldh, upper triangle read) by recursive 2-block Schur
// elimination; `out` receives the full symmetric inverse.
template <typename T, int n>
__device__ void spd_inv(const T* H, int ldh, T* out, int ldo) {
  if constexpr (n == 1) {
    out[0] = T(1) / H[0];
  } else {
    constexpr int m = n / 2;
    constexpr int r = n - m;
    T Ainv[m * m];
    spd_inv<T, m>(H, ldh, Ainv, m);
    T W[m * r];  // Ainv * H12
    for (int u = 0; u < m; ++u)
      for (int v = 0; v < r; ++v) {
        T s = T(0);
        for (int l = 0; l < m; ++l) s += Ainv[u * m + l] * H[l * ldh + m + v];
        W[u * r + v] = s;
      }
    T S[r * r];  // H22 - H12' W
    for (int u = 0; u < r; ++u)
      for (int v = u; v < r; ++v) {
        T s = H[(m + u) * ldh + m + v];
        for (int l = 0; l < m; ++l) s -= H[l * ldh + m + u] * W[l * r + v];
        S[u * r + v] = s;
        S[v * r + u] = s;
      }
    T Sinv[r * r];
    spd_inv<T, r>(S, r, Sinv, r);
    for (int u = 0; u < m; ++u)  // top-left: Ainv + W Sinv W'
      for (int v = u; v < m; ++v) {
        T s = Ainv[u * m + v];
        for (int a = 0; a < r; ++a)
          for (int b = 0; b < r; ++b) s += W[u * r + a] * Sinv[a * r + b] * W[v * r + b];
        out[u * ldo + v] = s;
        out[v * ldo + u] = s;
      }
    for (int u = 0; u < m; ++u)  // top-right: -W Sinv
      for (int v = 0; v < r; ++v) {
        T s = T(0);
        for (int a = 0; a < r; ++a) s += W[u * r + a] * Sinv[a * r + v];
        out[u * ldo + m + v] = -s;
        out[(m + v) * ldo + u] = -s;
      }
    for (int u = 0; u < r; ++u)  // bottom-right: Sinv
      for (int v = 0; v < r; ++v) out[(m + u) * ldo + m + v] = Sinv[u * r + v];
  }
}

template <typename T>
__device__ void spd_inv_dispatch(const T* H, T* out, int nu) {
  switch (nu) {
    case 1: spd_inv<T, 1>(H, nu, out, nu); break;
    case 2: spd_inv<T, 2>(H, nu, out, nu); break;
    case 3: spd_inv<T, 3>(H, nu, out, nu); break;
    default: spd_inv<T, 4>(H, nu, out, nu); break;
  }
}

// x = -(Hc^{-1} rhs) from the explicit inverse plus one refinement pass.
template <typename T>
__device__ void neg_refined_solve(const T* Hc, const T* Fiv, const T* rhs, T* x, int nu) {
  T x0[MAXNU], r[MAXNU];
  for (int u = 0; u < nu; ++u) {
    T s = T(0);
    for (int v = 0; v < nu; ++v) s += Fiv[u * nu + v] * rhs[v];
    x0[u] = s;
  }
  for (int u = 0; u < nu; ++u) {
    T s = rhs[u];
    for (int v = 0; v < nu; ++v) s -= Hc[u * nu + v] * x0[v];
    r[u] = s;
  }
  for (int u = 0; u < nu; ++u) {
    T s = x0[u];
    for (int v = 0; v < nu; ++v) s += Fiv[u * nu + v] * r[v];
    x[u] = -s;
  }
}

// Forward sweep: du = K dx + kff, dx+ = A dx + B du + req,
// dnu = -(P_{k+1} dx+ + p_{k+1}). All pointers are already offset to the lane.
template <typename T>
__device__ void forward_sweep(const T* A, const T* B, const T* req, const T* K,
                              const T* kff, const T* Pseq, const T* pn, T* dX, T* dU,
                              T* dnu, int N, int nx, int nu, T* dx, T* dxn, T* du) {
  const int tid = threadIdx.x;
  const int nxx = nx * nx, nxu = nx * nu;
  if (tid < nx) dx[tid] = T(0);
  __syncthreads();
  for (int k = 0; k < N; ++k) {
    if (tid < nu) {
      T s = kff[k * nu + tid];
      for (int j = 0; j < nx; ++j) s += K[k * nxu + tid * nx + j] * dx[j];
      du[tid] = s;
      dU[k * nu + tid] = s;
    } else if (tid >= 32 && tid < 32 + nx) {
      dX[k * nx + tid - 32] = dx[tid - 32];
    }
    __syncthreads();
    if (tid < nx) {
      T s = T(0);
      for (int j = 0; j < nx; ++j) s += A[k * nxx + tid * nx + j] * dx[j];
      for (int u = 0; u < nu; ++u) s += B[k * nxu + tid * nu + u] * du[u];
      dxn[tid] = s + req[k * nx + tid];
    }
    __syncthreads();
    if (tid < nx) {
      T s = T(0);
      for (int j = 0; j < nx; ++j) s += Pseq[k * nxx + tid * nx + j] * dxn[j];
      dnu[k * nx + tid] = -(s + pn[k * nx + tid]);
      dx[tid] = dxn[tid];
    }
    __syncthreads();
  }
  if (tid < nx) dX[N * nx + tid] = dx[tid];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) factor_predictor_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ Cxx,
    const T* __restrict__ Cuu, const T* __restrict__ Cxu, const T* __restrict__ PN,
    const T* __restrict__ rbx, const T* __restrict__ rbxN, const T* __restrict__ rbu,
    const T* __restrict__ req, T* __restrict__ dX, T* __restrict__ dU,
    T* __restrict__ dnu, T* __restrict__ Kout, T* __restrict__ FxuTout,
    T* __restrict__ Fuu_tri, T* __restrict__ Fiv_tri, T* __restrict__ Pseq,
    T* __restrict__ kff_g, T* __restrict__ pn_g, int N, int nx, int nu) {
  __shared__ T P[MAXNX * MAXNX], Ak[MAXNX * MAXNX], PA[MAXNX * MAXNX], Fxx[MAXNX * MAXNX];
  __shared__ T Bk[MAXNX * MAXNU], PB[MAXNX * MAXNU], FxuT[MAXNU * MAXNX], Ks[MAXNU * MAXNX];
  __shared__ T p[MAXNX], w[MAXNX], pnew[MAXNX], fu[MAXNU], kff[MAXNU];
  __shared__ T Fuu[MAXNU * MAXNU], Hc[MAXNU * MAXNU], Fiv[MAXNU * MAXNU];
  __shared__ T dx[MAXNX], dxn[MAXNX], du[MAXNU];

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * (nu + 1) / 2;
  const T* A_b = A + b * N * nxx;
  const T* B_b = B + b * N * nxu;
  const T* Cxx_b = Cxx + b * N * nxx;
  const T* Cuu_b = Cuu + b * N * nu * nu;
  const T* Cxu_b = Cxu + b * N * nxu;
  const T* rbx_b = rbx + b * N * nx;
  const T* rbu_b = rbu + b * N * nu;
  const T* req_b = req + b * N * nx;
  T* K_b = Kout + b * N * nxu;
  T* FxuT_b = FxuTout + b * N * nxu;
  T* Fuu_b = Fuu_tri + b * N * nuu;
  T* Fiv_b = Fiv_tri + b * N * nuu;
  T* Pseq_b = Pseq + b * N * nxx;
  T* kff_b = kff_g + b * N * nu;
  T* pn_b = pn_g + b * N * nx;

  for (int i = tid; i < nxx; i += THREADS) P[i] = PN[b * nxx + i];
  for (int i = tid; i < nx; i += THREADS) p[i] = rbxN[b * nx + i];
  __syncthreads();

  for (int k = N - 1; k >= 0; --k) {
    // 1: stage data in, P_{k+1} and p_{k+1} out
    for (int i = tid; i < nxx; i += THREADS) {
      Ak[i] = A_b[k * nxx + i];
      Pseq_b[k * nxx + i] = P[i];
    }
    for (int i = tid; i < nxu; i += THREADS) Bk[i] = B_b[k * nxu + i];
    for (int i = tid; i < nx; i += THREADS) pn_b[k * nx + i] = p[i];
    __syncthreads();

    // 2: PA = P A, PB = P B, w = p + P req
    for (int e = tid; e < nxx + nxu + nx; e += THREADS) {
      if (e < nxx) {
        const int i = e / nx, j = e % nx;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += P[i * nx + l] * Ak[l * nx + j];
        PA[e] = s;
      } else if (e < nxx + nxu) {
        const int e2 = e - nxx, i = e2 / nu, j = e2 % nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += P[i * nx + l] * Bk[l * nu + j];
        PB[e2] = s;
      } else {
        const int i = e - nxx - nxu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += P[i * nx + l] * req_b[k * nx + l];
        w[i] = p[i] + s;
      }
    }
    __syncthreads();

    // 3: Fxx = Cxx + A'PA, Fxu' = Cxu' + B'PA, Fuu = Cuu + B'PB,
    //    f_u = rbu + B'w, pnew = rbx + A'w
    const int n3 = nxx + nxu + nu * nu + nu + nx;
    for (int e = tid; e < n3; e += THREADS) {
      if (e < nxx) {
        const int i = e / nx, j = e % nx;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += Ak[l * nx + i] * PA[l * nx + j];
        Fxx[e] = Cxx_b[k * nxx + e] + s;
      } else if (e < nxx + nxu) {
        const int e2 = e - nxx, u = e2 / nx, j = e2 % nx;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += Bk[l * nu + u] * PA[l * nx + j];
        s += Cxu_b[k * nxu + j * nu + u];
        FxuT[e2] = s;
        FxuT_b[k * nxu + e2] = s;
      } else if (e < nxx + nxu + nu * nu) {
        const int e2 = e - nxx - nxu, u = e2 / nu, v = e2 % nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += Bk[l * nu + u] * PB[l * nu + v];
        Fuu[e2] = Cuu_b[k * nu * nu + e2] + s;
      } else if (e < nxx + nxu + nu * nu + nu) {
        const int u = e - nxx - nxu - nu * nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += Bk[l * nu + u] * w[l];
        fu[u] = rbu_b[k * nu + u] + s;
      } else {
        const int i = e - nxx - nxu - nu * nu - nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += Ak[l * nx + i] * w[l];
        pnew[i] = rbx_b[k * nx + i] + s;
      }
    }
    __syncthreads();

    // 4: Hc = sym(Fuu) + 1e-14 tr(Fuu) I and its inverse
    if (tid == 0) {
      T tr = T(0);
      for (int u = 0; u < nu; ++u) tr += Fuu[u * nu + u];
      for (int u = 0; u < nu; ++u)
        for (int v = 0; v < nu; ++v) {
          T h = T(0.5) * (Fuu[u * nu + v] + Fuu[v * nu + u]);
          if (u == v) h += T(1e-14) * tr;
          Hc[u * nu + v] = h;
        }
      spd_inv_dispatch<T>(Hc, Fiv, nu);
      for (int u = 0; u < nu; ++u)
        for (int v = u; v < nu; ++v) {
          Fuu_b[k * nuu + tri_index(u, v, nu)] = Hc[u * nu + v];
          Fiv_b[k * nuu + tri_index(u, v, nu)] = Fiv[u * nu + v];
        }
    }
    __syncthreads();

    // 5: K = -Hc^{-1} Fxu' (one column per thread), kff = -Hc^{-1} f_u
    if (tid <= nx) {
      T rhs[MAXNU], x[MAXNU];
      for (int u = 0; u < nu; ++u) rhs[u] = (tid < nx) ? FxuT[u * nx + tid] : fu[u];
      neg_refined_solve<T>(Hc, Fiv, rhs, x, nu);
      if (tid < nx) {
        for (int u = 0; u < nu; ++u) {
          Ks[u * nx + tid] = x[u];
          K_b[k * nxu + u * nx + tid] = x[u];
        }
      } else {
        for (int u = 0; u < nu; ++u) {
          kff[u] = x[u];
          kff_b[k * nu + u] = x[u];
        }
      }
    }
    __syncthreads();

    // 6: P = sym(Fxx + Fxu K), p = pnew + Fxu kff
    for (int e = tid; e < nxx + nx; e += THREADS) {
      if (e < nxx) {
        const int i = e / nx, j = e % nx;
        T mij = Fxx[i * nx + j], mji = Fxx[j * nx + i];
        for (int u = 0; u < nu; ++u) {
          mij += FxuT[u * nx + i] * Ks[u * nx + j];
          mji += FxuT[u * nx + j] * Ks[u * nx + i];
        }
        P[e] = T(0.5) * (mij + mji);
      } else {
        const int i = e - nxx;
        T s = pnew[i];
        for (int u = 0; u < nu; ++u) s += FxuT[u * nx + i] * kff[u];
        p[i] = s;
      }
    }
    __syncthreads();
  }

  forward_sweep<T>(A_b, B_b, req_b, K_b, kff_b, Pseq_b, pn_b, dX + b * (N + 1) * nx,
                   dU + b * N * nu, dnu + b * N * nx, N, nx, nu, dx, dxn, du);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) resolve_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ K,
    const T* __restrict__ FxuT, const T* __restrict__ Fuu_tri,
    const T* __restrict__ Fiv_tri, const T* __restrict__ Pseq,
    const T* __restrict__ rbx, const T* __restrict__ rbxN, const T* __restrict__ rbu,
    const T* __restrict__ req, T* __restrict__ dX, T* __restrict__ dU,
    T* __restrict__ dnu, T* __restrict__ kff_g, T* __restrict__ pn_g, int N, int nx,
    int nu) {
  __shared__ T p[MAXNX], w[MAXNX], pnew[MAXNX], fu[MAXNU], kff[MAXNU];
  __shared__ T dx[MAXNX], dxn[MAXNX], du[MAXNU];

  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * (nu + 1) / 2;
  const T* A_b = A + b * N * nxx;
  const T* B_b = B + b * N * nxu;
  const T* K_b = K + b * N * nxu;
  const T* FxuT_b = FxuT + b * N * nxu;
  const T* Fuu_b = Fuu_tri + b * N * nuu;
  const T* Fiv_b = Fiv_tri + b * N * nuu;
  const T* Pseq_b = Pseq + b * N * nxx;
  const T* rbx_b = rbx + b * N * nx;
  const T* rbu_b = rbu + b * N * nu;
  const T* req_b = req + b * N * nx;
  T* kff_b = kff_g + b * N * nu;
  T* pn_b = pn_g + b * N * nx;

  for (int i = tid; i < nx; i += THREADS) p[i] = rbxN[b * nx + i];
  __syncthreads();

  for (int k = N - 1; k >= 0; --k) {
    // w = p + P_{k+1} req
    if (tid < nx) {
      T s = T(0);
      for (int l = 0; l < nx; ++l) s += Pseq_b[k * nxx + tid * nx + l] * req_b[k * nx + l];
      w[tid] = p[tid] + s;
      pn_b[k * nx + tid] = p[tid];
    }
    __syncthreads();
    // f_u = rbu + B'w, pnew = rbx + A'w
    if (tid < nu) {
      T s = T(0);
      for (int l = 0; l < nx; ++l) s += B_b[k * nxu + l * nu + tid] * w[l];
      fu[tid] = rbu_b[k * nu + tid] + s;
    } else if (tid >= 32 && tid < 32 + nx) {
      const int i = tid - 32;
      T s = T(0);
      for (int l = 0; l < nx; ++l) s += A_b[k * nxx + l * nx + i] * w[l];
      pnew[i] = rbx_b[k * nx + i] + s;
    }
    __syncthreads();
    // kff = -Hc^{-1} f_u with the cached inverse and one refinement pass
    if (tid == 0) {
      T Hc[MAXNU * MAXNU], Fiv[MAXNU * MAXNU], x[MAXNU];
      for (int u = 0; u < nu; ++u)
        for (int v = u; v < nu; ++v) {
          const int t = tri_index(u, v, nu);
          Hc[u * nu + v] = Hc[v * nu + u] = Fuu_b[k * nuu + t];
          Fiv[u * nu + v] = Fiv[v * nu + u] = Fiv_b[k * nuu + t];
        }
      neg_refined_solve<T>(Hc, Fiv, fu, x, nu);
      for (int u = 0; u < nu; ++u) {
        kff[u] = x[u];
        kff_b[k * nu + u] = x[u];
      }
    }
    __syncthreads();
    // p = pnew + Fxu kff
    if (tid < nx) {
      T s = pnew[tid];
      for (int u = 0; u < nu; ++u) s += FxuT_b[k * nxu + u * nx + tid] * kff[u];
      p[tid] = s;
    }
    __syncthreads();
  }

  forward_sweep<T>(A_b, B_b, req_b, K_b, kff_b, Pseq_b, pn_b, dX + b * (N + 1) * nx,
                   dU + b * N * nu, dnu + b * N * nx, N, nx, nu, dx, dxn, du);
}

bool dims_ok(int Bsz, int N, int nx, int nu) {
  return Bsz >= 1 && N >= 1 && nx >= 1 && nx <= MAXNX && nu >= 1 && nu <= MAXNU;
}

template <typename T>
int launch_factor_predictor(const T* A, const T* B, const T* Cxx, const T* Cuu,
                            const T* Cxu, const T* PN, const T* rbx, const T* rbxN,
                            const T* rbu, const T* req, T* dX, T* dU, T* dnu, T* K,
                            T* FxuT, T* Fuu_tri, T* Fiv_tri, T* Pseq, T* kff, T* pn,
                            int Bsz, int N, int nx, int nu, cudaStream_t stream) {
  if (!dims_ok(Bsz, N, nx, nu)) return (int)cudaErrorInvalidValue;
  factor_predictor_kernel<T><<<Bsz, THREADS, 0, stream>>>(
      A, B, Cxx, Cuu, Cxu, PN, rbx, rbxN, rbu, req, dX, dU, dnu, K, FxuT, Fuu_tri,
      Fiv_tri, Pseq, kff, pn, N, nx, nu);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_resolve(const T* A, const T* B, const T* K, const T* FxuT, const T* Fuu_tri,
                   const T* Fiv_tri, const T* Pseq, const T* rbx, const T* rbxN,
                   const T* rbu, const T* req, T* dX, T* dU, T* dnu, T* kff, T* pn,
                   int Bsz, int N, int nx, int nu, cudaStream_t stream) {
  if (!dims_ok(Bsz, N, nx, nu)) return (int)cudaErrorInvalidValue;
  resolve_kernel<T><<<Bsz, THREADS, 0, stream>>>(A, B, K, FxuT, Fuu_tri, Fiv_tri, Pseq,
                                                 rbx, rbxN, rbu, req, dX, dU, dnu, kff,
                                                 pn, N, nx, nu);
  return (int)cudaGetLastError();
}

}  // namespace

#define RNM_FP_ARGS(T)                                                                 \
  const T *A, const T *B, const T *Cxx, const T *Cuu, const T *Cxu, const T *PN,       \
      const T *rbx, const T *rbxN, const T *rbu, const T *req, T *dX, T *dU, T *dnu,   \
      T *K, T *FxuT, T *Fuu_tri, T *Fiv_tri, T *Pseq, T *kff, T *pn, int Bsz, int N,   \
      int nx, int nu, void *stream
#define RNM_RS_ARGS(T)                                                                 \
  const T *A, const T *B, const T *K, const T *FxuT, const T *Fuu_tri,                 \
      const T *Fiv_tri, const T *Pseq, const T *rbx, const T *rbxN, const T *rbu,      \
      const T *req, T *dX, T *dU, T *dnu, T *kff, T *pn, int Bsz, int N, int nx,       \
      int nu, void *stream

extern "C" {

int rnm_factor_predictor_f32(RNM_FP_ARGS(float)) {
  return launch_factor_predictor<float>(A, B, Cxx, Cuu, Cxu, PN, rbx, rbxN, rbu, req,
                                        dX, dU, dnu, K, FxuT, Fuu_tri, Fiv_tri, Pseq,
                                        kff, pn, Bsz, N, nx, nu, (cudaStream_t)stream);
}

int rnm_factor_predictor_f64(RNM_FP_ARGS(double)) {
  return launch_factor_predictor<double>(A, B, Cxx, Cuu, Cxu, PN, rbx, rbxN, rbu, req,
                                         dX, dU, dnu, K, FxuT, Fuu_tri, Fiv_tri, Pseq,
                                         kff, pn, Bsz, N, nx, nu, (cudaStream_t)stream);
}

int rnm_resolve_f32(RNM_RS_ARGS(float)) {
  return launch_resolve<float>(A, B, K, FxuT, Fuu_tri, Fiv_tri, Pseq, rbx, rbxN, rbu,
                               req, dX, dU, dnu, kff, pn, Bsz, N, nx, nu,
                               (cudaStream_t)stream);
}

int rnm_resolve_f64(RNM_RS_ARGS(double)) {
  return launch_resolve<double>(A, B, K, FxuT, Fuu_tri, Fiv_tri, Pseq, rbx, rbxN, rbu,
                                req, dX, dU, dnu, kff, pn, Bsz, N, nx, nu,
                                (cudaStream_t)stream);
}

const char* rnm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

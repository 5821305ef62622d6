// Device building blocks of the Riccati Newton solves, shared by the fused
// Newton kernels (fused_qp.cu) and the whole-iteration kernel (fused_ipm.cu).
//
// Each function runs on one thread block and works on one lane (one QP):
// every pointer is already offset to that lane. The current stage's
// matrices live in shared memory (`FactorSmem` / `SweepSmem`, declared by
// the calling kernel); the per-stage sequences (K, Fxu', the Fuu and
// inverse triangles, P_{k+1}, kff, p_{k+1}) go to device memory.
//
// The pointers carry no __restrict__: the whole-iteration kernel hands in
// right-hand sides it wrote itself a moment earlier, which the read-only
// data path must not serve stale.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rnm {

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

// Shared memory of the feedforward and forward sweeps.
template <typename T>
struct SweepSmem {
  T p[MAXNX], w[MAXNX], pnew[MAXNX], fu[MAXNU], kff[MAXNU];
  T dx[MAXNX], dxn[MAXNX], du[MAXNU];
};

// Shared memory of the factorization: the current stage's blocks.
template <typename T>
struct FactorSmem {
  T P[MAXNX * MAXNX], Ak[MAXNX * MAXNX], PA[MAXNX * MAXNX], Fxx[MAXNX * MAXNX];
  T Bk[MAXNX * MAXNU], PB[MAXNX * MAXNU], FxuT[MAXNU * MAXNX], Ks[MAXNU * MAXNX];
  T Fuu[MAXNU * MAXNU], Hc[MAXNU * MAXNU], Fiv[MAXNU * MAXNU];
  SweepSmem<T> v;
};

// Forward sweep: du = K dx + kff, dx+ = A dx + B du + req,
// dnu = -(P_{k+1} dx+ + p_{k+1}).
template <typename T>
__device__ void forward_sweep(const T* A, const T* B, const T* req, const T* K,
                              const T* kff, const T* Pseq, const T* pn, T* dX, T* dU,
                              T* dnu, int N, int nx, int nu, SweepSmem<T>& sm) {
  const int tid = threadIdx.x;
  const int nxx = nx * nx, nxu = nx * nu;
  T* dx = sm.dx;
  T* dxn = sm.dxn;
  T* du = sm.du;
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
  __syncthreads();
}

// Riccati factorization fused with the predictor's feedforward sweep (reverse
// stage loop), then the forward sweep: (dX, dU, dnu) and the cached factors.
template <typename T>
__device__ void factor_predictor_lane(
    const T* A_b, const T* B_b, const T* Cxx_b, const T* Cuu_b, const T* Cxu_b,
    const T* PN_b, const T* rbx_b, const T* rbxN_b, const T* rbu_b, const T* req_b,
    T* dX_b, T* dU_b, T* dnu_b, T* K_b, T* FxuT_b, T* Fuu_b, T* Fiv_b, T* Pseq_b,
    T* kff_b, T* pn_b, int N, int nx, int nu, FactorSmem<T>& sm) {
  const int tid = threadIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * (nu + 1) / 2;
  T* P = sm.P;
  T* p = sm.v.p;
  T* w = sm.v.w;
  T* pnew = sm.v.pnew;
  T* fu = sm.v.fu;
  T* kff = sm.v.kff;

  for (int i = tid; i < nxx; i += THREADS) P[i] = PN_b[i];
  for (int i = tid; i < nx; i += THREADS) p[i] = rbxN_b[i];
  __syncthreads();

  for (int k = N - 1; k >= 0; --k) {
    // 1: stage data in, P_{k+1} and p_{k+1} out
    for (int i = tid; i < nxx; i += THREADS) {
      sm.Ak[i] = A_b[k * nxx + i];
      Pseq_b[k * nxx + i] = P[i];
    }
    for (int i = tid; i < nxu; i += THREADS) sm.Bk[i] = B_b[k * nxu + i];
    for (int i = tid; i < nx; i += THREADS) pn_b[k * nx + i] = p[i];
    __syncthreads();

    // 2: PA = P A, PB = P B, w = p + P req
    for (int e = tid; e < nxx + nxu + nx; e += THREADS) {
      if (e < nxx) {
        const int i = e / nx, j = e % nx;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += P[i * nx + l] * sm.Ak[l * nx + j];
        sm.PA[e] = s;
      } else if (e < nxx + nxu) {
        const int e2 = e - nxx, i = e2 / nu, j = e2 % nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += P[i * nx + l] * sm.Bk[l * nu + j];
        sm.PB[e2] = s;
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
        for (int l = 0; l < nx; ++l) s += sm.Ak[l * nx + i] * sm.PA[l * nx + j];
        sm.Fxx[e] = Cxx_b[k * nxx + e] + s;
      } else if (e < nxx + nxu) {
        const int e2 = e - nxx, u = e2 / nx, j = e2 % nx;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += sm.Bk[l * nu + u] * sm.PA[l * nx + j];
        s += Cxu_b[k * nxu + j * nu + u];
        sm.FxuT[e2] = s;
        FxuT_b[k * nxu + e2] = s;
      } else if (e < nxx + nxu + nu * nu) {
        const int e2 = e - nxx - nxu, u = e2 / nu, v = e2 % nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += sm.Bk[l * nu + u] * sm.PB[l * nu + v];
        sm.Fuu[e2] = Cuu_b[k * nu * nu + e2] + s;
      } else if (e < nxx + nxu + nu * nu + nu) {
        const int u = e - nxx - nxu - nu * nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += sm.Bk[l * nu + u] * w[l];
        fu[u] = rbu_b[k * nu + u] + s;
      } else {
        const int i = e - nxx - nxu - nu * nu - nu;
        T s = T(0);
        for (int l = 0; l < nx; ++l) s += sm.Ak[l * nx + i] * w[l];
        pnew[i] = rbx_b[k * nx + i] + s;
      }
    }
    __syncthreads();

    // 4: Hc = sym(Fuu) + 1e-14 tr(Fuu) I and its inverse
    if (tid == 0) {
      T tr = T(0);
      for (int u = 0; u < nu; ++u) tr += sm.Fuu[u * nu + u];
      for (int u = 0; u < nu; ++u)
        for (int v = 0; v < nu; ++v) {
          T h = T(0.5) * (sm.Fuu[u * nu + v] + sm.Fuu[v * nu + u]);
          if (u == v) h += T(1e-14) * tr;
          sm.Hc[u * nu + v] = h;
        }
      spd_inv_dispatch<T>(sm.Hc, sm.Fiv, nu);
      for (int u = 0; u < nu; ++u)
        for (int v = u; v < nu; ++v) {
          Fuu_b[k * nuu + tri_index(u, v, nu)] = sm.Hc[u * nu + v];
          Fiv_b[k * nuu + tri_index(u, v, nu)] = sm.Fiv[u * nu + v];
        }
    }
    __syncthreads();

    // 5: K = -Hc^{-1} Fxu' (one column per thread), kff = -Hc^{-1} f_u
    if (tid <= nx) {
      T rhs[MAXNU], x[MAXNU];
      for (int u = 0; u < nu; ++u) rhs[u] = (tid < nx) ? sm.FxuT[u * nx + tid] : fu[u];
      neg_refined_solve<T>(sm.Hc, sm.Fiv, rhs, x, nu);
      if (tid < nx) {
        for (int u = 0; u < nu; ++u) {
          sm.Ks[u * nx + tid] = x[u];
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
        T mij = sm.Fxx[i * nx + j], mji = sm.Fxx[j * nx + i];
        for (int u = 0; u < nu; ++u) {
          mij += sm.FxuT[u * nx + i] * sm.Ks[u * nx + j];
          mji += sm.FxuT[u * nx + j] * sm.Ks[u * nx + i];
        }
        P[e] = T(0.5) * (mij + mji);
      } else {
        const int i = e - nxx;
        T s = pnew[i];
        for (int u = 0; u < nu; ++u) s += sm.FxuT[u * nx + i] * kff[u];
        p[i] = s;
      }
    }
    __syncthreads();
  }

  forward_sweep<T>(A_b, B_b, req_b, K_b, kff_b, Pseq_b, pn_b, dX_b, dU_b, dnu_b, N, nx,
                   nu, sm.v);
}

// The corrector's feedforward sweep against the cached factors, then the
// forward sweep.
template <typename T>
__device__ void resolve_lane(const T* A_b, const T* B_b, const T* K_b, const T* FxuT_b,
                             const T* Fuu_b, const T* Fiv_b, const T* Pseq_b,
                             const T* rbx_b, const T* rbxN_b, const T* rbu_b,
                             const T* req_b, T* dX_b, T* dU_b, T* dnu_b, T* kff_b,
                             T* pn_b, int N, int nx, int nu, SweepSmem<T>& sm) {
  const int tid = threadIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * (nu + 1) / 2;
  T* p = sm.p;
  T* w = sm.w;
  T* pnew = sm.pnew;
  T* fu = sm.fu;
  T* kff = sm.kff;

  for (int i = tid; i < nx; i += THREADS) p[i] = rbxN_b[i];
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

  forward_sweep<T>(A_b, B_b, req_b, K_b, kff_b, Pseq_b, pn_b, dX_b, dU_b, dnu_b, N, nx,
                   nu, sm);
}

inline bool dims_ok(int Bsz, int N, int nx, int nu) {
  return Bsz >= 1 && N >= 1 && nx >= 1 && nx <= MAXNX && nu >= 1 && nu <= MAXNU;
}

}  // namespace rnm

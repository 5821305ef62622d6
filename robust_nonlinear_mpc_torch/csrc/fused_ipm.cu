// One whole Mehrotra predictor-corrector iteration of the interior-point QP
// as one kernel, for NVIDIA Hopper (sm_90a). Bound to PyTorch through a
// plain C interface (ctypes) by robust_nonlinear_mpc_torch/ops/fused_qp.py
// (`ipm_iteration`), which also holds its plain torch twin.
//
// Replaces robust_nonlinear_mpc_tpu/ops/pallas_qp.py `_ipm_iter_kernel`
// (wrapper `_ipm_iter_batched`, semantics `_fallback_ipm_iter`). Per lane it
// runs: the predictor rhs (t = (lam rineq - rcomp) / s and the reduced
// stationarity rhs), the Riccati factorization with the predictor solve, the
// slack / dual recovery, both fraction-to-boundary steps, mu_aff and sigma,
// the corrector rhs and solve against the cached factors, the update (lanes
// marked done keep their iterate), the fresh residuals, the KKT scalar, and
// the revert of a lane whose new KKT scalar is not finite (iterate and
// residuals back to the input, the old KKT scalar reported). The curvature
// Gram products (Cxx, Cuu, Cxu, PN from W = lam / s) come in from the
// wrapper, as the Pallas wrapper computes them outside its kernel too.
//
// Design. One thread block per lane, as the Newton kernels: the stage loops
// are the same device functions (newton.cuh). The per-stage sequences and
// the per-lane vectors (factors, rhs, directions, t, rcomp) sit in a
// device-memory workspace the wrapper allocates; shared memory holds only
// the current stage's blocks and a reduction buffer, so no N or ni limit
// applies. The per-lane sums (mu, mu_aff, the gap), minima (the ratios of the
// fraction-to-boundary rule) and max-abs terms of the KKT scalar are block
// reductions; min and max propagate NaN, as jnp.min / torch.amin do.
//
// Bound: latency, like the Newton kernels it contains: two sequential
// stage loops per lane plus a dozen short elementwise passes separated by
// barriers. The bytes it must move (the lane's data, curvature, iterate
// and residuals, about 75 KB per lane in float32 at the rocket's widths)
// would take 11.5 us at 3.35 TB/s for B = 512; its 0.39 GFLOP 5.9 us at the
// float32 peak (chip_smoke.kernel_bound).

#include "newton.cuh"

namespace {

using namespace rnm;

template <typename T>
struct IpmArgs {
  // problem data (batch-leading) and shared statics
  const T *A, *B, *c, *qx, *qu, *h, *hf;
  const T *Gx, *Gu, *Gf, *Hx, *Hu, *HxN;
  // curvature of this iteration
  const T *Cxx, *Cuu, *Cxu, *PN;
  // iterate and carried residuals (rx with a zero row 0)
  const T *X, *U, *lam, *s, *lamf, *sf, *nu;
  const T *req, *rineq, *rineqf, *rx, *rxN, *ru;
  const T* scale_p;
  const unsigned char* done;
  // outputs
  T *Xo, *Uo, *lamo, *so, *lamfo, *sfo, *nuo;
  T *reqo, *rineqo, *rineqfo, *rxo, *rxNo, *ruo, *res;
  unsigned char* bad;
  // workspace
  T *rbx, *rbxN, *rbu, *dX, *dU, *dnu, *K, *FxuT, *Fuu_tri, *Fiv_tri, *Pseq, *kff, *pn;
  T *ds, *dlam, *dsf, *dlamf, *t, *tf, *rcomp, *rcompf;
};

constexpr int IPM_NPTRS = 68;

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ double nan_min(double a, double b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ double nan_max(double a, double b) { return (a > b || a != a) ? a : b; }

struct SumOp {
  template <typename T> __device__ T operator()(T a, T b) const { return a + b; }
};
struct MinOp {
  template <typename T> __device__ T operator()(T a, T b) const { return nan_min(a, b); }
};
struct MaxOp {
  template <typename T> __device__ T operator()(T a, T b) const { return nan_max(a, b); }
};

// Reduce one value per thread over the block; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = op(red[tid], red[tid + s]);
    __syncthreads();
  }
  const T r = red[0];
  __syncthreads();
  return r;
}

template <typename T>
__device__ __forceinline__ T inf_value();
template <>
__device__ __forceinline__ float inf_value<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double inf_value<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ipm_iter_kernel(IpmArgs<T> a, int N, int nx,
                                                           int nu, int ni, int ni_f,
                                                           T tau, T n_comp) {
  __shared__ FactorSmem<T> sm;
  __shared__ T red_buf[THREADS];
  T* red = red_buf;
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * (nu + 1) / 2;
  const int Nni = N * ni;
  const T inf = inf_value<T>();

  // lane views
  const T* A = a.A + b * N * nxx;
  const T* Bm = a.B + b * N * nxu;
  const T* c = a.c + b * N * nx;
  const T* qx = a.qx + b * (N + 1) * nx;
  const T* qu = a.qu + b * N * nu;
  const T* h = a.h + b * Nni;
  const T* hf = a.hf + b * ni_f;
  const T* X = a.X + b * (N + 1) * nx;
  const T* U = a.U + b * N * nu;
  const T* lam = a.lam + b * Nni;
  const T* s = a.s + b * Nni;
  const T* lamf = a.lamf + b * ni_f;
  const T* sf = a.sf + b * ni_f;
  const T* nu_d = a.nu + b * N * nx;
  const T* req = a.req + b * N * nx;
  const T* rineq = a.rineq + b * Nni;
  const T* rineqf = a.rineqf + b * ni_f;
  const T* rx = a.rx + b * N * nx;
  const T* rxN = a.rxN + b * nx;
  const T* ru = a.ru + b * N * nu;
  const T* Gx = a.Gx;
  const T* Gu = a.Gu;
  const T* Gf = a.Gf;
  T* Xo = a.Xo + b * (N + 1) * nx;
  T* Uo = a.Uo + b * N * nu;
  T* lamo = a.lamo + b * Nni;
  T* so = a.so + b * Nni;
  T* lamfo = a.lamfo + b * ni_f;
  T* sfo = a.sfo + b * ni_f;
  T* nuo = a.nuo + b * N * nx;
  T* reqo = a.reqo + b * N * nx;
  T* rineqo = a.rineqo + b * Nni;
  T* rineqfo = a.rineqfo + b * ni_f;
  T* rxo = a.rxo + b * N * nx;
  T* rxNo = a.rxNo + b * nx;
  T* ruo = a.ruo + b * N * nu;
  T* rbx = a.rbx + b * N * nx;
  T* rbxN = a.rbxN + b * nx;
  T* rbu = a.rbu + b * N * nu;
  T* dX = a.dX + b * (N + 1) * nx;
  T* dU = a.dU + b * N * nu;
  T* dnu = a.dnu + b * N * nx;
  T* K = a.K + b * N * nxu;
  T* FxuT = a.FxuT + b * N * nxu;
  T* Fuu_tri = a.Fuu_tri + b * N * nuu;
  T* Fiv_tri = a.Fiv_tri + b * N * nuu;
  T* Pseq = a.Pseq + b * N * nxx;
  T* kff = a.kff + b * N * nu;
  T* pn = a.pn + b * N * nx;
  T* ds = a.ds + b * Nni;
  T* dlam = a.dlam + b * Nni;
  T* dsf = a.dsf + b * ni_f;
  T* dlamf = a.dlamf + b * ni_f;
  T* t = a.t + b * Nni;
  T* tf = a.tf + b * ni_f;
  T* rcomp = a.rcomp + b * Nni;
  T* rcompf = a.rcompf + b * ni_f;

  // ---- mu ----
  T acc = T(0);
  for (int e = tid; e < Nni; e += THREADS) acc += lam[e] * s[e];
  for (int e = tid; e < ni_f; e += THREADS) acc += lamf[e] * sf[e];
  const T mu = block_reduce(acc, red, SumOp()) / n_comp;

  // reduced rhs: rbx_k = rx_k + Gx_k' t_k (row 0 = 0), rbxN = rxN + Gf' t_f,
  // rbu_k = ru_k + Gu_k' t_k, with t from the complementarity rhs in rcomp
  auto assemble_rhs = [&]() {
    for (int e = tid; e < Nni; e += THREADS) t[e] = (lam[e] * rineq[e] - rcomp[e]) / s[e];
    for (int e = tid; e < ni_f; e += THREADS) tf[e] = (lamf[e] * rineqf[e] - rcompf[e]) / sf[e];
    __syncthreads();
    for (int e = tid; e < N * nx + nx + N * nu; e += THREADS) {
      if (e < N * nx) {
        const int k = e / nx, i = e % nx;
        T v = T(0);
        if (k > 0) {
          v = rx[e];
          for (int r = 0; r < ni; ++r) v += Gx[(k * ni + r) * nx + i] * t[k * ni + r];
        }
        rbx[e] = v;
      } else if (e < N * nx + nx) {
        const int i = e - N * nx;
        T v = rxN[i];
        for (int r = 0; r < ni_f; ++r) v += Gf[r * nx + i] * tf[r];
        rbxN[i] = v;
      } else {
        const int e2 = e - N * nx - nx, k = e2 / nu, u = e2 % nu;
        T v = ru[e2];
        for (int r = 0; r < ni; ++r) v += Gu[(k * ni + r) * nu + u] * t[k * ni + r];
        rbu[e2] = v;
      }
    }
    __syncthreads();
  };

  // ds = -rineq - (Gx dX + Gu dU), dlam = -(rcomp + lam ds) / s (and terminal)
  auto recover = [&]() {
    for (int e = tid; e < Nni + ni_f; e += THREADS) {
      if (e < Nni) {
        const int k = e / ni;
        T g = T(0);
        for (int i = 0; i < nx; ++i) g += Gx[e * nx + i] * dX[k * nx + i];
        for (int u = 0; u < nu; ++u) g += Gu[e * nu + u] * dU[k * nu + u];
        const T d = -rineq[e] - g;
        ds[e] = d;
        dlam[e] = -(rcomp[e] + lam[e] * d) / s[e];
      } else {
        const int r = e - Nni;
        T g = T(0);
        for (int i = 0; i < nx; ++i) g += Gf[r * nx + i] * dX[N * nx + i];
        const T d = -rineqf[r] - g;
        dsf[r] = d;
        dlamf[r] = -(rcompf[r] + lamf[r] * d) / sf[r];
      }
    }
    __syncthreads();
  };

  // max alpha in (0, 1] with v + alpha dv >= (1 - tau) v over (v, dv) pairs
  auto step_to_boundary = [&](const T* v, const T* dv, const T* vf, const T* dvf,
                              T tau_) {
    T m = inf;
    for (int e = tid; e < Nni; e += THREADS)
      if (dv[e] < T(0)) m = nan_min(m, -v[e] / dv[e]);
    for (int e = tid; e < ni_f; e += THREADS)
      if (dvf[e] < T(0)) m = nan_min(m, -vf[e] / dvf[e]);
    return nan_min(T(1), tau_ * block_reduce(m, red, MinOp()));
  };

  // ---- predictor (affine) step ----
  for (int e = tid; e < Nni; e += THREADS) rcomp[e] = lam[e] * s[e];
  for (int e = tid; e < ni_f; e += THREADS) rcompf[e] = lamf[e] * sf[e];
  __syncthreads();
  assemble_rhs();
  factor_predictor_lane<T>(A, Bm, a.Cxx + b * N * nxx, a.Cuu + b * N * nu * nu,
                           a.Cxu + b * N * nxu, a.PN + b * nxx, rbx, rbxN, rbu, req, dX,
                           dU, dnu, K, FxuT, Fuu_tri, Fiv_tri, Pseq, kff, pn, N, nx, nu,
                           sm);
  recover();
  const T ap_a = step_to_boundary(s, ds, sf, dsf, T(1));
  const T ad_a = step_to_boundary(lam, dlam, lamf, dlamf, T(1));
  acc = T(0);
  for (int e = tid; e < Nni; e += THREADS)
    acc += (s[e] + ap_a * ds[e]) * (lam[e] + ad_a * dlam[e]);
  for (int e = tid; e < ni_f; e += THREADS)
    acc += (sf[e] + ap_a * dsf[e]) * (lamf[e] + ad_a * dlamf[e]);
  const T mu_aff = block_reduce(acc, red, SumOp()) / n_comp;
  T q = mu_aff / nan_max(mu, T(1e-30));
  q = q * q * q;
  const T sigma = (q != q) ? q : (q < T(0) ? T(0) : (q > T(1) ? T(1) : q));
  const T smu = sigma * mu;

  // ---- corrector step ----
  for (int e = tid; e < Nni; e += THREADS) rcomp[e] = lam[e] * s[e] + ds[e] * dlam[e] - smu;
  for (int e = tid; e < ni_f; e += THREADS)
    rcompf[e] = lamf[e] * sf[e] + dsf[e] * dlamf[e] - smu;
  __syncthreads();
  assemble_rhs();
  resolve_lane<T>(A, Bm, K, FxuT, Fuu_tri, Fiv_tri, Pseq, rbx, rbxN, rbu, req, dX, dU, dnu,
                  kff, pn, N, nx, nu, sm.v);
  recover();
  const T ap = step_to_boundary(s, ds, sf, dsf, tau);
  const T ad = step_to_boundary(lam, dlam, lamf, dlamf, tau);

  // ---- update; a lane marked done keeps its iterate ----
  const bool frozen = a.done[b] != 0;
  for (int e = tid; e < (N + 1) * nx; e += THREADS) Xo[e] = frozen ? X[e] : X[e] + ap * dX[e];
  for (int e = tid; e < N * nu; e += THREADS) Uo[e] = frozen ? U[e] : U[e] + ap * dU[e];
  for (int e = tid; e < Nni; e += THREADS) {
    so[e] = frozen ? s[e] : s[e] + ap * ds[e];
    lamo[e] = frozen ? lam[e] : lam[e] + ad * dlam[e];
  }
  for (int e = tid; e < ni_f; e += THREADS) {
    sfo[e] = frozen ? sf[e] : sf[e] + ap * dsf[e];
    lamfo[e] = frozen ? lamf[e] : lamf[e] + ad * dlamf[e];
  }
  for (int e = tid; e < N * nx; e += THREADS) nuo[e] = frozen ? nu_d[e] : nu_d[e] + ad * dnu[e];
  __syncthreads();

  // ---- residuals at the new iterate, and the KKT scalar's terms ----
  T mp = T(0), md = T(0), sc = T(0), gap = T(0);
  for (int e = tid; e < N * nx; e += THREADS) {
    const int k = e / nx, i = e % nx;
    // dynamics: A x_k + B u_k + c_k - x_{k+1}
    T v = T(0);
    for (int j = 0; j < nx; ++j) v += A[k * nxx + i * nx + j] * Xo[k * nx + j];
    for (int u = 0; u < nu; ++u) v += Bm[k * nxu + i * nu + u] * Uo[k * nu + u];
    v += c[e] - Xo[(k + 1) * nx + i];
    reqo[e] = v;
    mp = nan_max(mp, fabs(v));
    // stationarity in x_k, k = 1..N-1 (row 0 pinned to zero)
    T r = T(0);
    if (k > 0) {
      for (int j = 0; j < nx; ++j) r += a.Hx[k * nxx + i * nx + j] * Xo[k * nx + j];
      r += qx[e];
      for (int l = 0; l < ni; ++l) r += Gx[(k * ni + l) * nx + i] * lamo[k * ni + l];
      r += nuo[(k - 1) * nx + i];
      T at = T(0);
      for (int j = 0; j < nx; ++j) at += A[k * nxx + j * nx + i] * nuo[k * nx + j];
      r -= at;
    }
    rxo[e] = r;
    md = nan_max(md, fabs(r));
  }
  for (int e = tid; e < Nni; e += THREADS) {
    const int k = e / ni;
    T v = T(0);
    for (int i = 0; i < nx; ++i) v += Gx[e * nx + i] * Xo[k * nx + i];
    for (int u = 0; u < nu; ++u) v += Gu[e * nu + u] * Uo[k * nu + u];
    v += so[e] - h[e];
    rineqo[e] = v;
    mp = nan_max(mp, fabs(v));
    gap += lamo[e] * so[e];
    sc = nan_max(sc, fabs(lamo[e]));
  }
  for (int e = tid; e < ni_f; e += THREADS) {
    T v = T(0);
    for (int i = 0; i < nx; ++i) v += Gf[e * nx + i] * Xo[N * nx + i];
    v += sfo[e] - hf[e];
    rineqfo[e] = v;
    mp = nan_max(mp, fabs(v));
    gap += lamfo[e] * sfo[e];
    sc = nan_max(sc, fabs(lamfo[e]));
  }
  for (int e = tid; e < nx; e += THREADS) {
    T r = T(0);
    for (int j = 0; j < nx; ++j) r += a.HxN[e * nx + j] * Xo[N * nx + j];
    r += qx[N * nx + e];
    for (int l = 0; l < ni_f; ++l) r += Gf[l * nx + e] * lamfo[l];
    r += nuo[(N - 1) * nx + e];
    rxNo[e] = r;
    md = nan_max(md, fabs(r));
  }
  for (int e = tid; e < N * nu; e += THREADS) {
    const int k = e / nu, u = e % nu;
    T r = T(0);
    for (int v = 0; v < nu; ++v) r += a.Hu[(k * nu + u) * nu + v] * Uo[k * nu + v];
    r += qu[e];
    for (int l = 0; l < ni; ++l) r += Gu[(k * ni + l) * nu + u] * lamo[k * ni + l];
    T bt = T(0);
    for (int j = 0; j < nx; ++j) bt += Bm[k * nxu + j * nu + u] * nuo[k * nx + j];
    r -= bt;
    ruo[e] = r;
    md = nan_max(md, fabs(r));
  }
  T qmax = T(0);
  for (int e = tid; e < (N + 1) * nx; e += THREADS) qmax = nan_max(qmax, fabs(qx[e]));
  for (int e = tid; e < N * nu; e += THREADS) qmax = nan_max(qmax, fabs(qu[e]));
  const T scale_p = a.scale_p[b];
  const T q_abs = block_reduce(qmax, red, MaxOp());
  const T res_p = block_reduce(mp, red, MaxOp()) / scale_p;
  const T scale_d = T(1) + nan_max(q_abs, block_reduce(sc, red, MaxOp()));
  const T res_d = block_reduce(md, red, MaxOp()) / scale_d;
  const T gap_n = block_reduce(gap, red, SumOp()) / n_comp;
  const T res_new = nan_max(nan_max(res_p, res_d), gap_n / scale_d);
  const bool is_bad = !isfinite(res_new);

  T res_out = res_new;
  if (is_bad) {
    // revert the iterate and its residuals; report the old KKT scalar
    for (int e = tid; e < (N + 1) * nx; e += THREADS) Xo[e] = X[e];
    for (int e = tid; e < N * nu; e += THREADS) {
      Uo[e] = U[e];
      ruo[e] = ru[e];
    }
    for (int e = tid; e < Nni; e += THREADS) {
      so[e] = s[e];
      lamo[e] = lam[e];
      rineqo[e] = rineq[e];
    }
    for (int e = tid; e < ni_f; e += THREADS) {
      sfo[e] = sf[e];
      lamfo[e] = lamf[e];
      rineqfo[e] = rineqf[e];
    }
    for (int e = tid; e < N * nx; e += THREADS) {
      nuo[e] = nu_d[e];
      reqo[e] = req[e];
      rxo[e] = rx[e];
    }
    for (int e = tid; e < nx; e += THREADS) rxNo[e] = rxN[e];
    mp = T(0), md = T(0), sc = T(0), gap = T(0);
    for (int e = tid; e < N * nx; e += THREADS) {
      mp = nan_max(mp, fabs(req[e]));
      md = nan_max(md, fabs(rx[e]));
    }
    for (int e = tid; e < Nni; e += THREADS) {
      mp = nan_max(mp, fabs(rineq[e]));
      gap += lam[e] * s[e];
      sc = nan_max(sc, fabs(lam[e]));
    }
    for (int e = tid; e < ni_f; e += THREADS) {
      mp = nan_max(mp, fabs(rineqf[e]));
      gap += lamf[e] * sf[e];
      sc = nan_max(sc, fabs(lamf[e]));
    }
    for (int e = tid; e < nx; e += THREADS) md = nan_max(md, fabs(rxN[e]));
    for (int e = tid; e < N * nu; e += THREADS) md = nan_max(md, fabs(ru[e]));
    const T rp = block_reduce(mp, red, MaxOp()) / scale_p;
    const T sd_old = T(1) + nan_max(q_abs, block_reduce(sc, red, MaxOp()));
    const T rd = block_reduce(md, red, MaxOp()) / sd_old;
    const T g_old = block_reduce(gap, red, SumOp()) / n_comp;
    res_out = nan_max(nan_max(rp, rd), g_old / sd_old);
  }
  if (tid == 0) {
    a.res[b] = res_out;
    a.bad[b] = is_bad ? 1 : 0;
  }
}

template <typename T>
int launch_ipm_iter(void* const* ptrs, int nptrs, int Bsz, int N, int nx, int nu, int ni,
                    int ni_f, double tau, double n_comp, cudaStream_t stream) {
  if (nptrs != IPM_NPTRS || !dims_ok(Bsz, N, nx, nu) || ni < 1 || ni_f < 1)
    return (int)cudaErrorInvalidValue;
  static_assert(sizeof(IpmArgs<T>) == IPM_NPTRS * sizeof(void*), "IpmArgs layout");
  IpmArgs<T> a;
  void** slots = reinterpret_cast<void**>(&a);
  for (int i = 0; i < IPM_NPTRS; ++i) slots[i] = ptrs[i];
  ipm_iter_kernel<T><<<Bsz, THREADS, 0, stream>>>(a, N, nx, nu, ni, ni_f, T(tau),
                                                  T(n_comp));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rnm_ipm_iter_f32(void* const* ptrs, int nptrs, int Bsz, int N, int nx, int nu, int ni,
                     int ni_f, double tau, double n_comp, void* stream) {
  return launch_ipm_iter<float>(ptrs, nptrs, Bsz, N, nx, nu, ni, ni_f, tau, n_comp,
                                (cudaStream_t)stream);
}

int rnm_ipm_iter_f64(void* const* ptrs, int nptrs, int Bsz, int N, int nx, int nu, int ni,
                     int ni_f, double tau, double n_comp, void* stream) {
  return launch_ipm_iter<double>(ptrs, nptrs, Bsz, N, nx, nu, ni, ni_f, tau, n_comp,
                                 (cudaStream_t)stream);
}

}  // extern "C"

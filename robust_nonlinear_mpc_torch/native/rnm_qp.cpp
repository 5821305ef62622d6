// rnm_qp.cpp — native C++ horizon-structured QP solver.
//
// The native-runtime counterpart of ops/qp_ipm.py: a Mehrotra
// predictor-corrector primal-dual interior point whose Newton step is a
// block-tridiagonal Riccati factorization over the horizon. This fills the
// role the code-generated OSQP C extension plays in the reference
// (solver/qp_jit.py backends "osqp"/"osqp_codegen") — a native CPU QP
// backend with fixed problem structure and numeric-only per-iteration
// updates — and doubles as an independent oracle for the XLA kernel.
//
// Problem:
//   min   sum_k x'Qx + u'Ru + xN'Qf xN + q'y     (H* = 2Q etc. passed in)
//   s.t.  x_0 = xinit
//         x_{k+1} = A_k x_k + B_k u_k + c_k
//         Gx x_k + Gu u_k <= h_k,   Gf x_N <= hf
//
// No external dependencies; self-contained dense linear algebra sized for
// MPC blocks (nx, nu <= ~64). Row-major storage throughout.
//
// Build: g++ -O3 -march=native -shared -fPIC -o librnm_qp.so rnm_qp.cpp

#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

using std::vector;

// ---- small dense helpers (row-major) ---------------------------------
inline void matmul(const double* A, const double* B, double* C, int m, int k,
                   int n) {  // C = A(m,k) B(k,n)
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      double s = 0;
      for (int p = 0; p < k; ++p) s += A[i * k + p] * B[p * n + j];
      C[i * n + j] = s;
    }
}

inline void matmul_tn(const double* A, const double* B, double* C, int m,
                      int k, int n) {  // C = A(k,m)' B(k,n)
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) {
      double s = 0;
      for (int p = 0; p < k; ++p) s += A[p * m + i] * B[p * n + j];
      C[i * n + j] = s;
    }
}

inline void matvec(const double* A, const double* x, double* y, int m, int n) {
  for (int i = 0; i < m; ++i) {
    double s = 0;
    for (int j = 0; j < n; ++j) s += A[i * n + j] * x[j];
    y[i] = s;
  }
}

inline void matvec_t(const double* A, const double* x, double* y, int m,
                     int n) {  // y = A(m,n)' x(m)
  for (int j = 0; j < n; ++j) y[j] = 0;
  for (int i = 0; i < m; ++i)
    for (int j = 0; j < n; ++j) y[j] += A[i * n + j] * x[i];
}

// Cholesky in place (lower), returns false if not PD
inline bool cholesky(double* A, int n) {
  for (int j = 0; j < n; ++j) {
    double d = A[j * n + j];
    for (int p = 0; p < j; ++p) d -= A[j * n + p] * A[j * n + p];
    if (d <= 0) return false;
    d = std::sqrt(d);
    A[j * n + j] = d;
    for (int i = j + 1; i < n; ++i) {
      double s = A[i * n + j];
      for (int p = 0; p < j; ++p) s -= A[i * n + p] * A[j * n + p];
      A[i * n + j] = s / d;
    }
  }
  return true;
}

// solve L L' X = B, B is (n, m) row-major, in place
inline void cho_solve(const double* L, double* B, int n, int m) {
  for (int c = 0; c < m; ++c) {
    for (int i = 0; i < n; ++i) {  // forward
      double s = B[i * m + c];
      for (int p = 0; p < i; ++p) s -= L[i * n + p] * B[p * m + c];
      B[i * m + c] = s / L[i * n + i];
    }
    for (int i = n - 1; i >= 0; --i) {  // backward
      double s = B[i * m + c];
      for (int p = i + 1; p < n; ++p) s -= L[p * n + i] * B[p * m + c];
      B[i * m + c] = s / L[i * n + i];
    }
  }
}

struct Work {
  int N, nx, nu, ni, nif;
  // iterates
  vector<double> X, U, lam, s, lamf, sf, nu_dyn;
  // residuals
  vector<double> req, rineq, rineqf, rx, rxN, ru;
  // factorization
  vector<double> P, p_vec, K, Lchol, Fxu, Pnext;
  // step
  vector<double> dX, dU, dnu, ds, dlam, dsf, dlamf, kff, pnext_seq;
};

}  // namespace

extern "C" {

// Returns 0 on success (relative KKT < tol*100), 1 on max-iter with usable
// iterate, 2 on numerical failure. info_out: [kkt_rel, iters, cost].
int rnm_qp_solve(int N, int nx, int nu, int ni, int nif,
                 const double* A,    // (N, nx, nx)
                 const double* B,    // (N, nx, nu)
                 const double* cvec, // (N, nx)
                 const double* Hx,   // (nx, nx) = 2Q
                 const double* Hu,   // (nu, nu) = 2R
                 const double* HxN,  // (nx, nx) = 2Qf
                 const double* Gx,   // (ni, nx)
                 const double* Gu,   // (ni, nu)
                 const double* Gf,   // (nif, nx)
                 const double* qx,   // (N+1, nx)
                 const double* qu,   // (N, nu)
                 const double* h,    // (N, ni)
                 const double* hf,   // (nif)
                 const double* xinit,
                 int max_iter, double tol,
                 double* X_out,      // (N+1, nx)
                 double* U_out,      // (N, nu)
                 double* lam_out,    // (N, ni)
                 double* lamf_out,   // (nif)
                 double* nu_out,     // (N, nx)
                 double* info_out)   // [3]
{
  const int n_comp = N * ni + nif;
  Work w;
  w.N = N; w.nx = nx; w.nu = nu; w.ni = ni; w.nif = nif;
  w.X.assign((N + 1) * nx, 0.0);
  w.U.assign(N * nu, 0.0);
  w.lam.assign(N * ni, 1.0);
  w.lamf.assign(nif, 1.0);
  w.nu_dyn.assign(N * nx, 0.0);
  std::memcpy(w.X.data(), xinit, nx * sizeof(double));

  // slack init: s = max(h - G z, 1)
  w.s.assign(N * ni, 1.0);
  w.sf.assign(nif, 1.0);
  {
    vector<double> t(ni);
    for (int k = 0; k < N; ++k) {
      matvec(Gx, &w.X[k * nx], t.data(), ni, nx);
      for (int r = 0; r < ni; ++r)
        w.s[k * ni + r] = std::max(h[k * ni + r] - t[r], 1.0);
    }
    vector<double> tf(nif);
    matvec(Gf, &w.X[N * nx], tf.data(), nif, nx);
    for (int r = 0; r < nif; ++r) w.sf[r] = std::max(hf[r] - tf[r], 1.0);
  }

  w.req.assign(N * nx, 0); w.rineq.assign(N * ni, 0); w.rineqf.assign(nif, 0);
  w.rx.assign((N + 1) * nx, 0); w.rxN.assign(nx, 0); w.ru.assign(N * nu, 0);
  w.P.assign(nx * nx, 0); w.p_vec.assign(nx, 0);
  w.K.assign(N * nu * nx, 0); w.Lchol.assign(N * nu * nu, 0);
  w.Fxu.assign(N * nx * nu, 0); w.Pnext.assign(N * nx * nx, 0);
  w.dX.assign((N + 1) * nx, 0); w.dU.assign(N * nu, 0); w.dnu.assign(N * nx, 0);
  w.ds.assign(N * ni, 0); w.dlam.assign(N * ni, 0);
  w.dsf.assign(nif, 0); w.dlamf.assign(nif, 0);
  w.kff.assign(N * nu, 0); w.pnext_seq.assign(N * nx, 0);

  vector<double> tmp_xx(nx * nx), tmp_xu(nx * nu), tmp_ux(nu * nx),
      tmp_uu(nu * nu), tvec(std::max({nx, nu, ni, nif}));
  vector<double> WGx(ni * nx), WGu(ni * nu);
  vector<double> rbx((N + 1) * nx), rbu(N * nu), rbxN(nx);
  vector<double> rca(N * ni), rcaf(nif), rcc(N * ni), rccf(nif);

  double scale_p = 1.0;
  for (int i = 0; i < N * nx; ++i) scale_p = std::max(scale_p, 1.0 + std::fabs(cvec[i]));
  for (int i = 0; i < N * ni; ++i) scale_p = std::max(scale_p, 1.0 + std::fabs(h[i]));
  for (int i = 0; i < nif; ++i) scale_p = std::max(scale_p, 1.0 + std::fabs(hf[i]));
  for (int i = 0; i < nx; ++i) scale_p = std::max(scale_p, 1.0 + std::fabs(xinit[i]));

  auto residuals = [&]() {
    // dynamics
    for (int k = 0; k < N; ++k) {
      matvec(&A[k * nx * nx], &w.X[k * nx], &w.req[k * nx], nx, nx);
      matvec(&B[k * nx * nu], &w.U[k * nu], tvec.data(), nx, nu);
      for (int i = 0; i < nx; ++i)
        w.req[k * nx + i] += tvec[i] + cvec[k * nx + i] - w.X[(k + 1) * nx + i];
    }
    // inequalities
    for (int k = 0; k < N; ++k) {
      matvec(Gx, &w.X[k * nx], &w.rineq[k * ni], ni, nx);
      matvec(Gu, &w.U[k * nu], tvec.data(), ni, nu);
      for (int r = 0; r < ni; ++r)
        w.rineq[k * ni + r] += tvec[r] + w.s[k * ni + r] - h[k * ni + r];
    }
    matvec(Gf, &w.X[N * nx], w.rineqf.data(), nif, nx);
    for (int r = 0; r < nif; ++r) w.rineqf[r] += w.sf[r] - hf[r];
    // stationarity (rx rows 1..N-1; row 0 unused)
    for (int k = 1; k < N; ++k) {
      double* r = &w.rx[k * nx];
      matvec(Hx, &w.X[k * nx], r, nx, nx);
      matvec_t(Gx, &w.lam[k * ni], tvec.data(), ni, nx);
      for (int i = 0; i < nx; ++i)
        r[i] += qx[k * nx + i] + tvec[i] + w.nu_dyn[(k - 1) * nx + i];
      matvec_t(&A[k * nx * nx], &w.nu_dyn[k * nx], tvec.data(), nx, nx);
      for (int i = 0; i < nx; ++i) r[i] -= tvec[i];
    }
    matvec(HxN, &w.X[N * nx], w.rxN.data(), nx, nx);
    matvec_t(Gf, w.lamf.data(), tvec.data(), nif, nx);
    for (int i = 0; i < nx; ++i)
      w.rxN[i] += qx[N * nx + i] + tvec[i] + w.nu_dyn[(N - 1) * nx + i];
    for (int k = 0; k < N; ++k) {
      double* r = &w.ru[k * nu];
      matvec(Hu, &w.U[k * nu], r, nu, nu);
      matvec_t(Gu, &w.lam[k * ni], tvec.data(), ni, nu);
      for (int i = 0; i < nu; ++i) r[i] += qu[k * nu + i] + tvec[i];
      matvec_t(&B[k * nx * nu], &w.nu_dyn[k * nx], tvec.data(), nx, nu);
      for (int i = 0; i < nu; ++i) r[i] -= tvec[i];
    }
  };

  auto kkt_rel = [&]() {
    double rp = 0, rd = 0, scale_d = 1.0;
    for (double v : w.req) rp = std::max(rp, std::fabs(v));
    for (double v : w.rineq) rp = std::max(rp, std::fabs(v));
    for (double v : w.rineqf) rp = std::max(rp, std::fabs(v));
    for (int k = 1; k < N; ++k)
      for (int i = 0; i < nx; ++i) rd = std::max(rd, std::fabs(w.rx[k * nx + i]));
    for (double v : w.rxN) rd = std::max(rd, std::fabs(v));
    for (double v : w.ru) rd = std::max(rd, std::fabs(v));
    for (int i = 0; i < (N + 1) * nx; ++i) scale_d = std::max(scale_d, 1.0 + std::fabs(qx[i]));
    for (int i = 0; i < N * nu; ++i) scale_d = std::max(scale_d, 1.0 + std::fabs(qu[i]));
    for (double v : w.lam) scale_d = std::max(scale_d, 1.0 + std::fabs(v));
    for (double v : w.lamf) scale_d = std::max(scale_d, 1.0 + std::fabs(v));
    double gap = 0;
    for (int i = 0; i < N * ni; ++i) gap += w.lam[i] * w.s[i];
    for (int i = 0; i < nif; ++i) gap += w.lamf[i] * w.sf[i];
    gap /= n_comp;
    return std::max(std::max(rp / scale_p, rd / scale_d), gap / scale_d);
  };

  auto factorize = [&]() -> bool {
    // terminal P
    vector<double> Pn(nx * nx);
    for (int i = 0; i < nx * nx; ++i) Pn[i] = HxN[i];
    for (int r = 0; r < nif; ++r) {
      double wf = w.lamf[r] / w.sf[r];
      for (int i = 0; i < nx; ++i)
        for (int j = 0; j < nx; ++j)
          Pn[i * nx + j] += Gf[r * nx + i] * wf * Gf[r * nx + j];
    }
    for (int k = N - 1; k >= 0; --k) {
      std::memcpy(&w.Pnext[k * nx * nx], Pn.data(), nx * nx * sizeof(double));
      // weighted congruences
      for (int r = 0; r < ni; ++r) {
        double wk = w.lam[k * ni + r] / w.s[k * ni + r];
        for (int j = 0; j < nx; ++j) WGx[r * nx + j] = wk * Gx[r * nx + j];
        for (int j = 0; j < nu; ++j) WGu[r * nu + j] = wk * Gu[r * nu + j];
      }
      vector<double> Cxx(nx * nx), Cuu(nu * nu), Cxu(nx * nu);
      matmul_tn(Gx, WGx.data(), Cxx.data(), nx, ni, nx);
      matmul_tn(Gu, WGu.data(), Cuu.data(), nu, ni, nu);
      matmul_tn(Gx, WGu.data(), Cxu.data(), nx, ni, nu);
      for (int i = 0; i < nx * nx; ++i) Cxx[i] += Hx[i];
      for (int i = 0; i < nu * nu; ++i) Cuu[i] += Hu[i];
      // F blocks
      matmul(Pn.data(), &A[k * nx * nx], tmp_xx.data(), nx, nx, nx);  // PA
      matmul(Pn.data(), &B[k * nx * nu], tmp_xu.data(), nx, nx, nu);  // PB
      vector<double> Fxx(nx * nx), Fuu(nu * nu), Fxu(nx * nu);
      matmul_tn(&A[k * nx * nx], tmp_xx.data(), Fxx.data(), nx, nx, nx);
      matmul_tn(&B[k * nx * nu], tmp_xu.data(), Fuu.data(), nu, nx, nu);
      matmul_tn(&A[k * nx * nx], tmp_xu.data(), Fxu.data(), nx, nx, nu);
      for (int i = 0; i < nx * nx; ++i) Fxx[i] += Cxx[i];
      for (int i = 0; i < nu * nu; ++i) Fuu[i] += Cuu[i];
      for (int i = 0; i < nx * nu; ++i) Fxu[i] += Cxu[i];
      // symmetrize + tiny regularization, cholesky
      double tr = 0;
      for (int i = 0; i < nu; ++i) tr += Fuu[i * nu + i];
      for (int i = 0; i < nu; ++i)
        for (int j = 0; j < i; ++j) {
          double v = 0.5 * (Fuu[i * nu + j] + Fuu[j * nu + i]);
          Fuu[i * nu + j] = Fuu[j * nu + i] = v;
        }
      for (int i = 0; i < nu; ++i) Fuu[i * nu + i] += tr * 1e-14;
      if (!cholesky(Fuu.data(), nu)) return false;
      std::memcpy(&w.Lchol[k * nu * nu], Fuu.data(), nu * nu * sizeof(double));
      std::memcpy(&w.Fxu[k * nx * nu], Fxu.data(), nx * nu * sizeof(double));
      // K = -Fuu^{-1} Fxu'
      for (int i = 0; i < nu; ++i)
        for (int j = 0; j < nx; ++j) tmp_ux[i * nx + j] = Fxu[j * nu + i];
      cho_solve(Fuu.data(), tmp_ux.data(), nu, nx);
      for (int i = 0; i < nu * nx; ++i) w.K[k * nu * nx + i] = -tmp_ux[i];
      // P = sym(Fxx + Fxu K)
      matmul(Fxu.data(), &w.K[k * nu * nx], tmp_xx.data(), nx, nu, nx);
      for (int i = 0; i < nx; ++i)
        for (int j = 0; j < nx; ++j) {
          double v = Fxx[i * nx + j] + tmp_xx[i * nx + j];
          Pn[i * nx + j] = v;
        }
      for (int i = 0; i < nx; ++i)
        for (int j = 0; j < i; ++j) {
          double v = 0.5 * (Pn[i * nx + j] + Pn[j * nx + i]);
          Pn[i * nx + j] = Pn[j * nx + i] = v;
        }
    }
    return true;
  };

  auto newton = [&](const double* rbx_, const double* rbxN_, const double* rbu_) {
    // backward affine recursion
    vector<double> p(nx), wv(nx), fu(nu);
    std::memcpy(p.data(), rbxN_, nx * sizeof(double));
    for (int k = N - 1; k >= 0; --k) {
      std::memcpy(&w.pnext_seq[k * nx], p.data(), nx * sizeof(double));
      matvec(&w.Pnext[k * nx * nx], &w.req[k * nx], wv.data(), nx, nx);
      // note: Newton dynamics rhs is -req? No: dx+ = A dx + B du + req_res
      // where req_res is the (negated) residual direction; here we pass req
      // as the residual so the affine term is req (matches qp_ipm.py).
      for (int i = 0; i < nx; ++i) wv[i] += p[i];
      matvec_t(&B[k * nx * nu], wv.data(), fu.data(), nx, nu);
      for (int i = 0; i < nu; ++i) fu[i] += rbu_[k * nu + i];
      vector<double> kf(fu);
      cho_solve(&w.Lchol[k * nu * nu], kf.data(), nu, 1);
      for (int i = 0; i < nu; ++i) w.kff[k * nu + i] = -kf[i];
      // p = rbx + A' w + Fxu kff
      matvec_t(&A[k * nx * nx], wv.data(), p.data(), nx, nx);
      matvec(&w.Fxu[k * nx * nu], &w.kff[k * nu], wv.data(), nx, nu);
      for (int i = 0; i < nx; ++i) p[i] += rbx_[k * nx + i] + wv[i];
    }
    // forward rollout
    for (int i = 0; i < nx; ++i) w.dX[i] = 0.0;
    for (int k = 0; k < N; ++k) {
      matvec(&w.K[k * nu * nx], &w.dX[k * nx], &w.dU[k * nu], nu, nx);
      for (int i = 0; i < nu; ++i) w.dU[k * nu + i] += w.kff[k * nu + i];
      matvec(&A[k * nx * nx], &w.dX[k * nx], &w.dX[(k + 1) * nx], nx, nx);
      matvec(&B[k * nx * nu], &w.dU[k * nu], wv.data(), nx, nu);
      for (int i = 0; i < nx; ++i)
        w.dX[(k + 1) * nx + i] += wv[i] + w.req[k * nx + i];
      matvec(&w.Pnext[k * nx * nx], &w.dX[(k + 1) * nx], wv.data(), nx, nx);
      for (int i = 0; i < nx; ++i)
        w.dnu[k * nx + i] = -(wv[i] + w.pnext_seq[k * nx + i]);
    }
  };

  auto reduced_rhs = [&](const double* rc, const double* rcf) {
    vector<double> t(ni), tf(nif), acc(std::max(nx, nu));
    for (int i = 0; i < nx; ++i) rbx[i] = 0.0;  // row 0 unused
    for (int k = 0; k < N; ++k) {
      for (int r = 0; r < ni; ++r)
        t[r] = (w.lam[k * ni + r] * w.rineq[k * ni + r] - rc[k * ni + r]) /
               w.s[k * ni + r];
      if (k >= 1) {
        matvec_t(Gx, t.data(), acc.data(), ni, nx);
        for (int i = 0; i < nx; ++i) rbx[k * nx + i] = w.rx[k * nx + i] + acc[i];
      }
      matvec_t(Gu, t.data(), acc.data(), ni, nu);
      for (int i = 0; i < nu; ++i) rbu[k * nu + i] = w.ru[k * nu + i] + acc[i];
    }
    for (int r = 0; r < nif; ++r)
      tf[r] = (w.lamf[r] * w.rineqf[r] - rcf[r]) / w.sf[r];
    matvec_t(Gf, tf.data(), rbxN.data(), nif, nx);
    for (int i = 0; i < nx; ++i) rbxN[i] += w.rxN[i];
  };

  auto recover = [&](const double* rc, const double* rcf) {
    vector<double> t(ni);
    for (int k = 0; k < N; ++k) {
      matvec(Gx, &w.dX[k * nx], t.data(), ni, nx);
      vector<double> t2(ni);
      matvec(Gu, &w.dU[k * nu], t2.data(), ni, nu);
      for (int r = 0; r < ni; ++r) {
        int idx = k * ni + r;
        w.ds[idx] = -w.rineq[idx] - t[r] - t2[r];
        w.dlam[idx] = -(rc[idx] + w.lam[idx] * w.ds[idx]) / w.s[idx];
      }
    }
    vector<double> tfv(nif);
    matvec(Gf, &w.dX[N * nx], tfv.data(), nif, nx);
    for (int r = 0; r < nif; ++r) {
      w.dsf[r] = -w.rineqf[r] - tfv[r];
      w.dlamf[r] = -(rcf[r] + w.lamf[r] * w.dsf[r]) / w.sf[r];
    }
  };

  auto boundary = [&](const vector<double>& v, const vector<double>& dv,
                      double tau) {
    double a = 1.0;
    for (size_t i = 0; i < v.size(); ++i)
      if (dv[i] < 0) a = std::min(a, -tau * v[i] / dv[i]);
    return a;
  };

  int it = 0;
  double res = std::numeric_limits<double>::infinity();
  for (; it < max_iter; ++it) {
    residuals();
    res = kkt_rel();
    if (res < tol) break;
    double mu = 0;
    for (int i = 0; i < N * ni; ++i) mu += w.lam[i] * w.s[i];
    for (int i = 0; i < nif; ++i) mu += w.lamf[i] * w.sf[i];
    mu /= n_comp;
    if (mu < 1e-14 * scale_p && res < tol * 100) break;
    if (!factorize()) return 2;

    // affine step
    for (int i = 0; i < N * ni; ++i) rca[i] = w.lam[i] * w.s[i];
    for (int i = 0; i < nif; ++i) rcaf[i] = w.lamf[i] * w.sf[i];
    reduced_rhs(rca.data(), rcaf.data());
    newton(rbx.data(), rbxN.data(), rbu.data());
    recover(rca.data(), rcaf.data());
    double apa = std::min(boundary(w.s, w.ds, 1.0), boundary(w.sf, w.dsf, 1.0));
    double ada = std::min(boundary(w.lam, w.dlam, 1.0), boundary(w.lamf, w.dlamf, 1.0));
    double mu_aff = 0;
    for (int i = 0; i < N * ni; ++i)
      mu_aff += (w.s[i] + apa * w.ds[i]) * (w.lam[i] + ada * w.dlam[i]);
    for (int i = 0; i < nif; ++i)
      mu_aff += (w.sf[i] + apa * w.dsf[i]) * (w.lamf[i] + ada * w.dlamf[i]);
    mu_aff /= n_comp;
    double sigma = std::pow(std::max(mu_aff, 0.0) / std::max(mu, 1e-300), 3.0);
    sigma = std::min(1.0, std::max(0.0, sigma));

    // corrector
    for (int i = 0; i < N * ni; ++i)
      rcc[i] = w.lam[i] * w.s[i] + w.ds[i] * w.dlam[i] - sigma * mu;
    for (int i = 0; i < nif; ++i)
      rccf[i] = w.lamf[i] * w.sf[i] + w.dsf[i] * w.dlamf[i] - sigma * mu;
    reduced_rhs(rcc.data(), rccf.data());
    newton(rbx.data(), rbxN.data(), rbu.data());
    recover(rcc.data(), rccf.data());
    double tau = 0.995;
    double ap = std::min(boundary(w.s, w.ds, tau), boundary(w.sf, w.dsf, tau));
    double ad = std::min(boundary(w.lam, w.dlam, tau), boundary(w.lamf, w.dlamf, tau));

    for (int i = 0; i < (N + 1) * nx; ++i) w.X[i] += ap * w.dX[i];
    for (int i = 0; i < N * nu; ++i) w.U[i] += ap * w.dU[i];
    for (int i = 0; i < N * ni; ++i) {
      w.s[i] += ap * w.ds[i];
      w.lam[i] += ad * w.dlam[i];
    }
    for (int i = 0; i < nif; ++i) {
      w.sf[i] += ap * w.dsf[i];
      w.lamf[i] += ad * w.dlamf[i];
    }
    for (int i = 0; i < N * nx; ++i) w.nu_dyn[i] += ad * w.dnu[i];
  }

  residuals();
  res = kkt_rel();

  // outputs
  std::memcpy(X_out, w.X.data(), (N + 1) * nx * sizeof(double));
  std::memcpy(U_out, w.U.data(), N * nu * sizeof(double));
  std::memcpy(lam_out, w.lam.data(), N * ni * sizeof(double));
  std::memcpy(lamf_out, w.lamf.data(), nif * sizeof(double));
  std::memcpy(nu_out, w.nu_dyn.data(), N * nx * sizeof(double));

  // cost
  double cost = 0;
  vector<double> tmp(nx);
  for (int k = 0; k < N; ++k) {
    matvec(Hx, &w.X[k * nx], tmp.data(), nx, nx);
    for (int i = 0; i < nx; ++i)
      cost += 0.5 * tmp[i] * w.X[k * nx + i] + qx[k * nx + i] * w.X[k * nx + i];
    vector<double> tu(nu);
    matvec(Hu, &w.U[k * nu], tu.data(), nu, nu);
    for (int i = 0; i < nu; ++i)
      cost += 0.5 * tu[i] * w.U[k * nu + i] + qu[k * nu + i] * w.U[k * nu + i];
  }
  matvec(HxN, &w.X[N * nx], tmp.data(), nx, nx);
  for (int i = 0; i < nx; ++i)
    cost += 0.5 * tmp[i] * w.X[N * nx + i] + qx[N * nx + i] * w.X[N * nx + i];

  info_out[0] = res;
  info_out[1] = (double)it;
  info_out[2] = cost;
  if (res < tol * 100) return 0;
  return 1;
}

}  // extern "C"

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
// Cxx = Hx + Gx' diag(W) Gx, Cuu, Cxu and PN = HxN + Gf' diag(W_f) Gf is
// built inside the kernel from the weights W = lam / s that the wrapper
// hands in (the Pallas wrapper builds it outside its kernel).
//
// Design. One thread block per lane, as the Newton kernels: the stage loops
// are the same device functions (newton.cuh). At B = 512 the batch is one
// wave on the H100 (four blocks an SM), so the time is one lane's chain, and
// the design keeps device memory out of it:
//   * the curvature of every stage is built first, off the P-chain, by the
//     whole block into a device workspace (the statics, the same for every
//     lane, come from L1); the factorization's ring then fetches it with the
//     stage's A_k, B_k, req_k by `cp.async`, two stages ahead, as the Newton
//     kernel fetches its curvature input;
//   * the lane's factors (P_{k+1}, K, Fxu', the triangles), the rhs (t, the
//     reduced rhs rbx, rbxN, rbu) and the directions (dX, dU, dnu) stay in
//     shared memory (dynamic, about 40 KB in float32 at the rocket's widths),
//     so neither sweep nor the recovery reads back what the block wrote. A
//     lane whose sequences do not fit (long horizons in float64) keeps them
//     in the device-memory workspace: no N or ni limit;
//   * the per-lane sums (mu, mu_aff, the gap), minima (the ratios of the
//     fraction-to-boundary rule) and max-abs terms of the KKT scalar are
//     warp-shuffle reductions with one shared-memory step; the paired and
//     the five KKT terms are reduced together; min and max propagate NaN, as
//     jnp.min / torch.amin do.
//
// Bound: latency, like the Newton kernels it contains: two sequential
// stage loops per lane plus a few short passes separated by barriers, with
// four lanes sharing an SM. The bytes it must move (the lane's data,
// weights, iterate and residuals, about 53 KB per lane in float32 at the
// rocket's widths) would take 8.3 us at 3.35 TB/s for B = 512, its
// operations (the curvature included) 9.7 us at the float32 peak
// (chip_smoke.kernel_bound).

#include "newton.cuh"
#include "occupancy.cuh"

namespace {

using namespace rnm;

template <typename T>
struct IpmArgs {
  // problem data (batch-leading) and shared statics
  const T *A, *B, *c, *qx, *qu, *h, *hf;
  const T *Gx, *Gu, *Gf, *Hx, *Hu, *HxN;
  // weights of this iteration (W = lam / s)
  const T *W, *Wf;
  // iterate and carried residuals (rx with a zero row 0)
  const T *X, *U, *lam, *s, *lamf, *sf, *nu;
  const T *req, *rineq, *rineqf, *rx, *rxN, *ru;
  const T* scale_p;
  const unsigned char* done;
  // outputs
  T *Xo, *Uo, *lamo, *so, *lamfo, *sfo, *nuo;
  T *reqo, *rineqo, *rineqfo, *rxo, *rxNo, *ruo, *res;
  unsigned char* bad;
  // workspace (the lane's sequences where they do not fit on chip, and the
  // slack / dual directions)
  T *rbx, *rbxN, *rbu, *dX, *dU, *dnu, *K, *FxuT, *Fuu_tri, *Fiv_tri, *Pseq, *kff, *pn;
  T *ds, *dlam, *dsf, *dlamf, *t, *tf, *rcomp, *rcompf;
  // the curvature of every stage: Cxx (N, nx, nx), Cxu (N, nx, nu), Cuu (N, nu, nu)
  T* C;
};

constexpr int IPM_NPTRS = 67;

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ double nan_min(double a, double b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }
__device__ __forceinline__ double nan_max(double a, double b) { return (a > b || a != a) ? a : b; }

enum { SUM, MIN, MAX };

// the most values one reduction carries (the KKT scalar's five terms)
constexpr int RED_VALUES = 5;

template <typename T>
__device__ __forceinline__ T combine(int op, T a, T b) {
  return op == SUM ? a + b : (op == MIN ? nan_min(a, b) : nan_max(a, b));
}

// Reduces NV values per thread, each by its operation, over the block, in
// place: every thread gets the results, bit-identical (a butterfly of
// shuffles within each warp, then the warps' partials in a fixed order).
// One barrier; `red` holds two buffers of WARPS x RED_VALUES words, used in turn,
// so a reduction never overwrites partials that a slower thread still reads
// from the one before.
template <int NV, typename T>
__device__ __forceinline__ void block_reduce(T* v, const int (&ops)[NV], T* red, int& turn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] = combine(ops[i], v[i], __shfl_xor_sync(0xffffffffu, v[i], off));
  static_assert(NV <= RED_VALUES, "too many values for one reduction");
  T* buf = red + turn * WARPS * RED_VALUES;
  turn ^= 1;
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < NV; ++i) buf[warp * NV + i] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    T r = buf[i];
    for (int w = 1; w < WARPS; ++w) r = combine(ops[i], r, buf[w * NV + i]);
    v[i] = r;
  }
}

template <typename T>
__device__ __forceinline__ T inf_value();
template <>
__device__ __forceinline__ float inf_value<float>() { return __int_as_float(0x7f800000); }
template <>
__device__ __forceinline__ double inf_value<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

// Shared memory of the whole-iteration kernel. Ring slot: A, B, req, Cxx,
// Cxu, Cuu of one stage; the sweeps use the same memory as four slots of A,
// B, req.
template <typename T>
struct IpmSmem {
  T* ring[2];
  int oA, oB, oreq, oCxx, oCxu, oCuu, fwd_slot;
  FactorWork<T> wk;
  T* red;
  // the lane's sequences and vectors (null off chip)
  T *P, *p, *K, *FxuT, *Fuu_t, *Fiv_t, *kff, *dX, *dU, *dnu, *t, *tf, *rbx, *rbxN, *rbu;
};

template <typename T>
__host__ __device__ size_t ipm_layout(IpmSmem<T>& L, T* base, int N, int nx, int nu, int ni,
                                      int ni_f, bool on_chip) {
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * nu, nut = nu * (nu + 1) / 2;
  L.oA = 0;
  L.oB = nxx;
  L.oreq = nxx + nxu;
  L.fwd_slot = nxx + nxu + nx;
  L.oCxx = L.fwd_slot;
  L.oCxu = L.oCxx + nxx;
  L.oCuu = L.oCxu + nxu;
  const int slot = L.oCuu + nuu;
  Carve c;
  const int ring = 2 * slot > 4 * L.fwd_slot ? 2 * slot : 4 * L.fwd_slot;
  L.ring[0] = c.take(base, (size_t)ring);
  L.ring[1] = L.ring[0] ? L.ring[0] + slot : nullptr;
  L.wk.PA = c.take(base, nxx);
  L.wk.Fxx = c.take(base, nxx);
  L.wk.PB = c.take(base, nxu);
  L.wk.Fuu = c.take(base, nuu);
  L.wk.w = c.take(base, nx);
  L.wk.pnew = c.take(base, nx);
  L.wk.fu = c.take(base, nu);
  L.red = c.take(base, 2 * WARPS * RED_VALUES);
  T* on = on_chip ? base : nullptr;
  const size_t sN = on_chip ? N : 0;
  L.P = c.take(on, sN * nxx);
  L.p = c.take(on, sN * nx);
  L.K = c.take(on, sN * nxu);
  L.FxuT = c.take(on, sN * nxu);
  L.Fuu_t = c.take(on, sN * nut);
  L.Fiv_t = c.take(on, sN * nut);
  L.kff = c.take(on, sN * nu);
  L.dX = c.take(on, on_chip ? (size_t)(N + 1) * nx : 0);
  L.dU = c.take(on, sN * nu);
  L.dnu = c.take(on, sN * nx);
  L.t = c.take(on, sN * ni);
  L.tf = c.take(on, on_chip ? (size_t)ni_f : 0);
  L.rbx = c.take(on, sN * nx);
  L.rbxN = c.take(on, on_chip ? (size_t)nx : 0);
  L.rbu = c.take(on, sN * nu);
  return c.words;
}

// a lane sequence: on chip (nothing to device memory), else in the workspace
template <typename T>
__device__ __forceinline__ Out<T> lane_seq(T* chip, T* work, int n) {
  return chip ? Out<T>{nullptr, chip, n, n} : Out<T>{work, work, n, n};
}

template <typename T, int NXC, int NUC>
__global__ void __launch_bounds__(THREADS, (Residency<T, NXC>::blocks))
    ipm_iter_kernel(IpmArgs<T> a, int N, int nx_, int nu_, int ni, int ni_f, T tau, T n_comp,
                    int on_chip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx = NXC > 0 ? NXC : nx_;
  const int nu = NUC > 0 ? NUC : nu_;
  IpmSmem<T> L;
  ipm_layout<T>(L, reinterpret_cast<T*>(smem_raw), N, nx, nu, ni, ni_f, on_chip != 0);
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const size_t sN = (size_t)N;
  const int nxx = nx * nx, nxu = nx * nu, nut = nu * (nu + 1) / 2;
  const int Nni = N * ni;
  const T inf = inf_value<T>();
  int turn = 0;

  // lane views
  const T* A = a.A + b * sN * nxx;
  const T* Bm = a.B + b * sN * nxu;
  const T* c = a.c + b * sN * nx;
  const T* qx = a.qx + b * (sN + 1) * nx;
  const T* qu = a.qu + b * sN * nu;
  const T* h = a.h + b * Nni;
  const T* hf = a.hf + b * ni_f;
  const T* X = a.X + b * (sN + 1) * nx;
  const T* U = a.U + b * sN * nu;
  const T* lam = a.lam + b * Nni;
  const T* s = a.s + b * Nni;
  const T* lamf = a.lamf + b * ni_f;
  const T* sf = a.sf + b * ni_f;
  const T* nu_d = a.nu + b * sN * nx;
  const T* req = a.req + b * sN * nx;
  const T* rineq = a.rineq + b * Nni;
  const T* rineqf = a.rineqf + b * ni_f;
  const T* rx = a.rx + b * sN * nx;
  const T* rxN = a.rxN + b * nx;
  const T* ru = a.ru + b * sN * nu;
  const T* Gx = a.Gx;
  const T* Gu = a.Gu;
  const T* Gf = a.Gf;
  const T* Wf = a.Wf + b * ni_f;
  T* Xo = a.Xo + b * (sN + 1) * nx;
  T* Uo = a.Uo + b * sN * nu;
  T* lamo = a.lamo + b * Nni;
  T* so = a.so + b * Nni;
  T* lamfo = a.lamfo + b * ni_f;
  T* sfo = a.sfo + b * ni_f;
  T* nuo = a.nuo + b * sN * nx;
  T* reqo = a.reqo + b * sN * nx;
  T* rineqo = a.rineqo + b * Nni;
  T* rineqfo = a.rineqfo + b * ni_f;
  T* rxo = a.rxo + b * sN * nx;
  T* rxNo = a.rxNo + b * nx;
  T* ruo = a.ruo + b * sN * nu;
  T* ds = a.ds + b * Nni;
  T* dlam = a.dlam + b * Nni;
  T* dsf = a.dsf + b * ni_f;
  T* dlamf = a.dlamf + b * ni_f;
  T* rcomp = a.rcomp + b * Nni;
  T* rcompf = a.rcompf + b * ni_f;
  // the lane's sequences and rhs: on chip, else in the workspace
  T* t = L.t ? L.t : a.t + b * Nni;
  T* tf = L.tf ? L.tf : a.tf + b * ni_f;
  T* rbx = L.rbx ? L.rbx : a.rbx + b * sN * nx;
  T* rbxN = L.rbxN ? L.rbxN : a.rbxN + b * nx;
  T* rbu = L.rbu ? L.rbu : a.rbu + b * sN * nu;
  const FactorOut<T> fo{lane_seq(L.P, a.Pseq + b * sN * nxx, nxx),
                        lane_seq(L.p, a.pn + b * sN * nx, nx),
                        lane_seq(L.K, a.K + b * sN * nxu, nxu),
                        lane_seq(L.FxuT, a.FxuT + b * sN * nxu, nxu),
                        lane_seq(L.Fuu_t, a.Fuu_tri + b * sN * nut, nut),
                        lane_seq(L.Fiv_t, a.Fiv_tri + b * sN * nut, nut),
                        lane_seq(L.kff, a.kff + b * sN * nu, nu)};
  const Out<T> dX = lane_seq(L.dX, a.dX + b * (sN + 1) * nx, nx);
  const Out<T> dU = lane_seq(L.dU, a.dU + b * sN * nu, nu);
  const Out<T> dnu = lane_seq(L.dnu, a.dnu + b * sN * nx, nx);
  const T* dXc = dX.c;
  const T* dUc = dU.c;
  const Seq<T> As{A, nxx, L.oA}, Bs{Bm, nxu, L.oB}, rs{req, nx, L.oreq};

  // ---- mu, and the predictor's complementarity rhs ----
  T acc[1] = {T(0)};
  for (int e = tid; e < Nni; e += THREADS) {
    const T v = lam[e] * s[e];
    rcomp[e] = v;
    acc[0] += v;
  }
  for (int e = tid; e < ni_f; e += THREADS) {
    const T v = lamf[e] * sf[e];
    rcompf[e] = v;
    acc[0] += v;
  }
  block_reduce<1>(acc, {SUM}, L.red, turn);
  const T mu = acc[0] / n_comp;

  // reduced rhs: rbx_k = rx_k + Gx_k' t_k (row 0 = 0), rbxN = rxN + Gf' t_f,
  // rbu_k = ru_k + Gu_k' t_k, with t = (lam rineq - rcomp) / s (each thread
  // reads back only the rcomp entries it wrote)
  auto assemble_rhs = [&]() {
    for (int e = tid; e < Nni; e += THREADS) t[e] = (lam[e] * rineq[e] - rcomp[e]) / s[e];
    for (int e = tid; e < ni_f; e += THREADS) tf[e] = (lamf[e] * rineqf[e] - rcompf[e]) / sf[e];
    __syncthreads();
    for (int e = tid; e < N * nx + nx + N * nu; e += THREADS) {
      if (e < N * nx) {
        const int k = e / nx, i = e - k * nx;
        T v = T(0);
        if (k > 0) {
          v = rx[e];
          for (int r = 0; r < ni; ++r) v += Gx[((size_t)k * ni + r) * nx + i] * t[k * ni + r];
        }
        rbx[e] = v;
      } else if (e < N * nx + nx) {
        const int i = e - N * nx;
        T v = rxN[i];
        for (int r = 0; r < ni_f; ++r) v += Gf[r * nx + i] * tf[r];
        rbxN[i] = v;
      } else {
        const int e2 = e - N * nx - nx, k = e2 / nu, u = e2 - k * nu;
        T v = ru[e2];
        for (int r = 0; r < ni; ++r) v += Gu[((size_t)k * ni + r) * nu + u] * t[k * ni + r];
        rbu[e2] = v;
      }
    }
    __syncthreads();
  };

  // ds = -rineq - (Gx dX + Gu dU), dlam = -(rcomp + lam ds) / s (and the
  // terminal rows), fused with the fraction-to-boundary minima of s and lam
  // (each thread reads back only what it wrote): returns the step lengths
  auto recover_step = [&](T tau_, T& ap_, T& ad_) {
    T m[2] = {inf, inf};
    for (int e = tid; e < Nni + ni_f; e += THREADS) {
      if (e < Nni) {
        const int k = e / ni;
        T g = T(0);
        for (int i = 0; i < nx; ++i) g += Gx[(size_t)e * nx + i] * dXc[k * nx + i];
        for (int u = 0; u < nu; ++u) g += Gu[(size_t)e * nu + u] * dUc[k * nu + u];
        const T d = -rineq[e] - g;
        const T dl = -(rcomp[e] + lam[e] * d) / s[e];
        ds[e] = d;
        dlam[e] = dl;
        if (d < T(0)) m[0] = nan_min(m[0], -s[e] / d);
        if (dl < T(0)) m[1] = nan_min(m[1], -lam[e] / dl);
      } else {
        const int r = e - Nni;
        T g = T(0);
        for (int i = 0; i < nx; ++i) g += Gf[r * nx + i] * dXc[N * nx + i];
        const T d = -rineqf[r] - g;
        const T dl = -(rcompf[r] + lamf[r] * d) / sf[r];
        dsf[r] = d;
        dlamf[r] = dl;
        if (d < T(0)) m[0] = nan_min(m[0], -sf[r] / d);
        if (dl < T(0)) m[1] = nan_min(m[1], -lamf[r] / dl);
      }
    }
    block_reduce<2>(m, {MIN, MIN}, L.red, turn);
    ap_ = nan_min(T(1), tau_ * m[0]);
    ad_ = nan_min(T(1), tau_ * m[1]);
  };

  // ---- predictor (affine) step ----
  assemble_rhs();
  // PN = HxN + Gf' diag(W_f) Gf is stage N-1's P; rbxN its p
  for (int e = tid; e < nxx + nx; e += THREADS) {
    if (e < nxx) {
      const int i = e / nx, j = e - i * nx;
      T v = T(0);
      for (int r = 0; r < ni_f; ++r) v += Gf[r * nx + i] * (Wf[r] * Gf[r * nx + j]);
      fo.P.put(N - 1, e, a.HxN[e] + v);
    } else {
      fo.p.put(N - 1, e - nxx, rbxN[e - nxx]);
    }
  }
  // the curvature of every stage, off the P-chain, into the workspace that
  // the factorization's ring fetches from: Cxx = Hx + Gx' diag(W) Gx in row
  // strips of four entries, Cxu = Gx' diag(W) Gu and Cuu = Hu + Gu' diag(W)
  // Gu a row each (one load of Gx_k[r][i] and W_k[r] serves the strip); the
  // statics are shared by every lane, so an SM's blocks find them in L1
  T* Cxx = a.C + b * sN * (nxx + nxu + nu * nu);
  T* Cxu = Cxx + sN * nxx;
  T* Cuu = Cxu + sN * nxu;
  {
    constexpr int U = NUC > 0 ? NUC : MAXNU;
    const T* W = a.W + b * Nni;
    const int strips = (nx + 3) / 4, per = nx * strips + nx + nu;
    for (int e = tid; e < N * per; e += THREADS) {
      const int k = e / per, q = e - k * per;
      const T* G = Gx + (size_t)k * ni * nx;
      const T* Gv = Gu + (size_t)k * ni * nu;
      const T* w = W + k * ni;
      T acc[4] = {T(0), T(0), T(0), T(0)};
      if (q < nx * strips) {
        const int i = q / strips, j0 = 4 * (q - i * strips);
        for (int r = 0; r < ni; ++r) {
          const T gi = G[r * nx + i], wr = w[r];
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4)
            if (j0 + c4 < nx) acc[c4] += gi * (wr * G[r * nx + j0 + c4]);
        }
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
          if (j0 + c4 < nx) {
            const int ij = i * nx + j0 + c4;
            Cxx[(size_t)k * nxx + ij] = a.Hx[(size_t)k * nxx + ij] + acc[c4];
          }
      } else if (q < nx * strips + nx) {
        const int i = q - nx * strips;
        for (int r = 0; r < ni; ++r) {
          const T gi = G[r * nx + i], wr = w[r];
#pragma unroll
          for (int v = 0; v < U; ++v)
            if (v < nu) acc[v] += gi * (wr * Gv[r * nu + v]);
        }
#pragma unroll
        for (int v = 0; v < U; ++v)
          if (v < nu) Cxu[(size_t)k * nxu + i * nu + v] = acc[v];
      } else {
        const int u = q - nx * strips - nx;
        for (int r = 0; r < ni; ++r) {
          const T gu = Gv[r * nu + u], wr = w[r];
#pragma unroll
          for (int v = 0; v < U; ++v)
            if (v < nu) acc[v] += gu * (wr * Gv[r * nu + v]);
        }
#pragma unroll
        for (int v = 0; v < U; ++v)
          if (v < nu)
            Cuu[(size_t)k * nu * nu + u * nu + v] = a.Hu[((size_t)k * nu + u) * nu + v] + acc[v];
      }
    }
  }
  __syncthreads();
  const FactorIn<T> fin{As, Bs, rs, {rbx, nx, -1}, {rbu, nu, -1},
                        {Cxx, nxx, L.oCxx}, {Cxu, nxu, L.oCxu}, {Cuu, nu * nu, L.oCuu}};
  factor_lane<T, NXC, NUC>(fin, fo, L.wk, L.ring, N, nx, nu);
  const ForwardIn<T> fwd{As, Bs, rs, {fo.K.c, nxu, -1}, fo.kff.c, fo.P.c, fo.p.c};
  const SweepRing<T> sweep_ring{L.ring[0], L.fwd_slot};
  forward_sweep<T, NXC, NUC>(fwd, dX, dU, dnu, sweep_ring, N, nx, nu);
  T ap_a, ad_a;
  recover_step(T(1), ap_a, ad_a);
  acc[0] = T(0);
  for (int e = tid; e < Nni; e += THREADS)
    acc[0] += (s[e] + ap_a * ds[e]) * (lam[e] + ad_a * dlam[e]);
  for (int e = tid; e < ni_f; e += THREADS)
    acc[0] += (sf[e] + ap_a * dsf[e]) * (lamf[e] + ad_a * dlamf[e]);
  block_reduce<1>(acc, {SUM}, L.red, turn);
  const T mu_aff = acc[0] / n_comp;
  T q = mu_aff / nan_max(mu, T(1e-30));
  q = q * q * q;
  const T sigma = (q != q) ? q : (q < T(0) ? T(0) : (q > T(1) ? T(1) : q));
  const T smu = sigma * mu;

  // ---- corrector step ----
  for (int e = tid; e < Nni; e += THREADS) rcomp[e] = lam[e] * s[e] + ds[e] * dlam[e] - smu;
  for (int e = tid; e < ni_f; e += THREADS)
    rcompf[e] = lamf[e] * sf[e] + dsf[e] * dlamf[e] - smu;
  assemble_rhs();
  const FeedforwardIn<T> ff{As, Bs, rs, {rbx, nx, -1}, {rbu, nu, -1},
                            {fo.P.c, nxx, -1}, {fo.FxuT.c, nxu, -1},
                            {fo.Fuu_t.c, nut, -1}, {fo.Fiv_t.c, nut, -1}, rbxN};
  feedforward_sweep<T, NXC, NUC>(ff, fo.kff, fo.p, sweep_ring, N, nx, nu);
  forward_sweep<T, NXC, NUC>(fwd, dX, dU, dnu, sweep_ring, N, nx, nu);
  T ap, ad;
  recover_step(tau, ap, ad);

  // ---- update; a lane marked done keeps its iterate ----
  const bool frozen = a.done[b] != 0;
  const T* dnuc = dnu.c;
  for (int e = tid; e < (N + 1) * nx; e += THREADS) Xo[e] = frozen ? X[e] : X[e] + ap * dXc[e];
  for (int e = tid; e < N * nu; e += THREADS) Uo[e] = frozen ? U[e] : U[e] + ap * dUc[e];
  for (int e = tid; e < Nni; e += THREADS) {
    so[e] = frozen ? s[e] : s[e] + ap * ds[e];
    lamo[e] = frozen ? lam[e] : lam[e] + ad * dlam[e];
  }
  for (int e = tid; e < ni_f; e += THREADS) {
    sfo[e] = frozen ? sf[e] : sf[e] + ap * dsf[e];
    lamfo[e] = frozen ? lamf[e] : lamf[e] + ad * dlamf[e];
  }
  for (int e = tid; e < N * nx; e += THREADS) nuo[e] = frozen ? nu_d[e] : nu_d[e] + ad * dnuc[e];
  __syncthreads();

  // ---- residuals at the new iterate, and the KKT scalar's terms ----
  // kkt = (q_abs, mp, sc, md, gap): max |q|, primal, max |lam|, dual, gap
  T kkt[5] = {T(0), T(0), T(0), T(0), T(0)};
  for (int e = tid; e < N * nx; e += THREADS) {
    const int k = e / nx, i = e - k * nx;
    // dynamics: A x_k + B u_k + c_k - x_{k+1}
    T v = T(0);
    for (int j = 0; j < nx; ++j) v += A[(size_t)k * nxx + i * nx + j] * Xo[k * nx + j];
    for (int u = 0; u < nu; ++u) v += Bm[(size_t)k * nxu + i * nu + u] * Uo[k * nu + u];
    v += c[e] - Xo[(k + 1) * nx + i];
    reqo[e] = v;
    kkt[1] = nan_max(kkt[1], fabs(v));
    // stationarity in x_k, k = 1..N-1 (row 0 pinned to zero)
    T r = T(0);
    if (k > 0) {
      for (int j = 0; j < nx; ++j) r += a.Hx[(size_t)k * nxx + i * nx + j] * Xo[k * nx + j];
      r += qx[e];
      for (int l = 0; l < ni; ++l) r += Gx[((size_t)k * ni + l) * nx + i] * lamo[k * ni + l];
      r += nuo[(k - 1) * nx + i];
      T at = T(0);
      for (int j = 0; j < nx; ++j) at += A[(size_t)k * nxx + j * nx + i] * nuo[k * nx + j];
      r -= at;
    }
    rxo[e] = r;
    kkt[3] = nan_max(kkt[3], fabs(r));
  }
  for (int e = tid; e < Nni; e += THREADS) {
    const int k = e / ni;
    T v = T(0);
    for (int i = 0; i < nx; ++i) v += Gx[(size_t)e * nx + i] * Xo[k * nx + i];
    for (int u = 0; u < nu; ++u) v += Gu[(size_t)e * nu + u] * Uo[k * nu + u];
    v += so[e] - h[e];
    rineqo[e] = v;
    kkt[1] = nan_max(kkt[1], fabs(v));
    kkt[4] += lamo[e] * so[e];
    kkt[2] = nan_max(kkt[2], fabs(lamo[e]));
  }
  for (int e = tid; e < ni_f; e += THREADS) {
    T v = T(0);
    for (int i = 0; i < nx; ++i) v += Gf[e * nx + i] * Xo[N * nx + i];
    v += sfo[e] - hf[e];
    rineqfo[e] = v;
    kkt[1] = nan_max(kkt[1], fabs(v));
    kkt[4] += lamfo[e] * sfo[e];
    kkt[2] = nan_max(kkt[2], fabs(lamfo[e]));
  }
  for (int e = tid; e < nx; e += THREADS) {
    T r = T(0);
    for (int j = 0; j < nx; ++j) r += a.HxN[e * nx + j] * Xo[N * nx + j];
    r += qx[N * nx + e];
    for (int l = 0; l < ni_f; ++l) r += Gf[l * nx + e] * lamfo[l];
    r += nuo[(N - 1) * nx + e];
    rxNo[e] = r;
    kkt[3] = nan_max(kkt[3], fabs(r));
  }
  for (int e = tid; e < N * nu; e += THREADS) {
    const int k = e / nu, u = e - k * nu;
    T r = T(0);
    for (int v = 0; v < nu; ++v) r += a.Hu[((size_t)k * nu + u) * nu + v] * Uo[k * nu + v];
    r += qu[e];
    for (int l = 0; l < ni; ++l) r += Gu[((size_t)k * ni + l) * nu + u] * lamo[k * ni + l];
    T bt = T(0);
    for (int j = 0; j < nx; ++j) bt += Bm[(size_t)k * nxu + j * nu + u] * nuo[k * nx + j];
    r -= bt;
    ruo[e] = r;
    kkt[3] = nan_max(kkt[3], fabs(r));
  }
  for (int e = tid; e < (N + 1) * nx; e += THREADS) kkt[0] = nan_max(kkt[0], fabs(qx[e]));
  for (int e = tid; e < N * nu; e += THREADS) kkt[0] = nan_max(kkt[0], fabs(qu[e]));
  block_reduce<5>(kkt, {MAX, MAX, MAX, MAX, SUM}, L.red, turn);
  const T scale_p = a.scale_p[b];
  const T q_abs = kkt[0];
  const T res_p = kkt[1] / scale_p;
  const T scale_d = T(1) + nan_max(q_abs, kkt[2]);
  const T res_d = kkt[3] / scale_d;
  const T gap_n = kkt[4] / n_comp;
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
    // old = (mp, sc, md, gap)
    T old[4] = {T(0), T(0), T(0), T(0)};
    for (int e = tid; e < N * nx; e += THREADS) {
      old[0] = nan_max(old[0], fabs(req[e]));
      old[2] = nan_max(old[2], fabs(rx[e]));
    }
    for (int e = tid; e < Nni; e += THREADS) {
      old[0] = nan_max(old[0], fabs(rineq[e]));
      old[3] += lam[e] * s[e];
      old[1] = nan_max(old[1], fabs(lam[e]));
    }
    for (int e = tid; e < ni_f; e += THREADS) {
      old[0] = nan_max(old[0], fabs(rineqf[e]));
      old[3] += lamf[e] * sf[e];
      old[1] = nan_max(old[1], fabs(lamf[e]));
    }
    for (int e = tid; e < nx; e += THREADS) old[2] = nan_max(old[2], fabs(rxN[e]));
    for (int e = tid; e < N * nu; e += THREADS) old[2] = nan_max(old[2], fabs(ru[e]));
    block_reduce<4>(old, {MAX, MAX, MAX, SUM}, L.red, turn);
    const T rp = old[0] / scale_p;
    const T sd_old = T(1) + nan_max(q_abs, old[1]);
    const T rd = old[2] / sd_old;
    const T g_old = old[3] / n_comp;
    res_out = nan_max(nan_max(rp, rd), g_old / sd_old);
  }
  if (tid == 0) {
    a.res[b] = res_out;
    a.bad[b] = is_bad ? 1 : 0;
  }
}

template <typename T>
size_t ipm_bytes(int N, int nx, int nu, int ni, int ni_f, bool* on_chip) {
  IpmSmem<T> L;
  const size_t full = ipm_layout<T>(L, nullptr, N, nx, nu, ni, ni_f, true) * sizeof(T);
  *on_chip = full <= MAX_SMEM;
  return *on_chip ? full : ipm_layout<T>(L, nullptr, N, nx, nu, ni, ni_f, false) * sizeof(T);
}

// The instantiation for these widths.
template <typename T>
auto ipm_kernel(int nx, int nu) {
  RNM_BY_WIDTH(ipm_iter_kernel, T, nx, nu);
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
  bool on_chip;
  const size_t bytes = ipm_bytes<T>(N, nx, nu, ni, ni_f, &on_chip);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = ipm_kernel<T>(nx, nu);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<Bsz, THREADS, bytes, stream>>>(a, N, nx, nu, ni, ni_f, T(tau), T(n_comp),
                                          on_chip ? 1 : 0);
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

// dims = (N, nx, nu, ni, ni_f, nw)
int rnm_ipm_iteration_info_f32(const int* d, int* out) {
  bool on_chip;
  const size_t bytes = ipm_bytes<float>(d[0], d[1], d[2], d[3], d[4], &on_chip);
  return kernel_info(ipm_kernel<float>(d[1], d[2]), THREADS, bytes, out, on_chip ? 1 : 0);
}
int rnm_ipm_iteration_info_f64(const int* d, int* out) {
  bool on_chip;
  const size_t bytes = ipm_bytes<double>(d[0], d[1], d[2], d[3], d[4], &on_chip);
  return kernel_info(ipm_kernel<double>(d[1], d[2]), THREADS, bytes, out, on_chip ? 1 : 0);
}

}  // extern "C"

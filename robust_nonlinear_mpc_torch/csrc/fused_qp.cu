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
// The stage loops are the device functions of newton.cuh: the current
// stage's P, A, P*A, Fxx (nx x nx) and B, P*B, Fxu', K (nx x nu) live in
// shared memory; the threads of the block spread over the entries of each
// product. The nu x nu gain system is solved by a closed-form recursive
// blockwise-Schur inverse of the symmetrized, trace-regularized Fuu plus one
// refinement pass, as in the Pallas kernel; P is symmetrized at every stage
// (skipping it lets asymmetric roundoff compound over long horizons). The
// forward sweep runs in the same kernel.
//
// Bound: latency. Per stage a lane does about 4*nx^3 FMAs over 17x17 blocks
// (nx = 17, nu = 4 for the rocket) in a handful of dependent phases, and the
// stages are strictly sequential over N, so the time is the chain of
// barriers and shared-memory round trips, not bytes or FLOPs. Later work:
// tensor-core (wgmma) products, several lanes per block to fill the warps,
// and CUDA-graph capture of the whole IPM iteration.

#include "newton.cuh"

namespace {

using namespace rnm;

template <typename T>
__global__ void __launch_bounds__(THREADS) factor_predictor_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ Cxx,
    const T* __restrict__ Cuu, const T* __restrict__ Cxu, const T* __restrict__ PN,
    const T* __restrict__ rbx, const T* __restrict__ rbxN, const T* __restrict__ rbu,
    const T* __restrict__ req, T* __restrict__ dX, T* __restrict__ dU,
    T* __restrict__ dnu, T* __restrict__ Kout, T* __restrict__ FxuTout,
    T* __restrict__ Fuu_tri, T* __restrict__ Fiv_tri, T* __restrict__ Pseq,
    T* __restrict__ kff_g, T* __restrict__ pn_g, int N, int nx, int nu) {
  __shared__ FactorSmem<T> sm;
  const size_t b = blockIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * (nu + 1) / 2;
  factor_predictor_lane<T>(
      A + b * N * nxx, B + b * N * nxu, Cxx + b * N * nxx, Cuu + b * N * nu * nu,
      Cxu + b * N * nxu, PN + b * nxx, rbx + b * N * nx, rbxN + b * nx, rbu + b * N * nu,
      req + b * N * nx, dX + b * (N + 1) * nx, dU + b * N * nu, dnu + b * N * nx,
      Kout + b * N * nxu, FxuTout + b * N * nxu, Fuu_tri + b * N * nuu,
      Fiv_tri + b * N * nuu, Pseq + b * N * nxx, kff_g + b * N * nu, pn_g + b * N * nx,
      N, nx, nu, sm);
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
  __shared__ SweepSmem<T> sm;
  const size_t b = blockIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * (nu + 1) / 2;
  resolve_lane<T>(A + b * N * nxx, B + b * N * nxu, K + b * N * nxu, FxuT + b * N * nxu,
                  Fuu_tri + b * N * nuu, Fiv_tri + b * N * nuu, Pseq + b * N * nxx,
                  rbx + b * N * nx, rbxN + b * nx, rbu + b * N * nu, req + b * N * nx,
                  dX + b * (N + 1) * nx, dU + b * N * nu, dnu + b * N * nx,
                  kff_g + b * N * nu, pn_g + b * N * nx, N, nx, nu, sm);
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

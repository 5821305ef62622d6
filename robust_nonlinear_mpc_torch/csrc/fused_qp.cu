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
// At the bench's B = 512 that is one wave on the H100's 132 SMs, so a
// kernel's time is the length of one lane's dependency chain, and the
// design shortens that chain (the stage loops are the device functions of
// newton.cuh):
//   * the stage inputs (A_k, B_k, the curvature, the rhs) reach shared
//     memory by `cp.async` two stages ahead, in a two-slot ring that the
//     warps without a gain thread fill while the gains are solved;
//   * the factorization's stage is four barrier-separated phases over the
//     block (PA/PB/w; Fxx/Fxu'/Fuu/f_u/pnew; the gains; P and p); the
//     nu x nu gain system is formed and inverted in registers by each of
//     the nx + 1 threads that solve a column (the closed-form recursive
//     blockwise-Schur inverse of the symmetrized, trace-regularized Fuu plus
//     one refinement pass, as in the Pallas kernel); P is symmetrized at
//     every stage (skipping it lets asymmetric roundoff compound over long
//     horizons);
//   * the lane's P_{k+1}, K, kff, p_{k+1} and dX stay in shared memory
//     (stride nx, no padding; dynamic shared memory, about 33 KB in float32
//     at the rocket's widths), so the forward sweep reads nothing back from
//     device memory; it runs on one warp (the state's entries handed round
//     by shuffles), and dnu is one parallel pass after it. Where the
//     sequences do not fit (long horizons in float64), they stay in device
//     memory;
//   * each model's (nx, nu) is its own instantiation (RNM_BY_WIDTH), so
//     the dot products unroll and the nu x nu blocks stay in registers; any
//     other nx <= 32, nu <= 4 takes the general path, whose width-32 arrays
//     live on the stack (half the blocks an SM, `Residency`), several times
//     slower at the rocket's shape.
//
// Bound: latency. Per stage a lane does about 4*nx^3 FMAs in four
// dependent phases, and the stages are strictly sequential over N, so the
// time is the chain of barriers and shared-memory round trips, stretched by
// the three other lanes that share the SM at B = 512 (one lane an SM runs
// the chain in about 60 % of the time), not the bytes or FLOPs of the
// call.

#include "newton.cuh"
#include "occupancy.cuh"

namespace {

using namespace rnm;

// Shared memory of the factor + predictor kernel. Ring slot: A, B, req,
// rbx, rbu, Cxx, Cxu, Cuu of one stage; the forward sweep reuses the two
// slots as four of A, B, req.
template <typename T>
struct FpSmem {
  T* ring[2];  // contiguous: the forward sweep's four slots fit in the two
  int oA, oB, oreq, orbx, orbu, oCxx, oCxu, oCuu, fwd_slot;
  FactorWork<T> wk;
  T *FxuT, *P, *p, *K, *kff, *dX;  // the sequences are null off chip
};

template <typename T>
__host__ __device__ size_t fp_layout(FpSmem<T>& L, T* base, int N, int nx, int nu,
                                     bool on_chip) {
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * nu;
  L.oA = 0;
  L.oB = L.oA + nxx;
  L.oreq = L.oB + nxu;
  L.fwd_slot = L.oreq + nx;  // the forward sweep's slot: A, B, req
  L.orbx = L.oreq + nx;
  L.orbu = L.orbx + nx;
  L.oCxx = L.orbu + nu;
  L.oCxu = L.oCxx + nxx;
  L.oCuu = L.oCxu + nxu;
  const int slot = L.oCuu + nuu;
  Carve c;
  L.ring[0] = c.take(base, 2 * (size_t)slot);
  L.ring[1] = L.ring[0] ? L.ring[0] + slot : nullptr;
  L.wk.PA = c.take(base, nxx);
  L.wk.Fxx = c.take(base, nxx);
  L.wk.PB = c.take(base, nxu);
  L.wk.Fuu = c.take(base, nuu);
  L.wk.w = c.take(base, nx);
  L.wk.pnew = c.take(base, nx);
  L.wk.fu = c.take(base, nu);
  L.FxuT = c.take(base, nxu);
  T* none = nullptr;
  L.P = c.take(on_chip ? base : none, on_chip ? (size_t)N * nxx : 0);
  L.p = c.take(on_chip ? base : none, on_chip ? (size_t)N * nx : 0);
  L.K = c.take(on_chip ? base : none, on_chip ? (size_t)N * nxu : 0);
  L.kff = c.take(on_chip ? base : none, on_chip ? (size_t)N * nu : 0);
  L.dX = c.take(on_chip ? base : none, on_chip ? (size_t)(N + 1) * nx : 0);
  return c.words;
}

// Shared memory of the corrector kernel. Ring slot (four of them): A, B,
// req, rbx, rbu, P_{k+1}, Fxu', the two triangles and K of one stage.
template <typename T>
struct RsSmem {
  T* ring;  // SWEEP_SLOTS slots of `slot` words
  int slot, oA, oB, oreq, orbx, orbu, oP, oFx, oFu, oFi, oK;
  T *kff, *pn, *dX;  // the sequences are null off chip
};

template <typename T>
__host__ __device__ size_t rs_layout(RsSmem<T>& L, T* base, int N, int nx, int nu,
                                     bool on_chip) {
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * (nu + 1) / 2;
  L.oA = 0;
  L.oB = L.oA + nxx;
  L.oreq = L.oB + nxu;
  L.orbx = L.oreq + nx;
  L.orbu = L.orbx + nx;
  L.oP = L.orbu + nu;
  L.oFx = L.oP + nxx;
  L.oFu = L.oFx + nxu;
  L.oFi = L.oFu + nuu;
  L.oK = L.oFi + nuu;
  L.slot = L.oK + nxu;
  Carve c;
  L.ring = c.take(base, (size_t)SWEEP_SLOTS * L.slot);
  T* none = nullptr;
  L.kff = c.take(on_chip ? base : none, on_chip ? (size_t)N * nu : 0);
  L.pn = c.take(on_chip ? base : none, on_chip ? (size_t)N * nx : 0);
  L.dX = c.take(on_chip ? base : none, on_chip ? (size_t)(N + 1) * nx : 0);
  return c.words;
}

template <typename T, int NXC, int NUC>
__global__ void __launch_bounds__(THREADS, (Residency<T, NXC>::blocks)) factor_predictor_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ Cxx,
    const T* __restrict__ Cuu, const T* __restrict__ Cxu, const T* __restrict__ PN,
    const T* __restrict__ rbx, const T* __restrict__ rbxN, const T* __restrict__ rbu,
    const T* __restrict__ req, T* dX, T* dU, T* dnu, T* Kout, T* FxuTout, T* Fuu_tri,
    T* Fiv_tri, T* Pseq, T* kff_g, T* pn_g, int N, int nx_, int nu_, int on_chip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx = NXC > 0 ? NXC : nx_;
  const int nu = NUC > 0 ? NUC : nu_;
  FpSmem<T> L;
  fp_layout<T>(L, reinterpret_cast<T*>(smem_raw), N, nx, nu, on_chip != 0);
  const size_t b = blockIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nuu = nu * nu, nut = nu * (nu + 1) / 2;
  const size_t sN = (size_t)N;
  const FactorIn<T> in{{A + b * sN * nxx, nxx, L.oA},     {B + b * sN * nxu, nxu, L.oB},
                       {req + b * sN * nx, nx, L.oreq},   {rbx + b * sN * nx, nx, L.orbx},
                       {rbu + b * sN * nu, nu, L.orbu},   {Cxx + b * sN * nxx, nxx, L.oCxx},
                       {Cxu + b * sN * nxu, nxu, L.oCxu}, {Cuu + b * sN * nuu, nuu, L.oCuu}};
  const FactorOut<T> out{seq_out(Pseq + b * sN * nxx, L.P, nxx),
                         seq_out(pn_g + b * sN * nx, L.p, nx),
                         seq_out(Kout + b * sN * nxu, L.K, nxu),
                         slot_out(FxuTout + b * sN * nxu, L.FxuT, nxu),
                         dev_out(Fuu_tri + b * sN * nut, nut),
                         dev_out(Fiv_tri + b * sN * nut, nut),
                         seq_out(kff_g + b * sN * nu, L.kff, nu)};
  const int tid = threadIdx.x;
  for (int i = tid; i < nxx; i += THREADS) out.P.put(N - 1, i, PN[b * nxx + i]);
  for (int i = tid; i < nx; i += THREADS) out.p.put(N - 1, i, rbxN[b * nx + i]);
  factor_lane<T, NXC, NUC>(in, out, L.wk, L.ring, N, nx, nu);
  const ForwardIn<T> fin{in.A, in.B, in.req, {out.K.c, nxu, -1}, out.kff.c, out.P.c, out.p.c};
  forward_sweep<T, NXC, NUC>(fin, seq_out(dX + b * (sN + 1) * nx, L.dX, nx),
                             dev_out(dU + b * sN * nu, nu), dev_out(dnu + b * sN * nx, nx),
                             SweepRing<T>{L.ring[0], L.fwd_slot}, N, nx, nu);
}

template <typename T, int NXC, int NUC>
__global__ void __launch_bounds__(THREADS, (Residency<T, NXC>::blocks)) resolve_kernel(
    const T* __restrict__ A, const T* __restrict__ B, const T* __restrict__ K,
    const T* __restrict__ FxuT, const T* __restrict__ Fuu_tri,
    const T* __restrict__ Fiv_tri, const T* __restrict__ Pseq,
    const T* __restrict__ rbx, const T* __restrict__ rbxN, const T* __restrict__ rbu,
    const T* __restrict__ req, T* dX, T* dU, T* dnu, T* kff_g, T* pn_g, int N, int nx_,
    int nu_, int on_chip) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx = NXC > 0 ? NXC : nx_;
  const int nu = NUC > 0 ? NUC : nu_;
  RsSmem<T> L;
  rs_layout<T>(L, reinterpret_cast<T*>(smem_raw), N, nx, nu, on_chip != 0);
  const size_t b = blockIdx.x;
  const int nxx = nx * nx, nxu = nx * nu, nut = nu * (nu + 1) / 2;
  const size_t sN = (size_t)N;
  const Seq<T> As{A + b * sN * nxx, nxx, L.oA}, Bs{B + b * sN * nxu, nxu, L.oB},
      rs{req + b * sN * nx, nx, L.oreq};
  const T* Pl = Pseq + b * sN * nxx;
  const FeedforwardIn<T> ff{As, Bs, rs,
                            {rbx + b * sN * nx, nx, L.orbx}, {rbu + b * sN * nu, nu, L.orbu},
                            {Pl, nxx, L.oP}, {FxuT + b * sN * nxu, nxu, L.oFx},
                            {Fuu_tri + b * sN * nut, nut, L.oFu},
                            {Fiv_tri + b * sN * nut, nut, L.oFi}, rbxN + b * nx};
  const Out<T> kff = seq_out(kff_g + b * sN * nu, L.kff, nu);
  const Out<T> pn = seq_out(pn_g + b * sN * nx, L.pn, nx);
  const SweepRing<T> ring{L.ring, L.slot};
  feedforward_sweep<T, NXC, NUC>(ff, kff, pn, ring, N, nx, nu);
  const ForwardIn<T> fin{As, Bs, rs, {K + b * sN * nxu, nxu, L.oK}, kff.c, Pl, pn.c};
  forward_sweep<T, NXC, NUC>(fin, seq_out(dX + b * (sN + 1) * nx, L.dX, nx),
                             dev_out(dU + b * sN * nu, nu), dev_out(dnu + b * sN * nx, nx),
                             ring, N, nx, nu);
}

// Shared bytes of a launch, and whether the lane's sequences sit on chip.
template <typename T, typename Layout>
size_t smem_bytes(Layout layout, int N, int nx, int nu, bool* on_chip) {
  const size_t full = layout(N, nx, nu, true) * sizeof(T);
  *on_chip = full <= MAX_SMEM;
  return *on_chip ? full : layout(N, nx, nu, false) * sizeof(T);
}

template <typename T>
size_t fp_bytes(int N, int nx, int nu, bool* on_chip) {
  return smem_bytes<T>([](int n, int x, int u, bool c) {
    FpSmem<T> L;
    return fp_layout<T>(L, nullptr, n, x, u, c);
  }, N, nx, nu, on_chip);
}

template <typename T>
size_t rs_bytes(int N, int nx, int nu, bool* on_chip) {
  return smem_bytes<T>([](int n, int x, int u, bool c) {
    RsSmem<T> L;
    return rs_layout<T>(L, nullptr, n, x, u, c);
  }, N, nx, nu, on_chip);
}

// The instantiation for these widths.
template <typename T>
auto fp_kernel(int nx, int nu) {
  RNM_BY_WIDTH(factor_predictor_kernel, T, nx, nu);
}

template <typename T>
auto rs_kernel(int nx, int nu) {
  RNM_BY_WIDTH(resolve_kernel, T, nx, nu);
}

template <typename T>
int launch_factor_predictor(const T* A, const T* B, const T* Cxx, const T* Cuu,
                            const T* Cxu, const T* PN, const T* rbx, const T* rbxN,
                            const T* rbu, const T* req, T* dX, T* dU, T* dnu, T* K,
                            T* FxuT, T* Fuu_tri, T* Fiv_tri, T* Pseq, T* kff, T* pn,
                            int Bsz, int N, int nx, int nu, cudaStream_t stream) {
  if (!dims_ok(Bsz, N, nx, nu)) return (int)cudaErrorInvalidValue;
  bool on_chip;
  const size_t bytes = fp_bytes<T>(N, nx, nu, &on_chip);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = fp_kernel<T>(nx, nu);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<Bsz, THREADS, bytes, stream>>>(A, B, Cxx, Cuu, Cxu, PN, rbx, rbxN, rbu, req, dX,
                                          dU, dnu, K, FxuT, Fuu_tri, Fiv_tri, Pseq, kff, pn,
                                          N, nx, nu, on_chip ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_resolve(const T* A, const T* B, const T* K, const T* FxuT, const T* Fuu_tri,
                   const T* Fiv_tri, const T* Pseq, const T* rbx, const T* rbxN,
                   const T* rbu, const T* req, T* dX, T* dU, T* dnu, T* kff, T* pn,
                   int Bsz, int N, int nx, int nu, cudaStream_t stream) {
  if (!dims_ok(Bsz, N, nx, nu)) return (int)cudaErrorInvalidValue;
  bool on_chip;
  const size_t bytes = rs_bytes<T>(N, nx, nu, &on_chip);
  if (bytes > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = rs_kernel<T>(nx, nu);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<Bsz, THREADS, bytes, stream>>>(A, B, K, FxuT, Fuu_tri, Fiv_tri, Pseq, rbx, rbxN,
                                          rbu, req, dX, dU, dnu, kff, pn, N, nx, nu,
                                          on_chip ? 1 : 0);
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

// dims = (N, nx, nu, ni, ni_f, nw)
int rnm_factor_predictor_info_f32(const int* d, int* out) {
  bool on_chip;
  return kernel_info(fp_kernel<float>(d[1], d[2]), THREADS,
                     fp_bytes<float>(d[0], d[1], d[2], &on_chip), out);
}
int rnm_factor_predictor_info_f64(const int* d, int* out) {
  bool on_chip;
  return kernel_info(fp_kernel<double>(d[1], d[2]), THREADS,
                     fp_bytes<double>(d[0], d[1], d[2], &on_chip), out);
}
int rnm_resolve_info_f32(const int* d, int* out) {
  bool on_chip;
  return kernel_info(rs_kernel<float>(d[1], d[2]), THREADS,
                     rs_bytes<float>(d[0], d[1], d[2], &on_chip), out);
}
int rnm_resolve_info_f64(const int* d, int* out) {
  bool on_chip;
  return kernel_info(rs_kernel<double>(d[1], d[2]), THREADS,
                     rs_bytes<double>(d[0], d[1], d[2], &on_chip), out);
}

const char* rnm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Fused system-response synthesis for NVIDIA Hopper (sm_90a): propagation of
// the response maps Phi_x / Phi_u through A + B K, the backoff row norms and
// the tube cost in one kernel. Bound to PyTorch through a plain C interface
// (ctypes) by robust_nonlinear_mpc_torch/ops/fused_response.py, which also
// holds the plain torch twin.
//
// Replaces robust_nonlinear_mpc_tpu/ops/pallas_response.py `_response_kernel`
// (wrapper `fused_response`). Always float32, as the Pallas kernel is.
//
// Per lane, column j of the response starts at stage j with Phi_x[j, j] =
// E[j] and walks k = j..N-1 on its own:
//   Phi_u[k, j] = K[k, j] Phi_x[k, j]
//   beta[k, j, i] = max(|| (Gx Phi_x[k, j] + Gu Phi_u[k, j])_i ||^2, eps)
//   tube += ||Q_reg Phi_x[k, j]||_F^2 + ||R_reg Phi_u[k, j]||_F^2
//   Phi_x[k+1, j] = A_k Phi_x[k, j] + B_k Phi_u[k, j]
// then the terminal row: beta_f[j, i] from Gf Phi_x[N, j] and the Q_reg_f
// term (column N is E[N] alone). Entries with j > k are zero. Only the
// backoffs cross columns: backoff[k, i] = sum_{j <= k} sqrt(beta[k, j, i]),
// backoff_f[i] = sum_j sqrt(beta_f[j, i]), and tube = sqrt(sum).
//
// Design: one warp per (lane, column), a warp-synchronous chain.
//   * A block holds one lane and up to 8 warps; warp w takes the columns
//     N-1-p and p of each pair p = w, w + warps, ... (N + 1 stages a pair),
//     and the last pair's warp also the terminal column N.
//   * Propagation, lane w: the lane owns disturbance column w of Phi_x[k, j]
//     (nx values) in registers and forms its Phi_u column (K[k, j] times it)
//     and its next column ([A_k B_k] times both); each shared load is a
//     16-byte broadcast of a matrix row that feeds four multiply-adds of
//     every lane. The lane also writes its column, [Phi_x; Phi_u][:, w], as
//     row w of a per-warp table Y.
//   * Row norms, lane r: the lane holds row r of the stacked block [Gx Gu;
//     Q_reg 0; 0 R_reg] (ni + nx + nu rows, two passes of the warp at the
//     rocket's 63) and sums (row . Y[w])^2 over w from broadcast rows of Y:
//     beta[k, j, r] for r < ni, the tube terms for the rest, with no
//     cross-lane reduction. The terminal row does the same with [Gf; Q_reg_f].
//   * The row blocks are built in shared memory once a block, behind its one
//     barrier. A_{k+1} and B_{k+1} reach a per-warp two-slot ring by
//     `cp.async` at the head of stage k, K[k+1, j] its slot once Phi_u is
//     formed, so the fetches overlap the row norms. Inside a stage only
//     `__syncwarp` orders the lanes.
//   * Phi_x[k, j] and Phi_u[k, j] leave as rows of nw consecutive floats
//     (lane w writes entry w), so each store instruction is one contiguous
//     segment, and beta as one row of ni; the zeros for j > k are written by
//     the whole block up front.
//   * After the warps are done (the second barrier), the block sums the
//     backoffs from the beta rows it wrote (read back from L2) and the tube
//     cost from one partial sum a warp.
//   * Each model's (nx, nu) with nw = nx is its own instantiation
//     (RNM_BY_WIDTH); other nx, nw <= 32, nu <= 4 take the general path
//     (`Residency`: half the blocks an SM, twice the registers).
// Shared memory per block: 53 KB at the rocket's widths with 8 warps, for
// any N (nothing is kept per stage), so four lanes an SM: B = 512 in one
// wave at 64 registers a thread.
//
// Bound: bytes. At B = 512 the kernel must write Phi_x (151 MB) and Phi_u
// (33 MB) and read the active half of K (j <= k, 17 MB), 234 MB in all, or
// 70 us at 3.35 TB/s; the products are 3.7 GFLOP (55 us at the float32
// peak; chip_smoke.kernel_bound).

#include "newton.cuh"
#include "occupancy.cuh"

namespace {

constexpr int RSP_WARPS = 8;
constexpr int MAX_SMEM = 227 * 1024;

__host__ __device__ __forceinline__ int pad32(int n) { return (n + 31) & ~31; }

// Shared-memory layout in floats; every region a multiple of 4. Block: the
// stage's row blocks Ra (pad32(ni + nx + nu) rows of ld: [Gx Gu], [Q_reg 0],
// [0 R_reg], zero rows), the terminal's Rf (pad32(ni_f + nx) rows of ld:
// [Gf 0], [Q_reg_f 0], zero rows), 32 words for the tube's partial sums. Per
// warp: a two-slot ring of [A_k B_k] (nx rows of ld each), K[k, j] (nu rows
// of nxp), the column's [Phi_x; Phi_u] by disturbance (nw rows of ld: row
// w = [x_w, u_w]).
struct RspLayout {
  int nxp, ld, ra, rf, block, warp;
  __host__ __device__ RspLayout(int nx, int nu, int nw, int ni, int ni_f) {
    nxp = rnm::pad4(nx);
    ld = nxp + 4;
    ra = pad32(ni + nx + nu);
    rf = pad32(ni_f + nx);
    block = (ra + rf) * ld + 32;
    warp = 2 * nx * ld + nu * nxp + nw * ld;
  }
  size_t words(int warps) const { return (size_t)block + (size_t)warps * warp; }
};

int rsp_warps(int N, int nx, int nu, int nw, int ni, int ni_f) {
  const RspLayout L(nx, nu, nw, ni, ni_f);
  int w = (N + 1) / 2 < RSP_WARPS ? (N + 1) / 2 : RSP_WARPS;
  while (w > 0 && L.words(w) * sizeof(float) > (size_t)MAX_SMEM) --w;
  return w;
}

// sum over w < nw of (g . Y[w])^2, g = (gx, gu) a row in registers, Y the
// warp's [Phi_x; Phi_u] rows (ld apart) in shared memory
template <int NX, int NU>
__device__ __forceinline__ float row_norm(const float* gx, const float* gu, const float* Y,
                                          int ld, int nxp, int nx, int nu, int nw) {
  float acc = 0.f;
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    float y[NX], yu[NU];
    rnm::load_row<float, NX>(Y + w * ld, y, nx);
    rnm::load_row<float, NU>(Y + w * ld + nxp, yu, nu);
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int l = 0; l < NX; l += 2) {
      if (l < nx) s0 += gx[l] * y[l];
      if (l + 1 < NX && l + 1 < nx) s1 += gx[l + 1] * y[l + 1];
    }
#pragma unroll
    for (int u = 0; u < NU; ++u)
      if (u < nu) s0 += gu[u] * yu[u];
    const float z = s0 + s1;
    acc += z * z;
  }
  return acc;
}

template <typename T, int NXC, int NUC>
__global__ void __launch_bounds__(32 * RSP_WARPS, (rnm::Residency<T, NXC>::blocks))
    response_kernel(const float* __restrict__ A, const float* __restrict__ B,
                    const float* __restrict__ E, const float* __restrict__ K,
                    const float* __restrict__ Gx, const float* __restrict__ Gu,
                    const float* __restrict__ Gf, const float* __restrict__ Qr,
                    const float* __restrict__ Rr, const float* __restrict__ Qrf,
                    float* __restrict__ Phi_x, float* __restrict__ Phi_u,
                    float* __restrict__ beta, float* __restrict__ beta_f,
                    float* __restrict__ backoff, float* __restrict__ backoff_f,
                    float* __restrict__ tube, int N, int nx_, int nu_, int nw_, int ni,
                    int ni_f, float eps) {
  constexpr int NX = NXC > 0 ? NXC : rnm::MAXNX;
  constexpr int NU = NUC > 0 ? NUC : rnm::MAXNU;
  // loops over the register columns unroll at a model's widths; on the
  // general path they stay rolled (their arrays live on the stack), which
  // keeps its build short
  constexpr int UNR = NXC > 0 ? 64 : 1;
  const int nx = NXC > 0 ? NXC : nx_;
  const int nu = NUC > 0 ? NUC : nu_;
  const int nw = NXC > 0 ? NXC : nw_;  // the instantiated models have nw = nx
  const RspLayout L(nx, nu, nw, ni, ni_f);
  const int nxp = L.nxp, ld = L.ld;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  float* Ra = smem;
  float* Rf = Ra + L.ra * ld;
  float* red = Rf + L.rf * ld;
  float* AB = red + 32 + (size_t)warp * L.warp;
  float* Ks = AB + 2 * nx * ld;
  float* Y = Ks + nu * nxp;
  const size_t b = blockIdx.x;
  const int J = N + 1, xw = nx * nw, uw = nu * nw;

  // the row blocks, zero-padded
  for (int e = tid; e < L.ra * ld; e += blockDim.x) {
    const int r = e / ld, s = e - r * ld;
    const bool xs = s < nx, us = s >= nxp && s < nxp + nu;
    float v = 0.f;
    if (r < ni)
      v = xs ? Gx[r * nx + s] : us ? Gu[r * nu + s - nxp] : 0.f;
    else if (r < ni + nx)
      v = xs ? Qr[(r - ni) * nx + s] : 0.f;
    else if (r < ni + nx + nu)
      v = us ? Rr[(r - ni - nx) * nu + s - nxp] : 0.f;
    Ra[e] = v;
  }
  for (int e = tid; e < L.rf * ld; e += blockDim.x) {
    const int r = e / ld, s = e - r * ld;
    float v = 0.f;
    if (s < nx) v = r < ni_f ? Gf[r * nx + s] : r < ni_f + nx ? Qrf[(r - ni_f) * nx + s] : 0.f;
    Rf[e] = v;
  }
  float* Px_b = Phi_x + b * (size_t)J * J * xw;
  float* Pu_b = Phi_u + b * (size_t)N * J * uw;
  float* beta_b = beta + b * (size_t)N * N * ni;
  for (int k = 0; k < N; ++k) {  // the columns j > k of stage k are zero
    float* zx = Px_b + ((size_t)k * J + k + 1) * xw;
    for (int i = tid; i < (N - k) * xw; i += blockDim.x) zx[i] = 0.f;
    float* zu = Pu_b + ((size_t)k * J + k + 1) * uw;
    for (int i = tid; i < (N - k) * uw; i += blockDim.x) zu[i] = 0.f;
    float* zb = beta_b + ((size_t)k * N + k + 1) * ni;
    for (int i = tid; i < (N - 1 - k) * ni; i += blockDim.x) zb[i] = 0.f;
  }
  __syncthreads();

  const bool own = lane < nw;
  const int w = own ? lane : 0;
  float tacc = 0.f;

  // rows r = lane, lane + 32, ... of a row block against the warp's Y: the
  // first `nb` rows give beta (to `out`), the rest the tube cost
  auto row_pass = [&](const float* Rm, int rows, int nb, float* out) {
    for (int r = lane; r < rows; r += 32) {
      float gx[NX], gu[NU];
      rnm::load_row<float, NX>(Rm + r * ld, gx, nx);
      rnm::load_row<float, NU>(Rm + r * ld + nxp, gu, nu);
      const float z2 = row_norm<NX, NU>(gx, gu, Y, ld, nxp, nx, nu, nw);
      if (r < nb)
        out[r] = fmaxf(z2, eps);
      else
        tacc += z2;
    }
  };

  auto column = [&](int j) {
    auto fetch_K = [&](int k) {
      const float* Kk = K + ((b * N + k) * J + j) * (size_t)(nu * nx);
      for (int i = lane; i < nu * nx; i += 32)
        rnm::cp_async_elem(Ks + (i / nx) * nxp + i % nx, Kk + i);
    };
    auto fetch_ab = [&](int k) {  // into ring slot k % 2
      const float* Ak = A + (b * N + k) * (size_t)(nx * nx);
      const float* Bk = B + (b * N + k) * (size_t)(nx * nu);
      float* slot = AB + (k & 1) * nx * ld;
      for (int i = lane; i < nx * nx; i += 32)
        rnm::cp_async_elem(slot + (i / nx) * ld + i % nx, Ak + i);
      for (int i = lane; i < nx * nu; i += 32)
        rnm::cp_async_elem(slot + (i / nu) * ld + nxp + i % nu, Bk + i);
    };
    __syncwarp();  // the previous column's reads of the slots and of Y are done
    if (j < N) {
      fetch_K(j);
      fetch_ab(j);
    }
    rnm::cp_async_commit();
    float x[NX], pu[NU];
#pragma unroll UNR
    for (int l = 0; l < NX; ++l)
      if (l < nx) x[l] = own ? E[((size_t)j * nx + l) * nw + w] : 0.f;

    for (int k = j; k < N; ++k) {
      rnm::cp_async_wait<0>();
      __syncwarp();
      // slot (k+1) % 2 was last read by stage k-1
      if (k + 1 < N) fetch_ab(k + 1);
      rnm::cp_async_commit();
      // lane w: Phi_x[k, j] and Phi_u[k, j] = K[k, j] Phi_x[k, j], column w,
      // out to device memory and into row w of Y
#pragma unroll UNR
      for (int u = 0; u < NU; ++u)
        if (u < nu) {
          float kr[NX];
          rnm::load_row<float, NX>(Ks + u * nxp, kr, nx);
          float s = 0.f;
#pragma unroll UNR
          for (int l = 0; l < NX; ++l)
            if (l < nx) s += kr[l] * x[l];
          pu[u] = s;
        }
      if (own) {
        float* Px = Px_b + ((size_t)k * J + j) * xw;
        float* Pu = Pu_b + ((size_t)k * J + j) * uw;
#pragma unroll UNR
        for (int l = 0; l < NX; ++l)
          if (l < nx) Px[l * nw + w] = x[l];
#pragma unroll UNR
        for (int u = 0; u < NU; ++u)
          if (u < nu) Pu[u * nw + w] = pu[u];
        rnm::store_row<float, NX>(Y + w * ld, x, nx);
        rnm::store_row<float, NU>(Y + w * ld + nxp, pu, nu);
      }
      __syncwarp();  // Y is written, K[k, j] is read
      if (k + 1 < N) fetch_K(k + 1);
      rnm::cp_async_commit();
      // lane r: beta[k, j, r] and the tube rows, over the nw columns of Y
      row_pass(Ra, ni + nx + nu, ni, beta_b + ((size_t)k * N + j) * ni);
      // lane w: Phi_x[k+1, j] = A_k Phi_x[k, j] + B_k Phi_u[k, j], from row w
      // of Y
      const float* ABk = AB + (k & 1) * nx * ld;
      rnm::load_row<float, NX>(Y + w * ld, x, nx);
      rnm::load_row<float, NU>(Y + w * ld + nxp, pu, nu);
      float xn[NX];
#pragma unroll UNR
      for (int i = 0; i < NX; ++i)
        if (i < nx) {
          float ar[NX], br[NU];
          rnm::load_row<float, NX>(ABk + i * ld, ar, nx);
          rnm::load_row<float, NU>(ABk + i * ld + nxp, br, nu);
          float s0 = 0.f, s1 = 0.f;
#pragma unroll UNR
          for (int l = 0; l < NX; l += 2) {
            if (l < nx) s0 += ar[l] * x[l];
            if (l + 1 < NX && l + 1 < nx) s1 += ar[l + 1] * x[l + 1];
          }
#pragma unroll UNR
          for (int u = 0; u < NU; ++u)
            if (u < nu) s0 += br[u] * pu[u];
          xn[i] = s0 + s1;
        }
#pragma unroll UNR
      for (int i = 0; i < NX; ++i)
        if (i < nx) x[i] = own ? xn[i] : 0.f;
    }

    // the terminal row: Phi_x[N, j], beta_f[j, :], the Q_reg_f term
    __syncwarp();  // the last stage's row norms have read every row of Y
    if (own) {
      float* Px = Px_b + ((size_t)N * J + j) * xw;
#pragma unroll UNR
      for (int l = 0; l < NX; ++l)
        if (l < nx) Px[l * nw + w] = x[l];
#pragma unroll UNR
      for (int u = 0; u < NU; ++u) pu[u] = 0.f;
      rnm::store_row<float, NX>(Y + w * ld, x, nx);
      rnm::store_row<float, NU>(Y + w * ld + nxp, pu, nu);
    }
    __syncwarp();
    row_pass(Rf, ni_f + nx, ni_f, beta_f + (b * J + j) * ni_f);
  };

  const int P = (N + 1) / 2;
  for (int p = warp; p < P; p += warps) {
    column(N - 1 - p);
    if (p != N - 1 - p) column(p);
    if (p == P - 1) column(N);
  }

  // the cross-column sums, from the beta rows the warps wrote
#pragma unroll UNR
  for (int s = 16; s >= 1; s >>= 1) tacc += __shfl_xor_sync(0xffffffffu, tacc, s);
  if (lane == 0) red[warp] = tacc;
  __syncthreads();
  for (int e = tid; e < N * ni; e += blockDim.x) {
    const int k = e / ni, i = e - k * ni;
    const float* bk = beta_b + (size_t)k * N * ni + i;
    float s = 0.f;
    for (int j = 0; j <= k; ++j) s += sqrtf(__ldcg(bk + (size_t)j * ni));
    backoff[b * N * ni + e] = s;
  }
  for (int i = tid; i < ni_f; i += blockDim.x) {
    const float* bf = beta_f + b * J * ni_f + i;
    float s = 0.f;
    for (int j = 0; j < J; ++j) s += sqrtf(__ldcg(bf + (size_t)j * ni_f));
    backoff_f[b * ni_f + i] = s;
  }
  if (tid == 0) {
    float total = 0.f;
    for (int v = 0; v < warps; ++v) total += red[v];
    tube[b] = sqrtf(total);
  }
}

auto rsp_kernel(int nx, int nu, int nw) {
  if (nw != nx) return response_kernel<float, 0, 0>;
  RNM_BY_WIDTH(response_kernel, float, nx, nu);
}

}  // namespace

extern "C" {

int rnm_fused_response_f32(const float* A, const float* B, const float* E, const float* K,
                           const float* Gx, const float* Gu, const float* Gf,
                           const float* Qr, const float* Rr, const float* Qrf, float* Phi_x,
                           float* Phi_u, float* beta, float* beta_f, float* backoff,
                           float* backoff_f, float* tube, int Bsz, int N, int nx, int nu,
                           int nw, int ni, int ni_f, double eps, void* stream) {
  if (Bsz < 1 || N < 1 || nx < 1 || nx > rnm::MAXNX || nu < 1 || nu > rnm::MAXNU || nw < 1 ||
      nw > 32 || ni < 1 || ni_f < 1)
    return (int)cudaErrorInvalidValue;
  const int warps = rsp_warps(N, nx, nu, nw, ni, ni_f);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  const size_t bytes = RspLayout(nx, nu, nw, ni, ni_f).words(warps) * sizeof(float);
  auto kernel = rsp_kernel(nx, nu, nw);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<Bsz, 32 * warps, bytes, (cudaStream_t)stream>>>(
      A, B, E, K, Gx, Gu, Gf, Qr, Rr, Qrf, Phi_x, Phi_u, beta, beta_f, backoff, backoff_f,
      tube, N, nx, nu, nw, ni, ni_f, (float)eps);
  return (int)cudaGetLastError();
}

// dims = (N, nx, nu, ni, ni_f, nw)
int rnm_fused_response_info_f32(const int* d, int* out) {
  const int warps = rsp_warps(d[0], d[1], d[2], d[5], d[3], d[4]);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  return rnm::kernel_info(rsp_kernel(d[1], d[2], d[5]), 32 * warps,
                          RspLayout(d[1], d[2], d[5], d[3], d[4]).words(warps) * sizeof(float),
                          out);
}

}  // extern "C"

// Fused system-response synthesis for NVIDIA Hopper (sm_90a): propagation of
// the response maps Phi_x / Phi_u through A + B K, the backoff row norms and
// the tube cost in one kernel. Bound to PyTorch through a plain C interface
// (ctypes) by robust_nonlinear_mpc_torch/ops/fused_response.py, which also
// holds the plain torch twin.
//
// Replaces robust_nonlinear_mpc_tpu/ops/pallas_response.py `_response_kernel`
// (wrapper `fused_response`). Always float32, as the Pallas kernel is.
//
// Per lane, for stage k = 0..N-1 the running response row Phi_x[k, :]
// (N+1 columns of nx x nw) stays in shared memory:
//   row[k] = E[k];  Phi_u[k, j] = K[k, j] row[j]            (j <= k, else 0)
//   beta[k, j, i] = max(|| (Gx row[j] + Gu Phi_u[k, j])_i ||^2, eps), j <= k
//   backoff[k, i] = sum_{j <= k} sqrt(beta[k, j, i])
//   tube += ||Q_reg row||_F^2 + ||R_reg Phi_u[k]||_F^2
//   row[j] <- A_k row[j] + B_k Phi_u[k, j]                    (j <= k, else 0)
// then the terminal row (diagonal E[N]) gives beta_f, backoff_f and the
// Q_reg_f term; tube = sqrt(sum). Phi_x and Phi_u are written to device memory
// once, as they are part of the solution.
//
// Design. One thread block per lane; the threads spread over the (column,
// row, disturbance) entries of each product. Columns j > k are zero and are
// skipped. Shared memory holds two copies of the row (current and next), the
// stage's Phi_u, A_k, B_k and the sqrt(beta) of the stage: 46 KB at the
// rocket's widths (N = 15, nx = nw = 17, nu = 4, ni = 42), dynamic, so longer
// horizons take up to the card's 227 KB.
//
// Bound: bytes. At B = 512 the kernel must write Phi_x (151 MB) and Phi_u
// (33 MB) and read K (33 MB), 251 MB in all, or 75 us at 3.35 TB/s; the
// products are 3.7 GFLOP (55 us at the float32 peak; chip_smoke.kernel_bound).

#include <cuda_runtime.h>
#include <stddef.h>

#include "occupancy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;

__device__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

size_t smem_floats(int N, int nx, int nu, int nw, int ni, int ni_f) {
  const size_t J = N + 1;
  const size_t nb = J * (size_t)(ni > ni_f ? ni : ni_f);
  return 2 * J * nx * nw + J * nu * nw + (size_t)nx * nx + (size_t)nx * nu + nb + THREADS;
}

__global__ void __launch_bounds__(THREADS) response_kernel(
    const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ E,
    const float* __restrict__ K, const float* __restrict__ Gx, const float* __restrict__ Gu,
    const float* __restrict__ Gf, const float* __restrict__ Qr, const float* __restrict__ Rr,
    const float* __restrict__ Qrf, float* __restrict__ Phi_x, float* __restrict__ Phi_u,
    float* __restrict__ beta, float* __restrict__ beta_f, float* __restrict__ backoff,
    float* __restrict__ backoff_f, float* __restrict__ tube, int N, int nx, int nu, int nw,
    int ni, int ni_f, float eps) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;
  const int J = N + 1;
  const int rsz = J * nx * nw, usz = J * nu * nw, xw = nx * nw, uw = nu * nw;
  float* row = smem;
  float* nxt = row + rsz;
  float* phu = nxt + rsz;
  float* Ak = phu + usz;
  float* Bk = Ak + nx * nx;
  float* sb = Bk + nx * nu;
  float* red = sb + J * (ni > ni_f ? ni : ni_f);

  const float* A_b = A + b * N * nx * nx;
  const float* B_b = B + b * N * nx * nu;
  const float* K_b = K + b * (size_t)N * J * nu * nx;
  float* Px_b = Phi_x + b * (size_t)J * rsz;
  float* Pu_b = Phi_u + b * (size_t)N * usz;
  float* beta_b = beta + b * (size_t)N * N * ni;

  for (int e = tid; e < rsz; e += THREADS) row[e] = 0.f;
  float tacc = 0.f;
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    // inject the diagonal Phi_x[k, k] = E[k]; stage matrices in
    for (int e = tid; e < xw; e += THREADS) row[k * xw + e] = E[k * xw + e];
    for (int e = tid; e < nx * nx; e += THREADS) Ak[e] = A_b[k * nx * nx + e];
    for (int e = tid; e < nx * nu; e += THREADS) Bk[e] = B_b[k * nx * nu + e];
    __syncthreads();

    // Phi_u[k, j] = K[k, j] row[j]; Phi_x[k] and Phi_u[k] out
    const float* K_k = K_b + (size_t)k * J * nu * nx;
    for (int e = tid; e < usz; e += THREADS) {
      const int j = e / uw, u = (e % uw) / nw, w = e % nw;
      float v = 0.f;
      if (j <= k)
        for (int i = 0; i < nx; ++i) v += K_k[(j * nu + u) * nx + i] * row[(j * nx + i) * nw + w];
      phu[e] = v;
      Pu_b[(size_t)k * usz + e] = v;
    }
    for (int e = tid; e < rsz; e += THREADS) Px_b[(size_t)k * rsz + e] = row[e];
    __syncthreads();

    // beta[k, j, i] and sqrt(beta) for the backoff; the tube terms
    for (int e = tid; e < N * ni; e += THREADS) {
      const int j = e / ni, i = e % ni;
      float bv = 0.f;
      if (j <= k) {
        float z2 = 0.f;
        for (int w = 0; w < nw; ++w) {
          float z = 0.f;
          for (int l = 0; l < nx; ++l) z += Gx[i * nx + l] * row[(j * nx + l) * nw + w];
          for (int u = 0; u < nu; ++u) z += Gu[i * nu + u] * phu[(j * nu + u) * nw + w];
          z2 += z * z;
        }
        bv = fmaxf(z2, eps);
        sb[j * ni + i] = sqrtf(bv);
      }
      beta_b[((size_t)k * N + j) * ni + i] = bv;
    }
    for (int e = tid; e < (k + 1) * xw; e += THREADS) {
      const int j = e / xw, a = (e % xw) / nw, w = e % nw;
      float v = 0.f;
      for (int l = 0; l < nx; ++l) v += Qr[a * nx + l] * row[(j * nx + l) * nw + w];
      tacc += v * v;
    }
    for (int e = tid; e < (k + 1) * uw; e += THREADS) {
      const int j = e / uw, u = (e % uw) / nw, w = e % nw;
      float v = 0.f;
      for (int l = 0; l < nu; ++l) v += Rr[u * nu + l] * phu[(j * nu + l) * nw + w];
      tacc += v * v;
    }
    // advance: row[j] <- A_k row[j] + B_k Phi_u[k, j] for j <= k
    for (int e = tid; e < rsz; e += THREADS) {
      const int j = e / xw, i = (e % xw) / nw, w = e % nw;
      float v = 0.f;
      if (j <= k) {
        for (int l = 0; l < nx; ++l) v += Ak[i * nx + l] * row[(j * nx + l) * nw + w];
        for (int u = 0; u < nu; ++u) v += Bk[i * nu + u] * phu[(j * nu + u) * nw + w];
      }
      nxt[e] = v;
    }
    __syncthreads();
    for (int i = tid; i < ni; i += THREADS) {
      float s = 0.f;
      for (int j = 0; j <= k; ++j) s += sb[j * ni + i];
      backoff[b * N * ni + k * ni + i] = s;
    }
    float* tmp = row;
    row = nxt;
    nxt = tmp;
    __syncthreads();
  }

  // terminal row: diagonal E[N]; beta_f, backoff_f and the Q_reg_f term
  for (int e = tid; e < xw; e += THREADS) row[N * xw + e] = E[N * xw + e];
  __syncthreads();
  for (int e = tid; e < rsz; e += THREADS) Px_b[(size_t)N * rsz + e] = row[e];
  for (int e = tid; e < J * ni_f; e += THREADS) {
    const int j = e / ni_f, i = e % ni_f;
    float z2 = 0.f;
    for (int w = 0; w < nw; ++w) {
      float z = 0.f;
      for (int l = 0; l < nx; ++l) z += Gf[i * nx + l] * row[(j * nx + l) * nw + w];
      z2 += z * z;
    }
    const float bv = fmaxf(z2, eps);
    beta_f[b * J * ni_f + e] = bv;
    sb[e] = sqrtf(bv);
  }
  for (int e = tid; e < rsz; e += THREADS) {
    const int j = e / xw, a = (e % xw) / nw, w = e % nw;
    float v = 0.f;
    for (int l = 0; l < nx; ++l) v += Qrf[a * nx + l] * row[(j * nx + l) * nw + w];
    tacc += v * v;
  }
  __syncthreads();
  for (int i = tid; i < ni_f; i += THREADS) {
    float s = 0.f;
    for (int j = 0; j < J; ++j) s += sb[j * ni_f + i];
    backoff_f[b * ni_f + i] = s;
  }
  const float total = block_sum(tacc, red);
  if (tid == 0) tube[b] = sqrtf(total);
}

}  // namespace

extern "C" {

int rnm_fused_response_f32(const float* A, const float* B, const float* E, const float* K,
                           const float* Gx, const float* Gu, const float* Gf,
                           const float* Qr, const float* Rr, const float* Qrf, float* Phi_x,
                           float* Phi_u, float* beta, float* beta_f, float* backoff,
                           float* backoff_f, float* tube, int Bsz, int N, int nx, int nu,
                           int nw, int ni, int ni_f, double eps, void* stream) {
  if (Bsz < 1 || N < 1 || nx < 1 || nu < 1 || nw < 1 || ni < 1 || ni_f < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_floats(N, nx, nu, nw, ni, ni_f) * sizeof(float);
  if (bytes > (size_t)MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      response_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  response_kernel<<<Bsz, THREADS, bytes, (cudaStream_t)stream>>>(
      A, B, E, K, Gx, Gu, Gf, Qr, Rr, Qrf, Phi_x, Phi_u, beta, beta_f, backoff, backoff_f,
      tube, N, nx, nu, nw, ni, ni_f, (float)eps);
  return (int)cudaGetLastError();
}

// dims = (N, nx, nu, ni, ni_f, nw)
int rnm_fused_response_info_f32(const int* d, int* out) {
  return rnm::kernel_info(response_kernel, THREADS,
                          smem_floats(d[0], d[1], d[2], d[5], d[3], d[4]) * sizeof(float), out);
}

}  // extern "C"

// Device building blocks of the Riccati Newton solves, shared by the fused
// Newton kernels (fused_qp.cu) and the whole-iteration kernel (fused_ipm.cu).
//
// Each function runs on one thread block and works on one lane (one QP):
// every pointer is already offset to that lane. What the lane's stage loops
// read lives in shared memory:
//   * the stage inputs (A_k, B_k, req_k, ...) come through rings in shared
//     memory that `cp.async` fills ahead of the stage that reads them (two
//     stages ahead in the factorization, three in the sweeps), so no load
//     from device memory sits inside the dependency chain;
//   * the lane's own sequences (P_{k+1}, K, kff, p_{k+1}, dX, ...) stay in
//     shared memory when they fit (`Out::c`), so the sweeps never read back
//     from device memory what the block wrote; the device-memory copies
//     (`Out::g`) that are part of a kernel's contract are written beside;
//   * the nu x nu gain system is formed and inverted in registers by every
//     thread that needs it (the results are bit-identical across threads),
//     so no phase runs on one thread while the block waits.
// The sweeps, a chain of nx-wide dot products, run on one warp: lane i holds
// the i-th entry of the state and shuffles hand it to the others. The
// factorization's stage spreads over the whole block with four barriers.
// Widths are compile-time for each supported model's (NXC, NUC) and runtime
// (0) for the general path (`RNM_BY_WIDTH`).
//
// The pointers carry no __restrict__: a kernel hands in sequences that it
// wrote itself a moment earlier, which the read-only data path must not
// serve stale.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace rnm {

constexpr int MAXNX = 32;
constexpr int MAXNU = 4;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// The widths compiled as their own instantiations: (nx, nu) of each of the
// system's models, the rocket (17, 4), the quadrotor (13, 4) and the
// pendulum (4, 1). Any other nx <= MAXNX, nu <= MAXNU takes the general
// path (runtime widths, 0). Returns `KERNEL<T, NXC, NUC>` for the lane's
// widths, in a function body:
#define RNM_BY_WIDTH(KERNEL, T, nx, nu)                \
  if ((nx) == 17 && (nu) == 4) return KERNEL<T, 17, 4>; \
  if ((nx) == 13 && (nu) == 4) return KERNEL<T, 13, 4>; \
  if ((nx) == 4 && (nu) == 1) return KERNEL<T, 4, 1>;   \
  return KERNEL<T, 0, 0>

// Resident blocks per SM the one-block-per-lane kernels (up to 256 threads)
// are compiled for, which sets their register budget: at a model's widths
// (NXC > 0) four keep B = 512 lanes in one wave on 132 SMs in float32 (at
// most 64 registers a thread), float64 is held to two; the general path
// (NXC = 0), whose width-32 arrays live on the stack, takes half as many.
template <typename T, int NXC>
struct Residency {
  static constexpr int blocks = (sizeof(T) == 4 ? 4 : 2) / (NXC > 0 ? 1 : 2);
};

__host__ __device__ __forceinline__ int tri_index(int u, int v, int nu) {
  // upper-triangle (u <= v) position in the row-major `_tri(nu)` order
  return u * nu - (u * (u - 1)) / 2 + (v - u);
}

// Inverse of a symmetric positive-definite n x n matrix (row-major, leading
// dimension ldh, upper triangle read) by recursive 2-block Schur
// elimination; `out` receives the full symmetric inverse. Inlined, so that
// at a compile-time n the blocks stay in registers.
template <typename T, int n>
__device__ __forceinline__ void spd_inv(const T* H, int ldh, T* out, int ldo) {
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

// spd_inv at a runtime nu: one call, not four inlined copies.
template <typename T>
__device__ __noinline__ void spd_inv_dispatch(const T* H, T* out, int nu) {
  switch (nu) {
    case 1: spd_inv<T, 1>(H, nu, out, nu); break;
    case 2: spd_inv<T, 2>(H, nu, out, nu); break;
    case 3: spd_inv<T, 3>(H, nu, out, nu); break;
    default: spd_inv<T, 4>(H, nu, out, nu); break;
  }
}

// Hc = sym(Fuu) + 1e-14 tr(Fuu) I and its inverse Fiv, in the calling
// thread's registers (row-major, leading dimension nu).
template <typename T, int NUC>
__device__ __forceinline__ void gain_system(const T* Fuu, T* Hc, T* Fiv, int nu_) {
  const int nu = NUC > 0 ? NUC : nu_;
  T tr = T(0);
#pragma unroll
  for (int u = 0; u < (NUC > 0 ? NUC : MAXNU); ++u)
    if (u < nu) tr += Fuu[u * nu + u];
#pragma unroll
  for (int u = 0; u < (NUC > 0 ? NUC : MAXNU); ++u)
#pragma unroll
    for (int v = 0; v < (NUC > 0 ? NUC : MAXNU); ++v)
      if (u < nu && v < nu) {
        T h = T(0.5) * (Fuu[u * nu + v] + Fuu[v * nu + u]);
        if (u == v) h += T(1e-14) * tr;
        Hc[u * nu + v] = h;
      }
  if constexpr (NUC > 0)
    spd_inv<T, NUC>(Hc, NUC, Fiv, NUC);
  else
    spd_inv_dispatch<T>(Hc, Fiv, nu);
}

// Hc and Fiv from their cached upper triangles, in registers.
template <typename T, int NUC>
__device__ __forceinline__ void unpack_tri(const T* Fuu_t, const T* Fiv_t, T* Hc, T* Fiv,
                                           int nu_) {
  const int nu = NUC > 0 ? NUC : nu_;
#pragma unroll
  for (int u = 0; u < (NUC > 0 ? NUC : MAXNU); ++u)
#pragma unroll
    for (int v = 0; v < (NUC > 0 ? NUC : MAXNU); ++v)
      if (u <= v && v < nu) {
        const int t = tri_index(u, v, nu);
        Hc[u * nu + v] = Hc[v * nu + u] = Fuu_t[t];
        Fiv[u * nu + v] = Fiv[v * nu + u] = Fiv_t[t];
      }
}

// x = -(Hc^{-1} rhs) from the explicit inverse plus one refinement pass.
template <typename T, int NUC>
__device__ __forceinline__ void neg_refined_solve(const T* Hc, const T* Fiv, const T* rhs,
                                                  T* x, int nu_) {
  const int nu = NUC > 0 ? NUC : nu_;
  constexpr int U = NUC > 0 ? NUC : MAXNU;
  T x0[U], r[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < nu) {
      T s = T(0);
#pragma unroll
      for (int v = 0; v < U; ++v)
        if (v < nu) s += Fiv[u * nu + v] * rhs[v];
      x0[u] = s;
    }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < nu) {
      T s = rhs[u];
#pragma unroll
      for (int v = 0; v < U; ++v)
        if (v < nu) s -= Hc[u * nu + v] * x0[v];
      r[u] = s;
    }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (u < nu) {
      T s = x0[u];
#pragma unroll
      for (int v = 0; v < U; ++v)
        if (v < nu) s += Fiv[u * nu + v] * r[v];
      x[u] = -s;
    }
}

// ---- asynchronous copies from device to shared memory --------------------
// One element per `cp.async` (4 bytes in float32, 8 in float64): a stage of
// A is nx^2 words, so stage offsets are not 16-byte aligned in general.
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// wait until at most `n` of this thread's newest groups are pending
template <int n>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
#endif
}

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, int n, int lane, int nthr) {
  for (int i = lane; i < n; i += nthr) cp_async_elem(dst + i, src + i);
}

// ---- 16-byte shared-memory rows, for the warp-per-column kernels ---------
// A row of n <= NL values that starts 16-byte aligned is read (written) as
// ceil(n / V) vector accesses of V = 16 / sizeof(T) values: one shared load
// instruction then feeds V multiply-adds of every lane. Storage past n up
// to the next multiple of V is padding: loads read it and drop it, stores
// write it.
template <typename T>
struct V16;
template <>
struct V16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static __forceinline__ float get(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
  }
  __device__ static __forceinline__ float4 make(const float* e) {
    return make_float4(e[0], e[1], e[2], e[3]);
  }
};
template <>
struct V16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static __forceinline__ double get(const double2& v, int i) {
    return i == 0 ? v.x : v.y;
  }
  __device__ static __forceinline__ double2 make(const double* e) {
    return make_double2(e[0], e[1]);
  }
};

// out[0..n) = p[0..n): NL is the compile-time bound of the register array,
// n the runtime width (n == NL folds the guards away)
template <typename T, int NL>
__device__ __forceinline__ void load_row(const T* p, T* out, int n) {
  using V = V16<T>;
#pragma unroll
  for (int q = 0; q < (NL + V::n - 1) / V::n; ++q)
    if (q * V::n < n) {
      const typename V::type v = reinterpret_cast<const typename V::type*>(p)[q];
#pragma unroll
      for (int t = 0; t < V::n; ++t)
        if (q * V::n + t < NL) out[q * V::n + t] = V::get(v, t);
    }
}

// p[0..n) = in[0..n); the padding up to the vector's end is written as 0
template <typename T, int NL>
__device__ __forceinline__ void store_row(T* p, const T* in, int n) {
  using V = V16<T>;
#pragma unroll
  for (int q = 0; q < (NL + V::n - 1) / V::n; ++q)
    if (q * V::n < n) {
      T e[V::n];
#pragma unroll
      for (int t = 0; t < V::n; ++t)
        e[t] = (q * V::n + t < NL && q * V::n + t < n) ? in[q * V::n + t] : T(0);
      reinterpret_cast<typename V::type*>(p)[q] = V::make(e);
    }
}

// a row width rounded up to a whole number of 16-byte vectors of either type
__host__ __device__ __forceinline__ int pad4(int n) { return (n + 3) & ~3; }

// ---- per-stage sequences -------------------------------------------------

// A per-stage input: stage k is `n` words at p + k n. `slot` >= 0: it is
// copied into that offset of a ring slot ahead of its stage; -1: it is read
// in place (it already lies in shared memory, or it is a fallback in device
// memory).
template <typename T>
struct Seq {
  const T* p;
  int n;
  int slot;
  __device__ __forceinline__ const T* at(int k, const T* ring_slot) const {
    return slot < 0 ? p + (size_t)k * n : ring_slot + slot;
  }
  __device__ __forceinline__ void fetch(int k, T* ring_slot, int lane, int nthr) const {
    if (slot >= 0) copy_async(ring_slot + slot, p + (size_t)k * n, n, lane, nthr);
  }
};

// A per-stage output: `g` in device memory (n words a stage, or null where
// no one reads it), `c` its copy that the block reads back (stride cs: n
// keeps the whole sequence, 0 one slot reused by every stage). Where the
// sequence does not fit in shared memory, c = g and cs = n.
template <typename T>
struct Out {
  T* g;
  T* c;
  int n;
  int cs;
  __device__ __forceinline__ T* chip(int k) const { return c + (size_t)k * cs; }
  __device__ __forceinline__ void put(int k, int i, T v) const {
    c[(size_t)k * cs + i] = v;
    if (g != nullptr && g != c) g[(size_t)k * n + i] = v;
  }
};

// Shared-memory carving, on the host (base = null: sizes only) and the device.
struct Carve {
  size_t words = 0;
  template <typename T>
  __host__ __device__ __forceinline__ T* take(T* base, size_t n) {
    T* p = base ? base + words : nullptr;
    words += n;
    return p;
  }
};

// ---- the forward sweep ---------------------------------------------------

// The sweeps' rings: SWEEP_SLOTS slots of `stride` words from `base`; a
// sweep fetches SWEEP_SLOTS - 1 stages ahead of the stage it computes, since
// one of its stages is far shorter than a fetch's latency.
constexpr int SWEEP_SLOTS = 4;

template <typename T>
struct SweepRing {
  T* base;
  int stride;
  __device__ __forceinline__ T* slot(int k) const { return base + (k % SWEEP_SLOTS) * stride; }
};

template <typename T>
struct ForwardIn {
  Seq<T> A, B, req, K;  // the ring slot holds A_k, B_k, req_k (and K_k where it is copied)
  const T* kff;         // (N, nu), on chip
  const T* Pseq;        // (N, nx, nx), read by the dnu pass only
  const T* pn;          // (N, nx), on chip
};

// Forward sweep on warp 0: du = K dx + kff, dx+ = A dx + B du + req, with the
// stage inputs three stages ahead in `ring`; then the whole block:
// dnu_k = -(P_{k+1} dx_{k+1} + p_{k+1}), off the chain. dX, dU and dnu go to
// their outputs (stride: a stage). Ends with a barrier.
template <typename T, int NXC, int NUC>
__device__ void forward_sweep(const ForwardIn<T>& in, const Out<T>& dX, const Out<T>& dU,
                              const Out<T>& dnu, const SweepRing<T>& ring, int N, int nx_,
                              int nu_) {
  const int nx = NXC > 0 ? NXC : nx_;
  const int nu = NUC > 0 ? NUC : nu_;
  constexpr int U = NUC > 0 ? NUC : MAXNU;
  const int tid = threadIdx.x;
  if (tid < 32) {
    const int lane = tid;
    auto fetch = [&](int k) {
      if (k < N) {
        T* slot = ring.slot(k);
        in.A.fetch(k, slot, lane, 32);
        in.B.fetch(k, slot, lane, 32);
        in.req.fetch(k, slot, lane, 32);
        in.K.fetch(k, slot, lane, 32);
      }
      cp_async_commit();
    };
    for (int k = 0; k < SWEEP_SLOTS - 1; ++k) fetch(k);
    // lane i < nx holds dx_i; dx_j reaches every lane by a shuffle
    const int li = lane < nx ? lane : 0;
    T x = T(0);
    for (int k = 0; k < N; ++k) {
      fetch(k + SWEEP_SLOTS - 1);
      cp_async_wait<SWEEP_SLOTS - 1>();
      __syncwarp();
      const T* slot = ring.slot(k);
      const T* Ak = in.A.at(k, slot) + li * nx;
      const T* Bk = in.B.at(k, slot) + li * nu;
      const T* Kk = in.K.at(k, slot);
      const T* kk = in.kff + k * nu;
      T du[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nu) du[u] = kk[u];
      T s = T(0);
#pragma unroll
      for (int j = 0; j < (NXC > 0 ? NXC : MAXNX); ++j)
        if (j < nx) {
          const T xj = __shfl_sync(0xffffffffu, x, j);
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (u < nu) du[u] += Kk[u * nx + j] * xj;
          s += Ak[j] * xj;
        }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nu) {
          if (lane == u) dU.put(k, u, du[u]);
          s += Bk[u] * du[u];
        }
      if (lane < nx) dX.put(k, lane, x);
      x = s + in.req.at(k, slot)[li];
      __syncwarp();
    }
    if (lane < nx) dX.put(N, lane, x);
  }
  __syncthreads();
  const T* Xc = dX.chip(0);
  for (int e = tid; e < N * nx; e += THREADS) {
    const int k = e / nx, i = e - k * nx;
    const T* Pk = in.Pseq + (size_t)k * nx * nx + i * nx;
    const T* xk = Xc + (size_t)(k + 1) * dX.cs;
    T s = T(0);
#pragma unroll
    for (int j = 0; j < (NXC > 0 ? NXC : MAXNX); ++j)
      if (j < nx) s += Pk[j] * xk[j];
    dnu.put(k, i, -(s + in.pn[k * nx + i]));
  }
  __syncthreads();
}

// ---- the corrector's feedforward sweep -----------------------------------

template <typename T>
struct FeedforwardIn {
  // ring-or-chip per stage: A, B, req, rbx, rbu, P_{k+1}, Fxu', the Fuu and
  // inverse triangles
  Seq<T> A, B, req, rbx, rbu, Pseq, FxuT, Fuu_t, Fiv_t;
  const T* rbxN;
};

// The feedforward sweep against cached factors on warp 0 (reverse stages,
// the stage inputs three stages ahead in `ring`):
// w = p + P_{k+1} req, f_u = rbu + B'w, kff = -Hc^{-1} f_u (refined),
// p = rbx + A'w + Fxu kff, with p_i and w_i held by lane i. Writes kff and
// pn.
template <typename T, int NXC, int NUC>
__device__ void feedforward_sweep(const FeedforwardIn<T>& in, const Out<T>& kff,
                                  const Out<T>& pn, const SweepRing<T>& ring, int N, int nx_,
                                  int nu_) {
  const int nx = NXC > 0 ? NXC : nx_;
  const int nu = NUC > 0 ? NUC : nu_;
  constexpr int U = NUC > 0 ? NUC : MAXNU;
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  auto fetch = [&](int k) {
    if (k >= 0) {
      T* slot = ring.slot(k);
      in.A.fetch(k, slot, lane, 32);
      in.B.fetch(k, slot, lane, 32);
      in.req.fetch(k, slot, lane, 32);
      in.rbx.fetch(k, slot, lane, 32);
      in.rbu.fetch(k, slot, lane, 32);
      in.Pseq.fetch(k, slot, lane, 32);
      in.FxuT.fetch(k, slot, lane, 32);
      in.Fuu_t.fetch(k, slot, lane, 32);
      in.Fiv_t.fetch(k, slot, lane, 32);
    }
    cp_async_commit();
  };
  for (int k = N - 1; k > N - SWEEP_SLOTS; --k) fetch(k);
  // lane i < nx holds p_i and w_i; w_l reaches every lane by a shuffle
  const int li = lane < nx ? lane : 0;
  T p = in.rbxN[li];
  for (int k = N - 1; k >= 0; --k) {
    __syncwarp();
    fetch(k - (SWEEP_SLOTS - 1));
    cp_async_wait<SWEEP_SLOTS - 1>();
    __syncwarp();
    const T* slot = ring.slot(k);
    const T* Pk = in.Pseq.at(k, slot) + li * nx;
    const T* rk = in.req.at(k, slot);
    const T* Ak = in.A.at(k, slot);
    const T* Bk = in.B.at(k, slot);
    if (lane < nx) pn.put(k, lane, p);
    T s = T(0);
#pragma unroll
    for (int l = 0; l < (NXC > 0 ? NXC : MAXNX); ++l)
      if (l < nx) s += Pk[l] * rk[l];
    const T w = p + s;
    T fu[U], Hc[U * U], Fiv[U * U], x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) fu[u] = T(0);
    T pa = T(0);
#pragma unroll
    for (int l = 0; l < (NXC > 0 ? NXC : MAXNX); ++l)
      if (l < nx) {
        const T wl = __shfl_sync(0xffffffffu, w, l);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (u < nu) fu[u] += Bk[l * nu + u] * wl;
        pa += Ak[l * nx + li] * wl;
      }
    const T* rbu = in.rbu.at(k, slot);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < nu) fu[u] = rbu[u] + fu[u];
    unpack_tri<T, NUC>(in.Fuu_t.at(k, slot), in.Fiv_t.at(k, slot), Hc, Fiv, nu);
    neg_refined_solve<T, NUC>(Hc, Fiv, fu, x, nu);
    const T* FxuT = in.FxuT.at(k, slot);
    T q = in.rbx.at(k, slot)[li] + pa;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < nu) {
        if (lane == u) kff.put(k, u, x[u]);
        q += FxuT[u * nx + li] * x[u];
      }
    p = q;
  }
  __syncwarp();
}

// ---- the factorization ---------------------------------------------------

template <typename T>
struct FactorIn {
  Seq<T> A, B, req, rbx, rbu;  // stage inputs (ring, or in place)
  Seq<T> Cxx, Cxu, Cuu;        // the stage's curvature (ring)
};

template <typename T>
struct FactorOut {
  // P_{k+1} and p_{k+1} (stage k reads its P and p from here, so these keep
  // the whole sequence), K, Fxu', the triangles, kff
  Out<T> P, p, K, FxuT, Fuu_t, Fiv_t, kff;
};

// the stage's working blocks in shared memory
template <typename T>
struct FactorWork {
  T *PA, *Fxx, *PB, *Fuu, *w, *pnew, *fu;
};

// Riccati factorization fused with the predictor's feedforward sweep, in a
// reverse stage loop over the block. Per stage, four barriers:
//   2: PA = P A, PB = P B, w = p + P req
//   3: Fxx = Cxx + A'PA, Fxu' = Cxu' + B'PA, Fuu = Cuu + B'PB,
//      f_u = rbu + B'w, pnew = rbx + A'w
//   5: threads 0..nx form Hc = sym(Fuu) + 1e-14 tr(Fuu) I and its inverse in
//      registers and solve K = -Hc^{-1} Fxu' (one column each) and kff;
//      the warps without such a thread fetch stage k-2's inputs into the
//      ring slot that stage k has done with
//   6: P = sym(Fxx + Fxu K), p = pnew + Fxu kff
// A fetch has the phases from its stage k+2's phase 5 to stage k+1's phase
// 3 to land (waited for at the end of phase 3). The caller puts P_N and p_N
// (stage N-1's P and p) before the call. Ends with a barrier.
template <typename T, int NXC, int NUC>
__device__ void factor_lane(const FactorIn<T>& in, const FactorOut<T>& out,
                            const FactorWork<T>& wk, T* const* ring, int N, int nx_, int nu_) {
  const int nx = NXC > 0 ? NXC : nx_;
  const int nu = NUC > 0 ? NUC : nu_;
  constexpr int U = NUC > 0 ? NUC : MAXNU;
  constexpr int NXL = NXC > 0 ? NXC : MAXNX;
  const int tid = threadIdx.x;
  const int nxx = nx * nx, nxu = nx * nu;
  const int w0 = 32 * ((nx + 32) / 32);  // the first thread of a warp with no gain thread
  // the stage inputs of stage k into ring slot k % 2, by threads t0,
  // t0 + nthr, ...
  auto fetch = [&](int k, int t0, int nthr) {
    T* slot = ring[k & 1];
    in.A.fetch(k, slot, t0, nthr);
    in.B.fetch(k, slot, t0, nthr);
    in.req.fetch(k, slot, t0, nthr);
    in.rbx.fetch(k, slot, t0, nthr);
    in.rbu.fetch(k, slot, t0, nthr);
    in.Cxx.fetch(k, slot, t0, nthr);
    in.Cxu.fetch(k, slot, t0, nthr);
    in.Cuu.fetch(k, slot, t0, nthr);
  };
  fetch(N - 1, tid, THREADS);
  if (N >= 2) fetch(N - 2, tid, THREADS);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int k = N - 1; k >= 0; --k) {
    const T* slot = ring[k & 1];
    const T* Ak = in.A.at(k, slot);
    const T* Bk = in.B.at(k, slot);
    const T* P = out.P.chip(k);
    const T* p = out.p.chip(k);

    // 2: PA = P A, PB = P B, w = p + P req
    {
      const T* rk = in.req.at(k, slot);
      for (int e = tid; e < nxx + nxu + nx; e += THREADS) {
        if (e < nxx) {
          const int i = e / nx, j = e - i * nx;
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NXL; ++l)
            if (l < nx) s += P[i * nx + l] * Ak[l * nx + j];
          wk.PA[e] = s;
        } else if (e < nxx + nxu) {
          const int e2 = e - nxx, i = e2 / nu, j = e2 - i * nu;
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NXL; ++l)
            if (l < nx) s += P[i * nx + l] * Bk[l * nu + j];
          wk.PB[e2] = s;
        } else {
          const int i = e - nxx - nxu;
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NXL; ++l)
            if (l < nx) s += P[i * nx + l] * rk[l];
          wk.w[i] = p[i] + s;
        }
      }
    }
    __syncthreads();

    // 3: Fxx, Fxu', Fuu, f_u, pnew
    {
      const T* Cxx = in.Cxx.at(k, slot);
      const T* Cxu = in.Cxu.at(k, slot);
      const T* Cuu = in.Cuu.at(k, slot);
      const T* rbx = in.rbx.at(k, slot);
      const T* rbu = in.rbu.at(k, slot);
      const int n3 = nxx + nxu + nu * nu + nu + nx;
      for (int e = tid; e < n3; e += THREADS) {
        if (e < nxx) {
          const int i = e / nx, j = e - i * nx;
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NXL; ++l)
            if (l < nx) s += Ak[l * nx + i] * wk.PA[l * nx + j];
          wk.Fxx[e] = Cxx[e] + s;
        } else if (e < nxx + nxu) {
          const int e2 = e - nxx, u = e2 / nx, j = e2 - u * nx;
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NXL; ++l)
            if (l < nx) s += Bk[l * nu + u] * wk.PA[l * nx + j];
          s += Cxu[j * nu + u];
          out.FxuT.put(k, e2, s);
        } else if (e < nxx + nxu + nu * nu) {
          const int e2 = e - nxx - nxu, u = e2 / nu, v = e2 - u * nu;
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NXL; ++l)
            if (l < nx) s += Bk[l * nu + u] * wk.PB[l * nu + v];
          wk.Fuu[e2] = Cuu[e2] + s;
        } else if (e < nxx + nxu + nu * nu + nu) {
          const int u = e - nxx - nxu - nu * nu;
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NXL; ++l)
            if (l < nx) s += Bk[l * nu + u] * wk.w[l];
          wk.fu[u] = rbu[u] + s;
        } else {
          const int i = e - nxx - nxu - nu * nu - nu;
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NXL; ++l)
            if (l < nx) s += Ak[l * nx + i] * wk.w[l];
          wk.pnew[i] = rbx[i] + s;
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // 5: the gain system in registers, K = -Hc^{-1} Fxu' and kff; the
    //    other warps fetch ahead
    const T* FxuT = out.FxuT.chip(k);
    if (tid <= nx) {
      T Hc[U * U], Fiv[U * U], rhs[U], x[U];
      gain_system<T, NUC>(wk.Fuu, Hc, Fiv, nu);
      if (tid == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int v = 0; v < U; ++v)
            if (u <= v && v < nu) {
              out.Fuu_t.put(k, tri_index(u, v, nu), Hc[u * nu + v]);
              out.Fiv_t.put(k, tri_index(u, v, nu), Fiv[u * nu + v]);
            }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nu) rhs[u] = (tid < nx) ? FxuT[u * nx + tid] : wk.fu[u];
      neg_refined_solve<T, NUC>(Hc, Fiv, rhs, x, nu);
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (u < nu) {
          if (tid < nx)
            out.K.put(k, u * nx + tid, x[u]);
          else
            out.kff.put(k, u, x[u]);
        }
    } else if (tid >= w0 && k >= 2) {
      // the warps with no gain thread: stage k's ring slot is free (phase 3
      // was its last reader), so stage k-2's inputs go there, two stages
      // ahead
      fetch(k - 2, tid - w0, THREADS - w0);
    }
    cp_async_commit();
    __syncthreads();

    // 6: P = sym(Fxx + Fxu K), p = pnew + Fxu kff (stage k-1's P and p)
    if (k >= 1) {
      const T* Ks = out.K.chip(k);
      const T* kff = out.kff.chip(k);
      for (int e = tid; e < nxx + nx; e += THREADS) {
        if (e < nxx) {
          const int i = e / nx, j = e - i * nx;
          T mij = wk.Fxx[i * nx + j], mji = wk.Fxx[j * nx + i];
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (u < nu) {
              mij += FxuT[u * nx + i] * Ks[u * nx + j];
              mji += FxuT[u * nx + j] * Ks[u * nx + i];
            }
          out.P.put(k - 1, e, T(0.5) * (mij + mji));
        } else {
          const int i = e - nxx;
          T s = wk.pnew[i];
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (u < nu) s += FxuT[u * nx + i] * kff[u];
          out.p.put(k - 1, i, s);
        }
      }
    }
    __syncthreads();
  }
}

// Out helpers: the whole sequence on chip where `c` is given, else in place
// in device memory; one reused on-chip slot; device memory only.
template <typename T>
__device__ __forceinline__ Out<T> seq_out(T* g, T* c, int n) {
  return c ? Out<T>{g, c, n, n} : Out<T>{g, g, n, n};
}
template <typename T>
__device__ __forceinline__ Out<T> slot_out(T* g, T* c, int n) {
  return Out<T>{g, c, n, 0};
}
template <typename T>
__device__ __forceinline__ Out<T> dev_out(T* g, int n) {
  return Out<T>{g, g, n, n};
}

inline bool dims_ok(int Bsz, int N, int nx, int nu) {
  return Bsz >= 1 && N >= 1 && nx >= 1 && nx <= MAXNX && nu >= 1 && nu <= MAXNU;
}

// Largest dynamic shared memory a block may ask for on the card.
constexpr size_t MAX_SMEM = 227 * 1024;

}  // namespace rnm

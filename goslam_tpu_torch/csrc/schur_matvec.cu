// K3: one matvec of the reduced camera system for the PCG solver,
// y = (A - E Q E^T) x, damping excluded.
//
// Replaces the TPU kernel goslam_tpu/ops/pallas_kernels.py :: schur_matvec
// (body _schur_matvec_kernel).  Plain version:
// goslam_tpu_torch/ops/dba.py :: schur_matvec_plain.
//
// Edges are sorted by source frame; rowptr [P+1] holds each frame's run
// (CSR), and edges at or past rowptr[P] are invalid and never visited.
// With x_i = x[k] for the edges of frame k and x_j = x[jj[e]]:
//   u     = Q[k] * (Ei[k]^T x_i + sum_e Eij[e]^T x_j)          [hw]
//   yf[k] = -Ei[k] u + sum_e (H[e][:6,:6] x_i + H[e][:6,6:] x_j)
//   oc[e] = H[e][6:,:6] x_i + H[e][6:,6:] x_j - Eij[e] u
// The caller adds oc[e] to row jj[e] of yf.  Eij travels as bf16 and is
// summed in fp32, as in the TPU kernel; everything else is fp32.
//
// What bounds it on an H100: bytes, and few of them.  One matvec reads Ei
// (24 B per frame pixel), Q (4 B), Eij (12 B per edge pixel) and H (576 B
// per edge) once: a few MB at 192 frames and 1024 edges, all resident in
// the 50 MB L2 from one CG iteration to the next, so the launch and the
// two dependent passes set the time, not bandwidth.
//
// Design: one thread block per source frame, which needs nothing from any
// other block.  Pass 1: each thread owns the pixels p = tid, tid + 256, ...
// and accumulates u[p] in shared memory over the frame's edges (no
// synchronisation inside the pass: a thread touches only its own
// pixels).  Pass 2: each warp takes whole work items (one per edge, plus
// one for the frame's own row), strides over the pixels, and finishes the
// six sums with warp shuffles; lanes 0-5 then add the 12x12 pose-Hessian
// product and store.  No atomics anywhere, so a launch gives the same
// bits every time, and a frame's degree needs no capacity.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// row a of a 12x12 block times [xi | xj]
__device__ __forceinline__ float row12(const float* Hrow, const float* xi,
                                       const float* xj) {
  float s = 0.f;
#pragma unroll
  for (int b = 0; b < 6; ++b) s += Hrow[b] * xi[b];
#pragma unroll
  for (int b = 0; b < 6; ++b) s += Hrow[6 + b] * xj[b];
  return s;
}

__device__ __forceinline__ float pick6(const float* r, int a) {
  float s = r[0];
#pragma unroll
  for (int b = 1; b < 6; ++b) s = (a == b) ? r[b] : s;
  return s;
}

__global__ void __launch_bounds__(NTHREADS)
schur_matvec_kernel(const float* __restrict__ x,        // [P, 6]
                    const float* __restrict__ Ei,       // [P, 6, hw]
                    const float* __restrict__ Q,        // [P, hw]
                    const float* __restrict__ H,        // [E, 12, 12]
                    const __nv_bfloat16* __restrict__ Eij,  // [E, 6, hw]
                    const int* __restrict__ jj,         // [E]
                    const int* __restrict__ rowptr,     // [P + 1]
                    int P, int E, int hw,
                    float* __restrict__ yf,             // [P, 6]
                    float* __restrict__ oc) {           // [E, 6]
  extern __shared__ float u[];                          // [hw]
  const int k = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int e0 = rowptr[k], e1 = rowptr[k + 1];

  // rows of invalid edges (sorted past the end) are zero for the caller's
  // scatter-add
  for (int e = rowptr[P] + k * NTHREADS + tid; e < E; e += P * NTHREADS) {
#pragma unroll
    for (int a = 0; a < 6; ++a) oc[(size_t)e * 6 + a] = 0.f;
  }

  float xi[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) xi[a] = x[k * 6 + a];

  // ---- pass 1: u = Q (Ei^T x_i + sum_e Eij^T x_j) -----------------------
  const float* Ek = Ei + (size_t)k * 6 * hw;
  for (int p = tid; p < hw; p += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int a = 0; a < 6; ++a) s += Ek[(size_t)a * hw + p] * xi[a];
    u[p] = s;
  }
  for (int e = e0; e < e1; ++e) {
    const int j = jj[e];
    float xj[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) xj[a] = x[j * 6 + a];
    const __nv_bfloat16* Ge = Eij + (size_t)e * 6 * hw;
    for (int p = tid; p < hw; p += NTHREADS) {
      float s = 0.f;
#pragma unroll
      for (int a = 0; a < 6; ++a)
        s += __bfloat162float(Ge[(size_t)a * hw + p]) * xj[a];
      u[p] += s;
    }
  }
  for (int p = tid; p < hw; p += NTHREADS) u[p] *= Q[(size_t)k * hw + p];
  __syncthreads();

  // ---- pass 2: one work item per edge, and one for the frame ------------
  const int n = e1 - e0;
  for (int item = warp; item <= n; item += NWARPS) {
    float r[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (item < n) {
      const int e = e0 + item;
      const __nv_bfloat16* Ge = Eij + (size_t)e * 6 * hw;
      for (int p = lane; p < hw; p += 32) {
        const float up = u[p];
#pragma unroll
        for (int a = 0; a < 6; ++a)
          r[a] += __bfloat162float(Ge[(size_t)a * hw + p]) * up;
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) r[a] = warp_sum(r[a]);
      if (lane < 6) {
        const int j = jj[e];
        float xj[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) xj[a] = x[j * 6 + a];
        const float hv = row12(H + (size_t)e * 144 + (6 + lane) * 12, xi, xj);
        oc[(size_t)e * 6 + lane] = hv - pick6(r, lane);
      }
    } else {
      for (int p = lane; p < hw; p += 32) {
        const float up = u[p];
#pragma unroll
        for (int a = 0; a < 6; ++a) r[a] += Ek[(size_t)a * hw + p] * up;
      }
      // the pose-Hessian rows of frame k: lanes stride over its edges
      float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int e = e0 + lane; e < e1; e += 32) {
        const int j = jj[e];
        float xj[6];
#pragma unroll
        for (int a = 0; a < 6; ++a) xj[a] = x[j * 6 + a];
#pragma unroll
        for (int a = 0; a < 6; ++a)
          s[a] += row12(H + (size_t)e * 144 + a * 12, xi, xj);
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) r[a] = warp_sum(s[a] - r[a]);
      if (lane < 6) yf[k * 6 + lane] = pick6(r, lane);
    }
  }
}

extern "C" int schur_matvec_launch(const float* x, const float* Ei,
                                   const float* Q, const float* H,
                                   const void* Eij, const int* jj,
                                   const int* rowptr, int P, int E, int hw,
                                   float* yf, float* oc, void* stream) {
  if (P <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)hw * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        schur_matvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  schur_matvec_kernel<<<P, NTHREADS, smem, (cudaStream_t)stream>>>(
      x, Ei, Q, H, reinterpret_cast<const __nv_bfloat16*>(Eij), jj, rowptr,
      P, E, hw, yf, oc);
  return (int)cudaGetLastError();
}

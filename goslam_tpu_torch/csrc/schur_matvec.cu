// K3: one matvec of the reduced camera system for the PCG solver,
// y = (A - E Q E^T) x, damping excluded, in one launch.
//
// Replaces the TPU kernel goslam_tpu/ops/pallas_kernels.py :: schur_matvec
// (body _schur_matvec_kernel).  Plain version:
// goslam_tpu_torch/ops/dba.py :: schur_matvec_plain.
//
// Edges are sorted by source frame; rowptr [P+1] holds each frame's run
// (CSR), and edges at or past rowptr[P] are invalid and never visited.
// colptr [P+1] and cidx list the valid edges again by target frame (CSC,
// stable): the edges into frame j are cidx[colptr[j] .. colptr[j+1]).
// With x_i = x[k] for the edges of frame k and x_j = x[jj[e]]:
//   u     = Q[k] * (Ei[k]^T x_i + sum_e Eij[e]^T x_j)          [hw]
//   yf[k] = -Ei[k] u + sum_e (H[e][:6,:6] x_i + H[e][:6,6:] x_j)
//   oc[e] = H[e][6:,:6] x_i + H[e][6:,6:] x_j - Eij[e] u
//   y[j]  = yf[j] + sum over the edges e into j of oc[e]
// Eij travels as bf16 and is summed in fp32, as in the TPU kernel;
// everything else is fp32.
//
// What bounds it on an H100: by its bytes (Ei, 24 B per frame pixel; Q,
// 4 B; Eij, 12 B per edge pixel; H, 576 B per edge: a few MB at 192
// frames, read once) about 1 us; in fact latency sets the time: the
// launch of a cooperative kernel, the grid-wide barrier, and a chain of
// dependent steps (row offsets, then the frame's rows and edge indices,
// then the two pixel passes with a block barrier between, then the
// scatter).
//
// Design: one launch for the whole matvec, scatter to jj included, so
// that a PCG iteration launches one kernel where it launched a kernel, an
// index_add_ and two allocations.  A cooperative launch of at most one
// wave of blocks (sized from an occupancy query; the runtime refuses a
// grid that does not fit), each block walking source frames k = blockIdx.x,
// +grid.  Phase A, per frame: the frame's Q row is copied to shared memory
// with cp.async during pass 1; pass 1 spreads the (pixel group of 8, work
// item) pairs of the frame over the block's threads, each loading 8 pixels
// of a row at once (16 bytes of Eij, two float4 of Ei), keeps one partial u
// per slot in shared memory and sums the slots in a fixed order; pass 2
// gives each warp whole items (an edge, or the frame's own row), reduces
// over the pixels with shuffles, and lanes 0-5 subtract the sums from the
// 12x12 pose-Hessian products and store, with no block barrier.  A
// grid-wide barrier; then phase B: each (frame j, row) adds the oc rows of
// the edges into j in CSC order to yf[j].  No atomics in the arithmetic,
// so two launches give the same bits, and a frame's degree needs no
// capacity.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)

struct Args {
  const float* x;                 // [P, 6]
  const float* Ei;                // [P, 6, hw]
  const float* Q;                 // [P, hw]
  const float* H;                 // [E, 12, 12]
  const __nv_bfloat16* Eij;       // [E, 6, hw]
  const int* jj;                  // [E]
  const int* rowptr;              // [P + 1]
  const int* colptr;              // [P + 1]
  const int* cidx;                // [E], the first colptr[P] used
  int P, hw;
  int vec;                        // rows are 16-byte aligned (hw % 8 == 0)
  int nslot;                      // edge slots of pass 1
  float* yf;                      // [P, 6] scratch
  float* oc;                      // [E, 6] scratch
  float* y;                       // [P, 6] output
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// row of a 12x12 block times [xi | xj]
__device__ __forceinline__ float row12(const float* Hrow, const float* xi,
                                       const float* xj) {
  const float4* h4 = reinterpret_cast<const float4*>(Hrow);
  const float4 a = h4[0], b = h4[1], c = h4[2];
  return a.x * xi[0] + a.y * xi[1] + a.z * xi[2] + a.w * xi[3]
       + b.x * xi[4] + b.y * xi[5] + b.z * xj[0] + b.w * xj[1]
       + c.x * xj[2] + c.y * xj[3] + c.z * xj[4] + c.w * xj[5];
}

// 8 values of a row from pixel p on; past hw they read as zero
__device__ __forceinline__ void load8(const __nv_bfloat16* row, int p,
                                      int hw, bool vec, float* o) {
  if (vec) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      o[2 * k] = __uint_as_float(w[k] << 16);
      o[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = p + k < hw ? __bfloat162float(row[p + k]) : 0.f;
  }
}

__device__ __forceinline__ void load8(const float* row, int p, int hw,
                                      bool vec, float* o) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(row + p);
    const float4 b = *reinterpret_cast<const float4*>(row + p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = p + k < hw ? row[p + k] : 0.f;
  }
}

__device__ __forceinline__ void load_x(const float* x, int k, float* o) {
#pragma unroll
  for (int a = 0; a < 6; ++a) o[a] = x[k * 6 + a];
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

struct Shared {
  float* u;       // [hw8]
  float* q;       // [hw8]: the frame's Q row
  float* part;    // [nslot * hw]
};

__device__ void frame_rows(const Args& A, int k, const Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hw = A.hw;
  const bool vec = A.vec != 0;
  const int ng = (hw + 7) / 8;                 // pixel groups of 8
  const int e0 = A.rowptr[k], e1 = A.rowptr[k + 1], n = e1 - e0;
  const float* Ek = A.Ei + (size_t)k * 6 * hw;
  // the frame's Q row travels to shared memory during pass 1
  for (int p = tid; p < hw; p += NTHREADS)
    cp_async4(sh.q + p, A.Q + (size_t)k * hw + p);
  asm volatile("cp.async.commit_group;\n" ::);
  float xi[6];
  load_x(A.x, k, xi);

  // ---- pass 1: u = Q (Ei^T x_i + sum_e Eij^T x_j) -----------------------
  // work item 0 is the frame's own term, 1..n its edges; slot s takes the
  // items s, s + nslot, ...
  for (int w = tid; w < A.nslot * ng; w += NTHREADS) {
    const int s = w / ng, p = (w % ng) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int item = s; item <= n; item += A.nslot) {
      float xv[6], v[8];
      if (item == 0) {
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          load8(Ek + (size_t)a * hw, p, hw, vec, v);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[q] += v[q] * xi[a];
        }
      } else {
        const int e = e0 + item - 1;
        load_x(A.x, A.jj[e], xv);
        const __nv_bfloat16* Ge = A.Eij + (size_t)e * 6 * hw;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          load8(Ge + (size_t)a * hw, p, hw, vec, v);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[q] += v[q] * xv[a];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (p + q < hw) sh.part[s * hw + p + q] = acc[q];
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  for (int p = tid; p < hw; p += NTHREADS) {
    float su = 0.f;
    for (int sl = 0; sl < A.nslot; ++sl) su += sh.part[sl * hw + p];
    sh.u[p] = su * sh.q[p];
  }
  __syncthreads();

  // ---- pass 2: items 0..n-1 the edges, item n the frame's own row -------
  // one warp per item; lanes 0-5 write its six rows, subtracting the
  // pixel sums from the pose-Hessian products
  for (int item = warp; item <= n; item += NWARPS) {
    const bool own = item == n;
    float r[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int pg = lane; pg < ng; pg += 32) {
      const int p = pg * 8;
      float uv[8], v[8];
      load8(sh.u, p, hw, vec, uv);
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        if (own)
          load8(Ek + (size_t)a * hw, p, hw, vec, v);
        else
          load8(A.Eij + ((size_t)(e0 + item) * 6 + a) * hw, p, hw, vec, v);
#pragma unroll
        for (int q = 0; q < 8; ++q) r[a] += v[q] * uv[q];
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) r[a] = warp_sum(r[a]);
    if (lane < 6) {
      const int a = lane;
      float rs = r[0];
#pragma unroll
      for (int b = 1; b < 6; ++b) rs = a == b ? r[b] : rs;
      float xj[6];
      if (!own) {
        const int e = e0 + item;
        load_x(A.x, A.jj[e], xj);
        A.oc[(size_t)e * 6 + a] =
            row12(A.H + (size_t)e * 144 + (6 + a) * 12, xi, xj) - rs;
      } else {
        float sy = 0.f;
        for (int e = e0; e < e1; ++e) {
          load_x(A.x, A.jj[e], xj);
          sy += row12(A.H + (size_t)e * 144 + a * 12, xi, xj);
        }
        A.yf[k * 6 + a] = sy - rs;
      }
    }
  }
  __syncthreads();      // shared memory is reused by the block's next frame
}

__global__ void __launch_bounds__(NTHREADS, 2) schur_matvec_kernel(Args A) {
  extern __shared__ __align__(16) float smem[];
  const int hw8 = (A.hw + 7) / 8 * 8;
  Shared sh;
  sh.u = smem;
  sh.q = sh.u + hw8;
  sh.part = sh.q + hw8;

  for (int k = blockIdx.x; k < A.P; k += gridDim.x) frame_rows(A, k, sh);

  cg::this_grid().sync();

  // ---- phase B: y[j] = yf[j] + the oc rows of the edges into j ----------
  for (int t = blockIdx.x * NTHREADS + threadIdx.x; t < A.P * 6;
       t += gridDim.x * NTHREADS) {
    const int j = t / 6, a = t % 6;
    float s = A.yf[t];
    for (int c = A.colptr[j]; c < A.colptr[j + 1]; ++c)
      s += A.oc[(size_t)A.cidx[c] * 6 + a];
    A.y[t] = s;
  }
}

extern "C" int schur_matvec_launch(const float* x, const float* Ei,
                                   const float* Q, const float* H,
                                   const void* Eij, const int* jj,
                                   const int* rowptr, const int* colptr,
                                   const int* cidx, int P, int E, int hw,
                                   int vec, float* yf, float* oc, float* y,
                                   void* stream) {
  (void)E;
  if (P <= 0 || hw <= 0) return (int)cudaGetLastError();
  Args A;
  A.x = x; A.Ei = Ei; A.Q = Q; A.H = H;
  A.Eij = reinterpret_cast<const __nv_bfloat16*>(Eij);
  A.jj = jj; A.rowptr = rowptr; A.colptr = colptr; A.cidx = cidx;
  A.P = P; A.hw = hw; A.vec = vec;
  const int ng = (hw + 7) / 8;
  // as many edge slots as the block has threads for all pixel groups
  A.nslot = ng >= NTHREADS ? 1 : NTHREADS / ng;
  A.yf = yf; A.oc = oc; A.y = y;
  const int hw8 = ng * 8;
  size_t smem = (2 * (size_t)hw8 + (size_t)A.nslot * hw) * sizeof(float);

  // the grid must be resident at once for its barrier: one wave at most
  static int n_sm = 0;
  static size_t occ_smem = (size_t)-1;
  static int occ_blocks = 0;
  cudaError_t err;
  if (n_sm == 0) {
    int dev;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
      return (int)err;
  }
  if (smem != occ_smem) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(schur_matvec_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_blocks, schur_matvec_kernel, NTHREADS, smem);
    if (err != cudaSuccess) return (int)err;
    occ_smem = smem;
  }
  if (occ_blocks < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int grid = P < occ_blocks * n_sm ? P : occ_blocks * n_sm;
  void* params[] = {&A};
  err = cudaLaunchCooperativeKernel((const void*)schur_matvec_kernel, grid,
                                    NTHREADS, params, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

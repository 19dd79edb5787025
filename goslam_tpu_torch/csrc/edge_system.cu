// K1: per-edge linearization of the dense-BA reprojection objective.
//
// Replaces the TPU kernel goslam_tpu/ops/pallas_kernels.py ::
// build_edge_system_fused (body _edge_system_kernel).  Plain version:
// goslam_tpu_torch/ops/dba.py :: build_edge_system_plain.
//
// Per edge e = (i -> j) and per pixel p of frame i it warps the
// inverse-depth point through Gij (g[e, 0:7]; stereo edges carry the fixed
// baseline and g[e, 7] = 1), forms the residual against the flow target,
// the analytic pose-j Jacobian rows, the pose-i rows by dual-adjoint
// transport, and the disparity Jacobian.  Outputs:
//   H [E,12,12], v [E,12]   weighted Gram of [J_i | J_j] with the residual
//                           as the 13th row (pose blocks, stereo masked)
//   Eii, Eij [E,6,hw]       pose-depth couplings
//   Cii, bz [E,hw]          depth-depth diagonal and depth rhs
//
// What bounds it on an H100: bytes.  Per pixel it reads 20 B (disparity,
// target, weight) and writes 56 B (Eii, Eij, Cii, bz); the arithmetic is
// ~0.6 kFLOP per pixel of fp32, far below the card's fp32 rate per byte.
//
// Design: one thread block per edge, threads striding over the pixels so
// neighbouring threads touch neighbouring addresses.  Each thread writes
// its pixels' Eii/Eij/Cii/bz directly and keeps the 78 upper-triangular H
// entries and the 12 v entries in registers; the block then reduces them
// with warp shuffles and one pass through shared memory.  No atomics, so
// the result is the same run to run.
#include <cuda_runtime.h>
#include <stdint.h>

#define MIN_DEPTH 0.25f
#define WEIGHT_SCALE 0.001f
#define NTHREADS 128
#define NWARPS (NTHREADS / 32)
#define NH 78                 // upper triangle of the 12x12 pose block
#define NACC (NH + 12)        // ... plus the 12 rhs entries

__device__ __forceinline__ void rot(float qx, float qy, float qz, float qw,
                                    float vx, float vy, float vz,
                                    float& ox, float& oy, float& oz) {
  const float ux = 2.f * (qy * vz - qz * vy);
  const float uy = 2.f * (qz * vx - qx * vz);
  const float uz = 2.f * (qx * vy - qy * vx);
  ox = vx + qw * ux + (qy * uz - qz * uy);
  oy = vy + qw * uy + (qz * ux - qx * uz);
  oz = vz + qw * uz + (qx * uy - qy * ux);
}

// -Adj(G)^T J for one 6-row Jacobian (the pose-i rows): with q^-1 the
// inverse rotation, Y[:3] = R^T a, Y[3:] = R^T (b + a x t), negated.
__device__ __forceinline__ void neg_adjT(const float* J, float tx, float ty,
                                         float tz, float qx, float qy,
                                         float qz, float qw, float* Y) {
  const float c0 = J[1] * tz - J[2] * ty;
  const float c1 = J[2] * tx - J[0] * tz;
  const float c2 = J[0] * ty - J[1] * tx;
  float r0, r1, r2, s0, s1, s2;
  rot(-qx, -qy, -qz, qw, J[0], J[1], J[2], r0, r1, r2);
  rot(-qx, -qy, -qz, qw, J[3] + c0, J[4] + c1, J[5] + c2, s0, s1, s2);
  Y[0] = -r0; Y[1] = -r1; Y[2] = -r2;
  Y[3] = -s0; Y[4] = -s1; Y[5] = -s2;
}

__global__ void __launch_bounds__(NTHREADS)
edge_system_kernel(const float* __restrict__ d_i,
                   const float2* __restrict__ tgt,
                   const float2* __restrict__ wgt,
                   const float* __restrict__ g,
                   const float* __restrict__ intr, int hw, int wd,
                   float* __restrict__ H, float* __restrict__ v,
                   float* __restrict__ Eii, float* __restrict__ Eij,
                   float* __restrict__ Cii, float* __restrict__ bz) {
  const int e = blockIdx.x;
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  const float* ge = g + 8 * e;
  const float tx = ge[0], ty = ge[1], tz = ge[2];
  const float qx = ge[3], qy = ge[4], qz = ge[5], qw = ge[6];
  const float keep_pose = 1.f - ge[7];      // stereo edges: depth only

  float acc[NACC];
#pragma unroll
  for (int n = 0; n < NACC; ++n) acc[n] = 0.f;

  const size_t row = (size_t)e * hw;
  for (int p = threadIdx.x; p < hw; p += NTHREADS) {
    const float d = d_i[row + p];
    const float X = ((float)(p % wd) - cx) / fx;
    const float Y = ((float)(p / wd) - cy) / fy;
    float rx, ry, rz;
    rot(qx, qy, qz, qw, X, Y, 1.f, rx, ry, rz);
    const float x = rx + d * tx, y = ry + d * ty, z = rz + d * tz;
    const float h = d;

    const bool ok = z >= MIN_DEPTH;
    const float dd = ok ? 1.f / z : 0.f;
    const float d2 = dd * dd;

    const float2 w = wgt[row + p];
    const float2 t = tgt[row + p];
    const float wu = ok ? w.x * WEIGHT_SCALE : 0.f;
    const float wv = ok ? w.y * WEIGHT_SCALE : 0.f;
    const float ru = t.x - (fx * dd * x + cx);
    const float rv = t.y - (fy * dd * y + cy);

    // rows of [J_i | J_j | r] for the u and v residuals
    float Au[13], Av[13];
    Au[6] = fx * h * dd;
    Au[7] = 0.f;
    Au[8] = -fx * x * h * d2;
    Au[9] = -fx * x * y * d2;
    Au[10] = fx * (1.f + x * x * d2);
    Au[11] = -fx * y * dd;
    Av[6] = 0.f;
    Av[7] = fy * h * dd;
    Av[8] = -fy * y * h * d2;
    Av[9] = -fy * (1.f + y * y * d2);
    Av[10] = fy * x * y * d2;
    Av[11] = fy * x * dd;
    neg_adjT(Au + 6, tx, ty, tz, qx, qy, qz, qw, Au);
    neg_adjT(Av + 6, tx, ty, tz, qx, qy, qz, qw, Av);
    Au[12] = ru;
    Av[12] = rv;

    // disparity Jacobian; the depth blocks use the pre-stereo weights
    const float jzu = fx * (tx * dd - tz * (x * d2));
    const float jzv = fy * (ty * dd - tz * (y * d2));
    Cii[row + p] = wu * jzu * jzu + wv * jzv * jzv;
    bz[row + p] = wu * ru * jzu + wv * rv * jzv;

    const float wup = wu * keep_pose, wvp = wv * keep_pose;
    const float eu = wup * jzu, ev = wvp * jzv;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      Eii[(row * 6) + (size_t)k * hw + p] = eu * Au[k] + ev * Av[k];
      Eij[(row * 6) + (size_t)k * hw + p] = eu * Au[6 + k] + ev * Av[6 + k];
    }

    int n = 0;
#pragma unroll
    for (int a = 0; a < 12; ++a) {
      const float wa = wup * Au[a], va = wvp * Av[a];
#pragma unroll
      for (int b = a; b < 13; ++b) {
        if (b == 12) acc[NH + a] += wa * ru + va * rv;
        else acc[n++] += wa * Au[b] + va * Av[b];
      }
    }
  }

  // block reduction: shuffles within each warp, then across warps
  __shared__ float red[NWARPS][NACC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < NACC; ++n) {
    float s = acc[n];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][n] = s;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < NACC; n += NTHREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) s += red[w][n];
    if (n >= NH) {
      v[(size_t)e * 12 + (n - NH)] = s;
    } else {
      int a = 0, m = n;
      while (m >= 12 - a) { m -= 12 - a; ++a; }
      const int b = a + m;
      H[(size_t)e * 144 + a * 12 + b] = s;
      H[(size_t)e * 144 + b * 12 + a] = s;
    }
  }
}

extern "C" int edge_system_launch(const float* d_i, const float* tgt,
                                  const float* wgt, const float* g,
                                  const float* intr, int E, int hw, int wd,
                                  float* H, float* v, float* Eii, float* Eij,
                                  float* Cii, float* bz, void* stream) {
  if (E > 0)
    edge_system_kernel<<<E, NTHREADS, 0, (cudaStream_t)stream>>>(
        d_i, reinterpret_cast<const float2*>(tgt),
        reinterpret_cast<const float2*>(wgt), g, intr, hw, wd, H, v, Eii,
        Eij, Cii, bz);
  return (int)cudaGetLastError();
}

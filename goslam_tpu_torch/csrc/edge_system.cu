// K1: per-edge linearization of the dense-BA reprojection objective.
//
// Replaces the TPU kernel goslam_tpu/ops/pallas_kernels.py ::
// build_edge_system_fused (body _edge_system_kernel), together with the
// prep that XLA fuses around its pallas_call there (Gij, the stereo
// baseline, the disparity gather, the valid mask).  Plain version:
// goslam_tpu_torch/ops/dba.py :: build_edge_system_plain.
//
// Per edge e = (i -> j) and per pixel p of frame i it forms
// Gij = poses[j] . poses[i]^-1 (the stereo baseline where i == j), warps
// the inverse-depth point through it, forms the residual against the
// flow target, the analytic pose-j Jacobian rows and the disparity
// Jacobian.  Outputs:
//   H [E,12,12], v [E,12]   weighted Gram of [J_i | J_j] and its residual
//                           product (pose blocks, stereo masked)
//   Eii, Eij [E,6,hw]       pose-depth couplings
//   Cii, bz [E,hw]          depth-depth diagonal and depth rhs
//
// What bounds it on an H100: bytes.  Per pixel it reads 20 B (disparity,
// target, weight) and writes 56 B (Eii, Eij, Cii, bz); its arithmetic is
// far below the card's fp32 rate per byte, so it stays on the CUDA cores
// in fp32.  At the paths' sizes (E=160, hw=384: 4.4 MB, 1.3 us at the
// memory rate) what sets the time is latency: the launch, the chain of
// dependent loads at the head of a block (ii, then poses and the
// disparity row), each warp's chain of arithmetic, and the reduction at
// the tail.
//
// Design:
//  * One launch does everything: each block forms its edge's Gij in
//    registers from the raw poses and int64 indices, reads the disparity
//    row straight from disps[ii] and scales the weights by valid.  The wrapper only checks, allocates and launches: no copy
//    from the host, no synchronization.
//  * Less work per pixel: the pose-i rows are the pose-j rows moved by
//    one 6x6 map per edge, J_i = M J_j with M = -Adj(Gij)^T.  So a pixel
//    adds only to the 6x6 Gram G = sum w J_j J_j^T and to g = sum w J_j r
//    (27 sums, 40 FMAs: J_j has a zero in each row) instead of the 90
//    entries of the 12x12 Gram, and the block forms H = [M G M^T, M G;
//    G M^T, G], v = [M g; g] once at the end; likewise Eii = M Eij, one
//    transport per pixel instead of two.  Gij's rotation is a 3x3 matrix
//    in registers and the pixel grid takes no division.
//  * Warps: one block per edge, two pixels a thread at hw=384 (192
//    threads; hw=1200: 256 threads, four or five pixels), each thread's
//    next pixel loaded while it works on this one.  A block of one pixel
//    a thread (12 warps at hw=384) and one of three pixels (4 warps) were
//    both slower on the card: more warps mean more reductions at the
//    tail, fewer a longer chain per warp.  The edge's loads go first:
//    target, weight and intrinsics before the indices, the disparity row
//    with the poses.
//  * Memory: each lane loads and stores its own pixel, so every load or
//    store of a warp is one contiguous segment of a pixel row (128 B of
//    disparity or of an output row, 256 B of target or weight).  16-byte
//    loads handed out to the lanes by shuffles were measured slower.
//  * Short, fixed-order tail: 27 sums a thread, reduced across a warp by
//    a butterfly that halves the values at each step (31 shuffles, lane l
//    ends with sum l), across warps in shared memory in a fixed order;
//    then each of 156 threads forms one entry of H or v from G, g and M
//    (M G M^T from its upper half, so it is exactly symmetric) and writes
//    it, H as contiguous rows.  No atomics: two launches give the same
//    bits.  80 registers, no spills: three blocks an SM.
#include <cuda_runtime.h>

#define MIN_DEPTH 0.25f
#define WEIGHT_SCALE 0.001f
#define MAX_THREADS 256
#define MIN_BLOCKS 3            // blocks an SM: at most 85 registers
#define MAX_WARPS (MAX_THREADS / 32)
#define NSUM 27                 // G's upper triangle (21) then g (6)

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

// the rotation matrix of quaternion q, row-major (rot(q, v) == R v)
__device__ __forceinline__ void rotation(float qx, float qy, float qz,
                                         float qw, float* R) {
  R[0] = 1.f - 2.f * (qy * qy + qz * qz);
  R[1] = 2.f * (qx * qy - qw * qz);
  R[2] = 2.f * (qx * qz + qw * qy);
  R[3] = 2.f * (qx * qy + qw * qz);
  R[4] = 1.f - 2.f * (qx * qx + qz * qz);
  R[5] = 2.f * (qy * qz - qw * qx);
  R[6] = 2.f * (qx * qz - qw * qy);
  R[7] = 2.f * (qy * qz + qw * qx);
  R[8] = 1.f - 2.f * (qx * qx + qy * qy);
}

// Y = M J = -Adj(G)^T J for a 6-vector J = [a; b] in the [trans, rot]
// tangent: Y[:3] = -R^T a, Y[3:] = -R^T (b + a x t)
__device__ __forceinline__ void neg_adjT(const float* J, const float* R,
                                         float tx, float ty, float tz,
                                         float* Y) {
  const float c0 = J[3] + (J[1] * tz - J[2] * ty);
  const float c1 = J[4] + (J[2] * tx - J[0] * tz);
  const float c2 = J[5] + (J[0] * ty - J[1] * tx);
  Y[0] = -(R[0] * J[0] + R[3] * J[1] + R[6] * J[2]);
  Y[1] = -(R[1] * J[0] + R[4] * J[1] + R[7] * J[2]);
  Y[2] = -(R[2] * J[0] + R[5] * J[1] + R[8] * J[2]);
  Y[3] = -(R[0] * c0 + R[3] * c1 + R[6] * c2);
  Y[4] = -(R[1] * c0 + R[4] * c1 + R[7] * c2);
  Y[5] = -(R[2] * c0 + R[5] * c1 + R[8] * c2);
}

// index of G[k][l], k <= l, in the packed upper triangle
__host__ __device__ constexpr int tri(int k, int l) {
  return k * 6 - k * (k - 1) / 2 + (l - k);
}

// one butterfly step: lanes with bit OFF clear keep values [0, OFF) and
// send [OFF, 2 OFF), their partners the other way round; each adds what
// it receives, so the values left are s[0..OFF) (compile-time indices)
template <int OFF>
__device__ __forceinline__ void halve(float* s, int lane) {
  const bool upper = lane & OFF;
#pragma unroll
  for (int n = 0; n < OFF; ++n) {
    const float send = upper ? s[n] : s[n + OFF];
    const float keep = upper ? s[n + OFF] : s[n];
    s[n] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
}

__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
edge_system_kernel(const float* __restrict__ poses,
                   const float* __restrict__ disps,
                   const float* __restrict__ intr,
                   const float2* __restrict__ tgt,
                   const float2* __restrict__ wgt,
                   const long long* __restrict__ ii,
                   const long long* __restrict__ jj,
                   const bool* __restrict__ valid, int P, int hw, int wd,
                   float* __restrict__ H, float* __restrict__ v,
                   float* __restrict__ Eii, float* __restrict__ Eij,
                   float* __restrict__ Cii, float* __restrict__ bz) {
  __shared__ float red[MAX_WARPS][32];
  __shared__ float sG[NSUM];          // G (packed) and g
  __shared__ float sM[6][6];          // M = -Adj(Gij)^T, row-major

  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)e * hw;

  // this thread's pixels are threadIdx.x + k blockDim.x; the first one's
  // target and weight do not wait for the edge
  const float2* trow = tgt + row;
  const float2* wrow = wgt + row;
  int q = threadIdx.x;
  float2 tn = make_float2(0.f, 0.f), wn = tn;
  if (q < hw) {
    tn = trow[q];
    wn = wrow[q];
  }
  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];

  // the edge: Gij = poses[j] . poses[i]^-1 (lie.rel), or the baseline
  const long long i_raw = ii[e], j_raw = jj[e];
  const bool stereo = i_raw == j_raw;
  const long long i = min(max(i_raw, 0LL), (long long)P - 1);
  const long long j = min(max(j_raw, 0LL), (long long)P - 1);
  const float vf = valid[e] ? 1.f : 0.f;
  const float keep_pose = stereo ? 0.f : 1.f;   // stereo: depth only
  const float* drow = disps + (size_t)i * hw;
  float dn = q < hw ? drow[q] : 0.f;    // out with the poses' loads
  float tx = -0.1f, ty = 0.f, tz = 0.f;
  float qx = 0.f, qy = 0.f, qz = 0.f, qw = 1.f;
  if (!stereo) {
    const float* pi = poses + 7 * i;
    const float* pj = poses + 7 * j;
    const float ax = pj[3], ay = pj[4], az = pj[5], aw = pj[6];
    const float bx = -pi[3], by = -pi[4], bzq = -pi[5], bw = pi[6];
    qx = aw * bx + ax * bw + ay * bzq - az * by;
    qy = aw * by + ay * bw + az * bx - ax * bzq;
    qz = aw * bzq + az * bw + ax * by - ay * bx;
    qw = aw * bw - ax * bx - ay * by - az * bzq;
    float rx, ry, rz;
    rot(qx, qy, qz, qw, pi[0], pi[1], pi[2], rx, ry, rz);
    tx = pj[0] - rx; ty = pj[1] - ry; tz = pj[2] - rz;
  }
  float R[9];
  rotation(qx, qy, qz, qw, R);
  if (threadIdx.x < 6) {              // column k of M: M applied to e_k
    float ek[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, col[6];
    ek[threadIdx.x] = 1.f;
    neg_adjT(ek, R, tx, ty, tz, col);
#pragma unroll
    for (int a = 0; a < 6; ++a) sM[a][threadIdx.x] = col[a];
  }
  // X = (u - cx) / fx by a multiply; u - cx is exact, so the rays of
  // pixels near the centre lose nothing to cancellation (the residual
  // below, target minus projection, magnifies any error in them)
  const float ifx = 1.f / fx, ify = 1.f / fy;
  const float iwd = 1.f / (float)wd;
  float* const cii_e = Cii + row;
  float* const bz_e = bz + row;
  float* const eii_e = Eii + row * 6;
  float* const eij_e = Eij + row * 6;

  float acc[NSUM];
#pragma unroll
  for (int n = 0; n < NSUM; ++n) acc[n] = 0.f;

  // a warp's loads and stores of a pixel row are one contiguous segment;
  // the loop is uniform across the warp (its lanes past hw go on with zero
  // weights and store nothing), so the warp stays converged
  for (int q0 = q - lane; q0 < hw; q0 += blockDim.x, q += blockDim.x) {
    const bool in = q < hw;
    const float d = dn;
    const float2 t = tn, w = wn;
    if (q + (int)blockDim.x < hw) {     // the next pixel's loads go out now
      dn = drow[q + blockDim.x];
      tn = trow[q + blockDim.x];
      wn = wrow[q + blockDim.x];
    }

    // pixel (u, v) = (q % wd, q / wd): (q + 0.5) / wd is at least 0.5 / wd
    // from an integer, far beyond the rounding of the product
    const float pv = floorf(((float)q + 0.5f) * iwd);
    const float pu = (float)q - pv * (float)wd;
    const float X = (pu - cx) * ifx, Y = (pv - cy) * ify;
    const float x = R[0] * X + R[1] * Y + R[2] + d * tx;
    const float y = R[3] * X + R[4] * Y + R[5] + d * ty;
    const float z = R[6] * X + R[7] * Y + R[8] + d * tz;
    const float h = d;

    const bool ok = z >= MIN_DEPTH;
    const float dd = ok ? __fdividef(1.f, z) : 0.f;
    const float d2 = dd * dd;

    const float wu = (ok && in ? w.x * WEIGHT_SCALE : 0.f) * vf;
    const float wv = (ok && in ? w.y * WEIGHT_SCALE : 0.f) * vf;
    const float ru = t.x - (fx * dd * x + cx);
    const float rv = t.y - (fy * dd * y + cy);

    // pose-j rows for u and v ([trans, rot]; Ju[1] = Jv[0] = 0)
    float Ju[6], Jv[6];
    Ju[0] = fx * h * dd;
    Ju[1] = 0.f;
    Ju[2] = -fx * x * h * d2;
    Ju[3] = -fx * x * y * d2;
    Ju[4] = fx * (1.f + x * x * d2);
    Ju[5] = -fx * y * dd;
    Jv[0] = 0.f;
    Jv[1] = fy * h * dd;
    Jv[2] = -fy * y * h * d2;
    Jv[3] = -fy * (1.f + y * y * d2);
    Jv[4] = fy * x * y * d2;
    Jv[5] = fy * x * dd;

    // disparity Jacobian; the depth blocks use the pre-stereo weights
    const float jzu = fx * (tx * dd - tz * (x * d2));
    const float jzv = fy * (ty * dd - tz * (y * d2));
    if (in) {
      cii_e[q] = wu * jzu * jzu + wv * jzv * jzv;
      bz_e[q] = wu * ru * jzu + wv * rv * jzv;
    }

    const float wup = wu * keep_pose, wvp = wv * keep_pose;
    const float eu = wup * jzu, ev = wvp * jzv;
    float Ej[6], Ei[6];
#pragma unroll
    for (int m = 0; m < 6; ++m) Ej[m] = eu * Ju[m] + ev * Jv[m];
    neg_adjT(Ej, R, tx, ty, tz, Ei);
    if (in) {
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        eii_e[(size_t)m * hw + q] = Ei[m];
        eij_e[(size_t)m * hw + q] = Ej[m];
      }
    }

    // G += w J J^T and g += w J r over the u and v rows, leaving out the
    // products with a row's zero
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float au = wup * Ju[k], av = wvp * Jv[k];
#pragma unroll
      for (int l = k; l < 6; ++l) {
        float s = acc[tri(k, l)];
        if (k != 1 && l != 1) s += au * Ju[l];
        if (k != 0 && l != 0) s += av * Jv[l];
        acc[tri(k, l)] = s;
      }
      float s = acc[21 + k];
      if (k != 1) s += au * ru;
      if (k != 0) s += av * rv;
      acc[21 + k] = s;
    }
  }

  // warp: a butterfly that halves the values at each step; lane l ends
  // with the warp's sum of value l (values 27-31 are zero)
  float s[32];
#pragma unroll
  for (int n = 0; n < 32; ++n) s[n] = n < NSUM ? acc[n] : 0.f;
  halve<16>(s, lane);
  halve<8>(s, lane);
  halve<4>(s, lane);
  halve<2>(s, lane);
  halve<1>(s, lane);
  red[warp][lane] = s[0];
  __syncthreads();

  // block: the warps' sums in a fixed order, four chains at a time
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x < NSUM) {
    const int n = threadIdx.x;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int w = 0; w < nwarps; w += 4) {
      a0 += red[w][n];
      if (w + 1 < nwarps) a1 += red[w + 1][n];
      if (w + 2 < nwarps) a2 += red[w + 2][n];
      if (w + 3 < nwarps) a3 += red[w + 3][n];
    }
    sG[n] = (a0 + a1) + (a2 + a3);
  }
  __syncthreads();

  // H = [M G M^T, M G; G M^T, G] and v = [M g; g], each entry from G, g
  // and M directly (M G M^T from its upper half, so it is exactly
  // symmetric)
  for (int n = threadIdx.x; n < 156; n += blockDim.x) {
    float val;
    if (n < 144) {
      const int a = n / 12, b = n % 12;
      const int lo = min(a, b), hi = max(a, b);
      if (hi < 6) {                   // (M G M^T)[lo][hi]
        val = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          float gm = 0.f;
#pragma unroll
          for (int l = 0; l < 6; ++l)
            gm += sG[tri(min(k, l), max(k, l))] * sM[hi][l];
          val += sM[lo][k] * gm;
        }
      } else if (lo < 6) {            // (M G)[lo][hi - 6]
        val = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k)
          val += sM[lo][k] * sG[tri(min(k, hi - 6), max(k, hi - 6))];
      } else {
        val = sG[tri(lo - 6, hi - 6)];
      }
      H[(size_t)e * 144 + n] = val;
    } else {
      const int a = n - 144;
      if (a < 6) {                    // (M g)[a]
        val = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) val += sM[a][k] * sG[21 + k];
      } else {
        val = sG[21 + a - 6];
      }
      v[(size_t)e * 12 + a] = val;
    }
  }
}

// poses [P,7], disps [P,hw], intr [4], tgt/wgt [E,hw,2] fp32; ii/jj [E]
// int64; valid [E] bool; outputs as above.
extern "C" int edge_system_launch(const float* poses, const float* disps,
                                  const float* intr, const float* tgt,
                                  const float* wgt, const long long* ii,
                                  const long long* jj, const bool* valid,
                                  int P, int E, int hw, int wd,
                                  float* H, float* v, float* Eii,
                                  float* Eij, float* Cii, float* bz,
                                  void* stream) {
  if (E <= 0) return 0;
  if (P <= 0 || hw <= 0 || wd <= 0) return (int)cudaErrorInvalidValue;
  // as few pixels a thread as fit the edge into a block of at most
  // MAX_THREADS (hw=384: 192 threads of two pixels)
  const int per_thread = (hw + MAX_THREADS - 1) / MAX_THREADS;
  const int threads = ((hw + per_thread - 1) / per_thread + 31) / 32 * 32;
  edge_system_kernel<<<E, threads, 0, (cudaStream_t)stream>>>(
      poses, disps, intr, reinterpret_cast<const float2*>(tgt),
      reinterpret_cast<const float2*>(wgt), ii, jj, valid, P, hw, wd, H, v,
      Eii, Eij, Cii, bz);
  return (int)cudaGetLastError();
}

// K2: on-the-fly windowed correlation (alt-corr) for a chunk of edges.
//
// Replaces the TPU kernel goslam_tpu/ops/pallas_corr.py :: alt_corr_fused
// (body _corr_kernel).  Plain version: goslam_tpu_torch/ops/corr.py ::
// alt_corr_plain; the function both compute is goslam_tpu/ops/corr.py ::
// alt_corr.
//
// Per edge e = (ii[e] -> jj[e]) and per pixel p of frame ii[e]: for each
// pyramid level l, the dot products of f1 = level0[ii[e], p] with the
// level-l features of frame jj[e] at the (2r+2)^2 = 64 integer taps around
// coords[e, p] / 2^l (zero out of bounds), then the bilinear combine into
// (2r+1)^2 = 49 channels, channel = x_off * 7 + y_off, levels level-major.
// Features are bf16 (/4-scaled); products and sums are fp32.
//
// What bounds it on an H100: bytes, the 784-byte fp32 output row per
// pixel (241 MB, 0.07 ms at 3.35 TB/s, for the backend's chunk of 256
// edges x 1200 pixels).  Its dot products (2 * 128 FLOP per in-bounds
// tap, at most 256 taps per pixel) take bf16 inputs, and at the tensor
// cores' bf16 rate they are ~20 GFLOP in 0.02 ms.  This kernel does them
// on the CUDA cores in fp32 instead, where the same work needs 0.3 ms at
// 67 TFLOP/s: as written, operations bind it.
//
// Design: the TPU kernel computed the whole [pixels, H_l*W_l] volume
// block and then cut the window out of it; here only the 256 taps a pixel
// needs are computed (the work of the original CUDA altcorr kernel).  One
// block per (edge, 64-pixel tile), 8 warps, each warp walks 8 pixels.  A
// warp works on 4 taps at a time: 8 lanes per tap, 16 channels per lane
// (two 16-byte loads, so each tap's 256-byte feature row is read by 8
// neighbouring lanes), a 3-step shuffle reduction inside each 8-lane
// group, the 64 tap values in shared memory, then 49 bilinear outputs per
// level written by the warp's lanes.  Tensor cores, TMA and volume tiling
// are later work.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int C = 128;               // feature channels
constexpr int RADIUS = 3;
constexpr int S = 2 * RADIUS + 2;    // 8: integer window side
constexpr int RD = 2 * RADIUS + 1;   // 7: bilinear window side
constexpr int NTAPS = S * S;         // 64
constexpr int TILE = 64;             // pixels per block
constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_LEVELS = 4;
constexpr float COORD_CLAMP = 1.0e4f;

struct Levels {
  const uint16_t* f[MAX_LEVELS];  // [T, H_l, W_l, C] bf16 bits
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

__device__ __forceinline__ void bf16x8_to_f32(uint4 q, float* o) {
  const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = __uint_as_float(wd[k] << 16);
    o[2 * k + 1] = __uint_as_float(wd[k] & 0xffff0000u);
  }
}

__global__ void __launch_bounds__(NTHREADS)
alt_corr_kernel(Levels lv, int nlvl, int T, const float2* __restrict__ coords,
                const int* __restrict__ ii, const int* __restrict__ jj,
                int P1, float* __restrict__ out) {
  __shared__ float taps[NWARPS][NTAPS];
  const int e = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grp = lane >> 3;    // which of the 4 taps of a pass
  const int sub = lane & 7;     // which 16-channel slice
  // out-of-range frame indices clamp, as a JAX gather does
  const int fi = min(max(ii[e], 0), T - 1);
  const int fj = min(max(jj[e], 0), T - 1);
  const int nch = nlvl * RD * RD;

  for (int k = 0; k < TILE / NWARPS; ++k) {
    const int p = blockIdx.x * TILE + warp * (TILE / NWARPS) + k;
    if (p >= P1) break;                       // uniform across the warp

    float f1[16];
    {
      const uint4* src = reinterpret_cast<const uint4*>(
          lv.f[0] + ((size_t)fi * P1 + p) * C + sub * 16);
      bf16x8_to_f32(src[0], f1);
      bf16x8_to_f32(src[1], f1 + 8);
    }
    const float2 c0 = coords[(size_t)e * P1 + p];
    float* orow = out + ((size_t)e * P1 + p) * nch;

    for (int l = 0; l < nlvl; ++l) {
      const float inv = 1.f / (float)(1 << l);
      // far-out coords clamp (all their taps are out of bounds either
      // way); a NaN coordinate keeps a NaN weight, as in the plain version
      const float cxr = c0.x * inv, cyr = c0.y * inv;
      const float cx = fminf(fmaxf(cxr, -COORD_CLAMP), COORD_CLAMP);
      const float cy = fminf(fmaxf(cyr, -COORD_CLAMP), COORD_CLAMP);
      const float x0f = floorf(cx), y0f = floorf(cy);
      const float dx = isnan(cxr) ? cxr : cx - x0f;
      const float dy = isnan(cyr) ? cyr : cy - y0f;
      const int x0 = (int)x0f, y0 = (int)y0f;
      const int H2 = lv.h[l], W2 = lv.w[l];
      const uint16_t* f2 = lv.f[l] + (size_t)fj * H2 * W2 * C + sub * 16;

#pragma unroll 4
      for (int it = 0; it < NTAPS / 4; ++it) {
        const int t = it * 4 + grp;
        const int ay = y0 - RADIUS + (t >> 3);
        const int ax = x0 - RADIUS + (t & 7);
        float s = 0.f;
        if (ay >= 0 && ay < H2 && ax >= 0 && ax < W2) {
          const uint4* src = reinterpret_cast<const uint4*>(
              f2 + ((size_t)ay * W2 + ax) * C);
          float f2v[16];
          bf16x8_to_f32(src[0], f2v);
          bf16x8_to_f32(src[1], f2v + 8);
#pragma unroll
          for (int c = 0; c < 16; ++c) s = fmaf(f1[c], f2v[c], s);
        }
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        if (sub == 0) taps[warp][t] = s;
      }
      __syncwarp();
      const float* T8 = taps[warp];             // T8[y * 8 + x]
      for (int o = lane; o < RD * RD; o += 32) {
        const int xo = o / RD, yo = o % RD;
        const float val = (1.f - dy) * (1.f - dx) * T8[yo * S + xo]
                        + (1.f - dy) * dx * T8[yo * S + xo + 1]
                        + dy * (1.f - dx) * T8[(yo + 1) * S + xo]
                        + dy * dx * T8[(yo + 1) * S + xo + 1];
        orow[l * RD * RD + o] = val;
      }
      __syncwarp();
    }
  }
}

extern "C" int alt_corr_launch(const void* const* levels, const int* hs,
                               const int* ws, int nlvl, int T,
                               const float* coords, const int* ii,
                               const int* jj, int E, int P1, float* out,
                               void* stream) {
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.f[l] = l < nlvl ? static_cast<const uint16_t*>(levels[l]) : nullptr;
    lv.h[l] = l < nlvl ? hs[l] : 0;
    lv.w[l] = l < nlvl ? ws[l] : 0;
  }
  if (E > 0 && P1 > 0) {
    dim3 grid((P1 + TILE - 1) / TILE, E);
    alt_corr_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        lv, nlvl, T, reinterpret_cast<const float2*>(coords), ii, jj, P1,
        out);
  }
  return (int)cudaGetLastError();
}

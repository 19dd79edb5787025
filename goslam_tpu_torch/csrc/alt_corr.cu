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
// Features are bf16 (/4-scaled); products are exact and sums fp32.
//
// What bounds it on an H100: bytes, the 784-byte fp32 output row per
// pixel (77 MB, 23 us at 3.35 TB/s, for the backend's chunk of 256 edges
// x 384 pixels).  The dot products (2 * 128 FLOP per in-bounds tap) take
// bf16 inputs; at the tensor cores' bf16 rate they are a few us.  Done
// one tap at a time on the CUDA cores in fp32, as the first version of
// this kernel did, they cost ~6 GFLOP and 6.4 GB of feature reads through
// the cache per launch, because neighbouring pixels, whose windows
// overlap almost completely, shared nothing.  What is left to pay here is
// moving the target features from L2 to each tile (a level's box is read
// once per tile of 64 pixels) and the per-level bookkeeping.
//
// Design: one block per (edge, tile of 64 pixels of frame ii); the f1 tile
// (64 x 128 bf16) is staged in shared memory once with 16-byte cp.async.
// For every level at once, the block first reduces its pixels' windows to
// the box of rows and columns of frame jj they touch (pixels whose window
// misses the image, NaN and far-out coordinates among them, are left
// out): when flow is smooth that is a few rows, at worst the whole level,
// which is what the TPU kernel always computed.  The boxes of all levels
// are then walked as one sequence of chunks of 64 target pixels,
// double-buffered in shared memory with cp.async, so the next level's
// first chunk loads while this level finishes.  Each chunk is multiplied
// with the f1 tile on the tensor cores (ldmatrix, mma.sync m16n8k16, bf16
// in, fp32 out; each of 8 warps owns a 16 x 32 slab of the 64 x 64
// product) and the product goes to shared memory, where each thread picks
// out the 16 of its pixel's 64 window taps that fall in the chunk; taps
// out of bounds stay zero.  After a level's last chunk the threads combine
// their taps bilinearly in registers (one shuffle brings the next tap row)
// and stage the 49 outputs per pixel in shared memory, and the block
// writes them as 49-float runs of its contiguous output rows, with
// streaming (evict-first) stores, so that the output does not push the
// feature pyramid out of L2.
#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int C = 128;               // feature channels
constexpr int RADIUS = 3;
constexpr int S = 2 * RADIUS + 2;    // 8: integer window side
constexpr int RD = 2 * RADIUS + 1;   // 7: bilinear window side
constexpr int TILE = 64;             // pixels of frame ii per block (rows)
constexpr int CHUNK = 64;            // target pixels per staged chunk (cols)
constexpr int NTHREADS = 256;
constexpr int ROW = C + 8;           // bf16 per shared feature row: 16 B of
                                     // padding, so that ldmatrix is free of
                                     // bank conflicts
constexpr int SROW = CHUNK + 8;      // floats per row of the product
constexpr int PIECES = C * 2 / 16;   // 16-byte pieces per feature row
constexpr int MAX_LEVELS = 4;
constexpr float COORD_CLAMP = 1.0e4f;
constexpr int FAR = -(1 << 20);      // window origin of an absent pixel

struct Levels {
  const uint16_t* f[MAX_LEVELS];  // [T, H_l, W_l, C] bf16 bits
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
};

struct Smem {
  uint16_t f1[TILE * ROW];
  uint16_t f2[2][CHUNK * ROW];
  float s[TILE * SROW];            // a chunk's 64 x 64 product
  int x0[MAX_LEVELS][TILE];        // window origin (tap 0, 0) per level
  int y0[MAX_LEVELS][TILE];
  float dx[MAX_LEVELS][TILE];      // bilinear fractions per level
  float dy[MAX_LEVELS][TILE];
  int box[MAX_LEVELS][4];          // ymin, ymax, xmin, xmax over the tile
  int ymin[MAX_LEVELS], xmin[MAX_LEVELS], nc[MAX_LEVELS], n[MAX_LEVELS];
  int cbeg[MAX_LEVELS + 1];        // first chunk of each level, flattened
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// r = q * nc + rem for 0 <= r < 2^22, from a float reciprocal and one
// correction step
__device__ __forceinline__ void divmod(int r, int nc, float inv, int& q,
                                       int& rem) {
  q = __float2int_rd((float)r * inv);
  rem = r - q * nc;
  if (rem < 0) { --q; rem += nc; }
  if (rem >= nc) { ++q; rem -= nc; }
}

// Stage target pixels c0 .. c0+63 of the box (row-major over its nc
// columns) of one level into dst: this thread copies piece tid % 16 of
// rows tid / 16 + 16 q.  Rows past the box's n pixels are left as they
// are (they only reach product columns that are never read).
__device__ __forceinline__ void load_chunk(uint16_t* dst, const uint16_t* f2,
                                           int W2, int c0, int n, int ymin,
                                           int xmin, int nc, float inv,
                                           int tid) {
  const int piece = tid % PIECES;
#pragma unroll
  for (int q = 0; q < CHUNK * PIECES / NTHREADS; ++q) {
    const int row = tid / PIECES + q * (NTHREADS / PIECES);
    const int r = c0 + row;
    if (r < n) {
      int ty, tx;
      divmod(r, nc, inv, ty, tx);
      cp_async16(dst + row * ROW + piece * 8,
                 f2 + ((size_t)(ymin + ty) * W2 + xmin + tx) * C + piece * 8);
    }
  }
  cp_async_commit();
}

// The chunk after chunk c of level l in the flattened order over all
// levels (levels with an empty box have no chunks); returns false after the
// last one.
__device__ __forceinline__ bool next_chunk(const Smem& sm, int nlvl, int& l,
                                           int& c) {
  if (sm.cbeg[l] + c + 1 < sm.cbeg[l + 1]) {
    ++c;
    return true;
  }
  for (++l; l < nlvl; ++l)
    if (sm.cbeg[l] < sm.cbeg[l + 1]) {
      c = 0;
      return true;
    }
  return false;
}

__device__ __forceinline__ void load_level_chunk(Smem& sm, uint16_t* dst,
                                                 const Levels& lv, int fj,
                                                 int l, int c, int tid) {
  const int W2 = lv.w[l], nc = sm.nc[l];
  load_chunk(dst, lv.f[l] + (size_t)fj * lv.h[l] * W2 * C, W2, c * CHUNK,
             sm.n[l], sm.ymin[l], sm.xmin[l], nc, 1.f / (float)nc, tid);
}

__global__ void __launch_bounds__(NTHREADS, 3)
alt_corr_kernel(Levels lv, int nlvl, int T, const float2* __restrict__ coords,
                const int* __restrict__ ii, const int* __restrict__ jj,
                int P1, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int e = blockIdx.y, p0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;     // mma fragment coordinates
  const int mrow = (warp & 3) * 16 + g;        // accumulator rows mrow, +8
  const int ncol = (warp >> 2) * 32;           // this warp's 32 columns
  const int lq = lane >> 3, li = lane & 7;     // ldmatrix row providers
  // the 16 taps this thread gathers: pixel pm, tap rows a0 and a0 + 1
  const int pm = tid >> 2, a0 = (tid & 3) * 2;
  // out-of-range frame indices clamp, as a JAX gather does
  const int fi = min(max(ii[e], 0), T - 1);
  const int fj = min(max(jj[e], 0), T - 1);
  const int nch = nlvl * RD * RD;
  const int np = min(TILE, P1 - p0);

  // ---- the f1 tile, once; absent pixels of a ragged tile are zero -------
  for (int i = tid; i < TILE * PIECES; i += NTHREADS) {
    const int row = i / PIECES, piece = i % PIECES;
    uint16_t* dst = sm.f1 + row * ROW + piece * 8;
    if (row < np)
      cp_async16(dst, lv.f[0] + ((size_t)fi * P1 + p0 + row) * C + piece * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();

  // ---- per (pixel, level): window origin, fractions, the tile's box -----
  if (tid < MAX_LEVELS * 4)
    sm.box[tid / 4][tid % 4] = (tid & 1) ? INT_MIN : INT_MAX;
  __syncthreads();
  {
    const int m = tid % TILE, l = tid / TILE;
    if (l < nlvl) {
      int x0 = FAR, y0 = FAR;
      float dx = 0.f, dy = 0.f;
      if (m < np) {
        const float2 cpx = coords[(size_t)e * P1 + p0 + m];
        const float inv = 1.f / (float)(1 << l);
        // far-out coords clamp (all their taps are out of bounds either
        // way); a NaN coordinate keeps a NaN fraction, as in the plain
        // version, and its window (at the clamp) misses the image
        const float cxr = cpx.x * inv, cyr = cpx.y * inv;
        const float cx = fminf(fmaxf(cxr, -COORD_CLAMP), COORD_CLAMP);
        const float cy = fminf(fmaxf(cyr, -COORD_CLAMP), COORD_CLAMP);
        const float x0f = floorf(cx), y0f = floorf(cy);
        dx = isnan(cxr) ? cxr : cx - x0f;
        dy = isnan(cyr) ? cyr : cy - y0f;
        x0 = (int)x0f - RADIUS;
        y0 = (int)y0f - RADIUS;
        if (x0 + S > 0 && x0 < lv.w[l] && y0 + S > 0 && y0 < lv.h[l]) {
          atomicMin(&sm.box[l][0], y0);
          atomicMax(&sm.box[l][1], y0 + S - 1);
          atomicMin(&sm.box[l][2], x0);
          atomicMax(&sm.box[l][3], x0 + S - 1);
        }
      }
      sm.x0[l][m] = x0;
      sm.y0[l][m] = y0;
      sm.dx[l][m] = dx;
      sm.dy[l][m] = dy;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int l = 0; l < nlvl; ++l) {
      const int* b = sm.box[l];
      const bool any = b[0] <= b[1];
      sm.ymin[l] = any ? max(b[0], 0) : 0;
      sm.xmin[l] = any ? max(b[2], 0) : 0;
      sm.nc[l] = any ? min(b[3], lv.w[l] - 1) - sm.xmin[l] + 1 : 1;
      sm.n[l] = any ? (min(b[1], lv.h[l] - 1) - sm.ymin[l] + 1) * sm.nc[l]
                    : 0;
      sm.cbeg[l] = total;
      total += (sm.n[l] + CHUNK - 1) / CHUNK;
    }
    sm.cbeg[nlvl] = total;
  }
  __syncthreads();

  // ldmatrix row addresses: A (16 rows of f1), B (two 8-column tiles)
  const uint16_t* a_src =
      sm.f1 + ((warp & 3) * 16 + (lq & 1) * 8 + li) * ROW + (lq >> 1) * 8;
  const int b_off = (ncol + (lq >> 1) * 8 + li) * ROW + (lq & 1) * 8;

  // the pipeline runs over the chunks of all levels: (ln, cn) is the chunk
  // in flight ahead of the one being multiplied
  int ln = 0, cn = -1;
  bool more = next_chunk(sm, nlvl, ln, cn);
  if (more) load_level_chunk(sm, sm.f2[0], lv, fj, ln, cn, tid);
  int gidx = 0;                                 // chunks multiplied so far
  for (int l = 0; l < nlvl; ++l) {
    // this thread's taps: bit k (tap row a0 + k / 8, column k % 8) is set
    // when the tap lies in the image; tap k sits at box index R0 + ...
    const int H2 = lv.h[l], W2 = lv.w[l], nc = sm.nc[l];
    const int wy = sm.y0[l][pm] + a0, wx = sm.x0[l][pm];
    // columns wx + b inside [0, W2): bits lo .. hi-1
    const int lo = min(max(-wx, 0), S), hi = min(max(W2 - wx, 0), S);
    const unsigned cols = ((1u << hi) - 1u) & ~((1u << lo) - 1u);
    const unsigned mask = ((unsigned)wy < (unsigned)H2 ? cols : 0u)
                        | ((unsigned)(wy + 1) < (unsigned)H2 ? cols << S : 0u);
    const int R0 = mask ? (wy - sm.ymin[l]) * nc + wx - sm.xmin[l] : 0;
    float tv[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) tv[k] = 0.f;

    // ---- the level's box, chunk by chunk, on the tensor cores ----------
    const int nchunks = sm.cbeg[l + 1] - sm.cbeg[l];
    for (int c = 0; c < nchunks; ++c, ++gidx) {
      more = next_chunk(sm, nlvl, ln, cn);
      if (more) {
        load_level_chunk(sm, sm.f2[(gidx + 1) & 1], lv, fj, ln, cn, tid);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const uint16_t* b_src = sm.f2[gidx & 1] + b_off;
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[nt][q] = 0.f;
#pragma unroll
      for (int ks = 0; ks < C / 16; ++ks) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, a_src + ks * 16);
#pragma unroll
        for (int pr = 0; pr < 2; ++pr) {
          ldmatrix_x4(b, b_src + pr * 16 * ROW + ks * 16);
          mma_bf16(acc[2 * pr], a, b[0], b[1]);
          mma_bf16(acc[2 * pr + 1], a, b[2], b[3]);
        }
      }
      // the 64 x 64 product to shared memory: accumulator (row mrow + 8h,
      // column ncol + nt*8 + 2 tig + j) is acc[nt][2h + j]
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        float* d = sm.s + mrow * SROW + ncol + nt * 8 + 2 * tig;
        *reinterpret_cast<float2*>(d) = make_float2(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<float2*>(d + 8 * SROW) =
            make_float2(acc[nt][2], acc[nt][3]);
      }
      __syncthreads();
      // each thread picks its pixel's taps that fall in this chunk (box
      // indices R0 .. R0 + nc + 7)
      const int base = R0 - c * CHUNK;
      if (mask && base < CHUNK && base + nc + S > 0) {
        const float* srow = sm.s + pm * SROW;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int d = base + (k / 8) * nc + k % 8;
          if (((mask >> k) & 1u) && (unsigned)d < (unsigned)CHUNK)
            tv[k] = srow[d];
        }
      }
    }

    // ---- bilinear combine from registers, staged for coalesced stores --
    // output (xo, yo) needs tap rows yo and yo + 1: this thread has rows a0
    // and a0 + 1, and row a0 + 2 is the next thread's first
    float nx[S];
#pragma unroll
    for (int x = 0; x < S; ++x) nx[x] = __shfl_down_sync(0xffffffffu, tv[x], 1);
    __syncthreads();                    // every thread is done with sm.s
    {
      const float dx = sm.dx[l][pm], dy = sm.dy[l][pm];
      const float w00 = (1.f - dy) * (1.f - dx), w01 = (1.f - dy) * dx;
      const float w10 = dy * (1.f - dx), w11 = dy * dx;
      float* orow = sm.s + pm * RD * RD;
#pragma unroll
      for (int xo = 0; xo < RD; ++xo)
        orow[xo * RD + a0] = w00 * tv[xo] + w01 * tv[xo + 1]
                           + w10 * tv[S + xo] + w11 * tv[S + xo + 1];
      if (a0 + 1 < RD) {
#pragma unroll
        for (int xo = 0; xo < RD; ++xo)
          orow[xo * RD + a0 + 1] = w00 * tv[S + xo] + w01 * tv[S + xo + 1]
                                 + w10 * nx[xo] + w11 * nx[xo + 1];
      }
    }
    __syncthreads();
    // the level's 49 channels of the tile's pixels: runs of 49 floats
    for (int i = tid; i < np * RD * RD; i += NTHREADS) {
      const int m = i / (RD * RD), o = i % (RD * RD);
      __stcs(out + ((size_t)e * P1 + p0 + m) * nch + l * RD * RD + o,
             sm.s[i]);
    }
  }
  cp_async_wait<0>();   // the f1 tile, where no level had a chunk
}

extern "C" int alt_corr_launch(const void* const* levels, const int* hs,
                               const int* ws, int nlvl, int T,
                               const float* coords, const int* ii,
                               const int* jj, int E, int P1, float* out,
                               void* stream) {
  static bool smem_set = false;
  const int smem = (int)sizeof(Smem);
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        alt_corr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  Levels lv;
  for (int l = 0; l < MAX_LEVELS; ++l) {
    lv.f[l] = l < nlvl ? static_cast<const uint16_t*>(levels[l]) : nullptr;
    lv.h[l] = l < nlvl ? hs[l] : 0;
    lv.w[l] = l < nlvl ? ws[l] : 0;
  }
  if (E > 0 && P1 > 0) {
    dim3 grid((P1 + TILE - 1) / TILE, E);
    alt_corr_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
        lv, nlvl, T, reinterpret_cast<const float2*>(coords), ii, jj, P1,
        out);
  }
  return (int)cudaGetLastError();
}

// Fused dense FAST-9/16 at two thresholds + high-threshold blend + 3x3 NMS.
//
// Replaces the TPU kernel orbslam2_dualcam_tpu/ops/pallas_kernels.py
// (fast_nms_pallas, body _fast_nms_kernel).  For every pixel of a batch of
// images [ncam, H, W] (f32) it writes
//   s_nms  = nms3x3(where(s_hi > 0, s_hi + 1e4, s_lo))   (0 where suppressed)
//   sad_lo = the ungated thresholded SAD surface at th_lo
// where s_t is the FAST score at threshold t: the SAD over the bright
// (or dark) arc when >= 9 contiguous circle pixels are all brighter than
// p + t (or all darker than p - t), else 0.  Pixels outside the image read
// as 0, and scores outside the image count as 0 for the NMS, exactly as in
// the TPU kernel and in the plain torch version (ops/fast_nms.py).
//
// What bounds it on Hopper.  Device memory traffic is 12 B per pixel: one
// 4 B read (the halo re-reads hit shared memory) and two 4 B writes.  The
// arithmetic is 16 circle differences, each feeding 4 threshold tests, 4
// bit inserts and 4 clamped sums, plus the 4 run-of-9 tests: a few hundred
// simple integer and float instructions per pixel, recomputed on the 1-px
// ring.  By that count the kernel sits near the card's ridge (~20 f32
// operations per HBM byte) with instruction issue, not bandwidth, the
// nearer bound, and at the main path's level sizes (at most 2 x 640 x 480)
// both are a few microseconds, so launch latency matters as much.  The
// design keeps the intermediate score maps out of device memory, which is
// what the plain version pays for most: one block loads its tile plus a
// 4-px halo into shared memory once, computes the blended score on the
// tile plus a 1-px ring into shared memory, synchronizes, and runs the NMS
// from there.  One thread per output pixel; the camera index is
// blockIdx.z.  The sums run in the same order as the plain version, so the
// two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 16;
constexpr int HALO = 4;                    // 3 (FAST circle) + 1 (NMS)
constexpr int IMG_W = TILE_W + 2 * HALO;   // shared image tile
constexpr int IMG_H = TILE_H + 2 * HALO;
constexpr int SC_W = TILE_W + 2;           // shared score tile (1-px ring)
constexpr int SC_H = TILE_H + 2;
constexpr float NMS_BONUS = 1e4f;

// FAST-16 Bresenham circle of radius 3, clockwise from 12 o'clock
// (ops/orb_tables.FAST_OFFSETS): (dx, dy).
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};

// Cyclic run-of->=9 test on a 16-bit ring: AND with 8 successive cyclic
// rotations; a bit survives iff it starts a run of 9.
__device__ __forceinline__ bool arc9(uint32_t m) {
  uint32_t x = m;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint32_t rot = ((x >> 1) | (x << 15)) & 0xFFFFu;
    x &= rot;
  }
  return x != 0u;
}

__global__ void fast_nms_kernel(const float* __restrict__ img,
                                float* __restrict__ s_out,
                                float* __restrict__ sad_out,
                                int H, int W, float th_hi, float th_lo) {
  __shared__ float simg[IMG_H][IMG_W];
  __shared__ float sscore[SC_H][SC_W];

  const int cam = blockIdx.z;
  const int oy = blockIdx.y * TILE_H;
  const int ox = blockIdx.x * TILE_W;
  const size_t plane = (size_t)H * (size_t)W;
  const float* im = img + (size_t)cam * plane;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;
  const int nthreads = TILE_W * TILE_H;

  // tile + 4-px halo, zero outside the image
  for (int i = tid; i < IMG_H * IMG_W; i += nthreads) {
    const int r = i / IMG_W, c = i % IMG_W;
    const int y = oy - HALO + r, x = ox - HALO + c;
    simg[r][c] = (y >= 0 && y < H && x >= 0 && x < W) ? im[(size_t)y * W + x] : 0.0f;
  }
  __syncthreads();

  // blended score on the tile + 1-px ring; sad_lo for the tile itself
  for (int i = tid; i < SC_H * SC_W; i += nthreads) {
    const int r = i / SC_W, c = i % SC_W;
    const int y = oy - 1 + r, x = ox - 1 + c;
    float s = 0.0f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const int cy = r + HALO - 1, cx = c + HALO - 1;
      const float p = simg[cy][cx];
      uint32_t bh = 0u, dh = 0u, bl = 0u, dl = 0u;
      float sbh = 0.0f, sdh = 0.0f, sbl = 0.0f, sdl = 0.0f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const float d = simg[cy + kDy[k]][cx + kDx[k]] - p;
        bh |= (uint32_t)(d > th_hi) << k;
        dh |= (uint32_t)(d < -th_hi) << k;
        bl |= (uint32_t)(d > th_lo) << k;
        dl |= (uint32_t)(d < -th_lo) << k;
        sbh = sbh + fmaxf(d - th_hi, 0.0f);
        sdh = sdh + fmaxf(-d - th_hi, 0.0f);
        sbl = sbl + fmaxf(d - th_lo, 0.0f);
        sdl = sdl + fmaxf(-d - th_lo, 0.0f);
      }
      const float s_hi = (arc9(bh) ? sbh : 0.0f) + (arc9(dh) ? sdh : 0.0f);
      const float s_lo = (arc9(bl) ? sbl : 0.0f) + (arc9(dl) ? sdl : 0.0f);
      s = s_hi > 0.0f ? s_hi + NMS_BONUS : s_lo;
      if (r >= 1 && r <= TILE_H && c >= 1 && c <= TILE_W) {
        sad_out[(size_t)cam * plane + (size_t)y * W + x] = sbl + sdl;
      }
    }
    sscore[r][c] = s;
  }
  __syncthreads();

  // 3x3 NMS: keep a pixel if it is >= its neighbourhood's max
  const int y = oy + threadIdx.y, x = ox + threadIdx.x;
  if (y < H && x < W) {
    const int r = threadIdx.y + 1, c = threadIdx.x + 1;
    const float center = sscore[r][c];
    float m = center;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        m = fmaxf(m, sscore[r + dy][c + dx]);
      }
    }
    s_out[(size_t)cam * plane + (size_t)y * W + x] = center >= m ? center : 0.0f;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` over a contiguous f32 batch [ncam, H, W]; outputs are
// preallocated [ncam, H, W].  Returns cudaGetLastError() after the launch.
int fast_nms_f32(const float* img, float* s_out, float* sad_out, int ncam,
                 int H, int W, float th_hi, float th_lo, void* stream) {
  const dim3 block(TILE_W, TILE_H, 1);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, ncam);
  fast_nms_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      img, s_out, sad_out, H, W, th_hi, th_lo);
  return static_cast<int>(cudaGetLastError());
}

const char* kernels_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"

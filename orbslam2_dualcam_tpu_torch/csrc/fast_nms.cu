// Fused dense FAST-9/16 at two thresholds + high-threshold blend + 3x3 NMS,
// one launch for every level and camera of a frame's pyramid.
//
// Replaces the TPU kernel orbslam2_dualcam_tpu/ops/pallas_kernels.py
// (fast_nms_pallas, body _fast_nms_kernel).  For every pixel of every image
// [ncam, H, W] (f32) of a list of levels it writes
//   s_nms  = nms3x3(where(s_hi > 0, s_hi + 1e4, s_lo))   (0 where suppressed)
//   sad_lo = the ungated thresholded SAD surface at th_lo
// where s_t is the FAST score at threshold t: the SAD over the bright
// (or dark) arc when >= 9 contiguous circle pixels are all brighter than
// p + t (or all darker than p - t), else 0.  Pixels outside the image read
// as 0, and scores outside the image count as 0 for the NMS, exactly as in
// the TPU kernel and in the plain torch version (ops/fast_nms.py).
//
// What bounds it on Hopper.  Device memory traffic is 12 B per pixel (one
// 4 B read, two 4 B writes): 2.2 us at 2 x 480 x 640.  The arithmetic is
// about 180 simple operations per pixel (16 circle differences, each
// compared against +-th_lo, conditionally added to a sum and inserted into
// a ring mask; two run-of-9 tests; the NMS), more where a corner exists.
// None of it fuses into multiply-adds, so at one operation per lane and
// clock the card needs about 3.3 us for the same image: operations, not
// bytes, are the nearer bound, and the main path's upper levels are so
// small that a launch of their own costs more than their work.
//
// What the design does about it.
//  * One launch per pyramid: a table of per-level pointers and sizes is a
//    kernel parameter (by value, no device copy, no host synchronization),
//    and a block finds its level from its index.
//  * A block of 256 threads owns a 62 x 30 tile.  Tile plus the 1-px ring
//    the NMS needs is 64 x 32 score positions: exactly 8 per thread, a
//    warp to half a row, with every index a shift or a mask.  All warps
//    carry the same share of the ring, so none waits at the barrier.
//  * Masks and sums are built at the low threshold only; a position whose
//    comparison holds adds d - t to its sum under the same predicate,
//    which is max(d - t, 0) without the max.  Since th_hi >= th_lo >= 0, a
//    high-threshold arc implies a low-threshold one of the same polarity,
//    and a ring cannot hold a bright and a dark arc of 9 at once.  So the
//    positions with a low arc (about a fifth of a textured frame's
//    pixels, spread over nearly every warp) are queued in shared memory
//    with their polarity, and the high threshold runs densely over the
//    queue, one polarity per entry, instead of divergently inside the
//    first pass.
//  * The ring masks are kept doubled (bit k and bit k + 16), so the
//    cyclic run-of-9 test is four shift-and-AND steps with no rotation.
//  * Both outputs are stored by the thread that owns the pixel, a warp to
//    a row.  40 registers and 22.9 KB of shared memory per block: 6 blocks
//    (48 warps) fit an SM.
// The sums run in the order k = 0..15 of the plain version, so the two
// agree bit for bit.
//
// What still holds it: a block loads, computes and stores in turn, and the
// blocks of a wave do so in step, so the memory phase (about a third of
// the time) and the arithmetic do not overlap; and a launch costs about
// 4 us before any work.  A persistent block that prefetches its next tile
// (cp.async into a second buffer) is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 16;
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS_PER_SM = 4;           // caps registers at 64
constexpr int RADIUS = 3;                     // FAST circle
constexpr int SC_W = 64;                      // score region: tile + 1-px ring
constexpr int SC_H = 32;
constexpr int TILE_W = SC_W - 2;
constexpr int TILE_H = SC_H - 2;
constexpr int IMG_W = SC_W + 2 * RADIUS;      // shared image region
constexpr int IMG_H = SC_H + 2 * RADIUS;
constexpr int ROWS_PER_PASS = THREADS / SC_W; // 4
constexpr int PASSES = SC_H / ROWS_PER_PASS;
constexpr float NMS_BONUS = 1e4f;
constexpr int QUEUE_DARK = SC_H * SC_W;       // queue entry: position | polarity

static_assert((SC_H & (SC_H - 1)) == 0 && 2 * SC_H * SC_W <= 65536,
              "a queue entry is a power-of-two position count plus one bit");

static_assert(SC_W == 64 && THREADS % SC_W == 0, "a warp covers half a score row");
static_assert(SC_H % ROWS_PER_PASS == 0, "score rows divide evenly over the passes");

struct Level {
  const float* img;   // [ncam, H, W]
  float* s;           // [ncam, H, W] s_nms
  float* sad;         // [ncam, H, W] sad_lo
  int H, W;
  int tiles_x;        // tiles across one image
  int tiles_per_cam;  // tiles of one image
  int first_block;    // index of the level's first block in the grid
};

struct Pyramid {
  Level lv[MAX_LEVELS];
  int n_levels;
  float th_hi, th_lo;
};

// FAST-16 Bresenham circle of radius 3, clockwise from 12 o'clock
// (ops/orb_tables.FAST_OFFSETS): X(k, dx, dy).
#define FAST_CIRCLE(X)                                                      \
  X(0, 0, -3) X(1, 1, -3) X(2, 2, -2) X(3, 3, -1) X(4, 3, 0) X(5, 3, 1)     \
  X(6, 2, 2) X(7, 1, 3) X(8, 0, 3) X(9, -1, 3) X(10, -2, 2) X(11, -3, 1)    \
  X(12, -3, 0) X(13, -3, -1) X(14, -2, -2) X(15, -1, -3)

// bit k of a ring mask, kept doubled so that a cyclic run is a linear one
#define RING_BIT(k) (0x10001u << (k))

// Run of >= 9 set bits on the 16-bit ring, from the doubled mask: after the
// first three steps bit i says that bits i..i+7 are set.
__device__ __forceinline__ bool arc9(uint32_t m) {
  uint32_t x = m & (m >> 1);
  x &= x >> 2;
  x &= x >> 4;
  return (x & (m >> 8)) != 0u;
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
fast_nms_pyramid_kernel(const __grid_constant__ Pyramid P) {
  __shared__ float simg[IMG_H * IMG_W];
  __shared__ float ssc[SC_H * SC_W];
  __shared__ uint16_t queue[SC_H * SC_W];
  __shared__ int queue_len;
  if (threadIdx.x == 0) queue_len = 0;

  int l = 0;
  while (l + 1 < P.n_levels && (int)blockIdx.x >= P.lv[l + 1].first_block) ++l;
  const int H = P.lv[l].H, W = P.lv[l].W;
  int b = (int)blockIdx.x - P.lv[l].first_block;
  const int cam = b / P.lv[l].tiles_per_cam;
  b -= cam * P.lv[l].tiles_per_cam;
  const int by = b / P.lv[l].tiles_x;
  const int bx = b - by * P.lv[l].tiles_x;
  const size_t base = (size_t)cam * (size_t)H * (size_t)W;
  const float* __restrict__ im = P.lv[l].img + base;
  float* __restrict__ s_out = P.lv[l].s + base;
  float* __restrict__ sad_out = P.lv[l].sad + base;
  const float th_hi = P.th_hi, th_lo = P.th_lo;
  const int oy = by * TILE_H, ox = bx * TILE_W;   // the tile's first pixel
  const int tid = threadIdx.x;

  // image region: tile + ring + circle radius, zero outside the image;
  // a warp to a row
  {
    const int lane = tid & 31;
    for (int r = tid >> 5; r < IMG_H; r += THREADS / 32) {
      const int y = oy - 1 - RADIUS + r;
      const bool row_in = y >= 0 && y < H;
#pragma unroll
      for (int j = 0; j < (IMG_W + 31) / 32; ++j) {
        const int c = lane + 32 * j;
        const int x = ox - 1 - RADIUS + c;
        if (c < IMG_W) {
          simg[r * IMG_W + c] =
              (row_in && x >= 0 && x < W) ? im[(size_t)y * W + x] : 0.0f;
        }
      }
    }
  }
  __syncthreads();

  // score position (r, c) of the region is pixel (oy - 1 + r, ox - 1 + c)
  const int c = tid & (SC_W - 1);
  const int r0 = tid / SC_W;
  const int x = ox - 1 + c;
  const bool col_in = x >= 0 && x < W;
  const bool own_col = c >= 1 && c <= TILE_W && x < W;

  // low-threshold score on the tile + ring, sad_lo for the tile itself;
  // positions with a low arc are queued for the high threshold.  A ring
  // cannot hold a bright and a dark arc of 9 at once, so one bit of the
  // entry says which polarity to test.
  const int lane = tid & 31;
#pragma unroll 2
  for (int j = 0; j < PASSES; ++j) {
    const int r = r0 + j * ROWS_PER_PASS;
    const int y = oy - 1 + r;
    float s = 0.0f;
    bool arc_b = false, arc_d = false;
    if (col_in && y >= 0 && y < H) {
      const float* ctr = simg + (r + RADIUS) * IMG_W + (c + RADIUS);
      const float p = ctr[0];
      uint32_t ring_b = 0u, ring_d = 0u;
      float sbl = 0.0f, sdl = 0.0f;
#define LO_STEP(k, dx, dy)                                             \
  {                                                                    \
    const float d = ctr[(dy) * IMG_W + (dx)] - p;                      \
    if (d > th_lo) { sbl += d - th_lo; ring_b |= RING_BIT(k); }        \
    if (d < -th_lo) { sdl += -d - th_lo; ring_d |= RING_BIT(k); }      \
  }
      FAST_CIRCLE(LO_STEP)
#undef LO_STEP
      arc_b = arc9(ring_b);
      arc_d = arc9(ring_d);
      s = arc_b ? sbl : (arc_d ? sdl : 0.0f);
      if (own_col && r >= 1 && r <= TILE_H) {
        sad_out[(size_t)y * W + x] = sbl + sdl;
      }
    }
    const int pos = r * SC_W + c;
    ssc[pos] = s;
    // every lane of the warp is here: one shared atomic per warp
    const bool need = arc_b | arc_d;
    const uint32_t vote = __ballot_sync(0xffffffffu, need);
    if (vote != 0u) {
      int first = 0;
      if (lane == 0) first = atomicAdd(&queue_len, __popc(vote));
      first = __shfl_sync(0xffffffffu, first, 0);
      if (need) {
        queue[first + __popc(vote & ((1u << lane) - 1u))] =
            (uint16_t)(pos | (arc_d ? QUEUE_DARK : 0));
      }
    }
  }
  __syncthreads();

  // the high threshold, densely over the queue: with the differences
  // negated for a dark arc, both polarities are the same test.  Where a
  // high arc exists its score (+ bonus) replaces the low one.
  const int n_queued = queue_len;
  for (int i = tid; i < n_queued; i += THREADS) {
    const int e = queue[i];
    const int pos = e & (QUEUE_DARK - 1);
    const float sign = (e & QUEUE_DARK) ? -1.0f : 1.0f;
    const float* ctr =
        simg + ((pos / SC_W) + RADIUS) * IMG_W + ((pos & (SC_W - 1)) + RADIUS);
    const float p = ctr[0];
    uint32_t ring_h = 0u;
    float sh = 0.0f;
#define HI_STEP(k, dx, dy)                                             \
  {                                                                    \
    const float d = sign * (ctr[(dy) * IMG_W + (dx)] - p);             \
    if (d > th_hi) { sh += d - th_hi; ring_h |= RING_BIT(k); }         \
  }
    FAST_CIRCLE(HI_STEP)
#undef HI_STEP
    if (arc9(ring_h) && sh > 0.0f) ssc[pos] = sh + NMS_BONUS;
  }
  __syncthreads();

  // 3x3 NMS: keep a pixel if it is >= its neighbourhood's max
  if (own_col) {
#pragma unroll 2
    for (int j = 0; j < PASSES; ++j) {
      const int r = r0 + j * ROWS_PER_PASS;
      const int y = oy - 1 + r;
      if (r >= 1 && r <= TILE_H && y < H) {
        const float* q = ssc + r * SC_W + c;
        const float center = q[0];
        float m = fmaxf(fmaxf(q[-SC_W - 1], q[-SC_W]), q[-SC_W + 1]);
        m = fmaxf(m, fmaxf(q[-1], q[1]));
        m = fmaxf(m, fmaxf(fmaxf(q[SC_W - 1], q[SC_W]), q[SC_W + 1]));
        s_out[(size_t)y * W + x] = center >= m ? center : 0.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// One launch on `stream` over n_levels contiguous f32 batches
// [ncam[l], H[l], W[l]]; outputs are preallocated with the same shapes.
// Requires th_hi >= th_lo >= 0.  Returns cudaGetLastError() after the launch.
int fast_nms_levels_f32(int n_levels, const void* const* img,
                        void* const* s_out, void* const* sad_out,
                        const int* ncam, const int* H, const int* W,
                        float th_hi, float th_lo, void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || !(th_hi >= th_lo) ||
      !(th_lo >= 0.0f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Pyramid P = {};
  P.n_levels = n_levels;
  P.th_hi = th_hi;
  P.th_lo = th_lo;
  long long blocks = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (ncam[l] < 1 || H[l] < 1 || W[l] < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Level& L = P.lv[l];
    L.img = static_cast<const float*>(img[l]);
    L.s = static_cast<float*>(s_out[l]);
    L.sad = static_cast<float*>(sad_out[l]);
    L.H = H[l];
    L.W = W[l];
    L.tiles_x = (W[l] + TILE_W - 1) / TILE_W;
    L.tiles_per_cam = L.tiles_x * ((H[l] + TILE_H - 1) / TILE_H);
    L.first_block = static_cast<int>(blocks);
    blocks += (long long)ncam[l] * L.tiles_per_cam;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  fast_nms_pyramid_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

// Most levels one launch takes.
int fast_nms_max_levels() { return MAX_LEVELS; }

const char* kernels_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

}  // extern "C"

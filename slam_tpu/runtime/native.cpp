// slam_tpu native runtime: the host-side components that surround the
// device compute path.
//
// The reference delegates its native work to OpenCV/GTSAM through Python
// bindings (SURVEY.md §2.3); in this framework the *compute* went to
// JAX/XLA, and the host runtime pieces that remain sequential or IO-bound
// are implemented here:
//
//   1. build_tracks  — the track-id chaining pass of the track store
//      (the one inherently sequential step of the frontend; replaces the
//      reference's per-match Python dict bookkeeping,
//      tracking_database.py:273-337).
//   2. load_png_gray — libpng grayscale decode straight into a float32
//      [0,1] block (the reference round-trips through cv2.imread,
//      Inputs.py:8-19).
//   3. loader_*      — a double-buffered background prefetcher that
//      decodes the next stereo chunk on worker threads while the
//      device processes the current one.
//
// Built as a plain shared library; bound via ctypes (no pybind11 in the
// image).

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// 1. track-id chaining
// ---------------------------------------------------------------------------
//
// For each frame f>=1 and current slot j with an inlier match to previous
// slot i = match_prev[f*K + j]: extend the previous slot's track, or issue
// a fresh id covering both frames. track_ids must be pre-filled with -1.
// Returns the number of tracks issued.
int32_t build_tracks(int32_t F, int32_t K, const int32_t* match_prev,
                     const uint8_t* inlier_prev, int32_t* track_ids) {
  int32_t next_track = 0;
  for (int32_t f = 1; f < F; ++f) {
    const int32_t* m = match_prev + (size_t)f * K;
    const uint8_t* inl = inlier_prev + (size_t)f * K;
    int32_t* prev_row = track_ids + (size_t)(f - 1) * K;
    int32_t* cur_row = track_ids + (size_t)f * K;
    for (int32_t j = 0; j < K; ++j) {
      if (!inl[j]) continue;
      int32_t i = m[j];
      if (i < 0 || i >= K) continue;
      int32_t tid = prev_row[i];
      if (tid < 0) {
        tid = next_track++;
        prev_row[i] = tid;
      }
      cur_row[j] = tid;
    }
  }
  return next_track;
}

// ---------------------------------------------------------------------------
// 2. PNG decode
// ---------------------------------------------------------------------------

// Decode an 8/16-bit PNG to grayscale float32 in [0,1]. Returns 0 on
// success. out must hold max_h*max_w floats; *h/*w receive actual size.
int load_png_gray(const char* path, float* out, int32_t* h, int32_t* w,
                  int32_t max_h, int32_t max_w) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return 1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    fclose(fp);
    return 2;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 3;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 W = png_get_image_width(png, info);
  png_uint_32 H = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  if ((int32_t)H > max_h || (int32_t)W > max_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return 4;
  }
  // normalize to 8-bit gray
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (depth == 16) png_set_strip_16(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  std::vector<uint8_t> rowbuf((size_t)W);
  const float inv = 1.0f / 255.0f;
  for (png_uint_32 y = 0; y < H; ++y) {
    png_read_row(png, rowbuf.data(), nullptr);
    float* dst = out + (size_t)y * W;
    for (png_uint_32 x = 0; x < W; ++x) dst[x] = rowbuf[x] * inv;
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  *h = (int32_t)H;
  *w = (int32_t)W;
  return 0;
}

// Decode into a fixed (H, W) row-major buffer, edge-replicate-padding
// bottom/right when the image is smaller (the bucket-padding semantics of
// utils/kitti.pad_to_bucket, so multi-resolution sequence batches can ride
// the prefetcher). The image must not exceed (H, W). Returns 0 on success.
int load_png_gray_padded(const char* path, float* out, int32_t H, int32_t W) {
  std::vector<float> tmp((size_t)H * W);
  int32_t h = 0, w = 0;
  int rc = load_png_gray(path, tmp.data(), &h, &w, H, W);
  if (rc != 0) return rc;
  if (h <= 0 || w <= 0) return 5;
  for (int32_t y = 0; y < H; ++y) {
    int32_t sy = y < h ? y : h - 1;
    const float* src = tmp.data() + (size_t)sy * w;
    float* dst = out + (size_t)y * W;
    memcpy(dst, src, (size_t)w * sizeof(float));
    for (int32_t x = w; x < W; ++x) dst[x] = src[w - 1];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// 3. background stereo-chunk prefetcher
// ---------------------------------------------------------------------------

struct Loader {
  std::vector<std::string> left, right;
  int32_t H = 0, W = 0, chunk = 0;
  int n_threads = 2;

  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  // each queued chunk: (valid frame count, 2*chunk*H*W floats L then R)
  std::deque<std::pair<int32_t, std::vector<float>>> ready;
  size_t next_chunk = 0, total_chunks = 0, chunks_done = 0;
  size_t max_queue = 2;
  std::atomic<bool> stop{false};

  void run() {
    while (!stop.load()) {
      size_t c;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (next_chunk >= total_chunks) break;
        cv_space.wait(lk, [&] { return ready.size() < max_queue || stop; });
        if (stop.load()) break;
        c = next_chunk++;
      }
      size_t start = c * chunk;
      size_t n = std::min((size_t)chunk, left.size() - start);
      std::vector<float> buf((size_t)2 * chunk * H * W, 0.0f);
      // decode with a small thread pool (frames are independent)
      std::atomic<size_t> idx{0};
      auto decode_some = [&]() {
        size_t k;
        while ((k = idx.fetch_add(1)) < 2 * n) {
          size_t f = k / 2;
          bool is_right = k % 2;
          const std::string& p =
              is_right ? right[start + f] : left[start + f];
          float* dst = buf.data() +
                       ((is_right ? (size_t)chunk : 0) + f) * (size_t)H * W;
          // smaller images are edge-replicate-padded to (H, W) — the
          // bucket semantics multi-resolution batches rely on; decode
          // failures blank the frame.
          int rc = load_png_gray_padded(p.c_str(), dst, H, W);
          if (rc != 0) memset(dst, 0, (size_t)H * W * sizeof(float));
        }
      };
      std::vector<std::thread> pool;
      for (int t = 1; t < n_threads; ++t) pool.emplace_back(decode_some);
      decode_some();
      for (auto& t : pool) t.join();
      {
        std::lock_guard<std::mutex> lk(mu);
        ready.emplace_back((int32_t)n, std::move(buf));
        ++chunks_done;
      }
      cv_ready.notify_one();
    }
    cv_ready.notify_all();  // wake any consumer waiting at end-of-stream
  }
};

void* loader_create(const char** left_paths, const char** right_paths,
                    int32_t num_frames, int32_t H, int32_t W, int32_t chunk,
                    int32_t n_threads) {
  Loader* L = new Loader();
  L->left.assign(left_paths, left_paths + num_frames);
  L->right.assign(right_paths, right_paths + num_frames);
  L->H = H;
  L->W = W;
  L->chunk = chunk;
  L->n_threads = n_threads > 0 ? n_threads : 2;
  L->total_chunks = (num_frames + chunk - 1) / chunk;
  L->worker = std::thread([L] { L->run(); });
  return L;
}

// Blocks until the next chunk is decoded; copies into out_left/out_right
// (each chunk*H*W floats). Returns the number of valid frames, 0 at end.
int32_t loader_next(void* handle, float* out_left, float* out_right) {
  Loader* L = (Loader*)handle;
  int32_t n = 0;
  std::vector<float> buf;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] {
      return !L->ready.empty() || L->chunks_done >= L->total_chunks ||
             L->stop;
    });
    if (L->ready.empty()) return 0;
    n = L->ready.front().first;
    buf = std::move(L->ready.front().second);
    L->ready.pop_front();
  }
  L->cv_space.notify_one();
  size_t plane = (size_t)L->chunk * L->H * L->W;
  memcpy(out_left, buf.data(), plane * sizeof(float));
  memcpy(out_right, buf.data() + plane, plane * sizeof(float));
  return n;  // valid frames in this chunk (tail chunks are partial)
}

void loader_destroy(void* handle) {
  Loader* L = (Loader*)handle;
  L->stop.store(true);
  L->cv_space.notify_all();
  L->cv_ready.notify_all();
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"

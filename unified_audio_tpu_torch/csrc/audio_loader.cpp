// Native audio loader: multi-threaded WAV decoding + prefetch ring buffer.
//
// The port's own copy of the repository's csrc/audio_loader.cpp. Decoding
// and the prefetch loop run on C++ worker threads, outside the GIL, so the
// host keeps the card's input pipeline fed; Python binds it through ctypes
// (unified_audio_tpu_torch/data/native_loader.py), which builds it with g++
// into build/kernels/ at first use.
//
// C API (all functions exported with C linkage):
//   loader_create(paths, n_paths, crop_len, batch, workers, capacity, seed)
//   loader_next(handle, out_float_buffer)  -> 1 on success, 0 on shutdown
//   loader_destroy(handle)
//   wav_read(path, out_buf, max_len, out_sr) -> samples read (or -1)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct WavData {
  std::vector<float> samples;  // first channel only
  int sample_rate = 0;
};

// Minimal RIFF/WAVE parser: PCM16/24/32 + float32, first channel.
bool read_wav_file(const char* path, WavData* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  char riff[12];
  if (std::fread(riff, 1, 12, f) != 12 || std::memcmp(riff, "RIFF", 4) ||
      std::memcmp(riff + 8, "WAVE", 4)) {
    std::fclose(f);
    return false;
  }
  uint16_t audio_format = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  std::vector<uint8_t> data;
  while (true) {
    char cid[4];
    uint32_t size;
    if (std::fread(cid, 1, 4, f) != 4) break;
    if (std::fread(&size, 4, 1, f) != 1) break;
    if (!std::memcmp(cid, "fmt ", 4)) {
      std::vector<uint8_t> fmt(size);
      if (std::fread(fmt.data(), 1, size, f) != size) break;
      audio_format = fmt[0] | (fmt[1] << 8);
      channels = fmt[2] | (fmt[3] << 8);
      std::memcpy(&rate, fmt.data() + 4, 4);
      bits = fmt[14] | (fmt[15] << 8);
    } else if (!std::memcmp(cid, "data", 4)) {
      data.resize(size);
      if (std::fread(data.data(), 1, size, f) != size) break;
    } else {
      std::fseek(f, size + (size & 1), SEEK_CUR);
    }
    if (size & 1 && std::memcmp(cid, "data", 4)) continue;
  }
  std::fclose(f);
  if (!channels || data.empty()) return false;

  const size_t bytes_per = bits / 8;
  const size_t frames = data.size() / (bytes_per * channels);
  out->sample_rate = static_cast<int>(rate);
  out->samples.resize(frames);
  const uint8_t* p = data.data();
  for (size_t i = 0; i < frames; ++i) {
    const uint8_t* s = p + i * bytes_per * channels;  // channel 0
    float v = 0.f;
    if (audio_format == 3 && bits == 32) {
      std::memcpy(&v, s, 4);
    } else if (bits == 16) {
      int16_t x;
      std::memcpy(&x, s, 2);
      v = static_cast<float>(x) / 32768.f;
    } else if (bits == 32) {
      int32_t x;
      std::memcpy(&x, s, 4);
      v = static_cast<float>(x) / 2147483648.f;
    } else if (bits == 24) {
      int32_t x = s[0] | (s[1] << 8) | (s[2] << 16);
      if (x >= (1 << 23)) x -= (1 << 24);
      v = static_cast<float>(x) / static_cast<float>(1 << 23);
    } else {
      return false;
    }
    out->samples[i] = v;
  }
  return true;
}

struct Loader {
  std::vector<std::string> paths;
  int crop_len;
  int batch;
  int capacity;
  std::vector<std::thread> workers;
  std::queue<std::vector<float>> ready;  // each entry: batch*crop_len floats
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> seed{0};

  void worker_loop(uint64_t wseed) {
    std::mt19937_64 rng(wseed);
    while (!stop.load()) {
      std::vector<float> batch_buf(
          static_cast<size_t>(batch) * crop_len, 0.f);
      for (int b = 0; b < batch; ++b) {
        WavData wav;
        // retry-on-failure like the reference loader
        for (int attempt = 0; attempt < 5; ++attempt) {
          const auto& path = paths[rng() % paths.size()];
          if (read_wav_file(path.c_str(), &wav) && !wav.samples.empty()) break;
          wav.samples.clear();
        }
        if (wav.samples.empty()) continue;
        float* dst = batch_buf.data() + static_cast<size_t>(b) * crop_len;
        const size_t n = wav.samples.size();
        if (n >= static_cast<size_t>(crop_len)) {
          size_t off = rng() % (n - crop_len + 1);
          std::memcpy(dst, wav.samples.data() + off,
                      sizeof(float) * crop_len);
        } else {  // wrap-pad
          for (int i = 0; i < crop_len; ++i) dst[i] = wav.samples[i % n];
        }
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_push.wait(lock, [&] {
        return stop.load() || ready.size() < static_cast<size_t>(capacity);
      });
      if (stop.load()) return;
      ready.push(std::move(batch_buf));
      cv_pop.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int crop_len, int batch,
                    int workers, int capacity, uint64_t seed) {
  auto* l = new Loader();
  l->paths.assign(paths, paths + n_paths);
  l->crop_len = crop_len;
  l->batch = batch;
  l->capacity = capacity > 0 ? capacity : 4;
  for (int w = 0; w < (workers > 0 ? workers : 2); ++w) {
    l->workers.emplace_back(&Loader::worker_loop, l, seed + 7919ull * w);
  }
  return l;
}

int loader_next(void* handle, float* out) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(l->mu);
  l->cv_pop.wait(lock, [&] { return l->stop.load() || !l->ready.empty(); });
  if (l->ready.empty()) return 0;
  auto batch_buf = std::move(l->ready.front());
  l->ready.pop();
  l->cv_push.notify_one();
  lock.unlock();
  std::memcpy(out, batch_buf.data(), batch_buf.size() * sizeof(float));
  return 1;
}

void loader_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_push.notify_all();
  l->cv_pop.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

int wav_read(const char* path, float* out, int max_len, int* out_sr) {
  WavData wav;
  if (!read_wav_file(path, &wav)) return -1;
  *out_sr = wav.sample_rate;
  int n = static_cast<int>(wav.samples.size());
  if (n > max_len) n = max_len;
  std::memcpy(out, wav.samples.data(), sizeof(float) * n);
  return n;
}

}  // extern "C"

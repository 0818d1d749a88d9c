// Host-side data loader: multi-threaded WAV decode and a bounded prefetch
// queue, a copy of the JAX package's native/dataloader.cpp (the port keeps
// its own).  Decoding and queueing run on C++ threads, outside the Python
// interpreter's lock, so feature extraction never waits on a file read.
//
// C ABI (ctypes-friendly):
//   wav_decode(bytes, len, out*, out_cap, &out_len, &sr, &channels) -> 0/err
//   dl_create(paths, n, n_threads, capacity) -> handle
//   dl_next(handle, out*, out_cap, &out_len, &sr, &channels, &index) -> 0/1 done/err<0
//   dl_destroy(handle)
//
// Built by sambert_hifigan_tpu_torch/data/native_loader.py:
//   g++ -O2 -shared -fPIC -std=c++17 -pthread dataloader.cpp -o <_build/...so>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fstream>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Decoded {
  std::vector<float> samples;  // interleaved
  int sample_rate = 0;
  int channels = 0;
  int64_t index = -1;
  bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

bool decode_wav(const uint8_t* data, size_t len, Decoded* out) {
  if (len < 44 || std::memcmp(data, "RIFF", 4) || std::memcmp(data + 8, "WAVE", 4))
    return false;
  size_t pos = 12;
  const uint8_t* fmt = nullptr;
  size_t fmt_len = 0;
  const uint8_t* body = nullptr;
  size_t body_len = 0;
  while (pos + 8 <= len) {
    const uint8_t* hdr = data + pos;
    uint32_t size = rd_u32(hdr + 4);
    const uint8_t* payload = hdr + 8;
    if (pos + 8 + size > len) size = static_cast<uint32_t>(len - pos - 8);
    if (!std::memcmp(hdr, "fmt ", 4)) {
      fmt = payload;
      fmt_len = size;
    } else if (!std::memcmp(hdr, "data", 4)) {
      body = payload;
      body_len = size;
    }
    pos += 8 + size + (size & 1);
  }
  if (!fmt || !body || fmt_len < 16) return false;
  uint16_t format = rd_u16(fmt);
  uint16_t channels = rd_u16(fmt + 2);
  uint32_t sr = rd_u32(fmt + 4);
  uint16_t bits = rd_u16(fmt + 14);
  if (format == 0xFFFE && fmt_len >= 26) format = rd_u16(fmt + 24);
  if (channels == 0) return false;

  size_t n = 0;
  std::vector<float>& s = out->samples;
  if (format == 1 && bits == 16) {
    n = body_len / 2;
    s.resize(n);
    const int16_t* p = reinterpret_cast<const int16_t*>(body);
    for (size_t i = 0; i < n; ++i) s[i] = p[i] / 32768.0f;
  } else if (format == 1 && bits == 32) {
    n = body_len / 4;
    s.resize(n);
    const int32_t* p = reinterpret_cast<const int32_t*>(body);
    for (size_t i = 0; i < n; ++i) s[i] = p[i] / 2147483648.0f;
  } else if (format == 1 && bits == 8) {
    n = body_len;
    s.resize(n);
    for (size_t i = 0; i < n; ++i) s[i] = (body[i] - 128) / 128.0f;
  } else if (format == 1 && bits == 24) {
    n = body_len / 3;
    s.resize(n);
    for (size_t i = 0; i < n; ++i) {
      int32_t v = body[3 * i] | (body[3 * i + 1] << 8) | (body[3 * i + 2] << 16);
      if (v & 0x800000) v -= 0x1000000;
      s[i] = v / 8388608.0f;
    }
  } else if (format == 3 && bits == 32) {
    n = body_len / 4;
    s.resize(n);
    std::memcpy(s.data(), body, n * 4);
  } else {
    return false;
  }
  out->sample_rate = static_cast<int>(sr);
  out->channels = channels;
  out->ok = true;
  return true;
}

struct Loader {
  std::vector<std::string> paths;
  std::vector<std::thread> workers;
  std::deque<Decoded> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t capacity;
  std::atomic<size_t> next_index{0};
  std::atomic<size_t> finished_workers{0};
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      size_t i = next_index.fetch_add(1);
      if (i >= paths.size() || stop.load()) break;
      Decoded d;
      d.index = static_cast<int64_t>(i);
      std::ifstream f(paths[i], std::ios::binary);
      if (f) {
        std::vector<uint8_t> bytes(
            (std::istreambuf_iterator<char>(f)), std::istreambuf_iterator<char>());
        decode_wav(bytes.data(), bytes.size(), &d);
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_push.wait(lock, [&] { return queue.size() < capacity || stop.load(); });
      if (stop.load()) break;
      queue.push_back(std::move(d));
      cv_pop.notify_one();
    }
    finished_workers.fetch_add(1);
    cv_pop.notify_all();
  }

  bool done_producing() {
    return finished_workers.load() == workers.size();
  }
};

}  // namespace

extern "C" {

int wav_decode(const uint8_t* data, int64_t len, float* out, int64_t out_cap,
               int64_t* out_len, int* sample_rate, int* channels) {
  Decoded d;
  if (!decode_wav(data, static_cast<size_t>(len), &d)) return -1;
  *out_len = static_cast<int64_t>(d.samples.size());
  *sample_rate = d.sample_rate;
  *channels = d.channels;
  if (out_cap < *out_len) return -2;  // caller re-calls with a bigger buffer
  std::memcpy(out, d.samples.data(), d.samples.size() * sizeof(float));
  return 0;
}

void* dl_create(const char** paths, int64_t n, int n_threads, int capacity) {
  auto* l = new Loader();
  l->paths.assign(paths, paths + n);
  l->capacity = capacity > 0 ? static_cast<size_t>(capacity) : 8;
  int threads = n_threads > 0 ? n_threads : 4;
  for (int i = 0; i < threads; ++i)
    l->workers.emplace_back([l] { l->worker(); });
  return l;
}

// Returns 0 = item written, 1 = exhausted, -2 = buffer too small (item stays
// queued; call again with out_cap >= *out_len), -1 = item failed to decode
// (skipped; call again).
int dl_next(void* handle, float* out, int64_t out_cap, int64_t* out_len,
            int* sample_rate, int* channels, int64_t* index) {
  auto* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lock(l->mu);
  l->cv_pop.wait(lock, [&] { return !l->queue.empty() || l->done_producing(); });
  if (l->queue.empty()) return 1;
  Decoded& d = l->queue.front();
  *index = d.index;
  if (!d.ok) {
    l->queue.pop_front();
    l->cv_push.notify_one();
    return -1;
  }
  *out_len = static_cast<int64_t>(d.samples.size());
  *sample_rate = d.sample_rate;
  *channels = d.channels;
  if (out_cap < *out_len) return -2;
  std::memcpy(out, d.samples.data(), d.samples.size() * sizeof(float));
  l->queue.pop_front();
  l->cv_push.notify_one();
  return 0;
}

void dl_destroy(void* handle) {
  auto* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_push.notify_all();
  l->cv_pop.notify_all();
  for (auto& t : l->workers) t.join();
  delete l;
}

}  // extern "C"

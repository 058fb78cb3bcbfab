// sdrio: native host-side IO engine for the SDR framework.
//
// Equivalent of the reference's native runtime plumbing —
// liquid's cbuffercf/cbufferf ring buffers (src/sdr_pmr446.c:467-471,
// 797-816, 903-906), the SoapySDR CF32 sample plane (src/shared.c), and the
// RtAudio handoff (src/sdr_pmr446.c:520-544) — rebuilt as a small C++
// library with a plain C ABI consumed from Python via ctypes:
//
//   * lock-free SPSC ring buffer (producer: file/SDR thread, consumer:
//     block-assembly for the device step), float32 elements (interleave IQ
//     as 2 floats per sample);
//   * IQ format converters (cu8/cs8/cs16 -> cf32) as tight vectorizable
//     loops — the hot path when feeding the device from rtl_sdr captures;
//   * a chunked capture reader that yields fixed-size blocks with remainder
//     carry (the cbuffercf role for file sources);
//   * streaming s16/f32 WAV writer (the file-side RtAudio replacement).
//
// Build: make -C native  (produces libsdrio.so)

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC ring buffer (float elements)
// ---------------------------------------------------------------------------

struct SdrRing {
  float* data;
  size_t capacity;              // in floats
  std::atomic<size_t> head;     // write index
  std::atomic<size_t> tail;     // read index
};

SdrRing* sdrio_ring_create(size_t capacity) {
  auto* r = new SdrRing();
  r->data = static_cast<float*>(malloc(capacity * sizeof(float)));
  if (!r->data) { delete r; return nullptr; }
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void sdrio_ring_destroy(SdrRing* r) {
  if (!r) return;
  free(r->data);
  delete r;
}

size_t sdrio_ring_size(const SdrRing* r) {
  size_t h = r->head.load(std::memory_order_acquire);
  size_t t = r->tail.load(std::memory_order_acquire);
  return h - t;
}

size_t sdrio_ring_space(const SdrRing* r) {
  return r->capacity - sdrio_ring_size(r);
}

// Returns number of floats written (may be < n if full).
size_t sdrio_ring_write(SdrRing* r, const float* src, size_t n) {
  size_t h = r->head.load(std::memory_order_relaxed);
  size_t t = r->tail.load(std::memory_order_acquire);
  size_t space = r->capacity - (h - t);
  if (n > space) n = space;
  size_t pos = h % r->capacity;
  size_t first = r->capacity - pos;
  if (first > n) first = n;
  memcpy(r->data + pos, src, first * sizeof(float));
  memcpy(r->data, src + first, (n - first) * sizeof(float));
  r->head.store(h + n, std::memory_order_release);
  return n;
}

// Returns number of floats read; zero-fills the shortfall if zero_fill
// (the audio-callback underrun behavior, src/sdr_pmr446.c:529-538).
size_t sdrio_ring_read(SdrRing* r, float* dst, size_t n, int zero_fill) {
  size_t t = r->tail.load(std::memory_order_relaxed);
  size_t h = r->head.load(std::memory_order_acquire);
  size_t avail = h - t;
  size_t take = n < avail ? n : avail;
  size_t pos = t % r->capacity;
  size_t first = r->capacity - pos;
  if (first > take) first = take;
  memcpy(dst, r->data + pos, first * sizeof(float));
  memcpy(dst + first, r->data, (take - first) * sizeof(float));
  r->tail.store(t + take, std::memory_order_release);
  if (zero_fill && take < n)
    memset(dst + take, 0, (n - take) * sizeof(float));
  return take;
}

// ---------------------------------------------------------------------------
// IQ format conversion (interleaved I/Q in, interleaved float32 out)
// ---------------------------------------------------------------------------

void sdrio_convert_cu8(const uint8_t* src, float* dst, size_t n_floats) {
  constexpr float kScale = 1.0f / 127.5f;
  for (size_t i = 0; i < n_floats; ++i)
    dst[i] = (static_cast<float>(src[i]) - 127.5f) * kScale;
}

void sdrio_convert_cs8(const int8_t* src, float* dst, size_t n_floats) {
  constexpr float kScale = 1.0f / 128.0f;
  for (size_t i = 0; i < n_floats; ++i)
    dst[i] = static_cast<float>(src[i]) * kScale;
}

void sdrio_convert_cs16(const int16_t* src, float* dst, size_t n_floats) {
  constexpr float kScale = 1.0f / 32768.0f;
  for (size_t i = 0; i < n_floats; ++i)
    dst[i] = static_cast<float>(src[i]) * kScale;
}

void sdrio_convert_f32_to_s16(const float* src, int16_t* dst,
                              size_t n, float gain) {
  for (size_t i = 0; i < n; ++i) {
    float v = src[i] * gain;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    dst[i] = static_cast<int16_t>(v);
  }
}

// ---------------------------------------------------------------------------
// Chunked capture reader: fixed-size cf32 blocks with remainder carry
// ---------------------------------------------------------------------------

struct SdrReader {
  FILE* f;
  int fmt;            // 0=cf32 1=cs16 2=cu8 3=cs8
  uint8_t* raw;       // staging buffer
  size_t raw_cap;
};

SdrReader* sdrio_reader_open(const char* path, int fmt) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* rd = new SdrReader();
  rd->f = f;
  rd->fmt = fmt;
  rd->raw = nullptr;
  rd->raw_cap = 0;
  return rd;
}

// Reads exactly n_samples complex samples into dst (2*n_samples floats).
// Returns samples produced; short count at EOF (tail zero-filled).
size_t sdrio_reader_read(SdrReader* rd, float* dst, size_t n_samples) {
  size_t n_floats = 2 * n_samples;
  size_t elem = rd->fmt == 0 ? 4 : (rd->fmt == 1 ? 2 : 1);
  size_t want_bytes = n_floats * elem;
  if (rd->raw_cap < want_bytes) {
    uint8_t* grown = static_cast<uint8_t*>(realloc(rd->raw, want_bytes));
    if (!grown) {  // keep the old buffer/raw_cap; report no samples
      memset(dst, 0, n_floats * sizeof(float));
      return 0;
    }
    rd->raw = grown;
    rd->raw_cap = want_bytes;
  }
  size_t got = fread(rd->raw, 1, want_bytes, rd->f);
  size_t got_floats = got / elem;
  // a file truncated mid-sample leaves an orphan I value: drop it so the
  // zero-filled region really is zero (parity with the NumPy fallback,
  // which truncates to an even element count)
  got_floats &= ~static_cast<size_t>(1);
  switch (rd->fmt) {
    case 0: memcpy(dst, rd->raw, got_floats * sizeof(float)); break;
    case 1: sdrio_convert_cs16(reinterpret_cast<int16_t*>(rd->raw), dst,
                               got_floats); break;
    case 2: sdrio_convert_cu8(rd->raw, dst, got_floats); break;
    case 3: sdrio_convert_cs8(reinterpret_cast<int8_t*>(rd->raw), dst,
                              got_floats); break;
  }
  if (got_floats < n_floats)
    memset(dst + got_floats, 0, (n_floats - got_floats) * sizeof(float));
  return got_floats / 2;
}

void sdrio_reader_close(SdrReader* rd) {
  if (!rd) return;
  fclose(rd->f);
  free(rd->raw);
  delete rd;
}

// ---------------------------------------------------------------------------
// Streaming WAV writer
// ---------------------------------------------------------------------------

struct SdrWav {
  FILE* f;
  uint64_t data_bytes;  // 64-bit: long scanner runs can pass 4 GiB
  uint32_t sample_rate;
  int s16;            // 1 = int16 PCM, 0 = float32
  int warned_4gib;
};

// RIFF sizes are uint32; cap the data chunk so 36 + data_bytes fits.
static const uint64_t kWavMaxDataBytes = 0xFFFFFFFFull - 36;

static void wav_write_header(SdrWav* w) {
  uint32_t sampwidth = w->s16 ? 2 : 4;
  uint16_t fmt_tag = w->s16 ? 1 : 3;
  uint32_t byte_rate = w->sample_rate * sampwidth;
  uint64_t db = w->data_bytes < kWavMaxDataBytes ? w->data_bytes
                                                 : kWavMaxDataBytes;
  uint32_t data_len = static_cast<uint32_t>(db);
  uint32_t riff_len = 36 + data_len;
  uint16_t block = static_cast<uint16_t>(sampwidth);
  uint16_t bits = static_cast<uint16_t>(8 * sampwidth);
  uint32_t fmt_len = 16;
  fseek(w->f, 0, SEEK_SET);
  fwrite("RIFF", 1, 4, w->f);
  fwrite(&riff_len, 4, 1, w->f);
  fwrite("WAVEfmt ", 1, 8, w->f);
  fwrite(&fmt_len, 4, 1, w->f);
  fwrite(&fmt_tag, 2, 1, w->f);
  uint16_t channels = 1;
  fwrite(&channels, 2, 1, w->f);
  fwrite(&w->sample_rate, 4, 1, w->f);
  fwrite(&byte_rate, 4, 1, w->f);
  fwrite(&block, 2, 1, w->f);
  fwrite(&bits, 2, 1, w->f);
  fwrite("data", 1, 4, w->f);
  fwrite(&data_len, 4, 1, w->f);
}

SdrWav* sdrio_wav_open(const char* path, uint32_t sample_rate, int s16) {
  FILE* f = fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new SdrWav{f, 0, sample_rate, s16, 0};
  wav_write_header(w);
  return w;
}

void sdrio_wav_write(SdrWav* w, const float* samples, size_t n) {
  size_t sampwidth = w->s16 ? 2 : 4;
  uint64_t room = w->data_bytes < kWavMaxDataBytes
                      ? (kWavMaxDataBytes - w->data_bytes) / sampwidth : 0;
  if (n > room) {  // stop at the RIFF limit instead of corrupting the header
    if (!w->warned_4gib) {
      fprintf(stderr,
              "sdrio_wav: RIFF 4 GiB limit reached; dropping samples\n");
      w->warned_4gib = 1;
    }
    n = static_cast<size_t>(room);
    if (n == 0) return;
  }
  if (w->s16) {
    int16_t buf[4096];
    size_t done = 0;
    while (done < n) {
      size_t chunk = n - done < 4096 ? n - done : 4096;
      sdrio_convert_f32_to_s16(samples + done, buf, chunk, 32767.0f);
      size_t wrote = fwrite(buf, 2, chunk, w->f);
      w->data_bytes += static_cast<uint64_t>(2 * wrote);
      if (wrote < chunk) {  // disk full/IO error: header must only claim
        fprintf(stderr, "sdrio_wav: short write (disk full?)\n");
        return;             // bytes actually on disk
      }
      done += chunk;
    }
  } else {
    size_t wrote = fwrite(samples, 4, n, w->f);
    w->data_bytes += static_cast<uint64_t>(4 * wrote);
    if (wrote < n)
      fprintf(stderr, "sdrio_wav: short write (disk full?)\n");
  }
}

void sdrio_wav_close(SdrWav* w) {
  if (!w) return;
  wav_write_header(w);      // patch sizes
  fclose(w->f);
  delete w;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multi-stream batch reader: S captures -> one [S, 2*block] float buffer
// (the host data-loader for data-parallel stream batches; worker threads
// convert formats concurrently)
// ---------------------------------------------------------------------------

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// Persistent worker pool: batch_read runs once per streamed block, so
// per-call thread create/join (tens of microseconds each at multi-GB/s
// ingest rates) is avoidable overhead — workers are created in
// sdrio_batch_open and parked on a condition variable between jobs.
struct SdrBatchReader {
  std::vector<SdrReader*> readers;
  size_t n_streams = 0;

  std::vector<std::thread> pool;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::atomic<size_t> next{0};
  size_t running = 0;           // workers still on the current job
  uint64_t job_id = 0;
  bool shutdown = false;
  float* dst = nullptr;
  size_t n_samples = 0;
  std::vector<size_t> got;
};

static void batch_worker(SdrBatchReader* b) {
  uint64_t seen = 0;
  for (;;) {
    {
      std::unique_lock<std::mutex> lk(b->mu);
      b->cv_work.wait(lk, [&] { return b->shutdown || b->job_id != seen; });
      if (b->shutdown) return;
      seen = b->job_id;
    }
    size_t stride = 2 * b->n_samples;
    size_t i;
    while ((i = b->next.fetch_add(1)) < b->n_streams) {
      b->got[i] = sdrio_reader_read(b->readers[i], b->dst + i * stride,
                                    b->n_samples);
    }
    {
      std::lock_guard<std::mutex> lk(b->mu);
      if (--b->running == 0) b->cv_done.notify_all();
    }
  }
}

SdrBatchReader* sdrio_batch_open(const char** paths, const int* fmts,
                                 size_t n_streams) {
  auto* b = new SdrBatchReader();
  b->n_streams = n_streams;
  for (size_t i = 0; i < n_streams; ++i) {
    SdrReader* r = sdrio_reader_open(paths[i], fmts[i]);
    if (!r) {
      for (auto* rr : b->readers) sdrio_reader_close(rr);
      delete b;
      return nullptr;
    }
    b->readers.push_back(r);
  }
  b->got.assign(n_streams, 0);
  unsigned hw = std::thread::hardware_concurrency();
  size_t n_workers = n_streams < (hw ? hw : 1) ? n_streams : (hw ? hw : 1);
  for (size_t w = 0; w < n_workers; ++w)
    b->pool.emplace_back(batch_worker, b);
  return b;
}

// dst: [n_streams, 2*n_samples] floats. Returns the max sample count
// produced across streams (0 = all at EOF); short streams zero-fill.
size_t sdrio_batch_read(SdrBatchReader* b, float* dst, size_t n_samples) {
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->dst = dst;
    b->n_samples = n_samples;
    std::fill(b->got.begin(), b->got.end(), 0);
    b->next.store(0);
    b->running = b->pool.size();
    ++b->job_id;
  }
  b->cv_work.notify_all();
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->cv_done.wait(lk, [&] { return b->running == 0; });
  }
  size_t mx = 0;
  for (size_t v : b->got) mx = v > mx ? v : mx;
  return mx;
}

void sdrio_batch_close(SdrBatchReader* b) {
  if (!b) return;
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->shutdown = true;
  }
  b->cv_work.notify_all();
  for (auto& t : b->pool) t.join();
  for (auto* r : b->readers) sdrio_reader_close(r);
  delete b;
}

}  // extern "C"

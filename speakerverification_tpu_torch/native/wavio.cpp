// Native WAV decode for the data pipeline (the port's own copy of the
// JAX package's native/wavio.cpp: the same C ABI, RIFF walk, clamps and
// error codes).
//
// Parse RIFF -> decode PCM to float32 mono. Doing the decode in C++ keeps
// Python threads free of the per-sample work (numpy can't fuse 24-bit
// unpacking), and ctypes releases the GIL for the whole call.
//
// Supported: PCM 16/24/32-bit and IEEE float32/float64, any channel count
// (averaged to mono), RIFF chunk walking (LIST/fact/bext skipped).
//
// Built at first use by ops/_build.py (g++ -O3 -std=c++17 -fPIC -shared)
// into the package's _build/ directory, and loaded by data/wavio.py.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

struct WavFormat {
  uint16_t audio_format = 0;   // 1 = PCM, 3 = IEEE float, 0xFFFE = extensible
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits_per_sample = 0;
};

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrUnsupported = -3;
constexpr int kErrRead = -4;

struct Reader {
  FILE* f = nullptr;
  ~Reader() { if (f) fclose(f); }
};

bool read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n;
}

// Walk RIFF chunks to the fmt and data chunks. On success, file position
// is at the start of sample data and *data_bytes holds its size.
int parse_header(FILE* f, WavFormat* fmt, uint64_t* data_bytes) {
  char tag[4];
  uint32_t riff_size;
  if (!read_exact(f, tag, 4) || memcmp(tag, "RIFF", 4) != 0) return kErrFormat;
  if (!read_exact(f, &riff_size, 4)) return kErrFormat;
  if (!read_exact(f, tag, 4) || memcmp(tag, "WAVE", 4) != 0) return kErrFormat;

  bool have_fmt = false;
  while (read_exact(f, tag, 4)) {
    uint32_t chunk_size;
    if (!read_exact(f, &chunk_size, 4)) return kErrFormat;
    if (memcmp(tag, "fmt ", 4) == 0) {
      uint8_t buf[40] = {0};
      size_t take = chunk_size < sizeof(buf) ? chunk_size : sizeof(buf);
      if (!read_exact(f, buf, take)) return kErrFormat;
      if (chunk_size > take && fseek(f, chunk_size - take, SEEK_CUR) != 0)
        return kErrFormat;
      memcpy(&fmt->audio_format, buf + 0, 2);
      memcpy(&fmt->channels, buf + 2, 2);
      memcpy(&fmt->sample_rate, buf + 4, 4);
      memcpy(&fmt->bits_per_sample, buf + 14, 2);
      if (fmt->audio_format == 0xFFFE && chunk_size >= 40) {
        // WAVE_FORMAT_EXTENSIBLE: sub-format GUID's first two bytes
        memcpy(&fmt->audio_format, buf + 24, 2);
      }
      have_fmt = true;
    } else if (memcmp(tag, "data", 4) == 0) {
      if (!have_fmt) return kErrFormat;
      // Clamp to the bytes actually present: a malformed/truncated file
      // whose data chunk lies about its size must not drive callers into
      // multi-GB allocations (libsndfile clamps the same way).
      long pos = ftell(f);
      if (pos < 0 || fseek(f, 0, SEEK_END) != 0) return kErrFormat;
      long end = ftell(f);
      if (end < 0 || fseek(f, pos, SEEK_SET) != 0) return kErrFormat;
      uint64_t remain = end > pos ? static_cast<uint64_t>(end - pos) : 0;
      *data_bytes = chunk_size < remain ? chunk_size : remain;
      return kOk;
    } else {
      // skip chunk (padded to even size)
      uint32_t skip = chunk_size + (chunk_size & 1);
      if (fseek(f, skip, SEEK_CUR) != 0) return kErrFormat;
    }
  }
  return kErrFormat;
}

// Mix `want` frames of `ch` interleaved samples of `bytes` each to mono:
// each frame's samples, converted by `sample`, summed in order from 0 in
// Acc and scaled by inv_ch. One channel takes a loop without the inner
// one, which the compiler vectorizes (0 + s keeps the sum's +0 for -0).
template <typename Acc, typename Sample>
void mix(const uint8_t* p, size_t want, int ch, int bytes, float inv_ch,
         float* out, Sample sample) {
  if (ch == 1) {
    for (size_t i = 0; i < want; ++i)
      out[i] = static_cast<float>(Acc(0) + sample(p + i * bytes));
    return;
  }
  for (size_t i = 0; i < want; ++i) {
    Acc acc = 0;
    for (int c = 0; c < ch; ++c)
      acc += sample(p + (i * static_cast<size_t>(ch) + c) * bytes);
    out[i] = static_cast<float>(acc * inv_ch);
  }
}

// Decode up to max_frames frames of interleaved samples to mono float32.
int decode(FILE* f, const WavFormat& fmt, uint64_t data_bytes,
           float* out, int64_t max_frames, int64_t* decoded) {
  const int bytes_per_sample = fmt.bits_per_sample / 8;
  const int ch = fmt.channels;
  if (ch == 0 || bytes_per_sample == 0) return kErrFormat;
  const int frame_bytes = bytes_per_sample * ch;
  int64_t total = static_cast<int64_t>(data_bytes / frame_bytes);
  if (max_frames >= 0 && total > max_frames) total = max_frames;

  const float inv_ch = 1.0f / ch;
  // Byte-bounded staging buffer: a 65535-channel header must not force a
  // multi-GB allocation (16384 frames × 64-bit × 65535 ch ≈ 8.6 GB). It
  // holds at most the frames to decode: the JAX package's copy allocates
  // and zero-fills all 4 MiB for every file, which costs more than the
  // decode of a short one.
  constexpr size_t kBufBytes = 1 << 22;  // 4 MiB
  size_t buf_frames = kBufBytes / static_cast<size_t>(frame_bytes);
  if (buf_frames == 0) buf_frames = 1;
  if (static_cast<int64_t>(buf_frames) > total)
    buf_frames = static_cast<size_t>(total);
  std::vector<uint8_t> buf(buf_frames * static_cast<size_t>(frame_bytes));

  int64_t done = 0;
  while (done < total) {
    size_t want = static_cast<size_t>(
        total - done < static_cast<int64_t>(buf_frames) ? total - done
                                                        : buf_frames);
    if (!read_exact(f, buf.data(), want * frame_bytes)) return kErrRead;
    const uint8_t* p = buf.data();
    float* o = out + done;
    switch (fmt.bits_per_sample) {
      case 16: {
        if (fmt.audio_format != 1) return kErrUnsupported;
        mix<float>(p, want, ch, 2, inv_ch, o, [](const uint8_t* s) {
          int16_t v;
          memcpy(&v, s, 2);
          return v * (1.0f / 32768.0f);
        });
        break;
      }
      case 24: {
        if (fmt.audio_format != 1) return kErrUnsupported;
        mix<float>(p, want, ch, 3, inv_ch, o, [](const uint8_t* s) {
          int32_t v = (s[0] << 8) | (s[1] << 16) |
                      (static_cast<int32_t>(static_cast<int8_t>(s[2])) << 24);
          return (v >> 8) * (1.0f / 8388608.0f);
        });
        break;
      }
      case 32: {
        if (fmt.audio_format == 1) {
          mix<float>(p, want, ch, 4, inv_ch, o, [](const uint8_t* s) {
            int32_t v;
            memcpy(&v, s, 4);
            return v * (1.0f / 2147483648.0f);
          });
        } else if (fmt.audio_format == 3) {
          mix<float>(p, want, ch, 4, inv_ch, o, [](const uint8_t* s) {
            float v;
            memcpy(&v, s, 4);
            return v;
          });
        } else {
          return kErrUnsupported;
        }
        break;
      }
      case 64: {
        if (fmt.audio_format != 3) return kErrUnsupported;
        mix<double>(p, want, ch, 8, inv_ch, o, [](const uint8_t* s) {
          double v;
          memcpy(&v, s, 8);
          return v;
        });
        break;
      }
      default:
        return kErrUnsupported;
    }
    done += want;
  }
  *decoded = done;
  return kOk;
}

}  // namespace

extern "C" {

// NOTE: every entry point catches all C++ exceptions (std::bad_alloc from
// the decode buffers on pathological inputs) — an exception crossing the
// ctypes ABI would std::terminate the host Python process.

// Query sample rate / frame count / channels without decoding.
int sv_wav_info(const char* path, int* sample_rate, int64_t* num_frames,
                int* channels) try {
  Reader r;
  r.f = fopen(path, "rb");
  if (!r.f) return kErrOpen;
  WavFormat fmt;
  uint64_t data_bytes = 0;
  int rc = parse_header(r.f, &fmt, &data_bytes);
  if (rc != kOk) return rc;
  // bits_per_sample < 8 gives a zero frame size: refuse it before the
  // division (the JAX package's copy divides by zero on such headers)
  if (fmt.channels == 0 || fmt.bits_per_sample / 8 == 0) return kErrFormat;
  *sample_rate = static_cast<int>(fmt.sample_rate);
  *channels = fmt.channels;
  *num_frames = static_cast<int64_t>(
      data_bytes / (fmt.channels * (fmt.bits_per_sample / 8)));
  return kOk;
} catch (...) {
  return kErrRead;
}

// Decode whole file (or first max_frames) to mono float32.
// Returns number of frames decoded, or a negative error code.
int64_t sv_wav_read(const char* path, float* out, int64_t max_frames,
                    int* sample_rate) try {
  Reader r;
  r.f = fopen(path, "rb");
  if (!r.f) return kErrOpen;
  WavFormat fmt;
  uint64_t data_bytes = 0;
  int rc = parse_header(r.f, &fmt, &data_bytes);
  if (rc != kOk) return rc;
  *sample_rate = static_cast<int>(fmt.sample_rate);
  int64_t decoded = 0;
  rc = decode(r.f, fmt, data_bytes, out, max_frames, &decoded);
  if (rc != kOk) return rc;
  return decoded;
} catch (...) {
  return kErrRead;
}

}  // extern "C"

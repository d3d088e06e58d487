// ctcasr_io — native data-loader core: batched wav decode + pad assembly.
//
// The reference delegated its input pipeline to tf.data's C++ runtime
// (SURVEY.md §2b row 5); this library is the equivalent first-party
// native component for the framework's loader: given a batch of wav
// paths it decodes PCM into a caller-provided, pre-padded float32
// [B, S] buffer in parallel worker threads — one C call per batch
// instead of per-utterance Python I/O (the loader's host-side hot path;
// the DSP itself runs on-device, features.py).
//
// Exposed C ABI (ctypes-friendly, see ctc_asr/data/native_io.py):
//   ctcasr_decode_batch(paths, n, max_samples, out, out_lengths,
//                       out_rates, n_threads) -> 0 on success
//   ctcasr_wav_info(path, &n_samples, &sample_rate) -> 0 on success
//
// Supported inputs (dispatched on magic bytes, extension ignored):
//   - RIFF/WAVE: PCM 8/16/24/32-bit int and 32-bit float, any channel
//     count (averaged to mono);
//   - FLAC (first-party subset decoder, flac_decode.cc) — LibriSpeech
//     ships as 16-bit 16 kHz FLAC, so manifests can point straight at
//     .flac with no external converter (no ffmpeg/sox dependency).
// Resampling stays in Python (scipy polyphase) — corpora are
// pre-converted to 16 kHz by data/generate.py, so the hot path never
// resamples.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "flac_decode.h"

namespace {

struct WavData {
  std::vector<float> samples;  // mono
  int sample_rate = 0;
  bool ok = false;
};

uint32_t rd_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}
uint16_t rd_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

// Parse an in-memory RIFF/WAVE stream fully into mono float32.
WavData decode_wav_buffer(const std::vector<uint8_t>& buf,
                          int64_t max_samples) {
  WavData out;
  const uint8_t* p = buf.data();
  if (buf.size() < 44) return out;
  if (std::memcmp(p, "RIFF", 4) != 0 || std::memcmp(p + 8, "WAVE", 4) != 0)
    return out;

  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  uint32_t data_len = 0;

  size_t off = 12;
  while (off + 8 <= buf.size()) {
    const uint8_t* ch = p + off;
    uint32_t chunk_len = rd_u32(ch + 4);
    if (std::memcmp(ch, "fmt ", 4) == 0 && chunk_len >= 16 &&
        off + 8 + chunk_len <= buf.size()) {
      fmt = rd_u16(ch + 8);
      channels = rd_u16(ch + 10);
      rate = rd_u32(ch + 12);
      bits = rd_u16(ch + 22);
      if (fmt == 0xFFFE && chunk_len >= 40)  // WAVE_FORMAT_EXTENSIBLE
        fmt = rd_u16(ch + 32);               // first 2 bytes of SubFormat
    } else if (std::memcmp(ch, "data", 4) == 0) {
      data = ch + 8;
      data_len = chunk_len;
      if (static_cast<size_t>(data - p) + data_len > buf.size())
        data_len = static_cast<uint32_t>(buf.size() - (data - p));
      break;
    }
    off += 8 + chunk_len + (chunk_len & 1);  // chunks are 2-byte aligned
  }
  if (!data || channels == 0 || rate == 0) return out;
  bool is_float = (fmt == 3);
  bool is_pcm = (fmt == 1);
  if (!is_float && !is_pcm) return out;
  if (is_float && bits != 32) return out;
  if (is_pcm && bits != 8 && bits != 16 && bits != 24 && bits != 32)
    return out;

  const int bytes_per = bits / 8;
  const int64_t frames_in_file =
      static_cast<int64_t>(data_len) / (bytes_per * channels);
  const int64_t n =
      max_samples > 0 && frames_in_file > max_samples ? max_samples
                                                      : frames_in_file;
  out.samples.resize(static_cast<size_t>(n));
  const float inv_ch = 1.0f / static_cast<float>(channels);
  for (int64_t i = 0; i < n; ++i) {
    float acc = 0.0f;
    const uint8_t* fr = data + i * bytes_per * channels;
    for (int c = 0; c < channels; ++c) {
      const uint8_t* s = fr + c * bytes_per;
      float v = 0.0f;
      if (is_float) {
        float tmp;
        std::memcpy(&tmp, s, 4);
        v = tmp;
      } else if (bits == 16) {
        int16_t tmp;
        std::memcpy(&tmp, s, 2);
        v = static_cast<float>(tmp) / 32768.0f;
      } else if (bits == 8) {  // unsigned
        v = (static_cast<float>(s[0]) - 128.0f) / 128.0f;
      } else if (bits == 24) {
        int32_t tmp = (static_cast<int32_t>(s[0]) << 8) |
                      (static_cast<int32_t>(s[1]) << 16) |
                      (static_cast<int32_t>(s[2]) << 24);
        v = static_cast<float>(tmp >> 8) / 8388608.0f;
      } else {  // 32-bit int
        int32_t tmp;
        std::memcpy(&tmp, s, 4);
        v = static_cast<float>(tmp) / 2147483648.0f;
      }
      acc += v;
    }
    out.samples[static_cast<size_t>(i)] = acc * inv_ch;
  }
  out.sample_rate = static_cast<int>(rate);
  out.ok = true;
  return out;
}

// Read a file and dispatch on magic bytes: RIFF/WAVE -> wav parser,
// fLaC -> first-party FLAC decoder (flac_decode.cc). Extension is
// ignored — LibriSpeech-shaped manifests can point straight at .flac
// files with no external converter in the pipeline.
WavData decode_audio(const char* path, int64_t max_samples) {
  WavData out;
  FILE* f = std::fopen(path, "rb");
  if (!f) return out;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize < 4) {
    std::fclose(f);
    return out;
  }
  std::vector<uint8_t> buf(static_cast<size_t>(fsize));
  if (std::fread(buf.data(), 1, buf.size(), f) != buf.size()) {
    std::fclose(f);
    return out;
  }
  std::fclose(f);

  if (std::memcmp(buf.data(), "fLaC", 4) == 0) {
    FlacData fd = flac_decode_buffer(buf.data(), buf.size(), max_samples);
    out.samples = std::move(fd.samples);
    out.sample_rate = fd.sample_rate;
    out.ok = fd.ok;
    return out;
  }
  return decode_wav_buffer(buf, max_samples);
}

}  // namespace

extern "C" {

// Decode n wavs into out[B, max_samples] (zero-padded). out_lengths[i]
// receives the decoded sample count (0 on per-file failure),
// out_rates[i] the file's sample rate. Returns the number of failures.
int ctcasr_decode_batch(const char** paths, int n, int64_t max_samples,
                        float* out, int32_t* out_lengths,
                        int32_t* out_rates, int n_threads) {
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      WavData w = decode_audio(paths[i], max_samples);
      float* dst = out + static_cast<int64_t>(i) * max_samples;
      std::memset(dst, 0, sizeof(float) * static_cast<size_t>(max_samples));
      if (!w.ok) {
        out_lengths[i] = 0;
        out_rates[i] = 0;
        failures.fetch_add(1);
        continue;
      }
      const int64_t m = static_cast<int64_t>(w.samples.size());
      std::memcpy(dst, w.samples.data(), sizeof(float) * m);
      out_lengths[i] = static_cast<int32_t>(m);
      out_rates[i] = w.sample_rate;
    }
  };
  int threads = n_threads > 0 ? n_threads : 1;
  if (threads > n) threads = n > 0 ? n : 1;
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(threads));
  for (int i = 0; i < threads; ++i) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

// Probe: sample count + rate. FLAC answers straight from the
// STREAMINFO metadata block (42 header bytes) instead of decoding
// every frame — prepare_librispeech(convert=False) calls this once per
// utterance, so the probe must be O(1), not O(full decode) (ADVICE
// r3). Falls back to a full decode when STREAMINFO reports 0 total
// samples (legal per spec) or for non-FLAC inputs.
int ctcasr_wav_info(const char* path, int64_t* n_samples,
                    int32_t* sample_rate) {
  FILE* f = std::fopen(path, "rb");
  if (f) {
    uint8_t head[42];
    size_t got = std::fread(head, 1, sizeof(head), f);
    std::fclose(f);
    if (got == sizeof(head) && std::memcmp(head, "fLaC", 4) == 0 &&
        (head[4] & 0x7F) == 0) {  // first metadata block is STREAMINFO
      // STREAMINFO layout (bits): 16 min/16 max blocksize, 24/24
      // framesize, 20 rate, 3 channels-1, 5 bps-1, 36 total samples.
      const uint8_t* si = head + 8;
      uint32_t rate = (static_cast<uint32_t>(si[10]) << 12) |
                      (static_cast<uint32_t>(si[11]) << 4) |
                      (static_cast<uint32_t>(si[12]) >> 4);
      uint64_t total = (static_cast<uint64_t>(si[13] & 0x0F) << 32) |
                       (static_cast<uint64_t>(si[14]) << 24) |
                       (static_cast<uint64_t>(si[15]) << 16) |
                       (static_cast<uint64_t>(si[16]) << 8) |
                       static_cast<uint64_t>(si[17]);
      if (rate != 0 && total != 0) {
        *n_samples = static_cast<int64_t>(total);
        *sample_rate = static_cast<int32_t>(rate);
        return 0;
      }
    }
  }
  WavData full = decode_audio(path, 0);
  if (!full.ok) return 1;
  *n_samples = static_cast<int64_t>(full.samples.size());
  *sample_rate = full.sample_rate;
  return 0;
}

}  // extern "C"

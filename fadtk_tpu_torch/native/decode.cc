// Host-side audio decoder for fadtk_tpu_torch (the port's own copy of
// fadtk_tpu/native/decode.cc, same C ABI).
//
// Decodes any container/codec FFmpeg understands (opus, mp3, flac, wav, ...)
// to interleaved float32 PCM at the file's native sample rate and channel
// count. This replaces the reference's torchaudio.load / soundfile decode step
// (reference fadtk/fad.py:149); resampling happens afterwards on the host
// (dsp/resample.py), so this library intentionally does NOT resample.
//
// C ABI, consumed from Python via ctypes (no pybind11 dependency).
//
// Build: see build.sh next to this file.

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

struct DecodeCtx {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  AVPacket* pkt = nullptr;
  AVFrame* frame = nullptr;

  ~DecodeCtx() {
    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
  }
};

}  // namespace

extern "C" {

// Decode `path` to interleaved float32.
//
// On success returns 0 and sets:
//   *out_data     malloc'd buffer of (*out_frames * *out_channels) floats,
//                 interleaved; caller frees with fadtk_free.
//   *out_channels, *out_frames, *out_sr
// On failure returns nonzero and writes a message into err.
int fadtk_decode_audio(const char* path, float** out_data, int* out_channels,
                       long long* out_frames, int* out_sr, char* err,
                       int errlen) {
  DecodeCtx c;
  int ret = avformat_open_input(&c.fmt, path, nullptr, nullptr);
  if (ret < 0) {
    char buf[256];
    av_strerror(ret, buf, sizeof(buf));
    set_err(err, errlen, std::string("open_input failed: ") + buf);
    return 1;
  }
  if (avformat_find_stream_info(c.fmt, nullptr) < 0) {
    set_err(err, errlen, "find_stream_info failed");
    return 1;
  }

  const AVCodec* codec = nullptr;
  int stream_idx =
      av_find_best_stream(c.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &codec, 0);
  if (stream_idx < 0 || !codec) {
    set_err(err, errlen, "no audio stream found");
    return 1;
  }
  AVStream* stream = c.fmt->streams[stream_idx];

  c.dec = avcodec_alloc_context3(codec);
  if (!c.dec || avcodec_parameters_to_context(c.dec, stream->codecpar) < 0) {
    set_err(err, errlen, "codec context setup failed");
    return 1;
  }
  c.dec->pkt_timebase = stream->time_base;
  if (avcodec_open2(c.dec, codec, nullptr) < 0) {
    set_err(err, errlen, "codec open failed");
    return 1;
  }

  c.pkt = av_packet_alloc();
  c.frame = av_frame_alloc();
  if (!c.pkt || !c.frame) {
    set_err(err, errlen, "alloc failed");
    return 1;
  }

  std::vector<float> samples;  // interleaved
  int channels = 0;
  int sr = 0;

  auto drain_frames = [&](bool flushing) -> int {
    while (true) {
      int r = avcodec_receive_frame(c.dec, c.frame);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) return 0;
      if (r < 0) return r;

      if (channels == 0) {
        channels = c.frame->ch_layout.nb_channels;
        sr = c.frame->sample_rate ? c.frame->sample_rate : c.dec->sample_rate;
        // Lazily create the format converter to interleaved float.
        AVChannelLayout layout;
        av_channel_layout_copy(&layout, &c.frame->ch_layout);
        if (swr_alloc_set_opts2(&c.swr, &layout, AV_SAMPLE_FMT_FLT, sr, &layout,
                                static_cast<AVSampleFormat>(c.frame->format),
                                sr, 0, nullptr) < 0 ||
            swr_init(c.swr) < 0) {
          av_channel_layout_uninit(&layout);
          return AVERROR(EINVAL);
        }
        av_channel_layout_uninit(&layout);
      }

      int n = c.frame->nb_samples;
      size_t base = samples.size();
      samples.resize(base + static_cast<size_t>(n) * channels);
      uint8_t* dst = reinterpret_cast<uint8_t*>(samples.data() + base);
      int converted =
          swr_convert(c.swr, &dst, n,
                      const_cast<const uint8_t**>(c.frame->extended_data), n);
      if (converted < 0) return converted;
      if (converted != n) {
        samples.resize(base + static_cast<size_t>(converted) * channels);
      }
      av_frame_unref(c.frame);
    }
    (void)flushing;
  };

  while (av_read_frame(c.fmt, c.pkt) >= 0) {
    if (c.pkt->stream_index == stream_idx) {
      if (avcodec_send_packet(c.dec, c.pkt) == 0) {
        if (drain_frames(false) < 0) {
          av_packet_unref(c.pkt);
          set_err(err, errlen, "decode/convert failed");
          return 1;
        }
      }
    }
    av_packet_unref(c.pkt);
  }
  // Flush the decoder.
  avcodec_send_packet(c.dec, nullptr);
  if (drain_frames(true) < 0) {
    set_err(err, errlen, "decoder flush failed");
    return 1;
  }

  if (channels == 0 || samples.empty()) {
    set_err(err, errlen, "no audio frames decoded");
    return 1;
  }

  long long frames = static_cast<long long>(samples.size()) / channels;
  float* buf = static_cast<float*>(
      std::malloc(samples.size() * sizeof(float)));
  if (!buf) {
    set_err(err, errlen, "out of memory");
    return 1;
  }
  std::memcpy(buf, samples.data(), samples.size() * sizeof(float));

  *out_data = buf;
  *out_channels = channels;
  *out_frames = frames;
  *out_sr = sr;
  return 0;
}

void fadtk_free(float* p) { std::free(p); }

}  // extern "C"

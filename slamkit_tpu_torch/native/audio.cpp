// Native audio decode for the extract-features pipeline.
//
// TPU-native replacement for the reference's torchaudio C++ I/O path
// (reference cli/extract_features.py:52-54 — torchaudio.load + resample):
// decodes any libav-supported container/codec (FLAC, WAV, MP3, OGG...),
// downmixes to mono and resamples to the target rate with libswresample,
// returning float32 PCM. Exposed to Python via ctypes (see bindings.py).
//
// Built by _build.py into <repo>/build/native/ at first use; a copy of
// slamkit_tpu/native/audio.cpp.
extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct DecodeCtx {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int stream_index = -1;

    ~DecodeCtx() {
        if (frame) av_frame_free(&frame);
        if (pkt) av_packet_free(&pkt);
        if (swr) swr_free(&swr);
        if (codec) avcodec_free_context(&codec);
        if (fmt) avformat_close_input(&fmt);
    }
};

int open_audio(DecodeCtx& ctx, const char* path) {
    if (avformat_open_input(&ctx.fmt, path, nullptr, nullptr) < 0) return -1;
    if (avformat_find_stream_info(ctx.fmt, nullptr) < 0) return -2;
    const AVCodec* dec = nullptr;
    ctx.stream_index =
        av_find_best_stream(ctx.fmt, AVMEDIA_TYPE_AUDIO, -1, -1, &dec, 0);
    if (ctx.stream_index < 0 || !dec) return -3;
    AVStream* st = ctx.fmt->streams[ctx.stream_index];
    ctx.codec = avcodec_alloc_context3(dec);
    if (!ctx.codec) return -4;
    if (avcodec_parameters_to_context(ctx.codec, st->codecpar) < 0) return -5;
    if (avcodec_open2(ctx.codec, dec, nullptr) < 0) return -6;
    ctx.pkt = av_packet_alloc();
    ctx.frame = av_frame_alloc();
    return ctx.pkt && ctx.frame ? 0 : -7;
}

int init_swr(DecodeCtx& ctx, const AVFrame* frame, int target_sr) {
    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    // MUST be zero-initialized: av_channel_layout_copy uninit()s dst first,
    // and uninit on stack garbage can av_freep a wild pointer
    AVChannelLayout in_layout = {};
    if (frame->ch_layout.nb_channels > 0) {
        av_channel_layout_copy(&in_layout, &frame->ch_layout);
    } else {
        av_channel_layout_default(&in_layout, 1);
    }
    int rc = swr_alloc_set_opts2(&ctx.swr, &mono, AV_SAMPLE_FMT_FLT, target_sr,
                                 &in_layout, (AVSampleFormat)frame->format,
                                 frame->sample_rate, 0, nullptr);
    av_channel_layout_uninit(&in_layout);
    if (rc < 0) return rc;
    return swr_init(ctx.swr);
}

int drain_swr(DecodeCtx& ctx, std::vector<float>& out) {
    // flush resampler tail
    for (;;) {
        int cap = 4096;
        size_t base = out.size();
        out.resize(base + cap);
        uint8_t* dst = reinterpret_cast<uint8_t*>(out.data() + base);
        int got = swr_convert(ctx.swr, &dst, cap, nullptr, 0);
        if (got <= 0) {
            out.resize(base);
            return got < 0 ? got : 0;
        }
        out.resize(base + got);
    }
}

}  // namespace

extern "C" {

// Decode `path` to mono float32 at target_sr. On success returns 0 and sets
// *out (malloc'd; free with sk_free) and *n_samples. Negative on error.
int sk_decode_audio(const char* path, int target_sr, float** out,
                    int64_t* n_samples) {
    DecodeCtx ctx;
    int rc = open_audio(ctx, path);
    if (rc < 0) return rc;

    std::vector<float> pcm;
    pcm.reserve(1 << 20);
    bool swr_ready = false;

    auto handle_frame = [&](AVFrame* f) -> int {
        if (!swr_ready) {
            int r = init_swr(ctx, f, target_sr);
            if (r < 0) return r;
            swr_ready = true;
        }
        int cap = swr_get_out_samples(ctx.swr, f->nb_samples) + 64;
        size_t base = pcm.size();
        pcm.resize(base + cap);
        uint8_t* dst = reinterpret_cast<uint8_t*>(pcm.data() + base);
        int got = swr_convert(ctx.swr, &dst, cap,
                              const_cast<const uint8_t**>(f->extended_data),
                              f->nb_samples);
        if (got < 0) return got;
        pcm.resize(base + got);
        return 0;
    };

    while (av_read_frame(ctx.fmt, ctx.pkt) >= 0) {
        if (ctx.pkt->stream_index == ctx.stream_index) {
            if (avcodec_send_packet(ctx.codec, ctx.pkt) == 0) {
                while (avcodec_receive_frame(ctx.codec, ctx.frame) == 0) {
                    rc = handle_frame(ctx.frame);
                    if (rc < 0) { av_packet_unref(ctx.pkt); return rc; }
                }
            }
        }
        av_packet_unref(ctx.pkt);
    }
    // flush decoder
    avcodec_send_packet(ctx.codec, nullptr);
    while (avcodec_receive_frame(ctx.codec, ctx.frame) == 0) {
        rc = handle_frame(ctx.frame);
        if (rc < 0) return rc;
    }
    if (swr_ready) {
        rc = drain_swr(ctx, pcm);
        if (rc < 0) return rc;
    }

    *n_samples = static_cast<int64_t>(pcm.size());
    *out = static_cast<float*>(std::malloc(pcm.size() * sizeof(float)));
    if (!*out) return -12;
    std::memcpy(*out, pcm.data(), pcm.size() * sizeof(float));
    return 0;
}

// Fast metadata: number of samples (at native rate) and sample rate, without
// decoding. Used for the duration-descending sort
// (reference cli/extract_features.py:34-37). Falls back to duration-based
// estimates when the container doesn't store exact frame counts.
int sk_audio_info(const char* path, int64_t* n_frames, int* sample_rate) {
    DecodeCtx ctx;
    int rc = open_audio(ctx, path);
    if (rc < 0) return rc;
    AVStream* st = ctx.fmt->streams[ctx.stream_index];
    *sample_rate = st->codecpar->sample_rate;
    if (st->nb_frames > 0 && st->codecpar->frame_size > 0) {
        *n_frames = st->nb_frames * st->codecpar->frame_size;
    } else if (st->duration > 0) {
        *n_frames = av_rescale_q(st->duration, st->time_base,
                                 AVRational{1, *sample_rate});
    } else if (ctx.fmt->duration > 0) {
        *n_frames = av_rescale(ctx.fmt->duration, *sample_rate, AV_TIME_BASE);
    } else {
        *n_frames = 0;
    }
    return 0;
}

void sk_free(float* p) { std::free(p); }

}  // extern "C"

// Streaming binary flight-log ("uavlog") — the rosbag-recording role,
// native.
//
// The reference records runs through a rosbag daemon (an explicit topic
// list, run_mpc_velocity_control.sh:120-150 of the reference) and reads
// them back with sqlite queries (src/px4/enhanced_plot_mpc_bag.py:446-530).
// The port's rollouts return whole flights as stacked tensors (saved as
// npz), but online use — long telemetry from a host control loop, or sweep
// workers appending as they fly — needs a streaming, append-only recorder
// that never holds the run in memory. This is it: a fixed-schema frame log
// with buffered appends and a zero-parse reader (frames are a flat f32
// matrix; the channel schema lives in the header).
//
// Format UAVLOG01 (little-endian):
//   magic[8] = "UAVLOG01"
//   u32 n_channels
//   per channel: u32 name_len, name bytes (no NUL), u32 width (f32 lanes)
//   frames: n_frames x total_width f32, row-major; n_frames is implied by
//   file size (crash-safe: a torn final frame is dropped on read).
//
// Exposed via ctypes; see ../io/uavlog.py, which builds it into the
// package's git-ignored _build/native/ at first use and implements the same
// format in NumPy as a fallback.
//
// Build:  g++ -O3 -shared -fPIC -o libuavlog.so uavlog.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <unistd.h>  // ftruncate

namespace {

struct Writer {
    FILE* f;
    long width;        // f32 lanes per frame
    long frames;       // frames appended so far
    long header;       // header length in bytes (frame data starts here)
};

// Parse "state:12,pos_ref:3,thrust:1" -> total width; returns -1 on any
// malformed entry. When `f` is non-null, also writes the channel table.
long parse_spec(const char* spec, FILE* f) {
    long total = 0;
    uint32_t n_channels = 0;
    const char* p = spec;
    // first pass: count channels
    for (const char* q = spec; *q;) {
        const char* colon = std::strchr(q, ':');
        if (!colon || colon == q) return -1;
        char* after = nullptr;
        long w = std::strtol(colon + 1, &after, 10);
        if (w <= 0 || after == colon + 1) return -1;
        ++n_channels;
        if (*after == ',') q = after + 1;
        else if (*after == '\0') { q = after; }
        else return -1;
    }
    if (n_channels == 0) return -1;
    if (f) {
        if (std::fwrite(&n_channels, 4, 1, f) != 1) return -1;
    }
    for (const char* q = p; *q;) {
        const char* colon = std::strchr(q, ':');
        uint32_t name_len = static_cast<uint32_t>(colon - q);
        char* after = nullptr;
        long w = std::strtol(colon + 1, &after, 10);
        if (f) {
            uint32_t w32 = static_cast<uint32_t>(w);
            if (std::fwrite(&name_len, 4, 1, f) != 1) return -1;
            if (std::fwrite(q, 1, name_len, f) != name_len) return -1;
            if (std::fwrite(&w32, 4, 1, f) != 1) return -1;
        }
        total += w;
        q = (*after == ',') ? after + 1 : after;
    }
    return total;
}

}  // namespace

extern "C" {

// Open a writer; returns an opaque handle or NULL.
void* uavlog_open_writer(const char* path, const char* spec) {
    long width = parse_spec(spec, nullptr);
    if (width <= 0) return nullptr;
    FILE* f = std::fopen(path, "wb");
    if (!f) return nullptr;
    if (std::fwrite("UAVLOG01", 1, 8, f) != 8 || parse_spec(spec, f) < 0) {
        std::fclose(f);
        std::remove(path);
        return nullptr;
    }
    Writer* w = new Writer{f, width, 0, std::ftell(f)};
    return w;
}

// Append n_frames frames (n_frames * width f32 values). Returns frames
// appended so far, or -1 on write failure. A short write (disk full,
// quota) rolls the file back to the last COMPLETE frame so a caller that
// recovers and keeps appending never leaves a torn frame in the middle —
// the read side only drops torn FINAL frames.
long uavlog_append(void* handle, const float* data, long n_frames) {
    Writer* w = static_cast<Writer*>(handle);
    if (!w || n_frames < 0) return -1;
    size_t count = static_cast<size_t>(n_frames) * w->width;
    if (count && std::fwrite(data, 4, count, w->f) != count) {
        std::fflush(w->f);
        long good = w->header + w->frames * w->width * 4;
        if (ftruncate(fileno(w->f), good) == 0) {
            std::fseek(w->f, good, SEEK_SET);
        }
        return -1;
    }
    w->frames += n_frames;
    return w->frames;
}

// Flush (durability point for long recordings). Returns 0 / -1.
long uavlog_flush(void* handle) {
    Writer* w = static_cast<Writer*>(handle);
    if (!w) return -1;
    return std::fflush(w->f) == 0 ? 0 : -1;
}

// Close and free; returns total frames written or -1.
long uavlog_close(void* handle) {
    Writer* w = static_cast<Writer*>(handle);
    if (!w) return -1;
    long frames = w->frames;
    int rc = std::fclose(w->f);
    delete w;
    return rc == 0 ? frames : -1;
}

// Read the header: fills `spec_out` ("name:width,..." NUL-terminated,
// capacity spec_cap) and returns the frame count (>= 0), or:
//   -1 cannot open, -2 bad magic/header, -3 spec buffer too small.
long uavlog_info(const char* path, char* spec_out, long spec_cap) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    char magic[8];
    if (std::fread(magic, 1, 8, f) != 8 || std::memcmp(magic, "UAVLOG01", 8)) {
        std::fclose(f);
        return -2;
    }
    uint32_t n_channels = 0;
    if (std::fread(&n_channels, 4, 1, f) != 1 || n_channels == 0 ||
        n_channels > 4096) {
        std::fclose(f);
        return -2;
    }
    long total_width = 0;
    long used = 0;
    for (uint32_t i = 0; i < n_channels; ++i) {
        uint32_t name_len = 0, width = 0;
        char name[256];
        if (std::fread(&name_len, 4, 1, f) != 1 || name_len == 0 ||
            name_len >= sizeof(name)) {
            std::fclose(f);
            return -2;
        }
        if (std::fread(name, 1, name_len, f) != name_len ||
            std::fread(&width, 4, 1, f) != 1 || width == 0) {
            std::fclose(f);
            return -2;
        }
        long need = static_cast<long>(name_len) + 14;  // name + ':' + digits + ','
        if (used + need >= spec_cap) {
            std::fclose(f);
            return -3;
        }
        if (i) spec_out[used++] = ',';
        std::memcpy(spec_out + used, name, name_len);
        used += name_len;
        used += std::snprintf(spec_out + used, spec_cap - used, ":%u", width);
        total_width += width;
    }
    spec_out[used] = '\0';
    long header_end = std::ftell(f);
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fclose(f);
    // torn final frame (crash mid-append) is dropped
    return (size - header_end) / (4 * total_width);
}

// Read up to max_frames frames into `out` (max_frames * total_width f32).
// Returns frames read or a negative error code (as uavlog_info).
long uavlog_read(const char* path, float* out, long max_frames) {
    char spec[8192];
    long frames = uavlog_info(path, spec, sizeof(spec));
    if (frames < 0) return frames;
    long width = parse_spec(spec, nullptr);
    if (width <= 0) return -2;
    if (frames > max_frames) frames = max_frames;

    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    // skip the header by walking the channel table
    std::fseek(f, 8, SEEK_SET);
    uint32_t n_channels = 0;
    if (std::fread(&n_channels, 4, 1, f) != 1) { std::fclose(f); return -2; }
    for (uint32_t i = 0; i < n_channels; ++i) {
        uint32_t name_len = 0;
        if (std::fread(&name_len, 4, 1, f) != 1) { std::fclose(f); return -2; }
        std::fseek(f, name_len + 4, SEEK_CUR);
    }
    size_t count = static_cast<size_t>(frames) * width;
    size_t got = std::fread(out, 4, count, f);
    std::fclose(f);
    return static_cast<long>(got / width);
}

}  // extern "C"

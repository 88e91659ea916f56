// Bulk <UnN> unit-string codec.
//
// prepare_tokens streams millions of jsonl lines of "<Un3><Un49>..." strings
// (reference cli/prepare_tokens.py:14-57); Python string formatting / regex is
// the hot loop there. This C++ path does both directions with raw integer
// formatting, releasing the GIL from the ctypes boundary.
//
// Built by _build.py into <repo>/build/native/ at first use; a copy of
// slamkit_tpu/native/codec.cpp.
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// units -> "<UnN><UnM>..." string. Returns malloc'd NUL-terminated buffer.
char* sk_units_to_string(const int32_t* units, int64_t n) {
    // "<Un" + up to 10 digits + ">" = 15 bytes max per unit
    char* buf = static_cast<char*>(std::malloc(static_cast<size_t>(n) * 16 + 1));
    if (!buf) return nullptr;
    char* p = buf;
    for (int64_t i = 0; i < n; ++i) {
        *p++ = '<'; *p++ = 'U'; *p++ = 'n';
        uint32_t v = static_cast<uint32_t>(units[i]);
        char tmp[12];
        int len = 0;
        do { tmp[len++] = '0' + (v % 10); v /= 10; } while (v);
        while (len) *p++ = tmp[--len];
        *p++ = '>';
    }
    *p = '\0';
    return buf;
}

// "<UnN>..." -> unit ids; any non-"<UnN>" characters are skipped (regex
// semantics of the reference's decode, unit_tokeniser.py:85-89).
// Returns malloc'd array, sets *n_out. Free with sk_codec_free.
int32_t* sk_string_to_units(const char* s, int64_t* n_out) {
    std::vector<int32_t> out;
    out.reserve(std::strlen(s) / 5 + 1);
    const char* p = s;
    while (*p) {
        if (p[0] == '<' && p[1] == 'U' && p[2] == 'n') {
            const char* q = p + 3;
            if (*q >= '0' && *q <= '9') {
                int64_t v = 0;
                while (*q >= '0' && *q <= '9') { v = v * 10 + (*q - '0'); ++q; }
                if (*q == '>') {
                    out.push_back(static_cast<int32_t>(v));
                    p = q + 1;
                    continue;
                }
            }
        }
        ++p;
    }
    *n_out = static_cast<int64_t>(out.size());
    int32_t* buf = static_cast<int32_t*>(std::malloc(out.size() * sizeof(int32_t)));
    if (buf) std::memcpy(buf, out.data(), out.size() * sizeof(int32_t));
    return buf;
}

void sk_codec_free(void* p) { std::free(p); }

}  // extern "C"

// Native Wavefront-OBJ loader — the host data-loader component
// (the reference's ReadFile role, src/data_utils.h:55-92,
// for the mesh pipeline; the Python fallback lives in accel/meshes.py).
//
// Semantics MUST match accel/meshes.load_obj exactly (the test compares
// both parsers on the same files):
//   - `v x y z` records (tokens beyond the first 3 coords ignored)
//   - `f i j k [l ...]` records, fan-triangulated (1,k,k+1)
//   - indices 1-based, or negative = relative to vertices seen SO FAR
//   - `v/vt/vn` tuples: vertex index only (the /vt/vn tail is ignored)
//   - records with too few fields are silently skipped (Python's
//     len(parts) guards), but a MALFORMED token inside a live record is
//     an ERROR — Python's float()/int() raise there, and silently
//     truncating would load different geometry depending on whether the
//     native library is available (ADVICE r3 low #2)
//   - everything else ignored
//
// Two-pass C API (caller allocates):
//   apt_obj_count(path, &n_verts, &n_tris)           -> 0 ok
//   apt_obj_load(path, verts_f64, faces_i64, nv, nt) -> 0 ok
//   nonzero: 1 = IO error / count mismatch, 2 = malformed token
// apt_obj_load re-verifies that the second pass produced exactly
// nv/nt records (the file may have changed between the passes; the
// caller's np.empty buffers must never keep uninitialized rows).
//
// Build: part of libaptnative.so (see Makefile).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Counts {
    long verts = 0;
    long tris = 0;
};

constexpr int kOk = 0;
constexpr int kIoError = 1;
constexpr int kMalformed = 2;

// Split `line` into whitespace-separated tokens (Python str.split()).
void tokenize(char* line, std::vector<char*>& toks) {
    toks.clear();
    char* p = line;
    while (*p) {
        while (*p && std::isspace(static_cast<unsigned char>(*p))) p++;
        if (!*p) break;
        toks.push_back(p);
        while (*p && !std::isspace(static_cast<unsigned char>(*p))) p++;
        if (*p) *p++ = '\0';
    }
}

// float(tok): the whole token must be consumed, like Python's float().
bool parse_f64(const char* tok, double* out) {
    char* end = nullptr;
    *out = std::strtod(tok, &end);
    return end != tok && *end == '\0';
}

// int(tok.split('/')[0]): everything before the first '/' (or the whole
// token) must be a valid integer; an empty head is malformed too.
bool parse_face_index(const char* tok, long long* out) {
    char* end = nullptr;
    long long i = std::strtoll(tok, &end, 10);
    if (end == tok) return false;
    if (*end != '\0' && *end != '/') return false;
    *out = i;
    return true;
}

// Returns kOk / kIoError / kMalformed.  When out buffers are non-null,
// fills them.  `counts` (if non-null) receives the parsed totals either
// way — apt_obj_load uses it to verify the two passes agree.
int parse(const char* path, Counts* counts, double* verts,
          long long* faces, long max_verts, long max_tris) {
    FILE* fh = std::fopen(path, "rb");
    if (!fh) return kIoError;
    char line[8192];
    long nv = 0;
    long nt = 0;
    std::vector<char*> toks;
    std::vector<long long> idx;
    while (std::fgets(line, sizeof line, fh)) {
        tokenize(line, toks);
        if (toks.empty()) continue;
        if (std::strcmp(toks[0], "v") == 0 && toks.size() >= 4) {
            double xyz[3];
            for (int k = 0; k < 3; k++) {
                if (!parse_f64(toks[1 + k], &xyz[k])) {
                    std::fclose(fh);
                    return kMalformed;  // Python float() raises here
                }
            }
            if (verts) {
                if (nv >= max_verts) { std::fclose(fh); return kIoError; }
                verts[nv * 3 + 0] = xyz[0];
                verts[nv * 3 + 1] = xyz[1];
                verts[nv * 3 + 2] = xyz[2];
            }
            nv++;
        } else if (std::strcmp(toks[0], "f") == 0 && toks.size() >= 4) {
            idx.clear();
            for (size_t k = 1; k < toks.size(); k++) {
                long long i;
                if (!parse_face_index(toks[k], &i)) {
                    std::fclose(fh);
                    return kMalformed;  // Python int() raises here
                }
                // 1-based, or negative relative to vertices so far
                idx.push_back(i > 0 ? i - 1 : nv + i);
            }
            for (size_t k = 1; k + 1 < idx.size(); k++) {
                if (faces) {
                    if (nt >= max_tris) { std::fclose(fh); return kIoError; }
                    faces[nt * 3 + 0] = idx[0];
                    faces[nt * 3 + 1] = idx[k];
                    faces[nt * 3 + 2] = idx[k + 1];
                }
                nt++;
            }
        }
    }
    std::fclose(fh);
    if (counts) {
        counts->verts = nv;
        counts->tris = nt;
    }
    return kOk;
}

}  // namespace

extern "C" {

int apt_obj_count(const char* path, long* n_verts, long* n_tris) {
    Counts c;
    int rc = parse(path, &c, nullptr, nullptr, 0, 0);
    if (rc != kOk) return rc;
    *n_verts = c.verts;
    *n_tris = c.tris;
    return 0;
}

int apt_obj_load(const char* path, double* verts, long long* faces,
                 long n_verts, long n_tris) {
    Counts c;
    int rc = parse(path, &c, verts, faces, n_verts, n_tris);
    if (rc != kOk) return rc;
    // the file may have shrunk between the count and load passes:
    // uninitialized np.empty rows must never reach the caller
    if (c.verts != n_verts || c.tris != n_tris) return kIoError;
    return 0;
}

}  // extern "C"

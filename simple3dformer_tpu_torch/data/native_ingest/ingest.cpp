// Native binvox ingest: RLE decode + xzy->xyz transpose + multithreaded
// bulk materialization of whole dataset splits into one contiguous buffer.
//
// The port's copy of simple3dformer_tpu/data/native_ingest/ingest.cpp (the
// code unchanged, built with the same flags, so both decode bit-equal).
// Rebuilds the host-side hot loop of the reference's data path
// (its utils/binvox_rw.py:117-151 read_as_3d_array, called per sample
// from data/modelnet40.py:35 inside DataLoader workers — the measured
// ingest bottleneck of the reference pipeline).
// The port decodes a dataset ONCE into a host array and stages it to
// device memory (data/pipeline.DeviceResidentDataset), so the decode is a
// startup cost, not a per-step one — but at ShapeNetV2 scale (~52k files
// of 128^3 = 2 MiB dense each) the Python/numpy per-file loop is minutes
// of wall clock. This library decodes a list of files in parallel with a
// simple atomic-counter thread pool, writing each grid directly into its
// slot of the caller-allocated [n, dx, dy, dz] uint8 output.
//
// Format (matches binvox_rw semantics exactly):
//   ASCII header:  "#binvox 1\n" / "dim dx dy dz\n" / "translate ...\n"
//                  "scale ...\n" / "data\n"
//   Payload:       (value, count) uint8 pairs, runs in x-z-y file order
//   fix_coords:    transpose file-order [x][z][y] -> [x][y][z]
//
// Error codes (negative; first failing file index reported via err_index):
//   -1 open/read failed       -2 malformed header
//   -3 dims mismatch          -4 payload length != dx*dy*dz
//   -5 odd payload byte count

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

struct Header {
    int64_t dims[3];
    size_t payload_off;  // byte offset of the first RLE pair
};

// Parse the ASCII header of a binvox file held fully in memory.
// Accepts the same inputs binvox_rw.read_header does: a "#binvox" first
// line, a "dim" line with three ints, then translate/scale/data lines
// (translate and scale are ignored here; materialization only needs the
// grid — parity with the datasets, which drop them too).
bool parse_header(const uint8_t* buf, size_t n, Header* h) {
    const char* p = reinterpret_cast<const char*>(buf);
    const char* end = p + n;
    if (n < 8 || strncmp(p, "#binvox", 7) != 0) return false;
    // walk line by line until the "data" line
    bool have_dim = false;
    while (p < end) {
        const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!nl) return false;
        if (strncmp(p, "dim ", 4) == 0) {
            long long a, b, c;
            if (sscanf(p + 4, "%lld %lld %lld", &a, &b, &c) != 3) return false;
            if (a <= 0 || b <= 0 || c <= 0) return false;
            h->dims[0] = a; h->dims[1] = b; h->dims[2] = c;
            have_dim = true;
        } else if (strncmp(p, "data", 4) == 0) {
            if (!have_dim) return false;
            h->payload_off = (nl + 1) - reinterpret_cast<const char*>(buf);
            return true;
        }
        p = nl + 1;
    }
    return false;
}

// RLE-expand payload into out, applying the [x][z][y] -> [x][y][z]
// transpose when fix_coords. Returns 0 or an error code.
//
// reshape(dims) in the reference maps flat file order onto axes
// [d0][d1][d2] = [dx][dy][dz] THEN transpose(0,2,1); so "file order" runs
// fastest over the last header dim dz, middle dy, slowest dx, and
// fix_coords swaps the two fast axes: out[(x*dz + b)*dy + a] covers flat
// file position (x*dy + a)*dz + b.
//
// The transposed path avoids any dense temp: memset the whole grid to its
// MAJORITY value (known from one cheap pass over the RLE pairs), then
// scatter only the minority runs with strided writes. Real binvox grids
// (solid fills / surface shells) have long runs and a small minority
// fraction, so this touches far less memory than expand+blocked-transpose
// (which measured only ~1.1x over numpy at 128^3; this is ~4x).
int decode_into(const uint8_t* payload, int64_t nbytes, uint8_t* out,
                int64_t dx, int64_t dy, int64_t dz, int fix_coords) {
    if (nbytes % 2 != 0) return -5;
    const int64_t total = dx * dy * dz;
    if (!fix_coords) {
        int64_t pos = 0;
        for (int64_t i = 0; i < nbytes; i += 2) {
            const uint8_t v = payload[i] ? 1 : 0;
            const int64_t run = payload[i + 1];
            if (pos + run > total) return -4;
            memset(out + pos, v, static_cast<size_t>(run));
            pos += run;
        }
        return pos == total ? 0 : -4;
    }
    // pass 1: validate coverage, count occupied
    int64_t pos = 0, ones = 0;
    for (int64_t i = 0; i < nbytes; i += 2) {
        const int64_t run = payload[i + 1];
        if (payload[i]) ones += run;
        pos += run;
    }
    if (pos != total) return -4;
    const uint8_t maj = (ones * 2 > total) ? 1 : 0;
    memset(out, maj, static_cast<size_t>(total));
    // pass 2: scatter minority runs, split at dz-row boundaries so each
    // segment is a fixed-(x, a) column of stride-dy writes
    pos = 0;
    const int64_t slab = dy * dz;
    for (int64_t i = 0; i < nbytes; i += 2) {
        const uint8_t v = payload[i] ? 1 : 0;
        int64_t run = payload[i + 1];
        if (v == maj) { pos += run; continue; }
        while (run > 0) {
            const int64_t x = pos / slab;
            const int64_t rem = pos - x * slab;
            const int64_t a = rem / dz;
            const int64_t b = rem - a * dz;
            int64_t seg = dz - b;
            if (seg > run) seg = run;
            uint8_t* base = out + x * slab + b * dy + a;
            for (int64_t k = 0; k < seg; ++k) base[k * dy] = v;
            pos += seg;
            run -= seg;
        }
    }
    return 0;
}

// Read a whole file into vec. Returns false on IO failure.
bool slurp(const char* path, std::vector<uint8_t>* vec) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return false; }
    const long sz = ftell(f);
    if (sz < 0) { fclose(f); return false; }
    if (fseek(f, 0, SEEK_SET) != 0) { fclose(f); return false; }
    vec->resize(static_cast<size_t>(sz));
    const size_t got = sz ? fread(vec->data(), 1, static_cast<size_t>(sz), f) : 0;
    fclose(f);
    return got == static_cast<size_t>(sz);
}

int decode_one_file(const char* path, uint8_t* out, int64_t dx, int64_t dy,
                    int64_t dz, int fix_coords, std::vector<uint8_t>* fbuf) {
    if (!slurp(path, fbuf)) return -1;
    Header h;
    if (!parse_header(fbuf->data(), fbuf->size(), &h)) return -2;
    if (h.dims[0] != dx || h.dims[1] != dy || h.dims[2] != dz) return -3;
    const int64_t nbytes =
        static_cast<int64_t>(fbuf->size()) - static_cast<int64_t>(h.payload_off);
    return decode_into(fbuf->data() + h.payload_off, nbytes, out, dx, dy, dz,
                       fix_coords);
}

}  // namespace

extern "C" {

// Decode one in-memory binvox file (header included) into out[dx*dy*dz].
int s3f_decode_binvox(const uint8_t* file_bytes, int64_t n, uint8_t* out,
                      int64_t dx, int64_t dy, int64_t dz, int fix_coords) {
    Header h;
    if (!parse_header(file_bytes, static_cast<size_t>(n), &h)) return -2;
    if (h.dims[0] != dx || h.dims[1] != dy || h.dims[2] != dz) return -3;
    return decode_into(file_bytes + h.payload_off, n - (int64_t)h.payload_off,
                       out, dx, dy, dz, fix_coords);
}

// Read the dims of a binvox file without decoding (for shape discovery).
int s3f_read_dims(const char* path, int64_t* dims_out) {
    std::vector<uint8_t> fbuf;
    if (!slurp(path, &fbuf)) return -1;
    Header h;
    if (!parse_header(fbuf.data(), fbuf.size(), &h)) return -2;
    dims_out[0] = h.dims[0]; dims_out[1] = h.dims[1]; dims_out[2] = h.dims[2];
    return 0;
}

// Bulk-decode n files into out[n * dx*dy*dz] with nthreads workers.
// Stops at the first error; *err_index receives the failing file's index.
int s3f_materialize(const char** paths, int64_t n, uint8_t* out, int64_t dx,
                    int64_t dy, int64_t dz, int fix_coords, int nthreads,
                    int64_t* err_index) {
    const int64_t voxels = dx * dy * dz;
    if (nthreads < 1) nthreads = 1;
    if (nthreads > n) nthreads = n > 0 ? static_cast<int>(n) : 1;
    std::atomic<int64_t> next(0);
    std::atomic<int> status(0);
    std::atomic<int64_t> bad(-1);
    auto worker = [&]() {
        std::vector<uint8_t> fbuf;
        for (;;) {
            const int64_t i = next.fetch_add(1);
            if (i >= n || status.load(std::memory_order_relaxed) != 0) return;
            const int rc = decode_one_file(paths[i], out + i * voxels, dx, dy,
                                           dz, fix_coords, &fbuf);
            if (rc != 0) {
                int expected = 0;
                if (status.compare_exchange_strong(expected, rc)) bad.store(i);
                return;
            }
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    if (err_index) *err_index = bad.load();
    return status.load();
}

}  // extern "C"

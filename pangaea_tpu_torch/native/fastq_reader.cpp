// Native FASTQ stream reader: gzip/plain, barcode extraction, 2-bit encode.
//
// TPU-native replacement for the host-side hot loop of the reference's
// C++ tools (count_kmer.cpp:186-292 does gzstream + header parse + barcode
// extraction before any counting): reads FASTQ records in bulk and emits
//   codes    (n, max_len) uint8 : A=0,C=1,T=2,G=3, 4 = N/pad/qual-masked
//            ((ascii >> 1) & 3, count_kmer.cpp:81)
//   lengths  (n,)        int32  : full read length (may exceed max_len —
//            callers re-split overlong reads host-side; linked reads are
//            short so this path is cold)
//   barcodes (n, bc_w)   char   : NUL-padded extracted barcode
//   names    (n, nm_w)   char   : NUL-padded read name
// Barcode rules mirror getBarcode (count_kmer.cpp:25-53): sticky type
// inference, BX:Z => 10x (value up to '-'), '#' => stLFR (between '#'
// and '/', "0_0_0" -> empty).
//
// C ABI only (ctypes binding in pangaea_tpu/native/__init__.py).
// Build: g++ -O3 -shared -fPIC fastq_reader.cpp -o libpangaea_io.so -lz

#include <unistd.h>
#include <zlib.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr int kBufSize = 1 << 20;

// Stream errors, sticky on the Reader and reported by pgn_error().
constexpr int kErrTruncated = 1;  // input ended inside a gzip member
constexpr int kErrCorrupt = 2;    // bad deflate data, header or trailer

// Raw z_stream inflate (~256 MB/s on this host) instead of gzread
// (~50 MB/s: its internal windowing copies dominate).
struct Reader {
    FILE* fp = nullptr;
    bool is_gz = false;
    z_stream zs{};
    unsigned char* in_buf = nullptr;  // compressed input
    char* buf = nullptr;              // decompressed output
    int buf_len = 0;
    int buf_pos = 0;
    bool eof = false;
    bool in_eof = false;
    // bytes of the current gzip member were consumed and its end
    // (Z_STREAM_END, trailer checked) has not been reached yet
    bool member_open = false;
    int error = 0;      // 0, kErrTruncated or kErrCorrupt
    int read_type = 0;  // 0 unknown, 1 = 10x, 2 = stLFR
    int min_qual = 0;   // 0 = no masking; else ASCII threshold
    std::string line;   // scratch

    // Python's gzip skips zero padding after a member's trailer; so do we.
    void skip_member_padding() {
        while (zs.avail_in > 0 && *zs.next_in == 0) {
            ++zs.next_in;
            --zs.avail_in;
        }
    }

    bool fill() {
        if (eof) return false;
        buf_pos = 0;
        if (!is_gz) {
            buf_len = static_cast<int>(fread(buf, 1, kBufSize, fp));
            if (buf_len <= 0) {
                eof = true;
                return false;
            }
            return true;
        }
        zs.next_out = reinterpret_cast<unsigned char*>(buf);
        zs.avail_out = kBufSize;
        while (zs.avail_out > 0) {
            if (zs.avail_in == 0 && !in_eof) {
                size_t got = fread(in_buf, 1, kBufSize, fp);
                if (got == 0) in_eof = true;
                zs.next_in = in_buf;
                zs.avail_in = static_cast<unsigned>(got);
            }
            if (!member_open) skip_member_padding();
            if (zs.avail_in == 0) {
                if (!in_eof) continue;
                // a clean end only right after a member's trailer
                if (member_open) error = kErrTruncated;
                break;
            }
            member_open = true;
            int ret = inflate(&zs, Z_NO_FLUSH);
            if (ret == Z_STREAM_END) {
                // concatenated gzip members (BGZF etc.): restart
                member_open = false;
                inflateReset2(&zs, 31);
            } else if (ret != Z_OK && ret != Z_BUF_ERROR) {
                error = kErrCorrupt;  // bad block, CRC or length mismatch
                break;
            }
        }
        if (error) eof = true;
        buf_len = kBufSize - static_cast<int>(zs.avail_out);
        if (buf_len <= 0) {
            eof = true;
            return false;
        }
        return true;
    }

    // next line into `line` (no trailing \n); false on EOF
    bool getline(std::string& out) {
        out.clear();
        while (true) {
            if (buf_pos >= buf_len && !fill()) return !out.empty();
            char* start = buf + buf_pos;
            char* nl = static_cast<char*>(
                memchr(start, '\n', buf_len - buf_pos));
            if (nl) {
                out.append(start, nl - start);
                buf_pos = (nl - buf) + 1;
                if (!out.empty() && out.back() == '\r') out.pop_back();
                return true;
            }
            out.append(start, buf_len - buf_pos);
            buf_pos = buf_len;
        }
    }
};

uint8_t kEnc[256];
struct EncInit {
    EncInit() {
        memset(kEnc, 4, sizeof(kEnc));
        kEnc[uint8_t('A')] = 0;
        kEnc[uint8_t('C')] = 1;
        kEnc[uint8_t('T')] = 2;
        kEnc[uint8_t('G')] = 3;
    }
} enc_init;

// getBarcode: (name, barcode) from a '@'-stripped header.
void parse_header(Reader* r, const std::string& header, std::string& name,
                  std::string& barcode) {
    if (r->read_type == 0) {
        if (header.find("BX:Z") != std::string::npos)
            r->read_type = 1;
        else if (header.find('#') != std::string::npos)
            r->read_type = 2;
    }
    name.clear();
    barcode.clear();
    if (r->read_type == 2) {
        size_t pos1 = header.find('#');
        size_t pos2 = header.find('/', pos1 + 1);
        name = header.substr(0, pos1);
        barcode = header.substr(
            pos1 + 1,
            (pos2 == std::string::npos ? header.size() : pos2) - pos1 - 1);
        if (barcode == "0_0_0") barcode.clear();
        return;
    }
    size_t end = header.find_first_of(" \r\t\n");
    name = header.substr(0, end);
    size_t pos1 = header.find("BX:Z");
    if (pos1 != std::string::npos) {
        size_t pos2 = header.find('-', pos1 + 5);
        barcode = header.substr(
            pos1 + 5,
            (pos2 == std::string::npos ? header.size() : pos2) - pos1 - 5);
    }
}

void put_str(char* dst, int width, const std::string& s) {
    int n = static_cast<int>(s.size());
    if (n > width - 1) n = width - 1;
    memcpy(dst, s.data(), n);
    memset(dst + n, 0, width - n);
}

}  // namespace

extern "C" {

void* pgn_open(const char* path, int min_qual_char) {
    FILE* fp = fopen(path, "rb");
    if (!fp) return nullptr;
    Reader* r = new Reader();
    r->fp = fp;
    r->buf = new char[kBufSize];
    r->min_qual = min_qual_char;
    // gzip magic sniff (not extension): 0x1f 0x8b
    int c1 = fgetc(fp), c2 = fgetc(fp);
    rewind(fp);
    r->is_gz = (c1 == 0x1f && c2 == 0x8b);
    if (r->is_gz) {
        r->in_buf = new unsigned char[kBufSize];
        r->zs.zalloc = Z_NULL;
        r->zs.zfree = Z_NULL;
        r->zs.opaque = Z_NULL;
        if (inflateInit2(&r->zs, 31) != Z_OK) {
            fclose(fp);
            delete[] r->buf;
            delete[] r->in_buf;
            delete r;
            return nullptr;
        }
    }
    return r;
}

void pgn_close(void* handle) {
    Reader* r = static_cast<Reader*>(handle);
    if (!r) return;
    if (r->is_gz) {
        inflateEnd(&r->zs);
        delete[] r->in_buf;
    }
    fclose(r->fp);
    delete[] r->buf;
    delete r;
}

// Read up to n records. Returns the number read (0 = EOF), or -1 when
// the gzip stream is truncated or corrupt (pgn_error says which); the
// records of that call are then not to be used.
// codes may be null (skip encoding); barcodes/names may be null.
// With a non-null lowq plane ((n, max_len) uint8), quality masking is
// REPORTED there (1 where quality < min_qual) instead of applied to the
// codes — the weighted masked sort-join needs both raw codes and the
// mask (kernels/features.py §quality-masked).
static int pgn_read_impl(void* handle, int n, int max_len, uint8_t* codes,
                         int32_t* lengths, char* barcodes, int bc_w,
                         char* names, int nm_w, uint8_t* lowq) {
    Reader* r = static_cast<Reader*>(handle);
    std::string header, seq, plus, qual, name, barcode;
    int i = 0;
    for (; i < n; ++i) {
        if (!r->getline(header)) break;
        if (!r->getline(seq)) break;
        if (!r->getline(plus)) break;
        if (!r->getline(qual)) break;
        const char* h = header.c_str();
        if (header[0] == '@') ++h;
        parse_header(r, std::string(h), name, barcode);
        int len = static_cast<int>(seq.size());
        lengths[i] = len;
        if (codes) {
            uint8_t* row = codes + static_cast<int64_t>(i) * max_len;
            int m = len < max_len ? len : max_len;
            for (int j = 0; j < m; ++j) row[j] = kEnc[uint8_t(seq[j])];
            if (r->min_qual > 0) {
                int qm = m < static_cast<int>(qual.size())
                             ? m
                             : static_cast<int>(qual.size());
                if (lowq) {
                    uint8_t* lrow =
                        lowq + static_cast<int64_t>(i) * max_len;
                    memset(lrow, 0, max_len);
                    for (int j = 0; j < qm; ++j)
                        lrow[j] = uint8_t(qual[j]) < r->min_qual;
                } else {
                    for (int j = 0; j < qm; ++j)
                        if (uint8_t(qual[j]) < r->min_qual) row[j] = 4;
                }
            } else if (lowq) {
                memset(lowq + static_cast<int64_t>(i) * max_len, 0,
                       max_len);
            }
            for (int j = m; j < max_len; ++j) row[j] = 4;
        }
        if (barcodes) put_str(barcodes + static_cast<int64_t>(i) * bc_w,
                              bc_w, barcode);
        if (names) put_str(names + static_cast<int64_t>(i) * nm_w, nm_w,
                           name);
    }
    return r->error ? -1 : i;
}

// 0, or why the stream failed: 1 = truncated gzip member, 2 = corrupt
// gzip data (a bad deflate block, header, CRC or length).
int pgn_error(void* handle) {
    return static_cast<Reader*>(handle)->error;
}

int pgn_read(void* handle, int n, int max_len, uint8_t* codes,
             int32_t* lengths, char* barcodes, int bc_w, char* names,
             int nm_w) {
    return pgn_read_impl(handle, n, max_len, codes, lengths, barcodes,
                         bc_w, names, nm_w, nullptr);
}

int pgn_read_lq(void* handle, int n, int max_len, uint8_t* codes,
                int32_t* lengths, char* barcodes, int bc_w, char* names,
                int nm_w, uint8_t* lowq) {
    return pgn_read_impl(handle, n, max_len, codes, lengths, barcodes,
                         bc_w, names, nm_w, lowq);
}

// Raw sequence fetch for overlong reads (rare path): re-reads are not
// possible on a stream, so callers that need full sequences set
// max_len large enough or use the Python fallback.

// ---------------------------------------------------------------------
// Step-0 external barcode sort converters (io/fastq.barcode_sort_*):
// stream FASTQ records to/from the NUL-joined sort-line format
// ("tag\0l1\0...\0l8\n", tag = BX:Z:<barcode> token or "~~~") consumed
// by `LANG=C sort`. C++ because the per-record Python conversion was
// the pipeline bottleneck (~26 MB/s on a 2-core host); these run at
// parse speed with 1 MiB buffered fd IO and release the GIL via ctypes.

namespace {

struct FdWriter {
    int fd;
    std::string buf;
    explicit FdWriter(int f) : fd(f) { buf.reserve(1 << 20); }
    bool flush() {
        size_t off = 0;
        while (off < buf.size()) {
            ssize_t w = write(fd, buf.data() + off, buf.size() - off);
            if (w < 0) return false;
            off += static_cast<size_t>(w);
        }
        buf.clear();
        return true;
    }
    bool put(const std::string& s) {
        buf += s;
        return buf.size() < (1 << 20) || flush();
    }
};

}  // namespace

// FASTQ(.gz) -> sort lines onto out_fd. Returns records written, -1 on
// IO error. Records with fewer than 8 lines at EOF are dropped (the
// reference's awk block loop does the same).
long long pgn_sort_feed(const char* path, int out_fd) {
    void* h = pgn_open(path, 0);
    if (!h) return -1;
    Reader* r = static_cast<Reader*>(h);
    FdWriter w(out_fd);
    std::string lines[8];
    long long n = 0;
    bool ok = true;
    while (ok) {
        int got = 0;
        for (; got < 8; ++got)
            if (!r->getline(lines[got])) break;
        if (got < 8) break;
        const std::string& header = lines[0];
        size_t p = header.find("BX:Z:");
        std::string rec;
        if (p == std::string::npos) {
            rec = "~~~";
        } else {
            size_t e = p;
            while (e < header.size() && header[e] != ' ' &&
                   header[e] != '\t' && header[e] != '\r')
                ++e;
            rec = header.substr(p, e - p);
        }
        for (int i = 0; i < 8; ++i) {
            rec += '\0';
            rec += lines[i];
        }
        rec += '\n';
        ok = w.put(rec);
        ++n;
    }
    if (r->error) ok = false;
    if (ok) ok = w.flush();
    pgn_close(h);
    return ok ? n : -1;
}

// ---- full external radix sort (the fastest backend) ------------------
//
// GNU sort moves the data ~4 times (stdin -> runs -> merge -> stdout)
// and measured 43 MB/s on the 2-core dev host. The barcode sort's key
// is the line prefix, so a classic external MSD radix sort does it in
// two sequential passes: scatter records into bucket files by the first
// 8 key bytes (buckets are ordered byte ranges, so concatenating sorted
// buckets IS the sorted stream), then load + std::sort + emit each
// bucket. A bucket larger than the memory budget recurses on the next
// 8 bytes (equal-prefix records always share a bucket, preserving
// total order). Line order == LANG=C whole-line order == the
// (tag, l1..l8) tuple order documented in io/fastq.py.

namespace {

struct Bucket {
    FILE* fp = nullptr;
    std::string path;
    long long bytes = 0;
};

// Simultaneously open bucket files per scatter level. 2-byte keys allow
// 65537 in theory; real barcode alphabets produce <= ~100. Exceeding
// the cap aborts the native sort (callers fall back to GNU sort) rather
// than running into the process fd limit.
constexpr size_t kMaxOpenBuckets = 600;
constexpr int kMaxRadixDepth = 32;

// emit one NUL-joined sort line as a FASTQ record
bool emit_line(const std::string& line, FILE* out) {
    size_t nul = line.find('\0');
    if (nul == std::string::npos) return true;  // malformed: skip
    std::string rec = line.substr(nul + 1);
    for (char& c : rec)
        if (c == '\0') c = '\n';
    rec += '\n';
    return fwrite(rec.data(), 1, rec.size(), out) == rec.size();
}

// load a bucket's lines, stable-sort them whole-line (== LANG=C order),
// emit as FASTQ.
bool radix_sort_lines(std::string& data, FILE* out) {
    std::vector<std::pair<const char*, size_t>> lines;
    size_t start = 0;
    while (start < data.size()) {
        size_t nl = data.find('\n', start);
        if (nl == std::string::npos) break;
        lines.emplace_back(data.data() + start, nl - start);
        start = nl + 1;
    }
    std::stable_sort(
        lines.begin(), lines.end(),
        [](const std::pair<const char*, size_t>& a,
           const std::pair<const char*, size_t>& b) {
            size_t n = a.second < b.second ? a.second : b.second;
            int c = memcmp(a.first, b.first, n);
            if (c) return c < 0;
            return a.second < b.second;
        });
    std::string line;
    for (auto& ln : lines) {
        line.assign(ln.first, ln.second);
        if (!emit_line(line, out)) return false;
    }
    return true;
}

struct RadixCtx {
    const char* tmp_dir;
    long long mem_limit;
    FILE* out;
    long long next_id = 0;
};

// Scatter helper: lazily opened per-key bucket files for one level.
struct ScatterSet {
    std::unordered_map<uint32_t, Bucket> buckets;
    RadixCtx* ctx;
    explicit ScatterSet(RadixCtx* c) : ctx(c) {}
    bool put(uint32_t key, const char* data, size_t len) {
        Bucket& bk = buckets[key];
        if (!bk.fp) {
            if (buckets.size() > kMaxOpenBuckets) return false;
            char path[4096];
            snprintf(path, sizeof(path), "%s/bkt_%lld_%06x", ctx->tmp_dir,
                     ctx->next_id++, key);
            bk.path = path;
            bk.fp = fopen(path, "wb");
            if (!bk.fp) return false;
            setvbuf(bk.fp, nullptr, _IOFBF, 1 << 18);
        }
        if (fwrite(data, 1, len, bk.fp) != len) return false;
        if (fputc('\n', bk.fp) == EOF) return false;
        bk.bytes += (long long)len + 1;
        return true;
    }
    std::vector<uint32_t> close_sorted() {
        std::vector<uint32_t> keys;
        keys.reserve(buckets.size());
        for (auto& kv : buckets) {
            if (kv.second.fp) fclose(kv.second.fp);
            kv.second.fp = nullptr;
            keys.push_back(kv.first);
        }
        std::sort(keys.begin(), keys.end());
        return keys;
    }
    void cleanup() {
        for (auto& kv : buckets) {
            if (kv.second.fp) fclose(kv.second.fp);
            remove(kv.second.path.c_str());
        }
    }
};

// Sort one bucket file whose lines all share their first `key_off`
// bytes: in memory when it fits the budget (or the recursion bottoms
// out), else scatter by the next 2 key bytes and recurse — the promised
// bounded-memory guarantee for few-bucket alphabets (ACGT barcodes
// yield only 16 top-level buckets). The file is consumed (removed).
bool radix_bucket_file(RadixCtx& ctx, const std::string& path,
                       long long bytes, size_t key_off, int depth) {
    if (bytes <= ctx.mem_limit || depth >= kMaxRadixDepth) {
        FILE* f = fopen(path.c_str(), "rb");
        if (!f) return false;
        std::string data;
        data.resize((size_t)bytes);
        size_t got = fread(&data[0], 1, data.size(), f);
        fclose(f);
        remove(path.c_str());
        data.resize(got);
        return radix_sort_lines(data, ctx.out);
    }
    ScatterSet sub(&ctx);
    {
        FILE* f = fopen(path.c_str(), "rb");
        if (!f) return false;
        std::string buf;
        char chunk[1 << 20];
        size_t start = 0;
        bool ok = true;
        while (ok) {
            size_t got = fread(chunk, 1, sizeof(chunk), f);
            if (got == 0) break;
            buf.append(chunk, got);
            size_t pos;
            while ((pos = buf.find('\n', start)) != std::string::npos) {
                size_t len = pos - start;
                const char* ln = buf.data() + start;
                uint8_t b0 = len > key_off ? (uint8_t)ln[key_off] : 0;
                uint8_t b1 = len > key_off + 1 ? (uint8_t)ln[key_off + 1]
                                               : 0;
                ok = sub.put(((uint32_t)b0 << 8) | b1, ln, len);
                if (!ok) break;
                start = pos + 1;
            }
            if (start > (1 << 20)) {
                buf.erase(0, start);
                start = 0;
            }
        }
        fclose(f);
        remove(path.c_str());
        if (!ok) {
            sub.cleanup();
            return false;
        }
    }
    for (uint32_t key : sub.close_sorted()) {
        Bucket& bk = sub.buckets[key];
        if (!radix_bucket_file(ctx, bk.path, bk.bytes, key_off + 2,
                               depth + 1)) {
            sub.cleanup();
            return false;
        }
    }
    return true;
}

}  // namespace

// External radix barcode sort: fastq(.gz) in_path -> sorted fastq at
// out_path, bucket spill under tmp_dir, per-bucket memory ~<= mem_limit.
// Returns records written, -1 on error.
long long pgn_sort_radix(const char* in_path, const char* out_path,
                         const char* tmp_dir, long long mem_limit) {
    void* h = pgn_open(in_path, 0);
    if (!h) return -1;
    Reader* r = static_cast<Reader*>(h);
    FILE* out = fopen(out_path, "wb");
    if (!out) {
        pgn_close(h);
        return -1;
    }

    // pass 1: scatter into buckets keyed by (region, first 2 key bytes
    // AFTER the common "BX:Z:" prefix) — line bytes [5, 7) when the line
    // starts with "BX:Z:" (every barcoded tag does), else bytes [0, 2)
    // ("~~~" sorts above "BX:Z:..." either way since '~' > 'B').
    // Ordering by (region flag, 2 bytes) is a correct coarse order for
    // whole-line comparison because all "BX:Z:" lines share the first 5
    // bytes. Pass 2 then sorts each bucket — in memory when it fits
    // mem_limit, else recursively re-scattered on the next 2 key bytes
    // (radix_bucket_file), so ACGT alphabets (only 16 top-level buckets)
    // stay within the budget too.
    RadixCtx ctx{tmp_dir, mem_limit > 0 ? mem_limit : (256LL << 20), out};
    ScatterSet top(&ctx);
    std::string lines8[8];
    long long n = 0;
    bool ok = true;
    auto put = [&](const std::string& line) {
        uint32_t key;
        if (line.compare(0, 5, "BX:Z:") == 0) {
            uint8_t b0 = line.size() > 5 ? (uint8_t)line[5] : 0;
            uint8_t b1 = line.size() > 6 ? (uint8_t)line[6] : 0;
            key = (0u << 16) | (b0 << 8) | b1;
        } else {
            uint8_t b0 = line.size() > 0 ? (uint8_t)line[0] : 0;
            uint8_t b1 = line.size() > 1 ? (uint8_t)line[1] : 0;
            key = (1u << 16) | (b0 << 8) | b1;
        }
        return top.put(key, line.data(), line.size());
    };
    while (ok) {
        int got = 0;
        for (; got < 8; ++got)
            if (!r->getline(lines8[got])) break;
        if (got < 8) break;
        const std::string& header = lines8[0];
        size_t p = header.find("BX:Z:");
        std::string rec;
        if (p == std::string::npos) {
            rec = "~~~";
        } else {
            size_t e = p;
            while (e < header.size() && header[e] != ' ' &&
                   header[e] != '\t' && header[e] != '\r')
                ++e;
            rec = header.substr(p, e - p);
        }
        for (int i = 0; i < 8; ++i) {
            rec += '\0';
            rec += lines8[i];
        }
        ok = put(rec);
        ++n;
    }
    if (r->error) ok = false;
    pgn_close(h);
    if (!ok) {
        top.cleanup();
        fclose(out);
        return -1;
    }

    // pass 2: buckets in key order; region-0 lines share bytes [0, 7)
    // ("BX:Z:" + 2 chars), region-1 lines share bytes [0, 2)
    for (uint32_t key : top.close_sorted()) {
        Bucket& bk = top.buckets[key];
        size_t key_off = (key >> 16) == 0 ? 7 : 2;
        if (!radix_bucket_file(ctx, bk.path, bk.bytes, key_off, 1)) {
            ok = false;
            break;
        }
    }
    if (!ok) top.cleanup();
    fclose(out);
    return ok ? n : -1;
}

// sort lines from in_fd -> FASTQ records appended to out_path.
// Returns records written, -1 on IO error.
long long pgn_sort_emit(int in_fd, const char* out_path) {
    FILE* out = fopen(out_path, "wb");
    if (!out) return -1;
    std::string buf;
    buf.reserve(2 << 20);
    char chunk[1 << 20];
    long long n = 0;
    bool ok = true;
    size_t start = 0;
    while (ok) {
        ssize_t got = read(in_fd, chunk, sizeof(chunk));
        if (got < 0) { ok = false; break; }
        if (got == 0) break;
        buf.append(chunk, static_cast<size_t>(got));
        size_t pos;
        while ((pos = buf.find('\n', start)) != std::string::npos) {
            // line = buf[start, pos): strip the tag (up to first NUL),
            // turn the remaining NULs into newlines
            size_t nul = buf.find('\0', start);
            if (nul != std::string::npos && nul < pos) {
                std::string rec = buf.substr(nul + 1, pos - nul - 1);
                for (char& c : rec)
                    if (c == '\0') c = '\n';
                rec += '\n';
                if (fwrite(rec.data(), 1, rec.size(), out) != rec.size()) {
                    ok = false;
                    break;
                }
                ++n;
            }
            start = pos + 1;
        }
        if (start > (1 << 20)) {
            buf.erase(0, start);
            start = 0;
        }
    }
    fclose(out);
    return ok ? n : -1;
}

// ---- bin materialization (extract_reads port) ------------------------
//
// Split reads into per-cluster bin files, replicating the reference
// binary src/cpptools/extract_reads.cpp:40-197 (and the Python port
// io/extract_reads.py, which stays as the fallback): clusters.tsv
// order, id "-1" skipped, R1 header rewritten to "@name\tBX:Z:bc-1",
// R2 passthrough on the interleaved path; both rewritten and
// name/barcode-mismatch pairs dropped on the paired path. C++ because
// the per-pair Python loop was ~10 s of the 240k-read driver bench
// (bench.py --driver-ours split) where the reference pays ~1 s.
//
// Returns 0, or -1 on an IO error or a truncated or corrupt gzip input.
long long pgn_extract_reads(const char* tsv_path, const char* out_prefix,
                            const char* in1, const char* in2,
                            int interleaved) {
    std::FILE* tsv = fopen(tsv_path, "rb");
    if (!tsv) return -1;
    // id list in tsv order + barcode -> file slot. Duplicate cluster ids
    // collapse into ONE slot (one FILE* per distinct id): two handles on
    // the same .fq path would interleave garbage through independent
    // buffers, and the Python fallback's dict-of-handles already merges
    // duplicates — the byte-compatible-fallback contract requires parity.
    std::vector<std::string> ids;
    std::unordered_map<std::string, int> bc2slot;
    std::unordered_map<std::string, int> id2slot;
    {
        std::string all;
        char tmp[1 << 16];
        size_t got;
        while ((got = fread(tmp, 1, sizeof tmp, tsv)) > 0)
            all.append(tmp, got);
        fclose(tsv);
        size_t start = 0;
        while (start < all.size()) {
            size_t nl = all.find('\n', start);
            if (nl == std::string::npos) nl = all.size();
            std::string line = all.substr(start, nl - start);
            start = nl + 1;
            if (line.empty()) continue;
            size_t tab = line.find('\t');
            std::string cid = line.substr(0, tab);
            if (cid == "-1") continue;
            int slot;
            auto known = id2slot.find(cid);
            if (known == id2slot.end()) {
                slot = static_cast<int>(ids.size());
                ids.push_back(cid);
                id2slot.emplace(cid, slot);
            } else {
                slot = known->second;
            }
            if (tab == std::string::npos) continue;
            size_t p = tab + 1;
            while (p <= line.size()) {
                size_t c = line.find(',', p);
                if (c == std::string::npos) c = line.size();
                if (c > p) bc2slot[line.substr(p, c - p)] = slot;
                p = c + 1;
            }
        }
    }
    struct Out {
        std::FILE* fq;
        std::FILE* bc;
    };
    std::vector<Out> outs;
    outs.reserve(ids.size());
    bool ok = true;
    for (const std::string& cid : ids) {
        std::string fq = std::string(out_prefix) + "_bin" + cid + ".fq";
        std::string bf = std::string(out_prefix) + "_bin" + cid +
                         ".barcode";
        Out o{fopen(fq.c_str(), "wb"), fopen(bf.c_str(), "wb")};
        if (!o.fq || !o.bc) ok = false;
        outs.push_back(o);
    }
    std::string name, barcode, rec;
    rec.reserve(1 << 12);
    if (ok && interleaved) {
        void* h = pgn_open(in1, 0);
        if (!h) ok = false;
        Reader* r = h ? static_cast<Reader*>(h) : nullptr;
        std::string l[8];
        while (ok) {
            int got = 0;
            for (; got < 8; ++got)
                if (!r->getline(l[got])) break;
            if (got < 8) break;
            std::string hdr = l[0];
            size_t at = 0;
            while (at < hdr.size() && hdr[at] == '@') ++at;  // lstrip('@')
            parse_header(r, hdr.substr(at), name, barcode);
            auto it = bc2slot.find(barcode);
            if (it == bc2slot.end()) continue;
            Out& o = outs[it->second];
            rec.clear();
            rec += '@';
            rec += name;
            rec += "\tBX:Z:";
            rec += barcode;
            rec += "-1\n";
            for (int i = 1; i < 8; ++i) {
                rec += l[i];
                rec += '\n';
            }
            ok = fwrite(rec.data(), 1, rec.size(), o.fq) == rec.size() &&
                 fwrite(barcode.data(), 1, barcode.size(), o.bc) ==
                     barcode.size() &&
                 fputc('\n', o.bc) != EOF;
        }
        if (r && r->error) ok = false;
        if (h) pgn_close(h);
    } else if (ok) {
        void* h1 = pgn_open(in1, 0);
        void* h2 = pgn_open(in2, 0);
        if (!h1 || !h2) ok = false;
        Reader* r1 = h1 ? static_cast<Reader*>(h1) : nullptr;
        Reader* r2 = h2 ? static_cast<Reader*>(h2) : nullptr;
        std::string a[4], b[4], name2, barcode2;
        while (ok) {
            int got = 0;
            for (; got < 4; ++got)
                if (!r1->getline(a[got])) break;
            if (got < 4) break;
            got = 0;
            for (; got < 4; ++got)
                if (!r2->getline(b[got])) break;
            if (got < 4) break;
            size_t at = 0;
            while (at < a[0].size() && a[0][at] == '@') ++at;
            parse_header(r1, a[0].substr(at), name, barcode);
            at = 0;
            while (at < b[0].size() && b[0][at] == '@') ++at;
            parse_header(r2, b[0].substr(at), name2, barcode2);
            auto it = bc2slot.find(barcode);
            if (it == bc2slot.end() || name != name2 ||
                barcode != barcode2)
                continue;
            Out& o = outs[it->second];
            rec.clear();
            rec += '@';
            rec += name;
            rec += "\tBX:Z:";
            rec += barcode;
            rec += "-1\n";
            for (int i = 1; i < 4; ++i) {
                rec += a[i];
                rec += '\n';
            }
            rec += '@';
            rec += name2;
            rec += "\tBX:Z:";
            rec += barcode2;
            rec += "-1\n";
            for (int i = 1; i < 4; ++i) {
                rec += b[i];
                rec += '\n';
            }
            ok = fwrite(rec.data(), 1, rec.size(), o.fq) == rec.size() &&
                 fwrite(barcode.data(), 1, barcode.size(), o.bc) ==
                     barcode.size() &&
                 fputc('\n', o.bc) != EOF;
        }
        if ((r1 && r1->error) || (r2 && r2->error)) ok = false;
        if (h1) pgn_close(h1);
        if (h2) pgn_close(h2);
    }
    for (Out& o : outs) {
        if (o.fq && fclose(o.fq) != 0) ok = false;
        if (o.bc && fclose(o.bc) != 0) ok = false;
    }
    return ok ? 0 : -1;
}

}  // extern "C"

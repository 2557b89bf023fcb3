// Native FASTA/FASTQ parser: file -> contiguous 2-bit-friendly ordinal
// buffer + offsets, the layout approx_counter_tpu_torch.io.fastx.Reads
// wants, and the window gather and sparse-N packer of the upload path.
// Host C++, not a kernel: a copy of the JAX package's
// native/fastx_parser.cpp, built by approx_counter_tpu_torch/kernels/_build.py (host_build, g++)
// and bound with ctypes in approx_counter_tpu_torch/io/native.py.
//
// Fills the role of SeqAn's SeqFileIn/readRecords in the reference
// (approx_counter.cpp:824-825): whole file in RAM, format
// auto-detected from the first byte, arbitrary characters mapped to N.
// Single pass, branch-light -- the Python parser in io/fastx.py is the
// behavioral spec; tests assert byte-equality of the two.
//
// C ABI (ctypes):
//   fastx_handle* fastx_parse(const char* path, const char** err)
//   fastx_handle* fastx_parse_chunk(const char* data, int64_t n,
//                                   int is_final, int64_t* consumed,
//                                   const char** err)
//   int64_t  fastx_n_reads(fastx_handle*)
//   int64_t  fastx_total_bases(fastx_handle*)
//   const uint8_t*  fastx_buf(fastx_handle*)      // [total_bases]
//   const int64_t*  fastx_offsets(fastx_handle*)  // [n_reads + 1]
//   void fastx_free(fastx_handle*)
// Error strings are static literals.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Handle {
    std::vector<uint8_t> buf;
    std::vector<int64_t> offsets;
};

// char -> ordinal (A=0,C=1,G=2,T=3, other=N=4); mirrors codec.py.
struct Table {
    uint8_t t[256];
    Table() {
        memset(t, 4, sizeof(t));
        const char *dna = "ACGT";
        for (int i = 0; i < 4; i++) {
            t[(uint8_t)dna[i]] = (uint8_t)i;
            t[(uint8_t)(dna[i] + 32)] = (uint8_t)i;  // lowercase
        }
    }
};
const Table kTable;

// Append [s, e) minus newlines to h->buf, translated.  Bulk per-line
// writes into reserved storage -- a per-char push_back loop runs ~10 MB/s
// on some virtualized hosts, this runs at memory speed.
static inline void append_seq_block(const char *data, size_t s, size_t e,
                                    Handle *h) {
    size_t old = h->buf.size();
    h->buf.resize(old + (e - s));  // upper bound; shrink below
    uint8_t *dst = h->buf.data() + old;
    const uint8_t *tbl = kTable.t;
    size_t i = s;
    while (i < e) {
        const char *nl = (const char *)memchr(data + i, '\n', e - i);
        size_t line_end = nl ? (size_t)(nl - data) : e;
        size_t len = line_end - i;
        if (len && data[line_end - 1] == '\r') len--;
        const uint8_t *src = (const uint8_t *)data + i;
        for (size_t j = 0; j < len; j++) dst[j] = tbl[src[j]];
        dst += len;
        i = nl ? line_end + 1 : e;
    }
    h->buf.resize((size_t)(dst - h->buf.data()));
}

bool parse_fasta(const char *data, size_t n, Handle *h, const char **err) {
    size_t pos = 0;
    h->buf.reserve(n);
    while (pos < n) {
        if (data[pos] != '>') {
            *err = "Malformed FASTA: expected '>' header";
            return false;
        }
        const char *nl = (const char *)memchr(data + pos, '\n', n - pos);
        if (!nl) {  // header w/o newline: empty record (matches Python)
            h->offsets.push_back((int64_t)h->buf.size());
            break;
        }
        size_t seq_start = (size_t)(nl - data) + 1;
        const char *next = (const char *)memchr(
            data + seq_start, '>', n - seq_start);
        size_t seq_end = next ? (size_t)(next - data) : n;
        append_seq_block(data, seq_start, seq_end, h);
        h->offsets.push_back((int64_t)h->buf.size());
        pos = seq_end;
    }
    return true;
}

// Append one line's translated bases [s, le) (already \r-stripped bounds).
static inline void append_line(const char *data, size_t s, size_t le,
                               Handle *h) {
    size_t old = h->buf.size();
    h->buf.resize(old + (le - s));
    uint8_t *dst = h->buf.data() + old;
    const uint8_t *src = (const uint8_t *)data + s;
    const uint8_t *tbl = kTable.t;
    for (size_t j = 0; j < le - s; j++) dst[j] = tbl[src[j]];
}

// Multi-line (wrapped) FASTQ, like SeqAn readRecords
// (approx_counter.cpp:824-825): sequence lines accumulate
// until a '+' separator line; quality is consumed by *length* (total ==
// sequence length -- quality may start with '@'/'+').  Mirrors the Python
// bulk parser in io/fastx.py exactly (tests assert byte-equality).
bool parse_fastq(const char *data, size_t n, Handle *h, const char **err) {
    size_t pos = 0;
    while (pos < n) {
        // skip blank lines between records (matches Python fallback)
        while (pos < n && (data[pos] == '\n' || data[pos] == '\r')) pos++;
        if (pos >= n) break;
        if (data[pos] != '@') {
            *err = "Malformed FASTQ: expected '@' header";
            return false;
        }
        const char *l1 = (const char *)memchr(data + pos, '\n', n - pos);
        if (!l1) { *err = "Malformed FASTQ: truncated record"; return false; }
        size_t p = (size_t)(l1 - data) + 1;
        // --- sequence lines until a '+' separator ---
        size_t buf_mark = h->buf.size();
        bool plus_seen = false;
        while (p < n) {
            if (data[p] == '+') { plus_seen = true; break; }
            const char *e = (const char *)memchr(data + p, '\n', n - p);
            size_t line_end = e ? (size_t)(e - data) : n;
            size_t le = line_end;
            while (le > p && data[le - 1] == '\r') le--;
            append_line(data, p, le, h);
            p = e ? line_end + 1 : n;
        }
        if (!plus_seen) {
            *err = "Malformed FASTQ: truncated record";
            return false;
        }
        size_t need = h->buf.size() - buf_mark;
        const char *sep = (const char *)memchr(data + p, '\n', n - p);
        p = sep ? (size_t)(sep - data) + 1 : n;
        // --- quality by length ---
        size_t got = 0;
        while (p < n && got < need) {
            const char *e = (const char *)memchr(data + p, '\n', n - p);
            size_t line_end = e ? (size_t)(e - data) : n;
            size_t le = line_end;
            while (le > p && data[le - 1] == '\r') le--;
            got += le - p;
            p = e ? line_end + 1 : n;
        }
        if (got != need) {
            *err = "Malformed FASTQ: quality length mismatch";
            return false;
        }
        h->offsets.push_back((int64_t)h->buf.size());
        pos = p;
    }
    return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// Incremental (streaming) parsers: parse complete records from a chunk,
// report consumed bytes so the caller can carry a trailing partial record
// into the next chunk.  With is_final these match the *streaming* Python
// iterators of approx_counter_tpu/io/stream.py (line-based FASTA record
// splits, partial trailing records yielded/dropped exactly like
// _iter_fasta/_iter_fastq there) --
// note this differs from fastx_parse's bulk EOF quirks by design.
// ---------------------------------------------------------------------------

namespace {

bool parse_fasta_inc(const char *data, size_t n, bool is_final, Handle *h,
                     size_t *consumed, const char **err) {
    size_t pos = 0;
    *consumed = 0;
    while (pos < n) {
        if (data[pos] != '>') {
            *err = "Malformed FASTA: expected '>' header";
            return false;
        }
        const char *nl = (const char *)memchr(data + pos, '\n', n - pos);
        if (!nl) {
            // header without newline: incomplete; at EOF the streaming
            // iterator drops it (it never became a record)
            *consumed = is_final ? n : pos;
            return true;
        }
        size_t seq_start = (size_t)(nl - data) + 1;
        // next record starts at a '\n' immediately followed by '>' --
        // line-based, like the Python streaming iterator
        size_t search = seq_start;
        size_t next_hdr = 0;
        bool have_next = false;
        while (search < n) {
            const char *nl2 = (const char *)memchr(
                data + search, '\n', n - search);
            if (!nl2) break;
            size_t cand = (size_t)(nl2 - data) + 1;
            if (cand >= n) break;
            if (data[cand] == '>') { next_hdr = cand; have_next = true; break; }
            search = cand;
        }
        if (!have_next && !is_final) {
            *consumed = pos;  // record may continue in the next chunk
            return true;
        }
        size_t seq_end = have_next ? next_hdr : n;
        append_seq_block(data, seq_start, seq_end, h);
        h->offsets.push_back((int64_t)h->buf.size());
        pos = seq_end;
        *consumed = pos;
    }
    return true;
}

// Streaming multi-line FASTQ; mirrors approx_counter_tpu/io/stream.py
// _iter_fastq exactly:
// sequence lines accumulate until a '+' line, quality consumed by length,
// the record counts once the '+' separator is reached; at EOF a record
// mid-accumulation yields its partial sequence (incl. an unterminated
// last line), a record mid-quality yields (its sequence is complete).
bool parse_fastq_inc(const char *data, size_t n, bool is_final, Handle *h,
                     size_t *consumed, const char **err) {
    size_t pos = 0;
    *consumed = 0;
    while (pos < n) {
        size_t p0 = pos;
        while (pos < n && (data[pos] == '\n' || data[pos] == '\r')) pos++;
        if (pos >= n) { *consumed = n; return true; }
        if (data[pos] != '@') {
            *err = "Malformed FASTQ: expected '@' header";
            return false;
        }
        const char *l1 = (const char *)memchr(data + pos, '\n', n - pos);
        if (!l1) { *consumed = is_final ? n : p0; return true; }
        size_t p = (size_t)(l1 - data) + 1;
        // --- sequence accumulation until a '+' line ---
        size_t buf_mark = h->buf.size();
        bool plus_seen = false;
        bool any_seq_line = false;
        while (p < n) {
            if (data[p] == '+') { plus_seen = true; break; }
            const char *e = (const char *)memchr(data + p, '\n', n - p);
            if (!e) break;  // unterminated line: chunk boundary or EOF tail
            size_t line_end = (size_t)(e - data);
            size_t le = line_end;
            while (le > p && data[le - 1] == '\r') le--;
            append_line(data, p, le, h);
            any_seq_line = true;
            p = line_end + 1;
        }
        if (!plus_seen) {
            if (!is_final) {
                h->buf.resize(buf_mark);
                *consumed = p0;
                return true;
            }
            // EOF semantics (== _iter_fastq): a '+'-starting tail closes
            // the record; otherwise the partial tail joins the sequence;
            // a bare header with nothing after it is dropped.
            bool tail_plus = p < n && data[p] == '+';
            size_t le = n;
            while (le > p && data[le - 1] == '\r') le--;
            if (!tail_plus && le > p) {
                append_line(data, p, le, h);
                any_seq_line = true;
            }
            if (tail_plus || any_seq_line) {
                h->offsets.push_back((int64_t)h->buf.size());
            } else {
                h->buf.resize(buf_mark);
            }
            *consumed = n;
            return true;
        }
        size_t need = h->buf.size() - buf_mark;
        const char *sep = (const char *)memchr(data + p, '\n', n - p);
        if (!sep) {
            if (!is_final) {
                h->buf.resize(buf_mark);
                *consumed = p0;
                return true;
            }
            h->offsets.push_back((int64_t)h->buf.size());  // '+' reached
            *consumed = n;
            return true;
        }
        size_t qp = (size_t)(sep - data) + 1;
        // --- quality by length (complete lines only) ---
        size_t got = 0;
        bool qual_done = got >= need;
        while (qp < n && !qual_done) {
            const char *e = (const char *)memchr(data + qp, '\n', n - qp);
            if (!e) break;  // partial qual line: not counted (== Python)
            size_t line_end = (size_t)(e - data);
            size_t le = line_end;
            while (le > qp && data[le - 1] == '\r') le--;
            got += le - qp;
            qp = line_end + 1;
            qual_done = got >= need;
        }
        if (qual_done && got != need) {
            *err = "Malformed FASTQ: quality length mismatch";
            return false;
        }
        if (!qual_done) {
            if (!is_final) {
                h->buf.resize(buf_mark);
                *consumed = p0;
                return true;
            }
            h->offsets.push_back((int64_t)h->buf.size());  // EOF mid-qual
            *consumed = n;
            return true;
        }
        h->offsets.push_back((int64_t)h->buf.size());
        pos = qp;
        *consumed = pos;
    }
    return true;
}

}  // namespace

extern "C" {

// Parse complete records from data[0..n); *consumed reports how many bytes
// were used (a trailing partial record is left for the caller to carry).
// With is_final != 0, EOF semantics match the Python iterators of
// approx_counter_tpu/io/stream.py.
Handle *fastx_parse_chunk(const char *data, int64_t n, int is_final,
                          int64_t *consumed, const char **err) {
    *err = nullptr;
    *consumed = 0;
    Handle *h = new Handle();
    h->offsets.push_back(0);
    if (n <= 0) return h;
    size_t used = 0;
    bool ok;
    if (data[0] == '>') {
        ok = parse_fasta_inc(data, (size_t)n, is_final != 0, h, &used, err);
    } else if (data[0] == '@') {
        ok = parse_fastq_inc(data, (size_t)n, is_final != 0, h, &used, err);
    } else {
        *err = "Unrecognized sequence file format";
        ok = false;
    }
    if (!ok) { delete h; return nullptr; }
    *consumed = (int64_t)used;
    return h;
}

}  // extern "C"

extern "C" {

Handle *fastx_parse(const char *path, const char **err) {
    *err = nullptr;
    FILE *f = fopen(path, "rb");
    if (!f) { *err = "could not open file"; return nullptr; }
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> data((size_t)(sz > 0 ? sz : 0));
    if (sz > 0 && fread(data.data(), 1, (size_t)sz, f) != (size_t)sz) {
        fclose(f);
        *err = "short read";
        return nullptr;
    }
    fclose(f);

    Handle *h = new Handle();
    h->offsets.push_back(0);
    if (data.empty()) return h;
    bool ok;
    if (data[0] == '>') ok = parse_fasta(data.data(), data.size(), h, err);
    else if (data[0] == '@') ok = parse_fastq(data.data(), data.size(), h, err);
    else { *err = "Unrecognized sequence file format"; ok = false; }
    if (!ok) { delete h; return nullptr; }
    return h;
}

// Cut sampled windows out of the base buffer: row i of out gets
// buf[starts[i] .. starts[i]+ncols).  Replaces the reference's per-read
// prefix()/suffix() views (approx_counter.cpp:463-466) with a straight
// memcpy loop.
void fastx_gather_windows(const uint8_t *buf, const int64_t *starts,
                          int64_t n, int64_t ncols, uint8_t *out,
                          int64_t out_stride) {
    for (int64_t i = 0; i < n; i++) {
        memcpy(out + i * out_stride, buf + starts[i], (size_t)ncols);
    }
}

// Sparse-N 2-bit window pack (the native counterpart of core/codec.py
// pack_windows_sparse): write the 2-bit plane (4 bases/byte, base j of each 4-group
// at bit 2*(j%4); row width ceil(m/8)*8/4 bytes) and collect the flattened
// row*m+col indices of N symbols inside the valid region
// [0, n_valid) x [0, ncols), in one streaming pass.
// Returns: #N positions (>= 0); -1 if more than ncap Ns (the caller ships
// the dense format); -2 if a non-N symbol >= 4 sits inside the valid
// region (sampler-contract violation -- dense format too).
int64_t fastx_pack_windows_sparse(const uint8_t *w, int64_t n, int64_t m,
                                  int64_t n_valid, int64_t ncols,
                                  uint8_t *lo, int32_t *n_idx,
                                  int64_t ncap) {
    const int64_t mp = ((m + 7) / 8) * 8;
    const int64_t row_bytes = mp / 4;
    int64_t n_n = 0;
    for (int64_t r = 0; r < n; r++) {
        const uint8_t *src = w + r * m;
        uint8_t *dst = lo + r * row_bytes;
        int64_t c = 0;
        // full 4-groups inside the row
        for (; c + 4 <= m; c += 4) {
            dst[c / 4] = (uint8_t)((src[c] & 3) | ((src[c + 1] & 3) << 2) |
                                   ((src[c + 2] & 3) << 4) |
                                   ((src[c + 3] & 3) << 6));
        }
        // ragged tail: pad with BASE_PAD(5)&3 = 1 (sliced off on device)
        for (int64_t g = c; g < mp; g += 4) {
            uint8_t b = 0;
            for (int t = 0; t < 4; t++) {
                uint8_t v = (g + t < m) ? src[g + t] : 5;
                b |= (uint8_t)((v & 3) << (2 * t));
            }
            dst[g / 4] = b;
        }
        if (r >= n_valid) continue;
        // N scan over the valid columns: SWAR word test, rare slow path.
        // The mask must cover ALL bits above the 2-bit base field (0xFC),
        // not just bit 2: a junk symbol >= 8 has bit 2 clear and would
        // otherwise be silently packed as v&3 instead of returning -2
        // like the numpy version does.
        int64_t cc = 0;
        for (; cc + 8 <= ncols; cc += 8) {
            uint64_t x;
            memcpy(&x, src + cc, 8);
            if (x & 0xFCFCFCFCFCFCFCFCULL) {
                for (int t = 0; t < 8; t++) {
                    uint8_t v = src[cc + t];
                    if (v >= 4) {
                        if (v != 4) return -2;
                        if (n_n >= ncap) return -1;
                        n_idx[n_n++] = (int32_t)(r * m + cc + t);
                    }
                }
            }
        }
        for (; cc < ncols; cc++) {
            uint8_t v = src[cc];
            if (v >= 4) {
                if (v != 4) return -2;
                if (n_n >= ncap) return -1;
                n_idx[n_n++] = (int32_t)(r * m + cc);
            }
        }
    }
    return n_n;
}

int64_t fastx_n_reads(Handle *h) { return (int64_t)h->offsets.size() - 1; }
int64_t fastx_total_bases(Handle *h) { return (int64_t)h->buf.size(); }
const uint8_t *fastx_buf(Handle *h) {
    return h->buf.empty() ? (const uint8_t *)"" : h->buf.data();
}
const int64_t *fastx_offsets(Handle *h) { return h->offsets.data(); }
void fastx_free(Handle *h) { delete h; }

}  // extern "C"

// Native streaming matrix parsers — this framework's equivalent of the
// reference's C++ file_parser layer (reference: src/file_parser/
// CharacterDelimitedParser.cpp, MtxParser.cpp, FileParser.cpp:9-19).
// Python binds via ctypes (cogaps_tpu/io/native.py); the pure-Python
// parsers remain the fallback.
//
// API: handle-based. fp_read_delim / fp_read_mtx return an opaque handle;
// accessors expose dims, the float32 data block, and newline-joined
// row/col name blobs; fp_free releases.
//
// Build: make -C native  (produces libfastparse.so)

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <string>
#include <vector>

namespace {

struct ParseResult
{
    int64_t nRows = 0;
    int64_t nCols = 0;
    int64_t nnz = 0;                // mtx only
    std::vector<float> data;        // dense row-major, or mtx values
    std::vector<int32_t> rowIdx;    // mtx only
    std::vector<int32_t> colIdx;    // mtx only
    std::string rowNames;           // '\n'-joined
    std::string colNames;
    std::string error;
};

// strip surrounding quotes + whitespace
std::string dequote(const char *begin, const char *end)
{
    while (begin < end && (*begin == ' ' || *begin == '\r')) ++begin;
    while (end > begin && (end[-1] == ' ' || end[-1] == '\r')) --end;
    if (end - begin >= 2 && (*begin == '"' || *begin == '\'')
        && end[-1] == *begin)
    {
        ++begin;
        --end;
    }
    return std::string(begin, end);
}

bool readFile(const char *path, std::string &out)
{
    FILE *f = fopen(path, "rb");
    if (f == nullptr) return false;
    fseek(f, 0, SEEK_END);
    long sz = ftell(f);
    fseek(f, 0, SEEK_SET);
    out.resize(static_cast<size_t>(sz));
    size_t got = fread(&out[0], 1, static_cast<size_t>(sz), f);
    fclose(f);
    out.resize(got);
    return true;
}

} // namespace

extern "C" {

void *fp_read_delim(const char *path, char sep, int gct)
{
    auto *res = new ParseResult();
    std::string buf;
    if (!readFile(path, buf))
    {
        res->error = "cannot open file";
        return res;
    }
    const char *p = buf.data();
    const char *bufEnd = buf.data() + buf.size();

    auto nextLine = [&](const char *&lineEnd) -> bool {
        if (p >= bufEnd) return false;
        lineEnd = static_cast<const char *>(memchr(p, '\n', bufEnd - p));
        if (lineEnd == nullptr) lineEnd = bufEnd;
        return true;
    };

    const char *lineEnd = nullptr;
    int nameCols = 1;
    if (gct)
    {
        // GCT 1.2: "#1.2", "nrows\tncols", then header with Name/Description
        nextLine(lineEnd); p = lineEnd + 1;                 // version
        nextLine(lineEnd); p = lineEnd + 1;                 // dims (recomputed)
        nameCols = 2;
    }
    // header
    if (!nextLine(lineEnd)) { res->error = "empty file"; return res; }
    {
        std::vector<std::string> header;
        const char *s = p;
        for (const char *q = p; q <= lineEnd; ++q)
        {
            if (q == lineEnd || *q == sep)
            {
                header.push_back(dequote(s, q));
                s = q + 1;
            }
        }
        // column names follow the name column(s); a short header (R-style
        // rownames csv) keeps every field
        size_t skip = header.size() > 0 && header[0].empty() ? 1
            : static_cast<size_t>(nameCols);
        if (gct) skip = 2;
        std::string names;
        size_t start = header.size() > skip ? skip : 0;
        int64_t count = 0;
        for (size_t i = start; i < header.size(); ++i)
        {
            if (count++) names += '\n';
            names += header[i];
        }
        res->colNames = names;
        res->nCols = count;
        p = lineEnd + 1;
    }

    std::string rowNames;
    while (nextLine(lineEnd))
    {
        if (lineEnd == p) { p = lineEnd + 1; continue; }  // blank line
        const char *s = p;
        int field = 0;
        for (const char *q = p; q <= lineEnd; ++q)
        {
            if (q == lineEnd || *q == sep)
            {
                if (field == 0)
                {
                    if (res->nRows) rowNames += '\n';
                    rowNames += dequote(s, q);
                }
                else if (field >= nameCols)
                {
                    res->data.push_back(strtof(s, nullptr));
                }
                ++field;
                s = q + 1;
            }
        }
        ++res->nRows;
        p = lineEnd + 1;
    }
    res->rowNames = rowNames;
    if (res->nRows > 0)
    {
        int64_t cols = static_cast<int64_t>(res->data.size()) / res->nRows;
        if (cols * res->nRows != static_cast<int64_t>(res->data.size()))
        {
            res->error = "ragged rows";
            return res;
        }
        res->nCols = cols;
    }
    return res;
}

void *fp_read_mtx(const char *path)
{
    auto *res = new ParseResult();
    std::string buf;
    if (!readFile(path, buf))
    {
        res->error = "cannot open file";
        return res;
    }
    const char *p = buf.data();
    const char *bufEnd = buf.data() + buf.size();
    if (buf.compare(0, 14, "%%MatrixMarket") != 0)
    {
        res->error = "not a MatrixMarket file";
        return res;
    }
    // skip comments
    while (p < bufEnd && *p == '%')
    {
        p = static_cast<const char *>(memchr(p, '\n', bufEnd - p));
        if (p == nullptr) { res->error = "truncated mtx"; return res; }
        ++p;
    }
    char *q = nullptr;
    res->nRows = strtol(p, &q, 10);
    res->nCols = strtol(q, &q, 10);
    int64_t nnz = strtol(q, &q, 10);
    res->rowIdx.reserve(nnz);
    res->colIdx.reserve(nnz);
    res->data.reserve(nnz);
    p = q;
    for (int64_t n = 0; n < nnz && p < bufEnd; ++n)
    {
        long i = strtol(p, &q, 10);
        long j = strtol(q, &q, 10);
        // pattern files have no value column: default 1
        const char *lineEnd = static_cast<const char *>(
            memchr(q, '\n', bufEnd - q));
        if (lineEnd == nullptr) lineEnd = bufEnd;
        float v = 1.0f;
        for (const char *c = q; c < lineEnd; ++c)
        {
            if (*c != ' ' && *c != '\r') { v = strtof(q, &q); break; }
        }
        res->rowIdx.push_back(static_cast<int32_t>(i - 1));
        res->colIdx.push_back(static_cast<int32_t>(j - 1));
        res->data.push_back(v);
        p = lineEnd + 1;
    }
    res->nnz = static_cast<int64_t>(res->data.size());
    return res;
}

int64_t fp_nrows(void *h) { return static_cast<ParseResult *>(h)->nRows; }
int64_t fp_ncols(void *h) { return static_cast<ParseResult *>(h)->nCols; }
int64_t fp_nnz(void *h) { return static_cast<ParseResult *>(h)->nnz; }
const float *fp_data(void *h) { return static_cast<ParseResult *>(h)->data.data(); }
const int32_t *fp_rowidx(void *h) { return static_cast<ParseResult *>(h)->rowIdx.data(); }
const int32_t *fp_colidx(void *h) { return static_cast<ParseResult *>(h)->colIdx.data(); }
const char *fp_rownames(void *h) { return static_cast<ParseResult *>(h)->rowNames.c_str(); }
const char *fp_colnames(void *h) { return static_cast<ParseResult *>(h)->colNames.c_str(); }
const char *fp_error(void *h)
{
    ParseResult *r = static_cast<ParseResult *>(h);
    return r->error.empty() ? nullptr : r->error.c_str();
}
void fp_free(void *h) { delete static_cast<ParseResult *>(h); }

} // extern "C"

// Native GFA v1 parser for gfasort_tpu_torch.
//
// Array-producing parser with the CLI parser's semantics (gfasort
// src/bin/gfasort.rs:88-167): numeric segment ids kept verbatim,
// three passes (S, L, P), edge complement dedup as in add_edge
// (src/graph_ops.rs:626-638).  Emits struct-of-arrays buffers that the
// Python wrapper turns into a BidirectedGraph / PathIndex without
// per-line Python work — the host-I/O path for chromosome-scale GFAs.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_set>
#include <vector>

namespace {

struct U64PairHash {
    size_t operator()(const std::pair<uint64_t, uint64_t>& p) const {
        uint64_t h = p.first * 0x9E3779B97F4A7C15ULL ^ (p.second + 0x7F4A7C15U);
        h ^= h >> 33;
        h *= 0xFF51AFD7ED558CCDULL;
        h ^= h >> 33;
        return (size_t)h;
    }
};

struct ParseResult {
    // segments
    std::vector<int64_t> seg_ids;
    std::vector<int64_t> seq_offsets;  // size n_segs+1 into seq_blob
    std::string seq_blob;
    // links (stored edge forms, deduped)
    std::vector<int64_t> link_from;    // handles (id<<1|rev)
    std::vector<int64_t> link_to;
    // paths
    std::string path_names;            // '\n'-joined
    std::vector<int64_t> step_handles;
    std::vector<int64_t> path_offsets; // size n_paths+1 into step_handles
    std::string error;
};

inline bool parse_i64(const char* s, const char* end, int64_t* out) {
    if (s >= end) return false;
    int64_t v = 0;
    bool any = false;
    for (; s < end; s++) {
        if (*s < '0' || *s > '9') return false;
        v = v * 10 + (*s - '0');
        any = true;
    }
    *out = v;
    return any;
}

ParseResult* parse(const char* data, size_t len) {
    auto* r = new ParseResult();
    r->seq_offsets.push_back(0);
    r->path_offsets.push_back(0);

    std::unordered_set<std::pair<uint64_t, uint64_t>, U64PairHash> edge_set;

    const char* p = data;
    const char* end = data + len;
    // Single pass is safe for S lines vs L/P ordering?  The reference
    // does three passes over the text; order only matters for
    // node_order (S lines in file order) which a single pass preserves,
    // and L/P reference ids numerically (no name table), so one pass is
    // behavior-identical.
    while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
        const char* line_end = nl ? nl : end;
        if (line_end > p) {
            char tag = *p;
            if (tag == 'S' || tag == 'L' || tag == 'P') {
                // split into fields
                const char* f[8];
                const char* fe[8];
                int nf = 0;
                const char* q = p;
                while (q <= line_end && nf < 8) {
                    const char* tab = (const char*)memchr(q, '\t', (size_t)(line_end - q));
                    f[nf] = q;
                    fe[nf] = tab ? tab : line_end;
                    nf++;
                    if (!tab) break;
                    q = tab + 1;
                }
                if (tag == 'S' && nf >= 3) {
                    int64_t id;
                    if (!parse_i64(f[1], fe[1], &id)) {
                        r->error = "Failed to parse node ID: " +
                                   std::string(f[1], fe[1]);
                        return r;
                    }
                    r->seg_ids.push_back(id);
                    r->seq_blob.append(f[2], fe[2]);
                    r->seq_offsets.push_back((int64_t)r->seq_blob.size());
                } else if (tag == 'L' && nf >= 5) {
                    int64_t from_id, to_id;
                    if (!parse_i64(f[1], fe[1], &from_id) ||
                        !parse_i64(f[3], fe[3], &to_id)) {
                        r->error = "Failed to parse link ID";
                        return r;
                    }
                    bool from_rev = !(fe[2] - f[2] == 1 && *f[2] == '+');
                    bool to_rev = !(fe[4] - f[4] == 1 && *f[4] == '+');
                    uint64_t fh = ((uint64_t)from_id << 1) | (from_rev ? 1 : 0);
                    uint64_t th = ((uint64_t)to_id << 1) | (to_rev ? 1 : 0);
                    // dedup edge/complement (src/graph_ops.rs:626-638)
                    if (!edge_set.count({fh, th}) &&
                        !edge_set.count({th ^ 1, fh ^ 1})) {
                        edge_set.insert({fh, th});
                        r->link_from.push_back((int64_t)fh);
                        r->link_to.push_back((int64_t)th);
                    }
                } else if (tag == 'P' && nf >= 3) {
                    r->path_names.append(f[1], fe[1]);
                    r->path_names.push_back('\n');
                    // steps: comma-separated <id><+|->
                    const char* s = f[2];
                    const char* se = fe[2];
                    while (s < se) {
                        const char* comma = (const char*)memchr(s, ',', (size_t)(se - s));
                        const char* step_end = comma ? comma : se;
                        // trim
                        while (s < step_end && (*s == ' ' || *s == '\r')) s++;
                        const char* te = step_end;
                        while (te > s && (te[-1] == ' ' || te[-1] == '\r')) te--;
                        if (te > s) {
                            char orient = te[-1];
                            int64_t id;
                            if (!parse_i64(s, te - 1, &id)) {
                                r->error = "Failed to parse path node ID: " +
                                           std::string(s, te);
                                return r;
                            }
                            // reference CLI treats any non-'+' final
                            // char as reverse (src/bin/gfasort.rs:149)
                            bool rev = orient != '+';
                            r->step_handles.push_back((id << 1) | (rev ? 1 : 0));
                        }
                        if (!comma) break;
                        s = comma + 1;
                    }
                    r->path_offsets.push_back((int64_t)r->step_handles.size());
                }
            }
        }
        if (!nl) break;
        p = nl + 1;
    }
    return r;
}

}  // namespace

extern "C" {

// Parse a GFA file.  Returns an opaque handle; query with the getters
// below and free with gfa_free.  NULL on I/O failure.
void* gfa_parse_file(const char* filename) {
    FILE* fp = fopen(filename, "rb");
    if (!fp) return nullptr;
    fseek(fp, 0, SEEK_END);
    long size = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    char* buf = (char*)malloc((size_t)size);
    if (!buf) {
        fclose(fp);
        return nullptr;
    }
    size_t rd = fread(buf, 1, (size_t)size, fp);
    fclose(fp);
    ParseResult* r = parse(buf, rd);
    free(buf);
    return r;
}

void* gfa_parse_buffer(const char* data, int64_t len) {
    return parse(data, (size_t)len);
}

const char* gfa_error(void* h) {
    auto* r = (ParseResult*)h;
    return r->error.empty() ? nullptr : r->error.c_str();
}

int64_t gfa_n_segs(void* h) { return (int64_t)((ParseResult*)h)->seg_ids.size(); }
int64_t gfa_n_links(void* h) { return (int64_t)((ParseResult*)h)->link_from.size(); }
int64_t gfa_n_paths(void* h) { return (int64_t)((ParseResult*)h)->path_offsets.size() - 1; }
int64_t gfa_n_steps(void* h) { return (int64_t)((ParseResult*)h)->step_handles.size(); }
int64_t gfa_seq_blob_len(void* h) { return (int64_t)((ParseResult*)h)->seq_blob.size(); }
int64_t gfa_path_names_len(void* h) { return (int64_t)((ParseResult*)h)->path_names.size(); }

const int64_t* gfa_seg_ids(void* h) { return ((ParseResult*)h)->seg_ids.data(); }
const int64_t* gfa_seq_offsets(void* h) { return ((ParseResult*)h)->seq_offsets.data(); }
const char* gfa_seq_blob(void* h) { return ((ParseResult*)h)->seq_blob.data(); }
const int64_t* gfa_link_from(void* h) { return ((ParseResult*)h)->link_from.data(); }
const int64_t* gfa_link_to(void* h) { return ((ParseResult*)h)->link_to.data(); }
const char* gfa_path_names(void* h) { return ((ParseResult*)h)->path_names.data(); }
const int64_t* gfa_step_handles(void* h) { return ((ParseResult*)h)->step_handles.data(); }
const int64_t* gfa_path_offsets(void* h) { return ((ParseResult*)h)->path_offsets.data(); }

void gfa_free(void* h) { delete (ParseResult*)h; }

}  // extern "C"

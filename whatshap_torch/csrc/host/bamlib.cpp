// Native BAM data loader: BGZF inflation + record splitting + columnar
// fixed-field extraction, so the Python layer can filter with numpy and
// materialize AlignedSegments lazily.  Loaded via ctypes (whatshap_torch/hostlib.py).
//
// BAM/BGZF layout per the SAM spec section 4; this replaces the per-block
// Python zlib loop and the per-record struct.unpack of the 32-byte fixed
// section, which dominate scan time for large files.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

struct BamFile {
    std::vector<uint8_t> pool;      // concatenated record bytes (without the 4-byte length)
    std::vector<uint64_t> offsets;  // n+1 entries into pool
    std::vector<int32_t> fixed;     // n x 8: ref_id,pos,flag,mapq,next_ref,next_pos,tlen,l_seq
    std::string header_text;
    std::vector<std::string> ref_names;
    std::vector<int32_t> ref_lens;
    std::string error;
};

// One z_stream reused across all BGZF members: inflateReset per block
// instead of a full inflateInit2/inflateEnd pair (which allocates and
// frees the window state every 64 KiB of payload).
struct ZGuard {
    z_stream zs;
    bool ok;
    ZGuard() : zs(), ok(false) {
        memset(&zs, 0, sizeof(zs));
        ok = inflateInit2(&zs, -15) == Z_OK;
    }
    ~ZGuard() {
        if (ok) inflateEnd(&zs);
    }
};

bool inflate_bgzf(const uint8_t* data, size_t size, std::vector<uint8_t>& out) {
    size_t pos = 0;
    out.reserve(size * 3);
    ZGuard zg;
    if (!zg.ok) return false;
    bool first = true;
    while (pos + 18 <= size) {
        if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return false;
        uint16_t xlen;
        memcpy(&xlen, data + pos + 10, 2);
        // All offsets below derive from file-supplied fields; validate each
        // against the buffer before dereferencing (truncated/corrupt input).
        if (pos + 12 + (size_t)xlen > size) return false;
        // find BC subfield for the block size
        size_t xpos = pos + 12, xend = xpos + xlen;
        int bsize = -1;
        while (xpos + 4 <= xend) {
            uint8_t si1 = data[xpos], si2 = data[xpos + 1];
            uint16_t slen;
            memcpy(&slen, data + xpos + 2, 2);
            if (si1 == 'B' && si2 == 'C' && slen == 2) {
                if (xpos + 6 > xend) return false;
                uint16_t bs;
                memcpy(&bs, data + xpos + 4, 2);
                bsize = (int)bs + 1;
                break;
            }
            xpos += 4 + slen;
        }
        if (bsize < 0) return false;
        // bsize must cover header(12) + extra(xlen) + crc+isize trailer(8)
        // and the whole block must lie inside the buffer.
        if ((size_t)bsize < 12 + (size_t)xlen + 8) return false;
        if (pos + (size_t)bsize > size) return false;
        size_t cdata_off = pos + 12 + xlen;
        size_t cdata_len = (size_t)bsize - 12 - xlen - 8;
        uint32_t isize;
        memcpy(&isize, data + pos + bsize - 4, 4);
        if (isize > (1u << 16)) return false;  // BGZF blocks decode to <=64 KiB
        if (isize > 0) {
            size_t base = out.size();
            out.resize(base + isize);
            if (!first && inflateReset(&zg.zs) != Z_OK) return false;
            first = false;
            zg.zs.next_in = const_cast<Bytef*>(data + cdata_off);
            zg.zs.avail_in = (uInt)cdata_len;
            zg.zs.next_out = out.data() + base;
            zg.zs.avail_out = isize;
            if (inflate(&zg.zs, Z_FINISH) != Z_STREAM_END) return false;
        }
        pos += bsize;
    }
    return true;
}

}  // namespace

extern "C" {

void* wh_bam_load(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long fsize = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> raw((size_t)fsize);
    if (fsize > 0 && fread(raw.data(), 1, (size_t)fsize, f) != (size_t)fsize) {
        fclose(f);
        return nullptr;
    }
    fclose(f);

    auto* bf = new BamFile();
    std::vector<uint8_t> u;
    if (!inflate_bgzf(raw.data(), raw.size(), u)) {
        delete bf;
        return nullptr;
    }
    if (u.size() < 12 || memcmp(u.data(), "BAM\x01", 4) != 0) {
        delete bf;
        return nullptr;
    }
    size_t pos = 4;
    int32_t l_text;
    memcpy(&l_text, u.data() + pos, 4);
    pos += 4;
    bf->header_text.assign((const char*)u.data() + pos, (size_t)l_text);
    // trim trailing NULs
    while (!bf->header_text.empty() && bf->header_text.back() == '\0')
        bf->header_text.pop_back();
    pos += (size_t)l_text;
    int32_t n_ref;
    memcpy(&n_ref, u.data() + pos, 4);
    pos += 4;
    for (int32_t i = 0; i < n_ref; ++i) {
        int32_t l_name;
        memcpy(&l_name, u.data() + pos, 4);
        pos += 4;
        bf->ref_names.emplace_back((const char*)u.data() + pos, (size_t)l_name - 1);
        pos += (size_t)l_name;
        int32_t l_ref;
        memcpy(&l_ref, u.data() + pos, 4);
        pos += 4;
        bf->ref_lens.push_back(l_ref);
    }

    bf->offsets.push_back(0);
    while (pos + 4 <= u.size()) {
        int32_t block_size;
        memcpy(&block_size, u.data() + pos, 4);
        pos += 4;
        if (block_size < 32 || pos + (size_t)block_size > u.size()) break;
        const uint8_t* rec = u.data() + pos;
        int32_t v[8];
        memcpy(&v[0], rec + 0, 4);   // ref_id
        memcpy(&v[1], rec + 4, 4);   // pos
        uint32_t bin_mq_nl, flag_nc;
        memcpy(&bin_mq_nl, rec + 8, 4);
        memcpy(&flag_nc, rec + 12, 4);
        v[2] = (int32_t)(flag_nc >> 16);         // flag
        v[3] = (int32_t)((bin_mq_nl >> 8) & 0xFF);  // mapq
        memcpy(&v[7], rec + 16, 4);  // l_seq
        memcpy(&v[4], rec + 20, 4);  // next_ref_id
        memcpy(&v[5], rec + 24, 4);  // next_pos
        memcpy(&v[6], rec + 28, 4);  // tlen
        for (int k = 0; k < 8; ++k) bf->fixed.push_back(v[k]);
        bf->pool.insert(bf->pool.end(), rec, rec + block_size);
        bf->offsets.push_back(bf->pool.size());
        pos += (size_t)block_size;
    }
    return bf;
}

uint64_t wh_bam_n_records(void* h) { return ((BamFile*)h)->offsets.size() - 1; }
const uint8_t* wh_bam_pool(void* h) { return ((BamFile*)h)->pool.data(); }
uint64_t wh_bam_pool_size(void* h) { return ((BamFile*)h)->pool.size(); }
const uint64_t* wh_bam_offsets(void* h) { return ((BamFile*)h)->offsets.data(); }
const int32_t* wh_bam_fixed(void* h) { return ((BamFile*)h)->fixed.data(); }
const char* wh_bam_header_text(void* h) { return ((BamFile*)h)->header_text.c_str(); }
int wh_bam_n_refs(void* h) { return (int)((BamFile*)h)->ref_names.size(); }
const char* wh_bam_ref_name(void* h, int i) { return ((BamFile*)h)->ref_names[(size_t)i].c_str(); }
int wh_bam_ref_len(void* h, int i) { return ((BamFile*)h)->ref_lens[(size_t)i]; }
void wh_bam_free(void* h) { delete (BamFile*)h; }

}  // extern "C"

// lancet_jax native I/O plane: streaming BGZF/BAM/BAI reader + faidx-style
// FASTA slicer, C++17, zlib only.
//
// This is the framework's equivalent of the reference's vendored
// native I/O libraries (bamtools-2.5.2 BamReader/BamAlignment and htslib
// faidx; SURVEY.md §2.2 rows I1/I2) — written from the SAM/BAM/BAI specs,
// no reference code. Exposed to Python via a flat extern "C" API consumed
// with ctypes (lancet_jax/native/__init__.py). Unlike the pure-Python
// io.bam reader (whole-file in memory), this one streams: BAI-guided
// virtual-offset seeks per region, block-at-a-time BGZF inflation, and
// record decode (nibble sequence unpack, qual re-offset) in native code.
//
// Packed record wire format returned by lbam_fetch (little-endian):
//   int32 pos; int32 end;            // 0-based leftmost, half-open end
//   uint16 flag; uint8 mapq; uint8 has_qual;
//   uint16 n_cigar; uint16 l_name;   // name length WITHOUT the nul
//   int32 l_seq; int32 l_tags;
//   char name[l_name];
//   uint32 cigar[n_cigar];           // (len<<4)|op as in BAM
//   char seq[l_seq];                 // ASCII bases
//   char qual[has_qual ? l_seq : 0]; // phred+33 ASCII
//   uint8 tags[l_tags];              // raw BAM aux blob
#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// BGZF stream: seekable virtual-offset reader over blocked gzip members.
// ---------------------------------------------------------------------------

struct BgzfStream {
  FILE* f = nullptr;
  int64_t file_size = 0;
  int64_t block_coffset = -1;  // compressed offset of the cached block
  int64_t next_coffset = 0;    // compressed offset of the block after it
  std::vector<uint8_t> block;  // inflated payload of the cached block
  size_t within = 0;           // cursor within the cached block

  bool open(const char* path) {
    f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    file_size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    return true;
  }
  void close() {
    if (f) std::fclose(f);
    f = nullptr;
  }

  // Inflate the BGZF block starting at compressed offset `coffset`.
  bool load_block(int64_t coffset) {
    if (coffset == block_coffset) return true;
    if (coffset >= file_size) return false;
    uint8_t hdr[18];
    std::fseek(f, (long)coffset, SEEK_SET);
    if (std::fread(hdr, 1, 18, f) != 18) return false;
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) return false;
    uint16_t xlen;
    std::memcpy(&xlen, hdr + 10, 2);
    std::vector<uint8_t> extra(xlen);
    std::fseek(f, (long)(coffset + 12), SEEK_SET);
    if (std::fread(extra.data(), 1, xlen, f) != xlen) return false;
    int bsize = -1;
    for (size_t ep = 0; ep + 4 <= extra.size();) {
      uint8_t si1 = extra[ep], si2 = extra[ep + 1];
      uint16_t slen;
      std::memcpy(&slen, extra.data() + ep + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        std::memcpy(&bs, extra.data() + ep + 4, 2);
        bsize = (int)bs + 1;
      }
      ep += 4 + slen;
    }
    if (bsize < 0) return false;
    int cdata_len = bsize - 12 - xlen - 8;
    std::vector<uint8_t> cdata(cdata_len);
    std::fseek(f, (long)(coffset + 12 + xlen), SEEK_SET);
    if (std::fread(cdata.data(), 1, cdata_len, f) != (size_t)cdata_len)
      return false;
    uint32_t isize;
    std::fseek(f, (long)(coffset + bsize - 4), SEEK_SET);
    if (std::fread(&isize, 4, 1, f) != 1) return false;
    block.resize(isize);
    if (isize > 0) {
      z_stream zs;
      std::memset(&zs, 0, sizeof zs);
      if (inflateInit2(&zs, -15) != Z_OK) return false;
      zs.next_in = cdata.data();
      zs.avail_in = cdata_len;
      zs.next_out = block.data();
      zs.avail_out = isize;
      int rc = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (rc != Z_STREAM_END) return false;
    }
    block_coffset = coffset;
    next_coffset = coffset + bsize;
    return true;
  }

  bool seek_virtual(uint64_t voffset) {
    int64_t co = (int64_t)(voffset >> 16);
    size_t wo = (size_t)(voffset & 0xffff);
    if (!load_block(co)) return false;
    if (wo > block.size()) return false;
    within = wo;
    return true;
  }

  uint64_t tell_virtual() const {
    // At a block boundary the canonical voffset points at the next block.
    if (within == block.size() && block_coffset >= 0)
      return (uint64_t)next_coffset << 16;
    return ((uint64_t)block_coffset << 16) | (uint64_t)within;
  }

  bool at_eof() {
    if (within < block.size()) return false;
    return next_coffset >= file_size;
  }

  // Read exactly n bytes across block boundaries; false at clean EOF start.
  bool read(uint8_t* dst, size_t n) {
    size_t got = 0;
    while (got < n) {
      if (within >= block.size()) {
        if (next_coffset >= file_size) return false;
        if (!load_block(next_coffset)) return false;
        within = 0;
        if (block.empty()) continue;  // EOF marker block
      }
      size_t take = std::min(n - got, block.size() - within);
      std::memcpy(dst + got, block.data() + within, take);
      within += take;
      got += take;
    }
    return true;
  }
};

// ---------------------------------------------------------------------------
// BAI index
// ---------------------------------------------------------------------------

struct Chunk {
  uint64_t beg, end;
};

struct RefIndex {
  std::map<uint32_t, std::vector<Chunk>> bins;
  std::vector<uint64_t> ioffsets;  // 16kb linear index
};

constexpr uint32_t kPseudoBin = 37450;

bool load_bai(const std::string& path, std::vector<RefIndex>& out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  auto rd = [&](void* p, size_t n) { return std::fread(p, 1, n, f) == n; };
  char magic[4];
  int32_t n_ref;
  if (!rd(magic, 4) || std::memcmp(magic, "BAI\x01", 4) != 0 ||
      !rd(&n_ref, 4)) {
    std::fclose(f);
    return false;
  }
  out.resize(n_ref);
  for (int r = 0; r < n_ref; ++r) {
    int32_t n_bin;
    if (!rd(&n_bin, 4)) goto fail;
    for (int b = 0; b < n_bin; ++b) {
      uint32_t bin;
      int32_t n_chunk;
      if (!rd(&bin, 4) || !rd(&n_chunk, 4)) goto fail;
      std::vector<Chunk> chunks(n_chunk);
      for (int c = 0; c < n_chunk; ++c)
        if (!rd(&chunks[c].beg, 8) || !rd(&chunks[c].end, 8)) goto fail;
      if (bin != kPseudoBin) out[r].bins[bin] = std::move(chunks);
    }
    int32_t n_intv;
    if (!rd(&n_intv, 4)) goto fail;
    out[r].ioffsets.resize(n_intv);
    for (int i = 0; i < n_intv; ++i)
      if (!rd(&out[r].ioffsets[i], 8)) goto fail;
  }
  std::fclose(f);
  return true;
fail:
  std::fclose(f);
  return false;
}

// Bins overlapping the 0-based half-open interval [beg, end).
void reg2bins(int64_t beg, int64_t end, std::vector<uint32_t>& bins) {
  if (beg >= end) return;
  end -= 1;
  bins.push_back(0);
  for (int64_t k = 1 + (beg >> 26); k <= 1 + (end >> 26); ++k)
    bins.push_back((uint32_t)k);
  for (int64_t k = 9 + (beg >> 23); k <= 9 + (end >> 23); ++k)
    bins.push_back((uint32_t)k);
  for (int64_t k = 73 + (beg >> 20); k <= 73 + (end >> 20); ++k)
    bins.push_back((uint32_t)k);
  for (int64_t k = 585 + (beg >> 17); k <= 585 + (end >> 17); ++k)
    bins.push_back((uint32_t)k);
  for (int64_t k = 4681 + (beg >> 14); k <= 4681 + (end >> 14); ++k)
    bins.push_back((uint32_t)k);
}

// ---------------------------------------------------------------------------
// BAM reader
// ---------------------------------------------------------------------------

const char kSeqNt[17] = "=ACMGRSVTWYHKDBN";

struct BamFile {
  BgzfStream bgzf;
  std::string header_text;
  std::vector<std::string> ref_names;
  std::vector<int64_t> ref_lens;
  std::vector<RefIndex> index;
  bool has_index = false;
  uint64_t first_rec_voffset = 0;
  std::vector<uint8_t> fetch_buf;  // packed result of the last fetch
  int64_t fetch_n = 0;

  bool open(const char* path) {
    if (!bgzf.open(path)) return false;
    uint8_t magic[4];
    if (!bgzf.seek_virtual(0) || !bgzf.read(magic, 4) ||
        std::memcmp(magic, "BAM\x01", 4) != 0)
      return false;
    int32_t l_text;
    if (!bgzf.read((uint8_t*)&l_text, 4)) return false;
    header_text.resize(l_text);
    if (l_text && !bgzf.read((uint8_t*)header_text.data(), l_text))
      return false;
    while (!header_text.empty() && header_text.back() == '\0')
      header_text.pop_back();
    int32_t n_ref;
    if (!bgzf.read((uint8_t*)&n_ref, 4)) return false;
    for (int i = 0; i < n_ref; ++i) {
      int32_t l_name, l_ref;
      if (!bgzf.read((uint8_t*)&l_name, 4)) return false;
      std::string nm(l_name, '\0');
      if (!bgzf.read((uint8_t*)nm.data(), l_name)) return false;
      while (!nm.empty() && nm.back() == '\0') nm.pop_back();
      if (!bgzf.read((uint8_t*)&l_ref, 4)) return false;
      ref_names.push_back(nm);
      ref_lens.push_back(l_ref);
    }
    first_rec_voffset = bgzf.tell_virtual();
    has_index = load_bai(std::string(path) + ".bai", index) &&
                index.size() == ref_names.size();
    return true;
  }
};

// Decode one raw BAM record body into the packed wire format (appended to
// `out`). Returns the record's (refid, pos, end).
struct RecMeta {
  int32_t refid, pos, end;
};

RecMeta pack_record(const std::vector<uint8_t>& rec,
                    std::vector<uint8_t>* out) {
  RecMeta meta{};
  int32_t pos, l_seq;
  uint32_t flag_nc, bin_mq_nl;
  std::memcpy(&meta.refid, rec.data() + 0, 4);
  std::memcpy(&pos, rec.data() + 4, 4);
  std::memcpy(&bin_mq_nl, rec.data() + 8, 4);
  std::memcpy(&flag_nc, rec.data() + 12, 4);
  std::memcpy(&l_seq, rec.data() + 16, 4);
  uint8_t l_read_name = bin_mq_nl & 0xff;
  uint8_t mapq = (bin_mq_nl >> 8) & 0xff;
  uint16_t n_cigar = flag_nc & 0xffff;
  uint16_t flag = flag_nc >> 16;
  size_t q = 32;
  const char* name = (const char*)rec.data() + q;
  uint16_t l_name = l_read_name ? (uint16_t)(l_read_name - 1) : 0;
  q += l_read_name;
  const uint8_t* cigar = rec.data() + q;
  // half-open end position: pos + sum of M/D/N/=/X op lengths
  int64_t span = 0;
  for (int c = 0; c < n_cigar; ++c) {
    uint32_t v;
    std::memcpy(&v, cigar + 4 * c, 4);
    uint32_t op = v & 0xf;
    // ops M(0) D(2) N(3) =(7) X(8) consume reference
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += v >> 4;
  }
  q += 4ull * n_cigar;
  const uint8_t* seq4 = rec.data() + q;
  q += (l_seq + 1) / 2;
  const uint8_t* qual = rec.data() + q;
  q += l_seq;
  const uint8_t* tags = rec.data() + q;
  int32_t l_tags = (int32_t)(rec.size() - q);
  uint8_t has_qual = (l_seq > 0 && qual[0] != 0xff) ? 1 : 0;
  meta.pos = pos;
  meta.end = (int32_t)(pos + span);

  if (out) {
    size_t base = out->size();
    size_t total = 24 + l_name + 4ull * n_cigar + (size_t)l_seq +
                   (has_qual ? (size_t)l_seq : 0) + (size_t)l_tags;
    out->resize(base + total);
    uint8_t* w = out->data() + base;
    std::memcpy(w + 0, &meta.pos, 4);
    std::memcpy(w + 4, &meta.end, 4);
    std::memcpy(w + 8, &flag, 2);
    w[10] = mapq;
    w[11] = has_qual;
    std::memcpy(w + 12, &n_cigar, 2);
    std::memcpy(w + 14, &l_name, 2);
    std::memcpy(w + 16, &l_seq, 4);
    std::memcpy(w + 20, &l_tags, 4);
    w += 24;
    std::memcpy(w, name, l_name);
    w += l_name;
    std::memcpy(w, cigar, 4ull * n_cigar);
    w += 4ull * n_cigar;
    for (int i = 0; i < l_seq; ++i)
      w[i] = kSeqNt[(i & 1) ? (seq4[i >> 1] & 0xf) : (seq4[i >> 1] >> 4)];
    w += l_seq;
    if (has_qual) {
      for (int i = 0; i < l_seq; ++i) w[i] = (uint8_t)(qual[i] + 33);
      w += l_seq;
    }
    std::memcpy(w, tags, l_tags);
  }
  return meta;
}

bool read_record(BgzfStream& s, std::vector<uint8_t>& rec) {
  int32_t block_size;
  if (!s.read((uint8_t*)&block_size, 4)) return false;
  if (block_size <= 0 || block_size > (1 << 28)) return false;
  rec.resize(block_size);
  return s.read(rec.data(), block_size);
}

}  // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

void* lbam_open(const char* path) {
  auto* b = new BamFile();
  if (!b->open(path)) {
    b->bgzf.close();
    delete b;
    return nullptr;
  }
  return b;
}

void lbam_close(void* h) {
  auto* b = (BamFile*)h;
  b->bgzf.close();
  delete b;
}

const char* lbam_header_text(void* h) {
  return ((BamFile*)h)->header_text.c_str();
}

int lbam_nrefs(void* h) { return (int)((BamFile*)h)->ref_names.size(); }

const char* lbam_ref_name(void* h, int i) {
  return ((BamFile*)h)->ref_names[i].c_str();
}

long lbam_ref_len(void* h, int i) {
  return (long)((BamFile*)h)->ref_lens[i];
}

int lbam_has_index(void* h) { return ((BamFile*)h)->has_index ? 1 : 0; }

// Fetch records on refid with pos <= end && end_position >= beg
// (0-based inclusive [beg, end]; same superset contract as the Python
// reader: containment filtering is the caller's job, mirroring the
// reference's SetRegion + in-loop checks, Microassembler.cc:498-500).
// Returns a malloc'd packed buffer; *out_n records, *out_size bytes.
uint8_t* lbam_fetch(void* h, int refid, long beg, long end, long* out_n,
                    long* out_size) {
  auto* b = (BamFile*)h;
  b->fetch_buf.clear();
  b->fetch_n = 0;
  std::vector<Chunk> chunks;
  if (b->has_index && refid >= 0 && refid < (int)b->index.size()) {
    const RefIndex& ri = b->index[refid];
    uint64_t min_off = 0;
    size_t intv = (size_t)(beg >> 14);
    if (intv < ri.ioffsets.size()) min_off = ri.ioffsets[intv];
    std::vector<uint32_t> bins;
    reg2bins(beg, end + 1, bins);
    for (uint32_t bin : bins) {
      auto it = ri.bins.find(bin);
      if (it == ri.bins.end()) continue;
      for (const Chunk& c : it->second)
        if (c.end > min_off) chunks.push_back(c);
    }
    std::sort(chunks.begin(), chunks.end(),
              [](const Chunk& a, const Chunk& c) { return a.beg < c.beg; });
    // merge overlapping/adjacent chunks
    std::vector<Chunk> merged;
    for (const Chunk& c : chunks) {
      if (!merged.empty() && c.beg <= merged.back().end)
        merged.back().end = std::max(merged.back().end, c.end);
      else
        merged.push_back(c);
    }
    chunks = std::move(merged);
  } else {
    chunks.push_back({b->first_rec_voffset, (uint64_t)b->bgzf.file_size << 16});
  }

  std::vector<uint8_t> rec;
  for (const Chunk& c : chunks) {
    if (!b->bgzf.seek_virtual(c.beg)) continue;
    while (b->bgzf.tell_virtual() < c.end && !b->bgzf.at_eof()) {
      if (!read_record(b->bgzf, rec)) break;
      RecMeta m = pack_record(rec, nullptr);
      if (m.refid != refid) {
        if (b->has_index) continue;  // chunked: shouldn't happen, skip
        if (m.refid > refid) break;  // coordinate-sorted full scan
        continue;
      }
      if (m.pos > end) break;  // sorted within chunk run
      if (m.end >= beg) {
        pack_record(rec, &b->fetch_buf);
        b->fetch_n++;
      }
    }
  }
  *out_n = b->fetch_n;
  *out_size = (long)b->fetch_buf.size();
  if (b->fetch_buf.empty()) return nullptr;
  auto* out = (uint8_t*)std::malloc(b->fetch_buf.size());
  std::memcpy(out, b->fetch_buf.data(), b->fetch_buf.size());
  return out;
}

// First record in the file (packed), for header/tag probes.
uint8_t* lbam_first(void* h, long* out_n, long* out_size) {
  auto* b = (BamFile*)h;
  *out_n = 0;
  *out_size = 0;
  std::vector<uint8_t> rec;
  if (!b->bgzf.seek_virtual(b->first_rec_voffset)) return nullptr;
  if (b->bgzf.at_eof() || !read_record(b->bgzf, rec)) return nullptr;
  std::vector<uint8_t> buf;
  pack_record(rec, &buf);
  *out_n = 1;
  *out_size = (long)buf.size();
  auto* out = (uint8_t*)std::malloc(buf.size());
  std::memcpy(out, buf.data(), buf.size());
  return out;
}

void lbam_free(uint8_t* p) { std::free(p); }

// ---------------------------------------------------------------------------
// FASTA + .fai
// ---------------------------------------------------------------------------

struct FaEntry {
  std::string name;
  int64_t length, offset, linebases, linewidth;
};

struct FaFile {
  FILE* f = nullptr;
  std::vector<FaEntry> entries;
  std::map<std::string, size_t> by_name;
};

void* lfa_open(const char* path) {
  std::string fai = std::string(path) + ".fai";
  FILE* idx = std::fopen(fai.c_str(), "rb");
  if (!idx) return nullptr;
  auto* fa = new FaFile();
  char line[4096];
  while (std::fgets(line, sizeof line, idx)) {
    FaEntry e;
    char name[2048];
    long long len, off, lb, lw;
    if (std::sscanf(line, "%2047s\t%lld\t%lld\t%lld\t%lld", name, &len, &off,
                    &lb, &lw) == 5) {
      e.name = name;
      e.length = len;
      e.offset = off;
      e.linebases = lb;
      e.linewidth = lw;
      fa->by_name[e.name] = fa->entries.size();
      fa->entries.push_back(e);
    }
  }
  std::fclose(idx);
  fa->f = std::fopen(path, "rb");
  if (!fa->f) {
    delete fa;
    return nullptr;
  }
  return fa;
}

void lfa_close(void* h) {
  auto* fa = (FaFile*)h;
  if (fa->f) std::fclose(fa->f);
  delete fa;
}

long lfa_nseqs(void* h) { return (long)((FaFile*)h)->entries.size(); }

const char* lfa_name(void* h, long i) {
  return ((FaFile*)h)->entries[i].name.c_str();
}

long lfa_len(void* h, long i) {
  return (long)((FaFile*)h)->entries[i].length;
}

// 1-based inclusive fetch, clamped to [1, length]; caller frees.
char* lfa_fetch(void* h, const char* chrom, long start, long end,
                long* out_len) {
  auto* fa = (FaFile*)h;
  *out_len = 0;
  auto it = fa->by_name.find(chrom);
  if (it == fa->by_name.end()) return nullptr;
  const FaEntry& e = fa->entries[it->second];
  if (start < 1) start = 1;
  if (end > e.length) end = (long)e.length;
  if (end < start) return nullptr;
  int64_t s0 = start - 1, e0 = end;
  int64_t byte_start =
      e.offset + (s0 / e.linebases) * e.linewidth + (s0 % e.linebases);
  int64_t byte_end = e.offset + ((e0 - 1) / e.linebases) * e.linewidth +
                     ((e0 - 1) % e.linebases) + 1;
  std::vector<char> raw(byte_end - byte_start);
  std::fseek(fa->f, (long)byte_start, SEEK_SET);
  size_t got = std::fread(raw.data(), 1, raw.size(), fa->f);
  auto* out = (char*)std::malloc(e0 - s0 + 1);
  long n = 0;
  for (size_t i = 0; i < got; ++i)
    if (raw[i] != '\n' && raw[i] != '\r') out[n++] = raw[i];
  out[n] = '\0';
  *out_len = n;
  return out;
}

void lfa_free(char* p) { std::free(p); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Colored-DBG build kernel (host compute plane).
//
// Native equivalent of engine/fastbuild.py's numpy passes (which themselves
// replace the reference's per-character k-mer stream, Graph.cc:119-349):
// canonical-mer grouping, per-node coverage / min-quality counters, status
// colors, first-occurrence creation order, directed edge list ordered by
// first event time, the mate-overlap dedup replay (std::binary_search over
// push-ordered name vectors — here run natively, exactly the reference's
// call, Graph.cc:232-317 / Node.cc:638-671), reference-mer membership, and
// the fused removeLowCov prune decision (Graph.cc:2790-2827).
//
// Input is the concatenated post-trim read bytes/qualities with K+1-byte
// 0xFF gaps (same layout fastbuild builds); outputs are flat arrays the
// Python side materializes into Node objects. Equality with the numpy path
// (and transitively the oracle engine) is asserted by tests.
// ---------------------------------------------------------------------------

#include <string_view>
#include <unordered_map>
#include <unordered_set>

namespace lgb {

struct Out {
  int64_t n_nodes = 0, n_edges = 0;
  uint8_t* mers = nullptr;      // n_nodes*K canonical bytes, creation order
  int32_t* cov = nullptr;       // 4*n_nodes: fwd_t, rev_t, fwd_n, rev_n
  int32_t* mq = nullptr;        // 4*n_nodes*K: mqf_t, mqr_t, mqf_n, mqr_n
  uint8_t* flags = nullptr;     // bit0 tumor, bit1 normal, bit2 in_ref,
                                // bit3 low, bit4..7 seen f/r tumor, f/r normal
  int32_t* mincov_qv = nullptr; // n_nodes
  int32_t* tot_cov = nullptr;   // n_nodes
  int32_t* esrc = nullptr;      // surviving edges, event-time order
  int32_t* edst = nullptr;
  uint8_t* edir = nullptr;      // 0=FF 1=FR 2=RF 3=RR
  // LR (linked-read) mode extras (ref: Microassembler.cc:582-593,
  // Node.cc:470-520, Graph.cc LR blocks). Null unless lr_mode.
  int32_t* lr_cov = nullptr;    // 4*n_nodes assigned bx counts tf,tr,nf,nr
  int32_t* lr_hp = nullptr;     // 6*n_nodes assigned hp t0,t1,t2,n0,n1,n2
  int32_t* lr_hpq = nullptr;    // 6*n_nodes*K per-base hp minqv counts
  uint8_t* lr_hpseen = nullptr; // bit0: tumor visited non-skip, bit1: normal
  std::vector<std::vector<int32_t>> bx_ids_t, bx_ids_n;  // per-node bx ids
};

constexpr uint8_t F_TUMOR = 1, F_NORMAL = 2, F_INREF = 4, F_LOW = 8,
                  F_SEENF_T = 16, F_SEENR_T = 32, F_SEENF_N = 64,
                  F_SEENR_N = 128;

struct SvHash {
  size_t operator()(std::string_view s) const noexcept {
    return std::hash<std::string_view>{}(s);
  }
};

inline void comp_table(uint8_t* t) {
  std::memset(t, 0, 256);
  const char* a = "ACGTacgtNn";
  const char* b = "TGCAtgcaNn";
  for (int i = 0; i < 10; ++i) t[(uint8_t)a[i]] = (uint8_t)b[i];
}

// 64-bit byte hash (8-byte strides, xorshift mix); nonzero by construction
// so 0 can mark empty slots in the open-addressing tables below.
inline uint64_t hash_bytes(const uint8_t* p, int len) {
  uint64_t h = 1469598103934665603ull;
  int i = 0;
  for (; i + 8 <= len; i += 8) {
    uint64_t w;
    std::memcpy(&w, p + i, 8);
    h = (h ^ w) * 0x9E3779B97F4A7C15ull;
    h ^= h >> 29;
  }
  if (i < len) {
    uint64_t w = 0;
    std::memcpy(&w, p + i, len - i);
    h = (h ^ w) * 0x9E3779B97F4A7C15ull;
    h ^= h >> 29;
  }
  return h | 1;
}

// Open-addressing mer-dedup table: stores (hash, node id); the canonical
// bytes live in `rep`, collisions verify with memcmp. Replaces the
// per-call unordered_map (allocation + chained probes dominated the
// build-kernel profile). Purely a dedup mechanism: node creation order
// (first occurrence) is unchanged.
struct FlatNodeMap {
  std::vector<uint64_t> hash;
  std::vector<int32_t> val;
  uint64_t mask = 0;
  void init(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    if (hash.size() != cap) {
      hash.assign(cap, 0);
      val.assign(cap, 0);
    } else {
      std::fill(hash.begin(), hash.end(), 0);
    }
    mask = cap - 1;
  }
};

// Open-addressing u64 -> i64 min-map (edge event times); empty = val
// INT64_MIN.
struct FlatU64Map {
  std::vector<uint64_t> key;
  std::vector<int64_t> val;
  uint64_t mask = 0;
  size_t used = 0;
  void init(size_t expected) {
    size_t cap = 16;
    while (cap < expected * 2) cap <<= 1;
    if (key.size() != cap) {
      key.assign(cap, 0);
      val.assign(cap, INT64_MIN);
    } else {
      std::fill(val.begin(), val.end(), INT64_MIN);
    }
    mask = cap - 1;
    used = 0;
  }
  static uint64_t mix(uint64_t k) {
    k ^= k >> 33;
    k *= 0xFF51AFD7ED558CCDull;
    k ^= k >> 33;
    return k;
  }
  void update_min(uint64_t k, int64_t t) {
    size_t i = mix(k) & mask;
    while (true) {
      if (val[i] == INT64_MIN) {
        key[i] = k;
        val[i] = t;
        ++used;
        return;
      }
      if (key[i] == k) {
        if (val[i] > t) val[i] = t;
        return;
      }
      i = (i + 1) & mask;
    }
  }
};

inline uint64_t mix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xFF51AFD7ED558CCDull;
  k ^= k >> 33;
  k *= 0xC4CEB9FE1A85EC53ull;
  k ^= k >> 33;
  return k;
}

// 2-bit base codes (A=0 C=1 G=2 T=3; 4 = anything else). The 2-bit
// big-endian packing of a window preserves byte-lexicographic order, so
// packed-integer compare == memcmp for clean (all-ACGT) windows.
inline const uint8_t* code2_table() {
  static const auto t = [] {
    static uint8_t a[256];
    std::memset(a, 4, 256);
    a[(uint8_t)'A'] = 0;
    a[(uint8_t)'C'] = 1;
    a[(uint8_t)'G'] = 2;
    a[(uint8_t)'T'] = 3;
    return a;
  }();
  return t;
}

// per-thread reusable scratch (one lgb_build runs per thread at a time)
struct Scratch {
  std::vector<uint8_t> rc_cat, orif, skip, rc_ref;
  std::vector<int32_t> qbad, nid, vread, vpos, badp, clean_cnt, m_cnt,
      m_fill;
  std::vector<int64_t> m_off;
  std::vector<std::string_view> m_flat;
  std::vector<const uint8_t*> canon;
  std::vector<const uint8_t*> rep;
  FlatNodeMap node_map;
  FlatU64Map edge_map;
  int lookup_k = 0;  // K of the last build (scratch_lookup validity)
};

// Probe the last build's node table (same thread) for a canonical mer;
// -1 when absent. `h` must come from scratch_hash below.
inline int32_t scratch_lookup(Scratch& scr, const uint8_t* cn, int K,
                              uint64_t h) {
  size_t slot = h & scr.node_map.mask;
  while (scr.node_map.hash[slot] != 0) {
    if (scr.node_map.hash[slot] == h &&
        std::memcmp(scr.rep[scr.node_map.val[slot]], cn, K) == 0)
      return scr.node_map.val[slot];
    slot = (slot + 1) & scr.node_map.mask;
  }
  return -1;
}

// Hash a canonical mer with the same class rule the build used: clean
// (all-ACGT) windows hash their 2-bit packing, dirty windows hash bytes.
inline uint64_t scratch_hash(const uint8_t* cn, int K) {
  if (K <= 31) {
    const uint8_t* code2 = code2_table();
    uint64_t v = 0;
    bool clean = true;
    for (int j = 0; j < K; ++j) {
      const uint8_t c = code2[cn[j]];
      clean &= c < 4;
      v = (v << 2) | (c & 3);
    }
    if (clean) return mix64(v) | 1;
  }
  return hash_bytes(cn, K);
}
inline Scratch& scratch() {
  thread_local Scratch s;
  return s;
}

}  // namespace lgb

// Build the window's colored DBG arrays. See Out for the result layout.
// sample: TMR=4 NML=5 (REF pseudo-read = 3); strand: FWD=1 REV=2.
// bx/hp: per-read BX barcode id (-1 = null) and HP haplotype (0..2);
// both null unless lr_mode (ref: Microassembler.cc:582-593).
static void* lgb_build_impl(
    const uint8_t* cat, const uint8_t* qcat, int64_t tot,
    int64_t n_reads, const int64_t* starts, const int32_t* lens,
    const int32_t* sample, const int32_t* strand,
    const int32_t* order, const int64_t* name_off,
    const uint8_t* name_blob, int K, int minq, double avgcov,
    int low_cov_threshold, double min_cov_ratio,
    const uint8_t* refseq, int64_t reflen,
    const int32_t* bx, const int32_t* hp, int lr_mode) {
  auto* out = new lgb::Out();
  uint8_t comp[256];
  lgb::comp_table(comp);

  lgb::Scratch& scr = lgb::scratch();

  // reverse complement of the whole concatenated stream: the revcomp of the
  // K-window at offset o is rc_cat[tot - o - K .. tot - o).
  scr.rc_cat.resize(tot);
  uint8_t* rc_cat = scr.rc_cat.data();
  for (int64_t i = 0; i < tot; ++i) rc_cat[i] = comp[cat[tot - 1 - i]];

  // per-mer visit tables ----------------------------------------------------
  int64_t n_mers = 0;
  for (int64_t r = 0; r < n_reads; ++r) n_mers += lens[r] - K + 1;
  scr.nid.resize(n_mers);    // node id (first-occurrence order)
  scr.orif.resize(n_mers);   // canonical orientation forward?
  scr.vread.resize(n_mers);  // read index
  scr.vpos.resize(n_mers);   // mer offset within read
  scr.canon.resize(n_mers);
  int32_t* nid = scr.nid.data();
  uint8_t* orif = scr.orif.data();
  int32_t* vread = scr.vread.data();
  int32_t* vpos = scr.vpos.data();
  const uint8_t** canon = scr.canon.data();

  // quality prefix: ok(o) == no byte in qcat[o..o+K] below minq (gap bytes
  // are 0, always below, so cross-read windows self-mask)
  scr.qbad.resize(tot + 1);
  int32_t* qbad = scr.qbad.data();
  qbad[0] = 0;
  for (int64_t i = 0; i < tot; ++i)
    qbad[i + 1] = qbad[i] + (qcat[i] < minq ? 1 : 0);
  auto pair_ok_at = [&](int64_t o) {
    if (o + K >= tot) return false;
    return qbad[o + K + 1] - qbad[o] == 0;
  };

  lgb::FlatNodeMap& node_map = scr.node_map;
  node_map.init((size_t)n_mers);
  std::vector<const uint8_t*>& rep = scr.rep;  // canonical bytes per node
  rep.clear();
  scr.lookup_k = K;

  // non-ACGT prefix over the concatenated stream (gap bytes count, so
  // cross-read windows are always "dirty" — they never occur as visits)
  const uint8_t* code2 = lgb::code2_table();
  const bool packable = K <= 31;
  scr.badp.resize(tot + 1);
  int32_t* badp = scr.badp.data();
  if (packable) {
    badp[0] = 0;
    for (int64_t i = 0; i < tot; ++i)
      badp[i + 1] = badp[i] + (code2[cat[i]] >= 4 ? 1 : 0);
  }
  const uint64_t mask2k =
      (K < 32) ? ((1ull << (2 * K)) - 1) : ~0ull;
  const int shift_hi = 2 * (K - 1);

  int64_t g = 0;
  for (int64_t r = 0; r < n_reads; ++r) {
    const int32_t nm = lens[r] - K + 1;
    const int64_t base = starts[r];
    uint64_t fw2 = 0, rc2 = 0;
    if (packable) {
      for (int j = 0; j < K - 1; ++j) {
        const uint8_t c = code2[cat[base + j]] & 3;
        fw2 = ((fw2 << 2) | c) & mask2k;
        rc2 = (rc2 >> 2) | ((uint64_t)(3 - c) << shift_hi);
      }
    }
    for (int32_t p = 0; p < nm; ++p, ++g) {
      const int64_t o = base + p;
      const uint8_t* fw = cat + o;
      const uint8_t* rc = rc_cat + (tot - o - K);
      bool isF;
      const uint8_t* cn;
      uint64_t h;
      if (packable) {
        const uint8_t c = code2[cat[o + K - 1]] & 3;
        fw2 = ((fw2 << 2) | c) & mask2k;
        rc2 = (rc2 >> 2) | ((uint64_t)(3 - c) << shift_hi);
      }
      if (packable && badp[o + K] - badp[o] == 0) {
        // clean window: packed compare == memcmp (order-preserving codes);
        // palindrome (fw2 == rc2) orients R like the oracle
        isF = fw2 < rc2;
        cn = isF ? fw : rc;
        h = lgb::mix64(isF ? fw2 : rc2) | 1;
      } else {
        const int c = std::memcmp(fw, rc, K);
        isF = c < 0;
        cn = isF ? fw : rc;
        h = lgb::hash_bytes(cn, K);
      }
      size_t slot = h & node_map.mask;
      int32_t id;
      while (true) {
        if (node_map.hash[slot] == 0) {
          node_map.hash[slot] = h;
          id = (int32_t)rep.size();
          node_map.val[slot] = id;
          rep.push_back(cn);
          break;
        }
        if (node_map.hash[slot] == h &&
            std::memcmp(rep[node_map.val[slot]], cn, K) == 0) {
          id = node_map.val[slot];
          break;
        }
        slot = (slot + 1) & node_map.mask;
      }
      nid[g] = id;
      orif[g] = isF;
      vread[g] = (int32_t)r;
      vpos[g] = p;
      canon[g] = cn;
    }
  }
  const int64_t n_nodes = (int64_t)rep.size();

  // mate-overlap dedup replay (paired, non-ref visits only): per pair p
  // (mer p non-last) the reference pushes u then v, probes u iff pos==0,
  // then probes v — std::binary_search over the OTHER mate-order's
  // push-ordered (unsorted) vector.
  scr.skip.assign(n_mers, 0);
  uint8_t* skip = scr.skip.data();
  {
    bool any_paired = false;
    for (int64_t r = 0; r < n_reads; ++r)
      if (order[r] > 0) { any_paired = true; break; }
    if (any_paired) {
      // flat replay of the reference's per-node push-ordered name vectors
      // (same pushes, same std::binary_search-over-unsorted-data quirk,
      // same interleaving): pass 1 counts pushes per (node, mate order),
      // pass 2 replays pushes into prefix-offset slots and probes over
      // the other order's filled prefix — the exact state the reference's
      // vector would hold at that probe. Avoids 2*n_nodes vector allocs
      // per (window, k) call.
      auto name_of = [&](int32_t r) {
        return std::string_view((const char*)name_blob + name_off[r],
                                (size_t)(name_off[r + 1] - name_off[r]));
      };
      auto visit_paired = [&](int64_t i) {
        const int32_t r = vread[i];
        return order[r] > 0 && sample[r] != 3 && vpos[i] != lens[r] - K;
      };
      scr.m_cnt.assign((size_t)n_nodes * 2, 0);
      int32_t* mcnt = scr.m_cnt.data();  // [order0: n_nodes][order1: ...]
      for (int64_t i = 0; i < n_mers; ++i) {
        if (!visit_paired(i)) continue;
        const int64_t b = (order[vread[i]] == 1) ? 0 : n_nodes;
        ++mcnt[b + nid[i]];
        ++mcnt[b + nid[i + 1]];
      }
      scr.m_off.resize((size_t)n_nodes * 2 + 1);
      int64_t* moff = scr.m_off.data();
      moff[0] = 0;
      for (int64_t n2 = 0; n2 < n_nodes * 2; ++n2)
        moff[n2 + 1] = moff[n2] + mcnt[n2];
      scr.m_flat.resize((size_t)moff[n_nodes * 2]);
      std::string_view* mflat = scr.m_flat.data();
      scr.m_fill.assign((size_t)n_nodes * 2, 0);
      int32_t* mfill = scr.m_fill.data();
      auto probe = [&](int64_t b_other, int64_t n, std::string_view nm) {
        const std::string_view* first = mflat + moff[b_other + n];
        return std::binary_search(first, first + mfill[b_other + n], nm);
      };
      for (int64_t i = 0; i < n_mers; ++i) {
        if (!visit_paired(i)) continue;
        const int32_t o = order[vread[i]];
        const int64_t b_self = (o == 1) ? 0 : n_nodes;
        const int64_t b_other = (o == 1) ? n_nodes : 0;
        const std::string_view nm = name_of(vread[i]);
        const int64_t u = nid[i], v = nid[i + 1];
        mflat[moff[b_self + u] + mfill[b_self + u]++] = nm;
        mflat[moff[b_self + v] + mfill[b_self + v]++] = nm;
        if (vpos[i] == 0 && probe(b_other, u, nm)) skip[i] = 1;
        if (probe(b_other, v, nm)) skip[i + 1] = 1;
      }
    }
  }

  // counters / flags ----------------------------------------------------
  out->n_nodes = n_nodes;
  out->mers = (uint8_t*)std::malloc((size_t)n_nodes * K);
  for (int64_t n = 0; n < n_nodes; ++n)
    std::memcpy(out->mers + n * K, rep[n], K);
  out->cov = (int32_t*)std::calloc((size_t)n_nodes * 4, 4);
  out->mq = (int32_t*)std::calloc((size_t)n_nodes * 4 * K, 4);
  out->flags = (uint8_t*)std::calloc(n_nodes, 1);
  out->mincov_qv = (int32_t*)std::malloc((size_t)n_nodes * 4);
  out->tot_cov = (int32_t*)std::malloc((size_t)n_nodes * 4);
  int32_t* cov = out->cov;
  int32_t* mq = out->mq;
  uint8_t* flags = out->flags;
  scr.clean_cnt.assign((size_t)n_nodes * 4, 0);
  int32_t* clean = scr.clean_cnt.data();

  for (int64_t i = 0; i < n_mers; ++i) {
    const int32_t r = vread[i];
    const int32_t sm = sample[r];
    if (sm == 3) continue;  // ref pseudo-read: no coverage, no colors
    const int64_t n = nid[i];
    if (sm == 5) flags[n] |= lgb::F_NORMAL;  // unconditional, incl. skipped
    // tumor color: quality-clean (K+1)-window pair, u and v side
    if (sm == 4 && vpos[i] != lens[r] - K) {
      const int64_t o = starts[r] + vpos[i];
      if (pair_ok_at(o)) {
        flags[n] |= lgb::F_TUMOR;
        flags[nid[i + 1]] |= lgb::F_TUMOR;
      }
    }
    if (skip[i]) continue;  // dedup-skipped coverage visit
    const bool fwd = strand[r] == 1;
    const int col = (sm == 4 ? 0 : 2) + (fwd ? 0 : 1);
    cov[n * 4 + col] += 1;
    flags[n] |= (uint8_t)(lgb::F_SEENF_T << col);
    // per-base min-quality counts in canonical orientation. Fast path:
    // when every base of the window passes minq (the common case — one
    // qbad prefix lookup), defer to a scalar per (col, node) that a
    // single broadcast pass adds to all K positions afterwards.
    const int64_t o = starts[r] + vpos[i];
    if (qbad[o + K] - qbad[o] == 0) {
      clean[(int64_t)col * n_nodes + n] += 1;
      continue;
    }
    int32_t* row = mq + ((int64_t)col * n_nodes + n) * K;
    if (orif[i]) {
      const uint8_t* q = qcat + o;
      for (int j = 0; j < K; ++j) row[j] += (q[j] >= minq);
    } else {
      const uint8_t* q = qcat + o + K - 1;
      for (int j = 0; j < K; ++j) row[j] += (q[-j] >= minq);
    }
  }
  for (int64_t cn_i = 0; cn_i < n_nodes * 4; ++cn_i) {
    const int32_t c = clean[cn_i];
    if (!c) continue;
    int32_t* row = mq + cn_i * K;
    for (int j = 0; j < K; ++j) row[j] += c;
  }

  // --- LR (linked-read) pass: replay of the oracle's per-visit BX/HP
  // bookkeeping (graph.py load_sequence LR blocks; ref Graph.cc LR,
  // Node.cc:470-520). A separate pass over the same visit stream keeps
  // the hot non-LR loop untouched: bx/hp adds run for EVERY visit (the
  // mate-overlap dedup guard only gates the cov-distr assignments), and
  // the assigned values are whatever the counts were at the last
  // NON-skipped visit -- order matters, so this is a replay, not a
  // post-hoc aggregate.
  if (lr_mode && bx != nullptr && hp != nullptr) {
    out->lr_cov = (int32_t*)std::calloc((size_t)n_nodes * 4, 4);
    out->lr_hp = (int32_t*)std::calloc((size_t)n_nodes * 6, 4);
    out->lr_hpq = (int32_t*)std::calloc((size_t)n_nodes * 6 * K, 4);
    out->lr_hpseen = (uint8_t*)std::calloc((size_t)n_nodes, 1);
    out->bx_ids_t.assign((size_t)n_nodes, {});
    out->bx_ids_n.assign((size_t)n_nodes, {});
    // per-node transient state: first-seen-strand bx counts + hp counts
    // + last-assigned hp snapshot (for the compare-and-set hpq update)
    std::vector<int32_t> cnt((size_t)n_nodes * 4, 0);
    std::vector<int32_t> hpcnt((size_t)n_nodes * 6, 0);
    std::vector<int32_t> asg_hp((size_t)n_nodes * 6, 0);
    // per-(node, sample) dirty bit: set when hpcnt changes, cleared by
    // an assignment. When clear, asg_hp == hpcnt for all 3 slots, so
    // the compare-and-set sweep below is a provable no-op — most visits
    // are repeat visits of known barcodes, so this skips the sweep.
    std::vector<uint8_t> hp_dirty((size_t)n_nodes * 2, 0);
    for (int64_t i = 0; i < n_mers; ++i) {
      const int32_t r = vread[i];
      const int32_t sm = sample[r];
      if (sm == 3) continue;  // ref pseudo-read: bx null, hp no-op
      const int sIdx = (sm == 4) ? 0 : 1;
      const int st = (strand[r] == 1) ? 0 : 1;
      const int64_t n = nid[i];
      const int32_t b = bx[r];
      const int h3 = hp[r] >= 0 && hp[r] <= 2 ? hp[r] : 0;
      // node.has_bx(bx, sample): null bx is never in the sets
      // (linear scan measured faster than a hash set here: per-node
      // barcode lists stay short and the scan is cache-resident)
      auto& ids = (sIdx == 0) ? out->bx_ids_t[n] : out->bx_ids_n[n];
      bool have = false;
      if (b >= 0)
        for (int32_t x : ids)
          if (x == b) { have = true; break; }
      if (!have) {
        if (b >= 0) {
          ids.push_back(b);
          cnt[n * 4 + sIdx * 2 + st] += 1;  // first-seen strand
        }
        // add_hp runs whenever has_bx() is false -- including null bx,
        // so null-bx reads bump hp counts on every visit (oracle quirk)
        hpcnt[n * 6 + sIdx * 3 + h3] += 1;
        hp_dirty[n * 2 + sIdx] = 1;
      }
      if (skip[i]) continue;  // mate-overlap dedup: no assignment
      // update_cov_distr(bx_cnt, qv, strand, sample): row assignment of
      // the visited strand's column
      out->lr_cov[n * 4 + sIdx * 2 + st] = cnt[n * 4 + sIdx * 2 + st];
      out->lr_hpseen[n] |= (uint8_t)(1 << sIdx);
      if (!hp_dirty[n * 2 + sIdx]) continue;  // sweep would be a no-op
      hp_dirty[n * 2 + sIdx] = 0;
      // update_hp_cov_distr: per-base minqv increments where the stored
      // (last-assigned) hp count is below the current one, then assign
      const int64_t o = starts[r] + vpos[i];
      for (int h2 = 0; h2 < 3; ++h2) {
        const int64_t sl = (int64_t)sIdx * 3 + h2;
        const int32_t cur = hpcnt[n * 6 + sl];
        if (asg_hp[n * 6 + sl] < cur) {
          int32_t* rowq = out->lr_hpq + (sl * n_nodes + n) * K;
          if (orif[i]) {
            const uint8_t* q = qcat + o;
            for (int j2 = 0; j2 < K; ++j2) rowq[j2] += (q[j2] >= minq);
          } else {
            const uint8_t* q = qcat + o + K - 1;
            for (int j2 = 0; j2 < K; ++j2) rowq[j2] += (q[-j2] >= minq);
          }
        }
        asg_hp[n * 6 + sl] = cur;
        out->lr_hp[n * 6 + sl] = cur;
      }
    }
  }

  // reference-window mer membership (markRefNodes at k-mer stage): the
  // per-k index covers offsets [0, reflen-K) of the *trimmed* window seq
  // (final mer excluded, Ref.cc:51).
  {
    scr.rc_ref.resize(reflen);
    uint8_t* rc_ref = scr.rc_ref.data();
    for (int64_t i = 0; i < reflen; ++i)
      rc_ref[i] = comp[refseq[reflen - 1 - i]];
    const int64_t nref = reflen - K;  // final mer excluded
    for (int64_t i = 0; i < nref; ++i) {
      const uint8_t* fw = refseq + i;
      const uint8_t* rc = rc_ref + (reflen - i - K);
      const uint8_t* cn = std::memcmp(fw, rc, K) < 0 ? fw : rc;
      const int32_t id = lgb::scratch_lookup(scr, cn, K,
                                             lgb::scratch_hash(cn, K));
      if (id >= 0) flags[id] |= lgb::F_INREF;
    }
  }

  // prune decision (removeLowCov semantics fused at k-mer stage) ---------
  std::vector<uint8_t> low(n_nodes, 0);
  for (int64_t n = 0; n < n_nodes; ++n) {
    int32_t mqv = INT32_MAX;
    for (int j = 0; j < K; ++j) {
      int32_t s = 0;
      for (int c = 0; c < 4; ++c) s += mq[((int64_t)c * n_nodes + n) * K + j];
      if (s < mqv) mqv = s;
    }
    const int32_t ft = cov[n * 4 + 0], rt = cov[n * 4 + 1];
    const int32_t fn = cov[n * 4 + 2], rn = cov[n * 4 + 3];
    out->mincov_qv[n] = mqv;
    out->tot_cov[n] = ft + rt + fn + rn;
    if (mqv <= low_cov_threshold || (double)mqv <= min_cov_ratio * avgcov ||
        (ft + rt == 1 && fn + rn == 1)) {
      low[n] = 1;
      flags[n] |= lgb::F_LOW;
    }
  }

  // edges: per pair two directed edges with event times 2p / 2p+1; unique
  // (src,dst,dir) keeps min time; output = survivors sorted by that time
  // (times are globally distinct, so no tie-break is ever consulted).
  {
    lgb::FlatU64Map& emin = scr.edge_map;
    emin.init((size_t)n_mers * 2);
    for (int64_t i = 0; i < n_mers; ++i) {
      const int32_t r = vread[i];
      if (vpos[i] == lens[r] - K) continue;
      const int64_t u = nid[i], v = nid[i + 1];
      if (low[u] || low[v]) continue;
      const bool uF = orif[i], vF = orif[i + 1];
      const uint8_t fd = uF ? (vF ? 0 : 1) : (vF ? 2 : 3);
      const uint8_t rd = uF ? (vF ? 3 : 1) : (vF ? 2 : 0);
      const uint64_t kf = ((uint64_t)u << 34) | ((uint64_t)v << 2) | fd;
      const uint64_t kr = ((uint64_t)v << 34) | ((uint64_t)u << 2) | rd;
      emin.update_min(kf, 2 * i);
      emin.update_min(kr, 2 * i + 1);
    }
    std::vector<std::pair<int64_t, uint64_t>> es;  // (time, key)
    es.reserve(emin.used);
    for (size_t i = 0; i < emin.val.size(); ++i)
      if (emin.val[i] != INT64_MIN) es.emplace_back(emin.val[i], emin.key[i]);
    std::sort(es.begin(), es.end());
    out->n_edges = (int64_t)es.size();
    out->esrc = (int32_t*)std::malloc(es.size() * 4);
    out->edst = (int32_t*)std::malloc(es.size() * 4);
    out->edir = (uint8_t*)std::malloc(es.size());
    for (size_t e = 0; e < es.size(); ++e) {
      out->esrc[e] = (int32_t)(es[e].second >> 34);
      out->edst[e] = (int32_t)((es[e].second >> 2) & ((1u << 30) - 1));
      out->edir[e] = (uint8_t)(es[e].second & 3);
    }
  }
  return out;
}

extern "C" {

// Build the window's colored DBG arrays (non-LR entry; see Out).
void* lgb_build(const uint8_t* cat, const uint8_t* qcat, int64_t tot,
                int64_t n_reads, const int64_t* starts, const int32_t* lens,
                const int32_t* sample, const int32_t* strand,
                const int32_t* order, const int64_t* name_off,
                const uint8_t* name_blob, int K, int minq, double avgcov,
                int low_cov_threshold, double min_cov_ratio,
                const uint8_t* refseq, int64_t reflen) {
  return lgb_build_impl(cat, qcat, tot, n_reads, starts, lens, sample,
                        strand, order, name_off, name_blob, K, minq, avgcov,
                        low_cov_threshold, min_cov_ratio, refseq, reflen,
                        nullptr, nullptr, 0);
}

int64_t lgb_n_nodes(void* h) { return ((lgb::Out*)h)->n_nodes; }
int64_t lgb_n_edges(void* h) { return ((lgb::Out*)h)->n_edges; }
const uint8_t* lgb_mers(void* h) { return ((lgb::Out*)h)->mers; }
const int32_t* lgb_cov(void* h) { return ((lgb::Out*)h)->cov; }
const int32_t* lgb_mq(void* h) { return ((lgb::Out*)h)->mq; }
const uint8_t* lgb_flags(void* h) { return ((lgb::Out*)h)->flags; }
const int32_t* lgb_mincov_qv(void* h) { return ((lgb::Out*)h)->mincov_qv; }
const int32_t* lgb_tot_cov(void* h) { return ((lgb::Out*)h)->tot_cov; }
const int32_t* lgb_esrc(void* h) { return ((lgb::Out*)h)->esrc; }
const int32_t* lgb_edst(void* h) { return ((lgb::Out*)h)->edst; }
const uint8_t* lgb_edir(void* h) { return ((lgb::Out*)h)->edir; }

void lgb_result_free(void* h) {
  auto* o = (lgb::Out*)h;
  std::free(o->mers);
  std::free(o->cov);
  std::free(o->mq);
  std::free(o->flags);
  std::free(o->mincov_qv);
  std::free(o->tot_cov);
  std::free(o->esrc);
  std::free(o->edst);
  std::free(o->edir);
  std::free(o->lr_cov);
  std::free(o->lr_hp);
  std::free(o->lr_hpq);
  std::free(o->lr_hpseen);
  delete o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Repeat scans (host fallback of the device gate kernels; ref util.cc
// semantics — see engine/seqs.py docstrings for the exact loop bounds).
// ---------------------------------------------------------------------------

extern "C" {

// exact duplicate k-mer among offsets [0, L-k) (final k-mer excluded)
int lsq_is_repeat(const uint8_t* s, int64_t L, int k) {
  const int64_t n_off = L - k;
  if (n_off <= 1) return 0;
  std::unordered_set<std::string_view, lgb::SvHash> seen;
  seen.reserve((size_t)n_off * 2);
  for (int64_t off = 0; off < n_off; ++off)
    if (!seen.insert(std::string_view((const char*)s + off, k)).second)
      return 1;
  return 0;
}

// near-duplicate (k+1)-length window with <= maxmm mismatches between
// pattern offset p and candidate start i > p, both in [0, L-k-1].
// Pigeonhole filter: split the (k+1)-window into maxmm+1 contiguous
// chunks; any pair within the mismatch budget must share at least one
// aligned chunk exactly, so only bucket collisions need verification.
int lsq_is_almost_repeat(const uint8_t* s, int64_t L, int k, int maxmm) {
  const int64_t maxp = L - k - 1;
  if (maxp < 1) return 0;
  const int w = k + 1;
  const int parts = maxmm + 1;
  if (w < parts) {  // degenerate: chunks would be empty; brute force
    for (int64_t p = 0; p <= maxp; ++p)
      for (int64_t i = p + 1; i <= maxp; ++i) {
        int mm = 0;
        for (int j = 0; j < w && mm <= maxmm; ++j) mm += s[p + j] != s[i + j];
        if (mm <= maxmm) return 1;
      }
    return 0;
  }
  auto verify = [&](int64_t p, int64_t i) {
    int mm = 0;
    for (int j = 0; j < w; ++j) {
      mm += s[p + j] != s[i + j];
      if (mm > maxmm) return false;
    }
    return true;
  };
  // flat chained hash buckets (thread-local scratch): positions whose
  // aligned chunk hashes equally share a chain. Hash collisions only add
  // candidates — verify() is exact — so no key equality check is needed.
  thread_local std::vector<int32_t> head, nxt;
  size_t cap = 16;
  while (cap < (size_t)(maxp + 1) * 2) cap <<= 1;
  const uint64_t mask = cap - 1;
  nxt.resize(maxp + 1);
  for (int t = 0; t < parts; ++t) {
    const int ot = (int)((int64_t)w * t / parts);
    const int lt = (int)((int64_t)w * (t + 1) / parts) - ot;
    head.assign(cap, 0);  // 0 = empty; chain stores p+1
    for (int64_t p = 0; p <= maxp; ++p) {
      const size_t slot = lgb::hash_bytes(s + p + ot, lt) & mask;
      for (int32_t q = head[slot]; q != 0; q = nxt[q - 1])
        if (verify(q - 1, p)) return 1;
      nxt[p] = head[slot];
      head[slot] = (int32_t)(p + 1);
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Coarse stage profiling (nanosecond accumulators, summed across worker
// threads; exported via lsr_stage_ns for the bench breakdown).
// ---------------------------------------------------------------------------

#include <atomic>
#include <chrono>

namespace lprof {
struct StageNs {
  std::atomic<int64_t> fetch{0}, triage{0}, extract{0}, kloop{0}, scan{0},
      build{0}, refcov{0}, mat{0}, stages{0}, eka{0}, comps{0}, refends{0},
      cyc{0}, compress{0}, cleanup{0}, findrep{0};
  void reset() {
    fetch = triage = extract = kloop = scan = 0;
    build = refcov = mat = stages = eka = 0;
    comps = refends = cyc = compress = cleanup = findrep = 0;
  }
};
inline StageNs& get() {
  static StageNs s;
  return s;
}
struct Timer {
  std::atomic<int64_t>& acc;
  std::chrono::steady_clock::time_point t0;
  explicit Timer(std::atomic<int64_t>& a)
      : acc(a), t0(std::chrono::steady_clock::now()) {}
  ~Timer() {
    acc += std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now() - t0)
               .count();
  }
};
}  // namespace lprof

// ---------------------------------------------------------------------------
// Full per-k graph pipeline (host compute plane).
//
// Native transliteration of engine/graph.py + node.py + path.py (which are
// themselves the behavior-exact re-expression of the reference's
// Graph.cc/Node.cc/Path.cc): connected components, source/sink anchoring
// with CLIP_REF_ENDS, cycle DFS, unitig compression, low-cov/tip/short-link
// cleanup, graph-path repeat gate, and the Edmonds-Karp-style best-new-edge
// path cover. The node table is a real libstdc++ unordered_map<string,...>,
// so the reference's iteration order (which decides compression survivor
// choice and coverage-row donation) holds natively instead of via the
// cpp_hash emulation. Output is a batch of PathJob records (path sequence,
// per-base coverage, tumor-span mask, DP-needed flag) plus the reference
// coverage projection and the window-seq trim state; Python runs the
// device-batched alignment and the transcript/variant stages.
//
// Any internal inconsistency throws; lgp_run catches and returns status 3,
// and the caller falls back to the Python engine for that window.
// ---------------------------------------------------------------------------

#include <cmath>
#include <deque>
#include <memory>
#include <stdexcept>

namespace lgp {

// per-run coverage-row stride: 4 columns (fwd, rev, mqf, mqr) in normal
// mode, 10 in LR mode (+ hp0..2, hp0..2_minqv; engine/node.py column
// order). Thread-local: lsr worker threads run independent windows.
inline thread_local int g_nc = 4;

using Dir = uint8_t;               // node orientation: 0=F 1=R
using EDir = uint8_t;              // edge dir: 0=FF 1=FR 2=RF 3=RR
constexpr Dir F = 0, R = 1;
inline Dir ed_start(EDir d) { return d <= 1 ? F : R; }
inline Dir ed_dest(EDir d) { return (d == 0 || d == 2) ? F : R; }
inline EDir flipme(EDir d) { constexpr EDir t[4] = {2, 3, 0, 1}; return t[d]; }
inline EDir fliplink(EDir d) { constexpr EDir t[4] = {3, 1, 2, 0}; return t[d]; }

struct GEdge {
  std::string nodeid;
  EDir dir;
  int flag = 0;
};

struct GN {
  std::string id, str;
  std::string status;              // cov_status bytes
  double ctf = 0, ctr = 0, cnf = 0, cnr = 0;
  bool is_ref = false, is_tumor = false, is_normal = false;
  bool is_source = false, is_sink = false, dead = false;
  int component = 0;
  bool touch_ref = false;
  int color = 0;
  int32_t mincov = 0, mincov_qv = 0;
  std::vector<int32_t> covT, covN;  // [L*4]: fwd, rev, mqf, mqr per base
  std::vector<GEdge> edges;

  bool is_special() const { return is_sink || is_source || is_ref; }
  int64_t strlen_() const { return is_special() ? 0 : (int64_t)str.size(); }
  double tot_tmr() const { return ctf + ctr; }
  double tot_nml() const { return cnf + cnr; }
  double tot_cov() const { return ctf + ctr + cnf + cnr; }

  bool is_tandem() const {
    for (const auto& e : edges)
      if (e.nodeid == id) return true;
    return false;
  }
  int get_buddy(Dir ori) const {  // (node.py get_buddy)
    if (is_special()) return -1;
    int ret = -1;
    for (size_t i = 0; i < edges.size(); ++i)
      if (ed_start(edges[i].dir) == ori) {
        if (ret != -1) return -1;
        ret = (int)i;
      }
    if (ret != -1 && edges[ret].nodeid == id) return -1;
    return ret;
  }
  void remove_edge(const std::string& nid, EDir d) {
    for (size_t i = 0; i < edges.size(); ++i)
      if (edges[i].nodeid == nid && edges[i].dir == d) {
        edges.erase(edges.begin() + i);
        return;
      }
    throw std::runtime_error("remove_edge missing");
  }
  void update_edge(const std::string& oldid, EDir olddir,
                   const std::string& newid, EDir newdir) {
    for (auto& e : edges)
      if (e.nodeid == oldid && e.dir == olddir) {
        e.nodeid = newid;
        e.dir = newdir;
        return;
      }
    throw std::runtime_error("update_edge missing");
  }
  void compute_min_cov() {  // over rows (node.py compute_min_cov)
    const int nc = g_nc;
    const int64_t L = (int64_t)covT.size() / nc;
    if (L == 0) { mincov = mincov_qv = 10000000; return; }
    int32_t mc = INT32_MAX, mq = INT32_MAX;
    for (int64_t i = 0; i < L; ++i) {
      const int32_t tot = covT[i * nc] + covT[i * nc + 1] + covN[i * nc] +
                          covN[i * nc + 1];
      const int32_t totq = covT[i * nc + 2] + covT[i * nc + 3] +
                           covN[i * nc + 2] + covN[i * nc + 3];
      if (tot < mc) mc = tot;
      if (totq < mq) mq = totq;
    }
    mincov = mc;
    mincov_qv = mq;
  }
  bool is_status_cnt_T(int K) const {  // node.py is_status_cnt(ord('T'))
    int64_t n = 0, cnt = 0;
    for (size_t i = K - 1; i < status.size(); ++i) {
      ++n;
      if (status[i] == 'T') ++cnt;
    }
    if (n == 0) return false;
    return (double)cnt / (double)n > 0.8;
  }
};

struct Job {
  std::string pathseq;
  std::vector<int32_t> covT, covN;  // L*4
  std::vector<uint8_t> span;        // L+1 tumor_span
  int64_t src_off = 0, ref_dist = 0;
  int32_t trim5 = -1;
  uint8_t needs_dp = 0;
};

// LR-mode barcode tables, frozen at build time (graph.add_bx_table /
// ref.add_bx; ref Microassembler.cc:582-593, VariantDB BX fields): per
// canonical mer, the distinct bx ids per sample. `graph_*` covers every
// visited mer; `ref_*` only mers in the per-k seq index.
struct BxTables {
  std::shared_ptr<std::vector<std::string>> names;  // bx id -> string
  std::unordered_map<std::string, std::vector<int32_t>> graph_t, graph_n;
  std::unordered_map<std::string, std::vector<int32_t>> ref_t, ref_n;
};

struct Result {
  int status = 0;  // 0 ok, 1 cycle, 2 repeat-in-path, 3 internal error
  int32_t trim5 = -1, trim3 = -1;
  int seq_set = 0;
  int64_t seq_off = 0, seq_len = 0;
  int nc = 4;                   // coverage-row stride (10 in LR mode)
  std::vector<int32_t> refcov;  // nc planes x rawlen (see lgp_run_impl)
  std::vector<Job> jobs;
  std::shared_ptr<BxTables> bxtab;  // LR mode only
};

struct PPath {  // path.py Path
  std::vector<GN*> nodes;
  std::vector<GEdge*> edges;
  std::vector<EDir> edgedir;
  Dir dir = F;
  int64_t len_m = 0;
  int has_cycle_m = 0;
  int score = 0;
  int flag = 1;
};

struct Graph {
  std::unordered_map<std::string, GN*> nodes;  // the real libstdc++ map
  std::vector<std::unique_ptr<GN>> pool;
  GN* source = nullptr;
  GN* sink = nullptr;
  int K;
  uint8_t comp[256];

  ~Graph() = default;
  GN* alloc(const std::string& id) {
    pool.emplace_back(new GN());
    GN* n = pool.back().get();
    n->id = id;
    n->str = id;
    n->status.assign(id.size(), 'E');
    n->covT.assign(id.size() * g_nc, 0);
    n->covN.assign(id.size() * g_nc, 0);
    return n;
  }
  GN* get(const std::string& id) const {
    auto it = nodes.find(id);
    return it == nodes.end() ? nullptr : it->second;
  }
  GN* edge_node(const GEdge& e) const { return get(e.nodeid); }

  std::string rc(const std::string& s) const {
    std::string out(s.size(), 0);
    for (size_t i = 0; i < s.size(); ++i)
      out[i] = (char)comp[(uint8_t)s[s.size() - 1 - i]];
    return out;
  }
  // canonical of an arbitrary-length window (mer.py: palindromes orient R)
  std::pair<std::string, Dir> canonical(const std::string& s) const {
    std::string r = rc(s);
    if (s < r) return {s, F};
    return {std::move(r), R};
  }
};

inline std::vector<int32_t> rev_rows(const std::vector<int32_t>& v) {
  const int nc = g_nc;
  const int64_t L = (int64_t)v.size() / nc;
  std::vector<int32_t> out(v.size());
  for (int64_t i = 0; i < L; ++i)
    for (int c = 0; c < nc; ++c) out[i * nc + c] = v[(L - 1 - i) * nc + c];
  return out;
}

inline std::vector<int32_t> rows_from(const std::vector<int32_t>& v,
                                      int64_t row) {
  return std::vector<int32_t>(v.begin() + row * g_nc, v.end());
}

}  // namespace lgp

namespace lgp {

inline void add_edge(GN* n, const std::string& nid, EDir d) {
  for (auto& e : n->edges)
    if (e.nodeid == nid && e.dir == d) return;
  n->edges.push_back({nid, d, 0});
}

// --- connected components (graph.py mark_connected_components) ------------
int mark_connected_components(Graph& g) {
  for (auto& kv : g.nodes) kv.second->component = 0;
  int comp = 0;
  for (auto& kv : g.nodes) {
    GN* n = kv.second;
    if (n->component != 0) continue;
    ++comp;
    std::deque<GN*> q{n};
    while (!q.empty()) {
      GN* cur = q.front();
      q.pop_front();
      if (cur == nullptr) continue;
      if (cur->component == 0) {
        cur->component = comp;
        for (auto& e : cur->edges) q.push_back(g.edge_node(e));
      }
    }
  }
  return comp;
}

// --- source/sink anchoring (graph.py mark_ref_ends) ------------------------
void mark_ref_ends(Graph& g, int compid, const uint8_t* rawseq,
                   int64_t rawlen, double cov_threshold, Result& res) {
  const int K = g.K;
  res.trim5 = -1;
  res.trim3 = -1;
  g.source = nullptr;
  g.sink = nullptr;
  const std::string raw((const char*)rawseq, (size_t)rawlen);

  // alloc-free canonical scans: whole-window rc hoisted, reusable key
  // buffer (canonical() semantics preserved: palindrome -> R side)
  const std::string rcraw = g.rc(raw);
  std::string key(K, '\0');
  auto canon_at = [&](int64_t off, Dir* ori) -> const std::string& {
    const char* fw = raw.data() + off;
    const char* rv = rcraw.data() + (rawlen - off - K);
    const int c = std::memcmp(fw, rv, K);
    if (c < 0) {
      *ori = F;
      key.assign(fw, K);
    } else {
      *ori = R;
      key.assign(rv, K);
    }
    return key;
  };

  GN* source_node = nullptr;
  std::string source_mer;
  Dir source_ori = F;
  int64_t source_offset = -1;
  // offsets past rawlen-K gave sub-K substrings before — those lookups
  // can never match a K-length node id, so the clamp is behavior-equal
  for (int64_t off = 0; off + K <= rawlen; ++off) {
    Dir ori;
    const std::string& cmer = canon_at(off, &ori);
    GN* cand = g.get(cmer);
    if (cand && cand->tot_cov() >= cov_threshold &&
        cand->component == compid) {
      if (source_node == nullptr) {
        source_node = cand;
        source_mer = cmer;
        source_ori = ori;
        source_offset = off;
      } else if (source_node == cand) {
        return;  // ambiguous
      }
    }
  }
  if (!source_node) return;

  GN* sink_node = nullptr;
  std::string sink_mer;
  Dir sink_ori = F;
  int64_t sink_offset = -1;
  for (int64_t off = rawlen - K; off >= 0; --off) {
    Dir ori;
    const std::string& cmer = canon_at(off, &ori);
    GN* cand = g.get(cmer);
    if (cand && cand->tot_cov() >= cov_threshold &&
        cand->component == compid) {
      if (sink_node == nullptr) {
        sink_node = cand;
        sink_mer = cmer;
        sink_ori = ori;
        sink_offset = off;
      } else if (sink_node == cand) {
        return;  // ambiguous
      }
    }
  }
  if (!sink_node) return;

  const int64_t ref_dist = sink_offset - source_offset + K;
  sink_offset = rawlen - sink_offset - K;
  res.seq_set = 1;
  res.seq_off = source_offset;
  res.seq_len = ref_dist;
  res.trim5 = (int32_t)source_offset;
  res.trim3 = (int32_t)sink_offset;

  // fake source node + CLIP_REF_ENDS
  GN* newsource = g.alloc("source" + std::to_string(compid));
  newsource->component = compid;
  const EDir sourcedir = (source_ori == F) ? 0 : 1;  // FF : FR
  for (int64_t i = (int64_t)source_node->edges.size() - 1; i >= 0; --i) {
    GEdge e = source_node->edges[i];
    if (ed_start(e.dir) == (source_ori == F ? R : F)) {
      GN* other = g.edge_node(e);
      if (other != nullptr && other != source_node) {
        other->remove_edge(source_node->id, fliplink(e.dir));
        source_node->edges.erase(source_node->edges.begin() + i);
      }
    }
  }
  add_edge(newsource, source_mer, sourcedir);
  newsource->is_source = true;
  add_edge(source_node, newsource->id, fliplink(sourcedir));
  g.source = newsource;
  g.nodes[newsource->id] = newsource;

  GN* newsink = g.alloc("sink" + std::to_string(compid));
  newsink->component = compid;
  const EDir sinkdir = (sink_ori == F) ? 3 : 0;  // RR : FF
  for (int64_t i = (int64_t)sink_node->edges.size() - 1; i >= 0; --i) {
    GEdge e = sink_node->edges[i];
    if (ed_start(e.dir) == sink_ori) {
      GN* other = g.edge_node(e);
      if (other != nullptr && other != sink_node) {
        other->remove_edge(sink_node->id, fliplink(e.dir));
        sink_node->edges.erase(sink_node->edges.begin() + i);
      }
    }
  }
  add_edge(newsink, sink_mer, sinkdir);
  newsink->is_sink = true;
  add_edge(sink_node, newsink->id, fliplink(sinkdir));
  g.sink = newsink;
  g.nodes[newsink->id] = newsink;
}

// --- cycle DFS (graph.py has_cycle / _cycle_dfs) ----------------------------
constexpr int WHITE = 1, GREY = 2, BLACK = 3;

bool cycle_dfs(Graph& g, GN* start, Dir d) {
  struct Frame { GN* node; Dir nd; size_t ei; };
  std::vector<Frame> stack{{start, d, 0}};
  start->color = GREY;
  while (!stack.empty()) {
    Frame& f = stack.back();
    if (f.ei >= f.node->edges.size()) {
      f.node->color = BLACK;
      stack.pop_back();
      continue;
    }
    GEdge& edge = f.node->edges[f.ei];
    f.ei += 1;
    if (ed_start(edge.dir) != f.nd) continue;
    GN* other = g.edge_node(edge);
    if (other == nullptr || other->is_special()) continue;
    if (other->color == GREY) {
      for (auto& fr : stack) fr.node->color = BLACK;
      return true;
    }
    if (other->color == WHITE) {
      other->color = GREY;
      stack.push_back({other, ed_dest(edge.dir), 0});
    }
  }
  return false;
}

bool has_cycle(Graph& g) {
  if (g.source == nullptr || g.sink == nullptr) return false;
  for (auto& kv : g.nodes) {
    if (kv.second->is_special()) continue;
    kv.second->color = WHITE;
  }
  return cycle_dfs(g, g.source, F) || cycle_dfs(g, g.source, R);
}

// --- compression (graph.py compress_node / compress) ------------------------
void clean_dead(Graph& g) {
  std::vector<std::string> dead;
  for (auto& kv : g.nodes)
    if (kv.second->dead) dead.push_back(kv.first);
  std::sort(dead.begin(), dead.end());
  for (auto& k : dead) g.nodes.erase(k);
}

void compress_node(Graph& g, GN* node, Dir d) {
  // cheap pre-checks first: most nodes have no mergeable buddy, and the
  // segment deques below would otherwise copy str + both coverage tables
  // per node per sweep for nothing
  if (node->get_buddy(d) == -1) return;
  if (node->is_tandem()) return;
  const int K = g.K;
  int64_t cur_len = (int64_t)node->str.size();
  std::deque<std::string> str_segs;
  str_segs.emplace_back(std::move(node->str));
  std::deque<std::vector<int32_t>> cov_segs_t, cov_segs_n;
  cov_segs_t.emplace_back(std::move(node->covT));
  cov_segs_n.emplace_back(std::move(node->covN));
  std::vector<std::string> status_tail;
  bool merged = false;

  while (true) {
    const int uniqueid = node->get_buddy(d);
    if (uniqueid == -1) break;
    if (node->is_tandem()) break;
    const EDir edir = node->edges[uniqueid].dir;
    const Dir bdir = (edir == 0 || edir == 2) ? R : F;  // FF/RF -> R
    GN* buddy = g.edge_node(node->edges[uniqueid]);
    if (buddy == nullptr || buddy->dead)
      throw std::runtime_error("compress: dead buddy");
    if (buddy->is_tandem()) break;
    const int buniqueid = buddy->get_buddy(bdir);
    if (buniqueid == -1) break;
    if (buddy->edges[buniqueid].nodeid != node->id)
      throw std::runtime_error("compress: buddy back-edge mismatch");

    merged = true;
    const bool dest_r = ed_dest(edir) == R;
    const std::string& B = buddy->str;
    const int64_t blen = (int64_t)B.size();
    const int64_t seg = blen - K + 1;  // segment rows/chars appended

    // The four (d, dest_r) cases of the reference's
    // substr/rc/rev_rows chains each reduce to one slice pass:
    //   d==F !dest_r : B[K-1..)            rows [K-1..L) fwd
    //   d==F  dest_r : rc(B[0..seg))       rows [0..seg) reversed
    //   d==R !dest_r : rc(B[K-1..))        rows [K-1..L) reversed
    //   d==R  dest_r : B[0..seg)           rows [0..seg) fwd
    std::string sstr;
    sstr.resize(seg);
    const bool lo_slice = dest_r;  // slice [0..seg) vs [K-1..blen)
    const bool rc_it = (d == R) != dest_r;
    if (rc_it) {
      const char* src = lo_slice ? B.data() : B.data() + K - 1;
      for (int64_t i = 0; i < seg; ++i)
        sstr[i] = (char)g.comp[(uint8_t)src[seg - 1 - i]];
    } else {
      std::memcpy(sstr.data(), lo_slice ? B.data() : B.data() + K - 1, seg);
    }
    auto slice_rows = [&](const std::vector<int32_t>& X) {
      const int nc = g_nc;
      std::vector<int32_t> out((size_t)seg * nc);
      const int64_t row0 = lo_slice ? 0 : K - 1;
      if (rc_it) {
        for (int64_t i = 0; i < seg; ++i)
          for (int c = 0; c < nc; ++c)
            out[i * nc + c] = X[(row0 + seg - 1 - i) * nc + c];
      } else {
        std::memcpy(out.data(), X.data() + row0 * nc,
                    (size_t)seg * nc * 4);
      }
      return out;
    };

    const int64_t amerlen = cur_len - K + 1;
    const int64_t bmerlen = seg;

    if (d == R) {
      // reversed segment prepends (graph.py dir==R dance)
      str_segs.push_front(std::move(sstr));
      cov_segs_t.push_front(slice_rows(buddy->covT));
      cov_segs_n.push_front(slice_rows(buddy->covN));
    } else {
      str_segs.push_back(std::move(sstr));
      cov_segs_t.push_back(slice_rows(buddy->covT));
      cov_segs_n.push_back(slice_rows(buddy->covN));
    }
    status_tail.push_back(buddy->status.substr(K - 1));

    const int64_t tot = amerlen + bmerlen;
    node->ctf = (node->ctf * amerlen + buddy->ctf * bmerlen) / tot;
    node->cnf = (node->cnf * amerlen + buddy->cnf * bmerlen) / tot;
    node->ctr = (node->ctr * amerlen + buddy->ctr * bmerlen) / tot;
    node->cnr = (node->cnr * amerlen + buddy->cnr * bmerlen) / tot;

    cur_len = cur_len + blen - K + 1;

    buddy->dead = true;
    if (buddy->is_ref) node->is_ref = true;
    if (buddy->is_normal) node->is_normal = true;
    if (buddy->is_tumor) node->is_tumor = true;

    node->edges.erase(node->edges.begin() + uniqueid);
    for (size_t i = 0; i < buddy->edges.size(); ++i) {
      if ((int)i == buniqueid) continue;
      const GEdge& be = buddy->edges[i];
      GEdge ne = be;  // copies flag
      if (edir == 1 || edir == 2) ne.dir = flipme(ne.dir);  // FR/RF
      GN* other = g.get(ne.nodeid);
      if (other == nullptr) throw std::runtime_error("compress: null other");
      if (other == buddy) {
        ne.nodeid = node->id;
        node->edges.push_back(ne);
      } else {
        node->edges.push_back(ne);
        other->update_edge(buddy->id, fliplink(be.dir), node->id,
                           fliplink(ne.dir));
      }
    }
  }

  if (merged) {
    size_t slen = 0, clen_t = 0, clen_n = 0;
    for (auto& s : str_segs) slen += s.size();
    for (auto& v : cov_segs_t) clen_t += v.size();
    for (auto& v : cov_segs_n) clen_n += v.size();
    node->str.clear();
    node->str.reserve(slen);
    for (auto& s : str_segs) node->str += s;
    std::vector<int32_t> ct, cn;
    ct.reserve(clen_t);
    cn.reserve(clen_n);
    for (auto& v : cov_segs_t) ct.insert(ct.end(), v.begin(), v.end());
    for (auto& v : cov_segs_n) cn.insert(cn.end(), v.begin(), v.end());
    node->covT = std::move(ct);
    node->covN = std::move(cn);
    for (auto& s : status_tail) node->status += s;
    node->compute_min_cov();
  } else {
    // no merge happened: hand the moved-out segments back
    node->str = std::move(str_segs.front());
    node->covT = std::move(cov_segs_t.front());
    node->covN = std::move(cov_segs_n.front());
  }
}

void compress(Graph& g, int compid) {
  for (auto& kv : g.nodes) {
    GN* n = kv.second;
    if (n->component == compid) {
      if (n->dead || n->is_special()) continue;
      compress_node(g, n, F);
      compress_node(g, n, R);
    }
  }
  clean_dead(g);
}

// --- removals (graph.py remove_node / remove_low_cov / tips / links) -------
void remove_node(Graph& g, GN* node) {
  if (node->dead) throw std::runtime_error("remove_node: already dead");
  node->dead = true;
  for (auto& e : node->edges) {
    GN* nn = g.edge_node(e);
    if (nn != nullptr && nn != node) nn->remove_edge(node->id, fliplink(e.dir));
  }
}

void remove_low_cov(Graph& g, bool docompression, int compid, double avgcov,
                    int low_cov_threshold, double min_cov_ratio) {
  for (auto& kv : g.nodes) {
    GN* node = kv.second;
    if (node->component != compid || node->dead) continue;
    if (node->is_special()) continue;
    if (node->mincov_qv <= low_cov_threshold ||
        (double)node->mincov_qv <= min_cov_ratio * avgcov ||
        (node->tot_tmr() == 1 && node->tot_nml() == 1)) {
      remove_node(g, node);
    }
  }
  clean_dead(g);
  if (docompression) compress(g, compid);
}

void remove_tips(Graph& g, int compid, int max_tip_len) {
  while (true) {
    int tips = 0;
    for (auto& kv : g.nodes) {
      GN* cur = kv.second;
      if (cur->component != compid || cur->dead) continue;
      if (cur->is_special()) continue;
      const int64_t deg = (int64_t)cur->edges.size();
      const int64_t ln = cur->strlen_() - g.K + 1;
      if (deg <= 1 && ln < max_tip_len) {
        remove_node(g, cur);
        ++tips;
      }
    }
    if (tips)
      compress(g, compid);
    else
      break;
  }
}

// find_tandems (engine/seqs.py; remove_short_links needs only the length)
int64_t find_tandems_len(const std::string& seq, int max_unit_len,
                         int min_report_units, int min_report_len,
                         int dist_from_str, int64_t pos) {
  const int64_t L = (int64_t)seq.size();
  int64_t out_len = 0;
  std::vector<std::vector<int64_t>> offsets(max_unit_len + 1);
  for (int m = 0; m <= max_unit_len; ++m) {
    offsets[m].assign(max_unit_len + 2, 0);
    for (int p = 0; p < m; ++p) offsets[m][p] = p;
  }
  for (int64_t i = 0; i < L; ++i) {
    for (int merlen = 1; merlen <= max_unit_len; ++merlen) {
      const int64_t phase = i % merlen;
      const int64_t offset = offsets[merlen][phase];
      int64_t j = 0;
      while (j < merlen && i + j < L && seq[i + j] == seq[offset + j]) ++j;
      if (j != merlen || (i + j + 1 == L)) {
        const char left = offset > 0 ? seq[offset - 1] : '\0';
        if (left != seq[offset + merlen - 1]) {
          if ((i - offset) / merlen >= min_report_units &&
              i - offset >= min_report_len) {
            int64_t ml = 1;
            while (ml < merlen) {
              const int64_t units = (i - offset + j) / ml;
              bool allmatch = true;
              for (int64_t index = 1; index < units; ++index)
                if (seq.compare(offset, ml, seq, offset + index * ml, ml) !=
                    0) {
                  allmatch = false;
                  break;
                }
              if (!allmatch)
                ++ml;
              else
                break;
            }
            if (ml == merlen) {
              const int64_t start = offset, end = i + j;
              if (pos >= start - dist_from_str && pos <= end + dist_from_str)
                out_len = end - start;
            }
          }
        }
        offsets[merlen][phase] = i;
      }
    }
  }
  return out_len;
}

void remove_short_links(Graph& g, int compid, int max_link_len, double avgcov,
                        int max_unit_len, int min_report_units,
                        int min_report_len, int dist_from_str) {
  int links = 0;
  const double thr = std::floor(std::sqrt(avgcov));
  for (auto& kv : g.nodes) {
    GN* cur = kv.second;
    if (cur->component != compid || cur->dead) continue;
    if (cur->is_special()) continue;
    const int64_t deg = (int64_t)cur->edges.size();
    const int64_t ln = (int64_t)cur->str.size() - g.K + 1;
    if (deg >= 2 && ln < max_link_len && (double)cur->mincov <= thr) {
      const int64_t L = find_tandems_len(cur->str, max_unit_len,
                                         min_report_units, min_report_len,
                                         dist_from_str, g.K - 1);
      if (L == 0) {
        remove_node(g, cur);
        ++links;
      }
    }
  }
  if (links) compress(g, compid);
}

}  // namespace lgp

namespace lgp {

// --- path enumeration (graph.py bfs / eka) ----------------------------------
std::unique_ptr<PPath> bfs(Graph& g, GN* source, GN* sink, Dir d,
                           int64_t reflen, int64_t dfs_limit,
                           int max_indel_len) {
  int64_t visit = 0;
  int complete = 0;
  std::deque<PPath> q;
  PPath p0;
  p0.nodes.push_back(source);
  p0.dir = d;
  p0.len_m = g.K;
  std::unique_ptr<PPath> best;
  q.push_back(std::move(p0));
  while (!q.empty()) {
    ++visit;
    if (dfs_limit && visit > dfs_limit) break;
    PPath path = std::move(q.front());
    q.pop_front();
    GN* cur = path.nodes.back();
    if (cur == sink && path.flag == 0) {
      ++complete;
      if (!best || path.score > best->score) best.reset(new PPath(path));
    } else if (path.len_m > reflen + max_indel_len) {
      // too long
    } else {
      for (auto& edge : cur->edges) {
        if (ed_start(edge.dir) != path.dir) continue;
        GN* other = g.edge_node(edge);
        if (other == nullptr) throw std::runtime_error("bfs: null edge node");
        if (!path.has_cycle_m) {
          for (GN* n : path.nodes)
            if (n == other) {
              path.has_cycle_m = 1;
              break;
            }
        }
        PPath np(path);
        np.nodes.push_back(other);
        np.edges.push_back(&edge);
        np.edgedir.push_back(edge.dir);
        np.dir = ed_dest(edge.dir);
        np.len_m = path.len_m + other->strlen_() - g.K + 1;
        np.flag = path.flag * edge.flag;
        if (edge.flag == 0) np.score = path.score + 1;
        q.push_back(std::move(np));
      }
    }
  }
  if (complete == 0) best.reset();
  return best;
}

// --- path -> sequence / coverage / span (path.py, extract.py) ---------------
std::string path_str(Graph& g, const PPath& p) {
  std::string ret;
  int64_t retlen = 0;
  Dir d = ed_start(p.edgedir[0]);
  for (size_t i = 0; i < p.nodes.size(); ++i) {
    GN* n = p.nodes[i];
    std::string nstr = n->str;
    if (d == R) nstr = g.rc(nstr);
    if (!n->is_special()) {
      if (retlen > 0) {
        ret += nstr.substr(g.K - 1);
        retlen += (int64_t)nstr.size() - g.K + 1;
      } else {
        ret += nstr;
        retlen = (int64_t)nstr.size();
      }
    }
    if (i < p.edgedir.size()) d = ed_dest(p.edgedir[i]);
  }
  return ret;
}

std::vector<int32_t> path_cov(Graph& g, const PPath& p, bool tumor) {
  std::vector<int32_t> out;
  int64_t total = 0;
  Dir d = ed_start(p.edgedir[0]);
  for (size_t i = 0; i < p.nodes.size(); ++i) {
    GN* n = p.nodes[i];
    const std::vector<int32_t>& C = tumor ? n->covT : n->covN;
    std::vector<int32_t> nc = (d == R) ? rev_rows(C) : C;
    if (!n->is_special()) {
      if (total == 0) {
        out.insert(out.end(), nc.begin(), nc.end());
        total = (int64_t)nc.size() / g_nc;
      } else {
        out.insert(out.end(), nc.begin() + (g.K - 1) * g_nc, nc.end());
        total += (int64_t)nc.size() / g_nc - (g.K - 1);
      }
    }
    if (i < p.edgedir.size()) d = ed_dest(p.edgedir[i]);
  }
  return out;
}

std::vector<uint8_t> tumor_span(Graph& g, const PPath& p, int64_t L) {
  // extract.py make_path_job: node i covers (hi_{i-1}, hi_i]
  std::vector<uint8_t> span(L + 1, 0);
  int64_t cur = 0, prev_hi = -1;
  for (GN* n : p.nodes) {
    if (n->is_special()) continue;
    const int64_t sp = (int64_t)n->str.size();
    const int64_t hi = cur + sp;
    const int64_t lo = std::max<int64_t>(prev_hi + 1, 0);
    const int64_t hi_c = std::min<int64_t>(hi, L);
    if (lo <= hi_c) {
      if (n->is_status_cnt_T(g.K))
        for (int64_t x = lo; x <= hi_c; ++x) span[x] = 1;
    }
    prev_hi = hi;
    cur += sp - g.K + 1;
    if (prev_hi >= L) break;
  }
  return span;
}

void eka(Graph& g, GN* source, GN* sink, Dir d, const uint8_t* rawseq,
         int64_t reflen, int64_t dfs_limit, int max_indel_len,
         int64_t src_off, int64_t ref_dist, int32_t trim5, Result& res) {
  while (true) {
    auto path = bfs(g, source, sink, d, reflen, dfs_limit, max_indel_len);
    if (!path) break;
    Job j;
    j.pathseq = path_str(g, *path);
    j.covT = path_cov(g, *path, true);
    j.covN = path_cov(g, *path, false);
    j.span = tumor_span(g, *path, (int64_t)j.covN.size() / g_nc);
    j.src_off = src_off;
    j.ref_dist = ref_dist;
    j.trim5 = trim5;
    // hamming vs the (just-trimmed) ref seq; -1 on length mismatch
    int64_t hd = -1;
    if ((int64_t)j.pathseq.size() == ref_dist) {
      hd = 0;
      for (int64_t i = 0; i < ref_dist; ++i)
        hd += (uint8_t)j.pathseq[i] != rawseq[src_off + i];
    }
    j.needs_dp = (hd == -1 || hd > 5);
    res.jobs.push_back(std::move(j));
    for (GEdge* e : path->edges) e->flag = 1;
  }
}

bool find_repeats_in_graph_paths(Graph& g, int K, int max_mismatch,
                                 int64_t reflen, int64_t dfs_limit,
                                 int max_indel_len) {
  if (g.source == nullptr || g.sink == nullptr) return false;
  bool answer = false;
  std::vector<GEdge*> touched;
  while (true) {
    auto path = bfs(g, g.source, g.sink, F, reflen, dfs_limit, max_indel_len);
    if (!path) break;
    const std::string ps = path_str(g, *path);
    if (lsq_is_almost_repeat((const uint8_t*)ps.data(), (int64_t)ps.size(), K,
                             max_mismatch)) {
      answer = true;
      break;
    }
    for (GEdge* e : path->edges) {
      e->flag = 1;
      touched.push_back(e);
    }
  }
  for (GEdge* e : touched) e->flag = 0;
  return answer;
}

}  // namespace lgp

// Full per-k pipeline: colored-DBG build (via lgb_build_impl) then
// components, anchoring, cycle gate, compression, cleanup, graph-path
// repeat gate, and the best-new-edge path cover. Returns a Result handle.
// bx/hp/lr_mode: see lgb_build_impl (LR mode; null for normal runs).
void* lgp_run_impl(
    const uint8_t* cat, const uint8_t* qcat, int64_t tot,
    int64_t n_reads, const int64_t* starts, const int32_t* lens,
    const int32_t* sample, const int32_t* strand,
    const int32_t* order, const int64_t* name_off,
    const uint8_t* name_blob, int K, int minq, double avgcov,
    int low_cov_threshold, double min_cov_ratio,
    const uint8_t* idxseq, int64_t idxlen, const uint8_t* rawseq,
    int64_t rawlen, double cov_threshold, int max_tip_len,
    int max_link_len, int64_t dfs_limit, int max_indel_len,
    int max_mismatch, int max_unit_len, int min_report_units,
    int min_report_len, int dist_from_str,
    const int32_t* bx, const int32_t* hp, int lr_mode) {
  auto* res = new lgp::Result();
  lgp::g_nc = lr_mode ? 10 : 4;
  res->nc = lgp::g_nc;
  lgb::Out* out = nullptr;
  try {
    {
      lprof::Timer t(lprof::get().build);
      out = (lgb::Out*)lgb_build_impl(
          cat, qcat, tot, n_reads, starts, lens, sample, strand, order,
          name_off, name_blob, K, minq, avgcov, low_cov_threshold,
          min_cov_ratio, idxseq, idxlen, bx, hp, lr_mode);
    }
    const int64_t n_nodes = out->n_nodes;

    // reference coverage projection (ref.py compute_coverage, pre-prune
    // node counts; nonzero only where the mer is in the seq-based index).
    // Probes the build's thread-local node table (same thread, still
    // valid) instead of constructing a fresh map over all nodes.
    // plane layout: [t_fwd, t_rev, n_fwd, n_rev] and, in LR mode, 6 more
    // planes [t_hp0, t_hp1, t_hp2, n_hp0, n_hp1, n_hp2] (ref.py
    // update_hp_coverage + compute_coverage; ref Ref.cc:173-250). LR cov
    // planes carry the ASSIGNED bx counts (update_coverage with bx_cnt).
    const int n_planes = lr_mode ? 10 : 4;
    res->refcov.assign((size_t)n_planes * rawlen, 0);
    {
      lprof::Timer t(lprof::get().refcov);
      lgb::Scratch& scr = lgb::scratch();
      uint8_t comp[256];
      lgb::comp_table(comp);
      std::vector<uint8_t> rc_raw(rawlen);
      for (int64_t i = 0; i < rawlen; ++i)
        rc_raw[i] = comp[rawseq[rawlen - 1 - i]];
      const int64_t n_off = rawlen - K;  // final mer excluded
      for (int64_t i = 0; i < n_off; ++i) {
        const uint8_t* fw = rawseq + i;
        const uint8_t* rc = rc_raw.data() + (rawlen - i - K);
        const uint8_t* cn = std::memcmp(fw, rc, K) < 0 ? fw : rc;
        int32_t vals[10] = {0};
        const int32_t nlk = lgb::scratch_lookup(scr, cn, K,
                                                lgb::scratch_hash(cn, K));
        if (nlk >= 0) {
          const int64_t n = nlk;
          const uint8_t fl = out->flags[n];
          if (fl & lgb::F_INREF) {
            const int32_t* cv = lr_mode ? out->lr_cov : out->cov;
            if (fl & lgb::F_SEENF_T) vals[0] = cv[n * 4 + 0];
            if (fl & lgb::F_SEENR_T) vals[1] = cv[n * 4 + 1];
            if (fl & lgb::F_SEENF_N) vals[2] = cv[n * 4 + 2];
            if (fl & lgb::F_SEENR_N) vals[3] = cv[n * 4 + 3];
            if (lr_mode) {
              if (out->lr_hpseen[n] & 1)
                for (int h2 = 0; h2 < 3; ++h2)
                  vals[4 + h2] = out->lr_hp[n * 6 + h2];
              if (out->lr_hpseen[n] & 2)
                for (int h2 = 0; h2 < 3; ++h2)
                  vals[7 + h2] = out->lr_hp[n * 6 + 3 + h2];
            }
          }
        }
        if (i == 0) {
          for (int64_t p = 0; p < K && p < rawlen; ++p)
            for (int c = 0; c < n_planes; ++c)
              res->refcov[c * rawlen + p] = vals[c];
        } else {
          for (int c = 0; c < n_planes; ++c)
            res->refcov[c * rawlen + (i + K - 1)] = vals[c];
        }
      }
    }

    // materialize the node map in creation order, then erase low nodes
    // (reference insert-all-then-removeLowCov sequence; bucket layout of
    // the real libstdc++ unordered_map IS the reference's iteration order)
    lprof::Timer* mat_t = new lprof::Timer(lprof::get().mat);
    lgp::Graph g;
    g.K = K;
    lgb::comp_table(g.comp);
    std::vector<lgp::GN*> by_id(n_nodes, nullptr);
    for (int64_t n = 0; n < n_nodes; ++n) {
      const std::string mer((const char*)out->mers + n * K, K);
      const uint8_t fl = out->flags[n];
      if (fl & lgb::F_LOW) {
        g.nodes[mer] = nullptr;
        continue;
      }
      lgp::GN* node = g.alloc(mer);
      node->ctf = out->cov[n * 4 + 0];
      node->ctr = out->cov[n * 4 + 1];
      node->cnf = out->cov[n * 4 + 2];
      node->cnr = out->cov[n * 4 + 3];
      node->is_tumor = fl & lgb::F_TUMOR;
      node->is_normal = fl & lgb::F_NORMAL;
      node->touch_ref = fl & lgb::F_INREF;
      // in LR mode the per-base fwd/rev columns hold bx counts, so the
      // row-derived mincov is bx-based (node.py compute_min_cov over the
      // LR cov_distr); mincov_qv stays mq-based either way
      node->mincov =
          lr_mode ? (out->lr_cov[n * 4 + 0] + out->lr_cov[n * 4 + 1] +
                     out->lr_cov[n * 4 + 2] + out->lr_cov[n * 4 + 3])
                  : out->tot_cov[n];
      node->mincov_qv = out->mincov_qv[n];
      const char st = (node->is_tumor && node->is_normal) ? 'B'
                      : node->is_tumor                    ? 'T'
                      : node->is_normal                   ? 'N'
                                                          : 'E';
      node->status.assign(K, st);
      const int nc2 = lgp::g_nc;
      const int32_t* cvm = lr_mode ? out->lr_cov : out->cov;
      for (int64_t j = 0; j < K; ++j) {
        node->covT[j * nc2 + 0] = cvm[n * 4 + 0];
        node->covT[j * nc2 + 1] = cvm[n * 4 + 1];
        node->covT[j * nc2 + 2] = out->mq[(0 * n_nodes + n) * K + j];
        node->covT[j * nc2 + 3] = out->mq[(1 * n_nodes + n) * K + j];
        node->covN[j * nc2 + 0] = cvm[n * 4 + 2];
        node->covN[j * nc2 + 1] = cvm[n * 4 + 3];
        node->covN[j * nc2 + 2] = out->mq[(2 * n_nodes + n) * K + j];
        node->covN[j * nc2 + 3] = out->mq[(3 * n_nodes + n) * K + j];
        if (lr_mode) {
          for (int h2 = 0; h2 < 3; ++h2) {
            node->covT[j * nc2 + 4 + h2] = out->lr_hp[n * 6 + h2];
            node->covT[j * nc2 + 7 + h2] =
                out->lr_hpq[((int64_t)h2 * n_nodes + n) * K + j];
            node->covN[j * nc2 + 4 + h2] = out->lr_hp[n * 6 + 3 + h2];
            node->covN[j * nc2 + 7 + h2] =
                out->lr_hpq[((int64_t)(3 + h2) * n_nodes + n) * K + j];
          }
        }
      }
      g.nodes[mer] = node;
      by_id[n] = node;
    }
    for (int64_t n = 0; n < n_nodes; ++n)
      if (out->flags[n] & lgb::F_LOW)
        g.nodes.erase(std::string((const char*)out->mers + n * K, K));
    const char* dirs = nullptr;
    (void)dirs;
    for (int64_t e = 0; e < out->n_edges; ++e) {
      lgp::GN* src = by_id[out->esrc[e]];
      if (src == nullptr) throw std::runtime_error("edge from low node");
      src->edges.push_back(
          {std::string((const char*)out->mers + (int64_t)out->edst[e] * K, K),
           (lgp::EDir)out->edir[e], 0});
    }
    if (lr_mode) {
      // freeze the per-mer barcode tables before cleanup/compression
      // mutates the graph (graph.add_bx_table / ref.add_bx are
      // build-time only; variant-time lookups key by original K-mers)
      res->bxtab = std::make_shared<lgp::BxTables>();
      res->bxtab->graph_t.reserve((size_t)n_nodes);
      res->bxtab->graph_n.reserve((size_t)n_nodes);
      for (int64_t n = 0; n < n_nodes; ++n) {
        const bool inref = out->flags[n] & lgb::F_INREF;
        if (!out->bx_ids_t[n].empty()) {
          std::string mer((const char*)out->mers + n * K, K);
          if (inref) res->bxtab->ref_t[mer] = out->bx_ids_t[n];
          res->bxtab->graph_t[std::move(mer)] =
              std::move(out->bx_ids_t[n]);  // out is freed below
        }
        if (!out->bx_ids_n[n].empty()) {
          std::string mer((const char*)out->mers + n * K, K);
          if (inref) res->bxtab->ref_n[mer] = out->bx_ids_n[n];
          res->bxtab->graph_n[std::move(mer)] =
              std::move(out->bx_ids_n[n]);
        }
      }
    }
    lgb_result_free(out);
    out = nullptr;
    delete mat_t;

    // --- per-component stages (micro.py process_graph inner loop) ---------
    lprof::Timer stages_t(lprof::get().stages);
    int numcomp;
    {
      lprof::Timer t(lprof::get().comps);
      numcomp = lgp::mark_connected_components(g);
    }
    for (int c = 1; c <= numcomp; ++c) {
      {
        lprof::Timer t(lprof::get().refends);
        lgp::mark_ref_ends(g, c, rawseq, rawlen, cov_threshold, *res);
      }
      {
        lprof::Timer t(lprof::get().cyc);
        if (lgp::has_cycle(g)) {
          res->status = 1;
          return res;
        }
      }
      {
        lprof::Timer t(lprof::get().compress);
        lgp::compress(g, c);
      }
      {
        lprof::Timer t(lprof::get().cleanup);
        lgp::remove_low_cov(g, true, c, avgcov, low_cov_threshold,
                            min_cov_ratio);
        lgp::remove_tips(g, c, max_tip_len);
        lgp::remove_short_links(g, c, max_link_len, avgcov, max_unit_len,
                                min_report_units, min_report_len,
                                dist_from_str);
      }
      const int64_t reflen = res->seq_set ? res->seq_len : idxlen;
      {
        lprof::Timer t(lprof::get().cyc);
        if (lgp::has_cycle(g)) {
          res->status = 1;
          return res;
        }
      }
      {
        lprof::Timer t(lprof::get().findrep);
        if (lgp::find_repeats_in_graph_paths(g, K, max_mismatch, reflen,
                                             dfs_limit, max_indel_len)) {
          res->status = 2;
          return res;
        }
      }
      if (g.source != nullptr && g.sink != nullptr) {
        lprof::Timer t(lprof::get().eka);
        lgp::eka(g, g.source, g.sink, lgp::F, rawseq, reflen, dfs_limit,
                 max_indel_len, res->seq_off, res->seq_len, res->trim5, *res);
      }
    }
    res->status = 0;
    return res;
  } catch (const std::exception&) {
    if (out) lgb_result_free(out);
    res->status = 3;
    res->jobs.clear();
    return res;
  }
}

extern "C" {

// Non-LR entry (ctypes surface; see lgp_run_impl).
void* lgp_run(const uint8_t* cat, const uint8_t* qcat, int64_t tot,
              int64_t n_reads, const int64_t* starts, const int32_t* lens,
              const int32_t* sample, const int32_t* strand,
              const int32_t* order, const int64_t* name_off,
              const uint8_t* name_blob, int K, int minq, double avgcov,
              int low_cov_threshold, double min_cov_ratio,
              const uint8_t* idxseq, int64_t idxlen, const uint8_t* rawseq,
              int64_t rawlen, double cov_threshold, int max_tip_len,
              int max_link_len, int64_t dfs_limit, int max_indel_len,
              int max_mismatch, int max_unit_len, int min_report_units,
              int min_report_len, int dist_from_str) {
  return lgp_run_impl(cat, qcat, tot, n_reads, starts, lens, sample, strand,
                      order, name_off, name_blob, K, minq, avgcov,
                      low_cov_threshold, min_cov_ratio, idxseq, idxlen,
                      rawseq, rawlen, cov_threshold, max_tip_len,
                      max_link_len, dfs_limit, max_indel_len, max_mismatch,
                      max_unit_len, min_report_units, min_report_len,
                      dist_from_str, nullptr, nullptr, 0);
}

int lgp_status(void* h) { return ((lgp::Result*)h)->status; }
int lgp_trim5(void* h) { return ((lgp::Result*)h)->trim5; }
int lgp_trim3(void* h) { return ((lgp::Result*)h)->trim3; }
int lgp_seq_set(void* h) { return ((lgp::Result*)h)->seq_set; }
long lgp_seq_off(void* h) { return (long)((lgp::Result*)h)->seq_off; }
long lgp_seq_len(void* h) { return (long)((lgp::Result*)h)->seq_len; }
const int32_t* lgp_refcov(void* h) { return ((lgp::Result*)h)->refcov.data(); }
long lgp_n_jobs(void* h) { return (long)((lgp::Result*)h)->jobs.size(); }
long lgp_job_len(void* h, long i) {
  return (long)((lgp::Result*)h)->jobs[i].pathseq.size();
}
const char* lgp_job_seq(void* h, long i) {
  return ((lgp::Result*)h)->jobs[i].pathseq.c_str();
}
const int32_t* lgp_job_covT(void* h, long i) {
  return ((lgp::Result*)h)->jobs[i].covT.data();
}
const int32_t* lgp_job_covN(void* h, long i) {
  return ((lgp::Result*)h)->jobs[i].covN.data();
}
const uint8_t* lgp_job_span(void* h, long i) {
  return ((lgp::Result*)h)->jobs[i].span.data();
}
long lgp_job_src_off(void* h, long i) {
  return (long)((lgp::Result*)h)->jobs[i].src_off;
}
long lgp_job_dist(void* h, long i) {
  return (long)((lgp::Result*)h)->jobs[i].ref_dist;
}
int lgp_job_trim5(void* h, long i) {
  return ((lgp::Result*)h)->jobs[i].trim5;
}
int lgp_job_needs_dp(void* h, long i) {
  return ((lgp::Result*)h)->jobs[i].needs_dp;
}
void lgp_free(void* h) { delete (lgp::Result*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched shard runner (host compute plane).
//
// One native call processes a whole run's windows: indexed BAM fetch with a
// shared per-chunk read cache (consecutive windows overlap 5:1, so decode
// happens once, not per window), active-region triage (CIGAR walk + MD-tag
// parse + softclip map; ref Microassembler.cc:255-432), the read-extraction
// filter chain (ref Microassembler.cc:436-655), quality trim, and the
// self-tuning-k per-window loop driving the lgp_* graph pipeline — all in
// C++ threads across windows. Reads never cross into Python. Output is the
// flat PathJob batch; Python runs the device-batched Gotoh alignment and
// hands the aligned strings back to lsr_finish, which replays the
// transcript column-scan state machine (ref Graph.cc:788-1220,
// Transcript.hh:107-226) natively and emits packed variant records.
//
// Any per-window inconsistency marks that window for Python-engine replay
// (its native jobs/counters are discarded), mirroring lgp_run's status-3
// contract.
// ---------------------------------------------------------------------------

#include <array>
#include <atomic>
#include <chrono>
#include <mutex>
#include <set>
#include <thread>

namespace lsr {

struct Rec {
  int32_t pos = 0, end = 0;
  uint16_t flag = 0;
  uint8_t mapq = 0;
  std::string name, seq, qual;        // qual empty when absent (0xff)
  std::vector<uint32_t> cigar;        // (len<<4)|op
  std::vector<uint8_t> tags;          // raw BAM aux blob

  bool is_mapped() const { return !(flag & 0x4); }
  bool is_reverse() const { return flag & 0x10; }
  bool is_first_mate() const { return (flag & 0x1) && (flag & 0x40); }
  bool is_second_mate() const { return (flag & 0x1) && (flag & 0x80); }
  bool is_duplicate() const { return flag & 0x400; }
  bool is_primary() const { return !(flag & 0x100); }
};

// Decode one raw BAM record body into Rec (mirrors io.bam._parse_record).
void parse_rec(const std::vector<uint8_t>& rec, Rec& out) {
  int32_t refid, pos, l_seq;
  uint32_t flag_nc, bin_mq_nl;
  std::memcpy(&refid, rec.data() + 0, 4);
  std::memcpy(&pos, rec.data() + 4, 4);
  std::memcpy(&bin_mq_nl, rec.data() + 8, 4);
  std::memcpy(&flag_nc, rec.data() + 12, 4);
  std::memcpy(&l_seq, rec.data() + 16, 4);
  const uint8_t l_read_name = bin_mq_nl & 0xff;
  out.mapq = (bin_mq_nl >> 8) & 0xff;
  const uint16_t n_cigar = flag_nc & 0xffff;
  out.flag = flag_nc >> 16;
  out.pos = pos;
  size_t q = 32;
  out.name.assign((const char*)rec.data() + q,
                  l_read_name ? l_read_name - 1 : 0);
  q += l_read_name;
  out.cigar.resize(n_cigar);
  int64_t span = 0;
  for (int c = 0; c < n_cigar; ++c) {
    uint32_t v;
    std::memcpy(&v, rec.data() + q + 4ull * c, 4);
    out.cigar[c] = v;
    const uint32_t op = v & 0xf;
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) span += v >> 4;
  }
  out.end = (int32_t)(pos + span);
  q += 4ull * n_cigar;
  const uint8_t* seq4 = rec.data() + q;
  out.seq.resize(l_seq);
  for (int i = 0; i < l_seq; ++i)
    out.seq[i] = kSeqNt[(i & 1) ? (seq4[i >> 1] & 0xf) : (seq4[i >> 1] >> 4)];
  q += (l_seq + 1) / 2;
  const uint8_t* qual = rec.data() + q;
  if (l_seq > 0 && qual[0] != 0xff) {
    out.qual.resize(l_seq);
    for (int i = 0; i < l_seq; ++i) out.qual[i] = (char)(qual[i] + 33);
  } else {
    out.qual.clear();
  }
  q += l_seq;
  out.tags.assign(rec.begin() + q, rec.end());
}

// Fetch+parse records on refid with pos <= end && end_position >= beg
// (same superset contract as lbam_fetch).
void fetch_recs(BamFile& b, int refid, int64_t beg, int64_t end,
                std::vector<Rec>& out) {
  std::vector<Chunk> chunks;
  if (b.has_index && refid >= 0 && refid < (int)b.index.size()) {
    const RefIndex& ri = b.index[refid];
    uint64_t min_off = 0;
    size_t intv = (size_t)(beg >> 14);
    if (intv < ri.ioffsets.size()) min_off = ri.ioffsets[intv];
    std::vector<uint32_t> bins;
    reg2bins(beg, end + 1, bins);
    for (uint32_t bin : bins) {
      auto it = ri.bins.find(bin);
      if (it == ri.bins.end()) continue;
      for (const Chunk& c : it->second)
        if (c.end > min_off) chunks.push_back(c);
    }
    std::sort(chunks.begin(), chunks.end(),
              [](const Chunk& a, const Chunk& c) { return a.beg < c.beg; });
    std::vector<Chunk> merged;
    for (const Chunk& c : chunks) {
      if (!merged.empty() && c.beg <= merged.back().end)
        merged.back().end = std::max(merged.back().end, c.end);
      else
        merged.push_back(c);
    }
    chunks = std::move(merged);
  } else if (refid >= 0) {
    chunks.push_back({b.first_rec_voffset, (uint64_t)b.bgzf.file_size << 16});
  }
  std::vector<uint8_t> rec;
  for (const Chunk& c : chunks) {
    if (!b.bgzf.seek_virtual(c.beg)) continue;
    while (b.bgzf.tell_virtual() < c.end && !b.bgzf.at_eof()) {
      if (!read_record(b.bgzf, rec)) break;
      RecMeta m = pack_record(rec, nullptr);
      if (m.refid != refid) {
        if (b.has_index) continue;
        if (m.refid > refid) break;
        continue;
      }
      if (m.pos > end) break;
      if (m.end >= beg) {
        out.emplace_back();
        parse_rec(rec, out.back());
      }
    }
  }
}

// --- BAM aux tag access (mirrors io.bam._parse_tags walk + the
// get_numeric_tag/get_string_tag -1.0/"" conventions, util.cc:486-560) -----
const uint8_t* find_tag(const std::vector<uint8_t>& tags, const char* tag,
                        char* type_out) {
  size_t p = 0;
  const size_t n = tags.size();
  while (p + 2 < n) {
    const bool hit = tags[p] == (uint8_t)tag[0] && tags[p + 1] == (uint8_t)tag[1];
    const char t = (char)tags[p + 2];
    p += 3;
    size_t sz;
    switch (t) {
      case 'A': case 'c': case 'C': sz = 1; break;
      case 's': case 'S': sz = 2; break;
      case 'i': case 'I': case 'f': sz = 4; break;
      case 'Z': case 'H': {
        size_t e = p;
        while (e < n && tags[e] != 0) ++e;
        if (hit) { *type_out = t; return tags.data() + p; }
        p = e + 1;
        continue;
      }
      case 'B': {
        if (p + 5 > n) return nullptr;
        const char sub = (char)tags[p];
        uint32_t cnt;
        std::memcpy(&cnt, tags.data() + p + 1, 4);
        size_t esz = (sub == 'c' || sub == 'C') ? 1
                     : (sub == 's' || sub == 'S') ? 2 : 4;
        if (hit) { *type_out = t; return tags.data() + p; }
        p += 5 + (size_t)cnt * esz;
        continue;
      }
      default: return nullptr;  // unknown type: stop (python `break`)
    }
    if (hit) { *type_out = t; return tags.data() + p; }
    p += sz;
  }
  return nullptr;
}

double numeric_tag(const Rec& r, const char* tag) {
  char t = 0;
  const uint8_t* v = find_tag(r.tags, tag, &t);
  if (!v) return -1.0;
  switch (t) {
    case 'c': return (double)*(const int8_t*)v;
    case 'C': return (double)*v;
    case 's': { int16_t x; std::memcpy(&x, v, 2); return (double)x; }
    case 'S': { uint16_t x; std::memcpy(&x, v, 2); return (double)x; }
    case 'i': { int32_t x; std::memcpy(&x, v, 4); return (double)x; }
    case 'I': { uint32_t x; std::memcpy(&x, v, 4); return (double)x; }
    case 'f': { float x; std::memcpy(&x, v, 4); return (double)x; }
    default: return -1.0;
  }
}

std::string string_tag(const Rec& r, const char* tag) {
  char t = 0;
  const uint8_t* v = find_tag(r.tags, tag, &t);
  if (!v) return "";
  if (t == 'A') return std::string(1, (char)*v);
  if (t == 'Z' || t == 'H') {
    const uint8_t* e = v;
    const uint8_t* lim = r.tags.data() + r.tags.size();
    while (e < lim && *e != 0) ++e;
    return std::string((const char*)v, (size_t)(e - v));
  }
  return "";
}

// --- MD-tag parse (engine/seqs.py parse_md; ref util.cc:432-483) ----------
void parse_md(const std::string& md, std::map<int64_t, int32_t>& counts,
              int64_t start, const std::string& qual, int min_qv) {
  static const auto valid = [] {
    std::array<bool, 256> t{};
    for (unsigned char c : std::string("acgtumrwsykvhdbxnACGTUMRWSYKVHDBXN^"))
      t[c] = true;
    return t;
  }();
  const int64_t n = (int64_t)md.size();
  auto first_of = [&](int64_t p) -> int64_t {
    for (int64_t i = p; i < n; ++i)
      if (valid[(uint8_t)md[i]]) return i;
    return -1;
  };
  auto first_not_of = [&](int64_t p) -> int64_t {
    for (int64_t i = p; i < n; ++i)
      if (!valid[(uint8_t)md[i]]) return i;
    return -1;
  };
  int64_t p = first_of(0);
  int64_t p_old = -1;
  int64_t pos = start;
  int64_t rpos = 0;
  while (p != -1) {
    const std::string num = md.substr(p_old + 1, p - (p_old + 1));
    const int step = std::atoi(num.c_str());
    pos += step;
    rpos += step;
    if (md[p] == '^') {
      int64_t p2 = first_not_of(p + 1);
      if (p2 == -1) p2 = n;
      pos += p2 - (p + 1);
      p = first_of(p2);
      p_old = p2 - 1;
    } else {
      pos += 1;
      rpos += 1;
      const char qc = (rpos < (int64_t)qual.size()) ? qual[rpos] : '\0';
      if ((int)(uint8_t)qc >= min_qv) counts[pos] += 1;
      p_old = p;
      p = first_of(p_old + 1);
    }
  }
}

// --- run configuration ------------------------------------------------------
struct Cfg {
  int min_k, max_k, min_qual_trim, min_qual_call;
  int min_map_qual, max_avg_cov, max_delta_as_xs;
  int xa_filter, primary_only, active_regions;
  int min_alt_cnt_tumor;
  int low_cov_threshold;
  double min_cov_ratio, cov_threshold;
  int max_tip_len;
  int64_t dfs_limit;
  int max_indel_len, max_mismatch;
  int max_unit_len, min_report_units, min_report_len, dist_from_str;
  int lr_mode = 0;  // linked-read mode (BX/HP payloads; icfg[20])
  std::vector<std::string> readgroups;  // empty vector => {"null"} semantics

  bool rg_ok(const std::string& rg) const {
    if (readgroups.empty()) return true;  // {"null"} admits everything
    for (const auto& g : readgroups)
      if (g == "null" || g == rg) return true;
    return false;
  }
};

struct SJob {
  int32_t win = 0;
  int32_t K = 0;
  std::string pathseq;
  std::vector<int32_t> covT, covN;   // L*nc rows
  std::vector<uint8_t> span;         // L+1
  int64_t src_off = 0, ref_dist = 0;
  int32_t trim5 = -1;
  uint8_t needs_dp = 0;
  uint8_t nc = 4;                    // coverage-row stride (10 in LR)
  std::shared_ptr<std::vector<int32_t>> refcov;  // nc planes x rawlen
  std::shared_ptr<lgp::BxTables> bxtab;          // LR mode only
};

struct WinInfo {
  int32_t refid_t = -1, refid_n = -1;
  int64_t start = 0, end = 0;
  const uint8_t* raw = nullptr;
  int64_t rawlen = 0;
};

struct WinOut {
  uint8_t fallback = 0;       // python must replay this window
  uint8_t windows_done = 0;
  uint8_t num_skip = 0;
  uint8_t exported = 0;       // device mode: reads exported, k-loop skipped
  uint8_t cls[7] = {0};       // tumor region-class counter deltas
  int64_t reads = 0;          // total_reads delta
  int64_t xbp = 0;            // exported-mode totalreadbp (post-trim)
  double ms = 0;
  std::vector<SJob> jobs;
  std::vector<uint8_t> xbuf;  // packed post-trim reads (device mode)
};

struct Var {
  int32_t win = 0;
  int64_t pos = 0;
  char code = '?';
  char prev_ref = 0, prev_alt = 0;
  int32_t kmer = 0;
  int32_t cov[8] = {0};       // rcnf rcnr rctf rctr acnf acnr actf actr
  // LR extras (zero / empty outside LR mode): HP triples already in the
  // Variant ctor's rotated order (hp1, hp2, hp0) for hprn/hprt/hpan/hpat,
  // then the 4 BX set strings (ref_n, ref_t, alt_n, alt_t)
  int32_t hp[12] = {0};
  std::string bx[4];
  std::string ref, alt, str_tag;
};

struct Out {
  int status = 0;  // 0 ok, 1 open failure
  Cfg cfg;
  std::vector<WinInfo> wins;
  std::vector<WinOut> res;
  std::vector<SJob*> jobs;     // all jobs in (window, emission) order
  std::vector<Var> vars;
  std::vector<uint8_t> varbuf; // packed wire format (built by lsr_finish)
  std::shared_ptr<std::vector<uint8_t>> raw_keeper;  // window raw bytes
};

inline lprof::StageNs& stage_ns() { return lprof::get(); }
using StageTimer = lprof::Timer;

// extraction read record (graph.add_alignment + trim state)
struct XRead {
  const Rec* rec = nullptr;    // null for the ref pseudo-read
  int32_t label = 0;           // TMR=4 NML=5 REF=3
  int32_t strand = 1;          // FWD=1 REV=2
  int32_t mate = 0;
  char code = 'M';             // M mapped, B bastard, R ref
  int32_t trm5 = 0, trm3 = 0;
  uint8_t junk = 0;
  int32_t bx_id = -1;          // LR: interned BX barcode (-1 = null)
  int32_t hp = 0;              // LR: HP haplotype tag (0..2)
};

// --- active-region triage (micro.is_active_region) -------------------------
bool is_active_region(const std::vector<const Rec*>& alns, const WinInfo& w,
                      bool is_tumor, const Cfg& cfg, WinOut* out) {
  const int min_evidence = cfg.min_alt_cnt_tumor;
  const int mq = is_tumor ? cfg.min_map_qual : 0;
  std::map<int64_t, int32_t> map_x, map_i, map_d, map_sc;

  for (const Rec* al : alns) {
    if (al->pos < w.start || al->end > w.end) continue;
    if (al->mapq < mq || al->is_duplicate()) continue;
    if (al->seq.empty() || al->qual.empty()) continue;
    std::string rg = string_tag(*al, "RG");
    if (rg.empty()) rg = "null";
    if (!cfg.rg_ok(rg)) continue;
    const std::string md = string_tag(*al, "MD");
    if (!md.empty())
      parse_md(md, map_x, al->pos, al->qual, cfg.min_qual_call);
    // CIGAR walk: pos advances for every non-I op (incl. S); events at the
    // post-advance position (reference quirk, Microassembler.cc:316-346)
    int64_t pos = al->pos;
    for (uint32_t cg : al->cigar) {
      const uint32_t op = cg & 0xf;
      const uint32_t ln = cg >> 4;
      if (op != 1) pos += ln;        // I==1
      if (op == 8) map_x[pos] += 1;  // X
      if (op == 1) map_i[pos] += 1;  // I
      if (op == 2) map_d[pos] += 1;  // D
    }
    // softclip genome positions (bamtools GetSoftClips semantics)
    {
      int64_t ref_pos = al->pos;
      for (uint32_t cg : al->cigar) {
        const uint32_t op = cg & 0xf;
        const uint32_t ln = cg >> 4;
        // D(2) M(0) X(8) N(3) =(7) advance ref
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) ref_pos += ln;
        else if (op == 4) map_sc[ref_pos] += 1;  // S
      }
    }
  }
  auto any_ge = [&](const std::map<int64_t, int32_t>& m) {
    for (const auto& kv : m)
      if (kv.second >= min_evidence) return true;
    return false;
  };
  const bool snv = any_ge(map_x);
  const bool indel = any_ge(map_i) || any_ge(map_d);
  const bool softclip = any_ge(map_sc);

  if (is_tumor && out) {
    if (snv && !indel && !softclip) out->cls[0] += 1;  // snv_only
    if (!snv && indel && !softclip) out->cls[1] += 1;  // indel_only
    if (!snv && !indel && softclip) out->cls[2] += 1;  // softclip_only
    if (!snv && (indel || softclip)) out->cls[3] += 1; // indel_or_softclip
    if ((snv || indel) && !softclip) out->cls[4] += 1; // snv_or_indel
    if ((snv || softclip) && !indel) out->cls[5] += 1; // snv_or_softclip
    if (snv || indel || softclip) out->cls[6] += 1;    // snv_or_indel_or_sc
  }
  return snv || indel || softclip;
}

// --- read extraction (micro.extract_reads) ---------------------------------
// Returns true when the window must be skipped (max avg coverage).
bool extract_reads(const std::vector<const Rec*>& alns, const WinInfo& w,
                   bool is_tumor, const Cfg& cfg, std::vector<XRead>& reads,
                   WinOut& out,
                   std::vector<std::string>* bx_names = nullptr,
                   std::unordered_map<std::string, int32_t>* bx_intern =
                       nullptr) {
  const int mq = is_tumor ? cfg.min_map_qual : 0;
  const double min_delta = is_tumor ? (double)cfg.max_delta_as_xs : -1.0;
  int64_t totalreadbp = 0;
  bool skip = false;

  for (const Rec* al : alns) {
    const double avgcov =
        w.rawlen ? (double)totalreadbp / (double)w.rawlen : 0.0;
    if (avgcov > (double)cfg.max_avg_cov) { skip = true; break; }
    if (al->pos < w.start || al->end > w.end) continue;
    if (cfg.primary_only && !al->is_primary()) continue;
    if (al->mapq < mq || al->is_duplicate()) continue;

    int32_t mate = 0;
    if (al->is_first_mate()) mate = 1;
    if (al->is_second_mate()) mate = 2;
    const int32_t strand = al->is_reverse() ? 2 : 1;

    const double as_ = numeric_tag(*al, "AS");
    const double xs_ = numeric_tag(*al, "XS");
    const double delta = std::fabs(as_ - xs_);
    if (delta <= min_delta && as_ != -1.0 && xs_ != -1.0) continue;

    std::string xt = string_tag(*al, "XT");
    if (xt.empty()) xt = "null";
    if (xt == "R" && is_tumor) continue;
    std::string xa = string_tag(*al, "XA");
    if (xa.empty()) xa = "null";
    if (xa != "null" && is_tumor && cfg.xa_filter) continue;

    std::string rg = string_tag(*al, "RG");
    if (rg.empty()) rg = "null";
    if (cfg.rg_ok(rg)) {
      XRead r;
      r.rec = al;
      r.label = is_tumor ? 4 : 5;
      r.strand = strand;
      r.mate = mate;
      r.code = al->is_mapped() ? 'M' : 'B';
      if (cfg.lr_mode) {
        // BX/HP capture (ref: Microassembler.cc:582-593)
        std::string bxs = string_tag(*al, "BX");
        if (!bxs.empty() && bx_intern != nullptr) {
          auto ins = bx_intern->emplace(bxs, (int32_t)bx_names->size());
          if (ins.second) bx_names->push_back(bxs);
          r.bx_id = ins.first->second;
        }
        const double hv = numeric_tag(*al, "HP");
        r.hp = (int32_t)hv;
        if (r.hp < 0 || r.hp > 2) r.hp = 0;
      }
      // quality trim (graph.trim; ref Graph.cc:355-384)
      const std::string& s = al->seq;
      const std::string& q = al->qual;
      const int64_t ln = (int64_t)s.size();
      auto is_dna = [](char c) {
        return c == 'A' || c == 'C' || c == 'G' || c == 'T' || c == 'a' ||
               c == 'c' || c == 'g' || c == 't';
      };
      auto good = [&](int64_t i) {
        return is_dna(s[i]) && i < (int64_t)q.size() &&
               (uint8_t)q[i] >= cfg.min_qual_trim;
      };
      int64_t t5 = 0;
      while (t5 < ln && !good(t5)) ++t5;
      if (t5 == ln) {
        r.trm5 = (int32_t)ln;
        r.trm3 = 0;
        r.junk = 1;
      } else {
        int64_t t3 = 0;
        while (t3 < ln && !good(ln - 1 - t3)) ++t3;
        r.trm5 = (int32_t)t5;
        r.trm3 = (int32_t)t3;
        r.junk = 0;
        for (int64_t i = t5; i < ln - t3; ++i)
          if (!is_dna(s[i])) { r.junk = 1; break; }
      }
      reads.push_back(std::move(r));
      out.reads += 1;
      totalreadbp += ln;
    }
  }
  return skip;
}

// --- per-window self-tuning-k loop (micro.process_graph) -------------------
// Returns false on internal error (window marked for python replay).
bool process_graph(const WinInfo& w, const Cfg& cfg,
                   std::vector<XRead>& reads, const uint8_t* gate_row,
                   int n_k, int win_idx, WinOut& out,
                   std::shared_ptr<std::vector<std::string>> bx_names =
                       nullptr) {
  // count mapped
  int64_t mapped = 0;
  for (const auto& r : reads)
    if (r.code == 'M') ++mapped;
  if (mapped <= 0) return true;

  // ref pseudo-read appended once (fastbuild._add_ref_read)
  {
    XRead rr;
    rr.rec = nullptr;
    rr.label = 3;
    rr.strand = 1;
    rr.mate = 0;
    rr.code = 'R';
    reads.push_back(rr);
  }

  // persistent per-window seq/trim state (ref.py set_k stale-trim quirk)
  int64_t seq_off = 0, seq_len = w.rawlen;
  int32_t cur_trim5 = 0, cur_trim3 = 0;
  (void)cur_trim5;
  (void)cur_trim3;

  const std::string qK((size_t)w.rawlen, 'K');

  for (int k = cfg.min_k; k <= cfg.max_k; k += 2) {
    // repeat gates (device-precomputed bitmap, or native scans)
    const int ki = (k - cfg.min_k) / 2;
    bool gated;
    if (n_k > 0 && ki < n_k) {
      gated = gate_row[ki] != 0;
    } else {
      gated = lsq_is_repeat(w.raw, w.rawlen, k) ||
              lsq_is_almost_repeat(w.raw, w.rawlen, k, cfg.max_mismatch);
    }
    if (gated) continue;

    // gather post-trim reads into the concatenated stream (fastbuild
    // _gather/_concat: skip junk, accumulate totalreadbp, skip len-K<=0,
    // K+1-wide 0xFF/0 gaps)
    const int GAP = k + 1;
    int64_t totalreadbp = 0;
    std::vector<int64_t> starts;
    std::vector<int32_t> lens, sample, strand, order, bxv, hpv;
    std::vector<const XRead*> used;
    int64_t tot = 0;
    for (const auto& r : reads) {
      if (r.junk) continue;
      const int64_t ln =
          (r.rec ? (int64_t)r.rec->seq.size() : w.rawlen) - r.trm5 - r.trm3;
      if (r.label != 3) totalreadbp += ln;
      if (ln - k <= 0) continue;
      used.push_back(&r);
      tot += ln + GAP;
    }
    std::vector<uint8_t> cat((size_t)tot, 0xFF), qcat((size_t)tot, 0);
    std::vector<int64_t> name_off;
    std::string name_blob;
    name_off.push_back(0);
    int64_t off = 0;
    for (const XRead* r : used) {
      const char* sp;
      const char* qp;
      int64_t ln;
      if (r->rec) {
        ln = (int64_t)r->rec->seq.size() - r->trm5 - r->trm3;
        sp = r->rec->seq.data() + r->trm5;
        qp = r->rec->qual.data() + r->trm5;
        name_blob += r->rec->name;
      } else {
        ln = w.rawlen;
        sp = (const char*)w.raw;
        qp = qK.data();
        // ref pseudo-read name = window hdr; only consulted for paired
        // reads (order>0), never for the ref read — a stand-in is fine
        name_blob += "ref";
      }
      starts.push_back(off);
      lens.push_back((int32_t)ln);
      sample.push_back(r->label);
      strand.push_back(r->strand);
      order.push_back(r->mate);
      bxv.push_back(r->bx_id);
      hpv.push_back(r->hp);
      std::memcpy(cat.data() + off, sp, (size_t)ln);
      std::memcpy(qcat.data() + off, qp, (size_t)ln);
      off += ln + GAP;
      name_off.push_back((int64_t)name_blob.size());
    }

    const double avgcov =
        w.rawlen ? (double)totalreadbp / (double)w.rawlen : 0.0;

    if (used.empty()) {
      // no usable reads: zero coverage projection, done (fastpipe no-seqs)
      auto rc = std::make_shared<std::vector<int32_t>>(4 * w.rawlen, 0);
      (void)rc;
      break;
    }

    const uint8_t* idxseq = w.raw + seq_off;
    const int64_t idxlen = seq_len;
    void* h = lgp_run_impl(
        cat.data(), qcat.data(), tot, (int64_t)used.size(), starts.data(),
        lens.data(), sample.data(), strand.data(), order.data(),
        name_off.data(), (const uint8_t*)name_blob.data(), k,
        cfg.min_qual_call, avgcov, cfg.low_cov_threshold, cfg.min_cov_ratio,
        idxseq, idxlen, w.raw, w.rawlen, cfg.cov_threshold, cfg.max_tip_len,
        k / 2, cfg.dfs_limit, cfg.max_indel_len, cfg.max_mismatch,
        cfg.max_unit_len, cfg.min_report_units, cfg.min_report_len,
        cfg.dist_from_str, cfg.lr_mode ? bxv.data() : nullptr,
        cfg.lr_mode ? hpv.data() : nullptr, cfg.lr_mode);
    auto* res = (lgp::Result*)h;
    const int status = res->status;
    if (status == 3) {
      lgp_free(h);
      return false;  // python replay
    }
    // state updates happen for OK and CYCLE/REPEAT alike (fastpipe glue)
    auto refcov = std::make_shared<std::vector<int32_t>>(res->refcov);
    cur_trim5 = res->trim5;
    cur_trim3 = res->trim3;
    if (res->seq_set) {
      seq_off = res->seq_off;
      seq_len = res->seq_len;
    }
    for (auto& j : res->jobs) {
      SJob sj;
      sj.win = win_idx;
      sj.K = k;
      sj.pathseq = std::move(j.pathseq);
      sj.covT = std::move(j.covT);
      sj.covN = std::move(j.covN);
      sj.span = std::move(j.span);
      sj.src_off = j.src_off;
      sj.ref_dist = j.ref_dist;
      sj.trim5 = j.trim5;
      sj.needs_dp = j.needs_dp;
      sj.nc = (uint8_t)res->nc;
      sj.refcov = refcov;
      if (res->bxtab) {
        res->bxtab->names = bx_names;
        sj.bxtab = res->bxtab;
      }
      out.jobs.push_back(std::move(sj));
    }
    lgp_free(h);
    if (status == 0) break;
    // CYCLE/REPEAT: retry next k (graph cleared; reads persist)
  }
  return true;
}

// --- device-mode read export -----------------------------------------------
// Packs the post-trim non-junk reads for the device graph engine: per read
// int32 len; int8 label, strand, mate, pad; int32 frag (-1 unpaired);
// seq bytes; qual bytes. Junk reads still count toward totalreadbp
// (fastbuild._gather semantics).
void export_reads(const std::vector<XRead>& reads, WinOut& out) {
  std::unordered_map<std::string, int32_t> frags;
  out.xbp = 0;
  int64_t n = 0;
  for (const auto& r : reads) {
    if (r.junk) continue;
    const int64_t tl = (int64_t)r.rec->seq.size() - r.trm5 - r.trm3;
    out.xbp += tl;
    ++n;
  }
  out.xbuf.reserve((size_t)(n * 12 + out.xbp * 2 + 16));
  for (const auto& r : reads) {
    if (r.junk) continue;
    const std::string& s = r.rec->seq;
    const std::string& q = r.rec->qual;
    const int32_t tl = (int32_t)s.size() - r.trm5 - r.trm3;
    int32_t frag = -1;
    if (r.mate > 0) {
      auto it = frags.emplace(r.rec->name, (int32_t)frags.size());
      frag = it.first->second;
    }
    const size_t base = out.xbuf.size();
    out.xbuf.resize(base + 12 + 2 * (size_t)tl);
    uint8_t* p = out.xbuf.data() + base;
    std::memcpy(p, &tl, 4);
    p[4] = (uint8_t)r.label;
    p[5] = (uint8_t)r.strand;
    p[6] = (uint8_t)r.mate;
    p[7] = 0;
    std::memcpy(p + 8, &frag, 4);
    std::memcpy(p + 12, s.data() + r.trm5, (size_t)tl);
    std::memcpy(p + 12 + tl, q.data() + r.trm5, (size_t)tl);
  }
  out.exported = 1;
}

// --- one window end-to-end (micro.process_window) ---------------------------
void process_window(const WinInfo& w, const Cfg& cfg,
                    const std::vector<const Rec*>& tumor_alns,
                    const std::vector<const Rec*>& normal_alns,
                    const uint8_t* gate_row, uint8_t exact_maxk, int n_k,
                    int win_idx, WinOut& out, bool device_mode = false) {
  // is_n_seq is always false (reference isNseq `||` bug, util.cc:259-273)
  if (n_k > 0) {
    if (exact_maxk) return;  // maxk exact-repeat gate: silent skip
  } else if (lsq_is_repeat(w.raw, w.rawlen, cfg.max_k)) {
    return;
  }

  bool active_t = true, active_n = true;
  if (cfg.active_regions) {
    StageTimer st(stage_ns().triage);
    active_t = is_active_region(tumor_alns, w, true, cfg, &out);
    active_n = is_active_region(normal_alns, w, false, cfg, nullptr);
  }
  if (active_t || active_n) {
    std::vector<XRead> reads;
    bool skip_t, skip_n;
    // per-window BX interning (LR mode): stable ids across samples and
    // k attempts; rendered back to strings at variant emission
    std::shared_ptr<std::vector<std::string>> bx_names;
    std::unordered_map<std::string, int32_t> bx_intern;
    if (cfg.lr_mode)
      bx_names = std::make_shared<std::vector<std::string>>();
    {
      StageTimer st(stage_ns().extract);
      skip_t = extract_reads(tumor_alns, w, true, cfg, reads, out,
                             bx_names.get(), &bx_intern);
      skip_n = extract_reads(normal_alns, w, false, cfg, reads, out,
                             bx_names.get(), &bx_intern);
    }
    if (!skip_t && !skip_n) {
      if (device_mode) {
        StageTimer st(stage_ns().extract);
        export_reads(reads, out);
      } else {
        StageTimer st(stage_ns().kloop);
        if (!process_graph(w, cfg, reads, gate_row, n_k, win_idx, out,
                           bx_names)) {
          out.fallback = 1;
          out.jobs.clear();
          return;
        }
      }
    } else {
      out.num_skip = 1;
    }
  } else {
    out.num_skip = 1;
  }
  out.windows_done = 1;
}

// pack: int32 win; int64 pos; u8 code,prev_ref,prev_alt,pad; int32 kmer;
//       int32 l_ref,l_alt,l_str; int32 cov[8]; bytes ref,alt,str
// Wire format v1: 64-byte header (win, pos, code, prev bp pair, version
// byte, kmer, ref/alt/str lengths, 8 cov counters) + 48 bytes HP triples
// + 16 bytes BX lengths, then ref | alt | str | bx0..bx3 payloads.
// (v0 had no HP/BX block; the version byte at offset 15 tells them apart
// for the Python parsers.)
void pack_vars(const std::vector<Var>& vars, std::vector<uint8_t>& buf) {
  buf.clear();
  for (const auto& v : vars) {
    const size_t base = buf.size();
    size_t bxlen = 0;
    for (int q = 0; q < 4; ++q) bxlen += v.bx[q].size();
    buf.resize(base + 128 + v.ref.size() + v.alt.size() +
               v.str_tag.size() + bxlen);
    uint8_t* w = buf.data() + base;
    std::memcpy(w, &v.win, 4);
    std::memcpy(w + 4, &v.pos, 8);
    w[12] = (uint8_t)v.code;
    w[13] = (uint8_t)v.prev_ref;
    w[14] = (uint8_t)v.prev_alt;
    w[15] = 1;  // wire format version
    std::memcpy(w + 16, &v.kmer, 4);
    const int32_t lr = (int32_t)v.ref.size(), la = (int32_t)v.alt.size(),
                  ls = (int32_t)v.str_tag.size();
    std::memcpy(w + 20, &lr, 4);
    std::memcpy(w + 24, &la, 4);
    std::memcpy(w + 28, &ls, 4);
    std::memcpy(w + 32, v.cov, 32);
    std::memcpy(w + 64, v.hp, 48);
    int32_t bl[4];
    for (int q = 0; q < 4; ++q) bl[q] = (int32_t)v.bx[q].size();
    std::memcpy(w + 112, bl, 16);
    uint8_t* wp = w + 128;
    std::memcpy(wp, v.ref.data(), v.ref.size());
    wp += v.ref.size();
    std::memcpy(wp, v.alt.data(), v.alt.size());
    wp += v.alt.size();
    std::memcpy(wp, v.str_tag.data(), v.str_tag.size());
    wp += v.str_tag.size();
    for (int q = 0; q < 4; ++q) {
      std::memcpy(wp, v.bx[q].data(), v.bx[q].size());
      wp += v.bx[q].size();
    }
  }
}

}  // namespace lsr

// ---------------------------------------------------------------------------
// Finish stage: aligned path -> transcripts -> variant records
// (extract.py _scan + transcript.py; ref Graph.cc:788-1220,
// Transcript.hh:107-226). Only the 4 coverage columns exist in non-LR mode;
// the HP columns are identically zero, so the 12 HP outputs are constants.
// ---------------------------------------------------------------------------

namespace lsr {

struct Row4 {
  int64_t v[10];  // 10-col coverage row (engine/node.py column order);
                  // cols 4..9 are zero outside LR mode
};

inline Row4 row_at(const std::vector<int32_t>& cov, int64_t i, int nc) {
  Row4 r{};
  for (int c = 0; c < nc; ++c) r.v[c] = cov[i * nc + c];
  return r;
}

// REF-allele coverage row at window position pos (zeros out of range);
// plane layout from lgp refcov: [t_fwd | t_rev | n_fwd | n_rev] (+ LR:
// [t_hp0..2 | n_hp0..2]) x rawlen. HP values land in row cols 4..6
// (ref.py compute_coverage writes cols 0,1,4,5,6).
inline Row4 ref_row(const SJob& j, const WinInfo& w, int64_t pos,
                    bool tumor) {
  Row4 r{};
  if (pos < 0 || pos >= w.rawlen || !j.refcov) return r;
  const int32_t* rc = j.refcov->data();
  const int64_t n = w.rawlen;
  if (tumor) {
    r.v[0] = rc[pos];
    r.v[1] = rc[n + pos];
    if (j.nc == 10)
      for (int h = 0; h < 3; ++h) r.v[4 + h] = rc[(4 + h) * n + pos];
  } else {
    r.v[0] = rc[2 * n + pos];
    r.v[1] = rc[3 * n + pos];
    if (j.nc == 10)
      for (int h = 0; h < 3; ++h) r.v[4 + h] = rc[(7 + h) * n + pos];
  }
  return r;
}

struct Tx {
  int64_t pos, ref_pos, start_pos, end_pos, ref_end_pos;
  char code;
  std::string ref, qry;
  bool somatic;
  char prev_bp_ref, prev_bp_alt;
  std::vector<Row4> altN, altT, refN, refT;
};

struct Stats {
  int64_t mn[10], mn0[10], mean[10];
};

// transcript.py _compute_stats: min seeded from the first row; min_non0
// seeded from min (zero first row pins it); sums wrap uint16; mean is
// float32-divided then truncated (Transcript.hh:123-226).
Stats compute_stats(const std::vector<Row4>& rows) {
  Stats st{};
  int64_t s[10] = {0};
  for (int c = 0; c < 10; ++c) {
    st.mn[c] = rows[0].v[c];
    st.mn0[c] = rows[0].v[c];
  }
  for (const auto& r : rows)
    for (int c = 0; c < 10; ++c) {
      const int64_t x = r.v[c];
      s[c] = (s[c] + x) & 0xFFFF;
      if (x != 0 && x < st.mn0[c]) st.mn0[c] = x;
      if (x < st.mn[c]) st.mn[c] = x;
    }
  const int64_t n = (int64_t)rows.size();
  for (int c = 0; c < 10; ++c)
    st.mean[c] = n ? (int64_t)((float)s[c] / (float)n) : 0;
  return st;
}

// find_tandems with motif accumulation (engine/seqs.py find_tandems;
// ref util.cc:574-758).
void find_tandems_full(const std::string& seq, int max_unit_len,
                       int min_report_units, int min_report_len,
                       int dist_from_str, int64_t pos, bool* ans_out,
                       int64_t* len_out, std::string* motif_out) {
  const int64_t L = (int64_t)seq.size();
  bool ans = false;
  int64_t out_len = 0;
  std::string motif;
  std::vector<std::vector<int64_t>> offsets(max_unit_len + 1);
  for (int m = 0; m <= max_unit_len; ++m) {
    offsets[m].assign(max_unit_len + 2, 0);
    for (int p = 0; p < m; ++p) offsets[m][p] = p;
  }
  for (int64_t i = 0; i < L; ++i) {
    for (int merlen = 1; merlen <= max_unit_len; ++merlen) {
      const int64_t phase = i % merlen;
      const int64_t offset = offsets[merlen][phase];
      int64_t j = 0;
      while (j < merlen && i + j < L && seq[i + j] == seq[offset + j]) ++j;
      if (j != merlen || (i + j + 1 == L)) {
        const char left = offset > 0 ? seq[offset - 1] : '\0';
        if (left != seq[offset + merlen - 1]) {
          if ((i - offset) / merlen >= min_report_units &&
              i - offset >= min_report_len) {
            int64_t ml = 1;
            while (ml < merlen) {
              const int64_t units = (i - offset + j) / ml;
              bool allmatch = true;
              for (int64_t index = 1; index < units; ++index)
                if (seq.compare(offset, ml, seq, offset + index * ml, ml) !=
                    0) {
                  allmatch = false;
                  break;
                }
              if (!allmatch)
                ++ml;
              else
                break;
            }
            if (ml == merlen) {
              const int64_t start = offset, end = i + j;
              if (pos >= start - dist_from_str && pos <= end + dist_from_str) {
                ans = true;
                out_len = end - start;
                motif += seq.substr(offset, merlen);
              }
            }
          }
        }
        offsets[merlen][phase] = i;
      }
    }
  }
  *ans_out = ans;
  *len_out = out_len;
  *motif_out = std::move(motif);
}

inline bool is_acgt(char c) {
  return c == 'A' || c == 'C' || c == 'G' || c == 'T';
}

// extract.py _bx_set: union the per-mer barcode sets over every K-mer
// start in [start, end], canonical orientation; ";"-joined sorted
// strings, "." when empty. Returns false on the out-of-range abort (the
// reference's std::out_of_range from substr, swallowed upstream).
inline bool render_bx(
    const std::unordered_map<std::string, std::vector<int32_t>>& table,
    int64_t start, int64_t end, const char* seq, int64_t len, int64_t K,
    const std::vector<std::string>& names, std::string* out) {
  if (start < 0 || end > len) return false;
  uint8_t comp[256];
  lgb::comp_table(comp);
  std::set<int32_t> ids;
  std::string fw, rv;
  for (int64_t i = start; i <= end; ++i) {
    if (i < 0 || i + K > len) continue;  // short substr: no K-length key
    fw.assign(seq + i, (size_t)K);
    rv.resize((size_t)K);
    for (int64_t q = 0; q < K; ++q)
      rv[(size_t)q] = (char)comp[(uint8_t)fw[(size_t)(K - 1 - q)]];
    const std::string& cm = fw < rv ? fw : rv;
    auto it = table.find(cm);
    if (it != table.end())
      for (int32_t b : it->second) ids.insert(b);
  }
  if (ids.empty()) {
    *out = ".";
    return true;
  }
  std::vector<std::string> strs;
  strs.reserve(ids.size());
  for (int32_t b : ids) strs.push_back(names[(size_t)b]);
  std::sort(strs.begin(), strs.end());
  std::string r;
  for (size_t q = 0; q < strs.size(); ++q) {
    if (q) r += ';';
    r += strs[q];
  }
  *out = std::move(r);
  return true;
}

// Column-scan state machine for one job. Returns false on the
// leading-gap abort (the reference's swallowed std::out_of_range).
bool scan_job(const SJob& j, const WinInfo& w, const std::string& ra,
              const std::string& pa, const Cfg& cfg, std::vector<Var>& vars) {
  const int64_t K = j.K;
  const int nc = j.nc;
  const int64_t L = (int64_t)j.covN.size() / nc;
  int64_t pos_in_ref = 0, refpos = 0, pathpos = 0;
  char code = '?';
  std::vector<Tx> txs;
  const int64_t n = (int64_t)ra.size();

  for (int64_t i = 0; i < n; ++i) {
    const char prev_code = code;
    if (ra[i] == '-') {
      code = '^';
      pos_in_ref = refpos;
      pathpos += 1;
    } else if (pa[i] == '-') {
      code = 'v';
      pos_in_ref = refpos;
      refpos += 1;
    } else {
      code = (ra[i] == pa[i]) ? '=' : 'x';
      pos_in_ref = refpos;
      refpos += 1;
      pathpos += 1;
    }
    if (pathpos > L) break;
    const bool within = j.span[pathpos] != 0;
    const int64_t P = pathpos - 1;
    // python's covN[-1] wraps to the last row (only reachable on paths the
    // leading-gap abort kills before the rows are consumed)
    const int64_t Pw = P >= 0 ? P : (L > 0 ? L - 1 : 0);
    if (code != '=') {
      const Row4 COVn = L ? row_at(j.covN, Pw, nc) : Row4{};
      const Row4 COVt = L ? row_at(j.covT, Pw, nc) : Row4{};
      const Row4 REFn = ref_row(j, w, pos_in_ref + j.trim5, false);
      const Row4 REFt = ref_row(j, w, pos_in_ref + j.trim5, true);
      const int64_t rrpos = pos_in_ref + w.start + j.trim5;
      const size_t ts = txs.size();
      int64_t pr = i - 1;
      while (pr >= 0 && !is_acgt(ra[pr])) --pr;
      int64_t pq = i - 1;
      while (pq >= 0 && !is_acgt(pa[pq])) --pq;
      if (pr < 0 || pq < 0) return false;  // leading-gap alignment

      if (ts > 0 && prev_code != '=') {
        Tx& t = txs.back();
        if (within) t.somatic = true;
        t.ref += ra[i];
        t.qry += pa[i];
        t.end_pos = P;
        t.ref_end_pos = pos_in_ref;
        if (code == '^' && t.code == code && t.pos == rrpos) {
          t.altN.push_back(COVn);
          t.altT.push_back(COVt);
        } else if (code == 'v' && t.code == code &&
                   (t.pos + (int64_t)t.ref.size()) == rrpos) {
          t.refN.push_back(REFn);
          t.refT.push_back(REFt);
        } else if (code == 'x' || t.code != code) {
          t.code = 'c';
          t.altN.push_back(COVn);
          t.altT.push_back(COVt);
          t.refN.push_back(REFn);
          t.refT.push_back(REFt);
        }
      } else {
        Tx t;
        t.pos = rrpos;
        t.ref_pos = pos_in_ref;
        t.start_pos = P + 1;
        t.code = code;
        t.end_pos = P;
        t.ref_end_pos = pos_in_ref;
        t.ref.assign(1, ra[i]);
        t.qry.assign(1, pa[i]);
        t.somatic = within;
        t.prev_bp_ref = ra[pr];
        t.prev_bp_alt = pa[pq];
        t.altN.push_back(COVn);
        t.altT.push_back(COVt);
        t.refN.push_back(REFn);
        t.refT.push_back(REFt);
        txs.push_back(std::move(t));
      }
    }
  }

  for (Tx& t : txs) {
    if (t.code != 'x') {
      // K bp of post-event coverage resync (Graph.cc:1040-1068)
      for (int64_t q = 0; q <= K; ++q) {
        const int64_t idx1 = t.end_pos + q;
        if (idx1 < L) {
          if (j.span[idx1]) t.somatic = true;
          t.altN.push_back(row_at(j.covN, idx1, nc));
          t.altT.push_back(row_at(j.covT, idx1, nc));
        }
        const int64_t idx2 = t.ref_end_pos + j.trim5 + q;
        t.refN.push_back(ref_row(j, w, idx2, false));
        t.refT.push_back(ref_row(j, w, idx2, true));
      }
    }
    const Stats aN = compute_stats(t.altN);
    const Stats aT = compute_stats(t.altT);
    const Stats rN = compute_stats(t.refN);
    const Stats rT = compute_stats(t.refT);

    int64_t RCNF = rN.mn[0], RCNR = rN.mn[1];
    int64_t RCTF = rT.mn[0], RCTR = rT.mn[1];
    int64_t ACNF, ACNR;
    if (t.code == 'x') {
      ACNF = aN.mn[2];
      ACNR = aN.mn[3];
    } else {
      ACNF = aN.mn0[0];
      ACNR = aN.mn0[1];
    }
    int64_t ACTF = (t.code == 'x') ? aT.mn[2] : aT.mn[0];
    int64_t ACTR = (t.code == 'x') ? aT.mn[3] : aT.mn[1];

    // LR haplotype selections (transcript.py get_min_cov_*_hp: plain min,
    // minqv columns for SNVs)
    int64_t HP0RN = rN.mn[4], HP1RN = rN.mn[5], HP2RN = rN.mn[6];
    int64_t HP0RT = rT.mn[4], HP1RT = rT.mn[5], HP2RT = rT.mn[6];
    const int hb = (t.code == 'x') ? 7 : 4;
    int64_t HP0AN = aN.mn[hb], HP1AN = aN.mn[hb + 1], HP2AN = aN.mn[hb + 2];
    const int64_t HP0AT = aT.mn[hb], HP1AT = aT.mn[hb + 1],
                  HP2AT = aT.mn[hb + 2];

    if (t.somatic) {
      RCNF = rN.mean[0];
      RCNR = rN.mean[1];
      RCTF = rT.mean[0];
      RCTR = rT.mean[1];
      ACNF = ACNR = 0;
      HP0RT = rT.mean[4];
      HP1RT = rT.mean[5];
      HP2RT = rT.mean[6];
      HP0RN = rN.mean[4];
      HP1RN = rN.mean[5];
      HP2RN = rN.mean[6];
      HP0AN = HP1AN = HP2AN = 0;
    }

    if (ACNF > 0 || ACNR > 0 || ACTF > 0 || ACTR > 0) {
      bool ans;
      int64_t slen;
      std::string motif;
      find_tandems_full(j.pathseq, cfg.max_unit_len, cfg.min_report_units,
                        cfg.min_report_len, cfg.dist_from_str, t.start_pos,
                        &ans, &slen, &motif);
      std::string bxs[4];
      if (j.nc == 10 && j.bxtab && j.bxtab->names) {
        const auto& names = *j.bxtab->names;
        const char* rseq = (const char*)w.raw + j.src_off;
        const int64_t rlen2 = j.ref_dist;
        // a failed span lookup aborts this and every later transcript of
        // the path (the reference's swallowed std::out_of_range)
        if (!render_bx(j.bxtab->ref_n, t.ref_pos - 1, t.ref_end_pos - 1,
                       rseq, rlen2, K, names, &bxs[0]) ||
            !render_bx(j.bxtab->ref_t, t.ref_pos - 1, t.ref_end_pos - 1,
                       rseq, rlen2, K, names, &bxs[1]) ||
            !render_bx(j.bxtab->graph_n, t.start_pos - 2, t.end_pos - 1,
                       j.pathseq.data(), (int64_t)j.pathseq.size(), K,
                       names, &bxs[2]) ||
            !render_bx(j.bxtab->graph_t, t.start_pos - 2, t.end_pos - 1,
                       j.pathseq.data(), (int64_t)j.pathseq.size(), K,
                       names, &bxs[3]))
          return true;
      }
      Var v;
      v.win = j.win;
      v.pos = t.pos - 1;
      v.code = t.code;
      v.prev_ref = t.prev_bp_ref;
      v.prev_alt = t.prev_bp_alt;
      v.kmer = (int32_t)K;
      v.cov[0] = (int32_t)RCNF;
      v.cov[1] = (int32_t)RCNR;
      v.cov[2] = (int32_t)RCTF;
      v.cov[3] = (int32_t)RCTR;
      v.cov[4] = (int32_t)ACNF;
      v.cov[5] = (int32_t)ACNR;
      v.cov[6] = (int32_t)ACTF;
      v.cov[7] = (int32_t)ACTR;
      v.ref = t.ref;
      v.alt = t.qry;
      if (j.nc == 10) {
        // rotated into the Variant ctor's (hp1, hp2, hp0) order
        const int64_t hpv[12] = {HP1RN, HP2RN, HP0RN, HP1RT, HP2RT, HP0RT,
                                 HP1AN, HP2AN, HP0AN, HP1AT, HP2AT, HP0AT};
        for (int q = 0; q < 12; ++q) v.hp[q] = (int32_t)hpv[q];
        for (int q = 0; q < 4; ++q) v.bx[q] = bxs[q];
      }
      if (ans) v.str_tag = std::to_string(slen) + motif;
      vars.push_back(std::move(v));
    }
  }
  return true;
}

}  // namespace lsr

// ---------------------------------------------------------------------------
// Shard-runner orchestration: genomic chunking, shared read caches, worker
// threads, and the flat C API.
// ---------------------------------------------------------------------------

namespace lsr {

struct ChromCache {
  std::vector<Rec> recs;       // file order (coordinate-sorted)
  std::vector<int32_t> pos, end;
  int32_t maxspan = 0;

  void build() {
    pos.resize(recs.size());
    end.resize(recs.size());
    maxspan = 0;
    for (size_t i = 0; i < recs.size(); ++i) {
      pos[i] = recs[i].pos;
      end[i] = recs[i].end;
      maxspan = std::max(maxspan, recs[i].end - recs[i].pos);
    }
  }
  // window view with the python _fetch contract: pos <= right,
  // end >= left, file order
  void view(int64_t left, int64_t right, std::vector<const Rec*>& out) const {
    out.clear();
    auto lo = std::lower_bound(pos.begin(), pos.end(),
                               (int32_t)(left - maxspan));
    auto hi = std::upper_bound(pos.begin(), pos.end(), (int32_t)right);
    for (auto it = lo; it < hi; ++it) {
      const size_t i = (size_t)(it - pos.begin());
      if (end[i] >= left) out.push_back(&recs[i]);
    }
  }
};

struct Runner {
  Cfg cfg;
  Out* out;
  const uint8_t* gates;       // [n_windows, n_k] or null
  const uint8_t* exact_maxk;  // [n_windows] or null
  int n_k;
};

}  // namespace lsr

extern "C" {

// icfg layout: min_k max_k min_qual_trim min_qual_call min_map_qual
//   max_avg_cov max_delta_as_xs xa_filter primary_only active_regions
//   min_alt_cnt_tumor low_cov_threshold max_tip_len dfs_limit
//   max_indel_len max_mismatch max_unit_len min_report_units
//   min_report_len dist_from_str
// dcfg layout: min_cov_ratio cov_threshold
void* lsr_run(const char* tumor_path, const char* normal_path,
              int64_t n_windows, const int32_t* refid_t,
              const int32_t* refid_n, const int64_t* win_start,
              const int64_t* win_end, const uint8_t* raw_blob,
              const int64_t* raw_off, const uint8_t* gates,
              const uint8_t* exact_maxk, int n_k, const int64_t* icfg,
              const double* dcfg, const char* readgroups, int n_threads,
              int64_t cache_span, const uint8_t* device_mask) {
  auto* out = new lsr::Out();
  lsr::Cfg cfg;
  cfg.min_k = (int)icfg[0];
  cfg.max_k = (int)icfg[1];
  cfg.min_qual_trim = (int)icfg[2];
  cfg.min_qual_call = (int)icfg[3];
  cfg.min_map_qual = (int)icfg[4];
  cfg.max_avg_cov = (int)icfg[5];
  cfg.max_delta_as_xs = (int)icfg[6];
  cfg.xa_filter = (int)icfg[7];
  cfg.primary_only = (int)icfg[8];
  cfg.active_regions = (int)icfg[9];
  cfg.min_alt_cnt_tumor = (int)icfg[10];
  cfg.low_cov_threshold = (int)icfg[11];
  cfg.max_tip_len = (int)icfg[12];
  cfg.dfs_limit = icfg[13];
  cfg.max_indel_len = (int)icfg[14];
  cfg.max_mismatch = (int)icfg[15];
  cfg.max_unit_len = (int)icfg[16];
  cfg.min_report_units = (int)icfg[17];
  cfg.min_report_len = (int)icfg[18];
  cfg.dist_from_str = (int)icfg[19];
  cfg.lr_mode = (int)icfg[20];
  cfg.min_cov_ratio = dcfg[0];
  cfg.cov_threshold = dcfg[1];
  if (readgroups && readgroups[0]) {
    std::string s(readgroups), tok;
    for (char c : s) {
      if (c == '\n') {
        if (!tok.empty()) cfg.readgroups.push_back(tok);
        tok.clear();
      } else {
        tok += c;
      }
    }
    if (!tok.empty()) cfg.readgroups.push_back(tok);
  }

  BamFile tumor, normal;
  if (!tumor.open(tumor_path) || !normal.open(normal_path)) {
    tumor.bgzf.close();
    normal.bgzf.close();
    out->status = 1;
    return out;
  }

  // copy window descriptors (the raw blob is copied so Python may free it)
  const int64_t raw_total = raw_off[n_windows];
  auto raw_copy = std::make_shared<std::vector<uint8_t>>(
      raw_blob, raw_blob + raw_total);
  out->wins.resize(n_windows);
  out->res.resize(n_windows);
  for (int64_t i = 0; i < n_windows; ++i) {
    auto& w = out->wins[i];
    w.refid_t = refid_t[i];
    w.refid_n = refid_n[i];
    w.start = win_start[i];
    w.end = win_end[i];
    w.raw = raw_copy->data() + raw_off[i];
    w.rawlen = raw_off[i + 1] - raw_off[i];
  }
  out->raw_keeper = raw_copy;  // keep the blob alive with the handle

  // genomic chunking over (refid_t, start)
  std::vector<int64_t> order(n_windows);
  for (int64_t i = 0; i < n_windows; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (out->wins[a].refid_t != out->wins[b].refid_t)
      return out->wins[a].refid_t < out->wins[b].refid_t;
    return out->wins[a].start < out->wins[b].start;
  });
  if (cache_span <= 0) cache_span = 8 << 20;
  if (n_threads < 1) n_threads = 1;

  int64_t c0 = 0;
  while (c0 < n_windows) {
    const int32_t rid = out->wins[order[c0]].refid_t;
    const int32_t rid_n = out->wins[order[c0]].refid_n;
    int64_t lo = out->wins[order[c0]].start;
    int64_t hi = out->wins[order[c0]].end;
    int64_t c1 = c0 + 1;
    while (c1 < n_windows && out->wins[order[c1]].refid_t == rid &&
           out->wins[order[c1]].end - lo <= cache_span) {
      hi = std::max(hi, out->wins[order[c1]].end);
      ++c1;
    }
    // load both caches (two reader threads)
    lsr::ChromCache tc, nc;
    {
      lsr::StageTimer st(lsr::stage_ns().fetch);
      std::thread t1([&] {
        if (rid >= 0) lsr::fetch_recs(tumor, rid, lo, hi, tc.recs);
        tc.build();
      });
      std::thread t2([&] {
        if (rid_n >= 0) lsr::fetch_recs(normal, rid_n, lo, hi, nc.recs);
        nc.build();
      });
      t1.join();
      t2.join();
    }
    // process the chunk's windows with a worker pool
    std::atomic<int64_t> next(c0);
    auto worker = [&] {
      std::vector<const lsr::Rec*> tv, nv;
      while (true) {
        const int64_t slot = next.fetch_add(1);
        if (slot >= c1) break;
        const int64_t wi = order[slot];
        const auto& w = out->wins[wi];
        auto t0 = std::chrono::steady_clock::now();
        tc.view(w.start, w.end, tv);
        nc.view(w.start, w.end, nv);
        lsr::process_window(
            w, cfg, tv, nv, gates ? gates + wi * n_k : nullptr,
            exact_maxk ? exact_maxk[wi] : 0, n_k, (int)wi, out->res[wi],
            device_mask && device_mask[wi]);
        out->res[wi].ms =
            std::chrono::duration<double, std::milli>(
                std::chrono::steady_clock::now() - t0)
                .count();
      }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    c0 = c1;
  }
  tumor.bgzf.close();
  normal.bgzf.close();

  // flat job list in (window, emission) order
  for (int64_t i = 0; i < n_windows; ++i)
    for (auto& j : out->res[i].jobs) out->jobs.push_back(&j);

  // store cfg for the finish stage
  out->cfg = cfg;
  return out;
}

int lsr_status(void* h) { return ((lsr::Out*)h)->status; }

long lsr_n_jobs(void* h) { return (long)((lsr::Out*)h)->jobs.size(); }

// 6 int64 per job: win, src_off, ref_dist, path_len, needs_dp, K
void lsr_job_meta(void* h, int64_t* outp) {
  auto* o = (lsr::Out*)h;
  for (size_t i = 0; i < o->jobs.size(); ++i) {
    const lsr::SJob* j = o->jobs[i];
    outp[i * 6 + 0] = j->win;
    outp[i * 6 + 1] = j->src_off;
    outp[i * 6 + 2] = j->ref_dist;
    outp[i * 6 + 3] = (int64_t)j->pathseq.size();
    outp[i * 6 + 4] = j->needs_dp;
    outp[i * 6 + 5] = j->K;
  }
}

const char* lsr_job_path(void* h, long i) {
  return ((lsr::Out*)h)->jobs[i]->pathseq.c_str();
}

// per window: flags (bit0 fallback), reads, ms, and 9 counters
// (num_skip + 7 region classes + windows_done)
void lsr_win_out(void* h, uint8_t* flags, int64_t* reads, double* ms,
                 int64_t* cls) {
  auto* o = (lsr::Out*)h;
  for (size_t i = 0; i < o->res.size(); ++i) {
    const auto& r = o->res[i];
    flags[i] = r.fallback ? 1 : 0;
    reads[i] = r.reads;
    ms[i] = r.ms;
    cls[i * 9 + 0] = r.num_skip;
    for (int c = 0; c < 7; ++c) cls[i * 9 + 1 + c] = r.cls[c];
    cls[i * 9 + 8] = r.windows_done;
  }
}

// Finish: aligned strings for the DP jobs (in job order, dp-subset order),
// non-DP jobs use their own (refseq, pathseq). Builds the packed varbuf.
void lsr_finish(void* h, const uint8_t* ra_blob, const int64_t* ra_off,
                const uint8_t* pa_blob, const int64_t* pa_off) {
  auto* o = (lsr::Out*)h;
  o->vars.clear();
  int64_t dp = 0;
  for (const lsr::SJob* j : o->jobs) {
    if (o->res[j->win].fallback) continue;  // replayed in python
    std::string ra, pa;
    if (j->needs_dp) {
      ra.assign((const char*)ra_blob + ra_off[dp],
                (size_t)(ra_off[dp + 1] - ra_off[dp]));
      pa.assign((const char*)pa_blob + pa_off[dp],
                (size_t)(pa_off[dp + 1] - pa_off[dp]));
      ++dp;
    } else {
      const auto& w = o->wins[j->win];
      ra.assign((const char*)w.raw + j->src_off, (size_t)j->ref_dist);
      pa = j->pathseq;
    }
    {
      lsr::StageTimer st(lsr::stage_ns().scan);
      lsr::scan_job(*j, o->wins[j->win], ra, pa, o->cfg, o->vars);
    }
  }
  lsr::pack_vars(o->vars, o->varbuf);
}

long lsr_n_vars(void* h) { return (long)((lsr::Out*)h)->vars.size(); }
long lsr_varbuf_size(void* h) { return (long)((lsr::Out*)h)->varbuf.size(); }
const uint8_t* lsr_varbuf(void* h) { return ((lsr::Out*)h)->varbuf.data(); }

// device-mode export accessors: per-window (exported, n_bytes, totalreadbp)
void lsr_x_info(void* h, uint8_t* exported, int64_t* nbytes, int64_t* bp) {
  auto* o = (lsr::Out*)h;
  for (size_t i = 0; i < o->res.size(); ++i) {
    exported[i] = o->res[i].exported;
    nbytes[i] = (int64_t)o->res[i].xbuf.size();
    bp[i] = o->res[i].xbp;
  }
}

const uint8_t* lsr_x_data(void* h, long i) {
  return ((lsr::Out*)h)->res[i].xbuf.data();
}

// coarse stage nanoseconds: fetch, triage, extract, kloop, scan (summed
// across worker threads — see StageNs)
void lsr_stage_reset() { lsr::stage_ns().reset(); }

void lsr_stage_ns(int64_t* out16) {
  auto& s = lsr::stage_ns();
  out16[0] = s.fetch.load();
  out16[1] = s.triage.load();
  out16[2] = s.extract.load();
  out16[3] = s.kloop.load();
  out16[4] = s.scan.load();
  out16[5] = s.build.load();
  out16[6] = s.refcov.load();
  out16[7] = s.mat.load();
  out16[8] = s.stages.load();
  out16[9] = s.eka.load();
  out16[10] = s.comps.load();
  out16[11] = s.refends.load();
  out16[12] = s.cyc.load();
  out16[13] = s.compress.load();
  out16[14] = s.cleanup.load();
  out16[15] = s.findrep.load();
}

void lsr_free(void* h) { delete (lsr::Out*)h; }

// ---------------------------------------------------------------------------
// Standalone batch transcript finisher for device-engine jobs: replays
// scan_job over (pathseq, aligned strings, coverage rows, span) coming
// from the device pipeline (devicepipe), producing the same packed varbuf
// as lsr_finish. meta stride 8 per job:
// [K, trim5, refstart, src_off(unused), ref_dist(unused), rawlen,
//  win_id, refcov_off(elements)].
// ---------------------------------------------------------------------------

struct LsxOut {
  std::vector<lsr::Var> vars;
  std::vector<uint8_t> varbuf;
};

void* lsx_scan_batch(
    int64_t n_jobs, const int64_t* meta,
    const uint8_t* path_blob, const int64_t* path_off,
    const uint8_t* ra_blob, const int64_t* ra_off,
    const uint8_t* pa_blob, const int64_t* pa_off,
    const int32_t* covT_blob, const int32_t* covN_blob,
    const int64_t* cov_off,  // element offsets (4 per base)
    const uint8_t* span_blob, const int64_t* span_off,
    const int32_t* refcov_blob, const int64_t* icfg4) {
  auto* o = new LsxOut();
  lsr::Cfg cfg{};
  cfg.max_unit_len = (int)icfg4[0];
  cfg.min_report_units = (int)icfg4[1];
  cfg.min_report_len = (int)icfg4[2];
  cfg.dist_from_str = (int)icfg4[3];
  std::unordered_map<int64_t, std::shared_ptr<std::vector<int32_t>>> rcs;
  for (int64_t i = 0; i < n_jobs; ++i) {
    const int64_t* m = meta + i * 8;
    lsr::SJob j;
    j.win = (int32_t)m[6];
    j.K = (int32_t)m[0];
    j.trim5 = (int32_t)m[1];
    j.pathseq.assign((const char*)path_blob + path_off[i],
                     (size_t)(path_off[i + 1] - path_off[i]));
    const int64_t ce = cov_off[i + 1] - cov_off[i];
    j.covT.assign(covT_blob + cov_off[i], covT_blob + cov_off[i] + ce);
    j.covN.assign(covN_blob + cov_off[i], covN_blob + cov_off[i] + ce);
    j.span.assign(span_blob + span_off[i], span_blob + span_off[i + 1]);
    const int64_t rawlen = m[5];
    const int64_t rco = m[7];
    auto it = rcs.find(rco);
    if (it == rcs.end()) {
      it = rcs.emplace(rco, std::make_shared<std::vector<int32_t>>(
                                refcov_blob + rco,
                                refcov_blob + rco + 4 * rawlen)).first;
    }
    j.refcov = it->second;
    lsr::WinInfo w;
    w.start = m[2];
    w.rawlen = rawlen;
    std::string ra((const char*)ra_blob + ra_off[i],
                   (size_t)(ra_off[i + 1] - ra_off[i]));
    std::string pa((const char*)pa_blob + pa_off[i],
                   (size_t)(pa_off[i + 1] - pa_off[i]));
    lsr::scan_job(j, w, ra, pa, cfg, o->vars);
  }
  lsr::pack_vars(o->vars, o->varbuf);
  return o;
}

long lsx_varbuf_size(void* h) { return (long)((LsxOut*)h)->varbuf.size(); }
const uint8_t* lsx_varbuf(void* h) { return ((LsxOut*)h)->varbuf.data(); }
void lsx_free(void* h) { delete (LsxOut*)h; }

}  // extern "C"

// ===========================================================================
// libstdc++ map-order ranks (lmo_*).
//
// The reference's node table is std::unordered_map<string, Node_t*>
// (ref: src/Graph.hh:68) and is iterated during cleanup/compression, so
// unitig-survivor choice and component numbering depend on libstdc++'s
// iteration order. The device graph engine produces node tables in
// creation order; this kernel replays the map order by inserting the mer
// strings into a real std::unordered_map on this toolchain — bit-exact by
// construction — and reports each key's iteration rank plus the remaining
// insert headroom before the next rehash (the fake source/sink inserts of
// Graph.cc:2156-2227 only perturb iteration order via a rehash, so windows
// without headroom fall back to the native engine).
//
// Mers arrive packed 2 bits/base MSB-first as (hi, lo) uint64 words
// (k <= 63 fits lo alone; k <= 101 spills into hi), one flat array for the
// whole window batch with per-window offsets — no Python string
// materialization anywhere.
// ===========================================================================

extern "C" {

void lmo_ranks_batch(int64_t n_windows, const int64_t* offs,
                     const uint64_t* hi, const uint64_t* lo, int32_t k,
                     int32_t* ranks_out, int64_t* slack_out) {
  static const char kBase[4] = {'A', 'C', 'G', 'T'};
  for (int64_t w = 0; w < n_windows; ++w) {
    const int64_t b = offs[w], e = offs[w + 1];
    const int64_t n = e - b;
    if (n <= 0) {
      slack_out[w] = int64_t(1) << 30;
      continue;
    }
    std::unordered_map<std::string, int64_t> m;
    m.max_load_factor(1.0f);
    std::string s((size_t)k, 'A');
    for (int64_t i = b; i < e; ++i) {
      // base j sits at bit position 2*(k-1-j) of the 128-bit value hi:lo
      for (int j = 0; j < k; ++j) {
        const int bit = 2 * (k - 1 - j);
        const uint64_t word = bit >= 64 ? hi[i] : lo[i];
        const int sh = bit >= 64 ? bit - 64 : bit;
        s[(size_t)j] = kBase[(word >> sh) & 3];
      }
      m.emplace(s, i - b);
    }
    std::vector<int32_t> rank_of((size_t)n, 0);
    int32_t r = 0;
    for (const auto& kv : m) rank_of[(size_t)kv.second] = r++;
    for (int64_t i = b; i < e; ++i) ranks_out[i] = rank_of[(size_t)(i - b)];
    slack_out[w] =
        (int64_t)((double)m.bucket_count() * (double)m.max_load_factor()) -
        (int64_t)m.size();
  }
}

}  // extern "C"

// Native FastQ input pipeline: streaming multi-file plain/gzip reader with
// record parsing, quality trimming, k-mer sieving, base encoding and live
// statistics -- optionally fanned out over worker threads.
//
// Equivalent of the reference scan engine's host half
// (csrc/workhorse.c:482-956 gz/file streaming, :1010-1103 record
// parse/trim, :1375-1408 pthread fan-out over a mutex-shared stream in
// /root/reference): instead of feeding a pthread scan loop, workers fill
// fixed-shape batch buffers (raw bytes, base codes, trimmed lengths,
// global file offsets) that the Python layer ships to the device
// matchers.  Semantics -- error messages, first-longest quality run,
// trailing-partial-record handling, multi-stream gzip, decompressed size
// estimation -- replicate kvarq_tpu/engine/reader.py exactly (which in
// turn replicates workhorse.c); tests assert byte-equality of the two
// pipelines.  Unlike the reference (unordered hit list), batches are
// emitted in record order regardless of thread count, so results are
// deterministic.
//
// Exposed via a plain C ABI for ctypes (no Python C-API dependency).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>
#if defined(__linux__) || defined(__APPLE__)
#include <sys/mman.h>
#define KVARQ_HAVE_MMAP 1
#endif

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#ifdef KVARQ_NO_ZLIB
// zero-dependency build: the self-contained streaming inflate replaces
// the zlib subset used below (the reference achieved this by vendoring
// miniz, reference csrc/gz/miniz.c; kvq_inflate.h is an original
// implementation written for this fallback)
#include "kvq_inflate.h"
#else
#include <zlib.h>
#endif
#ifdef KVARQ_USE_LIBDEFLATE
#include <libdeflate.h>   // ~3x zlib inflate; whole-member API only
#endif
// fast whole-input DEFLATE decoder for mmap'd single-member gz (the
// serial-inflate bottleneck): ~2x zlib streaming; self-contained, used
// by the ring producer whenever the compressed file could be mapped
#include "kvq_fast_inflate.h"

namespace {

constexpr int MAX_READLENGTH = 1024;   // histogram cap (workhorse.c:105)
constexpr size_t CHUNKSIZE = 8u * 1024 * 1024;
constexpr size_t WORKCHUNK = 1u * 1024 * 1024;  // per work-item span
constexpr uint8_t CODE_READ_JUNK = 5;  // kvarq_tpu/engine/encode.py
// default records per kvq_next call: bounds live-stats/stop() latency.
// Large values give fewer, fuller candidate batches; smaller ones give
// finer-grained reader/device overlap (kvq_open arg / $KVARQ_PARSE_CAP).
// Not measured on the GPU host yet.
constexpr int64_t DEFAULT_PARSE_CAP = 4 * 262144;

// $KVARQ_PROF=1: aggregate per-phase cycle counters (printed to stderr
// at kvq_close) -- development aid for placing optimization effort;
// zero overhead when off (single branch per phase)
inline bool prof_enabled() {
    static const bool on = [] {
        const char* e = std::getenv("KVARQ_PROF");
        return e && e[0] && e[0] != '0';
    }();
    return on;
}

inline uint64_t prof_now() {
#if defined(__x86_64__)
    unsigned lo, hi;
    __asm__ __volatile__("rdtsc" : "=a"(lo), "=d"(hi));
    return ((uint64_t)hi << 32) | lo;
#else
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (uint64_t)ts.tv_sec * 1000000000ull + ts.tv_nsec;
#endif
}

struct Stream {
    std::string fname;
    FILE* f = nullptr;
    bool is_gz = false;
    z_stream zs;
    bool z_init = false;
    bool z_done = false;        // current inflate stream finished
    std::vector<uint8_t> zin;   // compressed input buffer
    size_t zin_pos = 0, zin_len = 0;
    int64_t fsize = 0;          // on-disk size
    // written by the decode thread, read by the consumer's progress
    // estimate: access only through the __atomic builtins (relaxed --
    // it feeds a monotone size estimate, no ordering required).  A
    // std::atomic member would delete Stream's move constructor, which
    // the streams vector needs.
    int64_t compressed_read = 0;
    int64_t produced = 0;       // decompressed bytes yielded
    // background whole-file libdeflate decode (small gz files): once
    // ready, decompressed bytes are served from `bg->dec` instead of
    // streaming through zlib
    struct BgDecode* bg = nullptr;
    bool bg_serving = false;
    int64_t known_total = -1;   // exact decompressed size once known
    // big-file pipelined decode paths (see open_stream)
    struct RingDecode* ring = nullptr;    // dedicated zlib decode thread
    struct BgzfDecode* bgzf = nullptr;    // parallel per-block libdeflate
    // plain regular files are mmap'd: workers take zero-copy spans
    // straight from the mapping (no fill_buf syscall+copy under the
    // shared lock -- the serialized fraction that capped thread fan-out).
    // Unmapped only in kvq_close, after workers have joined, since
    // in-flight WorkItems reference the mapping.
    const uint8_t* map = nullptr;
    size_t map_size = 0;
    size_t map_advised = 0;      // readahead high-water (madvise WILLNEED)
};

// background decode of a whole (small) gz file with libdeflate (~3x
// zlib): runs concurrently with the zlib streaming path, which serves
// reads until the decode is ready; `state` 1=running 2=ready 3=unusable.
// The thread opens the file independently and shares nothing with the
// consumer but this struct.
struct BgDecode {
    std::thread thr;
    std::atomic<int> state{1};
    std::vector<uint8_t> dec;
};

// pipelined streaming decode for big plain-gzip files: a dedicated thread
// runs the zlib inflate loop (multi-stream restart, trailing-garbage
// semantics identical to the inline path) into a bounded chunk queue, so
// decompression overlaps with record parsing/sieving instead of running
// under the shared stream mutex.  Memory stays flat (MAX_BYTES window).
struct RingDecode {
    std::thread thr;
    std::mutex m;
    std::condition_variable cv_data, cv_space;
    std::deque<std::vector<uint8_t>> q;
    size_t qbytes = 0;
    size_t front_off = 0;        // consumed bytes of q.front()
    bool done = false;
    bool failed = false;
    bool abandon = false;
    std::string error;
    static constexpr size_t MAX_BYTES = 32u << 20;
};

// BGZF (bgzip) files -- the block-compressed gzip dialect ubiquitous in
// bioinformatics -- are a sequence of independent <=64 KB gzip members
// whose compressed size is recorded in a BC extra subfield, so blocks
// can be enumerated by seeking (no inflate) and decompressed in PARALLEL
// with libdeflate across worker threads.  Delivery is in file order with
// a bounded in-flight window; the exact decompressed size (sum of block
// ISIZEs) is known at open time, making progress reporting exact.
struct BgzfBlock { int64_t coff; int32_t csize; int32_t isize; };
struct BgzfDecode {
    std::vector<BgzfBlock> blocks;
    std::vector<std::thread> thrs;
    std::atomic<size_t> next{0};
    std::mutex m;
    std::condition_variable cv_data, cv_space;
    std::map<size_t, std::vector<uint8_t>> ready;
    std::set<size_t> bad;        // blocks whose decode failed
    size_t consume = 0;          // next block index the consumer needs
    size_t front_off = 0;        // consumed bytes of ready[consume]
    bool abandon = false;
    std::string error;           // guarded by m
    std::string fname;
    int fd = -1;
    static constexpr size_t WINDOW = 64;   // blocks in flight (<= 4 MB)
};

// parse one BGZF member header at `off` (via pread) and extract the
// total block size from the BC extra subfield; returns false when the
// bytes there are not a BGZF block
// parse one BGZF member header + ISIZE tail from memory; `b` points at
// the block start and must hold the whole member (csize <= 64 KiB + 1)
bool bgzf_block_mem(const uint8_t* b, int64_t avail, int32_t* csize,
                    int32_t* isize) {
    if (avail < 28) return false;         // minimal BGZF block is 28 bytes
    if (b[0] != 0x1f || b[1] != 0x8b || b[2] != 8) return false;
    if (!(b[3] & 4)) return false;        // FEXTRA required
    int xlen = b[10] | (b[11] << 8);
    if (xlen < 6 || xlen > 4096 || 12 + xlen > avail) return false;
    const uint8_t* extra = b + 12;
    int bsize = -1;
    for (int p = 0; p + 4 <= xlen; ) {
        int slen = extra[p + 2] | (extra[p + 3] << 8);
        if (extra[p] == 'B' && extra[p + 1] == 'C' && slen == 2
            && p + 6 <= xlen) {
            bsize = extra[p + 4] | (extra[p + 5] << 8);
            break;
        }
        p += 4 + slen;
    }
    if (bsize < 0) return false;
    *csize = bsize + 1;
    if (*csize > avail || *csize < 28) return false;
    const uint8_t* tail = b + *csize - 4;
    uint32_t is = (uint32_t)tail[0] | ((uint32_t)tail[1] << 8)
                | ((uint32_t)tail[2] << 16) | ((uint32_t)tail[3] << 24);
    if (is > 65536) return false;         // BGZF spec bound
    *isize = (int32_t)is;
    return true;
}

// enumerate every block of a candidate BGZF file; returns false (leaving
// `blocks` unusable) unless the WHOLE file parses as BGZF members, so a
// failed probe cleanly falls back to the generic zlib paths
bool bgzf_probe(const std::string& fname, int64_t fsize,
                std::vector<BgzfBlock>* blocks, int64_t* total) {
    int fd = ::open(fname.c_str(), O_RDONLY);
    if (fd < 0) return false;
    // one buffered sequential pass: a 10 GB BGZF file has ~160k blocks,
    // and 3 pread syscalls per block at open time added seconds of dead
    // time before the first byte was served
    constexpr size_t BUFSZ = 4 << 20;     // >> max member size (64 KiB)
    std::vector<uint8_t> buf(BUFSZ);
    int64_t bstart = 0;
    int64_t blen = 0;
    int64_t off = 0;
    *total = 0;
    bool ok = true;
    while (off < fsize) {
        int64_t need = fsize - off;   // whole next member, or what's left
        if (need > 65537) need = 65537;
        if (off + need > bstart + blen) {
            bstart = off;
            int64_t want = fsize - off;
            if (want > (int64_t)BUFSZ) want = BUFSZ;
            blen = pread(fd, buf.data(), (size_t)want, off);
            if (blen < want) { ok = false; break; }
        }
        int32_t csize = 0, isize = 0;
        int64_t avail = bstart + blen - off;
        if (avail > 65537) avail = 65537;
        if (!bgzf_block_mem(buf.data() + (off - bstart), avail,
                            &csize, &isize)) {
            ok = false;
            break;
        }
        blocks->push_back(BgzfBlock{off, csize, isize});
        *total += isize;
        off += csize;
    }
    ::close(fd);
    if (!ok || blocks->empty()) {
        blocks->clear();
        return false;
    }
    return true;
}

#ifdef KVARQ_USE_LIBDEFLATE
// BGZF decode worker: claim block indices, pread + libdeflate-decompress
// each member, publish in the ordered map (bounded in-flight window)
void bgzf_worker_main(BgzfDecode* bz) {
    libdeflate_decompressor* d = libdeflate_alloc_decompressor();
    if (!d) return;
    for (;;) {
        size_t i = bz->next.fetch_add(1);
        if (i >= bz->blocks.size()) break;
        {   // bound how far workers run ahead of the consumer
            std::unique_lock<std::mutex> l(bz->m);
            bz->cv_space.wait(l, [&] {
                return bz->abandon || i < bz->consume + BgzfDecode::WINDOW;
            });
            if (bz->abandon) break;
        }
        const BgzfBlock& blk = bz->blocks[i];
        std::vector<uint8_t> cbuf((size_t)blk.csize);
        std::vector<uint8_t> dec((size_t)blk.isize);
        bool ok = pread(bz->fd, cbuf.data(), cbuf.size(), blk.coff)
                  == (ssize_t)cbuf.size();
        if (ok && blk.isize > 0) {
            size_t out = 0;
            ok = libdeflate_gzip_decompress(
                     d, cbuf.data(), cbuf.size(), dec.data(), dec.size(),
                     &out) == LIBDEFLATE_SUCCESS
                 && out == (size_t)blk.isize;
        }
        {
            std::lock_guard<std::mutex> l(bz->m);
            if (!ok) {
                bz->bad.insert(i);
                if (bz->error.empty()) {
                    char msg[160];
                    std::snprintf(msg, sizeof(msg),
                                  "error inflating '%s': bad bgzf block "
                                  "at offset %lld", bz->fname.c_str(),
                                  (long long)blk.coff);
                    bz->error = msg;
                }
            }
            bz->ready[i] = std::move(dec);
        }
        bz->cv_data.notify_all();
    }
    libdeflate_free_decompressor(d);
}
#endif

// one record-aligned span of decompressed data plus its processed outputs
struct CandRec { int32_t rl; int64_t filepos; size_t raw_off; };
struct WorkItem {
    uint64_t seq = 0;
    std::vector<uint8_t> data;  // complete records only
    // zero-copy span variant: the item borrows [ext, ext+ext_len) from a
    // Stream's mmap'd file instead of owning a copy in `data`; valid
    // until kvq_close unmaps (workers are joined before that)
    const uint8_t* ext = nullptr;
    size_t ext_len = 0;
    std::vector<int32_t> nl;    // newline positions within data (the
                                // splitter's scan, reused by the parse)
    int64_t offset = 0;         // global decompressed offset of data[0]
    std::vector<CandRec> cands;
    std::vector<uint8_t> raws;  // concatenated trimmed candidate bytes
    int64_t rls[MAX_READLENGTH] = {};
    int64_t rls_longest = -1;
    int64_t nrecords = 0;
    bool has_error = false;
    std::string error;
};

struct Reader {
    std::vector<Stream> streams;
    size_t cur_stream = 0;
    int amin = 0;
    int minreadlength = 0;

    std::vector<uint8_t> buf;   // leftover + fresh chunk
    size_t buf_pos = 0;         // parse cursor within buf
    int64_t buf_offset = 0;     // global decompressed offset of buf[0]
    bool at_eof = false;

    // live stats (polled cross-thread; plain stores are fine)
    volatile int64_t records_parsed = 0;
    volatile int64_t parsed = 0;
    volatile int64_t total = 0;
    int64_t rls[MAX_READLENGTH] = {};
    volatile int64_t rls_longest = -1;
    std::vector<int64_t> est;   // per-file size estimate
    // read length that did not fit the caller's row stride; kvq_next
    // returned -2 and resumes once the caller re-calls with bigger rows
    int pending_rl = 0;

    std::string error;
    uint8_t code_of[256];

    // optional exact k-mer seed-and-verify sieve
    // (kvarq_tpu/engine/sieve.py, the numpy oracle this must match
    // read-for-read): three-stage cascade -- presence bit, >= t seeds on
    // one (diagonal, template), exact overlap mismatch count <= e.  The
    // index arrays are owned by the Python side for the handle's
    // lifetime; `present` (packed presence bit per kcode, cache-resident
    // fast path) is built here.
    const int32_t* sieve_start = nullptr;
    const int32_t* sieve_gpos = nullptr;
    const int32_t* sieve_gtid = nullptr;
    const int32_t* sieve_tstart = nullptr;
    const int32_t* sieve_tstop = nullptr;
    const uint8_t* sieve_bank = nullptr;
    std::vector<uint64_t> sieve_present;
    // L1-resident fast path: presence bits keyed by the 2-bit (ACGT)
    // window code for k <= 16.  A window without N can only match a
    // bank k-mer without N, so the 2-bit map is exact for such windows;
    // windows containing N (rare) take the base-5 slow path.
    std::vector<uint64_t> sieve_present2;
    int sieve_k = 0;
    int sieve_t = 0;
    int sieve_m = 0;
    int sieve_e = 0;
    int64_t sieve_p5k = 0;   // 5^k
    uint32_t sieve_mask2 = 0;  // (1 << 2k) - 1
    // 2-bit-code -> base-5-code conversion, 4 digits per byte
    int64_t conv5[3][256];
    // secondary index keyed directly by the 2-bit (ACGT) window code for
    // N-free bank k-mers: start2 is 4^k + 1 entries (256 KB at k=8 --
    // L2-resident vs the base-5 start's 1.5 MB), gpos2/gtid2 the
    // re-bucketed seed lists.  A window without N can only match an
    // N-free bank k-mer, so probing this index is exact for such windows
    // and skips both the base-5 conversion and the large-table loads
    // that otherwise dominate sieve time (~10 presence probes per read).
    std::vector<int32_t> sieve_start2;
    // (gpos, gtid) interleaved -- one cache line per stage-2 entry
    // instead of two parallel-array loads.  seed2 is indexed by the
    // 2-bit start2 buckets, seed5 mirrors the caller's gpos/gtid for the
    // base-5 buckets (N windows, k = 12 fallback).
    std::vector<int32_t> sieve_seed2;
    std::vector<int32_t> sieve_seed5;
    bool sieve_has2 = false;

    // dense open-addressed bucket table (k <= 8, small banks): start2 is
    // 256 KB with only ~26 KB of useful entries scattered one per line,
    // so every probe pays a poorly-utilized L2 line (measured: the
    // dominant sieve cost).  Slots are 8 bytes -- {key, count, first
    // seed inline | overflow offset} -- in a table sized to ~0.4 load
    // factor, so a probe is ONE well-utilized L2 line and single-seed
    // buckets (the majority) need no further loads.
    struct HashSlot {
        uint16_t key;
        uint16_t cnt;        // 0 = empty
        uint32_t payload;    // cnt==1: gpos<<16|tid; else seed2 offset
    };
    std::vector<HashSlot> sieve_hash;
    uint32_t sieve_hash_shift = 0;   // hash = (key * MULT) >> shift
    static constexpr uint32_t HASH_MULT = 2654435761u;

    // worker-thread machinery (nthreads > 1): workers pull record-aligned
    // spans from the shared stream under in_mtx (the reference's
    // fastq_read_mutex pattern, workhorse.c:746) and publish processed
    // items; the consumer (kvq_next) drains them in sequence order
    int nthreads = 1;
    int64_t parse_cap = DEFAULT_PARSE_CAP;
    std::vector<std::thread> workers;
    std::mutex in_mtx, out_mtx;
    std::condition_variable out_cv;
    std::map<uint64_t, WorkItem*> completed;
    std::atomic<uint64_t> next_split{0};
    uint64_t next_consume = 0;
    std::atomic<bool> stopping{false};
    std::atomic<bool> split_eof{false};
    std::atomic<bool> split_failed{false};
    std::string split_error;        // guarded by in_mtx
    WorkItem* cur = nullptr;        // partially drained item
    size_t cur_i = 0;

    // $KVARQ_PROF phase cycle counters (see prof_enabled)
    mutable std::atomic<uint64_t> prof_fill{0};    // stream fill/inflate
    mutable std::atomic<uint64_t> prof_split{0};   // record-span splitting
    mutable std::atomic<uint64_t> prof_trim{0};    // parse checks + trim
    mutable std::atomic<uint64_t> prof_sieve{0};   // k-mer sieve
    mutable std::atomic<uint64_t> prof_pack{0};    // batch packing/encode
    mutable std::atomic<uint64_t> prof_item{0};    // process_item total
    mutable std::atomic<uint64_t> prof_inwait{0};  // in_mtx acquisition wait
    mutable std::atomic<uint64_t> prof_outwait{0}; // consumer out_cv wait
};

void update_total(Reader* r) {
    int64_t t = 0;
    for (int64_t e : r->est) t += e;
    r->total = t;
}

#ifdef KVARQ_USE_LIBDEFLATE
void bg_decode_main(BgDecode* bg, std::string fname, int64_t fsize);
static int64_t mem_available_bytes();
#endif

// fast-inflate variant of the ring producer: decodes straight off the
// stream's mmap'd compressed file (kvq_fast_inflate.h, ~2x zlib) with a
// 32 KB window kept contiguous before the chunk area.  Same queue
// protocol, same multi-member / silent-truncation / error-message
// semantics as the zlib loop below.
#ifdef KVARQ_HAVE_MMAP
void ring_fast_main(Stream* s) {
    RingDecode* rd = s->ring;
    kvq_fast::Decoder* d = new kvq_fast::Decoder();
    d->init(s->map, s->map_size);
    constexpr size_t WIN = 1u << 15;
    constexpr size_t CH = 1u << 20;
    std::vector<uint8_t> buf(WIN + CH);
    size_t hist = 0;
    for (;;) {
        long n = kvq_fast::decode_some(d, buf.data() + WIN, CH, hist);
        std::string err;
        bool at_end = false;
        if (n < 0) {
            err = "error inflating '" + s->fname + "': "
                + (d->msg ? d->msg : "data error");
            n = 0;
        } else {
            __atomic_store_n(&s->compressed_read,
                             (int64_t)d->byte_pos(), __ATOMIC_RELAXED);
            if (d->phase == kvq_fast::PH_DONE
                    || d->phase == kvq_fast::PH_TRUNC)
                at_end = true;
            else if (d->phase == kvq_fast::PH_ERR)
                // the error call delivered its valid prefix (n bytes);
                // push those for parsing, then surface the error --
                // exactly like the zlib loop's out.resize(got) + err
                err = "error inflating '" + s->fname + "': "
                    + (d->msg ? d->msg : "data error");
        }
        std::vector<uint8_t> out;
        if (n > 0) {
            out.assign(buf.begin() + WIN, buf.begin() + WIN + n);
            size_t keep = (size_t)n + hist;
            if (keep > WIN) keep = WIN;
            std::memmove(buf.data() + WIN - keep,
                         buf.data() + WIN + (size_t)n - keep, keep);
            hist = keep;
        }
        std::unique_lock<std::mutex> l(rd->m);
        rd->cv_space.wait(l, [&] {
            return rd->abandon || rd->qbytes < RingDecode::MAX_BYTES;
        });
        if (rd->abandon) {
            delete d;
            return;
        }
        if (n > 0) {
            rd->qbytes += out.size();
            rd->q.push_back(std::move(out));
        }
        if (!err.empty()) {
            rd->failed = true;
            rd->error = err;
            rd->done = true;
        } else if (at_end) {
            rd->done = true;
        }
        bool finished = rd->done;
        l.unlock();
        rd->cv_data.notify_all();
        if (finished) {
            delete d;
            return;
        }
    }
}
#endif

// body of the RingDecode producer thread: the same zlib streaming loop
// as the inline path (multi-stream restart, trailing-garbage and error
// semantics identical) pushing 1 MB chunks into the bounded queue.  Owns
// s.f / s.zs / s.zin exclusively once started.
void ring_zlib_main(Stream* s) {
    RingDecode* rd = s->ring;
#ifdef KVARQ_HAVE_MMAP
    if (s->map) {
        const char* ff = std::getenv("KVARQ_FAST_INFLATE");
        if (!(ff && ff[0] == '0')) {
            ring_fast_main(s);
            return;
        }
    }
#endif
    for (;;) {
        std::vector<uint8_t> out(1u << 20);
        size_t got = 0;
        std::string err;
        bool at_end = false;
        while (got < out.size()) {
            if (s->zin_pos == s->zin_len) {
                s->zin_len = std::fread(s->zin.data(), 1, s->zin.size(),
                                        s->f);
                s->zin_pos = 0;
                __atomic_fetch_add(&s->compressed_read,
                                   (int64_t)s->zin_len,
                                   __ATOMIC_RELAXED);
                if (s->zin_len == 0) { at_end = true; break; }
            }
            s->zs.next_in = s->zin.data() + s->zin_pos;
            s->zs.avail_in = (uInt)(s->zin_len - s->zin_pos);
            s->zs.next_out = out.data() + got;
            s->zs.avail_out = (uInt)(out.size() - got);
            int ret = inflate(&s->zs, Z_NO_FLUSH);
            s->zin_pos = s->zin_len - s->zs.avail_in;
            got = out.size() - s->zs.avail_out;
            if (ret == Z_STREAM_END) {
                // multi-stream gz: restart inflate mid-file
                // (workhorse.c:841-866)
                if (inflateReset(&s->zs) != Z_OK) {
                    err = "inflateReset failed in '" + s->fname + "'";
                    break;
                }
                if (s->zin_pos == s->zin_len && std::feof(s->f)) {
                    at_end = true;
                    break;
                }
                continue;
            }
            if (ret != Z_OK && ret != Z_BUF_ERROR) {
                err = "error inflating '" + s->fname + "': " +
                      (s->zs.msg ? s->zs.msg : zError(ret));
                break;
            }
            if (ret == Z_BUF_ERROR && s->zin_pos == s->zin_len &&
                std::feof(s->f)) {
                at_end = true;
                break;
            }
        }
        out.resize(got);
        std::unique_lock<std::mutex> l(rd->m);
        rd->cv_space.wait(l, [&] {
            return rd->abandon || rd->qbytes < RingDecode::MAX_BYTES;
        });
        if (rd->abandon) return;
        if (got) {
            rd->qbytes += out.size();
            rd->q.push_back(std::move(out));
        }
        if (!err.empty()) {
            rd->failed = true;
            rd->error = err;
            rd->done = true;
        } else if (at_end) {
            rd->done = true;
        }
        bool finished = rd->done;
        l.unlock();
        rd->cv_data.notify_all();
        if (finished) return;
    }
}

bool open_stream(Stream& s, std::string* err, int nthreads) {
    s.f = std::fopen(s.fname.c_str(), "rb");
    if (!s.f) {
        *err = "cannot open '" + s.fname + "'";
        return false;
    }
    // non-regular inputs (FIFOs, process substitution) cannot be
    // seeked, sized, re-opened (a second open would steal/consume the
    // writer's stream) or mmap'd -- they take the plain streaming paths
    struct stat st_;
    const bool is_reg = ::fstat(::fileno(s.f), &st_) == 0
                        && S_ISREG(st_.st_mode);
    if (is_reg) {
        std::fseek(s.f, 0, SEEK_END);
        s.fsize = std::ftell(s.f);
        std::fseek(s.f, 0, SEEK_SET);
    } else {
        s.fsize = 0;
    }
    size_t n = s.fname.size();
    s.is_gz = n > 3 && s.fname.compare(n - 3, 3, ".gz") == 0;
#ifdef KVARQ_HAVE_MMAP
    if (s.fsize > 0) {
        // regular files are mmap'd.  Plain FastQ: workers split records
        // straight on the mapping (pull_work), eliminating the
        // read()+copy that used to run under the shared stream mutex
        // (the measured 234 cycles/read serialized fill; see
        // docs/performance.md "reader thread scaling").  Gzip: the ring
        // producer's fast whole-input inflate (kvq_fast_inflate.h)
        // decodes straight off the mapping, ~2x zlib's streaming rate.
        // $KVARQ_MMAP=0 falls back to buffered reads everywhere.
        const char* mm = std::getenv("KVARQ_MMAP");
        struct stat st;
        if (!(mm && mm[0] == '0')
                && ::fstat(::fileno(s.f), &st) == 0 && S_ISREG(st.st_mode)
                && (int64_t)st.st_size == s.fsize) {
            void* p = ::mmap(nullptr, (size_t)s.fsize, PROT_READ,
                             MAP_PRIVATE, ::fileno(s.f), 0);
            if (p != MAP_FAILED) {
                s.map = (const uint8_t*)p;
                s.map_size = (size_t)s.fsize;
#ifdef MADV_SEQUENTIAL
                ::madvise(p, s.map_size, MADV_SEQUENTIAL);
#endif
            }
        }
    }
#endif
    if (s.is_gz) {
        std::memset(&s.zs, 0, sizeof(s.zs));
        // 16+MAX_WBITS: gzip wrapper (header parse incl. extra fields)
        if (inflateInit2(&s.zs, 16 + MAX_WBITS) != Z_OK) {
            *err = "inflateInit failed for '" + s.fname + "'";
            return false;
        }
        s.z_init = true;
        s.zin.resize(1u << 20);
#ifdef KVARQ_USE_LIBDEFLATE
        const char* e = std::getenv("KVARQ_LIBDEFLATE");
        bool ld_ok = !(e && e[0] == '0');
        // the probe RE-OPENS the file, which would steal bytes from a
        // FIFO writer: regular files only (fsize>0 also gates the bg
        // takeover and the mmap fast-inflate below for the same reason)
        if (ld_ok && is_reg) {
            // BGZF fast path: any size, parallel per-block decode, exact
            // decompressed size known before the first byte is served
            std::vector<BgzfBlock> blocks;
            int64_t total = 0;
            if (bgzf_probe(s.fname, s.fsize, &blocks, &total)) {
                int fd = ::open(s.fname.c_str(), O_RDONLY);
                if (fd >= 0) {
                    s.bgzf = new BgzfDecode();
                    s.bgzf->blocks = std::move(blocks);
                    s.bgzf->fname = s.fname;
                    s.bgzf->fd = fd;
                    s.known_total = total;
                    int nthr = nthreads < 1 ? 1 : nthreads;
                    if (nthr > 8) nthr = 8;
                    const char* bt = std::getenv("KVARQ_BGZF_THREADS");
                    if (bt && bt[0]) nthr = std::atoi(bt);
                    // at least one worker or bgzf_read waits forever on
                    // a block nobody will publish; cap the fan-out too
                    if (nthr < 1) nthr = 1;
                    if (nthr > 64) nthr = 64;
                    for (int i = 0; i < nthr; i++)
                        s.bgzf->thrs.emplace_back(bgzf_worker_main, s.bgzf);
                    return true;
                }
            }
        }
        // whole-file background decode for RAM-fitting plain-gz files
        // (libdeflate, ~3x zlib); the streaming ring serves bytes until
        // the decode is ready, so there is no startup stall.  The
        // decode is DUPLICATED work while both run, so the big-file
        // takeover only pays when a core is free to absorb it: on a
        // 2-core host it loses the race against the pipelined ring and
        // slows everything down (measured 5.7 s -> 12 s on a 1.7 GB
        // corpus), while with spare cores it converts the post-decode
        // remainder to full-speed in-memory parsing.  Small files
        // (<= 64 MB) keep the takeover unconditionally: the decode wins
        // long before the ring warms up.  RAM gate: compressed +
        // 3-5x decompressed must fit comfortably (MemAvailable / 12).
        int64_t bgcap = (int64_t)64 * 1024 * 1024;
        const unsigned hw = std::thread::hardware_concurrency();
        if (hw >= (unsigned)nthreads + 2) {
            int64_t mem = mem_available_bytes();
            if (mem > 0 && mem / 12 > bgcap) bgcap = mem / 12;
        }
        const char* bc = std::getenv("KVARQ_GZ_BGCAP");
        if (bc && bc[0]) bgcap = std::atoll(bc);
        // when the ring's fast inflate will run (mapped file), the
        // whole-file takeover is pure duplicated decode at comparable
        // speed -- skip it
        const char* ff2 = std::getenv("KVARQ_FAST_INFLATE");
        bool fast_ring = s.map && !(ff2 && ff2[0] == '0');
        if (ld_ok && !fast_ring && s.fsize > 0 && s.fsize <= bgcap) {
            s.bg = new BgDecode();
            s.bg->thr = std::thread(bg_decode_main, s.bg, s.fname, s.fsize);
        }
#else
        (void)nthreads;
#endif
        // generic gzip: pipelined streaming decode on a dedicated thread
        // (bounded queue, flat memory, any file size) -- replaces the old
        // inline inflate that ran under the shared stream mutex
        s.ring = new RingDecode();
        s.ring->thr = std::thread(ring_zlib_main, &s);
    }
    return true;
}

void abandon_ring(Stream& s) {
    if (!s.ring) return;
    {
        std::lock_guard<std::mutex> l(s.ring->m);
        s.ring->abandon = true;
    }
    s.ring->cv_space.notify_all();
    s.ring->cv_data.notify_all();
    if (s.ring->thr.joinable()) s.ring->thr.join();
    delete s.ring;
    s.ring = nullptr;
}

void close_stream(Stream& s) {
    abandon_ring(s);
    if (s.bgzf) {
        {
            std::lock_guard<std::mutex> l(s.bgzf->m);
            s.bgzf->abandon = true;
        }
        s.bgzf->cv_space.notify_all();
        s.bgzf->cv_data.notify_all();
        for (auto& t : s.bgzf->thrs)
            if (t.joinable()) t.join();
        if (s.bgzf->fd >= 0) ::close(s.bgzf->fd);
        delete s.bgzf;
        s.bgzf = nullptr;
    }
    if (s.bg) {
        if (s.bg->thr.joinable()) s.bg->thr.join();
        delete s.bg;
        s.bg = nullptr;
        s.bg_serving = false;
    }
    if (s.z_init) { inflateEnd(&s.zs); s.z_init = false; }
    if (s.f) { std::fclose(s.f); s.f = nullptr; }
}

// consume from the RingDecode chunk queue; blocks for data, serves any
// buffered bytes before surfacing a decode error (the error then returns
// -1 on the next call, with the exact inline-path message)
long ring_read(Stream& s, uint8_t* out, size_t want, std::string* err) {
    RingDecode* rd = s.ring;
    size_t got = 0;
    std::unique_lock<std::mutex> l(rd->m);
    while (got < want) {
        if (!rd->q.empty()) {
            std::vector<uint8_t>& front = rd->q.front();
            size_t n = front.size() - rd->front_off;
            if (n > want - got) n = want - got;
            std::memcpy(out + got, front.data() + rd->front_off, n);
            got += n;
            rd->front_off += n;
            if (rd->front_off == front.size()) {
                rd->qbytes -= front.size();
                rd->q.pop_front();
                rd->front_off = 0;
                rd->cv_space.notify_all();
            }
            continue;
        }
        if (rd->done) break;
        rd->cv_data.wait(l);
    }
    if (got == 0 && rd->failed) {
        *err = rd->error;
        return -1;
    }
    s.produced += (int64_t)got;
    return (long)got;
}

#ifdef KVARQ_USE_LIBDEFLATE
// consume BGZF blocks in file order from the parallel decode pool
long bgzf_read(Stream& s, uint8_t* out, size_t want, std::string* err) {
    BgzfDecode* bz = s.bgzf;
    size_t got = 0;
    std::unique_lock<std::mutex> l(bz->m);
    while (got < want && bz->consume < bz->blocks.size()) {
        auto f = bz->ready.find(bz->consume);
        if (f == bz->ready.end()) {
            bz->cv_data.wait(l);
            continue;
        }
        if (bz->bad.count(bz->consume)) {
            if (got) break;          // serve buffered bytes; error next call
            *err = bz->error;
            return -1;
        }
        std::vector<uint8_t>& blk = f->second;
        size_t n = blk.size() - bz->front_off;
        if (n > want - got) n = want - got;
        std::memcpy(out + got, blk.data() + bz->front_off, n);
        got += n;
        bz->front_off += n;
        if (bz->front_off == blk.size()) {
            bz->ready.erase(f);
            bz->front_off = 0;
            bz->consume++;
            bz->cv_space.notify_all();
        }
    }
    s.produced += (int64_t)got;
    // exact size is known; est is exact
    __atomic_store_n(&s.compressed_read, s.fsize, __ATOMIC_RELAXED);
    return (long)got;
}
#endif

// read up to `want` decompressed bytes from stream; 0 = stream EOF, -1 = error
long stream_read(Stream& s, uint8_t* out, size_t want, std::string* err) {
    if (!s.is_gz) {
#ifdef KVARQ_HAVE_MMAP
        if (s.map) {
            // buffered consumption of a mapped file (single-threaded
            // path, or a threaded tail after a partial record): memcpy
            // from the mapping, no syscall
            size_t pos = (size_t)s.produced;
            size_t n = pos < s.map_size ? s.map_size - pos : 0;
            if (n > want) n = want;
            std::memcpy(out, s.map + pos, n);
            s.produced += (long)n;
            __atomic_fetch_add(&s.compressed_read, (int64_t)n,
                               __ATOMIC_RELAXED);
            return (long)n;
        }
#endif
        size_t n = std::fread(out, 1, want, s.f);
        s.produced += (long)n;
        __atomic_fetch_add(&s.compressed_read, (int64_t)n,
                           __ATOMIC_RELAXED);
        return (long)n;
    }
#ifdef KVARQ_USE_LIBDEFLATE
    if (s.bgzf) return bgzf_read(s, out, want, err);
    if (s.bg && !s.bg_serving &&
        s.bg->state.load(std::memory_order_acquire) == 2) {
        // background decode finished: serve the rest from its buffer
        // (picking up exactly where the ring stream left off -- both
        // decode the same file, so the bytes are identical)
        s.bg_serving = true;
        s.known_total = (int64_t)s.bg->dec.size();
        abandon_ring(s);
        __atomic_store_n(&s.compressed_read, s.fsize,
                         __ATOMIC_RELAXED);
    }
    if (s.bg_serving) {
        const std::vector<uint8_t>& dec = s.bg->dec;
        size_t pos = (size_t)s.produced;
        size_t n = pos < dec.size() ? dec.size() - pos : 0;
        if (n > want) n = want;
        std::memcpy(out, dec.data() + pos, n);
        s.produced += (long)n;
        return (long)n;
    }
#endif
    return ring_read(s, out, want, err);
}

// ---- accelerated gz decode ----------------------------------------------

#ifdef KVARQ_USE_LIBDEFLATE
// free host memory (Linux MemAvailable); -1 when unknown.  Only the
// libdeflate takeover consults it, so keep it inside the #ifdef (the
// plain -lz build would otherwise warn about an unused function).
static int64_t mem_available_bytes() {
    FILE* f = std::fopen("/proc/meminfo", "r");
    if (!f) return -1;
    char line[160];
    long long kb = -1;
    while (std::fgets(line, sizeof line, f))
        if (std::sscanf(line, "MemAvailable: %lld kB", &kb) == 1) break;
    std::fclose(f);
    return kb > 0 ? (int64_t)kb * 1024 : -1;
}

// body of the background decode thread: slurp the compressed file and
// decode all gzip members (multi-stream semantics, workhorse.c:841-866)
// into bg->dec.  Any failure -- short read, bad data, pathological
// ratio -- just marks the decode unusable (state 3); the concurrent zlib
// streaming path keeps going and reports errors with its own messages.
void bg_decode_main(BgDecode* bg, std::string fname, int64_t fsize) try {
    FILE* f = std::fopen(fname.c_str(), "rb");
    std::vector<uint8_t> in((size_t)fsize);
    bool ok = f && std::fread(in.data(), 1, in.size(), f) == in.size();
    if (f) std::fclose(f);
    libdeflate_decompressor* d =
        ok ? libdeflate_alloc_decompressor() : nullptr;
    if (!d) {
        bg->state.store(3, std::memory_order_release);
        return;
    }
    // growth bound: pathological-ratio guard AND current free RAM (a
    // legal high-ratio file must abandon the takeover, not OOM -- the
    // streaming ring is decoding the same file concurrently anyway)
    size_t cap = in.size() * 48 + (1u << 24);
    const int64_t mem = mem_available_bytes();
    if (mem > 0 && cap > (size_t)(mem / 2)) cap = (size_t)(mem / 2);
    size_t pos = 0;       // consumed compressed bytes
    size_t len = 0;       // produced decompressed bytes
    // start from a generous ratio guess (resize copies + zero-fills, so
    // repeated doubling on multi-GB outputs is real wall time), but never
    // above the RAM cap: on a tight-memory host the uncapped guess could
    // throw bad_alloc and abandon a takeover that fits at cap
    size_t init = in.size() * 5 + (1u << 24);
    bg->dec.resize(init < cap ? init : cap);
    while (ok && pos < in.size()) {
        size_t ain = 0, aout = 0;
        libdeflate_result res = libdeflate_gzip_decompress_ex(
            d, in.data() + pos, in.size() - pos,
            bg->dec.data() + len, bg->dec.size() - len, &ain, &aout);
        if (res == LIBDEFLATE_INSUFFICIENT_SPACE &&
            bg->dec.size() < cap) {
            size_t want = bg->dec.size() * 2;
            bg->dec.resize(want < cap ? want : cap);
            continue;
        }
        if (res != LIBDEFLATE_SUCCESS) {
            ok = false;
            break;
        }
        pos += ain;
        len += aout;
    }
    libdeflate_free_decompressor(d);
    if (!ok) {
        bg->dec.clear();
        bg->dec.shrink_to_fit();
        bg->state.store(3, std::memory_order_release);
        return;
    }
    bg->dec.resize(len);
    bg->state.store(2, std::memory_order_release);
} catch (...) {
    // allocation failure etc. must mark the decode unusable, not
    // escape the thread (which would std::terminate the process)
    bg->dec.clear();
    bg->dec.shrink_to_fit();
    bg->state.store(3, std::memory_order_release);
}
#endif

// refresh the decompressed-size estimate: exact when the stream was fully
// decoded, else from the compression ratio so far (workhorse.c:882-884)
void refine_est(Reader* r, size_t si) {
    Stream& s = r->streams[si];
    if (!s.is_gz || s.fsize <= 0) return;
    if (s.known_total >= 0) {
        r->est[si] = s.known_total;
        update_total(r);
        return;
    }
    double frac = (double)__atomic_load_n(&s.compressed_read,
                                          __ATOMIC_RELAXED)
                  / (double)s.fsize;
    if (frac > 1.0) frac = 1.0;
    if (frac > 1e-9) {
        int64_t e = (int64_t)((double)s.produced / frac);
        r->est[si] = e > s.produced ? e : s.produced;
    }
    update_total(r);
}

// pull the next chunk into r->buf (after the unparsed leftover);
// returns bytes added, 0 at global EOF, -1 error.
// Caller must hold in_mtx in threaded mode.
long fill_buf(Reader* r) {
    // drop parsed prefix, keep leftover
    if (r->buf_pos) {
        r->buf.erase(r->buf.begin(), r->buf.begin() + r->buf_pos);
        r->buf_offset += (int64_t)r->buf_pos;
        r->buf_pos = 0;
    }
    while (r->cur_stream < r->streams.size()) {
        Stream& s = r->streams[r->cur_stream];
        if (!s.f && !open_stream(s, &r->error, r->nthreads)) return -1;
        size_t old = r->buf.size();
        r->buf.resize(old + CHUNKSIZE);
        long n = stream_read(s, r->buf.data() + old, CHUNKSIZE, &r->error);
        if (n < 0) return -1;
        r->buf.resize(old + (size_t)n);
        if (n == 0) {
            // exact size once the file is fully read
            r->est[r->cur_stream] = s.produced;
            update_total(r);
            close_stream(s);
            r->cur_stream++;
            continue;
        }
        refine_est(r, r->cur_stream);
        r->parsed = r->buf_offset + (int64_t)r->buf.size();
        return n;
    }
    r->at_eof = true;
    r->parsed = r->buf_offset + (int64_t)r->buf.size();
    r->total = r->parsed;
    return 0;
}

// SWAR scan: index of the first byte < amin in q[0..n), or n if none.
// Valid for amin <= 127 (ASCII quality cutoffs always are); bytes >= 128
// compare as "not less", matching the uint8 comparison used throughout.
inline size_t first_below(const uint8_t* q, size_t n, uint8_t amin) {
    size_t i = 0;
#if defined(__AVX2__)
    const __m256i A = _mm256_set1_epi8((char)amin);
    for (; i + 32 <= n; i += 32) {
        const __m256i v = _mm256_loadu_si256((const __m256i*)(q + i));
        const uint32_t ge = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(_mm256_max_epu8(v, A), v));
        if (ge != 0xFFFFFFFFu)
            return i + (size_t)__builtin_ctz(~ge);
    }
#else
    const uint64_t am = 0x0101010101010101ull * amin;
    const uint64_t hi = 0x8080808080808080ull;
    for (; i + 8 <= n; i += 8) {
        uint64_t x;
        std::memcpy(&x, q + i, 8);
        uint64_t lt = (x - am) & ~x & hi;   // high bit set per byte < amin
        if (lt) {
            // lowest such byte
            return i + (size_t)(__builtin_ctzll(lt) >> 3);
        }
    }
#endif
    for (; i < n; i++)
        if (q[i] < amin) return i;
    return n;
}

// ---- k-mer seed-and-verify sieve ----------------------------------------
//
// Three-stage cascade; must keep exactly the reads
// kvarq_tpu.engine.sieve.KmerSieve.candidates keeps (the numpy oracle;
// tests assert read-for-read parity).  Junk bytes (anything outside
// ACGTN) reset the rolling window.

// per-read seed bookkeeping shared by both sieve implementations;
// (diag, tid) packed into one u64 key so the dedup scan is one load
// per entry.  The key list keeps 8 sentinel (~0) slots beyond nseeds so
// the AVX2 scan can read whole vectors; ~0 is never a real key (tid is
// a nonnegative int32).
struct SeedState {
    static constexpr int MAX_SEEDS = 256;
    alignas(32) uint64_t keys[MAX_SEEDS + 8];
    int16_t counts[MAX_SEEDS];
    int nseeds = 0;
    SeedState() { for (int i = 0; i < 8; i++) keys[i] = ~0ull; }
};

// find `key` among the first `n` entries (vectorized); -1 when absent
static inline int seed_find(const SeedState& ss, uint64_t key) {
#if defined(__AVX2__)
    const __m256i vkey = _mm256_set1_epi64x((long long)key);
    for (int si = 0; si < ss.nseeds; si += 4) {
        const uint32_t m = (uint32_t)_mm256_movemask_pd(
            _mm256_castsi256_pd(_mm256_cmpeq_epi64(
                _mm256_loadu_si256((const __m256i*)(ss.keys + si)),
                vkey)));
        if (m) return si + (int)__builtin_ctz(m);
    }
    return -1;
#else
    for (int s = 0; s < ss.nseeds; s++)
        if (ss.keys[s] == key) return s;
    return -1;
#endif
}

// stage 3: exact overlap check of the read against template `tid` at
// diagonal `diag` -- 1 = hit possible (keep read), 0 = too many
// mismatches, -1 = overlap shorter than m (dead diagonal)
inline int sieve_verify(const Reader* r, const uint8_t* rp, int rl,
                        int32_t diag, int32_t tid) {
    int64_t lo2 = r->sieve_tstart[tid];
    if (diag > lo2) lo2 = diag;
    int64_t hi2 = r->sieve_tstop[tid];
    if (diag + rl < hi2) hi2 = diag + rl;
    if (hi2 - lo2 < r->sieve_m) return -1;
    int mism = 0;
    for (int64_t g2 = lo2; g2 < hi2; g2++)
        if (r->sieve_bank[g2] != r->code_of[rp[g2 - diag]]
            && ++mism > r->sieve_e) return 0;
    return 1;
}

// stages 2 + 3 over the bank entries [jlo, jhi) of one read window at
// `wpos`: collect seeds per (diagonal, template); at exactly t seeds run
// the exact overlap check.  Returns true once the read is proven a
// candidate (incl. the conservative keep on seed-list overflow).
inline bool sieve_stage2(const Reader* r, const uint8_t* rp, int rl,
                         int wpos, const int32_t* seeds,
                         int32_t jlo, int32_t jhi, SeedState& ss) {
    const int t = r->sieve_t;
    for (int32_t j = jlo; j < jhi; j++) {
        const int32_t diag = seeds[2 * j] - wpos;
        const int32_t tid = seeds[2 * j + 1];
        const uint64_t key = ((uint64_t)(uint32_t)diag << 32)
                           | (uint32_t)tid;
        int s = seed_find(ss, key);
        if (s < 0) {
            if (ss.nseeds == SeedState::MAX_SEEDS)
                return true;               // overflow: keep (conservative)
            s = ss.nseeds;
            ss.keys[s] = key; ss.counts[s] = 0;
            ss.keys[s + 8] = ~0ull;        // keep the sentinel pad ahead
            ss.nseeds++;
        }
        // stage 2: t seeds on one (diagonal, template)
        if (++ss.counts[s] != t) continue;
        const int v = sieve_verify(r, rp, rl, diag, tid);
        if (v > 0) return true;
        ss.counts[s] = -32000;             // verified dead / overlap < m
    }
    return false;
}

// seed bookkeeping for one read: the exact SeedState plus, for the
// common t == 2 configuration, a register/L1-resident 1024-bit bloom
// filter.  With t == 2 a seed key only matters once it REPEATS, so the
// hot path per entry is hash + bit test-and-set with no key-list scan;
// the exact scan runs only on a bloom hit (a real repeat, or a ~n^2/1024
// collision).  Candidate set identical to sieve_stage2 by construction.
struct SeedCtx {
    SeedState ss;
    uint64_t bloom[16];
    uint64_t dead[(SeedState::MAX_SEEDS + 63) / 64];
    explicit SeedCtx(bool t2) {
        if (t2) {
            std::memset(bloom, 0, sizeof(bloom));
            std::memset(dead, 0, sizeof(dead));
        }
    }
};

inline bool sieve_stage2_t2(const Reader* r, const uint8_t* rp, int rl,
                            int wpos, const int32_t* seeds,
                            int32_t jlo, int32_t jhi, SeedCtx& sc) {
    SeedState& ss = sc.ss;
    for (int32_t j = jlo; j < jhi; j++) {
        const int32_t diag = seeds[2 * j] - wpos;
        const int32_t tid = seeds[2 * j + 1];
        const uint64_t key = ((uint64_t)(uint32_t)diag << 32)
                           | (uint32_t)tid;
        const uint32_t h =
            (uint32_t)((key * 0x9E3779B97F4A7C15ull) >> 54);
        uint64_t& bw = sc.bloom[h >> 6];
        const uint64_t bit = 1ull << (h & 63);
        int s = -1;
        if (!(bw & bit) || (s = seed_find(ss, key)) < 0) {
            bw |= bit;                     // definitely unseen: record
            if (ss.nseeds == SeedState::MAX_SEEDS)
                return true;               // overflow: keep (conservative)
            ss.keys[ss.nseeds] = key;
            ss.keys[ss.nseeds + 8] = ~0ull;
            ss.nseeds++;
            continue;
        }
        // second seed on this (diagonal, template): verify exactly
        if (sc.dead[s >> 6] >> (s & 63) & 1) continue;
        if (sieve_verify(r, rp, rl, diag, tid) > 0) return true;
        sc.dead[s >> 6] |= 1ull << (s & 63);
    }
    return false;
}

inline bool sieve_seen(const Reader* r, const uint8_t* rp, int rl,
                       int wpos, const int32_t* seeds, int32_t jlo,
                       int32_t jhi, SeedCtx& sc) {
    return r->sieve_t == 2
        ? sieve_stage2_t2(r, rp, rl, wpos, seeds, jlo, jhi, sc)
        : sieve_stage2(r, rp, rl, wpos, seeds, jlo, jhi, sc.ss);
}

// rolling-window implementation over the base-5 index (any k) -- the
// direct transcription of the oracle; used when the 2-bit secondary
// index is unavailable (k = 12)
bool sieve_candidate_base5(const Reader* r, const uint8_t* rp, int rl) {
    const int k = r->sieve_k;
    const uint32_t mask2 = r->sieve_mask2;
    SeedCtx sc(r->sieve_t == 2);
    uint32_t kcode2 = 0;   // rolling 2-bit window code, window base j at
                           // bits [2j, 2j+2) (same layout as the packed
                           // stream in sieve_candidate_fast)
    int krun = 0;          // non-junk run length
    int krun4 = 0;         // ACGT-only run length
    for (int i = 0; i < rl; i++) {
        uint8_t c = r->code_of[rp[i]];
        if (c >= 5) { krun = 0; krun4 = 0; continue; }
        if (c < 4) {
            kcode2 = ((kcode2 >> 2) | ((uint32_t)c << (2 * (k - 1))))
                   & mask2;
            krun4++;
        } else { krun4 = 0; }
        if (++krun < k) continue;
        // stage 1: presence bit.  N-free windows hit the 4^k-bit map;
        // windows containing N take the base-5 map.
        int64_t kcode;
        if (krun4 >= k) {
            if (!(r->sieve_present2[kcode2 >> 6] >> (kcode2 & 63) & 1))
                continue;
            kcode = r->conv5[0][kcode2 & 0xFF]
                  + r->conv5[1][(kcode2 >> 8) & 0xFF]
                  + r->conv5[2][(kcode2 >> 16) & 0xFF];
        } else {
            kcode = 0;
            for (int j = i + 1 - k; j <= i; j++)
                kcode = kcode * 5 + r->code_of[rp[j]];
            if (!(r->sieve_present[(size_t)kcode >> 6]
                  >> (kcode & 63) & 1))
                continue;
        }
        if (sieve_seen(r, rp, rl, i + 1 - k, r->sieve_seed5.data(),
                       r->sieve_start[kcode], r->sieve_start[kcode + 1],
                       sc))
            return true;
    }
    return false;
}

#if defined(__AVX2__)
// 16 presence probes with one 16-lane gather; lane order is preserved
// end-to-end so bit o of the result is window s+o directly.  Compiled
// for AVX-512 and dispatched at runtime (the base build targets
// x86-64-v3).
__attribute__((target("avx512f,avx512vl,avx512dq,avx512bw")))
static uint32_t probe16_avx512(uint64_t pk64, const uint64_t* present2,
                               uint32_t mask2) {
    const __m512i vpk = _mm512_set1_epi64((long long)pk64);
    const __m512i a = _mm512_srlv_epi64(
        vpk, _mm512_setr_epi64(0, 2, 4, 6, 8, 10, 12, 14));
    const __m512i b = _mm512_srlv_epi64(
        vpk, _mm512_setr_epi64(16, 18, 20, 22, 24, 26, 28, 30));
    __m512i keys = _mm512_inserti64x4(
        _mm512_castsi256_si512(_mm512_cvtepi64_epi32(a)),
        _mm512_cvtepi64_epi32(b), 1);
    keys = _mm512_and_si512(keys, _mm512_set1_epi32((int)mask2));
    const __m512i word = _mm512_i32gather_epi32(
        _mm512_srli_epi32(keys, 5), (const int*)present2, 4);
    const __m512i bit = _mm512_srlv_epi32(
        word, _mm512_and_si512(keys, _mm512_set1_epi32(31)));
    return (uint32_t)_mm512_test_epi32_mask(bit, _mm512_set1_epi32(1));
}

static bool cpu_has_avx512() {
    static const bool ok = __builtin_cpu_supports("avx512vl")
        && __builtin_cpu_supports("avx512dq")
        && __builtin_cpu_supports("avx512bw");
    return ok;
}
#endif

// two-phase fast path over the 2-bit secondary index (k <= 11; default
// k = 8).  Phase 1 packs the read ONCE into a 2-bit base stream (base p
// at bits [2p, 2p+2)) plus junk/N bitmasks, then derives every window
// key with a shift+mask from the packed stream -- no serial rolling
// dependency, no per-base branches; the SIMD packer encodes 32 bases in
// ~10 instructions (movemask bit-plane extraction + pdep interleave).
// Phase 2 prefetches all stage-2 bucket bounds up front (memory-level
// parallelism instead of serial L2 misses) and then probes them.
// Candidate set is identical to sieve_candidate_base5 by construction.
bool sieve_candidate_fast(const Reader* r, const uint8_t* rp, int rl) {
    const int k = r->sieve_k;
    const uint32_t mask2 = r->sieve_mask2;
    // the packed window list holds MAX_READLENGTH entries and every
    // window of the read may flag; longer reads take the rolling
    // formulation (identical candidate set, no per-window buffers)
    if (rl - k + 1 > MAX_READLENGTH)
        return sieve_candidate_base5(r, rp, rl);

    // phase 1a: pack 2-bit codes + junk/N masks (+32 slack so the
    // constant-size tail zeroing below stays in bounds)
    uint8_t pk[MAX_READLENGTH / 4 + 32];
    uint8_t jm[MAX_READLENGTH / 8 + 32];
    uint8_t nm[MAX_READLENGTH / 8 + 32];
    int i = 0;
#if defined(__AVX2__) && defined(__BMI2__)
    // canonical char per low nibble ('\n' where no base maps: it can
    // never appear inside a line, so the equality test is exact -- only
    // bytes equal to one of ACGTN validate); 2-bit codes per low nibble
    // match code_of (A0 C1 G2 T3; N/junk don't-care, masked via nm/jm)
    const __m256i CANON = _mm256_setr_epi8(
        '\n', 'A', '\n', 'C', 'T', '\n', '\n', 'G',
        '\n', '\n', '\n', '\n', '\n', '\n', 'N', '\n',
        '\n', 'A', '\n', 'C', 'T', '\n', '\n', 'G',
        '\n', '\n', '\n', '\n', '\n', '\n', 'N', '\n');
    const __m256i CODE2 = _mm256_setr_epi8(
        0, 0, 0, 1, 3, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0,
        0, 0, 0, 1, 3, 0, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0);
    const __m256i LNMASK = _mm256_set1_epi8(0x0F);
    const __m256i NCH = _mm256_set1_epi8('N');
    for (; i + 32 <= rl; i += 32) {
        const __m256i v = _mm256_loadu_si256((const __m256i*)(rp + i));
        const __m256i ln = _mm256_and_si256(v, LNMASK);
        const uint32_t valid = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(v, _mm256_shuffle_epi8(CANON, ln)));
        const __m256i c2 = _mm256_shuffle_epi8(CODE2, ln);
        const uint32_t b0 = (uint32_t)_mm256_movemask_epi8(
            _mm256_slli_epi16(c2, 7));
        const uint32_t b1 = (uint32_t)_mm256_movemask_epi8(
            _mm256_slli_epi16(c2, 6));
        uint64_t packed = _pdep_u64(b0, 0x5555555555555555ull)
                        | _pdep_u64(b1, 0xAAAAAAAAAAAAAAAAull);
        std::memcpy(pk + (i >> 2), &packed, 8);
        const uint32_t junk = ~valid;
        const uint32_t nbits = (uint32_t)_mm256_movemask_epi8(
            _mm256_cmpeq_epi8(v, NCH));
        std::memcpy(jm + (i >> 3), &junk, 4);
        std::memcpy(nm + (i >> 3), &nbits, 4);
    }
#endif
    // zero the tail so the unaligned window loads read defined bytes
#if defined(__AVX2__) && defined(__BMI2__)
    // the SIMD pack consumed every full 32-base block, so rl - i < 32
    // and constant 24-byte spans cover every case -- the compiler
    // inlines plain stores instead of 3 memset calls (~60 cycles/read
    // of call overhead at 101 bp)
    std::memset(pk + (i >> 2), 0, 24);
    std::memset(jm + (i >> 3), 0, 24);
    std::memset(nm + (i >> 3), 0, 24);
#else
    // generic build: i == 0 here, the scalar loop below fills the
    // whole read -- zero everything it will OR into
    std::memset(pk + (i >> 2), 0, (size_t)((rl - i + 3) / 4) + 8);
    std::memset(jm + (i >> 3), 0, (size_t)((rl - i + 7) / 8) + 8);
    std::memset(nm + (i >> 3), 0, (size_t)((rl - i + 7) / 8) + 8);
#endif
    for (; i < rl; i++) {
        const uint8_t c = r->code_of[rp[i]];
        pk[i >> 2] |= (uint8_t)((c & 3) << (2 * (i & 3)));
        jm[i >> 3] |= (uint8_t)((c >= 5 ? 1 : 0) << (i & 7));
        nm[i >> 3] |= (uint8_t)((c == 4 ? 1 : 0) << (i & 7));
    }

    // phase 1b: branchless presence scan over all windows -- key =
    // 2k bits of the packed stream at bit 2*wpos.  Junk/N window masks
    // come from OR-smearing the per-base bitmasks over the window width
    // (4-5 shift-ORs cover 16 windows at once); per window only the key
    // extraction + presence probe remain, collected into a bitmask so
    // the (rare) flagged windows append via a ctz loop.
    uint64_t wins[MAX_READLENGTH];
    int nw = 0;
    const uint64_t* present2 = r->sieve_present2.data();
    const int W = rl - k;            // last window start
    for (int s = 0; s <= W; s += 16) {
        uint64_t pk64, jm64, nm64;   // s % 16 == 0: bit offsets are 0
        std::memcpy(&pk64, pk + (s >> 2), 8);
        std::memcpy(&jm64, jm + (s >> 3), 8);
        std::memcpy(&nm64, nm + (s >> 3), 8);
        // OR-smear width k: bit o = OR of bits o..o+k-1 (doubling
        // shifts, final shift sized so coverage stays contiguous)
        uint64_t sj = jm64 | (jm64 >> 1);
        uint64_t sn = nm64 | (nm64 >> 1);
        sj |= sj >> 2; sn |= sn >> 2;
        if (k > 8) {
            sj |= sj >> 4; sn |= sn >> 4;
            sj |= sj >> (k - 8); sn |= sn >> (k - 8);
        } else if (k > 4) {
            sj |= sj >> (k - 4); sn |= sn >> (k - 4);
        }
        const uint32_t clean = (uint32_t)~sj & 0xFFFFu;
        const uint32_t hasn = (uint32_t)sn & 0xFFFFu;
        const int e = (W - s) < 15 ? (W - s) : 15;
        const uint32_t lim = (e == 15) ? 0xFFFFu : ((1u << (e + 1)) - 1);
        uint32_t cmask;
#if defined(__AVX2__) && defined(__BMI2__)
        if (cpu_has_avx512()) {
            cmask = probe16_avx512(pk64, present2, mask2);
        } else
#endif
        {
            // scalar probe loop: measured EQUAL to the 16-lane AVX-512
            // gather within noise and faster than an AVX2 2-gather
            // formulation on this class of CPU -- the 8 KB presence
            // bitmap is L1-resident and the serial pkv chain is 1
            // cycle/window, so gathers only add latency
            cmask = 0;
            uint64_t pkv = pk64;
            for (int o = 0; o <= e; o++, pkv >>= 2) {
                const uint32_t key = (uint32_t)pkv & mask2;
                cmask |= (uint32_t)(
                    (present2[key >> 6] >> (key & 63)) & 1u) << o;
            }
        }
        cmask = (cmask | hasn) & clean & lim;
        while (cmask) {
            const int o = __builtin_ctz(cmask);
            cmask &= cmask - 1;
            const uint32_t key = (uint32_t)(pk64 >> (2 * o)) & mask2;
            const uint64_t hitn = (uint64_t)((hasn >> o) & 1u);
            wins[nw++] = (hitn << 63)
                       | ((uint64_t)(uint32_t)(s + o) << 32) | key;
        }
    }
    if (!nw) return false;

    SeedCtx sc(r->sieve_t == 2);

    if (!r->sieve_hash.empty()) {
        // phase 2 via the dense slot table: ONE prefetched L2 line per
        // probe; single-seed buckets (the majority) resolve entirely
        // from the slot, bigger buckets overflow into seed2.  (A
        // separate slot-resolution pass measured slower: the prefetch
        // pass already hides the L2 latency.)
        const uint32_t nslots1 = (uint32_t)r->sieve_hash.size() - 1;
        const Reader::HashSlot* hash = r->sieve_hash.data();
        for (int q = 0; q < nw; q++)
            if (!(wins[q] >> 63))
                __builtin_prefetch(&hash[
                    ((uint32_t)wins[q] * Reader::HASH_MULT)
                    >> r->sieve_hash_shift]);
        for (int q = 0; q < nw; q++) {
            const int wpos = (int)(uint32_t)(wins[q] >> 32) & 0x7FFFFFFF;
            if (wins[q] >> 63) {      // N window: base-5 path (rare)
                int64_t kcode = 0;
                for (int j = wpos; j < wpos + k; j++)
                    kcode = kcode * 5 + r->code_of[rp[j]];
                if (!(r->sieve_present[(size_t)kcode >> 6]
                      >> (kcode & 63) & 1))
                    continue;
                if (sieve_seen(r, rp, rl, wpos, r->sieve_seed5.data(),
                               r->sieve_start[kcode],
                               r->sieve_start[kcode + 1], sc))
                    return true;
                continue;
            }
            const uint16_t key = (uint16_t)(uint32_t)wins[q];
            uint32_t h = ((uint32_t)key * Reader::HASH_MULT)
                       >> r->sieve_hash_shift;
            // the presence bit guarantees the key is in the table
            while (hash[h].key != key || !hash[h].cnt)
                h = (h + 1) & nslots1;
            const Reader::HashSlot slot = hash[h];
            if (slot.cnt == 1) {
                const int32_t pair[2] = {
                    (int32_t)(slot.payload >> 16),
                    (int32_t)(slot.payload & 0xFFFF)};
                if (sieve_seen(r, rp, rl, wpos, pair, 0, 1, sc))
                    return true;
            } else {
                if (sieve_seen(r, rp, rl, wpos, r->sieve_seed2.data(),
                               (int32_t)slot.payload,
                               (int32_t)(slot.payload + slot.cnt), sc))
                    return true;
            }
        }
        return false;
    }

    // phase 2 (generic): prefetch every bucket's bounds, then every
    // bucket's seed rows, then run stages 2/3 -- memory-level
    // parallelism instead of a serial chain of L2 misses per probe
    for (int q = 0; q < nw; q++)
        if (!(wins[q] >> 63))
            __builtin_prefetch(&r->sieve_start2[(uint32_t)wins[q]]);
    int32_t bounds[MAX_READLENGTH][2];
    for (int q = 0; q < nw; q++) {
        if (wins[q] >> 63) continue;
        const uint32_t w = (uint32_t)wins[q];
        bounds[q][0] = r->sieve_start2[w];
        bounds[q][1] = r->sieve_start2[w + 1];
        __builtin_prefetch(&r->sieve_seed2[2 * (size_t)bounds[q][0]]);
    }
    for (int q = 0; q < nw; q++) {
        const int wpos = (int)(uint32_t)(wins[q] >> 32) & 0x7FFFFFFF;
        if (wins[q] >> 63) {          // N window: base-5 path (rare)
            int64_t kcode = 0;
            for (int j = wpos; j < wpos + k; j++)
                kcode = kcode * 5 + r->code_of[rp[j]];
            if (!(r->sieve_present[(size_t)kcode >> 6]
                  >> (kcode & 63) & 1))
                continue;
            if (sieve_seen(r, rp, rl, wpos, r->sieve_seed5.data(),
                           r->sieve_start[kcode],
                           r->sieve_start[kcode + 1], sc))
                return true;
        } else {
            if (sieve_seen(r, rp, rl, wpos, r->sieve_seed2.data(),
                           bounds[q][0], bounds[q][1], sc))
                return true;
        }
    }
    return false;
}

// Parse sanity checks + quality trim + sieve for the record whose four
// line-end newlines are nls[0..3] within `b` (record starts at `p`);
// `base_off` is the global decompressed offset of b[0].  Histogram
// updates go to rls / rls_longest (caller-owned).
// Returns 1 = emit read (sets *rl_out / *bs_out), 0 = drop,
// -1 = format error (sets *err).
int handle_record(const Reader* r, const uint8_t* b, size_t p,
                  const size_t nls[4], int64_t base_off,
                  int64_t* rls, int64_t* rls_longest,
                  int* rl_out, size_t* bs_out, std::string* err) {
    if (b[p] != '@') {
        char msg[96];
        std::snprintf(msg, sizeof(msg),
                      "record must start with '@' (and not '%c') "
                      "fpos=%lld", b[p],
                      (long long)(base_off + (int64_t)p));
        *err = msg;
        return -1;
    }
    size_t plus = nls[1] + 1;
    if (b[plus] != '+') {
        char msg[96];
        std::snprintf(msg, sizeof(msg),
                      "3rd line of record must start with '+' fpos=%lld",
                      (long long)(base_off + (int64_t)plus));
        *err = msg;
        return -1;
    }

    // quality trim: first-longest run of bytes >= amin in the quality
    // line (workhorse.c:1055-1070); CR before LF breaks the run since
    // '\r' < any sane amin -- matched by byte comparison either way.
    // SWAR fast path: most lines pass entirely, and the prefix run up to
    // the first failing byte is the first candidate for "longest".
    const uint64_t prof_t0 = prof_enabled() ? prof_now() : 0;
    const int amin = r->amin;
    size_t qs = nls[2] + 1, qe = nls[3];
    size_t f = first_below(b + qs, qe - qs, (uint8_t)amin);
    int best = (int)f, best_off = 0, run = 0;
    for (size_t i = qs + f + 1; i < qe; i++) {
        if (b[i] >= amin) {
            run++;
            if (run > best) { best = run; best_off = (int)(i + 1 - run - qs); }
        } else {
            run = 0;
        }
    }
    int rl = best;

    // histogram counts every record, incl. discarded ones
    int hrl = rl < MAX_READLENGTH ? rl : MAX_READLENGTH - 1;
    rls[hrl]++;
    if (rl > *rls_longest) *rls_longest = rl;

    uint64_t prof_t1 = 0;
    if (prof_t0) {
        prof_t1 = prof_now();
        r->prof_trim.fetch_add(prof_t1 - prof_t0,
                               std::memory_order_relaxed);
    }

    if (rl < r->minreadlength || rl <= 0)
        return 0;

    size_t bs = nls[0] + 1 + (size_t)best_off;  // trimmed read start

    if (r->sieve_start && rl >= r->sieve_k) {
        const bool cand = r->sieve_has2
            ? sieve_candidate_fast(r, b + bs, rl)
            : sieve_candidate_base5(r, b + bs, rl);
        if (prof_t1)
            r->prof_sieve.fetch_add(prof_now() - prof_t1,
                                    std::memory_order_relaxed);
        if (!cand) return 0;
    }

    *rl_out = rl;
    *bs_out = bs;
    return 1;
}

// ---- worker-thread machinery ------------------------------------------

// SIMD newline-position scan of base[from, to), positions emitted
// relative to base[rel]; shared by the span splitter and the
// process_item fallback
static void scan_newlines(const uint8_t* base, size_t from, size_t to,
                          size_t rel, std::vector<int32_t>* out) {
    size_t i = from;
#if defined(__AVX2__)
    const __m256i NL = _mm256_set1_epi8('\n');
    for (; i + 32 <= to; i += 32) {
        uint32_t m = (uint32_t)_mm256_movemask_epi8(_mm256_cmpeq_epi8(
            _mm256_loadu_si256((const __m256i*)(base + i)), NL));
        while (m) {
            out->push_back((int32_t)(i + __builtin_ctz(m) - rel));
            m &= m - 1;
        }
    }
#endif
    for (; i < to; i++)
        if (base[i] == '\n') out->push_back((int32_t)(i - rel));
}

// pull the next record-aligned span from the shared stream (the
// reference's mutex-guarded fastq_read + fastq_rewind, workhorse.c:746,
// :696-718 -- but via exact 4-newline counting instead of the rewind
// heuristic).  Returns nullptr at EOF / error / stop.
WorkItem* pull_work(Reader* r) {
    // in_mtx wait time is THE scaling diagnostic: everything under the
    // lock (fill/inflate, newline split, span copy) is the serialized
    // fraction that caps worker fan-out (Amdahl) -- see the nthreads
    // sweep in docs/performance.md
    const uint64_t w0 = prof_enabled() ? prof_now() : 0;
    std::unique_lock<std::mutex> l(r->in_mtx);
    if (w0) r->prof_inwait.fetch_add(prof_now() - w0,
                                     std::memory_order_relaxed);
    for (;;) {
        if (r->stopping || r->split_failed || r->split_eof) return nullptr;
#ifdef KVARQ_HAVE_MMAP
        // zero-copy fast path: buf is drained and the current stream is
        // an mmap'd plain file -- split records directly on the mapping
        // and hand the worker a borrowed span.  The only work left under
        // the lock is the newline scan (~44 cycles/read), against the
        // ~234 cycles/read of serialized read()+copy the buffered path
        // pays: this is what lets worker fan-out scale past a few cores
        // (docs/performance.md "reader thread scaling").
        while (r->buf_pos == r->buf.size()
                && r->cur_stream < r->streams.size()) {
            Stream& s = r->streams[r->cur_stream];
            if (!s.f) {
                if (!open_stream(s, &r->error, r->nthreads)) {
                    r->split_error = r->error;
                    r->split_failed = true;
                    r->out_cv.notify_all();
                    return nullptr;
                }
            }
            if (!s.map || s.is_gz) break;   // gz maps feed the ring only
            size_t pos = (size_t)s.produced;
            if (pos >= s.map_size) {
                // exhausted: close and advance HERE (fill_buf's EOF
                // path), so a following mapped stream enters this fast
                // path instead of being buffer-copied by fill_buf
                r->est[r->cur_stream] = s.produced;
                update_total(r);
                close_stream(s);
                r->cur_stream++;
                continue;
            }
            size_t mavail = s.map_size - pos;
            // compact the drained buf so global offsets stay exact
            if (r->buf_pos) {
                r->buf_offset += (int64_t)r->buf_pos;
                r->buf.clear();
                r->buf_pos = 0;
            }
#ifdef MADV_WILLNEED
            // async readahead so page faults don't land in the scan
            if (pos + (32u << 20) > s.map_advised
                    && s.map_advised < s.map_size) {
                size_t ahead = s.map_size - s.map_advised;
                if (ahead > (64u << 20)) ahead = 64u << 20;
                ::madvise((void*)(s.map + s.map_advised), ahead,
                          MADV_WILLNEED);
                s.map_advised += ahead;
            }
#endif
            const uint64_t mt0 = prof_enabled() ? prof_now() : 0;
            size_t window = mavail < WORKCHUNK ? mavail : WORKCHUNK;
            std::vector<int32_t> nls;
            nls.reserve(window / 48 + 8);
            size_t scan_end = pos + window;
            for (size_t q = pos; ; ) {
                scan_newlines(s.map, q, scan_end, pos, &nls);
                if (nls.size() < 4 && scan_end < pos + mavail) {
                    // record longer than the window: widen (doubling,
                    // capped so nl offsets stay within int32)
                    q = scan_end;
                    size_t widen = (scan_end - pos) * 2;
                    if (widen > (1u << 30)) widen = 1u << 30;
                    size_t lim = mavail < widen ? mavail : widen;
                    if (scan_end >= pos + lim) break;
                    scan_end = pos + lim;
                    continue;
                }
                break;
            }
            const size_t nrec4m = nls.size() & ~(size_t)3;
            if (mt0) r->prof_split.fetch_add(prof_now() - mt0,
                                             std::memory_order_relaxed);
            if (!nrec4m) {
                // no complete record left in the mapping: hand the tail
                // to the buffered path so a record may span into the
                // next stream (identical to the buffered semantics)
                r->buf.insert(r->buf.end(), s.map + pos,
                              s.map + s.map_size);
                s.produced = (int64_t)s.map_size;
                __atomic_store_n(&s.compressed_read, s.fsize,
                                 __ATOMIC_RELAXED);
                r->parsed = r->buf_offset + (int64_t)r->buf.size();
                break;
            }
            size_t span = (size_t)nls[nrec4m - 1] + 1;
            nls.resize(nrec4m);
            WorkItem* it = new WorkItem();
            it->seq = r->next_split++;
            it->offset = r->buf_offset;
            it->ext = s.map + pos;
            it->ext_len = span;
            it->nl = std::move(nls);
            s.produced += (int64_t)span;
            __atomic_fetch_add(&s.compressed_read, (int64_t)span,
                               __ATOMIC_RELAXED);
            r->buf_offset += (int64_t)span;
            r->parsed = r->buf_offset;
            return it;
        }
#endif
        size_t avail = r->buf.size() - r->buf_pos;
        if (avail < WORKCHUNK && !r->at_eof) {
            const uint64_t t0 = prof_enabled() ? prof_now() : 0;
            long n = fill_buf(r);
            if (t0) r->prof_fill.fetch_add(prof_now() - t0,
                                           std::memory_order_relaxed);
            if (n < 0) {
                r->split_error = r->error;
                r->split_failed = true;
                r->out_cv.notify_all();
                return nullptr;
            }
            continue;
        }
        // find the end of the last complete record (every 4th newline)
        // with ONE SIMD newline scan whose positions the worker's
        // record parse then reuses (it previously re-scanned the span)
        const uint64_t st0 = prof_enabled() ? prof_now() : 0;
        const uint8_t* base = r->buf.data();
        const size_t start = r->buf_pos;
        size_t scan_end = start + (avail < WORKCHUNK ? avail : WORKCHUNK);
        size_t last_rec_end = 0;
        std::vector<int32_t> nls;
        nls.reserve((scan_end - start) / 48 + 8);
        for (size_t q = start; ; ) {
            scan_newlines(base, q, scan_end, start, &nls);
            if (nls.size() < 4 && scan_end < start + avail) {
                // record longer than the window: widen
                q = scan_end;
                scan_end = start + avail;
                continue;
            }
            break;
        }
        const size_t nrec4 = nls.size() & ~(size_t)3;
        if (nrec4)
            last_rec_end = start + (size_t)nls[nrec4 - 1] + 1;
        nls.resize(nrec4);
        if (st0) r->prof_split.fetch_add(prof_now() - st0,
                                         std::memory_order_relaxed);
        if (last_rec_end == 0) {
            if (!r->at_eof) {      // need more data for one record
                if (fill_buf(r) < 0) {
                    r->split_error = r->error;
                    r->split_failed = true;
                    r->out_cv.notify_all();
                    return nullptr;
                }
                continue;
            }
            // trailing data without a full record is silently dropped
            // (workhorse.c:1032-1034)
            r->split_eof = true;
            r->out_cv.notify_all();
            return nullptr;
        }
        WorkItem* it = new WorkItem();
        it->seq = r->next_split++;
        it->offset = r->buf_offset + (int64_t)r->buf_pos;
        it->data.assign(base + r->buf_pos, base + last_rec_end);
        it->nl = std::move(nls);
        r->buf_pos = last_rec_end;
        return it;
    }
}

// parse + trim + sieve every record of the item into its local outputs
void process_item(Reader* r, WorkItem* it) {
    const uint64_t it0 = prof_enabled() ? prof_now() : 0;
    const uint8_t* b = it->ext ? it->ext : it->data.data();
    const size_t len = it->ext ? it->ext_len : it->data.size();

    // newline positions come from the splitter's scan (pull_work fills
    // it->nl); the fallback scan covers items built by other callers.
    // Item spans are record-aligned, so the count is a multiple of 4.
    std::vector<int32_t> local_nl;
    if (it->nl.empty() && len) {
        local_nl.reserve(len / 48 + 8);
        scan_newlines(b, 0, len, 0, &local_nl);
    }
    const std::vector<int32_t>& nl =
        it->nl.empty() ? local_nl : it->nl;

    size_t p = 0;
    for (size_t rec = 0; rec + 3 < nl.size(); rec += 4) {
        const size_t nls[4] = {(size_t)nl[rec], (size_t)nl[rec + 1],
                               (size_t)nl[rec + 2], (size_t)nl[rec + 3]};
        int rl = 0;
        size_t bs = 0;
        int ret = handle_record(r, b, p, nls, it->offset,
                                it->rls, &it->rls_longest,
                                &rl, &bs, &it->error);
        if (ret < 0) {
            it->has_error = true;
            return;
        }
        it->nrecords++;
        if (ret > 0) {
            it->cands.push_back(CandRec{
                rl, it->offset + (int64_t)bs, it->raws.size()});
            it->raws.insert(it->raws.end(), b + bs, b + bs + rl);
        }
        p = nls[3] + 1;
    }
    // the positions are dead now; free them before the item parks in
    // the ordered completion queue
    std::vector<int32_t>().swap(it->nl);
    if (it0) r->prof_item.fetch_add(prof_now() - it0,
                                    std::memory_order_relaxed);
}

void worker_main(Reader* r) {
    for (;;) {
        WorkItem* it = pull_work(r);
        if (!it) return;
        process_item(r, it);
        {
            std::lock_guard<std::mutex> l(r->out_mtx);
            r->completed[it->seq] = it;
        }
        r->out_cv.notify_all();
    }
}

// threaded kvq_next: drain processed items in sequence order
long next_threaded(Reader* r, long cap, long lmax, uint8_t* raw,
                   uint8_t* codes, int32_t* rl_out, int64_t* filepos,
                   int32_t* batch_maxrl) {
    long out = 0;
    int maxrl = 0;
    int64_t consumed = 0;

    while (out < cap) {
        if (!r->cur) {
            std::unique_lock<std::mutex> l(r->out_mtx);
            for (;;) {
                auto f = r->completed.find(r->next_consume);
                if (f != r->completed.end()) {
                    r->cur = f->second;
                    r->cur_i = 0;
                    r->completed.erase(f);
                    break;
                }
                if ((r->split_eof || r->split_failed)
                        && r->next_consume == r->next_split) {
                    if (r->split_failed) {
                        std::lock_guard<std::mutex> li(r->in_mtx);
                        r->error = r->split_error;
                        *batch_maxrl = maxrl;
                        return -1;
                    }
                    *batch_maxrl = maxrl;
                    return out;   // true EOF
                }
                const uint64_t ow0 = prof_enabled() ? prof_now() : 0;
                r->out_cv.wait(l);
                if (ow0) r->prof_outwait.fetch_add(
                    prof_now() - ow0, std::memory_order_relaxed);
            }
            // merge the item's stats in record order
            r->records_parsed = r->records_parsed + r->cur->nrecords;
            for (int i = 0; i < MAX_READLENGTH; i++)
                r->rls[i] += r->cur->rls[i];
            if (r->cur->rls_longest > r->rls_longest)
                r->rls_longest = r->cur->rls_longest;
            consumed += r->cur->nrecords;
        }
        WorkItem* it = r->cur;
        const uint64_t pt0 = prof_enabled() ? prof_now() : 0;
        while (out < cap && r->cur_i < it->cands.size()) {
            const CandRec& c = it->cands[r->cur_i];
            if (c.rl > lmax) {
                // stride too small: deliver what is packed so far; the
                // caller grows its buffers (kvq_pending_rl) and calls
                // again -- the candidate is not consumed, and its
                // stats were already merged with its work item
                r->pending_rl = c.rl;
                *batch_maxrl = maxrl;
                return out > 0 ? out : -2;
            }
            uint8_t* rrow = raw + out * lmax;
            uint8_t* crow = codes + out * lmax;
            std::memcpy(rrow, it->raws.data() + c.raw_off, (size_t)c.rl);
            for (int i = 0; i < c.rl; i++) crow[i] = r->code_of[rrow[i]];
            rl_out[out] = c.rl;
            filepos[out] = c.filepos;
            if (c.rl > maxrl) maxrl = c.rl;
            out++;
            r->cur_i++;
        }
        if (pt0) r->prof_pack.fetch_add(prof_now() - pt0,
                                        std::memory_order_relaxed);
        if (r->cur_i >= it->cands.size()) {
            bool had_error = it->has_error;
            if (had_error) r->error = it->error;
            delete it;
            r->cur = nullptr;
            r->next_consume++;
            if (had_error) return -1;
            if (consumed >= r->parse_cap && out > 0) break;
        }
    }
    *batch_maxrl = maxrl;
    return out;
}

}  // namespace

extern "C" {

// build provenance: native.py embeds the sha256 of this source at build
// time and compares at load, so a shipped/prebuilt .so whose mtime ties
// with a fresh checkout can never be used silently against newer source
#ifndef KVARQ_SRC_HASH
#define KVARQ_SRC_HASH ""
#endif
const char* kvq_src_hash(void) { return KVARQ_SRC_HASH; }

Reader* kvq_open(const char** fnames, int nfiles, int amin,
                 int minreadlength, int nthreads, long parse_cap) {
    Reader* r = new Reader();
    r->amin = amin;
    r->minreadlength = minreadlength;
    for (int i = 0; i < nfiles; i++) {
        Stream s;
        s.fname = fnames[i];
        r->streams.push_back(std::move(s));
    }
    // initial size estimates: plain size, or 3x compressed
    // (workhorse.c:624-626).  stat(), NOT a probe fopen: opening a
    // FIFO/process-substitution input here would consume the writer's
    // one-shot connection -- the writer sees a reader, writes, closes,
    // and the real open later blocks forever (measured deadlock)
    for (auto& s : r->streams) {
        struct stat st;
        int64_t sz = 0;
        if (::stat(s.fname.c_str(), &st) == 0 && S_ISREG(st.st_mode))
            sz = (int64_t)st.st_size;
        size_t n = s.fname.size();
        bool gz = n > 3 && s.fname.compare(n - 3, 3, ".gz") == 0;
        r->est.push_back(gz ? sz * 3 : sz);
    }
    update_total(r);
    std::memset(r->code_of, CODE_READ_JUNK, sizeof(r->code_of));
    r->code_of['A'] = 0; r->code_of['C'] = 1; r->code_of['G'] = 2;
    r->code_of['T'] = 3; r->code_of['N'] = 4;
    if (nthreads > 16) nthreads = 16;
    // oversubscription clamp: the reference's default of 8 threads on a
    // 2-core host pays context-switch overhead for nothing (measured
    // ~2-3% at the bench); cap at cores+2 so the pipeline keeps a
    // producer and a consumer runnable but no more.  KVARQ_THREADS_EXACT
    // disables the clamp (thread-scaling measurements want the exact
    // requested count, oversubscribed or not -- tools/gz_bench.py --sweep)
    const char* exact = std::getenv("KVARQ_THREADS_EXACT");
    const unsigned hw = std::thread::hardware_concurrency();
    if (!(exact && exact[0] && exact[0] != '0')
            && hw >= 1 && nthreads > (int)hw + 2)
        nthreads = (int)hw + 2;
    if (nthreads < 1) nthreads = 1;
    r->nthreads = nthreads;
    if (parse_cap > 0) r->parse_cap = parse_cap;
    return r;
}

const char* kvq_error(Reader* r) { return r->error.c_str(); }

// enable the seed-and-verify sieve: `start` has 5^k + 1 entries,
// `gpos[start[c]:start[c+1]]` / `gtid[...]` are bank position + template
// id per k-mer code; `tstart`/`tstop` are template spans in global
// coords; `bank` the concatenated template codes.  A read survives iff
// some (diagonal, template) collects `t` exact seeds AND the actual
// overlap there has length >= m with <= e mismatches.  Caller keeps all
// arrays alive until kvq_close.  Call before the first kvq_next.
void kvq_set_sieve(Reader* r, const int32_t* start, const int32_t* gpos,
                   const int32_t* gtid, const int32_t* tstart,
                   const int32_t* tstop, const uint8_t* bank,
                   int k, int t, int m, int maxerrors) {
    r->sieve_start = start;
    r->sieve_gpos = gpos;
    r->sieve_gtid = gtid;
    r->sieve_tstart = tstart;
    r->sieve_tstop = tstop;
    r->sieve_bank = bank;
    r->sieve_k = k;
    r->sieve_t = t;
    r->sieve_m = m;
    r->sieve_e = maxerrors;
    r->sieve_p5k = 1;
    for (int i = 0; i < k; i++) r->sieve_p5k *= 5;
    r->sieve_mask2 = (uint32_t)((1ull << (2 * k)) - 1);
    r->sieve_present.assign(((size_t)r->sieve_p5k + 63) / 64, 0);
    // N-free bank k-mers additionally populate an L1-resident 2-bit-code
    // bitmap (4^k bits; 8 KB at k=8): a window without N can only match
    // an N-free bank k-mer, so the small map is exact for such windows
    r->sieve_present2.assign(((size_t)1 << (2 * k)) / 64 + 1, 0);
    // 2-bit-keyed secondary index (see Reader): 4^k + 1 start entries is
    // affordable up to k = 11 (16 MB); beyond that the base-5 index
    // remains the only path.  Keys are position-little-endian (window
    // base j at bits [2j, 2j+2)) so the scan side can slice them
    // directly out of a packed 2-bit read stream; base-5 codes no
    // longer map monotonically onto them, so the seed lists fill with a
    // two-pass counting sort.
    r->sieve_has2 = k <= 11;
    if (r->sieve_has2)
        r->sieve_start2.assign(((size_t)1 << (2 * k)) + 1, 0);
    const int32_t nentries = start[r->sieve_p5k];
    r->sieve_seed5.resize((size_t)nentries * 2);
    for (int32_t j = 0; j < nentries; j++) {
        r->sieve_seed5[2 * (size_t)j] = gpos[j];
        r->sieve_seed5[2 * (size_t)j + 1] = gtid[j];
    }
    // base-5 code (big-endian digits: c = sum w[idx] * 5^(k-1-idx)) ->
    // little-endian 2-bit key; digit j from the LSB end is window base
    // k-1-j, so it lands at bits 2*(k-1-j)
    auto c2_of = [k](int64_t c, bool* has_n) -> uint32_t {
        uint32_t c2 = 0;
        int64_t v = c;
        for (int j = 0; j < k; j++) {
            const int d = (int)(v % 5);
            v /= 5;
            if (d == 4) { *has_n = true; return 0; }
            c2 |= (uint32_t)d << (2 * (k - 1 - j));
        }
        *has_n = false;
        return c2;
    };
    for (int64_t c = 0; c < r->sieve_p5k; c++) {
        if (start[c + 1] <= start[c]) continue;
        r->sieve_present[(size_t)c >> 6] |= 1ull << (c & 63);
        bool has_n;
        const uint32_t c2 = c2_of(c, &has_n);
        if (has_n) continue;
        r->sieve_present2[c2 >> 6] |= 1ull << (c2 & 63);
        if (r->sieve_has2)
            r->sieve_start2[c2 + 1] += start[c + 1] - start[c];
    }
    if (r->sieve_has2) {
        for (size_t i = 1; i < r->sieve_start2.size(); i++)
            r->sieve_start2[i] += r->sieve_start2[i - 1];
        r->sieve_seed2.assign(2 * (size_t)r->sieve_start2.back(), 0);
        std::vector<int32_t> cursor(r->sieve_start2.begin(),
                                    r->sieve_start2.end() - 1);
        for (int64_t c = 0; c < r->sieve_p5k; c++) {
            if (start[c + 1] <= start[c]) continue;
            bool has_n;
            const uint32_t c2 = c2_of(c, &has_n);
            if (has_n) continue;
            int32_t& cur = cursor[c2];
            for (int32_t j = start[c]; j < start[c + 1]; j++) {
                r->sieve_seed2[2 * (size_t)cur] = gpos[j];
                r->sieve_seed2[2 * (size_t)cur + 1] = gtid[j];
                cur++;
            }
        }
    }
    // dense bucket hash (see Reader::sieve_hash): k <= 8 keys fit u16
    // and gpos/tid must too; count the distinct codes first
    r->sieve_hash.clear();
    r->sieve_hash_shift = 0;
    if (r->sieve_has2 && k <= 8) {
        int64_t ncodes = 0;
        bool fits = true;
        for (int64_t c = 0; c < r->sieve_p5k && fits; c++) {
            if (start[c + 1] <= start[c]) continue;
            bool has_n;
            (void)c2_of(c, &has_n);
            if (has_n) continue;
            ncodes++;
            if (start[c + 1] - start[c] > 0xFFFF) fits = false;
            for (int32_t j = start[c]; fits && j < start[c + 1]; j++)
                if (gpos[j] > 0xFFFF || gtid[j] > 0xFFFF) fits = false;
        }
        if (fits && ncodes && ncodes <= 20000) {
            uint32_t nslots = 1024;
            while (nslots < 2 * (uint32_t)ncodes) nslots <<= 1;
            r->sieve_hash_shift = 32 - __builtin_ctz(nslots);
            r->sieve_hash.assign(nslots, Reader::HashSlot{0, 0, 0});
            for (int64_t c = 0; c < r->sieve_p5k; c++) {
                if (start[c + 1] <= start[c]) continue;
                bool has_n;
                const uint32_t c2 = c2_of(c, &has_n);
                if (has_n) continue;
                const uint16_t cnt =
                    (uint16_t)(start[c + 1] - start[c]);
                uint32_t h = (c2 * Reader::HASH_MULT)
                           >> r->sieve_hash_shift;
                while (r->sieve_hash[h].cnt)
                    h = (h + 1) & (nslots - 1);
                r->sieve_hash[h].key = (uint16_t)c2;
                r->sieve_hash[h].cnt = cnt;
                // seed2 offset of this bucket (same order as start2)
                const uint32_t off = (uint32_t)r->sieve_start2[c2];
                r->sieve_hash[h].payload = cnt == 1
                    ? ((uint32_t)(uint16_t)gpos[start[c]] << 16)
                      | (uint16_t)gtid[start[c]]
                    : off;
            }
        }
    }

    // 2-bit-key -> base-5 value conversion tables, 4 window positions
    // per byte: byte g of a key holds window bases 4g..4g+3, base
    // 4g+j contributing ((byte >> 2j) & 3) * 5^(k-1-(4g+j))
    for (int g = 0; g < 3; g++) {
        for (int b = 0; b < 256; b++) {
            int64_t v = 0;
            for (int j = 0; j < 4 && 4 * g + j < k; j++) {
                int64_t pw = 1;
                for (int q = 0; q < k - 1 - (4 * g + j); q++) pw *= 5;
                v += (int64_t)((b >> (2 * j)) & 3) * pw;
            }
            r->conv5[g][b] = v;
        }
    }
}

// read length behind the last -2 return from kvq_next (see there)
long kvq_pending_rl(Reader* r) {
    return r->pending_rl;
}

void kvq_stats(Reader* r, int64_t* records_parsed, int64_t* parsed,
               int64_t* total, int64_t* rls_longest, int64_t* rls) {
    *records_parsed = r->records_parsed;
    *parsed = r->parsed;
    *total = r->total;
    *rls_longest = r->rls_longest;
    if (rls) std::memcpy(rls, r->rls, sizeof(r->rls));
}

// Fill up to `cap` records into the caller's buffers (stride = lmax bytes
// per row for raw/codes).  Returns #records (0 = EOF), -1 = error, or
// -2 = a read is longer than lmax: query kvq_pending_rl, grow the
// buffers and call again (nothing was consumed or double-counted).
long kvq_next(Reader* r, long cap, long lmax, uint8_t* raw, uint8_t* codes,
              int32_t* rl_out, int64_t* filepos, int32_t* batch_maxrl) {
    if (r->nthreads > 1) {
        if (r->workers.empty() && !r->split_eof && !r->split_failed)
            for (int i = 0; i < r->nthreads; i++)
                r->workers.emplace_back(worker_main, r);
        return next_threaded(r, cap, lmax, raw, codes, rl_out, filepos,
                             batch_maxrl);
    }

    long out = 0;
    int maxrl = 0;
    // with the sieve active one call could otherwise consume the whole
    // file; cap the records parsed per call (once something was emitted)
    // so live stats / stop() stay responsive
    const int64_t parse_cap = r->records_parsed + r->parse_cap;

    while (out < cap) {
        if (out > 0 && r->records_parsed >= parse_cap) break;
        const uint8_t* b = r->buf.data();
        const size_t len = r->buf.size();
        size_t p = r->buf_pos;

        // locate the 4 line ends of the next record
        size_t nls[4];
        int got = 0;
        size_t q = p;
        for (; got < 4; got++) {
            const void* nl = std::memchr(b + q, '\n', len - q);
            if (!nl) break;
            nls[got] = (const uint8_t*)nl - b;
            q = nls[got] + 1;
        }
        if (got < 4) {
            if (!r->at_eof) {
                long n = fill_buf(r);
                if (n < 0) return -1;
                if (n > 0) continue;
            }
            // trailing data without a full record is silently dropped
            // (workhorse.c:1032-1034)
            break;
        }

        int rl = 0;
        size_t bs = 0;
        int64_t rls_longest = r->rls_longest;
        int ret = handle_record(r, b, p, nls, r->buf_offset,
                                r->rls, &rls_longest, &rl, &bs, &r->error);
        r->rls_longest = rls_longest;
        if (ret < 0) return -1;
        if (ret > 0 && rl > lmax) {
            // stride too small: un-count the histogram entry (the
            // record is fully re-parsed after the caller grows its
            // buffers via kvq_pending_rl) and leave buf_pos on it
            int hrl = rl < MAX_READLENGTH ? rl : MAX_READLENGTH - 1;
            r->rls[hrl]--;
            r->pending_rl = rl;
            *batch_maxrl = maxrl;
            return out > 0 ? out : -2;
        }
        r->records_parsed = r->records_parsed + 1;
        if (ret > 0) {
            uint8_t* rrow = raw + out * lmax;
            uint8_t* crow = codes + out * lmax;
            std::memcpy(rrow, b + bs, (size_t)rl);
            for (int i = 0; i < rl; i++) crow[i] = r->code_of[rrow[i]];
            rl_out[out] = rl;
            filepos[out] = r->buf_offset + (int64_t)bs;
            if (rl > maxrl) maxrl = rl;
            out++;
        }
        r->buf_pos = nls[3] + 1;
    }
    *batch_maxrl = maxrl;
    return out;
}

void kvq_close(Reader* r) {
    r->stopping = true;
    for (auto& w : r->workers) w.join();
    if (prof_enabled()) {
        const uint64_t trim = r->prof_trim.load(), sieve = r->prof_sieve.load();
        const uint64_t item = r->prof_item.load();
        std::fprintf(stderr,
                     "[kvarq-prof] cycles: fill=%.3g split=%.3g trim=%.3g "
                     "sieve=%.3g pack=%.3g item_other=%.3g inwait=%.3g "
                     "outwait=%.3g (records=%lld, threads=%d)\n",
                     (double)r->prof_fill.load(), (double)r->prof_split.load(),
                     (double)trim, (double)sieve, (double)r->prof_pack.load(),
                     (double)(item > trim + sieve ? item - trim - sieve : 0),
                     (double)r->prof_inwait.load(),
                     (double)r->prof_outwait.load(),
                     (long long)r->records_parsed, r->nthreads);
    }
    for (auto& kv : r->completed) delete kv.second;
    delete r->cur;
    for (auto& s : r->streams) close_stream(s);
#ifdef KVARQ_HAVE_MMAP
    // unmap LAST: in-flight WorkItems borrow spans from the mappings,
    // and the workers holding them were joined above
    for (auto& s : r->streams)
        if (s.map) {
            ::munmap((void*)s.map, s.map_size);
            s.map = nullptr;
        }
#endif
    delete r;
}

}  // extern "C"

// ---- standalone sieve microbenchmark ------------------------------------
// g++ -O3 -march=x86-64-v3 -DKVARQ_SIEVE_MAIN -pthread csrc/reader.cpp
//     -lz [-ldeflate -DKVARQ_USE_LIBDEFLATE] -o /tmp/sieve_bench
// Deterministic, single-threaded, in-process: times sieve_candidate_*
// over synthetic reads against a synthetic bank, isolated from stream /
// threading / scheduler noise (the A/B methodology the tuned sieve was
// validated with; ambient load makes end-to-end deltas <10% unmeasurable).
#ifdef KVARQ_SIEVE_MAIN
#include <algorithm>
#include <random>

static inline uint64_t sb_now() {
    unsigned lo, hi;
    __asm__ volatile("rdtsc" : "=a"(lo), "=d"(hi));
    return ((uint64_t)hi << 32) | lo;
}

int main(int argc, char** argv) {
    const int n_templates = argc > 1 ? std::atoi(argv[1]) : 264;
    const int n_reads = argc > 2 ? std::atoi(argv[2]) : 200000;
    const int rl = argc > 3 ? std::atoi(argv[3]) : 101;
    const int k = 8, t = 2, m = 25, e = 2;

    std::mt19937 rng(20260820);
    const char* B = "ACGT";

    // bank: random templates, ~75 bp, plus-strand only (the shape the
    // MTBC bench presents after flanking)
    std::vector<std::string> tmpl;
    for (int i = 0; i < n_templates; i++) {
        int L = 50 + (int)(rng() % 60);
        std::string s;
        for (int j = 0; j < L; j++) s += B[rng() % 4];
        tmpl.push_back(s);
    }
    // base-5 index exactly like kvarq_tpu.engine.sieve.KmerSieve.build
    int64_t p5k = 1;
    for (int i = 0; i < k; i++) p5k *= 5;
    std::vector<int32_t> start((size_t)p5k + 1, 0);
    std::vector<uint8_t> bank;
    std::vector<int32_t> tstart, tstop;
    std::vector<std::pair<int64_t, std::pair<int32_t, int32_t>>> entries;
    uint8_t code_of[256];
    std::memset(code_of, 5, sizeof(code_of));
    code_of['A'] = 0; code_of['C'] = 1; code_of['G'] = 2;
    code_of['T'] = 3; code_of['N'] = 4;
    for (size_t ti = 0; ti < tmpl.size(); ti++) {
        tstart.push_back((int32_t)bank.size());
        for (char c : tmpl[ti]) bank.push_back(code_of[(uint8_t)c]);
        tstop.push_back((int32_t)bank.size());
        for (int j = 0; j < k; j++) bank.push_back(5);
        const int32_t off = tstart.back();
        const std::string& s = tmpl[ti];
        for (size_t w = 0; w + k <= s.size(); w++) {
            int64_t code = 0;
            for (int j = 0; j < k; j++)
                code = code * 5 + code_of[(uint8_t)s[w + j]];
            entries.push_back({code, {(int32_t)(off + w), (int32_t)ti}});
        }
    }
    std::stable_sort(entries.begin(), entries.end(),
                     [](const auto& a, const auto& b)
                     { return a.first < b.first; });
    std::vector<int32_t> gpos, gtid;
    for (auto& en : entries) {
        start[en.first + 1]++;
        gpos.push_back(en.second.first);
        gtid.push_back(en.second.second);
    }
    for (int64_t c = 0; c < p5k; c++) start[c + 1] += start[c];

    Reader* r = kvq_open(nullptr, 0, 33, 25, 1, 0);
    kvq_set_sieve(r, start.data(), gpos.data(), gtid.data(),
                  tstart.data(), tstop.data(), bank.data(), k, t, m, e);

    // reads: random background + 3% planted template windows
    std::vector<uint8_t> reads((size_t)n_reads * rl);
    for (int i = 0; i < n_reads; i++) {
        uint8_t* rp = reads.data() + (size_t)i * rl;
        for (int j = 0; j < rl; j++) rp[j] = (uint8_t)B[rng() % 4];
        if (rng() % 100 < 3) {
            const std::string& s = tmpl[rng() % tmpl.size()];
            int n = (int)s.size() < rl ? (int)s.size() : rl;
            std::memcpy(rp, s.data(), n);
        }
    }

    if (argc > 4 && argv[4][0] == 'p') {
        // parse mode: time the process_item path (newline scan +
        // handle_record incl. trim + sieve) over an in-memory span
        std::vector<uint8_t> buf;
        for (int i = 0; i < n_reads; i++) {
            char hdr[32];
            int hn = std::snprintf(hdr, sizeof hdr, "@r%d\n", i);
            buf.insert(buf.end(), hdr, hdr + hn);
            const uint8_t* rp = reads.data() + (size_t)i * rl;
            buf.insert(buf.end(), rp, rp + rl);
            buf.push_back('\n'); buf.push_back('+'); buf.push_back('\n');
            for (int j = 0; j < rl; j++) buf.push_back('I');
            buf.push_back('\n');
        }
        for (int rep = 0; rep < 3; rep++) {
            WorkItem it;
            it.data = buf;
            const uint64_t t0 = sb_now();
            process_item(r, &it);
            const uint64_t dt = sb_now() - t0;
            std::printf("parse rep %d: %.0f cycles/record "
                        "(%lld records, %zu cands)\n", rep,
                        (double)dt / it.nrecords,
                        (long long)it.nrecords, it.cands.size());
        }
        kvq_close(r);
        return 0;
    }

    long cand = 0;
    for (int rep = 0; rep < 3; rep++) {
        cand = 0;
        const uint64_t t0 = sb_now();
        for (int i = 0; i < n_reads; i++)
            cand += (int)sieve_candidate_fast(
                r, reads.data() + (size_t)i * rl, rl);
        const uint64_t dt = sb_now() - t0;
        std::printf("rep %d: %.0f cycles/read (%ld candidates / %d)\n",
                    rep, (double)dt / n_reads, cand, n_reads);
    }
    kvq_close(r);
    return 0;
}
#endif  // KVARQ_SIEVE_MAIN

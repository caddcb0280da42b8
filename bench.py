#!/usr/bin/env python
'''
Benchmark: reads/second scanning a synthetic Illumina-like FastQ against
the full MTBC testsuites (phylo + resistance + spoligo, 132 templates x 2
strands), on the GPU.  It refuses to run without one.

Prints the device identity (JAX platform, device kind and count, host
cores, ``nvidia-smi`` name and power limit) to stderr, then ONE json line:
    {"metric": "scan_reads_per_s", "value": N, "unit": "reads/s",
     "runs": [...], "peak": P, "spread_pct": S, "device": {...}}

Every run is preceded by warmup scans of a prefix whose results are gated
bit-for-bit against the byte-exact numpy oracle (bench aborts on any
divergence).  No reference-relative figure is reported until the
reference C engine (tools/ref_bench.c) is measured on the GPU host.

Env knobs: KVARQ_BENCH_READS (default 2000000), KVARQ_BENCH_READLEN (101),
KVARQ_BENCH_WARMUP (1), KVARQ_BENCH_RUNS (5), KVARQ_BENCH_MODE (scan or
hits: the findseqs hit-list path), KVARQ_BENCH_PLANT (fraction of reads
drawn from template loci, 0.03), KVARQ_DRYRUN_REAL (1: also run the
mesh-sharded scan path on a one-device mesh and gate it against the
numpy oracle).
'''

import json
import os
import sys
import time

import numpy as np

HERE = os.path.abspath(os.path.dirname(__file__))
sys.path.insert(0, HERE)

# the bench measures the device scan path; never let the small-input
# numpy fast path absorb the (small) warmup scan
os.environ.setdefault('KVARQ_SMALL_SCAN', '0')

N_READS = int(os.environ.get('KVARQ_BENCH_READS', '2000000'))
READLEN = int(os.environ.get('KVARQ_BENCH_READLEN', '101'))
MUTRATE = 0.005         # per-base sequencing-error rate in planted reads
# fraction of reads drawn from template loci; raise for hit-dense
# corpora (e.g. KVARQ_BENCH_PLANT=0.5 with KVARQ_BENCH_MODE=hits)
PLANT_FRAC = float(os.environ.get('KVARQ_BENCH_PLANT', '0.03'))


def load_mtbc():
    from kvarq_tpu.log import set_warning
    set_warning()
    from kvarq_tpu.testsuites import discover_testsuites, load_testsuites
    paths = discover_testsuites([os.path.join(HERE, 'testsuites')])
    return load_testsuites(paths, ['MTBC'])


def template_windows(suites, spacing=25):
    from kvarq_tpu.analyse import Analyser
    analyser = Analyser()
    coverages = analyser.load_coverages(suites, spacing=spacing)
    return [c.plus_seq.bases for c in coverages.values()]


def generate_fastq(path, windows, n_reads, readlen, seed=20260817):
    ''' deterministic synthetic FastQ (vectorized): mostly random
        background plus a fraction of reads drawn from template loci with
        sequencing errors and occasional low-quality tails (exercises
        quality trimming) '''
    rng = np.random.RandomState(seed)
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    qhi, qlo = b'I'[0], b'#'[0]   # Q40 / Q2 (Sanger)

    reads = bases[rng.randint(4, size=(n_reads, readlen))]
    planted = np.flatnonzero(rng.rand(n_reads) < PLANT_FRAC) if windows \
        else np.array([], dtype=np.int64)
    for i in planted:
        w = windows[rng.randint(len(windows))].encode()
        if len(w) >= readlen:
            off = rng.randint(len(w) - readlen + 1)
            reads[i] = np.frombuffer(w[off:off + readlen], np.uint8)
        else:
            off = rng.randint(readlen - len(w) + 1)
            reads[i, off:off + len(w)] = np.frombuffer(w, np.uint8)
        errs = np.flatnonzero(rng.rand(readlen) < MUTRATE)
        reads[i, errs] = bases[rng.randint(4, size=len(errs))]

    quals = np.full((n_reads, readlen), qhi, dtype=np.uint8)
    tailed = np.flatnonzero(rng.rand(n_reads) < 0.1)
    tails = rng.randint(1, readlen // 2, size=len(tailed))
    col = np.arange(readlen)
    quals[tailed] = np.where(col >= readlen - tails[:, None], qlo,
                             quals[tailed])

    nl = np.uint8(ord('\n'))
    with open(path, 'wb') as f:
        for lo_ in range(0, n_reads, 65536):
            hi = min(n_reads, lo_ + 65536)
            parts = []
            for i in range(lo_, hi):
                parts.append(b'@r%d\n' % i)
                parts.append(reads[i].tobytes())
                parts.append(b'\n+\n')
                parts.append(quals[i].tobytes())
                parts.append(b'\n')
            f.write(b''.join(parts))


def bench_path(tag):
    plant = '' if PLANT_FRAC == 0.03 else '_p%g' % PLANT_FRAC
    import tempfile
    return os.path.join(
        tempfile.gettempdir(), 'kvarq_bench_%s_%dx%d%s.fastq'
        % (tag, N_READS, READLEN, plant))


def oracle_basecounts(found, seqs):
    ''' rebuild per-strand [5, S] base counts from a findseqs hit list
        (the numpy oracle's output) -- the exact quantity countseqs
        accumulates on device (non-AGCTN read bytes are dropped,
        matching the device path's 5-channel one-hot) '''
    from kvarq_tpu.engine import encode
    counts = [np.zeros((encode.NBASE, len(s)), np.int64) for s in seqs]
    for hit, hitseq in zip(found['hits'], found['hitseqs']):
        start = max(0, hit.seq_pos)
        codes = encode.encode_read(hitseq.encode('latin-1'))
        pos = start + np.arange(len(codes))
        valid = codes < encode.NBASE
        np.add.at(counts[hit.seq_nr], (codes[valid], pos[valid]), 1)
    return counts


def assert_device_matches_oracle(device_ret, path, seqs, found=None):
    ''' compare a countseqs() result against the byte-exact numpy golden
        matcher on the same input; abort the bench on ANY divergence.
        :returns: the oracle findseqs result (pure in (path, seqs)), so
        repeated gates over the same input can reuse it via ``found`` '''
    from kvarq_tpu import engine

    if found is None:
        engine.config(backend='numpy', sieve='off')
        try:
            found = engine.findseqs(path, seqs)
        finally:
            engine.config(
                backend=os.environ.get('KVARQ_BACKEND', 'auto'),
                sieve=os.environ.get('KVARQ_SIEVE', 'auto'))

    dev, ora = device_ret['stats'], found['stats']
    for key in ('nseqhits', 'nseqbasehits', 'records_parsed'):
        if dev[key] != ora[key]:
            raise SystemExit('BIT-EXACTNESS FAILURE: stats[%r] device=%r '
                             'oracle=%r' % (key, dev[key], ora[key]))
    want = oracle_basecounts(found, seqs)
    for t, (got, exp) in enumerate(zip(device_ret['basecounts'], want)):
        if not np.array_equal(np.asarray(got, np.int64), exp):
            raise SystemExit('BIT-EXACTNESS FAILURE: basecounts[%d] '
                             '(template %r...) differ' % (t, seqs[t][:20]))
    total = int(np.asarray(dev['nseqhits']).sum())
    print('bit-exactness vs numpy oracle: OK (%d hits, %d templates)'
          % (total, len(seqs)), file=sys.stderr)
    return found


def sharded_dryrun_gate(wpath, seqs, found=None):
    ''' scan the warmup prefix through ShardedScanner on a real-device
        1x1 mesh (candidate-screen step under shard_map) and gate the
        result against the numpy oracle (``found`` reuses a previously
        computed oracle result for the same input) '''
    import jax
    from kvarq_tpu.parallel import make_mesh, ShardedScanner
    from kvarq_tpu.engine import reader

    t0 = time.time()
    mesh = make_mesh(1, 1, jax.devices()[:1])
    scanner = ShardedScanner(seqs, maxerrors=2, minoverlap=25, mesh=mesh)
    stats = reader.ReaderStats()
    for batch in reader.prefetch(reader.batches(
            [wpath], 33 + 13, 25, stats, batchsize=16384, nthreads=2)):
        scanner.scan_batch(batch)
    scanner.finalize()
    ret = {
        'basecounts': [bc.astype(np.int64) for bc in scanner.coverages()],
        'stats': {
            'nseqhits': tuple(int(x) for x in scanner.seqhits),
            'nseqbasehits': tuple(int(x) for x in scanner.seqbasehits),
            'records_parsed': int(stats.records_parsed),
        },
    }
    print('sharded (mesh) scan on real device: %.1fs, backend=%s'
          % (time.time() - t0, scanner.backend), file=sys.stderr)
    assert_device_matches_oracle(ret, wpath, seqs, found=found)


def device_identity():
    ''' the GPU this bench runs on; raises (never falls back to the
        CPU) when JAX finds none '''
    import subprocess
    from kvarq_tpu.device import require_gpu
    devices = require_gpu()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    ident = dict(platform=devices[0].platform,
                 kind=devices[0].device_kind, count=len(devices),
                 host_cpus=os.cpu_count(),
                 nvidia_smi=smi.strip().splitlines())
    print('device: %s' % json.dumps(ident), file=sys.stderr)
    return ident


def main():
    from kvarq_tpu import engine

    ident = device_identity()
    suites = load_mtbc()
    windows = template_windows(suites)

    path = bench_path('mtbc')
    if not os.path.exists(path):
        t0 = time.time()
        generate_fastq(path, windows, N_READS, READLEN)
        print('generated %s in %.1fs' % (path, time.time() - t0),
              file=sys.stderr)

    from kvarq_tpu.analyse import Analyser

    seqs = None
    # build the template sequence list exactly like Analyser.scan does
    analyser = Analyser()
    coverages = analyser.load_coverages(suites, spacing=analyser.spacing)
    seqs = [c.plus_seq.bases for c in coverages.values()]
    seqs += [c.minus_seq.bases for c in coverages.values()]

    engine.config(maxerrors=2, minoverlap=25, minreadlength=25,
                  nthreads=8, Amin=chr(33 + 13))  # CLI defaults (config.py)

    if int(os.environ.get('KVARQ_BENCH_WARMUP', '1')):
        # warm the jit caches on a small prefix so compile time is excluded
        wpath = bench_path('warmup')
        if not os.path.exists(wpath):
            with open(path) as f, open(wpath, 'w') as g:
                for _ in range(4 * 2048):
                    line = f.readline()
                    if not line:
                        break
                    g.write(line)

        # cold/warm visibility: how many entries the persistent
        # compilation cache held before the first scan
        from kvarq_tpu.jaxutil import cache_dir, ensure_compilation_cache
        ensure_compilation_cache()
        path_c = cache_dir()
        n_cached = len([f for f in os.listdir(path_c)
                        if f.endswith('-cache')]) \
            if os.path.isdir(path_c) else 0
        if os.environ.get('KVARQ_BENCH_MODE', 'scan') == 'hits':
            # hit-path warmup + exactness gate: the device matcher must
            # reproduce the numpy oracle's hit list on the prefix
            t0 = time.time()
            warm = engine.findseqs(wpath, seqs)
            print('hit-path warmup (incl. compile): %.1fs'
                  % (time.time() - t0), file=sys.stderr)
            engine.config(backend='numpy', sieve='off')
            try:
                ora = engine.findseqs(wpath, seqs)
            finally:
                engine.config(
                    backend=os.environ.get('KVARQ_BACKEND', 'auto'),
                    sieve=os.environ.get('KVARQ_SIEVE', 'auto'))
            if list(warm['hits']) != list(ora['hits']):
                raise SystemExit('BIT-EXACTNESS FAILURE: hit lists '
                                 'differ (%d vs %d hits)'
                                 % (len(warm['hits']), len(ora['hits'])))
            print('hit-list exactness vs numpy oracle: OK (%d hits)'
                  % len(ora['hits']), file=sys.stderr)
        else:
            t0 = time.time()
            warm = engine.countseqs(wpath, seqs)
            print('cold-start warmup (incl. compile; persistent cache '
                  'held %d entries): %.1fs' % (n_cached, time.time() - t0),
                  file=sys.stderr)
            t0 = time.time()
            engine.countseqs(wpath, seqs)
            print('warm re-scan of the same prefix: %.1fs'
                  % (time.time() - t0), file=sys.stderr)
            # bit-exactness gate: the device path must reproduce the
            # numpy oracle exactly on the warmup prefix -- a miscounting
            # kernel must fail the bench, not ship a wrong perf number
            oracle = assert_device_matches_oracle(warm, wpath, seqs)

        if (os.environ.get('KVARQ_BENCH_MODE', 'scan') != 'hits'
                and int(os.environ.get('KVARQ_DRYRUN_REAL', '1'))):
            # the mesh-sharded scan path (shard_map + psum + the
            # candidate-screen step) must ALSO run on the real device
            # and reproduce the oracle (1x1 mesh; multi-device topology
            # is validated on the virtual CPU mesh and chip_smoke.py
            # --four)
            sharded_dryrun_gate(wpath, seqs, found=oracle)

    # report the median of KVARQ_BENCH_RUNS runs as the headline with
    # full dispersion alongside.  KVARQ_BENCH_MODE=hits measures the findseqs (-H/-x hit-list) path
    # instead of the tensorized countseqs path; combine with
    # KVARQ_BENCH_PLANT for hit-dense corpora.
    mode = os.environ.get('KVARQ_BENCH_MODE', 'scan')
    runs = int(os.environ.get('KVARQ_BENCH_RUNS', '5'))
    samples = []
    for _ in range(max(1, runs)):
        t0 = time.time()
        if mode == 'hits':
            ret = engine.findseqs(path, seqs)
            nhits = len(ret['hits'])
        else:
            ret = engine.countseqs(path, seqs)
            nhits = int(np.asarray(ret['stats']['nseqhits']).sum())
        dt = time.time() - t0
        nrec = ret['stats']['records_parsed']
        print('scanned %d records in %.2fs (%d template hits)'
              % (nrec, dt, nhits), file=sys.stderr)
        samples.append(nrec / dt)

    samples.sort()
    rps = float(np.median(samples))
    print(json.dumps({
        'metric': 'scan_reads_per_s' if mode != 'hits'
                  else 'findseqs_reads_per_s',
        'value': round(rps, 1),
        'unit': 'reads/s',
        'runs': [round(s, 1) for s in samples],
        'peak': round(samples[-1], 1),
        'spread_pct': round(100.0 * (samples[-1] - samples[0])
                            / max(rps, 1e-9), 1),
        'device': ident,
    }))


if __name__ == '__main__':
    main()

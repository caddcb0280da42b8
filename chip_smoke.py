#!/usr/bin/env python
'''
End-to-end smoke run of the MTBC scan on a GPU, at full size, through the
entry points a user calls (the ``kvarq`` CLI, ``engine.countseqs``,
``engine.findseqs``).  Every result is integer counts, compared bitwise.

    python chip_smoke.py            # one GPU, phases 1-6
    python chip_smoke.py --four     # four GPUs: the mesh and batch paths
                                    # only, each against one GPU

Phases, one line each (``--four`` runs 1 and the mesh phase):

1. device: platform, kind, count, host cores, ``nvidia-smi`` name and
   power limit; the native reader must load
2. golden CLI scan of tests/fastqs/L3_N1014_hits_5k.fastq, default and
   ``-H``, against the known calls
3. whole-sample scan, 1,048,576 reads at 101 bp: countseqs with the sieve
   on (dense step) and off (candidate screen), and findseqs, agree
   bitwise; all three equal the numpy oracle on a 65,536-read prefix
4. the same at 150 bp (262,144 reads, Lpad 192), oracle on 32,768 reads
5. compiled memory of the dense and screened steps at 16,384 reads
6. the tests marked ``gpu``, in this process

The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``; any failure exits non-zero before it.
Without a GPU the script exits non-zero at phase 1.
'''

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
TESTSUITES = os.path.join(HERE, 'testsuites')
GOLDEN_FASTQ = os.path.join(HERE, 'tests', 'fastqs', 'L3_N1014_hits_5k.fastq')
GOLDEN = [
    'lineage 3',
    'Streptomycin resistance::SNP781687AG=rpsL.K43R',
    'Rifampicin resistance (RRDR) [761139CG=rpoB.H445D 761140AG=rpoB.H445R]',
    '703777740003771',
]
# the CLI defaults (kvarq_tpu.config): e=2, o=25, r=25, Q13, 8 threads
CONFIG = dict(maxerrors=2, minoverlap=25, minreadlength=25, nthreads=8,
              Amin=chr(33 + 13))
SEED = 20260817
SUB = 16384


def say(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


def nvidia_smi():
    ''' the card lines of ``nvidia-smi --query-gpu=name,power.limit`` '''
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout


# --- engine bookkeeping -------------------------------------------------------

class EngineLog:
    ''' records the scanner/matcher objects the engine builds, so each
        phase can say which engine ran (and prove no numpy detour did) '''

    def __init__(self):
        from kvarq_tpu import engine
        self.used = []
        for name in ('_make_scanner', '_make_matcher'):
            setattr(engine, name, self._recording(getattr(engine, name)))

    def _recording(self, fn):
        def wrapper(*args, **kwargs):
            obj = fn(*args, **kwargs)
            self.used.append(obj)
            return obj
        return wrapper

    def take(self):
        ''' describe and forget the engines used since the last call '''
        used, self.used = self.used, []
        desc = []
        for obj in used:
            name = type(obj).__name__
            if name == 'NumpyMatcher':
                raise AssertionError('the scan ran through the numpy matcher')
            extra = []
            if hasattr(obj, 'backend'):
                extra.append('backend=%s' % obj.backend)
            if hasattr(obj, 'gather_k'):
                extra.append('gather_k=%s' % obj.gather_k)
            if hasattr(obj, 'mesh'):
                extra.append('mesh=%s' % dict(obj.mesh.shape))
            if getattr(obj, 'dense', False):
                extra.append('dense')
            desc.append('%s(%s)' % (name, ', '.join(extra)))
        return ' + '.join(desc)


def mtbc():
    ''' (seqs, windows): plus+minus template strands of the full MTBC
        testsuites, as Analyser.scan builds them, and the plus strands
        the synthetic reads are planted from '''
    import bench
    from kvarq_tpu.analyse import Analyser
    suites = bench.load_mtbc()
    analyser = Analyser()
    coverages = analyser.load_coverages(suites, spacing=analyser.spacing)
    plus = [c.plus_seq.bases for c in coverages.values()]
    return plus + [c.minus_seq.bases for c in coverages.values()], plus


def write_prefix(path, n_reads, out):
    with open(path, 'rb') as f, open(out, 'wb') as g:
        for _ in range(4 * n_reads):
            g.write(f.readline())
    return out


def equal_results(a, b, what):
    ''' bitwise equality of two (basecounts, stats) results '''
    import numpy as np
    bca, sta = a
    bcb, stb = b
    if len(bca) != len(bcb):
        raise AssertionError('%s: %d vs %d templates'
                             % (what, len(bca), len(bcb)))
    for t, (x, y) in enumerate(zip(bca, bcb)):
        if not np.array_equal(np.asarray(x, np.int64),
                              np.asarray(y, np.int64)):
            raise AssertionError('%s: basecounts of template %d differ'
                                 % (what, t))
    if dict(sta) != dict(stb):
        keys = sorted(k for k in set(sta) | set(stb)
                      if sta.get(k) != stb.get(k))
        raise AssertionError('%s: stats differ in %s' % (what, keys))


def scan(path, seqs, how, log, mesh=''):
    ''' one scan through the engine API: ``how`` is ``sieve`` / ``nosieve``
        (countseqs) or ``hits`` (findseqs).  :returns: ((basecounts,
        stats), seconds, engines used, raw result) '''
    from kvarq_tpu import engine
    engine.config(backend='auto', mesh=mesh,
                  sieve='off' if how == 'nosieve' else 'auto')
    t0 = time.time()
    if how == 'hits':
        ret = engine.findseqs(path, seqs)
        bcs = engine._basecounts_from_hits(ret['hits'], ret['hitseqs'],
                                           seqs)
    else:
        ret = engine.countseqs(path, seqs)
        bcs = ret['basecounts']
    dt = time.time() - t0
    return (bcs, ret['stats']), dt, log.take(), ret


# --- the numpy oracle, fanned out over host cores -----------------------------

def _oracle_chunk(args):
    ''' worker: the byte-exact numpy hit path on one chunk file (never
        touches JAX) '''
    path, seqs = args
    from kvarq_tpu import engine
    engine.config(**dict(CONFIG, nthreads=1), backend='numpy', sieve='off')
    ret = engine.findseqs(path, seqs)
    return (engine._basecounts_from_hits(ret['hits'], ret['hitseqs'], seqs),
            ret['stats'])


def oracle(path, seqs, n_reads, tmp):
    ''' numpy oracle result for the first ``n_reads`` reads of ``path``:
        the prefix is split into record-aligned chunks, scanned in a
        process pool, and the per-chunk counts summed '''
    import multiprocessing
    import numpy as np
    workers = max(1, min(16, os.cpu_count() or 1))
    per = -(-n_reads // workers)
    chunks = []
    with open(path, 'rb') as f:
        for i in range(workers):
            out = os.path.join(tmp, 'oracle_%d.fastq' % i)
            with open(out, 'wb') as g:
                for _ in range(4 * min(per, n_reads - i * per)):
                    g.write(f.readline())
            chunks.append((out, seqs))
    ctx = multiprocessing.get_context('spawn')
    with ctx.Pool(workers) as pool:
        parts = pool.map(_oracle_chunk, chunks)
    bcs = [sum(p[0][t] for p in parts) for t in range(len(seqs))]
    stats = {}
    for key in ('nseqhits', 'nseqbasehits'):
        stats[key] = tuple(int(x) for x in
                           np.sum([p[1][key] for p in parts], axis=0))
    for key in ('parsed', 'total', 'records_parsed', 'sigints'):
        stats[key] = sum(p[1][key] for p in parts)
    n = max(len(p[1]['readlengths']) for p in parts)
    rls = np.zeros(n, np.int64)
    for p in parts:
        rls[:len(p[1]['readlengths'])] += p[1]['readlengths']
    stats['readlengths'] = tuple(int(x) for x in rls)
    stats['progress'] = 1.0
    return bcs, stats


# --- phases -------------------------------------------------------------------

def phase_device(n_expected):
    import jax
    from kvarq_tpu.device import require_gpu
    from kvarq_tpu.engine import native
    devices = require_gpu()
    if len(devices) < n_expected:
        raise AssertionError('need %d GPUs, JAX found %d'
                             % (n_expected, len(devices)))
    if not native.available():
        raise AssertionError('the native reader did not load (numpy '
                             'pipeline fallback)')
    smi = nvidia_smi()
    say(1, 'device: platform=%s kind=%s count=%d host_cpus=%d jax=%s '
           'native_reader=loaded'
        % (devices[0].platform, devices[0].device_kind, len(devices),
           os.cpu_count(), jax.__version__))
    for line in smi.strip().splitlines():
        print(line.strip(), flush=True)
    return devices


def run_cli(argv):
    ''' kvarq_tpu.cli.main in this process; :returns: its stdout '''
    from kvarq_tpu import cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            cli.main(argv)
        except SystemExit as e:
            if e.code not in (0, None):
                raise AssertionError('kvarq %s exited %r'
                                     % (' '.join(argv), e.code))
    return out.getvalue()


def phase_golden(tmp, log):
    results = {}
    times = {}
    for name, extra in (('default', []), ('-H', ['-H'])):
        out = os.path.join(tmp, 'golden%s.json' % name)
        t0 = time.time()
        run_cli(['-t', TESTSUITES, 'scan', '-f', '-l', 'MTBC'] + extra
                + [GOLDEN_FASTQ, out])
        times[name] = '%s %.1fs' % (log.take(), time.time() - t0)
        with open(out) as fd:
            results[name] = json.load(fd)
        if name == 'default':
            text = run_cli(['illustrate', '-r', out])
            missing = [g for g in GOLDEN if g not in text]
            if missing:
                raise AssertionError('golden calls missing: %r' % missing)
    for key in ('analyses', 'coverages', 'stats'):
        if results['default'][key] != results['-H'][key]:
            raise AssertionError('scan and scan -H differ in %r' % key)
    say(2, 'golden CLI scan: calls OK, -H equal; cold (incl. compile): '
           'scan=%s; scan -H=%s' % (times['default'], times['-H']))


def three_way(phase, seqs, windows, tmp, log, n_reads, readlen, n_oracle,
              expect_backend='screen'):
    ''' countseqs (sieve on / off) and findseqs on ``n_reads`` seeded
        reads agree bitwise; on an ``n_oracle`` prefix all three equal
        the numpy oracle '''
    import bench
    path = os.path.join(tmp, 'sample_%d.fastq' % readlen)
    t0 = time.time()
    bench.generate_fastq(path, windows, n_reads, readlen, seed=SEED)
    gen = time.time() - t0
    prefix = write_prefix(path, n_oracle,
                          os.path.join(tmp, 'prefix_%d.fastq' % readlen))
    t0 = time.time()
    want = oracle(prefix, seqs, n_oracle, tmp)
    t_oracle = time.time() - t0

    report = []
    for label, p in (('full', path), ('prefix', prefix)):
        runs = {}
        for how in ('sieve', 'nosieve', 'hits'):
            res, dt, used, _ = scan(p, seqs, how, log)
            if how != 'hits' and ('backend=%s' % expect_backend) not in used:
                raise AssertionError('%s ran %s, not the %s step'
                                     % (how, used, expect_backend))
            runs[how] = res
            if label == 'full':
                report.append('%s=%s %.1fs' % (how, used, dt))
        equal_results(runs['sieve'], runs['nosieve'],
                      '%s: sieve vs no sieve' % label)
        equal_results(runs['sieve'], runs['hits'],
                      '%s: countseqs vs findseqs' % label)
        if label == 'prefix':
            equal_results(runs['sieve'], want, 'prefix: device vs oracle')
        else:
            nhits = int(sum(res[1]['nseqhits']))
    say(phase, '%d reads x %d bp (generated in %.1fs): 3 runs bitwise '
               'equal, %d template hits; oracle on %d reads equal (%.1fs); '
               'cold (incl. compile): %s'
        % (n_reads, readlen, gen, nhits, n_oracle, t_oracle,
           '; '.join(report)))


def phase_memory(seqs):
    import jax
    import jax.numpy as jnp
    from kvarq_tpu.engine import screen_scan
    from kvarq_tpu.engine.tensor_scan import build_bank
    lines = []
    for Lpad in (128, 192):
        bank = build_bank(seqs, Lpad, CONFIG['minoverlap'])
        arrays = screen_scan.device_arrays(bank)
        for name, gather_k in (('dense', 0), ('screen', 768)):
            step = screen_scan.scan_step(
                Lpad, bank, len(seqs), CONFIG['maxerrors'],
                CONFIG['minoverlap'], SUB, gather_k=gather_k)
            lowered = jax.jit(step).lower(
                jax.ShapeDtypeStruct((SUB, Lpad), jnp.uint8),
                jax.ShapeDtypeStruct((SUB,), jnp.int32),
                arrays['K'], arrays['qmeta'])
            t0 = time.time()
            compiled = lowered.compile()
            dt = time.time() - t0
            mem = compiled.memory_analysis()
            lines.append(
                'Lpad %d %s (G=%d Q=%d): temp=%d argument=%d output=%d '
                'code=%d bytes, compile %.1fs' % (
                    Lpad, name, bank.G, bank.Q, mem.temp_size_in_bytes,
                    mem.argument_size_in_bytes, mem.output_size_in_bytes,
                    mem.generated_code_size_in_bytes, dt))
    say(5, 'memory_analysis at %d reads: %s' % (SUB, '; '.join(lines)))


def phase_gpu_tests():
    import pytest
    os.environ['KVARQ_TEST_GPU'] = '1'
    rc = pytest.main(['-q', '-m', 'gpu', '-p', 'no:cacheprovider',
                      '-p', 'no:randomly',
                      os.path.join(HERE, 'tests', 'test_gpu_smoke.py')])
    if rc != 0:
        raise AssertionError('tests marked gpu failed (pytest exit %s)' % rc)
    say(6, 'tests marked gpu: passed')


def phase_four(seqs, windows, tmp, log, suites, n_reads=1 << 20,
               n_batch=1 << 18):
    ''' the mesh and batch paths on four GPUs, each bitwise equal to the
        same scan on one GPU in this process: ``n_reads`` for the mesh
        scans, four files of ``n_batch`` for ``kvarq batch`` '''
    import bench
    import numpy as np
    path = os.path.join(tmp, 'sample_101.fastq')
    bench.generate_fastq(path, windows, n_reads, 101, seed=SEED)
    lines = []
    one = {}
    for how in ('sieve', 'nosieve', 'hits'):
        res, dt, used, raw = scan(path, seqs, how, log)
        one[how] = (res, raw)
        lines.append('1 GPU %s: %s %.1fs' % (how, used, dt))
    for mesh in ('4x1', '2x2'):
        for how in ('sieve', 'nosieve'):
            res, dt, used, _ = scan(path, seqs, how, log, mesh=mesh)
            equal_results(res, one[how][0], 'mesh %s %s' % (mesh, how))
            lines.append('mesh %s %s: %s %.1fs' % (mesh, how, used, dt))
    res, dt, used, raw = scan(path, seqs, 'hits', log, mesh='auto')
    ref = one['hits'][1]
    if list(raw['hits']) != list(ref['hits']) \
            or raw['hitseqs'] != ref['hitseqs']:
        raise AssertionError('mesh auto -H: hit lists differ')
    equal_results(res, one['hits'][0], 'mesh auto -H')
    lines.append('mesh auto -H: %s %.1fs, %d hits'
                 % (used, dt, len(raw['hits'])))

    # kvarq batch of four seeded files, one process over all four GPUs,
    # against countseqs of the same files on one GPU
    files = []
    for i in range(4):
        f = os.path.join(tmp, 'batch_%d.fastq' % i)
        bench.generate_fastq(f, windows, n_batch, 101, seed=SEED + 1 + i)
        files.append(f)
    out = os.path.join(tmp, 'batch.json')
    t0 = time.time()
    run_cli(['-t', TESTSUITES, 'batch', '-f', '-l', 'MTBC'] + files + [out])
    dt = time.time() - t0
    with open(out) as fd:
        got = json.load(fd)
    (bcs, stats), _, used, _ = scan(files, seqs, 'sieve', log)
    want = batch_json(suites, bcs, stats)
    for key in ('analyses', 'coverages'):
        if got[key] != want[key]:
            raise AssertionError('batch: %r differs from one GPU' % key)
    for key in ('nseqhits', 'nseqbasehits', 'records_parsed',
                'readlengths', 'parsed'):
        if got['stats'][key] != json.loads(json.dumps(stats[key])):
            raise AssertionError('batch: stats[%r] differs from one GPU'
                                 % key)
    lines.append('batch of 4 files (%d records): %.1fs, equal to 1 GPU %s'
                 % (got['stats']['records_parsed'], dt, used))
    assert np.sum(got['stats']['nseqhits']) > 0
    say('four', 'all mesh and batch runs bitwise equal to one GPU: '
        + '; '.join(lines))


def batch_json(suites, bcs, stats):
    ''' the result json ``kvarq batch`` writes, built from a one-device
        countseqs result the way cmd_batch folds its own '''
    from kvarq_tpu import analyse
    from kvarq_tpu.engine.tensor_scan import fold_into_coverage
    analyser = analyse.Analyser()
    analyser.testsuites = suites
    analyser.coverages = analyser.load_coverages(suites,
                                                 spacing=analyser.spacing)
    n = len(analyser.coverages)
    for i, coverage in enumerate(analyser.coverages.values()):
        fold_into_coverage(coverage, bcs[i], bcs[n + i])
    analyser.stats = stats
    analyser.update_testsuites()
    enc = analyser.encode()
    return json.loads(json.dumps(dict(analyses=enc['analyses'],
                                      coverages=enc['coverages'])))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--four', action='store_true',
                    help='run only the four-GPU mesh and batch phase')
    args = ap.parse_args(argv)

    # the small-input numpy detour must not absorb any scan here
    os.environ['KVARQ_SMALL_SCAN'] = '0'
    sys.path.insert(0, HERE)
    n_dev = 4 if args.four else 1
    devices = phase_device(n_dev)

    from kvarq_tpu import engine
    from kvarq_tpu.log import set_warning
    set_warning()
    log = EngineLog()
    engine.config(**CONFIG)
    seqs, windows = mtbc()
    tmp = tempfile.mkdtemp(prefix='kvarq_chip_smoke_')
    try:
        if args.four:
            import bench
            phase_four(seqs, windows, tmp, log, bench.load_mtbc())
        else:
            phase_golden(tmp, log)
            engine.config(**CONFIG)
            three_way(3, seqs, windows, tmp, log, 1 << 20, 101, 1 << 16)
            three_way(4, seqs, windows, tmp, log, 1 << 18, 150, 1 << 15)
            phase_memory(seqs)
            phase_gpu_tests()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(devices)}}), flush=True)


if __name__ == '__main__':
    main()

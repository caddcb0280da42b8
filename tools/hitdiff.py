#!/usr/bin/env python
'''
Hit-level differential harness: diffs the FULL hit-tuple stream
``(seq_nr, file_pos, seq_pos, length, readlength)`` of
``engine.findseqs`` against ``tools/ref_bench.c`` (the faithful C
reimplementation of the reference hot loop, workhorse.c:976-1197) --
byte-for-byte, not just total counts, so a compensating-error pair
cannot hide.

Covers the checked-in fixtures plus randomized corpora engineered to
exercise all 4 overlap modes (reads shorter/longer than templates,
planted mutations 0-3, low-quality tails), swept over maxerrors 0-3 and
several minoverlap values.

Usage: python tools/hitdiff.py [--quick] [--backend numpy|xla|screen]
Exit 0 = every stream identical; a nonempty diff aborts with context.

Also importable: ``run_case()`` / ``build_ref_bench()`` are used by
tests/test_hitdiff.py (the CI gate).
'''

import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.abspath(os.path.dirname(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)


def build_ref_bench(outdir):
    ''' compile ref_bench.c; returns the binary path or None if no
        C compiler is available '''
    binpath = os.path.join(outdir, 'ref_bench')
    src = os.path.join(HERE, 'ref_bench.c')
    for cc in ('cc', 'gcc', 'clang'):
        try:
            subprocess.run([cc, '-O2', '-o', binpath, src, '-lpthread'],
                           check=True, capture_output=True)
            return binpath
        except (OSError, subprocess.CalledProcessError):
            continue
    return None


def ref_hits(binpath, fastq, seqs, amin, maxerrors, minoverlap,
             minreadlength, workdir):
    ''' run ref_bench with the hit dump; returns the list of tuple lines '''
    tpl = os.path.join(workdir, 'templates.txt')
    with open(tpl, 'w') as f:
        f.write('\n'.join(seqs) + '\n')
    dump = os.path.join(workdir, 'hits.txt')
    subprocess.run(
        [binpath, fastq, tpl, str(amin), str(maxerrors), str(minoverlap),
         str(minreadlength), '1', dump],
        check=True, capture_output=True)
    with open(dump) as f:
        return f.read().splitlines()


def engine_hits(fastq, seqs, amin, maxerrors, minoverlap, minreadlength,
                backend='numpy'):
    ''' run engine.findseqs; returns hit-tuple lines in the same format '''
    from kvarq_tpu import engine
    engine.config(maxerrors=maxerrors, minoverlap=minoverlap,
                  minreadlength=minreadlength, nthreads=2,
                  Amin=chr(amin), backend=backend)
    found = engine.findseqs(fastq, seqs)
    return ['%d %d %d %d %d' % h for h in found['hits']]


def run_case(binpath, fastq, seqs, amin, maxerrors, minoverlap,
             minreadlength, workdir, backend='numpy'):
    ''' diff the two hit streams; raises AssertionError with context '''
    ref = ref_hits(binpath, fastq, seqs, amin, maxerrors, minoverlap,
                   minreadlength, workdir)
    got = engine_hits(fastq, seqs, amin, maxerrors, minoverlap,
                      minreadlength, backend)
    if ref != got:
        n = min(len(ref), len(got))
        first = next((i for i in range(n) if ref[i] != got[i]), n)
        ctx = '\n'.join(
            '  ref=%-30s got=%s' % (ref[i] if i < len(ref) else '<end>',
                                    got[i] if i < len(got) else '<end>')
            for i in range(max(0, first - 2), min(first + 3,
                                                  max(len(ref), len(got)))))
        raise AssertionError(
            'hit streams differ (%s e=%d o=%d r=%d): %d vs %d hits, '
            'first divergence at %d:\n%s'
            % (os.path.basename(fastq), maxerrors, minoverlap,
               minreadlength, len(ref), len(got), first, ctx))
    return len(ref)


def random_corpus(path, seqs, n_reads, seed, with_n=False):
    ''' randomized FastQ engineered to hit all 4 overlap modes: reads of
        varying length (some shorter than the shortest template, some
        longer than the longest), template substrings planted at the
        read head/tail/middle with 0-3 mutations, plus background junk
        and low-quality segments '''
    rng = np.random.RandomState(seed)
    alphabet = b'ACGTN' if with_n else b'ACGT'
    bases = np.frombuffer(alphabet, dtype=np.uint8)
    lines = []
    for i in range(n_reads):
        rl = int(rng.randint(12, 160))
        read = bases[rng.randint(len(bases), size=rl)]
        if rng.rand() < 0.7:
            w = seqs[rng.randint(len(seqs))].encode()
            nmut = int(rng.randint(0, 4))
            frag = np.frombuffer(w, np.uint8).copy()
            if nmut:
                pos = rng.choice(len(frag), size=min(nmut, len(frag)),
                                 replace=False)
                frag[pos] = bases[rng.randint(len(bases), size=len(pos))]
            mode = rng.randint(4)
            if mode == 0 and rl > 1:           # template tail at read head
                k = min(rl, len(frag), 1 + rng.randint(len(frag)))
                read[:k] = frag[len(frag) - k:]
            elif mode == 1 and rl > 1:         # template head at read tail
                k = min(rl, len(frag), 1 + rng.randint(len(frag)))
                read[rl - k:] = frag[:k]
            elif mode == 2 and rl > len(frag):  # template inside read
                off = rng.randint(rl - len(frag) + 1)
                read[off:off + len(frag)] = frag
            else:                               # read inside template
                if len(frag) >= rl:
                    off = rng.randint(len(frag) - rl + 1)
                    read[:] = frag[off:off + rl]
                else:
                    read[:len(frag)] = frag
        qual = np.full(rl, b'I'[0], dtype=np.uint8)
        r = rng.rand()
        if r < 0.15:      # low-quality tail
            qual[rl - rng.randint(1, max(2, rl // 2)):] = b'#'[0]
        elif r < 0.25:    # low-quality head (shifts the trim window)
            qual[:rng.randint(1, max(2, rl // 2))] = b'#'[0]
        elif r < 0.30:    # interior low-quality island (two runs, tie
            p = rng.randint(rl)            # cases for first-longest-run)
            qual[p:p + 1] = b'#'[0]
        lines.append(b'@r%d\n%s\n+\n%s\n'
                     % (i, read.tobytes(), qual.tobytes()))
    with open(path, 'wb') as f:
        f.write(b''.join(lines))


def random_templates(rng, n, lmin=15, lmax=200):
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    return [bytes(bases[rng.randint(4, size=rng.randint(lmin, lmax))])
            .decode() for _ in range(n)]


def main():
    quick = '--quick' in sys.argv
    backend = 'numpy'
    if '--backend' in sys.argv:
        backend = sys.argv[sys.argv.index('--backend') + 1]

    from kvarq_tpu.log import set_warning
    set_warning()

    with tempfile.TemporaryDirectory() as tmp:
        binpath = build_ref_bench(tmp)
        if binpath is None:
            print('no C compiler available', file=sys.stderr)
            return 1

        total = 0
        # 1. the handwritten engine fixture with its quirky templates
        fixture = os.path.join(REPO, 'tests', 'fastqs', 'test_engine.fastq')
        plus = ['CACCGGTGTAGGCAAGTCGTAACAAGG', 'TTTTTTTTTTGGGGGGGGGG',
                'CCCC', 'CCC']
        comp = dict(zip('ACGT', 'TGCA'))
        seqs = plus + [''.join(comp.get(c, c) for c in reversed(s))
                       for s in plus]
        for e in range(4):
            for mo in (3, 10, 20):
                total += run_case(binpath, fixture, seqs, 33 + 2, e, mo, 3,
                                  tmp, backend)

        # 2. the golden 5k MTBC extract against the real template bank
        if not quick:
            gold = os.path.join(REPO, 'tests', 'fastqs',
                                'L3_N1014_hits_5k.fastq')
            from kvarq_tpu.analyse import Analyser
            from kvarq_tpu.testsuites import (discover_testsuites,
                                              load_testsuites)
            suites = load_testsuites(
                discover_testsuites([os.path.join(REPO, 'testsuites')]),
                ['MTBC'])
            analyser = Analyser()
            covs = analyser.load_coverages(suites, spacing=25)
            mtbc = [c.plus_seq.bases for c in covs.values()] \
                + [c.minus_seq.bases for c in covs.values()]
            for e in (0, 2, 3):
                total += run_case(binpath, gold, mtbc, 33 + 13, e, 25, 25,
                                  tmp, backend)

        # 3. randomized corpora x maxerrors x minoverlap sweep
        rng = np.random.RandomState(20260820)
        n_corpora = 2 if quick else 6
        for c in range(n_corpora):
            seqs = random_templates(rng, 12)
            corpus = os.path.join(tmp, 'corpus%d.fastq' % c)
            random_corpus(corpus, seqs, 200 if quick else 1000,
                          seed=1000 + c, with_n=(c % 2 == 1))
            for e in range(4):
                for mo in (10, 25):
                    total += run_case(binpath, corpus, seqs, 33 + 10, e,
                                      mo, 10, tmp, backend)

        print('hit streams identical over all cases (%d hits compared, '
              'backend=%s)' % (total, backend))
    return 0


if __name__ == '__main__':
    sys.exit(main())

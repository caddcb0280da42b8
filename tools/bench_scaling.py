#!/usr/bin/env python
'''
Multi-chip scaling harness: scans the same synthetic workload with the
sharded mesh scanner (kvarq_tpu.parallel) over 1..N devices and reports
reads/s per device count plus scaling efficiency.

With ``--virtual N`` this runs on a virtual CPU mesh, which validates
the sharded path end-to-end and measures *relative* scaling of the
collective-merged step; CPU numbers say nothing about GPU throughput --
run on real GPUs for device measurements.

Usage:
    python tools/bench_scaling.py [--virtual 8] [--reads 100000]
'''

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--virtual', type=int, default=0,
                    help='force a virtual CPU mesh with N devices')
    ap.add_argument('--reads', type=int, default=100000)
    ap.add_argument('--readlen', type=int, default=101)
    args = ap.parse_args()

    if args.virtual:
        flags = os.environ.get('XLA_FLAGS', '')
        if 'host_platform_device_count' not in flags:
            os.environ['XLA_FLAGS'] = (
                flags + ' --xla_force_host_platform_device_count=%d'
                % args.virtual).strip()
        os.environ['JAX_PLATFORMS'] = 'cpu'
        import jax
        jax.config.update('jax_platforms', 'cpu')

    import jax
    import numpy as np
    from kvarq_tpu.log import set_warning
    set_warning()
    from kvarq_tpu.testsuites import discover_testsuites, load_testsuites
    from kvarq_tpu.analyse import Analyser
    from kvarq_tpu.engine import encode
    from kvarq_tpu import parallel

    paths = discover_testsuites(
        [os.path.join(os.path.dirname(HERE), 'testsuites')])
    suites = load_testsuites(paths, ['MTBC'])
    an = Analyser()
    covs = an.load_coverages(suites, spacing=25)
    seqs = [c.plus_seq.bases for c in covs.values()]
    seqs += [c.minus_seq.bases for c in covs.values()]

    devices = jax.devices()
    print('devices: %d x %s' % (len(devices), devices[0].platform),
          file=sys.stderr)

    rng = np.random.RandomState(0)
    B, Lpad = args.reads, 128
    raw = rng.choice(np.frombuffer(b'ACGT', np.uint8), (B, Lpad))
    for b in range(0, B, 32):
        s = seqs[rng.randint(len(seqs))].encode()[:args.readlen]
        raw[b, :len(s)] = np.frombuffer(s, np.uint8)
    codes = encode.encode_read_array(raw)
    rl = np.full(B, args.readlen, np.int32)
    codes[np.arange(Lpad)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK

    class Batch:
        pass

    results = {}
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]
    for n in counts:
        mesh = parallel.make_mesh(n_data=n, n_bank=1,
                                  devices=devices[:n])
        sc = parallel.ShardedScanner(seqs, 2, 25, mesh=mesh)
        batch = Batch()
        sub = 16384
        # warm up / compile
        batch.codes, batch.rl = codes[:sub], rl[:sub]
        sc.scan_batch(batch)
        sc.reset()
        t0 = time.time()
        for lo_ in range(0, B, sub):
            batch.codes = codes[lo_:lo_ + sub]
            batch.rl = rl[lo_:lo_ + sub]
            sc.scan_batch(batch)
        total_hits = int(sc.seqhits.sum())
        dt = time.time() - t0
        rps = B / dt
        results[n] = rps
        eff = rps / (results[1] * n) if 1 in results else 1.0
        print('%2d device(s): %8.0f reads/s  (%.2f efficiency, '
              '%d hits)' % (n, rps, eff, total_hits), file=sys.stderr)

    import json
    base = results.get(1, 1)
    print(json.dumps({
        'metric': 'scaling_efficiency',
        'per_device_reads_per_s': results,
        'efficiency': {n: round(r / (base * n), 3)
                       for n, r in results.items()},
    }))


if __name__ == '__main__':
    main()

#!/usr/bin/env python
'''
Device-sustained scan throughput: the exhaustive (sieve-less) scan step
over device-resident inputs -- isolates the screen + accumulation graph
from the host reader/sieve.

One jitted accumulate-step consumes ``--fuse`` stacked sub-batches per
dispatch; inputs are uploaded once and reused, accumulators are donated,
and the run is synced by a host readback at the end.  Refuses to run
without a GPU; prints the device identity beside the rate.

Usage:
    python tools/device_bench.py [--fuse 32] [--steps 8] [--hitfrac 0.03]
'''

import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--fuse', type=int, default=32,
                    help='sub-batches per dispatch (KVARQ_FUSE_STEPS)')
    ap.add_argument('--steps', type=int, default=8,
                    help='timed dispatches')
    ap.add_argument('--hitfrac', type=float, default=0.03,
                    help='fraction of reads planted from template loci')
    ap.add_argument('--readlen', type=int, default=101)
    args = ap.parse_args()
    os.environ['KVARQ_FUSE_STEPS'] = str(args.fuse)

    import jax
    import numpy as np
    from kvarq_tpu.device import require_gpu
    dev = require_gpu()[0]

    from kvarq_tpu.log import set_warning
    set_warning()
    from kvarq_tpu.analyse import Analyser
    from kvarq_tpu.engine import encode
    from kvarq_tpu.engine.tensor_scan import _cached_context
    from kvarq_tpu.testsuites import discover_testsuites, load_testsuites

    paths = discover_testsuites(
        [os.path.join(os.path.dirname(HERE), 'testsuites')])
    suites = load_testsuites(paths, ['MTBC'])
    an = Analyser()
    covs = an.load_coverages(suites, spacing=25)
    seqs = [c.plus_seq.bases for c in covs.values()]
    seqs += [c.minus_seq.bases for c in covs.values()]

    Lpad = 128
    t0 = time.time()
    bank, arrays, step, sub = _cached_context(
        tuple(seqs), Lpad, 2, 25, 'screen', args.fuse)
    print('context (bank G=%d, sub=%d) in %.1fs'
          % (bank.G, sub, time.time() - t0), file=sys.stderr)

    # synthetic batch: mostly random reads, --hitfrac planted templates
    rng = np.random.RandomState(20260819)
    bases = np.frombuffer(b'ACGT', dtype=np.uint8)
    raw = bases[rng.randint(4, size=(args.fuse * sub, Lpad))]
    rl = np.full(args.fuse * sub, args.readlen, dtype=np.int32)
    planted = np.flatnonzero(rng.rand(len(raw)) < args.hitfrac)
    windows = [c.plus_seq.bases.encode() for c in covs.values()]
    for i in planted:
        w = windows[rng.randint(len(windows))]
        n = min(len(w), args.readlen)
        raw[i, :n] = np.frombuffer(w[:n], np.uint8)
    codes = encode.encode_read_array(raw)
    codes[np.arange(Lpad)[None, :] >= rl[:, None]] = encode.CODE_READ_JUNK
    codes = codes.reshape(args.fuse, sub, Lpad)
    rl = rl.reshape(args.fuse, sub)

    dcodes = jax.device_put(codes)
    drl = jax.device_put(rl)

    def zero_acc():
        import jax.numpy as jnp
        return (jnp.zeros((encode.NBASE, bank.G), dtype=jnp.float32),
                jnp.zeros(len(seqs) + 1, dtype=jnp.int32),
                jnp.zeros(len(seqs) + 1, dtype=jnp.int32),
                jnp.zeros((), dtype=jnp.int32))   # candmax

    t0 = time.time()
    acc = step(dcodes, drl, *zero_acc(), **arrays)
    nh = int(np.asarray(acc[1])[:-1].sum())   # readback = real sync
    print('warmup dispatch (incl. compile): %.1fs, %d hit weight'
          % (time.time() - t0, nh), file=sys.stderr)

    acc = zero_acc()
    t0 = time.time()
    for _ in range(args.steps):
        acc = step(dcodes, drl, *acc, **arrays)
    nh = int(np.asarray(acc[1])[:-1].sum())   # sync
    dt = time.time() - t0

    reads = args.steps * args.fuse * sub
    Qp = arrays['qmeta'].shape[1]
    nch = arrays['K'].shape[0] // Lpad
    flops = 2.0 * reads * Lpad * nch * Qp
    print('%s: %d reads in %.2fs: %.0f reads/s, %.1f TFLOP/s of screen '
          'matmul (%d hit weight)'
          % (dev.device_kind, reads, dt, reads / dt, flops / dt / 1e12, nh))


if __name__ == '__main__':
    main()

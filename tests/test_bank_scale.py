'''
Template-bank scaling (SURVEY §5.7 "bank axis"): a 1,000+ template
SNP-barcode bank (coll14-style -- Coll et al 2014's 62-SNP scheme scaled
up) scanned with the bank axis sharded over the virtual 8-device mesh
must be bitwise-identical to the single-device scan.  This is the axis
that makes huge barcodes (thousands of SNPs, e.g. whole-genome typing
schemes) fit: each shard holds 1/n_bank of the K matrix / one-hot bank.

The memory-growth numbers these tests anchor live in
docs/architecture.md ("Bank-axis sizing").
'''

import numpy as np
import pytest

from kvarq_tpu.engine import encode, reader
from kvarq_tpu import parallel

TEMPLATE_LEN = 25
N_TEMPLATES = 1040           # > 1000, divides 8 evenly
READLEN = 101
BASES = np.frombuffer(b'ACGT', dtype=np.uint8)


@pytest.fixture(scope='module')
def bank_and_reads():
    ''' deterministic synthetic genome + barcode bank + read batch:
        1,040 SNP templates (25-bp windows, center base mutated) drawn
        from a 60 kb genome, and 256 reads of which 64 carry a planted
        template window '''
    rng = np.random.RandomState(2014)
    genome = BASES[rng.randint(4, size=60000)]

    seqs = []
    for i in range(N_TEMPLATES):
        start = rng.randint(0, len(genome) - TEMPLATE_LEN)
        w = genome[start:start + TEMPLATE_LEN].copy()
        mid = TEMPLATE_LEN // 2
        w[mid] = BASES[(np.searchsorted(BASES, w[mid]) + 1
                        + rng.randint(3)) % 4]
        seqs.append(w.tobytes().decode())

    B = 256
    raw = BASES[rng.randint(4, size=(B, READLEN))]
    for i in range(64):
        t = rng.randint(N_TEMPLATES)
        off = rng.randint(READLEN - TEMPLATE_LEN + 1)
        raw[i, off:off + TEMPLATE_LEN] = np.frombuffer(
            seqs[t].encode(), dtype=np.uint8)
    codes = encode.encode_read_array(raw)
    rl = np.full(B, READLEN, dtype=np.int32)
    batch = reader.RecordBatch(codes, rl, np.zeros(B, dtype=np.int64), raw)
    return seqs, batch


def _scan(seqs, batch, n_data, n_bank):
    mesh = parallel.make_mesh(n_data, n_bank)
    scanner = parallel.ShardedScanner(seqs, maxerrors=2, minoverlap=25,
                                      mesh=mesh, backend='xla')
    scanner.scan_batch(batch)
    return scanner


@pytest.mark.parametrize('n_data,n_bank', [(1, 8), (2, 4)])
def test_bank_sharded_equals_single_device(bank_and_reads, n_data, n_bank):
    import jax
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 (virtual) devices')
    seqs, batch = bank_and_reads

    single = _scan(seqs, batch, 1, 1)
    sharded = _scan(seqs, batch, n_data, n_bank)

    assert int(single.seqhits.sum()) >= 64       # every plant must hit
    assert np.array_equal(single.seqhits, sharded.seqhits)
    assert np.array_equal(single.seqbasehits, sharded.seqbasehits)
    ref, got = single.coverages(), sharded.coverages()
    diff = [t for t in range(len(seqs))
            if not np.array_equal(ref[t], got[t])]
    assert not diff, 'coverages differ for templates %r' % diff[:10]


def test_bank_shard_memory_split(bank_and_reads):
    ''' the per-shard one-hot bank really is ~1/n_bank of the whole:
        the point of the axis (docs/architecture.md sizing table) '''
    seqs, _ = bank_and_reads
    Lpad = 128
    whole = parallel.ShardBank(seqs, Lpad, 1)
    split = parallel.ShardBank(seqs, Lpad, 8)
    assert split.G <= -(-whole.G // 8) + TEMPLATE_LEN + Lpad
    # global template numbering is preserved across shards
    tids = np.unique(split.tid[split.tid >= 0])
    assert tids.min() == 0 and tids.max() == len(seqs) - 1

'''
kvarq_tpu -- a reimplementation of the KvarQ targeted variant-calling
framework (reference: kvarq/kvarq) as a JAX program that runs on a GPU.

KvarQ calls variants (lineage SNPs, resistance mutations, spoligotypes)
directly from FastQ reads of bacterial genomes, without mapping or
assembly.  This package provides the same capabilities, redesigned for
an accelerator:

- the hot scanning loop (reference ``csrc/workhorse.c``) is a batched
  one-hot match (bf16 matmuls plus exact integer gating) compiled by
  XLA for the GPU -- or for the CPU, when JAX is pointed there,
- the input pipeline (FastQ parse, gzip inflate, quality trim) runs on
  host CPU (C++ with a pure-Python fallback),
- multi-device scale-out shards read batches data-parallel over a
  ``jax.sharding.Mesh`` and merges per-locus coverage tensors with
  ``psum`` collectives (replacing the reference's pthread mutexes).

The JSON result format, CLI surface, testsuite plugin API and all
analysis semantics are kept compatible with the reference so existing
users can switch over directly.
'''

# Versioning follows the reference scheme (reference kvarq/__init__.py:1-12):
# second number tracks .json file-format compatibility -- kept at 12 so that
# result files interoperate with reference KvarQ 0.12.x.
VERSION = '0.12.3'

DOWNLOAD_URL = 'https://github.com/kvarq/kvarq'
DOC_URL = 'https://kvarq.readthedocs.org/'

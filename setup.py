#!/usr/bin/env python
'''
Packaging for kvarq_tpu (reference setup.py:31-149: C-extension build +
``kvarq`` console entry point; the py2exe/py2app/NSIS bundling of the
reference is obsolete -- modern wheels serve the same purpose).

The native FastQ reader (csrc/reader.cpp) is built as a plain shared
library loaded via ctypes (csrc/_reader.so, not tracked by git: a
checkout builds it at first use, a wheel at build time); it is optional
-- the numpy pipeline is a byte-exact fallback -- so build failures do
not fail the install.
'''

import os
import subprocess
import sys

from setuptools import setup, find_packages
from setuptools.command.build_py import build_py

HERE = os.path.abspath(os.path.dirname(__file__))


def build_native():
    ''' same flag cascade as kvarq_tpu.engine.native._build: AVX2
        baseline (portable across machines a wheel may travel to),
        libdeflate when available; the source hash is embedded so the
        runtime loader accepts the library as current, and the library
        is written to a temporary name and renamed into place '''
    import hashlib
    src = os.path.join(HERE, 'csrc', 'reader.cpp')
    lib = os.path.join(HERE, 'csrc', '_reader.so')
    tmp = '%s.%d.tmp' % (lib, os.getpid())
    with open(src, 'rb') as fd:
        src_hash = hashlib.sha256(fd.read()).hexdigest()[:16]
    for arch in (['-march=x86-64-v3', '-mpclmul'], ['-march=native'], []):
        for extra in (['-DKVARQ_USE_LIBDEFLATE', '-lz', '-ldeflate'],
                      ['-lz'],
                      ['-DKVARQ_NO_ZLIB']):   # self-contained inflate
            cmd = (['g++', '-O3'] + arch
                   + ['-DKVARQ_SRC_HASH="%s"' % src_hash,
                      '-shared', '-fPIC', '-pthread', '-o', tmp, src]
                   + extra)
            try:
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(tmp, lib)
                return True
            except Exception:
                continue
    sys.stderr.write('warning: native reader build failed; '
                     'the numpy pipeline will be used\n')
    return False


class BuildWithNative(build_py):
    def run(self):
        build_native()
        super().run()


def read_version():
    with open(os.path.join(HERE, 'kvarq_tpu', '__init__.py')) as f:
        for line in f:
            if line.startswith('VERSION'):
                return line.split("'")[1]
    return '0.0'


setup(
    name='kvarq-tpu',
    version=read_version(),
    description='Targeted variant calling from FastQ reads with JAX',
    packages=find_packages(include=['kvarq_tpu*', 'kvarq*']),
    # paths starting ../ land next to the packages in site-packages --
    # exactly where util.get_root_path() resolves them: the native
    # reader source+binary (csrc/), the shipped testsuites incl. the
    # reconstructed MTBC ancestor genome, and the manual (docs/).  The
    # native reader binary is the one build_native() just compiled.
    package_data={
        'kvarq_tpu': ['gui/res/*.png'],
        '': ['../csrc/reader.cpp', '../csrc/kvq_inflate.h',
             '../csrc/kvq_fast_inflate.h',
             '../csrc/_reader.so',
             '../testsuites/*.md',
             '../testsuites/MTBC/*.py', '../testsuites/MTBC/*.md',
             '../testsuites/MTBC/*.bases',
             '../testsuites/examples/*.py',
             '../testsuites/ebola/*.py', '../testsuites/ebola/*.fasta',
             '../testsuites/examples/*.tsv',
             '../docs/*.md'],
    },
    python_requires='>=3.10',
    install_requires=['numpy', 'jax'],
    entry_points={
        'console_scripts': ['kvarq = kvarq_tpu.cli:main'],
    },
    cmdclass={'build_py': BuildWithNative},
)
